// Multi-threshold confusion counts for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpumetrics/ops/binned_confusion.py,
// function binned_confusion_fused (body _kernel).  For preds, y, v of shape
// (N, C) and thresholds of shape (T,) it writes two (T, C) int32 arrays:
//
//     tp[t, c]      = sum_n [preds[n, c] >= thr[t]] * y[n, c]
//     predpos[t, c] = sum_n [preds[n, c] >= thr[t]] * v[n, c]
//
// y and v are 0/1 masks (target bit * valid, and valid), counted
// independently.  A tie with a threshold counts as positive, a NaN pred is
// below every threshold, a NaN threshold counts nothing, and the thresholds
// may be unsorted, duplicated or infinite (-0.0 and 0.0 compare equal).
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the
// tensor cores): the inputs are read once, 3*N*C*4 bytes; at N=8192, C=1000,
// T=200 that is 98.3 MB (29 us).  With the thresholds sorted, the function
// needs ceil(log2(T+1)) comparisons per element (8.2e6 elements there, about
// 1 us of operations), so the bytes set the bound at every shape the main
// path uses.  The design therefore reads each input element once, in one
// pass, and keeps everything else on chip; two launches per call, no host
// sync:
//
// 1. rank_kernel ranks the T thresholds, one warp per threshold (NaN
//    thresholds last, ties by index), into a sorted copy and the caller's
//    index of each sorted position, and zeroes the outputs.
// 2. count_kernel: a block owns a tile of `width` classes (lane = class, so a
//    warp reads a contiguous run of a row; narrow C puts 32/width rows on one
//    warp), one split of the rows and one range of buckets.  Each element
//    finds its bucket b = #{k : sorted[k] <= pred} by a search of fixed
//    depth through the range's thresholds, kept in shared memory as a
//    breadth-first tree, and adds its y and v bits, packed as y + (v << 16),
//    to hist[b][lane] with one shared-memory atomic.  Every lane owns its
//    column of the histogram, so a warp's atomics never meet on a bank or an
//    address whatever the buckets, also when narrow C sends many rows of one
//    class through one warp.  A thread loads its next rows before it counts
//    the current ones.
// 3. The block's epilogue turns each column into suffix sums over the
//    buckets (32 threads per column) and adds, for every sorted position k,
//    sum_{b > k} hist[b] to out[order[k]][class] with an int32 atomic,
//    skipping zeros: exact and independent of the order in which blocks run,
//    up to 2^31 per call.  The host caps the rows of a split so that no
//    16-bit field of a packed column can carry.
//
// What holds it above its bound is the latency of the loads: the search and
// the atomics leave each thread few loads in flight.  Blocks of 1024 threads
// at 32 registers (two blocks, 64 warps, on an SM) hide the most of it.
//
// Sizes: a bucket takes 128 bytes of histogram (32 lanes) and 4 of
// thresholds, and a block is given room for the next power of two of its
// range's buckets: at T=200, 256 buckets, 33 KB.  When the T+1 buckets do not
// fit in the 227 KB a block may have (T above about 1,720), the grid gains a
// dimension of bucket ranges: a block keeps the buckets of its range and the
// thresholds that bound them, and skips elements outside it, so every T runs
// and reads the inputs once per range.

#include <cuda_runtime.h>

#include <algorithm>
#include <mutex>

namespace {

constexpr int kThreads = 1024;              // count_kernel block
constexpr int kParts = kThreads / 32;       // threads per column in the suffix scan
constexpr int kRowsInFlight = 2;            // rows a thread loads ahead
constexpr int kMaxSteps = 0xffff / kParts;  // block steps per split: no packed field passes 0xffff
constexpr int kRankThreads = 256;
constexpr int kMaxDevices = 64;

// One warp per threshold i: its rank is the number of thresholds that sort
// before it, NaN thresholds last and ties by index.
__global__ void __launch_bounds__(kRankThreads)
rank_kernel(const float* __restrict__ thr, int t, float* __restrict__ sorted, int* __restrict__ order,
            int* __restrict__ out, long long out_len) {
  // the count kernel adds into the outputs
  for (long long i = (long long)blockIdx.x * kRankThreads + threadIdx.x; i < out_len;
       i += (long long)gridDim.x * kRankThreads)
    out[i] = 0;
  const long long i = ((long long)blockIdx.x * kRankThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (i >= t) return;  // uniform over the warp
  const float ti = __ldg(thr + i);
  const bool nan_i = isnan(ti);
  int rank = 0;
  for (int j = lane; j < t; j += 32) {
    const float tj = __ldg(thr + j);
    // float comparisons: -0.0 == 0.0
    rank += nan_i ? (!isnan(tj) || j < i) : (tj < ti || (tj == ti && j < i));
  }
  rank = __reduce_add_sync(0xffffffffu, rank);
  if (lane == 0) {
    sorted[rank] = ti;
    order[rank] = (int)i;
  }
}

// Loads the elements of kRowsInFlight rows, `step` rows apart from `row`:
// the pred and the packed bits y + (v << 16) (0 for a row past `r_end`).
__device__ __forceinline__ void load_rows(const float* __restrict__ preds, const float* __restrict__ y,
                                          const float* __restrict__ v, long long row, long long r_end, int step,
                                          int c, long long col, float* p, unsigned* inc) {
#pragma unroll
  for (int u = 0; u < kRowsInFlight; ++u) {
    const long long r = row + (long long)u * step;
    p[u] = 0.0f;
    inc[u] = 0;
    if (r < r_end) {
      const long long off = r * c + col;
      p[u] = __ldg(preds + off);
      inc[u] = (unsigned)(__ldg(y + off) != 0.0f) | ((unsigned)(__ldg(v + off) != 0.0f) << 16);
    }
  }
}

// kSteps = ceil(log2(bucket count of the range)): the depth of the search.
template <int kSteps>
__global__ void __launch_bounds__(kThreads, 2)
count_kernel(const float* __restrict__ preds, const float* __restrict__ y, const float* __restrict__ v,
             const float* __restrict__ sorted, const int* __restrict__ order, int* __restrict__ out, long long n,
             int c, int t, int width, long long rows_per_split, int bucket_span) {
  constexpr int kEdges = 1 << kSteps;
  extern __shared__ unsigned smem[];
  __shared__ unsigned part_sum[kParts][32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int b0 = blockIdx.z * bucket_span;
  const int nb = min(bucket_span, t + 1 - b0);
  const long long c0 = (long long)blockIdx.x * width;
  const long long col = c0 + (tid & (width - 1));  // width is a power of two <= 32
  const int step = kThreads / width;
  const long long r_begin = (long long)blockIdx.y * rows_per_split;
  const long long r_end = min(n, r_begin + rows_per_split);

  // The range holds buckets b0 .. b0 + nb - 1: preds in [lower, upper), with
  // lower = sorted[b0 - 1] (-inf for the first range), upper = sorted[b0 + nb - 1]
  // (NaN, never <= a pred, for the last).  The nb - 1 thresholds inside,
  // sorted[b0 .. b0 + nb - 2], are edges 1 .. nb - 1, and NaN edges, never
  // <= a pred, fill up to kEdges - 1.  They are stored as a search tree in
  // breadth-first order (node x at depth d holds edge (2 (x - 2^d) + 1)
  // 2^(kSteps - 1 - d); its children are 2x and 2x + 1), so the nodes a step
  // reads are contiguous and a warp meets on fewer banks than in a sorted
  // array (on an H100 at 8192x1000x200, 4 % less time than a plain search of
  // the sorted thresholds).
  const float neg_inf = __int_as_float(0xff800000), qnan = __int_as_float(0x7fffffff);
  const float lower = b0 > 0 ? sorted[b0 - 1] : neg_inf;
  const float upper = b0 + nb - 1 < t ? sorted[b0 + nb - 1] : qnan;
  float* tree = reinterpret_cast<float*>(smem);
  unsigned* hist = smem + kEdges;  // [bucket - b0][lane]
  for (int x = tid + 1; x < kEdges; x += kThreads) {
    const int d = 31 - __clz(x);
    const int edge = (2 * (x - (1 << d)) + 1) << (kSteps - 1 - d);
    tree[x] = edge < nb ? sorted[b0 - 1 + edge] : qnan;
  }
  for (int i = tid; i < nb * 32; i += kThreads) hist[i] = 0;
  __syncthreads();

  if (col < c) {
    float p[kRowsInFlight], p_next[kRowsInFlight];
    unsigned inc[kRowsInFlight], inc_next[kRowsInFlight];
    long long r = r_begin + tid / width;
    load_rows(preds, y, v, r, r_end, step, c, col, p, inc);
    for (; r < r_end; r += kRowsInFlight * step) {
      // the next rows' loads are in flight while these are counted
      load_rows(preds, y, v, r + kRowsInFlight * step, r_end, step, c, col, p_next, inc_next);
      // bucket - b0 = #{edges <= p}: the predicate holds on a prefix of
      // the edges, so the leaf reached, x - kEdges, is that number.  The
      // rows' searches are interleaved.
      int x[kRowsInFlight];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) x[u] = 1;
#pragma unroll
      for (int k = 0; k < kSteps; ++k)
#pragma unroll
        for (int u = 0; u < kRowsInFlight; ++u) x[u] = 2 * x[u] + (tree[x[u]] <= p[u]);
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        // a NaN pred fails lower <= p: its bucket 0 counts for no threshold
        if (inc[u] != 0 && lower <= p[u] && !(upper <= p[u]))
          atomicAdd(&hist[(x[u] - kEdges) * 32 + lane], inc[u]);
        p[u] = p_next[u];
        inc[u] = inc_next[u];
      }
    }
  }
  __syncthreads();

  // suffix sums over this range's buckets, in place: hist[b] = sum_{b' >= b} hist[b']
  const int part = tid >> 5;
  const int len = (nb + kParts - 1) / kParts;
  const int lo = min(nb, part * len);
  const int hi = min(nb, lo + len);
  unsigned run = 0;
  for (int b = lo; b < hi; ++b) run += hist[b * 32 + lane];
  part_sum[part][lane] = run;
  __syncthreads();
  run = 0;
  for (int q = part + 1; q < kParts; ++q) run += part_sum[q][lane];
  for (int b = hi - 1; b >= lo; --b) {
    run += hist[b * 32 + lane];
    hist[b * 32 + lane] = run;
  }
  __syncthreads();

  // the threshold at sorted position k counts the buckets b > k: within this
  // range that is hist[k + 1 - b0], all of it (hist[0]) when k + 1 <= b0, and
  // nothing when k + 1 >= b0 + nb
  const int k_end = min(t, b0 + nb - 1);
  const int groups = 32 / width;  // columns of one class
  const int width_log2 = __ffs(width) - 1;
  const long long plane = (long long)t * c;
  for (long long e = tid; e < ((long long)k_end << width_log2); e += kThreads) {
    const int k = (int)(e >> width_log2);
    const int cl = (int)(e & (width - 1));
    const long long ci = c0 + cl;
    if (ci >= c) continue;
    const int hb = max(0, k + 1 - b0);
    unsigned yc = 0, vc = 0;
    for (int g = 0; g < groups; ++g) {
      const unsigned x = hist[hb * 32 + cl + g * width];
      yc += x & 0xffffu;
      vc += x >> 16;
    }
    const long long o = (long long)__ldg(order + k) * c + ci;
    if (yc) atomicAdd(out + o, (int)yc);
    if (vc) atomicAdd(out + plane + o, (int)vc);
  }
}

using CountKernel = void (*)(const float*, const float*, const float*, const float*, const int*, int*, long long, int,
                            int, int, long long, int);
// one instantiation per search depth, up to ranges of 2^11 buckets (more than
// the 227 KB of shared memory a block may have can hold)
constexpr CountKernel kCountKernels[] = {
    count_kernel<0>, count_kernel<1>, count_kernel<2>, count_kernel<3>, count_kernel<4>,  count_kernel<5>,
    count_kernel<6>, count_kernel<7>, count_kernel<8>, count_kernel<9>, count_kernel<10>, count_kernel<11>,
};
constexpr int kDepths = sizeof(kCountKernels) / sizeof(kCountKernels[0]);

struct DeviceInfo {
  bool ready = false;
  int sms = 0;
  int max_span = 0;             // buckets a block's range may hold
  size_t smem[kDepths] = {};    // dynamic shared memory of a block, per search depth
  int occupancy[kDepths] = {};  // blocks an SM holds, per search depth
};

// Per device, once: the SM count, the widest bucket range, and for each
// search depth the shared memory of a block (room for the thresholds and the
// histogram of the depth's widest range) and how many such blocks an SM holds.
// Every count_kernel is allowed all the shared memory a block can have (the
// attribute is needed above 48 KB).
cudaError_t device_info(int dev, DeviceInfo* info) {
  static std::mutex mu;
  static DeviceInfo cache[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  DeviceInfo& d = cache[dev];
  if (!d.ready) {
    int optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    int budget = optin;
    for (const CountKernel kernel : kCountKernels) {
      cudaFuncAttributes attr;
      if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
      if (err == cudaSuccess) budget = std::min(budget, optin - (int)attr.sharedSizeBytes);
    }
    for (const CountKernel kernel : kCountKernels)
      if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, budget);
    // a bucket takes 128 bytes of histogram and 4 of thresholds
    const int top = 1 << (kDepths - 1);
    d.max_span = std::min(top, (budget - 4 * top) / 128);
    if (err == cudaSuccess && d.max_span < 1) err = cudaErrorInvalidConfiguration;
    for (int k = 0; k < kDepths && err == cudaSuccess; ++k) {
      d.smem[k] = 4 * ((size_t)1 << k) + 128 * (size_t)std::min(1 << k, d.max_span);
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&d.occupancy[k], kCountKernels[k], kThreads, d.smem[k]);
      if (err == cudaSuccess && d.occupancy[k] < 1) err = cudaErrorInvalidConfiguration;
    }
    if (err != cudaSuccess) return err;
    d.ready = true;
  }
  *info = d;
  return cudaSuccess;
}

}  // namespace

// Writes tp into out[0:T*C] and predpos into out[T*C:2*T*C], both (T, C)
// int32 in the caller's threshold order.  scratch holds 2*T int32 words (the
// sorted thresholds and their caller indices).  All pointers are device
// pointers on the current device; both launches go to `stream` and nothing
// synchronises.  Returns 0 on success, else a CUDA error code.
extern "C" int binned_confusion_counts(const void* preds, const void* y, const void* v, const void* thr, void* out,
                                       void* scratch, long long n, int c, int t, void* stream) {
  if (n <= 0 || c <= 0 || t <= 0) return (int)cudaErrorInvalidValue;
  if (t >= (1 << 30)) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  DeviceInfo info;
  err = device_info(dev, &info);
  if (err != cudaSuccess) return (int)err;

  int width = 1;
  while (width < c && width < 32) width *= 2;
  const int step = kThreads / width;
  const long long col_tiles = (c + width - 1) / width;

  // when the T+1 buckets do not fit, the grid gains a dimension of bucket ranges
  const int bucket_span = std::min(t + 1, info.max_span);
  const long long ranges = (t + 1 + (long long)bucket_span - 1) / bucket_span;
  int steps = 0;
  while ((1 << steps) < bucket_span) ++steps;
  const int occupancy = info.occupancy[steps];
  if (col_tiles > 0x7fffffffLL || ranges > 65535) return (int)cudaErrorInvalidConfiguration;

  // as many blocks as fit on the card at once; no split shorter than four
  // block steps or four rows a bucket (the epilogue's cost), and none longer
  // than kMaxSteps block steps (the packed counters)
  const long long want = (long long)info.sms * occupancy / (col_tiles * ranges);
  const long long min_rows = 4LL * std::max(step, bucket_span);
  const long long most = (n + min_rows - 1) / min_rows;
  const long long least = (n + (long long)kMaxSteps * step - 1) / ((long long)kMaxSteps * step);
  long long splits = std::max(std::max(std::min(want, most), least), 1LL);
  if (splits > 65535) return (int)cudaErrorInvalidConfiguration;
  const long long rows_per_split = (n + splits - 1) / splits;
  splits = (n + rows_per_split - 1) / rows_per_split;

  float* sorted = (float*)scratch;
  int* order = (int*)scratch + t;
  const long long out_len = 2LL * t * c;
  const long long rank_blocks = (32LL * t + kRankThreads - 1) / kRankThreads;
  const long long zero_blocks = std::min((out_len + kRankThreads - 1) / kRankThreads, 4LL * info.sms);
  cudaStream_t s = (cudaStream_t)stream;
  rank_kernel<<<(unsigned)std::max(rank_blocks, zero_blocks), kRankThreads, 0, s>>>(
      (const float*)thr, t, sorted, order, (int*)out, out_len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 grid((unsigned)col_tiles, (unsigned)splits, (unsigned)ranges);
  kCountKernels[steps]<<<grid, kThreads, info.smem[steps], s>>>(
      (const float*)preds, (const float*)y, (const float*)v, sorted, order, (int*)out, n, c, t, width, rows_per_split,
      bucket_span);
  return (int)cudaGetLastError();
}
