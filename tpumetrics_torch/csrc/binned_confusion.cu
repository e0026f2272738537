// Multi-threshold confusion counts for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpumetrics/ops/binned_confusion.py,
// function binned_confusion_fused (body _kernel).  For preds, y, v of shape
// (N, C) and thresholds of shape (T,) it writes two (T, C) int32 arrays:
//
//     tp[t, c]      = sum_n [preds[n, c] >= thr[t]] * y[n, c]
//     predpos[t, c] = sum_n [preds[n, c] >= thr[t]] * v[n, c]
//
// y and v are 0/1 masks (target bit * valid, and valid).  A tie with a
// threshold counts as positive, a NaN pred is below every threshold, and the
// thresholds may be unsorted, duplicated or infinite: every (n, c, t) triple
// is one comparison, exactly as written above.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the
// tensor cores): the inputs are read once, 3*N*C*4 bytes.  At N=8192,
// C=1000, T=200 that is 98.3 MB (29 us at 3.35 TB/s); at N=8192, C=128,
// T=64 it is 12.6 MB (3.8 us).  The bytes set the bound at both shapes:
// even this design's N*C*T compare-and-accumulate pairs (1.64e9, 24 us at
// one operation a pair; 6.7e7, 1 us) take less, and the function needs far
// fewer (about N*C*log2(T) with the thresholds sorted).
//
// Design: the (N, C, T) comparison never reaches memory.  A block owns a
// tile of up to 32 classes and 32 thresholds and one split of the rows; the
// grid is (class tiles, threshold tiles, row splits), with enough row splits
// to put several blocks on each SM.  A thread's class is fixed (lane = class,
// so a warp reads a contiguous run of a row); its threads stride over the
// rows of the split and keep the 2 x 32 counts of their threshold tile in
// registers, with the 32 thresholds in registers too.  Narrow C (down to 1,
// the flattened micro-average path) gives several rows to one warp instead
// of idling lanes.  At the end the lanes of a warp that share a class are
// summed with shuffles, the warps through shared-memory atomics, and the
// blocks with one int32 atomicAdd per (t, c) into the zeroed output.
// Integer atomics make the counts exact and independent of order, up to
// 2^31 per call.  Making it fast (a bucketed histogram over thresholds
// sorted in shared memory, O(N*C*log T) and bound by memory) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileT = 32;
constexpr int kBlocksPerSm = 4;

__global__ void __launch_bounds__(kThreads)
binned_confusion_kernel(const float* __restrict__ preds, const float* __restrict__ y,
                        const float* __restrict__ v, const float* __restrict__ thr,
                        int* __restrict__ tp_out, int* __restrict__ pp_out, long long n, int c, int t,
                        int col_width, long long rows_per_split) {
  __shared__ float s_thr[kTileT];
  __shared__ int s_tp[kTileT][32];
  __shared__ int s_pp[kTileT][32];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int col_local = tid % col_width;  // col_width is a power of two <= 32
  const int rows_per_step = kThreads / col_width;
  const int col = blockIdx.x * col_width + col_local;
  const int t0 = blockIdx.y * kTileT;
  const long long r_begin = (long long)blockIdx.z * rows_per_split;
  const long long r_end = min(n, r_begin + rows_per_split);

  // thresholds past T pad the tile; their counts are never written out
  if (tid < kTileT) s_thr[tid] = (t0 + tid < t) ? thr[t0 + tid] : 0.0f;
  for (int i = tid; i < kTileT * 32; i += kThreads) {
    (&s_tp[0][0])[i] = 0;
    (&s_pp[0][0])[i] = 0;
  }
  __syncthreads();

  float th[kTileT];
  int tp_acc[kTileT];
  int pp_acc[kTileT];
#pragma unroll
  for (int k = 0; k < kTileT; ++k) {
    th[k] = s_thr[k];
    tp_acc[k] = 0;
    pp_acc[k] = 0;
  }

  if (col < c) {
    for (long long r = r_begin + tid / col_width; r < r_end; r += rows_per_step) {
      const long long off = r * c + col;
      const float p = __ldg(preds + off);
      const int yb = __ldg(y + off) != 0.0f;
      const int vb = __ldg(v + off) != 0.0f;
#pragma unroll
      for (int k = 0; k < kTileT; ++k) {
        if (p >= th[k]) {
          tp_acc[k] += yb;
          pp_acc[k] += vb;
        }
      }
    }
  }

  // lanes l and l ^ off hold the same class whenever off >= col_width
  for (int off = 16; off >= col_width; off >>= 1) {
#pragma unroll
    for (int k = 0; k < kTileT; ++k) {
      tp_acc[k] += __shfl_xor_sync(0xffffffffu, tp_acc[k], off);
      pp_acc[k] += __shfl_xor_sync(0xffffffffu, pp_acc[k], off);
    }
  }
  if (lane < col_width) {
#pragma unroll
    for (int k = 0; k < kTileT; ++k) {
      atomicAdd(&s_tp[k][lane], tp_acc[k]);
      atomicAdd(&s_pp[k][lane], pp_acc[k]);
    }
  }
  __syncthreads();

  for (int i = tid; i < kTileT * col_width; i += kThreads) {
    const int k = i / col_width;
    const int cl = i % col_width;
    const int ti = t0 + k;
    const int ci = blockIdx.x * col_width + cl;
    if (ti < t && ci < c) {
      const long long o = (long long)ti * c + ci;
      if (s_tp[k][cl]) atomicAdd(tp_out + o, s_tp[k][cl]);
      if (s_pp[k][cl]) atomicAdd(pp_out + o, s_pp[k][cl]);
    }
  }
}

}  // namespace

// Accumulates into tp and pp, (T, C) int32 arrays that the caller zeroed.
// All pointers are device pointers on the current device; the launch goes to
// `stream`.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int binned_confusion_counts(const void* preds, const void* y, const void* v, const void* thr,
                                       void* tp, void* pp, long long n, int c, int t, void* stream) {
  if (n <= 0 || c <= 0 || t <= 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;

  int col_width = 1;
  while (col_width < c && col_width < 32) col_width *= 2;
  const int rows_per_step = kThreads / col_width;
  const long long col_tiles = (c + col_width - 1) / col_width;
  const long long thr_tiles = (t + kTileT - 1) / kTileT;
  if (col_tiles > 0x7fffffffLL || thr_tiles > 65535) return (int)cudaErrorInvalidConfiguration;

  // enough row splits for kBlocksPerSm blocks on every SM, but never fewer
  // rows per split than one step of the block
  const long long want = ((long long)sms * kBlocksPerSm + col_tiles * thr_tiles - 1) / (col_tiles * thr_tiles);
  const long long most = (n + rows_per_step - 1) / rows_per_step;
  long long splits = want < most ? want : most;
  if (splits < 1) splits = 1;
  if (splits > 65535) splits = 65535;
  const long long rows_per_split = (n + splits - 1) / splits;
  splits = (n + rows_per_split - 1) / rows_per_split;

  const dim3 grid((unsigned)col_tiles, (unsigned)thr_tiles, (unsigned)splits);
  binned_confusion_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)preds, (const float*)y, (const float*)v, (const float*)thr, (int*)tp, (int*)pp, n, c, t,
      col_width, rows_per_split);
  return (int)cudaGetLastError();
}
