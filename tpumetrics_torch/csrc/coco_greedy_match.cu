// COCO's greedy detection-to-ground-truth match for Hopper (sm_90a), one
// block per (image, class) cell, every cell of an evaluation in one launch.
//
// Replaces the lax.fori_loop of tpumetrics/detection/_coco_eval_jax.py
// (_build_program, :217-281) and the numpy loop of
// tpumetrics/detection/_coco_eval.py (_match_cells_batched, :357-375).
// Neither is a Pallas kernel: the JAX package runs the match as an XLA loop
// over the padded detection axis, or on the host. The match is sequential
// over a cell's detections and does a few dozen operations at each step;
// written as torch ops it becomes about 15 launches a detection slot, so
// launch latency would set its time.
//
// Inputs, flat and cell-sorted (no padding):
//   det_boxes (Nd, 4) float64 xyxy, each cell's detections consecutive, in
//   score order and capped at the largest max-det; gt_boxes (Ng, 4) float64
//   xyxy, gt_crowd (Ng,) uint8 and gt_area (Ng,) float64 (the effective
//   area: the user's, or the box's where the user gave 0), each cell's
//   ground truths consecutive; cells (N, 4) int32, one row a cell:
//   (det_start, det_count, gt_start, gt_count); thr (T,) float64
//   (min(threshold, 1 - 1e-10)); area_lo / area_hi (A,) float64.
// Outputs, one row a detection: det_matches and det_ignore, (Nd, A, T)
// uint8. Every detection row must belong to exactly one cell: the kernel
// writes a cell's rows and no others.
//
// The semantics are those of _match_cells_batched exactly:
//   - the IoU of (d, g) is inter / (union > 0 ? union : 1), union = da + ga
//     - inter, or da for a crowd ground truth;
//   - a ground truth is ignored at area range a if it is a crowd or its
//     effective area lies outside [lo, hi];
//   - detection d (in order) takes, among the ground truths still available
//     with IoU >= thr, a non-ignored one if there is any, else an ignored
//     one: the highest IoU, ties to the LARGEST g (numpy's reversed argmax);
//     det_matches = 1 and det_ignore = that ground truth's ignore flag; a
//     crowd ground truth absorbs the match without being claimed, any other
//     becomes unavailable at this (a, t);
//   - an unmatched detection whose own area lies outside [lo, hi] is
//     ignored.
//
// Bit for bit the numpy oracle: every IoU is formed with __dsub_rn,
// __dmul_rn, __dadd_rn and __ddiv_rn in numpy's order (areas (x2-x1)*(y2-y1);
// lt = max, rb = min, wh = max(rb - lt, 0), inter = w*h; (da + ga) - inter),
// so nvcc's default -fmad=true cannot contract a product into an FMA, and
// max / min propagate NaN as np.maximum / np.minimum do (CUDA's fmax would
// drop it and turn a NaN box into a finite IoU). The IoU is only compared,
// never output, so the sign of a zero does not matter.
//
// Design (a simple one that is right; speed is later work): a block of
// 32-256 threads owns one cell. It computes the cell's IoU tile
// cooperatively into shared memory, a chunk of detection rows at a time
// (as many as the launch's shared memory holds at the cell's own ground
// truth count), then one thread per (area, threshold) pair, 40 at COCO's
// defaults, walks the chunk's detections in order. A pair's available
// ground truths are bits in shared memory, one uint64 word per 64 of them,
// walked with __ffsll so a step visits only ground truths still available,
// in ascending g (which is what makes ">=" keep the largest index among
// ties). Thread p writes byte p of a detection's A*T-byte output row, so no
// two threads write one byte and a warp's writes to a row are contiguous.
//
// What bounds it (PERF.md has the times): the bytes, reading the boxes,
// crowds, areas and cell rows once and writing the two outputs once; the
// greedy walk is integer and compare work of about A*T*sum(d*g) steps, which
// the H100's 132 SMs spread over the cells.

#include <cuda_runtime.h>

#include <algorithm>
#include <mutex>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;
constexpr long long kTileTarget = 16 * 1024;  // shared memory a block aims for, so several blocks share an SM
constexpr int kMaxDevices = 64;

// np.maximum / np.minimum: a NaN operand is the result.
__device__ __forceinline__ double nan_max(double a, double b) { return (a >= b || a != a) ? a : b; }
__device__ __forceinline__ double nan_min(double a, double b) { return (a <= b || a != a) ? a : b; }

__device__ __forceinline__ double box_area(const double* b) {
  return __dmul_rn(__dsub_rn(b[2], b[0]), __dsub_rn(b[3], b[1]));
}

// Shared bytes a cell of ng ground truths needs besides its IoU rows: the
// availability words (words x pairs) and the ignore (A x ng) and crowd (ng)
// flags.
__host__ __device__ __forceinline__ long long fixed_bytes(int ng, int pairs, int num_areas) {
  return 8LL * ((ng + 63) / 64) * pairs + (long long)(num_areas + 1) * ng;
}

__global__ void coco_greedy_match_kernel(const double* __restrict__ det_boxes, const double* __restrict__ gt_boxes,
                                         const unsigned char* __restrict__ gt_crowd,
                                         const double* __restrict__ gt_area, const int* __restrict__ cells,
                                         const double* __restrict__ thr, const double* __restrict__ area_lo,
                                         const double* __restrict__ area_hi, unsigned char* __restrict__ det_matches,
                                         unsigned char* __restrict__ det_ignore, int num_areas, int num_thrs,
                                         long long smem_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pairs = num_areas * num_thrs;
  const long long cell = blockIdx.x;
  const long long ds = cells[cell * 4 + 0], gs = cells[cell * 4 + 2];
  const int nd = max(cells[cell * 4 + 1], 0), ng = max(cells[cell * 4 + 3], 0);
  const int words = (ng + 63) / 64;
  // shared layout: the availability words, the IoU tile (rows x ng doubles), the ignore flags, the crowd flags
  unsigned long long* avail = reinterpret_cast<unsigned long long*>(smem);
  double* tile = reinterpret_cast<double*>(avail + (size_t)words * pairs);
  const long long fixed = fixed_bytes(ng, pairs, num_areas);
  const int rows = ng ? static_cast<int>(min((long long)nd, (smem_bytes - fixed) / (8LL * ng))) : nd;
  if (nd && rows < 1) return;  // a cell larger than the launch's max_gt: the host sizes it from the true counts
  unsigned char* ign = reinterpret_cast<unsigned char*>(tile + (size_t)rows * ng);
  unsigned char* crowd = ign + (size_t)num_areas * ng;
  const double* dbox = det_boxes + ds * 4;
  const double* gbox = gt_boxes + gs * 4;

  for (int g = threadIdx.x; g < ng; g += blockDim.x) {
    const unsigned char c = gt_crowd[gs + g] != 0;
    const double area = gt_area[gs + g];
    crowd[g] = c;
    for (int a = 0; a < num_areas; ++a) ign[a * ng + g] = c || area < area_lo[a] || area > area_hi[a];
  }
  for (int i = threadIdx.x; i < words * pairs; i += blockDim.x) {
    const int w = i / pairs;
    const int left = ng - 64 * w;
    avail[i] = left >= 64 ? ~0ULL : (1ULL << left) - 1ULL;
  }

  for (int d0 = 0; d0 < nd; d0 += rows) {
    const int rn = min(rows, nd - d0);
    __syncthreads();  // the previous chunk's walk is done with the tile; the flags above are written
    for (int i = threadIdx.x; i < rn * ng; i += blockDim.x) {
      const int r = i / ng, g = i % ng;
      const double* db = dbox + (size_t)(d0 + r) * 4;
      const double* gb = gbox + (size_t)g * 4;
      const double da = box_area(db);
      const double ga = box_area(gb);
      const double w = nan_max(__dsub_rn(nan_min(db[2], gb[2]), nan_max(db[0], gb[0])), 0.0);
      const double h = nan_max(__dsub_rn(nan_min(db[3], gb[3]), nan_max(db[1], gb[1])), 0.0);
      const double inter = __dmul_rn(w, h);
      double uni = __dsub_rn(__dadd_rn(da, ga), inter);
      if (crowd[g]) uni = da;
      tile[(size_t)r * ng + g] = __ddiv_rn(inter, uni > 0.0 ? uni : 1.0);
    }
    __syncthreads();
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      const int a = p / num_thrs, t = p % num_thrs;
      const double th = thr[t], lo = area_lo[a], hi = area_hi[a];
      const unsigned char* ign_a = ign + (size_t)a * ng;
      for (int r = 0; r < rn; ++r) {
        const double* row = tile + (size_t)r * ng;
        int best_real = -1, best_ign = -1;
        double val_real = 0.0, val_ign = 0.0;
        for (int w = 0; w < words; ++w) {
          unsigned long long bits = avail[(size_t)w * pairs + p];
          while (bits) {
            const int g = 64 * w + __ffsll(static_cast<long long>(bits)) - 1;
            bits &= bits - 1ULL;
            const double v = row[g];
            if (!(v >= th)) continue;
            if (ign_a[g]) {
              if (best_ign < 0 || v >= val_ign) { best_ign = g; val_ign = v; }
            } else if (best_real < 0 || v >= val_real) {
              best_real = g;
              val_real = v;
            }
          }
        }
        const int best = best_real >= 0 ? best_real : best_ign;
        unsigned char m = 0, ig;
        if (best >= 0) {
          m = 1;
          ig = ign_a[best];
          if (!crowd[best]) avail[(size_t)(best >> 6) * pairs + p] &= ~(1ULL << (best & 63));
        } else {
          const double da = box_area(dbox + (size_t)(d0 + r) * 4);
          ig = da < lo || da > hi;
        }
        const size_t out = (size_t)(ds + d0 + r) * pairs + p;
        det_matches[out] = m;
        det_ignore[out] = ig;
      }
    }
  }
}

// The most dynamic shared memory a block of the kernel may use on `dev`,
// set once per device (the attribute is needed above 48 KB).
cudaError_t smem_limit(int dev, int* limit) {
  static std::mutex mu;
  static int cache[kMaxDevices] = {0};
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (cache[dev] == 0) {
    int optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(coco_greedy_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    cache[dev] = optin;
  }
  *limit = cache[dev];
  return cudaSuccess;
}

}  // namespace

// Pointers as described above, all on the current device and contiguous;
// n cells, the largest of them max_det detections and max_gt ground truths
// (they size the shared memory); num_areas * num_thrs (area, threshold)
// pairs. Launches on `stream` and returns the launch's CUDA error (0 when it
// was queued); cudaErrorInvalidValue for a size it does not take (one IoU row
// of max_gt doubles, the ignore flags and the availability words beyond the
// card's shared memory).
extern "C" int coco_greedy_match(const double* det_boxes, const double* gt_boxes, const unsigned char* gt_crowd,
                                 const double* gt_area, const int* cells, const double* thr, const double* area_lo,
                                 const double* area_hi, unsigned char* det_matches, unsigned char* det_ignore,
                                 long long n, int max_det, int max_gt, int num_areas, int num_thrs,
                                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 1 || n > 0x7fffffffLL || max_det < 0 || max_gt < 0 || num_areas < 1 || num_thrs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int pairs = num_areas * num_thrs;
  // a cell's fixed part and one IoU row grow with its ground truths, so the largest cell sets the least size
  const long long fixed = fixed_bytes(max_gt, pairs, num_areas);
  const long long row = 8LL * max_gt;
  const long long rows = row ? std::min<long long>(std::max(max_det, 1), std::max(1LL, (kTileTarget - fixed) / row)) : 0;
  const long long smem = fixed + rows * row;
  if (smem > kDefaultSmem) {
    int dev = 0, limit = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = smem_limit(dev, &limit);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (smem > limit) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = std::min(kMaxThreads, std::max(32, (pairs + 31) / 32 * 32));
  coco_greedy_match_kernel<<<static_cast<unsigned>(n), threads, static_cast<size_t>(smem), stream>>>(
      det_boxes, gt_boxes, gt_crowd, gt_area, cells, thr, area_lo, area_hi, det_matches, det_ignore, num_areas,
      num_thrs, smem);
  return static_cast<int>(cudaGetLastError());
}
