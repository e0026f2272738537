// COCO's greedy detection-to-ground-truth match for Hopper (sm_90a): every
// (image, class) cell of an evaluation in one call of three launches (two past 64 (area, threshold) pairs, where
// the block path takes every cell).
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
//   (det_start, det_count, gt_start, gt_count), 16-byte aligned; thr (T,)
//   float64 (min(threshold, 1 - 1e-10)); ranges (A, 2) float64, (lo, hi)
//   rows.
// Outputs, one row a detection: det_matches and det_ignore, (Nd, A, T)
// uint8, 16-byte aligned. Every detection row must belong to exactly one
// cell: the default rows are written for every row, the walks rewrite a
// cell's rows and no others.
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
// What bounds it: the bytes, above all the two (A, T) uint8 output rows of
// every detection (40 MB of the 60 MB at the COCO val2017 stream's call); the
// IoUs' fp64 work is a hundredth of that time. COCO's cells are tiny: at that
// call 173,458 cells, 86 % without a ground truth, 56 % of one detection,
// 79 % of those with ground truths holding one, the largest 49 x 17. So the
// bytes are written by a launch that knows nothing of cells, and the greedy
// walk runs beside it over the 14 % of cells that have ground truths:
//   1. sort_cells_kernel: the cell table into lists (the walks, heavy ones
//      first; the one-ground-truth cells; the block path's cells), a block's
//      cells of each kind placed with one atomicAdd a kind.
//   2. default_rows_kernel: every detection row as if its cell had no ground
//      truth (det_matches 0, det_ignore "its own area lies outside [lo,
//      hi]"), 32 rows a warp, staged in shared memory and stored 16 bytes a
//      lane, contiguous: a store pass at the card's memory rate. It lets the
//      next launch start at once (programmatic dependent launch) and keeps
//      kRowBlocks blocks an SM, so that the walks' blocks fit beside it.
//   3. coco_greedy_match_kernel, beside it: warps take work from shared
//      counters, so that a warp that finishes early takes more: first each
//      cell of 2-64 ground truths (heavy ones first, so that the last taken
//      are short), walked by the warp with its state in registers (lane g
//      holds ground truth g, lane p % 32 the availability word of pair p,
//      KP pairs a lane); the IoUs of up to kTile (detection, ground truth)
//      pairs at a time, one a lane, go to a tile in shared memory (rows of
//      the padded ground-truth count, a power of two) with a ballot of those
//      at or above the least threshold, and each detection with a candidate,
//      in order, scans its candidates g ascending, every lane reading the
//      same tile entry, so ">=" keeps the largest index. Then the cells of
//      one ground truth, kOneGrab at a time, their detections one a lane: at
//      pair (a, t) the ground truth goes to the first detection whose IoU
//      passes threshold t (to every such one for a crowd), an exclusive
//      OR-scan of the passed thresholds segmented by cell. Only rows with a
//      candidate are rewritten, as two bit masks over the pairs buffered in
//      shared memory and written, once the default rows have ended
//      (griddepcontrol.wait), with the widest stores a row allows. Last, the
//      blocks take the large cells (more than 64 ground truths, or more
//      than 64 pairs or 32 areas), one a block: the IoUs of 256 ground truths
//      at a time in shared memory and one thread per pair walking the
//      candidates, its availability bits in shared memory, the pairs in as
//      many groups as the block's shared memory needs.
// The shared memory a block gets is fixed, never sized by the cells, so the
// host reads nothing to launch; the block path then holds a cell of up to
// 64 * ((smem - kChunkBytes) / 8) ground truths, which
// coco_greedy_match_plan reports.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <mutex>

namespace {

constexpr int kWarps = 8;                 // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 2;             // walk blocks an SM should hold (caps the registers a thread)
constexpr int kTile = 256;                // IoUs a warp's tile holds
constexpr int kWarpMaxGt = 64;            // ground truths a warp holds in its lanes, two a lane
constexpr int kWarpMaxAreas = 32;         // area ranges the warp path's bit masks hold
constexpr int kWarpMaxPairs = 64;         // (area, threshold) pairs the warp path holds as bits of one word
constexpr int kHeavyWork = 64;            // detections x ground truths past which a walk is taken first
constexpr int kOneGrab = 4;               // cells of one ground truth a warp takes at a time
constexpr int kRowBlocks = 2;             // default-row blocks an SM holds, beside the walks' blocks
constexpr int kCounterStride = 16;        // 64-bit words between counters: one counter a 128-byte line
// The counters, zeroed by the caller, each on its own line: the four lists' lengths (0-3), then the walks, the
// one-ground-truth cells and the large cells taken from them.
constexpr int kWalksTaken = 4, kOnesTaken = 5, kLargeTaken = 6;
constexpr int kCounters = (kLargeTaken + 1) * kCounterStride;
constexpr int kChunk = kThreads;          // ground truths the block path takes at a time
constexpr int kChunkBytes = kChunk * (8 + 8 + 1) + 4 * (kChunk / 32);  // IoUs, areas, crowds, candidate words
constexpr int kLargeMin = 32 * 1024;      // least shared memory a walk block gets, for the block path
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kChunkBytes % 16 == 0, "the block path's availability words follow its chunk");

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// A walk's rewritten row, buffered in shared memory until the default rows are written: the row's first byte in
// the outputs, and det_matches and det_ignore as bits p = a * T + t (A x T <= 64).
struct Rewrite {
  long long out;
  unsigned long long matched, ignored;
};
constexpr int kRewrites = 64;  // rewrites a warp buffers

// A walk warp's shared bytes: its IoU tile, the tile's ballot words and its buffered rewrites.
constexpr int kWarpBytes = 8 * kTile + 4 * (kTile / 32) + kRewrites * static_cast<int>(sizeof(Rewrite));
static_assert(kWarpBytes % 16 == 0, "the warps' shared regions stay 16-byte aligned");

// Pairs a lane holds for A x T = pairs: 1 or 2 (32 * KP >= pairs); above 64 pairs every cell takes the block path,
// which any KP runs.
int lane_pairs(int pairs) { return pairs <= 32 ? 1 : pairs <= kWarpMaxPairs ? 2 : 1; }

// The dynamic shared memory of a walk block.
int block_smem() { return std::max(kLargeMin, kWarps * kWarpBytes); }

// Whether the warps walk cells of up to kWarpMaxGt ground truths at these counts (else the block path takes all).
__host__ __device__ bool warp_path(int num_areas, int num_thrs) {
  const int pairs = num_areas * num_thrs;
  return pairs <= kWarpMaxPairs && num_areas <= kWarpMaxAreas;
}

// np.maximum / np.minimum: a NaN operand is the result.
__device__ __forceinline__ double nan_max(double a, double b) { return (a >= b || a != a) ? a : b; }
__device__ __forceinline__ double nan_min(double a, double b) { return (a <= b || a != a) ? a : b; }

struct Box {
  double x0, y0, x1, y1;
};

__device__ __forceinline__ Box load_box(const double* p) { return {__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3)}; }

__device__ __forceinline__ double box_area(const Box& b) {
  return __dmul_rn(__dsub_rn(b.x1, b.x0), __dsub_rn(b.y1, b.y0));
}

__device__ __forceinline__ double box_iou(const Box& d, double da, const Box& g, double ga, bool crowd) {
  const double w = nan_max(__dsub_rn(nan_min(d.x1, g.x1), nan_max(d.x0, g.x0)), 0.0);
  const double h = nan_max(__dsub_rn(nan_min(d.y1, g.y1), nan_max(d.y0, g.y0)), 0.0);
  const double inter = __dmul_rn(w, h);
  const double uni = crowd ? da : __dsub_rn(__dadd_rn(da, ga), inter);
  return __ddiv_rn(inter, uni > 0.0 ? uni : 1.0);
}

// Bit a: the area lies outside range a of the (lo, hi) rows in shared memory.
__device__ __forceinline__ unsigned outside(double area, const double* s_ranges, int num_areas) {
  unsigned om = 0;
#pragma unroll 4
  for (int a = 0; a < num_areas; ++a)
    om |= static_cast<unsigned>(area < s_ranges[2 * a] || area > s_ranges[2 * a + 1]) << a;
  return om;
}

// Bits 0-7 of x as eight bytes of 0 or 1, byte i bit i (little endian).
__device__ __forceinline__ unsigned long long spread8(unsigned x) {
  const unsigned lo = ((x & 0xFu) * 0x00204081u) & 0x01010101u, hi = (((x >> 4) & 0xFu) * 0x00204081u) & 0x01010101u;
  return lo | static_cast<unsigned long long>(hi) << 32;
}

// Bits 0 .. width - 1 of `bits` as width bytes of 0 or 1 (width a power of two, at most 16) to an aligned dst.
__device__ __forceinline__ void store_bits(unsigned char* dst, unsigned bits, int width) {
  switch (width) {
    case 16: {
      const unsigned long long lo = spread8(bits), hi = spread8(bits >> 8);
      *reinterpret_cast<uint4*>(dst) = make_uint4(static_cast<unsigned>(lo), static_cast<unsigned>(lo >> 32),
                                                  static_cast<unsigned>(hi), static_cast<unsigned>(hi >> 32));
      break;
    }
    case 8: {
      const unsigned long long w = spread8(bits);
      *reinterpret_cast<uint2*>(dst) = make_uint2(static_cast<unsigned>(w), static_cast<unsigned>(w >> 32));
      break;
    }
    case 4: *reinterpret_cast<unsigned*>(dst) = static_cast<unsigned>(spread8(bits & 0xFu)); break;
    case 2: *reinterpret_cast<unsigned short*>(dst) = static_cast<unsigned short>(spread8(bits & 0x3u)); break;
    default: *dst = bits & 1u; break;
  }
}

// Lane r's row of a warp's staged rows: the A x T bytes of a detection that matched nothing, det_ignore's bit a
// of om repeated T times for each area a.
__device__ __forceinline__ void stage_row(unsigned char* r, unsigned om, int num_areas, int num_thrs) {
  for (int a = 0, p = 0; a < num_areas; ++a) {
    const unsigned char v = (om >> a) & 1u;
    for (int t = 0; t < num_thrs; ++t, ++p) r[p] = v;
  }
}

// One large cell, matched by the whole block (see the header); smem_bytes of dynamic shared memory.
__device__ void block_cell(const int4 row, const double* __restrict__ det_boxes, const double* __restrict__ gt_boxes,
                           const unsigned char* __restrict__ gt_crowd, const double* __restrict__ gt_area,
                           const double* __restrict__ thr, const double* __restrict__ ranges,
                           unsigned char* __restrict__ det_matches,
                           unsigned char* __restrict__ det_ignore, int num_thrs, int pairs, double th_min,
                           int smem_bytes, unsigned char* smem) {
  const long long ds = row.x, gs = row.z;
  const int nd = row.y, ng = row.w;
  const int tid = threadIdx.x, lane = tid & 31;
  double* s_iou = reinterpret_cast<double*>(smem);
  double* s_area = s_iou + kChunk;
  unsigned* s_cand = reinterpret_cast<unsigned*>(s_area + kChunk);
  unsigned char* s_crowd = reinterpret_cast<unsigned char*>(s_cand + kChunk / 32);
  unsigned long long* s_avail = reinterpret_cast<unsigned long long*>(smem + kChunkBytes);
  const int words = max((ng + 63) / 64, 1);
  const int group = min(min(pairs, kThreads), (smem_bytes - kChunkBytes) / (8 * words));  // >= 1: the host checks
  for (int p0 = 0; p0 < pairs; p0 += group) {
    const int gn = min(group, pairs - p0);
    for (int i = tid; i < gn * words; i += kThreads) {  // availability word w of pair p0 + i % gn
      const int left = ng - 64 * (i / gn);
      s_avail[i] = left >= 64 ? ~0ULL : (1ULL << left) - 1ULL;
    }
    const bool mine = tid < gn;
    const int p = p0 + (mine ? tid : 0);
    const int a = p / num_thrs;
    const double th = thr[p % num_thrs], lo = ranges[2 * a], hi = ranges[2 * a + 1];
    for (int d = 0; d < nd; ++d) {
      const Box db = load_box(det_boxes + (ds + d) * 4);
      const double da = box_area(db);
      int best_real = -1, best_ign = -1;
      double val_real = 0.0, val_ign = 0.0;
      bool crowd_ign = false;
      for (int g0 = 0; g0 < ng; g0 += kChunk) {
        __syncthreads();  // the chunk's last readers are done; the availability words are written
        const int g = g0 + tid;
        bool cand = false;
        if (g < ng) {
          const Box gb = load_box(gt_boxes + (gs + g) * 4);
          const bool crowd = __ldg(gt_crowd + gs + g) != 0;
          const double v = box_iou(db, da, gb, box_area(gb), crowd);
          s_iou[tid] = v;
          s_area[tid] = __ldg(gt_area + gs + g);
          s_crowd[tid] = crowd;
          cand = v >= th_min;
        }
        const unsigned bits = __ballot_sync(kFull, cand);
        if (lane == 0) s_cand[tid >> 5] = bits;
        __syncthreads();
        if (!mine) continue;
        for (int w = 0; w < kChunk / 32; ++w) {
          unsigned b = s_cand[w];
          while (b) {
            const int l = 32 * w + __ffs(b) - 1;
            b &= b - 1;
            const int gg = g0 + l;
            if (!((s_avail[(gg >> 6) * gn + tid] >> (gg & 63)) & 1ULL)) continue;
            const double v = s_iou[l];
            if (!(v >= th)) continue;
            const bool crowd = s_crowd[l] != 0;
            if (crowd || s_area[l] < lo || s_area[l] > hi) {
              if (best_ign < 0 || v >= val_ign) {
                best_ign = gg;
                val_ign = v;
                crowd_ign = crowd;
              }
            } else if (best_real < 0 || v >= val_real) {
              best_real = gg;
              val_real = v;
            }
          }
        }
      }
      if (mine) {
        unsigned char m = 1, ig = 0;
        if (best_real >= 0) {
          s_avail[(best_real >> 6) * gn + tid] &= ~(1ULL << (best_real & 63));
        } else if (best_ign >= 0) {
          ig = 1;
          if (!crowd_ign) s_avail[(best_ign >> 6) * gn + tid] &= ~(1ULL << (best_ign & 63));
        } else {
          m = 0;
          ig = da < lo || da > hi;
        }
        const long long out = (ds + d) * pairs + p;
        det_matches[out] = m;
        det_ignore[out] = ig;
      }
    }
    __syncthreads();  // every pair of the group is done with its words
  }
}


// The first launch: the cell table, sorted into lists for the walks, each (n, 4): in lists[0] the cells a warp
// walks, those of more than kHeavyWork detections x ground truths (counters[0] of them) from the front, the others
// (counters[1]) from the back; in lists[1] the cells of one ground truth (counters[2]); in lists[2] the cells the
// block path takes (more than kWarpMaxGt ground truths, or every cell where the warps walk none; counters[3]).
__global__ void __launch_bounds__(kThreads) sort_cells_kernel(const int4* __restrict__ cells,
                                                              unsigned long long* __restrict__ counters,
                                                              int4* __restrict__ lists, long long n, int num_areas,
                                                              int num_thrs) {
  __shared__ unsigned long long s_counts[kWarps][4], s_base[4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool warp_ok = warp_path(num_areas, num_thrs);
  // the cell table: block b takes cells [b C, (b + 1) C), warp w of it a run of those; the block counts its cells
  // of each kind, takes room for them with one atomicAdd a kind, and its warps then write them in order
  const long long per_block = (n + gridDim.x - 1) / gridDim.x, per_warp = (per_block + kWarps - 1) / kWarps;
  const long long lo = min(n, blockIdx.x * per_block + warp * per_warp);
  const long long hi = min(min(n, (blockIdx.x + 1) * per_block), lo + per_warp);
  unsigned long long own[4] = {0, 0, 0, 0};  // this warp's cells of each kind
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (lane == k) s_counts[warp][k] = own[k];
      __syncthreads();
      if (threadIdx.x < 4) {
        unsigned long long total = 0;
        for (int w = 0; w < kWarps; ++w) total += s_counts[w][threadIdx.x];
        s_base[threadIdx.x] = total ? atomicAdd(counters + kCounterStride * threadIdx.x, total) : 0ULL;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        own[k] = s_base[k];
        for (int w = 0; w < warp; ++w) own[k] += s_counts[w][k];
      }
    }
    for (long long c0 = lo; c0 < hi; c0 += 32) {
      const long long c = c0 + lane;
      const int4 r = c < hi ? cells[c] : make_int4(0, 0, 0, 0);
      const bool big = r.y > 0 && (r.w > kWarpMaxGt || !warp_ok);
      const bool walk = r.y > 0 && r.w > 0 && !big;
      const bool one = walk && r.w == 1;
      const bool heavy = walk && !one && static_cast<long long>(r.y) * r.w > kHeavyWork;
      // heavy walks from the front of lists[0], the warp's other walks from its back, the one-ground-truth cells
      // in lists[1], the block path's in lists[2]
      const unsigned kinds[4] = {__ballot_sync(kFull, heavy), __ballot_sync(kFull, walk && !one && !heavy),
                                 __ballot_sync(kFull, one), __ballot_sync(kFull, big)};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (pass == 1 && ((kinds[k] >> lane) & 1u)) {
          const long long at = static_cast<long long>(own[k]) + __popc(kinds[k] & ((1u << lane) - 1u));
          lists[k == 0 ? at : k == 1 ? n - 1 - at : (k - 1) * n + at] = r;
        }
        own[k] += __popc(kinds[k]);
      }
    }
  }
}

// The second launch: every detection row as if its cell had no ground truth (det_matches 0, det_ignore the
// detection's own area outside each range), 32 rows a warp at a time: lane r reads row r's box and stages its
// A x T bytes in shared memory, and the warp stores the 32 rows of each output, one contiguous span, 16 bytes a
// lane. The walks, launched next, may start at once beside it (griddepcontrol.launch_dependents): they rewrite
// the rows that have a candidate, after waiting for this launch to end.
__global__ void __launch_bounds__(kThreads) default_rows_kernel(const double* __restrict__ det_boxes,
                                                                const double* __restrict__ ranges,
                                                                unsigned char* __restrict__ det_matches,
                                                                unsigned char* __restrict__ det_ignore,
                                                                long long rows, int num_areas, int num_thrs) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double s_ranges[2 * kWarpMaxAreas];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pairs = num_areas * num_thrs;
  for (int i = threadIdx.x; i < 2 * num_areas; i += kThreads) s_ranges[i] = ranges[i];
  __syncthreads();
  const long long first = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  unsigned char* stage = smem + warp * round16(32 * pairs);
  const long long tiles = (rows + 31) / 32;
  for (long long t = first; t < tiles; t += nwarps) {
    const int rn = static_cast<int>(min(32LL, rows - 32 * t));
    if (lane < rn)
      stage_row(stage + lane * pairs,
                outside(box_area(load_box(det_boxes + (32 * t + lane) * 4)), s_ranges, num_areas), num_areas,
                num_thrs);
    __syncwarp();
    const long long out = 32 * t * pairs;  // 32 rows of pairs bytes: 16-byte aligned
    const int bytes = rn * pairs, words = bytes / 16;
    for (int w = lane; w < words; w += 32) {
      reinterpret_cast<uint4*>(det_ignore + out)[w] = reinterpret_cast<const uint4*>(stage)[w];
      reinterpret_cast<uint4*>(det_matches + out)[w] = make_uint4(0, 0, 0, 0);
    }
    for (int i = 16 * words + lane; i < bytes; i += 32) {  // the last tile's tail
      det_ignore[out + i] = stage[i];
      det_matches[out + i] = 0;
    }
    __syncwarp();  // the staging rows are free
  }
}

// The (area, threshold) pairs as bits p = a * T + t of one 64-bit word (A x T <= kWarpMaxPairs).
struct PairMasks {
  unsigned long long valid;  // the A x T pairs
  unsigned long long rep;    // bit a * T of each area: a T-bit threshold mask times rep is that mask at every area
  unsigned long long thrs;   // the T low bits
  int num_areas, num_thrs;

  // Each set bit a of `areas` as the T bits of area a.
  __device__ __forceinline__ unsigned long long by_area(unsigned areas) const {
    unsigned long long m = 0;
#pragma unroll 4
    for (int a = 0; a < num_areas; ++a)
      if ((areas >> a) & 1u) m |= thrs << (a * num_thrs);
    return m;
  }
};

// Waits for the default rows (griddepcontrol.wait: the launch before has ended and its stores are visible), then
// writes a warp's `count` buffered rewrites, one a lane; returns 0, the buffer's new count.
__device__ __forceinline__ int flush_rewrites(const Rewrite* buf, int count, unsigned char* __restrict__ det_matches,
                                              unsigned char* __restrict__ det_ignore, int pairs, int width) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  __syncwarp();
  for (int e = threadIdx.x & 31; e < count; e += 32) {
    const Rewrite r = buf[e];
    for (int p0 = 0; p0 < pairs; p0 += width) {
      store_bits(det_matches + r.out + p0, static_cast<unsigned>(r.matched >> p0), width);
      store_bits(det_ignore + r.out + p0, static_cast<unsigned>(r.ignored >> p0), width);
    }
  }
  __syncwarp();  // the buffer is free
  return 0;
}

// The third launch, beside the second (see the header). Its warps take the first launch's lists from shared
// counters: the cells of 2-64 ground truths one at a time, the heavy ones first, each walked by the warp; then the
// cells of one ground truth kOneGrab at a time, their detections one a lane. Both rewrite the rows of detections
// that have a candidate. Then the blocks take the first launch's large cells one at a time.
template <int KP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    coco_greedy_match_kernel(const double* __restrict__ det_boxes, const double* __restrict__ gt_boxes,
                             const unsigned char* __restrict__ gt_crowd, const double* __restrict__ gt_area,
                             const double* __restrict__ thr, const double* __restrict__ ranges,
                             unsigned char* __restrict__ det_matches, unsigned char* __restrict__ det_ignore,
                             unsigned long long* __restrict__ counters, const int4* __restrict__ lists,
                             long long n, int num_areas, int num_thrs, int smem_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long taken;
  __shared__ double s_ranges[2 * kWarpMaxAreas], s_thr[kWarpMaxPairs];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pairs = num_areas * num_thrs;
  const bool warp_ok = warp_path(num_areas, num_thrs);
  const int width = min(pairs & -pairs, 16);  // a row is a whole number of width-byte words
  if (warp_ok) {
    for (int i = threadIdx.x; i < 2 * num_areas; i += kThreads) s_ranges[i] = ranges[i];
    for (int i = threadIdx.x; i < num_thrs; i += kThreads) s_thr[i] = thr[i];
  }
  PairMasks masks;
  masks.num_areas = num_areas;
  masks.num_thrs = num_thrs;
  masks.valid = pairs >= 64 ? ~0ULL : (1ULL << pairs) - 1ULL;
  masks.thrs = num_thrs >= 64 ? ~0ULL : (1ULL << num_thrs) - 1ULL;
  masks.rep = 0;
  if (warp_ok)
    for (int a = 0; a < num_areas; ++a) masks.rep |= 1ULL << (a * num_thrs);

  // the least threshold: an IoU below it is a candidate at no pair (a NaN threshold matches nothing)
  double th_min = __longlong_as_double(0x7ff0000000000000LL);
  for (int t = 0; t < num_thrs; ++t) th_min = thr[t] < th_min ? thr[t] : th_min;
  // the lane's pairs p = lane + 32 k
  double th[KP];
  int area_of[KP];
  bool has[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const int p = lane + 32 * k;
    has[k] = p < pairs;
    area_of[k] = has[k] ? p / num_thrs : 0;
    th[k] = thr[has[k] ? p % num_thrs : 0];
  }
  unsigned char* own = smem + warp * kWarpBytes;
  double* tile = reinterpret_cast<double*>(own);
  unsigned* tile_bits = reinterpret_cast<unsigned*>(own + 8 * kTile);
  Rewrite* rewrites = reinterpret_cast<Rewrite*>(own + 8 * kTile + 4 * (kTile / 32));
  int buffered = 0;  // rewrites waiting in the buffer: rows rewritten as bit masks wait while the default rows are written
  __syncthreads();  // the ranges are in shared memory

  // the first launch's lists: the warp's walks (heavy ones at the front of lists[0], the others at its back), one
  // at a time, then the one-ground-truth cells of lists[1], kOneGrab at a time, each from its counter
  const long long heavy_n = static_cast<long long>(counters[0]);
  const long long items = heavy_n + static_cast<long long>(counters[kCounterStride]);
  const long long ones = static_cast<long long>(counters[2 * kCounterStride]);
  const int4 none = make_int4(0, 0, 0, 0);
  for (;;) {
    unsigned long long at = 0;
    if (lane == 0) at = atomicAdd(counters + kWalksTaken * kCounterStride, 1ULL);
    const long long i = static_cast<long long>(__shfl_sync(kFull, at, 0));
    if (i >= items) break;
    const int4 row = i < heavy_n ? lists[i] : lists[n - 1 - (i - heavy_n)];
    {  // the warp's walk of this cell
      const long long ds = row.x, gs = row.z;
      const int cnd = row.y, cng = row.w;
      // loads, all at once: lane g holds ground truth g (ground truths 32-63 are read where needed), lane j
      // detection j of the first 32
      Box gbox = {0.0, 0.0, 0.0, 0.0}, db = {0.0, 0.0, 0.0, 0.0};
      double gar = 0.0, gar1 = 0.0;
      bool gcr = false, gcr1 = false;
      if (lane < cng) {
        gbox = load_box(gt_boxes + (gs + lane) * 4);
        gar = __ldg(gt_area + gs + lane);
        gcr = __ldg(gt_crowd + gs + lane) != 0;
      }
      if (lane + 32 < cng) {
        gar1 = __ldg(gt_area + gs + 32 + lane);
        gcr1 = __ldg(gt_crowd + gs + 32 + lane) != 0;
      }
      if (lane < cnd) db = load_box(det_boxes + (ds + lane) * 4);
      const double gba = box_area(gbox);
      // crowds and, per area, ignored ground truths as bit masks over g
      const unsigned long long crowd =
          __ballot_sync(kFull, gcr) | static_cast<unsigned long long>(__ballot_sync(kFull, gcr1)) << 32;
      unsigned long long ign[KP], avail[KP];
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        ign[k] = 0;
        avail[k] = cng == 64 ? ~0ULL : (1ULL << cng) - 1ULL;
      }
#pragma unroll 4
      for (int a = 0; a < num_areas; ++a) {
        const double lo = s_ranges[2 * a], hi = s_ranges[2 * a + 1];
        const unsigned long long m =
            __ballot_sync(kFull, lane < cng && (gcr || gar < lo || gar > hi)) |
            static_cast<unsigned long long>(__ballot_sync(kFull, lane + 32 < cng && (gcr1 || gar1 < lo || gar1 > hi)))
                << 32;
#pragma unroll
        for (int k = 0; k < KP; ++k) ign[k] = area_of[k] == a ? m : ign[k];
      }
      int lg = 0;  // log2 of the padded ground-truth count
      while ((1 << lg) < cng) ++lg;
      const int tile_rows = min(32, kTile >> lg);
      for (int d0 = 0; d0 < cnd; d0 += 32) {
        const int rn = min(32, cnd - d0);
        if (d0 > 0) db = lane < rn ? load_box(det_boxes + (ds + d0 + lane) * 4) : Box{0.0, 0.0, 0.0, 0.0};
        const double da = box_area(db);
        const unsigned om = outside(da, s_ranges, num_areas);  // of row d0 + lane
        for (int r0 = 0; r0 < rn; r0 += tile_rows) {
          const int rr = min(tile_rows, rn - r0), elems = rr << lg;
          // the IoUs of rows r0 .. r0 + rr - 1, one (row, ground truth) a lane, and a ballot of the candidates
          for (int e0 = 0; e0 < elems; e0 += 32) {
            const int e = e0 + lane;
            const int j = (r0 + (e >> lg)) & 31, g = e & ((1 << lg) - 1);
            const Box dj = {__shfl_sync(kFull, db.x0, j), __shfl_sync(kFull, db.y0, j), __shfl_sync(kFull, db.x1, j),
                            __shfl_sync(kFull, db.y1, j)};
            const double daj = __shfl_sync(kFull, da, j);
            Box gb = {__shfl_sync(kFull, gbox.x0, g & 31), __shfl_sync(kFull, gbox.y0, g & 31),
                      __shfl_sync(kFull, gbox.x1, g & 31), __shfl_sync(kFull, gbox.y1, g & 31)};
            double ga = __shfl_sync(kFull, gba, g & 31);
            const bool ok = e < elems && g < cng;
            if (ok && g >= 32) {  // ground truths 32-63: from memory
              gb = load_box(gt_boxes + (gs + g) * 4);
              ga = box_area(gb);
            }
            double v = 0.0;
            if (ok) {
              v = box_iou(dj, daj, gb, ga, (crowd >> g) & 1ULL);
              tile[e] = v;
            }
            const unsigned bits = __ballot_sync(kFull, ok && v >= th_min);
            if (lane == 0) tile_bits[e0 >> 5] = bits;
          }
          __syncwarp();
          // lane jj: the candidates of row r0 + jj
          unsigned long long cand = 0;
          if (lane < rr) {
            const int eb = lane << lg;
            if (lg == 6) {
              cand = tile_bits[eb >> 5] | static_cast<unsigned long long>(tile_bits[(eb >> 5) + 1]) << 32;
            } else {
              const unsigned w = tile_bits[eb >> 5] >> (eb & 31);
              cand = lg == 5 ? w : w & ((1u << (1 << lg)) - 1u);
            }
          }
          unsigned rows = __ballot_sync(kFull, cand != 0);
          // the greedy walk over the rows with a candidate, in order, every lane its pairs
          while (rows) {
            const int jj = __ffs(rows) - 1;
            rows &= rows - 1;
            unsigned long long cj = __shfl_sync(kFull, cand, jj);
            const unsigned omj = __shfl_sync(kFull, om, r0 + jj);
            int best_real[KP], best_ign[KP];
            double val_real[KP], val_ign[KP];
#pragma unroll
            for (int k = 0; k < KP; ++k) {
              best_real[k] = best_ign[k] = -1;
              val_real[k] = val_ign[k] = 0.0;
            }
            while (cj) {
              const int g = __ffsll(static_cast<long long>(cj)) - 1;
              cj &= cj - 1ULL;
              const double v = tile[(jj << lg) + g];
#pragma unroll
              for (int k = 0; k < KP; ++k) {
                if (!((avail[k] >> g) & 1ULL) || !(v >= th[k])) continue;
                if ((ign[k] >> g) & 1ULL) {
                  if (best_ign[k] < 0 || v >= val_ign[k]) {
                    best_ign[k] = g;
                    val_ign[k] = v;
                  }
                } else if (best_real[k] < 0 || v >= val_real[k]) {
                  best_real[k] = g;
                  val_real[k] = v;
                }
              }
            }
            const long long out = (ds + d0 + r0 + jj) * pairs;
            unsigned long long matched = 0, ignored = 0;
#pragma unroll
            for (int k = 0; k < KP; ++k) {
              const int best = best_real[k] >= 0 ? best_real[k] : best_ign[k];
              unsigned char m = 0, ig = (omj >> area_of[k]) & 1u;
              if (best >= 0) {
                m = 1;
                ig = best_real[k] < 0;  // a non-ignored ground truth is never a crowd
                if (!((crowd >> best) & 1ULL)) avail[k] &= ~(1ULL << best);
              }
              matched |= static_cast<unsigned long long>(__ballot_sync(kFull, has[k] && m)) << (32 * k);
              ignored |= static_cast<unsigned long long>(__ballot_sync(kFull, has[k] && ig)) << (32 * k);
            }
            if (lane == 0) rewrites[buffered] = Rewrite{out, matched, ignored};
            if (++buffered == kRewrites) buffered = flush_rewrites(rewrites, buffered, det_matches, det_ignore, pairs, width);
          }
          __syncwarp();  // the tile is free for the next rows
        }
      }
    }
  }
  // The cells of one ground truth g. With one ground truth the greedy walk has a closed form: at pair (a, t), g goes
  // to the first detection in order whose IoU is at or above threshold t (and is claimed there, at every area
  // alike, since g is a candidate whether ignored at an area or not), or, where g is a crowd, to every such
  // detection. So the warp takes kOneGrab cells at a time and their detections 32 at a time, one a lane, and a
  // detection wins the thresholds it passes that no detection of its cell before it passed: an exclusive OR-scan
  // segmented by cell, carried from one round to the next. det_ignore of a matched pair is g's being ignored at
  // that area; a row that passes no threshold keeps the second launch's default, the others are rewritten.
  for (;;) {
    unsigned long long at = 0;
    if (lane == 0) at = atomicAdd(counters + kOnesTaken * kCounterStride, static_cast<unsigned long long>(kOneGrab));
    const long long base = static_cast<long long>(__shfl_sync(kFull, at, 0));
    if (base >= ones) break;
    const int4 row = lane < kOneGrab && base + lane < ones ? lists[n + base + lane] : none;
    const int count = max(row.y, 0);
    int incl = count;  // inclusive prefix sum of the cells' detections over the lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    const int excl = incl - count, total = __shfl_sync(kFull, incl, 31);
    int carry_cell = -1;             // the cell whose detections run on from the round before
    unsigned long long carry = 0;    // the thresholds its detections passed there
    for (int q0 = 0; q0 < total; q0 += 32) {
      const int q = q0 + lane;
      int src = 0;  // the lane (cell) holding detection q: the first whose inclusive sum exceeds q
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (__shfl_sync(kFull, incl, src + step - 1) <= q) src += step;
      const bool valid = q < total;
      const long long ds = __shfl_sync(kFull, row.x, src), gs = __shfl_sync(kFull, row.z, src);
      const int d = q - __shfl_sync(kFull, excl, src);
      const int above = __shfl_up_sync(kFull, src, 1);
      bool head = lane == 0 || src != above;  // the first of its cell in this round
      unsigned long long passed = 0;
      bool crowd = false;
      unsigned long long gign = 0;
      double da = 0.0;
      if (valid) {
        const Box db = load_box(det_boxes + (ds + d) * 4), gb = load_box(gt_boxes + gs * 4);
        crowd = __ldg(gt_crowd + gs) != 0;
        const double garea = __ldg(gt_area + gs);
        da = box_area(db);
        const double v = box_iou(db, da, gb, box_area(gb), crowd);
        if (v >= th_min) {
#pragma unroll 8
          for (int t = 0; t < num_thrs; ++t) passed |= static_cast<unsigned long long>(v >= s_thr[t]) << t;
        }
        gign = crowd ? masks.valid : masks.by_area(outside(garea, s_ranges, num_areas));
      }
      // the OR of `passed` over the cell's lanes up to this one (a segmented inclusive scan)
      unsigned long long seen = passed;
      bool closed = head;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned long long v = __shfl_up_sync(kFull, seen, off);
        const bool c = __shfl_up_sync(kFull, closed, off);
        if (lane >= off && !closed) seen |= v;
        if (lane >= off) closed = closed || c;
      }
      unsigned long long before = __shfl_up_sync(kFull, seen, 1);
      if (head) before = 0;
      if (src == carry_cell) before |= carry;
      const unsigned long long won = crowd ? passed : passed & ~before;
      // the last lane's cell may run on into the next round
      const int last = __shfl_sync(kFull, src, 31);
      const unsigned long long last_seen = __shfl_sync(kFull, seen, 31);
      carry = last_seen | (last == carry_cell ? carry : 0ULL);
      carry_cell = last;
      const bool rewrite = valid && passed;
      const unsigned adds = __ballot_sync(kFull, rewrite);
      if (buffered + __popc(adds) > kRewrites)
        buffered = flush_rewrites(rewrites, buffered, det_matches, det_ignore, pairs, width);
      if (rewrite) {
        const unsigned long long matched = won * masks.rep & masks.valid;
        const unsigned long long ignored =
            (matched & gign) | (masks.by_area(outside(da, s_ranges, num_areas)) & ~matched);
        rewrites[buffered + __popc(adds & ((1u << lane) - 1u))] = Rewrite{(ds + d) * pairs, matched, ignored};
      }
      buffered += __popc(adds);
    }
  }

  __syncwarp();
  flush_rewrites(rewrites, buffered, det_matches, det_ignore, pairs, width);  // (waits, whatever is left)

  // ---- the block path: the first launch's large cells, one a block at a time (after the wait above, where the
  // default rows were launched)
  const long long count = static_cast<long long>(counters[3 * kCounterStride]);
  for (;;) {
    __syncthreads();  // `taken` is free
    if (threadIdx.x == 0) taken = static_cast<long long>(atomicAdd(counters + kLargeTaken * kCounterStride, 1ULL));
    __syncthreads();
    const long long i = taken;
    if (i >= count) break;
    block_cell(lists[2 * n + i], det_boxes, gt_boxes, gt_crowd, gt_area, thr, ranges, det_matches, det_ignore, num_thrs,
               pairs, th_min, smem_bytes, smem);
  }
}

const void* walk_kernel(int kp) {
  return kp == 1 ? reinterpret_cast<const void*>(&coco_greedy_match_kernel<1>)
                 : reinterpret_cast<const void*>(&coco_greedy_match_kernel<2>);
}

// Blocks of kernel `fn` (cache slot `slot`) an SM holds at `smem` bytes, and the SMs, per device (queried once a
// size; above 48 KB the kernel's dynamic shared-memory limit is raised to `smem` first).
cudaError_t occupancy(int dev, int slot, const void* fn, int smem, int* per_sm, int* sms) {
  static std::mutex mu;
  static int cache_sms[kMaxDevices] = {0};
  static int cache_optin[kMaxDevices][4] = {{0}};  // the dynamic shared-memory limit set
  static int cache_smem[kMaxDevices][4] = {{0}}, cache_blocks[kMaxDevices][4] = {{0}};
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  cudaError_t err = cudaSuccess;
  if (cache_sms[dev] == 0) err = cudaDeviceGetAttribute(&cache_sms[dev], cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > kDefaultSmem && cache_optin[dev][slot] < smem) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) cache_optin[dev][slot] = smem;
  }
  if (err == cudaSuccess && cache_smem[dev][slot] != smem + 1) {  // the cache holds smem + 1: 0 is "not queried"
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, smem);
    if (err == cudaSuccess && blocks < 1) err = cudaErrorInvalidConfiguration;
    if (err == cudaSuccess) {
      cache_smem[dev][slot] = smem + 1;
      cache_blocks[dev][slot] = blocks;
    }
  }
  if (err != cudaSuccess) return err;
  *per_sm = cache_blocks[dev][slot];
  *sms = cache_sms[dev];
  return cudaSuccess;
}

}  // namespace

// For num_areas * num_thrs pairs: out[0] the largest ground-truth count of a cell the launch takes (the block
// path's shared memory), out[1] the dynamic shared memory of a walk block, out[2] the threads of a block, out[3]
// the pairs a lane holds (KP), out[4] the most ground truths a cell of the warp path holds (0: every cell takes
// the block path), out[5] the 64-bit words of the zeroed counters the launches need, out[6] the words between two
// counters (the first four, the lists' lengths, count the cells the first launch put in each list: heavy walks,
// other walks, one-ground-truth cells, the block path's cells). Returns 0, or cudaErrorInvalidValue for a count it
// does not take.
extern "C" int coco_greedy_match_plan(int num_areas, int num_thrs, int* out) {
  if (num_areas < 1 || num_thrs < 1 || static_cast<long long>(num_areas) * num_thrs > (1 << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  const int pairs = num_areas * num_thrs, smem = block_smem();
  out[0] = 64 * ((smem - kChunkBytes) / 8);
  out[1] = smem;
  out[2] = kThreads;
  out[3] = lane_pairs(pairs);
  out[4] = warp_path(num_areas, num_thrs) ? kWarpMaxGt : 0;
  out[5] = kCounters;
  out[6] = kCounterStride;
  return 0;
}

// Pointers as described above, all on the current device and contiguous; counters plan[5] zeroed words and lists
// room for 3 x n cell rows, both the launches' scratch; rows detection rows and n cells (none larger than
// coco_greedy_match_plan's out[0] ground truths: the caller checks); num_areas * num_thrs (area, threshold)
// pairs. Launches on `stream` the cell sort, the default rows (where the warps walk cells) and the walks, the last
// with programmatic stream serialization, where the default rows were launched, so that they may run beside them
// (the walks read the sort's lists at once, and the default rows start after the sort has ended); writes the three grids'
// blocks to blocks[0..2] (0: not launched) and returns the launches' CUDA error (0 when they were queued).
extern "C" int coco_greedy_match(const double* det_boxes, const double* gt_boxes, const unsigned char* gt_crowd,
                                 const double* gt_area, const int* cells, const double* thr, const double* ranges,
                                 unsigned char* det_matches, unsigned char* det_ignore, unsigned long long* counters,
                                 int* lists, long long rows, long long n, int num_areas, int num_thrs,
                                 void* stream_ptr, int* blocks) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int plan[7];
  if (n < 1 || rows < 0 || coco_greedy_match_plan(num_areas, num_thrs, plan) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {static_cast<const void*>(cells), static_cast<const void*>(lists),
                        static_cast<const void*>(det_matches), static_cast<const void*>(det_ignore)})
    if (reinterpret_cast<std::uintptr_t>(p) % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  const int smem = plan[1], kp = plan[3];
  const int4* c4 = reinterpret_cast<const int4*>(cells);
  int4* l4 = reinterpret_cast<int4*>(lists);
  blocks[0] = blocks[1] = blocks[2] = 0;
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = occupancy(dev, 0, reinterpret_cast<const void*>(&sort_cells_kernel), 0, &per_sm, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long grid = std::min(static_cast<long long>(per_sm) * sms, (n + 255) / 256);  // some 256 cells a block
  blocks[0] = static_cast<int>(grid);
  sort_cells_kernel<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(c4, counters, l4, n, num_areas, num_thrs);
  err = cudaGetLastError();
  if (err == cudaSuccess && plan[4] > 0 && rows > 0) {  // the walks rewrite these rows where they match
    const int rows_smem = kWarps * round16(32 * num_areas * num_thrs);
    err = occupancy(dev, 1, reinterpret_cast<const void*>(&default_rows_kernel), rows_smem, &per_sm, &sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    // kRowBlocks a card's SM, so that the walks' blocks fit beside them
    grid = std::min(static_cast<long long>(std::min(per_sm, kRowBlocks)) * sms, ((rows + 31) / 32 + kWarps - 1) / kWarps);
    blocks[1] = static_cast<int>(grid);
    default_rows_kernel<<<static_cast<unsigned>(grid), kThreads, rows_smem, stream>>>(
        det_boxes, ranges, det_matches, det_ignore, rows, num_areas, num_thrs);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) err = occupancy(dev, 1 + kp, walk_kernel(kp), smem, &per_sm, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  grid = std::min(static_cast<long long>(per_sm) * sms, (n + kWarps - 1) / kWarps);
  blocks[2] = static_cast<int>(grid);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(grid));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attribute[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attribute;
  config.numAttrs = blocks[1] > 0 ? 1 : 0;
  const double* gb = gt_boxes;
  const unsigned char* gc = gt_crowd;
  const double* ga = gt_area;
  const int4* lc = l4;
  if (kp == 1)
    err = cudaLaunchKernelEx(&config, coco_greedy_match_kernel<1>, det_boxes, gb, gc, ga, thr, ranges, det_matches,
                             det_ignore, counters, lc, n, num_areas, num_thrs, smem);
  else
    err = cudaLaunchKernelEx(&config, coco_greedy_match_kernel<2>, det_boxes, gb, gc, ga, thr, ranges, det_matches,
                             det_ignore, counters, lc, n, num_areas, num_thrs, smem);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
