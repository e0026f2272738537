// BERTScore's greedy cosine matching, for Hopper (sm_90a): each (sentence,
// layer) cell's precision, recall and F1 from its token embeddings, with the
// (p, r) similarity matrix kept on the chip.
//
// Replaces no Pallas kernel: it replaces XLA's fusion of
// tpumetrics/functional/text/bert.py, function _get_precision_recall_f1
// (:98-120): one full-precision einsum into a (b, l, p, r) similarity tensor,
// its row and column maxima, and two idf-weighted sums. As torch ops on the
// card those lines write the similarity tensor and read it twice: at
// all_layers with RoBERTa-large (25 hidden states), 64 sentences and 512
// tokens, 1.7 GB for every chunk of the corpus.
//
// For unit-normalized float32 embeddings pe (n, L, Sp, D) and te (n, L, St, D)
// (zero at special and pad positions) and float32 scales ps (n, Sp), ts (n, St),
// each cell (b, l) writes
//
//     P[b,l] = sum_p ps[b,p] * max_r <pe[b,l,p], te[b,l,r]>
//     R[b,l] = sum_r ts[b,r] * max_p <pe[b,l,p], te[b,l,r]>
//     F1     = 2 P R / (P + R), and 0 where that is NaN
//
// The maxima run over every row and column of the cell, zero ones included
// (their cosine is 0): the kernel skips nothing but the tiles' ragged edges,
// and a NaN similarity wins a maximum, as it does in torch's amax.
//
// What bounds it on an H100 SXM: the operations. The products are
// 2 n L Sp St D float32 operations (at all_layers, 64 x 25 x 512 x 512 x 1024:
// 8.6e11, 12.8 ms at 67 TFLOP/s on the CUDA cores) against 6.7 GB of inputs
// read once (2.0 ms at 3.35 TB/s). JAX's einsum runs at Precision.HIGHEST, so
// the products are float32 FMAs, not TF32 or bf16 on the tensor cores.
//
// The design: one block of 256 threads (16 x 16) a cell. The cell's rows (p)
// and columns (r) go in square tiles of 16 TM, each thread holding a TM x TM
// block of the tile's similarities in registers; the tile is sized to the
// cell (64, 96 or 128: bert_greedy_match_tile), so that a cell of some 90
// tokens a side, an MT segment's, does not pad to 128 x 128. For each pair of
// tiles, chunks of 8 of D are staged through shared memory, transposed, in two
// buffers: the next chunk's loads (16 bytes a thread where D allows) are in
// flight while the current one is multiplied, and one barrier a chunk
// separates them. A thread's rows and columns lie in groups of V contiguous
// ones 16 V apart, so that its operands are vector reads (float4 or float2)
// without bank conflicts. A thread carries its rows' maxima in registers
// across the column tiles, then 16 lanes meet them by shuffles; the column
// maxima meet through shared memory after each tile pair and live in shared
// memory for the whole cell. The two weighted sums run in one fixed order (a
// warp each: strided partials, then a shuffle tree), so two calls give the
// same bits. The similarity tensor is never written; there is one launch a
// call, on the caller's stream, and no host read.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 8;     // entries of D staged at a time
constexpr int kThreads = 256;  // 16 x 16 threads

__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

template <int TM>
struct Tile {
  static constexpr int kRows = 16 * TM;                 // rows (or columns) of a tile
  static constexpr int kStride = kRows + 4;             // a staged k of the tile, padded (16-byte aligned)
  static constexpr int kV = TM % 4 == 0 ? 4 : 2;        // contiguous rows a thread holds in a group
  static constexpr int kLoaders = kRows * kChunk / 4;   // threads that stage 4 entries of D each
  static constexpr int kBuffer = kChunk * kStride;      // floats of one staged operand chunk
  // shared floats before the maxima: two buffers of both operands, the column partials, the sums
  static constexpr int kFixed = 4 * kBuffer + 16 * kRows + 4;
};

// Four entries of D (k0 + 4 kq ...) of one row of a tile, zero past the rows or D.
__device__ __forceinline__ float4 fetch(const float* src, int row, int rows, int k, int dim, bool vec) {
  if (row >= rows) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float* p = src + (long long)row * dim + k;
  if (vec) return k < dim ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 v;
  v.x = k < dim ? __ldg(p) : 0.0f;
  v.y = k + 1 < dim ? __ldg(p + 1) : 0.0f;
  v.z = k + 2 < dim ? __ldg(p + 2) : 0.0f;
  v.w = k + 3 < dim ? __ldg(p + 3) : 0.0f;
  return v;
}

template <int TM>
__device__ __forceinline__ void put(float* dst, int row, int kq, float4 v) {
  constexpr int S = Tile<TM>::kStride;
  dst[(kq * 4 + 0) * S + row] = v.x;
  dst[(kq * 4 + 1) * S + row] = v.y;
  dst[(kq * 4 + 2) * S + row] = v.z;
  dst[(kq * 4 + 3) * S + row] = v.w;
}

// TM operands of one staged k: groups of V contiguous entries, 16 V apart.
template <int TM>
__device__ __forceinline__ void operands(float (&x)[TM], const float* s, int t) {
  constexpr int V = Tile<TM>::kV;
#pragma unroll
  for (int g = 0; g < TM / V; ++g) {
    const float* p = s + g * 16 * V + t * V;
    if constexpr (V == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      x[g * 4 + 0] = v.x, x[g * 4 + 1] = v.y, x[g * 4 + 2] = v.z, x[g * 4 + 3] = v.w;
    } else {
      const float2 v = *reinterpret_cast<const float2*>(p);
      x[g * 2 + 0] = v.x, x[g * 2 + 1] = v.y;
    }
  }
}

template <int TM>
__device__ __forceinline__ int lane_row(int i, int t) {
  constexpr int V = Tile<TM>::kV;
  return (i / V) * 16 * V + t * V + i % V;
}

template <int TM>
__global__ void __launch_bounds__(kThreads, 2) bert_greedy_match_kernel(
    const float* __restrict__ pe, const float* __restrict__ te, const float* __restrict__ ps,
    const float* __restrict__ ts, int sp, int st, int dim, long long layers, bool vec, float* __restrict__ precision,
    float* __restrict__ recall, float* __restrict__ f1) {
  using T = Tile<TM>;
  constexpr int BM = T::kRows;
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                          // [2][kChunk][kStride]: the row tile, transposed
  float* b_s = a_s + 2 * T::kBuffer;          // [2][kChunk][kStride]: the column tile, transposed
  float* col_part = b_s + 2 * T::kBuffer;     // [16][BM]: each thread row's column maxima of a tile
  float* sums = col_part + 16 * BM;           // [4]: P and R
  float* row_max = sums + 4;                  // [sp]
  float* col_max = row_max + sp;              // [st]

  const long long cell = blockIdx.x;
  const long long b = cell / layers;
  const float* A = pe + cell * sp * (long long)dim;
  const float* B = te + cell * st * (long long)dim;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const bool loader = tid < T::kLoaders;
  const int lrow = tid / (kChunk / 4), lkq = tid % (kChunk / 4);  // the row and quarter of D this thread stages
  const int chunks = (dim + kChunk - 1) / kChunk;

  for (int r = tid; r < st; r += kThreads) col_max[r] = -INFINITY;
  __syncthreads();

  for (int p0 = 0; p0 < sp; p0 += BM) {
    float rmax[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) rmax[i] = -INFINITY;
    for (int r0 = 0; r0 < st; r0 += BM) {
      float acc[TM][TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = 0.0f;
      float4 na = make_float4(0.0f, 0.0f, 0.0f, 0.0f), nb = na;
      if (loader) {
        na = fetch(A, p0 + lrow, sp, lkq * 4, dim, vec);
        nb = fetch(B, r0 + lrow, st, lkq * 4, dim, vec);
        put<TM>(a_s, lrow, lkq, na);
        put<TM>(b_s, lrow, lkq, nb);
      }
      __syncthreads();
      for (int c = 0; c < chunks; ++c) {
        const int cur = c & 1;
        const bool next = c + 1 < chunks;
        if (loader && next) {
          const int k = (c + 1) * kChunk + lkq * 4;
          na = fetch(A, p0 + lrow, sp, k, dim, vec);
          nb = fetch(B, r0 + lrow, st, k, dim, vec);
        }
        const float* as = a_s + cur * T::kBuffer;
        const float* bs = b_s + cur * T::kBuffer;
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          float a[TM], v[TM];
          operands<TM>(a, as + k * T::kStride, ty);
          operands<TM>(v, bs + k * T::kStride, tx);
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
        }
        if (loader && next) {
          put<TM>(a_s + (cur ^ 1) * T::kBuffer, lrow, lkq, na);
          put<TM>(b_s + (cur ^ 1) * T::kBuffer, lrow, lkq, nb);
        }
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const int col = lane_row<TM>(j, tx);
        const bool col_ok = r0 + col < st;
        float m = -INFINITY;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          if (col_ok) rmax[i] = nan_max(rmax[i], acc[i][j]);
          if (p0 + lane_row<TM>(i, ty) < sp) m = nan_max(m, acc[i][j]);
        }
        col_part[ty * BM + col] = m;
      }
      __syncthreads();
      if (tid < BM && r0 + tid < st) {
        float m = col_max[r0 + tid];
        for (int y = 0; y < 16; ++y) m = nan_max(m, col_part[y * BM + tid]);
        col_max[r0 + tid] = m;
      }
      __syncthreads();
    }
    // the 16 lanes of a half warp share their rows (ty) and hold different columns
#pragma unroll
    for (int i = 0; i < TM; ++i)
      for (int off = 8; off >= 1; off >>= 1) rmax[i] = nan_max(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], off));
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = p0 + lane_row<TM>(i, ty);
        if (row < sp) row_max[row] = rmax[i];
      }
    }
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  if (warp < 2) {  // warp 0: P over the rows, warp 1: R over the columns; each in one fixed order
    const int n = warp == 0 ? sp : st;
    const float* w = warp == 0 ? ps + b * sp : ts + b * st;
    const float* m = warp == 0 ? row_max : col_max;
    float s = 0.0f;
    for (int i = lane; i < n; i += 32) s = fmaf(w[i], m[i], s);
    for (int off = 16; off >= 1; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) sums[warp] = s;
  }
  __syncthreads();
  if (tid == 0) {
    const float p = sums[0], r = sums[1];
    float f = 2.0f * p * r / (p + r);
    if (f != f) f = 0.0f;
    precision[cell] = p;
    recall[cell] = r;
    f1[cell] = f;
  }
}

template <int TM>
int launch(const float* pe, const float* te, const float* ps, const float* ts, long long cells, long long layers,
           int sp, int st, int dim, float* precision, float* recall, float* f1, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * (Tile<TM>::kFixed + sp + st);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(bert_greedy_match_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const bool vec = dim % 4 == 0 && ((reinterpret_cast<unsigned long long>(pe) | reinterpret_cast<unsigned long long>(te)) & 15) == 0;
  bert_greedy_match_kernel<TM><<<(unsigned)cells, kThreads, smem, stream>>>(
      pe, te, ps, ts, sp, st, dim, layers, vec, precision, recall, f1);
  return (int)cudaGetLastError();
}

}  // namespace

// The tile's rows a side for cells of sp x st tokens: of 64, 96 and 128, the
// one with the least padded work, weighted by what each spends a product on
// (a 64 tile reads one operand for 2 FMAs, a 96 tile one for 3, a 128 tile one
// for 4). The weights are estimates: the 96 tile is timed at the MT call and
// the 128 tile at all_layers, the 64 tile at no stream's shape.
extern "C" int bert_greedy_match_tile(int sp, int st) {
  const int tiles[3] = {64, 96, 128};
  const double weight[3] = {1.3, 1.1, 1.0};
  int best = 128;
  double best_cost = 0.0;
  for (int i = 0; i < 3; ++i) {
    const long long t = tiles[i];
    const double cost = weight[i] * (double)((sp + t - 1) / t * t) * (double)((st + t - 1) / t * t);
    if (i == 0 || cost < best_cost) best = tiles[i], best_cost = cost;
  }
  return best;
}

// pe (n, layers, sp, dim), te (n, layers, st, dim), ps (n, sp), ts (n, st): contiguous float32.
// precision, recall, f1: (n, layers) float32. Returns the CUDA error of the launch (0 on success).
extern "C" int bert_greedy_match(const float* pe, const float* te, const float* ps, const float* ts, long long n,
                                 long long layers, int sp, int st, int dim, float* precision, float* recall,
                                 float* f1, void* stream) {
  const long long cells = n * layers;
  if (cells <= 0 || sp <= 0 || st <= 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  if (cells > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (bert_greedy_match_tile(sp, st)) {
    case 64: return launch<4>(pe, te, ps, ts, cells, layers, sp, st, dim, precision, recall, f1, s);
    case 96: return launch<6>(pe, te, ps, ts, cells, layers, sp, st, dim, precision, recall, f1, s);
    default: return launch<8>(pe, te, ps, ts, cells, layers, sp, st, dim, precision, recall, f1, s);
  }
}
