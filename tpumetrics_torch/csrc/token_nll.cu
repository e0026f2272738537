// Per-token negative log-likelihood of a language model's logits, for Hopper
// (sm_90a): one read of the logits, one float32 NLL a row.
//
// Replaces no Pallas kernel: it replaces XLA's fusion of
// tpumetrics/functional/text/perplexity.py, function _perplexity_update
// (:40-57): a cast of the (B, S, V) logits to float32, a full log_softmax, a
// gather of one entry a row and a masked sum. Done as torch ops on the card,
// those lines write a float32 copy of the logits and float32 log-probabilities
// (at Llama 3's V = 128,256 and 8 x 2,048 tokens, 8.4 GB each beside 4.2 GB of
// bf16 logits) and move some 30 GB.
//
// For logits (B, S, V) in float32, bfloat16 or float16, with any strides on B
// and S and the V axis contiguous, and int64 targets (B, S), each row writes
//
//     lse[r] = M + log(sum_j exp(x_j - M)),    M the row's max
//     nll[r] = log(sum_j exp(x_j - M)) - (x_t - M)
//
// in float32 (the second is -log_softmax(x)[t], in the order JAX's
// log_softmax takes it). A target equal to ignore_index (when has_ignore)
// writes nll 0. A target in [-V, -1] wraps to t + V; one outside [-V, V)
// writes NaN, as JAX's take_along_axis gives there. The wrapper sums the rows
// and counts the targets (tpumetrics_torch/ops/token_nll.py).
//
// What bounds it on an H100 SXM: the bytes. At 8 x 2,048 x 128,256 the bf16
// logits are 4.20 GB, 1.254 ms at 3.35 TB/s (2.509 ms for float32); the
// outputs are 131 KB. The 2.10e9 exponentials need about 0.50 ms of the
// special-function units (132 SMs x 16 a clock at 1.98 GHz), 40 % of the bytes
// time, so the kernel spends one exponential an element: each thread keeps an
// online max and sum, and rescales its sum only when a 16-byte vector raises
// its max (rarely, after the first vectors of a row).
//
// The design: a block of 512 threads a row (16,384 blocks at the main shape,
// two resident an SM). A row need not start on 16 bytes (GPT-2's V = 50,257
// makes a bf16 row 100,514 bytes long), so the block reads a scalar head up to
// the first 16-byte boundary, a body of 16-byte vectors (kUnroll loads in
// flight a thread before any arithmetic) and a scalar tail. Within a thread
// the vectors' partial sums are added with Kahan's compensation (the row's
// sum runs over some 30 vectors a thread); the threads' (max, sum) pairs then
// meet in a tree of warp shuffles and one across the warps. One thread reads
// the target's logit. The kernel launches on the caller's stream and reads
// nothing back, so a CUDA graph can capture it; every call gives the same bits.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // 16-byte loads in flight a thread

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// A thread's running (max, sum of exp(x - max)) with Kahan's compensation c
// (the sum is s - c). The max starts at -FLT_MAX, not -inf, so that x - m is
// never -inf - (-inf): a row of -inf keeps the sum at 0 and writes NaN through
// log(0) - (-inf), and NaN inputs reach the sum through exp(NaN).
struct Online {
  float m = -FLT_MAX;
  float s = 0.f;
  float c = 0.f;

  __device__ __forceinline__ void raise_to(float vmax) {
    if (vmax > m) {
      const float r = __expf(m - vmax);
      s *= r;
      c *= r;
      m = vmax;
    }
  }

  __device__ __forceinline__ void add(float partial) {
    const float y = partial - c;
    const float t = s + y;
    c = (t - s) - y;
    s = t;
  }
};

template <typename T>
__device__ __forceinline__ void add_vector(Online& st, const uint4& raw) {
  constexpr int kE = 16 / sizeof(T);
  T v[kE];
  *reinterpret_cast<uint4*>(v) = raw;
  float x[kE];
#pragma unroll
  for (int i = 0; i < kE; ++i) x[i] = to_float(v[i]);
  float vmax = x[0];
#pragma unroll
  for (int i = 1; i < kE; ++i) vmax = fmaxf(vmax, x[i]);
  st.raise_to(vmax);
  float e[kE];
#pragma unroll
  for (int i = 0; i < kE; ++i) e[i] = __expf(x[i] - st.m);
  // a pairwise partial of the vector, then one compensated add
#pragma unroll
  for (int w = 1; w < kE; w *= 2) {
#pragma unroll
    for (int i = 0; i + w < kE; i += 2 * w) e[i] += e[i + w];
  }
  st.add(e[0]);
}

__device__ __forceinline__ void add_scalar(Online& st, float x) {
  st.raise_to(x);
  st.add(__expf(x - st.m));
}

// (m1, s1) and (m2, s2) into one pair; exact exponentials here (a few a thread)
__device__ __forceinline__ void combine(float& m, float& s, float m2, float s2) {
  const float mm = fmaxf(m, m2);
  s = s * expf(m - mm) + s2 * expf(m2 - mm);
  m = mm;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    token_nll_kernel(const T* __restrict__ logits, long long seq, long long stride_b, long long stride_s,
                     long long vocab, const long long* __restrict__ target, long long ignore_index, int has_ignore,
                     float* __restrict__ nll, float* __restrict__ lse) {
  __shared__ float warp_m[kWarps];
  __shared__ float warp_s[kWarps];

  const long long r = blockIdx.x;
  const long long b = r / seq;
  const long long pos = r - b * seq;
  const T* row = logits + b * stride_b + pos * stride_s;
  const int tid = threadIdx.x;

  long long t = target[r];
  const bool ignored = has_ignore && t == ignore_index;
  const bool in_range = t >= -vocab && t < vocab;
  if (t < 0) t += vocab;
  float x_target = 0.f;  // read by thread 0, which also writes the row's outputs
  if (tid == 0 && !ignored && in_range) x_target = to_float(row[t]);

  constexpr int kE = 16 / sizeof(T);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(row);
  long long head = (long long)((16 - (addr & 15)) & 15) / (long long)sizeof(T);
  if (head > vocab) head = vocab;
  const long long nvec = (vocab - head) / kE;
  const long long tail0 = head + nvec * kE;

  Online st;
  if (tid < head) add_scalar(st, to_float(row[tid]));
  const uint4* body = reinterpret_cast<const uint4*>(row + head);
  for (long long v0 = tid; v0 < nvec; v0 += (long long)kThreads * kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long v = v0 + (long long)k * kThreads;
      if (v < nvec) raw[k] = __ldg(body + v);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (v0 + (long long)k * kThreads < nvec) add_vector<T>(st, raw[k]);
    }
  }
  if (tail0 + tid < vocab) add_scalar(st, to_float(row[tail0 + tid]));

  float m = st.m;
  float s = st.s - st.c;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    combine(m, s, m2, s2);
  }
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (lane == 0) {
    warp_m[warp] = m;
    warp_s[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? warp_m[lane] : -FLT_MAX;
    s = lane < kWarps ? warp_s[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
      combine(m, s, m2, s2);
    }
    if (lane == 0) {
      const float log_s = logf(s);
      lse[r] = m + log_s;
      float out;
      if (ignored) {
        out = 0.f;
      } else if (!in_range) {
        out = __int_as_float(0x7fc00000);  // NaN
      } else {
        out = log_s - (x_target - m);
      }
      nll[r] = out;
    }
  }
}

template <typename T>
cudaError_t launch(const void* logits, long long batch, long long seq, long long stride_b, long long stride_s,
                   long long vocab, const long long* target, long long ignore_index, int has_ignore, float* nll,
                   float* lse, cudaStream_t stream) {
  token_nll_kernel<T><<<(unsigned)(batch * seq), kThreads, 0, stream>>>(
      static_cast<const T*>(logits), seq, stride_b, stride_s, vocab, target, ignore_index, has_ignore, nll, lse);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. Strides in elements; the V axis
// contiguous. The wrapper checks shapes and keeps batch * seq below 2^31.
// Returns the launch's CUDA error (0 when it was queued).
extern "C" int token_nll(const void* logits, int dtype, long long batch, long long seq, long long stride_b,
                         long long stride_s, long long vocab, const long long* target, long long ignore_index,
                         int has_ignore, float* nll, float* lse, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch<float>(logits, batch, seq, stride_b, stride_s, vocab, target, ignore_index, has_ignore, nll, lse, s);
      break;
    case 1:
      err = launch<__nv_bfloat16>(logits, batch, seq, stride_b, stride_s, vocab, target, ignore_index, has_ignore,
                                  nll, lse, s);
      break;
    case 2:
      err = launch<__half>(logits, batch, seq, stride_b, stride_s, vocab, target, ignore_index, has_ignore, nll, lse,
                           s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
