// Cascaded IIR biquads over time for Hopper (sm_90a).
//
// Replaces tpumetrics/functional/audio/srmr.py, function _biquad_cascade: a
// lax.scan over time, not a Pallas kernel (XLA compiles the scan into a
// device loop; PyTorch has no op for an IIR recurrence, so without this
// kernel each time step of each stage would be a handful of launches).
//
// For x of shape (L, T) and normalised coefficients b, a of shape (S, L, 3)
// (a[..., 0] == 1; the wrapper divides by it), every lane l runs S
// direct-form-II-transposed biquads in cascade, state starting at zero:
//
//     y      = b0 * h + s0
//     s0'    = (b1 * h - a1 * y) + s1
//     s1'    = b2 * h - a2 * y
//     h_next = clamp ? clip(y, -1, 1) : y       (NaN stays NaN)
//
// and writes the last stage's output to out (L, T).  With clamp, a stage's
// own recursion keeps the unclipped y; only what feeds the next stage (and
// the output) is clipped, as in the JAX function.  Every product, sum and
// difference is rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn, in the
// plain version's order), so nvcc cannot contract them into FMAs and the
// kernel equals the plain torch version bit for bit.
//
// What bounds it on an H100 SXM (3.35 TB/s): the bytes, one read of x and
// one write of out, 8*L*T bytes (a parallel scan over T would need no
// sequential chain).  What bounds this design is the chain: one thread per
// lane walks T in order, so a launch takes T steps of the recurrence's
// latency (about 16 cycles for the y -> s0' -> y loop of a stage, more for
// four stages in cascade) whatever L is, and at the SRMR shapes
// (L = 184 and 1,472) only a few dozen warps exist.  The design does what
// is cheap about that: blocks of one warp, so the warps spread over the
// SMs and none shares an issue slot; the coefficients and the state live
// in registers; a thread loads a chunk of its lane ahead of the recurrence
// (independent loads in flight) and stores the chunk after it.  A chunked
// linear-recurrence scan across T, or a (T, L) layout for coalesced loads,
// is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;

__device__ __forceinline__ float clip_keep_nan(float y) {
    // fminf/fmaxf would return the non-NaN operand; comparisons with NaN are false
    return y > 1.0f ? 1.0f : (y < -1.0f ? -1.0f : y);
}

template <int S, bool CLAMP>
__global__ void __launch_bounds__(32) biquad_cascade_kernel(
    const float* __restrict__ x, const float* __restrict__ b, const float* __restrict__ a,
    float* __restrict__ out, int lanes, long long t_len) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
    float b0[S], b1[S], b2[S], a1[S], a2[S], s0[S], s1[S];
#pragma unroll
    for (int i = 0; i < S; ++i) {
        const size_t k = (static_cast<size_t>(i) * lanes + lane) * 3;
        b0[i] = b[k];
        b1[i] = b[k + 1];
        b2[i] = b[k + 2];
        a1[i] = a[k + 1];
        a2[i] = a[k + 2];
        s0[i] = 0.0f;
        s1[i] = 0.0f;
    }
    const float* xl = x + static_cast<size_t>(lane) * t_len;
    float* ol = out + static_cast<size_t>(lane) * t_len;
    for (long long t0 = 0; t0 < t_len; t0 += kChunk) {
        const int n = t_len - t0 < kChunk ? static_cast<int>(t_len - t0) : kChunk;
        float buf[kChunk];
#pragma unroll
        for (int k = 0; k < kChunk; ++k) buf[k] = k < n ? xl[t0 + k] : 0.0f;
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
            float h = buf[k];
#pragma unroll
            for (int i = 0; i < S; ++i) {
                const float y = __fadd_rn(__fmul_rn(b0[i], h), s0[i]);
                const float n0 = __fadd_rn(__fsub_rn(__fmul_rn(b1[i], h), __fmul_rn(a1[i], y)), s1[i]);
                const float n1 = __fsub_rn(__fmul_rn(b2[i], h), __fmul_rn(a2[i], y));
                s0[i] = n0;
                s1[i] = n1;
                h = CLAMP ? clip_keep_nan(y) : y;
            }
            buf[k] = h;
        }
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
            if (k < n) ol[t0 + k] = buf[k];
        }
    }
}

template <int S, bool CLAMP>
cudaError_t launch(const float* x, const float* b, const float* a, float* out, int lanes, long long t_len,
                   cudaStream_t stream) {
    biquad_cascade_kernel<S, CLAMP><<<(lanes + 31) / 32, 32, 0, stream>>>(x, b, a, out, lanes, t_len);
    return cudaGetLastError();
}

}  // namespace

// x (lanes, t_len), b and a (stages, lanes, 3) with a[..., 0] == 1, out (lanes, t_len): float32, contiguous,
// on the current device.  Built for SRMR's two filterbanks only (ops/biquad.py _KERNEL_CASES): 4 stages with
// clamp (gammatone) and 1 stage without (modulation); any other pair returns cudaErrorInvalidValue.
// Launches on `stream` and returns the launch's CUDA error (0 when it was queued).
extern "C" int biquad_cascade(const float* x, const float* b, const float* a, float* out, int lanes,
                              long long t_len, int stages, int clamp, void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (stages == 4 && clamp) return launch<4, true>(x, b, a, out, lanes, t_len, stream);
    if (stages == 1 && !clamp) return launch<1, false>(x, b, a, out, lanes, t_len, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}
