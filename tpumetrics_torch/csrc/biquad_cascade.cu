// Cascaded IIR biquads over time for Hopper (sm_90a): a chunked, chained
// linear-recurrence scan over T.
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
// the output) is clipped, as in the JAX function.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32): the bytes, one
// read of x and one write of out, 8*L*T bytes, at SRMR's shapes (184 lanes x
// 128,000 x 4 stages; 1,472 x 128,000 x 1).  A stage is linear in its state:
// over K samples the state goes s -> M s + e, with M = A^K the homogeneous
// transition (A = [[-a1, 1], [-a2, 0]]) and e the state reached from zero.
// So T splits into chunks that run in parallel, and only the 2-float state
// has to travel along T.  The design:
//
//  - A block of 256 threads owns one lane and a tile of 256 x K = 4,096
//    consecutive samples (K = 16 a thread).  It loads the tile with
//    coalesced 16-byte loads (4-byte ones where T % 4 != 0) into shared
//    memory, rows padded to K + 1 floats so that each thread then reads its
//    own K samples without bank conflicts, and writes the output back the
//    same way: x is read once and out written once.
//  - Per stage, each thread runs its K samples from state zero (its e, in
//    FMAs), the block scans the threads' maps in float64 (warp shuffles,
//    then across the 8 warps) with M's powers M^(2^p), formed in float64 in
//    the prologue, and each thread then runs its K samples again from its
//    true start state, cast to float32.  Its y (clipped with clamp) stays in
//    registers as the next stage's input, so all S stages run in one launch.
//  - Between the tiles of a lane, the state is carried in float64, in one
//    fixed order: tile j waits for tile j-1's inclusive state of the stage
//    (an acquire load of a flag), publishes its own (M^256 c + the tile's
//    aggregate, then a release store of the flag) and only then runs its
//    samples.  Blocks take their (tile, lane) from an atomic ticket in
//    launch order, tile-major, so a block only waits on one that is already
//    running or done.  The wrapper zeroes the ticket and the flags on the
//    stream for every call.
//
// Why float64 carries: the modulation bank's 4 Hz band has poles at radius
// about 0.9996, a near-double root at 1.  Rounding M^K and the carries to
// float32 moves those poles.  Emulated on a CPU at 16 kHz over 128,000
// samples (scripts/emulate_biquad_scan.py), float32 carries come to 1.1e-1
// of the lane's peak against a float64 reference, the plain float32 loop
// to 1.6e-3, and float64 carries with float32 inside each chunk to 6.1e-5
// at K = 16 (4.9e-4 at K = 128).  Why a fixed order: a decoupled look-back
// composes predecessors in an order set by timing and would change the bits
// from run to run; here every call gives the same bits, and a graph replay
// the eager call's.  A scan reassociates the recurrence, so the kernel is not bit for
// bit the plain loop: it is held to a float64 reference within a stated
// tolerance (ops/biquad.py).  The pass that writes the output rounds every
// product, sum and difference on its own (__fmul_rn, __fadd_rn, __fsub_rn)
// in the plain loop's order, so a lane of at most K samples equals the plain
// loop bit for bit; the clip is two comparisons, so NaN passes it.  A
// non-finite input makes its chunk's e non-finite, and the scan carries that
// to every later chunk, as the plain loop's state carries it.
//
// What bounds this design (PERF.md §6 has the times): the modulation call
// (1 stage on 1,472 lanes) runs near its bytes bound; the gammatone call
// (4 stages on 184 lanes, an eighth of the bytes) is set by the
// instructions, two passes over the samples a stage and the float64 scan,
// and by the carry chain along a lane, 32 tiles x 4 stages, whose latency
// a one-lane call shows.
// Registers: 64 a thread (__launch_bounds__(256, 4): 4 blocks, 32 warps an
// SM), with a few spills; 17.8-18.7 KB of shared memory a block.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;                 // K: samples a thread runs
constexpr int kTile = kThreads * kChunk;   // samples a block owns
constexpr int kStride = kChunk + 1;        // a thread's padded row in shared memory
constexpr int kPowers = 9;                 // P[p] = M^(2^p) = A^(K 2^p), p = 0..8; P[8] spans the tile
constexpr int kWarpPower = 5;              // P[5] = M^32 spans a warp
constexpr int kTilePower = 8;
static_assert(kThreads == 1 << kTilePower && kWarps == 1 << (kTilePower - kWarpPower), "the powers index the scan");
static_assert((kChunk & (kChunk - 1)) == 0 && kChunk % 4 == 0, "K is a power of two and a whole number of float4s");

struct Vec2 {
    double x, y;
};
struct Mat2 {
    double a, b, c, d;  // [[a, b], [c, d]]
};

__device__ __forceinline__ Vec2 operator+(Vec2 u, Vec2 v) { return {u.x + v.x, u.y + v.y}; }
__device__ __forceinline__ Vec2 apply(const Mat2& m, Vec2 v) { return {m.a * v.x + m.b * v.y, m.c * v.x + m.d * v.y}; }
__device__ __forceinline__ Mat2 compose(const Mat2& m, const Mat2& n) {
    return {m.a * n.a + m.b * n.c, m.a * n.b + m.b * n.d, m.c * n.a + m.d * n.c, m.c * n.b + m.d * n.d};
}
__device__ __forceinline__ Vec2 shfl_up(Vec2 v, int d) {
    return {__shfl_up_sync(0xffffffffu, v.x, d), __shfl_up_sync(0xffffffffu, v.y, d)};
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}
__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
    asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned long long global_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}
// A predecessor is running or done when a block waits on it, so a wait of seconds means a broken protocol: the
// kernel traps (the call then fails with a launch error) rather than hold the card.
constexpr unsigned long long kWaitLimitNs = 10'000'000'000ULL;

__device__ __forceinline__ float clip_keep_nan(float y) {
    // fminf/fmaxf would return the non-NaN operand; comparisons with NaN are false
    return y > 1.0f ? 1.0f : (y < -1.0f ? -1.0f : y);
}

struct Coef {
    float b0, b1, b2, a1, a2;
};

// One step of the zero-state pass, in FMAs: its end state only feeds the float64 scan, and three FMAs a step take
// fewer instructions than the plain order and round less.
__device__ __forceinline__ void zero_state_step(const Coef& c, float h, float& s0, float& s1) {
    const float y = fmaf(c.b0, h, s0);
    const float n0 = fmaf(-c.a1, y, fmaf(c.b1, h, s1));
    s1 = fmaf(-c.a2, y, __fmul_rn(c.b2, h));
    s0 = n0;
}

// One step of a stage, in the plain version's order of operations, each rounded on its own.
__device__ __forceinline__ float step(const Coef& c, float h, float& s0, float& s1) {
    const float y = __fadd_rn(__fmul_rn(c.b0, h), s0);
    const float n0 = __fadd_rn(__fsub_rn(__fmul_rn(c.b1, h), __fmul_rn(c.a1, y)), s1);
    const float n1 = __fsub_rn(__fmul_rn(c.b2, h), __fmul_rn(c.a2, y));
    s0 = n0;
    s1 = n1;
    return y;
}

// sync[0] is the ticket; sync[1 + tile * lanes + lane] counts the stages whose inclusive state that tile has
// published in carry[(tile * lanes + lane) * S + stage].  Both are zero at launch.
template <int S, bool CLAMP, bool VEC>
__global__ void __launch_bounds__(kThreads, 4) biquad_cascade_kernel(
    const float* __restrict__ x, const float* __restrict__ b, const float* __restrict__ a, float* __restrict__ out,
    double2* __restrict__ carry, unsigned* __restrict__ sync, int lanes, long long t_len, int tiles) {
    __shared__ float buf[kThreads * kStride];
    __shared__ Mat2 powers[S][kPowers];
    __shared__ Vec2 warp_start[kWarps];  // a warp's inclusive sum, then its start relative to the tile's
    __shared__ Vec2 carry_in;
    __shared__ int ticket;

    const int tid = threadIdx.x, wl = tid & 31, warp = tid >> 5;
    if (tid == 0) ticket = static_cast<int>(atomicAdd(sync, 1u));
    __syncthreads();
    const int tile = ticket / lanes, lane = ticket - (ticket / lanes) * lanes;
    const long long t0 = static_cast<long long>(tile) * kTile;
    const size_t row = static_cast<size_t>(lane) * t_len + t0;
    const long long left = t_len - t0;  // samples of this tile inside the lane

    // the tile, coalesced, into the padded rows (zeros past the lane's end: no output reads them)
    if (VEC) {
        const float4* src = reinterpret_cast<const float4*>(x + row);
        float4 v[kTile / 4 / kThreads];
#pragma unroll
        for (int r = 0; r < kTile / 4 / kThreads; ++r) {
            const int q = r * kThreads + tid;
            v[r] = 4LL * q < left ? src[q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
#pragma unroll
        for (int r = 0; r < kTile / 4 / kThreads; ++r) {
            const int n = 4 * (r * kThreads + tid);
            float* dst = buf + (n / kChunk) * kStride + n % kChunk;
            dst[0] = v[r].x;
            dst[1] = v[r].y;
            dst[2] = v[r].z;
            dst[3] = v[r].w;
        }
    } else {
#pragma unroll
        for (int r = 0; r < kChunk; ++r) {
            const int n = r * kThreads + tid;
            buf[(n / kChunk) * kStride + n % kChunk] = n < left ? x[row + n] : 0.0f;
        }
    }
    // prologue: M = A^K and its powers, in float64, one thread a stage
    if (tid < S) {
        const size_t k = (static_cast<size_t>(tid) * lanes + lane) * 3;
        Mat2 m = {-static_cast<double>(a[k + 1]), 1.0, -static_cast<double>(a[k + 2]), 0.0};
        for (int n = 1; n < kChunk; n <<= 1) m = compose(m, m);
        for (int p = 0; p < kPowers; ++p) {
            powers[tid][p] = m;
            m = compose(m, m);
        }
    }
    __syncthreads();
    float h[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) h[k] = buf[tid * kStride + k];

#pragma unroll
    for (int i = 0; i < S; ++i) {
        const size_t k = (static_cast<size_t>(i) * lanes + lane) * 3;
        const Coef c = {b[k], b[k + 1], b[k + 2], a[k + 1], a[k + 2]};
        const Mat2* pw = powers[i];
        // 1. the chunk from state zero: its e
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int n = 0; n < kChunk; ++n) zero_state_step(c, h[n], s0, s1);
        // 2. inclusive scan of the chunks' maps within the warp: v = sum over l' <= l of M^(l - l') e_l'
        Vec2 v = {static_cast<double>(s0), static_cast<double>(s1)};
#pragma unroll
        for (int p = 0; p < kWarpPower; ++p) {
            const Vec2 o = shfl_up(v, 1 << p);
            if (wl >= (1 << p)) v = v + apply(pw[p], o);
        }
        Vec2 before = shfl_up(v, 1);  // the state at this chunk's start, from zero at the warp's start
        if (wl == 0) before = {0.0, 0.0};
        if (wl == 31) warp_start[warp] = v;
        __syncthreads();
        // 3. across the warps, then the carry from the tile before, in warp 0
        if (warp == 0) {
            Vec2 g = wl < kWarps ? warp_start[wl] : Vec2{0.0, 0.0};
#pragma unroll
            for (int p = 0; p < kTilePower - kWarpPower; ++p) {
                const Vec2 o = shfl_up(g, 1 << p);
                if (wl >= (1 << p)) g = g + apply(pw[kWarpPower + p], o);
            }
            Vec2 g_before = shfl_up(g, 1);
            const Vec2 aggregate = {__shfl_sync(0xffffffffu, g.x, kWarps - 1), __shfl_sync(0xffffffffu, g.y, kWarps - 1)};
            if (wl == 0) g_before = {0.0, 0.0};
            if (wl < kWarps) warp_start[wl] = g_before;
            if (wl == 0) {
                Vec2 cin = {0.0, 0.0};
                if (tile > 0) {
                    const size_t prev = static_cast<size_t>(tile - 1) * lanes + lane;
                    const unsigned long long since = global_ns();
                    while (load_acquire(sync + 1 + prev) <= static_cast<unsigned>(i)) {
                        if (global_ns() - since > kWaitLimitNs) __trap();
                    }
                    const double2 got = __ldcg(carry + prev * S + i);
                    cin = {got.x, got.y};
                }
                if (tile + 1 < tiles) {
                    const size_t self = static_cast<size_t>(tile) * lanes + lane;
                    const Vec2 end = apply(pw[kTilePower], cin) + aggregate;
                    __stcg(carry + self * S + i, make_double2(end.x, end.y));
                    store_release(sync + 1 + self, static_cast<unsigned>(i + 1));
                }
                carry_in = cin;
            }
        }
        __syncthreads();
        // 4. this chunk's true start: M^l (M^(32 w) c + the warp's start) + the chunk's start in the warp
        Vec2 start = carry_in;
#pragma unroll
        for (int p = 0; p < kTilePower - kWarpPower; ++p) {
            if ((warp >> p) & 1) start = apply(pw[kWarpPower + p], start);
        }
        start = start + warp_start[warp];
#pragma unroll
        for (int p = 0; p < kWarpPower; ++p) {
            if ((wl >> p) & 1) start = apply(pw[p], start);
        }
        start = start + before;
        // 5. the chunk again from there: the stage's output, the next stage's input
        s0 = static_cast<float>(start.x);
        s1 = static_cast<float>(start.y);
#pragma unroll
        for (int n = 0; n < kChunk; ++n) {
            const float y = step(c, h[n], s0, s1);
            h[n] = CLAMP ? clip_keep_nan(y) : y;
        }
    }

#pragma unroll
    for (int k = 0; k < kChunk; ++k) buf[tid * kStride + k] = h[k];
    __syncthreads();
    if (VEC) {
        float4* dst = reinterpret_cast<float4*>(out + row);
#pragma unroll
        for (int r = 0; r < kTile / 4 / kThreads; ++r) {
            const int q = r * kThreads + tid;
            const int n = 4 * q;
            if (n < left) {
                const float* s = buf + (n / kChunk) * kStride + n % kChunk;
                dst[q] = make_float4(s[0], s[1], s[2], s[3]);
            }
        }
    } else {
#pragma unroll
        for (int r = 0; r < kChunk; ++r) {
            const int n = r * kThreads + tid;
            if (n < left) out[row + n] = buf[(n / kChunk) * kStride + n % kChunk];
        }
    }
}

template <int S, bool CLAMP>
cudaError_t launch(const float* x, const float* b, const float* a, float* out, double2* carry, unsigned* sync,
                   int lanes, long long t_len, int tiles, cudaStream_t stream) {
    const unsigned blocks = static_cast<unsigned>(lanes) * static_cast<unsigned>(tiles);
    const bool vec = t_len % 4 == 0 && reinterpret_cast<size_t>(x) % 16 == 0 && reinterpret_cast<size_t>(out) % 16 == 0;
    if (vec) {
        biquad_cascade_kernel<S, CLAMP, true><<<blocks, kThreads, 0, stream>>>(x, b, a, out, carry, sync, lanes, t_len, tiles);
    } else {
        biquad_cascade_kernel<S, CLAMP, false><<<blocks, kThreads, 0, stream>>>(x, b, a, out, carry, sync, lanes, t_len, tiles);
    }
    return cudaGetLastError();
}

}  // namespace

// Samples a block owns: the wrapper sizes its scratch with it.
extern "C" int biquad_cascade_tile() { return kTile; }

// x (lanes, t_len), b and a (stages, lanes, 3) with a[..., 0] == 1, out (lanes, t_len): float32, contiguous, on the
// current device.  tiles = ceil(t_len / biquad_cascade_tile()); carry: tiles * lanes * stages float64 pairs (16-byte
// aligned); sync: 1 + tiles * lanes uint32, all zero.  Built for SRMR's two filterbanks only (ops/biquad.py
// _KERNEL_CASES): 4 stages with clamp (gammatone) and 1 stage without (modulation); any other pair, or a tile count
// that does not match t_len or does not fit the grid, returns cudaErrorInvalidValue.  Launches on `stream` and returns
// the launch's CUDA error (0 when it was queued).
extern "C" int biquad_cascade(const float* x, const float* b, const float* a, float* out, void* carry, void* sync,
                              int lanes, long long t_len, int tiles, int stages, int clamp, void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (lanes < 1 || t_len < 1 || tiles != (t_len + kTile - 1) / kTile ||
        static_cast<long long>(lanes) * tiles > 0x7fffffffLL) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    double2* c = static_cast<double2*>(carry);
    unsigned* s = static_cast<unsigned*>(sync);
    if (stages == 4 && clamp) return launch<4, true>(x, b, a, out, c, s, lanes, t_len, tiles, stream);
    if (stages == 1 && !clamp) return launch<1, false>(x, b, a, out, c, s, lanes, t_len, tiles, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}
