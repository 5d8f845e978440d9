// Backward of the inter-chunk recurrence of the chunked SSD scan
// (csrc/ssd_state.cu), for sm_90a.
//
// Replaces no TPU kernel: the JAX package differentiates the plain
// chunked scan (src/repro/models/ssm.py::ssd_chunked, whose recurrence is
// a Python loop over chunks), and the Pallas SSD kernel has no VJP.  The
// port's training runs the forward through csrc/ssd_state.cu, so its
// backward is a kernel too.  With the forward
//     prev[c] = carry_c;  carry_{c+1} = states[c] + decay[c] carry_c;
//     final = carry_nc
// and the gradients dprev (B, nc, H, P, N) and dfinal (B, H, P, N), the
// backward is a reverse scan:
//     G = dfinal
//     for c = nc - 1 .. 0:
//         dstates[c]      = G
//         ddecay[b, c, h] = sum_{p, n} G * prev[c]
//         G               = decay[c] G + dprev[c]
//     dinit = G
// (its plain version is autograd of kernels/ssd/ref.py::
// chunk_recurrence_ref).
//
// Bound on the H100: bytes.  dprev and prev are read once and dstates
// written once: at the mamba2-130m prefill (B = 2, nc = 256, H = 24, P =
// 64, N = 128) 403 MB each, 1.21 GB in all, 0.36 ms at 3.35 TB/s; four
// FLOPs an element.
//
// Design: one warp owns 32 x W contiguous (p, n) elements of one (b, h)
// slice (W = 4: one float4 a lane; W = 1 when P * N is not a multiple of
// 4 or a pointer is not 16-byte aligned) and walks the chunks backwards,
// carrying G in registers, with the loads of the next DEPTH chunks in
// flight as in the forward.  The sum for ddecay over the P x N elements
// is the part the forward has not: each warp sums its own elements with
// shuffles in a fixed butterfly and writes one partial a chunk
// (part[b, c, h, warp of the slice]); a second kernel adds the partials
// of each (b, c, h) in order.  No atomics: the gradients are the same
// from run to run.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int DEPTH = 4;      // chunks loaded ahead

__device__ __forceinline__ float fma_step(float d, float g, float dp) {
    return fmaf(d, g, dp);
}
__device__ __forceinline__ float4 fma_step(float d, float4 g, float4 dp) {
    return make_float4(fmaf(d, g.x, dp.x), fmaf(d, g.y, dp.y),
                       fmaf(d, g.z, dp.z), fmaf(d, g.w, dp.w));
}
__device__ __forceinline__ float dot(float a, float b) { return a * b; }
__device__ __forceinline__ float dot(float4 a, float4 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ float4 zero<float4>() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
}

// T = float4 (W = 4 elements a lane) or float (W = 1).  per_h = P * N /
// W items of one (b, h) slice, wph = ceil(per_h / 32) warps a slice.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_state_bwd_kernel(const T* __restrict__ dprev, const T* __restrict__ dfin,
                     const T* __restrict__ prev,
                     const float* __restrict__ decay, T* __restrict__ dstates,
                     T* __restrict__ dinit, float* __restrict__ part,
                     long long n_rows, int nc, int H, int per_h, int wph) {
    const long long gw = ((long long)blockIdx.x * THREADS + threadIdx.x) / 32;
    const int lane = threadIdx.x & 31;
    if (gw >= n_rows * H * wph) return;          // whole warps only
    const long long bh = gw / wph;
    const int wi = (int)(gw % wph);
    const long long b = bh / H;
    const int h = (int)(bh % H);
    const int item = wi * 32 + lane;
    const bool ok = item < per_h;
    const long long row_items = (long long)H * per_h;
    const long long e = (long long)h * per_h + (ok ? item : 0);
    const T* gp = dprev + b * nc * row_items + e;  // chunk c: + c * row_items
    const T* pp = prev + b * nc * row_items + e;
    T* sp = dstates + b * nc * row_items + e;
    const float* dp = decay + b * nc * H + h;      // chunk c: + c * H
    float* outp = part + (b * nc * H + h) * (long long)wph + wi;

    T g[DEPTH], pv[DEPTH];
    float d[DEPTH];
#pragma unroll
    for (int k = 0; k < DEPTH; ++k) {
        const int c = nc - 1 - k;
        g[k] = zero<T>();
        pv[k] = zero<T>();
        d[k] = 0.f;
        if (c >= 0) {
            if (ok) {
                g[k] = __ldg(gp + c * row_items);
                pv[k] = __ldg(pp + c * row_items);
            }
            d[k] = __ldg(dp + c * H);
        }
    }
    T G = ok ? dfin[b * row_items + e] : zero<T>();
    for (int c0 = nc - 1; c0 >= 0; c0 -= DEPTH) {
#pragma unroll
        for (int k = 0; k < DEPTH; ++k) {
            const int c = c0 - k;
            if (c < 0) break;                     // the same c in every lane
            if (ok) sp[c * row_items] = G;
            float s = dot(G, pv[k]);
            const T gc = g[k];
            const float dc = d[k];
            if (c - DEPTH >= 0) {   // the load DEPTH chunks ahead
                if (ok) {
                    g[k] = __ldg(gp + (c - DEPTH) * row_items);
                    pv[k] = __ldg(pp + (c - DEPTH) * row_items);
                }
                d[k] = __ldg(dp + (c - DEPTH) * H);
            }
            G = fma_step(dc, G, gc);
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                s += __shfl_xor_sync(0xffffffffu, s, off);
            if (lane == 0) outp[(long long)c * H * wph] = s;
        }
    }
    if (ok) dinit[b * row_items + e] = G;
}

// ddecay[i] = sum of part[i, 0 .. wph - 1], in order.
__global__ void __launch_bounds__(THREADS)
ssd_state_bwd_sum(const float* __restrict__ part, float* __restrict__ ddecay,
                  long long n, int wph) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    const float* p = part + i * wph;
    float s = 0.f;
    for (int j = 0; j < wph; ++j) s += p[j];
    ddecay[i] = s;
}

}  // namespace

// The partials a (b, c, h) needs at most, whatever the path: one a warp
// of 32 elements (the wrapper sizes part as B * nc * H times this).
extern "C" int ssd_state_bwd_parts(int P, int N) {
    return (P * N + 31) / 32;
}

// dprev (B, nc, H, P, N), dfin (B, H, P, N), prev (B, nc, H, P, N) and
// decay (B, nc, H) -> dstates (B, nc, H, P, N), dinit (B, H, P, N) and
// ddecay (B, nc, H); part: scratch of B * nc * H * ssd_state_bwd_parts(P,
// N) floats.  All contiguous fp32, nc >= 1.  Returns cudaGetLastError()
// after the launches.
extern "C" int ssd_state_bwd_launch(const float* dprev, const float* dfin,
                                    const float* prev, const float* decay,
                                    float* dstates, float* dinit,
                                    float* ddecay, float* part, long long B,
                                    int nc, int H, int P, int N,
                                    void* stream) {
    if (B < 1 || nc < 1 || H < 1 || P < 1 || N < 1)
        return (int)cudaErrorInvalidValue;
    const int pn = P * N;
    const bool vec = pn % 4 == 0 && (uintptr_t)dprev % 16 == 0 &&
                     (uintptr_t)dfin % 16 == 0 && (uintptr_t)prev % 16 == 0 &&
                     (uintptr_t)dstates % 16 == 0 &&
                     (uintptr_t)dinit % 16 == 0;
    const int per_h = vec ? pn / 4 : pn;
    const int wph = (per_h + 31) / 32;
    const long long threads = B * H * (long long)wph * 32;
    const long long blocks = (threads + THREADS - 1) / THREADS;
    const long long n = B * nc * (long long)H;
    const long long sum_blocks = (n + THREADS - 1) / THREADS;
    if (blocks > 0x7fffffffLL || sum_blocks > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (vec)
        ssd_state_bwd_kernel<float4><<<(unsigned)blocks, THREADS, 0, st>>>(
            reinterpret_cast<const float4*>(dprev),
            reinterpret_cast<const float4*>(dfin),
            reinterpret_cast<const float4*>(prev), decay,
            reinterpret_cast<float4*>(dstates),
            reinterpret_cast<float4*>(dinit), part, B, nc, H, per_h, wph);
    else
        ssd_state_bwd_kernel<float><<<(unsigned)blocks, THREADS, 0, st>>>(
            dprev, dfin, prev, decay, dstates, dinit, part, B, nc, H, per_h,
            wph);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ssd_state_bwd_sum<<<(unsigned)sum_blocks, THREADS, 0, st>>>(part, ddecay,
                                                                n, wph);
    return (int)cudaGetLastError();
}
