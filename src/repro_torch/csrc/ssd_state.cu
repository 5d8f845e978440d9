// The inter-chunk recurrence of the chunked SSD scan, in one launch, for
// sm_90a.
//
// Replaces: the jax.lax.scan over chunks in src/repro/kernels/ssd/ops.py::
// ssd_chunked_pallas (not a TPU kernel: XLA compiles the scan to one loop
// on the device; the port's plain version, kernels/ssd/ref.py::
// chunk_recurrence_ref, issues two launches a chunk).  With states
// (B, nc, H, P, N) each chunk's own end state, decay (B, nc, H) and init
// (B, H, P, N):
//     prev[b, 0] = init[b];  prev[b, c + 1] = states[b, c] + decay[b, c] prev[b, c]
//     final[b]   = states[b, nc - 1] + decay[b, nc - 1] prev[b, nc - 1]
// computed as one fused multiply-add a step (the plain version's addcmul
// may round twice: the two agree to a few ulps, see tests/test_torch_cuda.py).
//
// Bound on the H100: bytes.  Every state is read once and every prev
// written once: at the mamba2-130m prefill (B = 2, nc = 256, H = 24, P =
// 64, N = 128) 403 MB each way, 0.24 ms at 3.35 TB/s; two FLOPs an element.
//
// Design: each thread owns four contiguous (h, p, n) elements of one batch
// row (16-byte loads and stores; one element on the scalar path when P * N
// is not a multiple of 4 or a pointer is not 16-byte aligned) and walks
// the chunks in order, carrying its state in registers.  The loads of the
// next DEPTH chunks' states and decays are in flight while the current
// chunk's multiply-add waits on them: the chain over chunks is serial, so
// the bytes in flight come from the threads (B * H * P * N / 4 of them)
// times DEPTH.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int DEPTH = 4;      // chunks loaded ahead

__device__ __forceinline__ float fma_step(float d, float c, float s) {
    return fmaf(d, c, s);
}
__device__ __forceinline__ float4 fma_step(float d, float4 c, float4 s) {
    return make_float4(fmaf(d, c.x, s.x), fmaf(d, c.y, s.y),
                       fmaf(d, c.z, s.z), fmaf(d, c.w, s.w));
}

// T = float4 (W = 4 elements a thread) or float (W = 1).
template <typename T, int W>
__global__ void __launch_bounds__(THREADS)
ssd_state_kernel(const T* __restrict__ states, const float* __restrict__ decay,
                 const T* __restrict__ init, T* __restrict__ prev,
                 T* __restrict__ fin, long long n_rows, int nc, int H,
                 int per_h) {
    // per_h = P * N / W items of one head, H * per_h items of a batch row
    const long long row_items = (long long)H * per_h;
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n_rows * row_items) return;
    const long long b = i / row_items;
    const long long e = i % row_items;
    const int h = (int)(e / per_h);
    const T* sp = states + b * nc * row_items + e;    // chunk c: + c * row_items
    T* pp = prev + b * nc * row_items + e;
    const float* dp = decay + b * nc * H + h;          // chunk c: + c * H

    T s[DEPTH];
    float d[DEPTH];
#pragma unroll
    for (int k = 0; k < DEPTH; ++k) {
        if (k < nc) {
            s[k] = __ldg(sp + k * row_items);
            d[k] = __ldg(dp + k * H);
        }
    }
    T carry = init[b * row_items + e];
    for (int c0 = 0; c0 < nc; c0 += DEPTH) {
#pragma unroll
        for (int k = 0; k < DEPTH; ++k) {
            const int c = c0 + k;
            if (c >= nc) break;
            pp[c * row_items] = carry;
            const T sc = s[k];
            const float dc = d[k];
            if (c + DEPTH < nc) {   // the load DEPTH chunks ahead
                s[k] = __ldg(sp + (c + DEPTH) * row_items);
                d[k] = __ldg(dp + (c + DEPTH) * H);
            }
            carry = fma_step(dc, carry, sc);
        }
    }
    fin[b * row_items + e] = carry;
}

}  // namespace

// states (B, nc, H, P, N), decay (B, nc, H), init (B, H, P, N) -> prev
// (B, nc, H, P, N), fin (B, H, P, N); all contiguous fp32, nc >= 1.
// Returns cudaGetLastError() after the launch.
extern "C" int ssd_state_launch(const float* states, const float* decay,
                                const float* init, float* prev, float* fin,
                                long long B, int nc, int H, int P, int N,
                                void* stream) {
    if (B < 1 || nc < 1 || H < 1 || P < 1 || N < 1)
        return (int)cudaErrorInvalidValue;
    const int pn = P * N;
    const bool vec = pn % 4 == 0 && (uintptr_t)states % 16 == 0 &&
                     (uintptr_t)init % 16 == 0 && (uintptr_t)prev % 16 == 0 &&
                     (uintptr_t)fin % 16 == 0;
    const int w = vec ? 4 : 1;
    const long long items = B * H * (long long)(pn / w);
    const long long blocks = (items + THREADS - 1) / THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (vec)
        ssd_state_kernel<float4, 4><<<(unsigned)blocks, THREADS, 0, st>>>(
            reinterpret_cast<const float4*>(states), decay,
            reinterpret_cast<const float4*>(init),
            reinterpret_cast<float4*>(prev), reinterpret_cast<float4*>(fin),
            B, nc, H, pn / 4);
    else
        ssd_state_kernel<float, 1><<<(unsigned)blocks, THREADS, 0, st>>>(
            states, decay, init, prev, fin, B, nc, H, pn);
    return (int)cudaGetLastError();
}
