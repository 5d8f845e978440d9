// Fused pointwise ensemble CRPS, forward and backward, for sm_90a.
//
// Replaces: src/repro/kernels/crps/crps.py::crps_fused (Pallas body
// _crps_kernel).  The JAX package differentiates it through its oracle;
// the backward here is a kernel of its own.
//
// Forward, per point n of ens (E, N), obs (N,) -> out (N,):
//     out[n] = sum_e |u_e - y| / E  -  c * sum_{a<b} |u_a - u_b| / E^2
// with c = 1 (biased, eq. 46) or E / (E - 1) (fair, eq. 47), summed in
// the order of the Pallas kernel.
// Backward with respect to ens only, g (N,) -> grad (E, N):
//     grad[e, n] = g[n] * ( sgn(u_e - y) / E
//                          - c / E^2 * sum_{i != e} sgn(u_e - u_i) )
// with sgn(0) = 0, the subgradient torch's abs takes at 0.
//
// Bound on the H100: bytes.  Each point reads E + 1 floats and writes 1
// (forward) or reads E + 2 and writes E (backward), against O(E^2)
// comparisons: at E = 2 that is 3-4 FLOP per byte, far below the fp32
// ridge (67 TFLOP/s over 3.35 TB/s, ~20 FLOP/B).
//
// Design: the TPU kernel streams (E, 1024) tiles through VMEM and unrolls
// the E^2 loop over vector registers; here one thread owns one point and
// keeps its E members in registers (E is a template parameter, capped at
// E_MAX), so the only device-memory traffic is the one read of each input
// and the one write of each output, coalesced along n for every member.

#include <cuda_runtime.h>

// Threads per block: a build may override it (-DTUNE_THREADS=512: the
// autotuner's variants, kernels/autotune.py).
#ifndef TUNE_THREADS
#define TUNE_THREADS 256
#endif

namespace {

constexpr int THREADS = TUNE_THREADS;
constexpr int E_MAX = 16;  // MAX_MEMBERS in kernels/crps/ops.py
static_assert(THREADS >= 32 && THREADS <= 1024 && THREADS % 32 == 0,
              "whole warps, at most 1024 threads a block");

__device__ __forceinline__ float sgnf(float x) {
    return (float)((x > 0.f) - (x < 0.f));
}

template <int E>
__global__ void __launch_bounds__(THREADS)
crps_fwd_kernel(const float* __restrict__ ens, const float* __restrict__ obs,
                float* __restrict__ out, long long N, float coeff) {
    const long long n = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (n >= N) return;
    float u[E];
#pragma unroll
    for (int e = 0; e < E; ++e) u[e] = ens[e * N + n];
    const float y = obs[n];
    float err = 0.f, spread = 0.f;
#pragma unroll
    for (int a = 0; a < E; ++a) {
        err += fabsf(u[a] - y);
#pragma unroll
        for (int b = a + 1; b < E; ++b) spread += fabsf(u[a] - u[b]);
    }
    out[n] = err / (float)E - coeff * spread / (float)(E * E);
}

template <int E>
__global__ void __launch_bounds__(THREADS)
crps_bwd_kernel(const float* __restrict__ g, const float* __restrict__ ens,
                const float* __restrict__ obs, float* __restrict__ grad,
                long long N, float coeff) {
    const long long n = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (n >= N) return;
    float u[E];
#pragma unroll
    for (int e = 0; e < E; ++e) u[e] = ens[e * N + n];
    const float y = obs[n];
    const float gn = g[n];
    const float cs = coeff / (float)(E * E);
#pragma unroll
    for (int e = 0; e < E; ++e) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < E; ++i) s += sgnf(u[e] - u[i]);  // i == e adds 0
        grad[e * N + n] = gn * (sgnf(u[e] - y) / (float)E - cs * s);
    }
}

template <int E>
int launch(const float* g, const float* ens, const float* obs, float* out,
           long long N, float coeff, bool backward, cudaStream_t stream) {
    const long long blocks = (N + THREADS - 1) / THREADS;
    if (backward)
        crps_bwd_kernel<E><<<(unsigned)blocks, THREADS, 0, stream>>>(
            g, ens, obs, out, N, coeff);
    else
        crps_fwd_kernel<E><<<(unsigned)blocks, THREADS, 0, stream>>>(
            ens, obs, out, N, coeff);
    return (int)cudaGetLastError();
}

static_assert(E_MAX == 16, "dispatch has one CASE per member count");

int dispatch(const float* g, const float* ens, const float* obs, float* out,
             int E, long long N, float coeff, bool backward, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    switch (E) {
#define CASE(n) \
    case n:     \
        return launch<n>(g, ens, obs, out, N, coeff, backward, st);
        CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
        CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15)
        CASE(16)
#undef CASE
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// The compiled constants: THREADS, E_MAX; returns how many it wrote.
extern "C" int crps_constants(int* out) {
    out[0] = THREADS;
    out[1] = E_MAX;
    return 2;
}

// ens (E, N), obs (N,), out (N,), all contiguous fp32.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for E
// outside 1..E_MAX).
extern "C" int crps_fwd_launch(const float* ens, const float* obs, float* out,
                               int E, long long N, float coeff, void* stream) {
    return dispatch(nullptr, ens, obs, out, E, N, coeff, false, stream);
}

// g (N,), ens (E, N), obs (N,) -> grad (E, N), all contiguous fp32.
extern "C" int crps_bwd_launch(const float* g, const float* ens,
                               const float* obs, float* grad, int E,
                               long long N, float coeff, void* stream) {
    return dispatch(g, ens, obs, grad, E, N, coeff, true, stream);
}
