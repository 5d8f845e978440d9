// Transpose of the banded DISCO contraction (its gradient w.r.t. x), for
// sm_90a.
//
// Replaces: the VJP of src/repro/kernels/disco/disco.py::disco_band_contract
// (with the roll and latitude gather of dispatch.disco_conv_banded_buffers),
// which the JAX package computes with jax.vjp of its oracle.
//
// The forward (csrc/disco_band.cu), with off0 = -(D / 2), is
//     out[b, k, h, w] = sum_{s, d} psi[k, h, s, d]
//                       * x[b, lat_idx[h, s], (w*stride + d + off0) mod W_in]
// so its transpose is, for every input row r and longitude v,
//     gx[b, r, v] = sum_{(h, s): lat_idx[h, s] = r} sum_k
//                   sum_{d: w*stride + d + off0 = v (mod W_in)}
//                   psi[k, h, s, d] * g[b, k, h, w].
// At stride 2 only the taps of the parity that matches v contribute.
// g (B, K, H_out, W_out), psi (K, H_out, S, D), gx (B, H_in, W_in); fp32.
// The (h, s) entries of each row r come as CSR lists built on the host
// once per plan (row_ptr (H_in + 1,), row_ent = h * S + s), without the
// entries whose psi slice is all zero.
//
// Bound on the H100: operations, as for the forward (the same products,
// 2 * K * S * D / stride FLOP per output of the forward).
//
// Design: deterministic, without atomics.  A block owns one input row r,
// a tile of TV = 128 longitudes v and a tile of TBP = 8 planes, and
// writes each of its gx elements exactly once.  It walks r's entries
// and, for each basis function k, stages the psi row psi[k, h, s, :] (D
// floats) and the g segment each plane's outputs need (the w that reach
// the tile through some tap, wrapping by index arithmetic) in shared
// memory; each thread then sums its taps for its v into TBP registers.
// A tap index d and its g column move in opposite directions, so the
// loop steps one pointer along each.  fp32 FMAs on the CUDA cores.
//
// Later work, not done here: each g value feeds one FMA (a register
// window over several v per thread would reuse it), and the taps outside
// the filter's disk are zero but are still multiplied.

#include <cuda_runtime.h>

namespace {

constexpr int TV = 128;  // input longitudes per block (one per thread)
constexpr int TBP = 8;   // planes per block

__device__ __forceinline__ int floordiv(int a, int b) {
    return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__global__ void __launch_bounds__(TV)
disco_band_bwd_kernel(const float* __restrict__ g,
                      const float* __restrict__ psi,
                      const int* __restrict__ row_ptr,
                      const int* __restrict__ row_ent,
                      float* __restrict__ gx, int B, int K, int H_out,
                      int W_out, int H_in, int W_in, int S, int D,
                      int stride) {
    extern __shared__ float smem[];
    const int off0 = -(D / 2);
    const int v0 = blockIdx.x * TV;
    const int r = blockIdx.y;
    const int b0 = blockIdx.z * TBP;
    const int tid = threadIdx.x;
    const int v = v0 + tid;
    // the w (unwrapped) that reach this tile through some tap
    const int wlo = floordiv(v0 - (D - 1) - off0, stride);
    const int whi = floordiv(v0 + TV - 1 - off0, stride);
    const int seg = whi - wlo + 1;
    float* ps = smem;        // [D]
    float* gs = smem + D;    // [TBP][seg]

    // this thread's first tap: v - d - off0 must be a multiple of stride
    // (v - off0 >= 0, so the remainder is the first such d)
    const int dstart = (v - off0) % stride;
    const int idx0 = (v - dstart - off0) / stride - wlo;

    float acc[TBP];
#pragma unroll
    for (int bb = 0; bb < TBP; ++bb) acc[bb] = 0.f;

    const int e1 = row_ptr[r + 1];
    for (int e = row_ptr[r]; e < e1; ++e) {
        const int hs = row_ent[e];
        const int h = hs / S;
        for (int k = 0; k < K; ++k) {
            const float* prow = psi + ((size_t)k * H_out * S + hs) * D;
            for (int i = tid; i < D; i += TV) ps[i] = prow[i];
            for (int i = tid; i < TBP * seg; i += TV) {
                const int bb = i / seg, j = i % seg;
                const int b = b0 + bb;
                int w = (wlo + j) % W_out;
                if (w < 0) w += W_out;
                gs[i] = (b < B)
                            ? g[(((size_t)b * K + k) * H_out + h) * W_out + w]
                            : 0.f;
            }
            __syncthreads();
            if (v < W_in) {
                const float* gp = gs + idx0;
                for (int d = dstart; d < D; d += stride, --gp) {
                    const float p = ps[d];
#pragma unroll
                    for (int bb = 0; bb < TBP; ++bb)
                        acc[bb] = fmaf(p, gp[bb * seg], acc[bb]);
                }
            }
            __syncthreads();
        }
    }

    if (v >= W_in) return;
#pragma unroll
    for (int bb = 0; bb < TBP; ++bb) {
        const int b = b0 + bb;
        if (b >= B) break;
        gx[((size_t)b * H_in + r) * W_in + v] = acc[bb];
    }
}

// Dynamic shared memory one block needs, in bytes (transpose_smem_bytes
// in kernels/disco/ops.py checks it before the launch).
size_t smem_bytes(int D, int stride) {
    const int seg = (TV + D - 1) / stride + 2;
    return sizeof(float) * (D + (size_t)TBP * seg);
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int disco_band_bwd_launch(const float* g, const float* psi,
                                     const int* row_ptr, const int* row_ent,
                                     float* gx, int B, int K, int H_out,
                                     int W_out, int H_in, int W_in, int S,
                                     int D, int stride, void* stream) {
    const size_t smem = smem_bytes(D, stride);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            disco_band_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((W_in + TV - 1) / TV, H_in, (B + TBP - 1) / TBP);
    disco_band_bwd_kernel<<<grid, TV, smem, (cudaStream_t)stream>>>(
        g, psi, row_ptr, row_ent, gx, B, K, H_out, W_out, H_in, W_in, S, D,
        stride);
    return (int)cudaGetLastError();
}
