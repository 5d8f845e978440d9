// Banded DISCO contraction on the sphere, for sm_90a.
//
// Replaces: src/repro/kernels/disco/disco.py::disco_band_contract (Pallas
// body _disco_kernel) together with the roll and latitude gather that
// src/repro/kernels/dispatch.py::disco_conv_banded_buffers does before it.
//
// Computes, with off0 = -(D / 2):
//     out[b, k, h, w] = sum_{s, d} psi[k, h, s, d]
//                       * x[b, lat_idx[h, s], (w*stride + d + off0) mod W_in]
// x (B, H_in, W_in), psi (K, H_out, S, D), lat_idx (H_out, S) int32,
// out (B, K, H_out, W_out) with W_out = W_in / stride; all fp32.
//
// Bound on the H100: operations.  Each output sums S*D products per basis
// function: at fcn3_full 2*K*S*D FLOP per output is 77 kFLOP at the
// encoder (S=13, D=423) and 45 kFLOP at the decoder (S=5, D=641), against
// 4 bytes read of x per S*D window element that is shared by neighbours;
// the ~60 TFLOP of band work per member-step is far above the fp32 ridge.
//
// Design: a block owns one output latitude row h, a tile of 128
// longitudes and a tile of 8 input planes; each thread keeps K x 8
// accumulators (one output longitude, every basis function, every plane).
// The loop over the S latitude taps stages one slice psi[:, h, s, :]
// (K x D floats, 18 KB at the decoder) and the 8 input rows' window
// segments in shared memory, so the whole psi row (154 KB at the encoder)
// never has to fit at once.  The input row is read through lat_idx and
// the longitude wraps by index arithmetic: neither the S-fold gathered
// copy nor the D-wrap-padded copy that the TPU path materialises (13 GB
// per member at the decoder) is ever written.  Each psi value fetched
// from shared memory (as two float4 broadcasts per tap) feeds 8 FMAs and
// each x value feeds K FMAs.  fp32 FMAs on the CUDA cores.
//
// Later work, not done here: the band is dense over D but the filter is
// zero outside the geodesic disk (sparsity skipped), tensor-core
// (3xTF32 / wgmma) formulation as a per-row GEMM, TMA staging.

#include <cuda_runtime.h>

namespace {

constexpr int TW = 128;   // output longitudes per block (one per thread)
constexpr int TBP = 8;    // input planes per block
constexpr int KP = 8;     // padded basis count in the shared psi slice

template <int K>
__global__ void __launch_bounds__(TW)
disco_band_kernel(const float* __restrict__ x, const float* __restrict__ psi,
                  const int* __restrict__ lat_idx, float* __restrict__ out,
                  int B, int H_in, int W_in, int H_out, int S, int D,
                  int stride, int W_out) {
    extern __shared__ float4 smem4[];
    float* ps = reinterpret_cast<float*>(smem4);   // [D][KP]
    const int seg = (TW - 1) * stride + D;
    float* xs = ps + D * KP;                        // [TBP][seg]

    const int w0 = blockIdx.x * TW;
    const int h = blockIdx.y;
    const int b0 = blockIdx.z * TBP;
    const int tid = threadIdx.x;
    const int w = w0 + tid;
    const int start = w0 * stride - D / 2;          // input column of xs[.][0]

    float acc[TBP][K];
#pragma unroll
    for (int bb = 0; bb < TBP; ++bb)
#pragma unroll
        for (int k = 0; k < K; ++k) acc[bb][k] = 0.f;

    for (int s = 0; s < S; ++s) {
        const int r = lat_idx[h * S + s];
        // psi[:, h, s, :] -> ps[d][k], read contiguously along d.
        for (int i = tid; i < KP * D; i += TW) {
            const int k = i / D, d = i % D;
            ps[d * KP + k] =
                (k < K) ? psi[((size_t)(k * H_out + h) * S + s) * D + d] : 0.f;
        }
        // the window segment of input row r for each plane of the tile
        for (int i = tid; i < TBP * seg; i += TW) {
            const int bb = i / seg, j = i % seg;
            const int b = b0 + bb;
            int col = (start + j) % W_in;
            if (col < 0) col += W_in;
            xs[i] = (b < B) ? x[((size_t)b * H_in + r) * W_in + col] : 0.f;
        }
        __syncthreads();
        if (w < W_out) {
            const float* xrow = xs + tid * stride;
            for (int d = 0; d < D; ++d) {
                const float4 p0 = *reinterpret_cast<const float4*>(ps + d * KP);
                const float4 p1 =
                    *reinterpret_cast<const float4*>(ps + d * KP + 4);
                const float pv[KP] = {p0.x, p0.y, p0.z, p0.w,
                                      p1.x, p1.y, p1.z, p1.w};
#pragma unroll
                for (int bb = 0; bb < TBP; ++bb) {
                    const float xv = xrow[bb * seg + d];
#pragma unroll
                    for (int k = 0; k < K; ++k)
                        acc[bb][k] = fmaf(pv[k], xv, acc[bb][k]);
                }
            }
        }
        __syncthreads();
    }

    if (w >= W_out) return;
#pragma unroll
    for (int bb = 0; bb < TBP; ++bb) {
        const int b = b0 + bb;
        if (b >= B) break;
#pragma unroll
        for (int k = 0; k < K; ++k)
            out[(((size_t)b * K + k) * H_out + h) * W_out + w] = acc[bb][k];
    }
}

template <int K>
int launch(const float* x, const float* psi, const int* lat_idx, float* out,
           int B, int H_in, int W_in, int H_out, int S, int D, int stride,
           cudaStream_t stream) {
    const int W_out = W_in / stride;
    const size_t smem =
        sizeof(float) * ((size_t)D * KP + (size_t)TBP * ((TW - 1) * stride + D));
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            disco_band_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((W_out + TW - 1) / TW, H_out, (B + TBP - 1) / TBP);
    disco_band_kernel<K><<<grid, TW, smem, stream>>>(
        x, psi, lat_idx, out, B, H_in, W_in, H_out, S, D, stride, W_out);
    return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// a basis count outside 1..8).
extern "C" int disco_band_launch(const float* x, const float* psi,
                                 const int* lat_idx, float* out, int B,
                                 int H_in, int W_in, int K, int H_out, int S,
                                 int D, int stride, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    switch (K) {
#define CASE(n) \
    case n:     \
        return launch<n>(x, psi, lat_idx, out, B, H_in, W_in, H_out, S, D, stride, st);
        CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
        default:
            return (int)cudaErrorInvalidValue;
    }
}
