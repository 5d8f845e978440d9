// Legendre contraction of the spherical harmonic transform, for sm_90a.
//
// Replaces: src/repro/kernels/legendre/legendre.py::legendre_contract
// (Pallas body _legendre_kernel), the TPU kernel of both SHT directions.
//
// Computes, in the TPU kernel's own m-minor layout (no copies around it):
//     out[b, n, j] = sum_k x[b, k, j] * t[k, n, j >> CSHIFT]
// i.e. one (B x K) @ (K x N) product per Fourier order m.  With CSHIFT = 0
// j is m (real x).  With CSHIFT = 1 j interleaves (m, re/im): x and out are
// complex64 tensors seen as floats, and the real and imaginary parts of
// one order share its table in one launch.  Forward SHT: k = latitude,
// t = quadrature-weighted Pbar (H, L, M); inverse SHT: k = degree, t =
// Pbar seen transposed as (L, H, M) through its strides.  x and t may
// have any strides but a unit one on j and m; out is contiguous.
//
// Bound on the H100: operations.  At the fcn3_full latent (K = N = M =
// 360, B ~ 1350 complex rows for 2 members) the product does
// 2*2B*K*N*M ~ 250 GFLOP on ~3 GB of operands, ~80 FLOP per byte, above
// the fp32 ridge of the card (67 TFLOP/s over 3.35 TB/s ~ 20 FLOP/B).
//
// Design: the TPU kernel's sequential "arbitrary" k grid axis, which
// carried the sum in o_ref from one grid step to the next, becomes a
// loop over K inside one CUDA block (blocks run in no order, so nothing
// may be carried between them).  m is the fastest axis in memory, so a
// block owns TJ = 8 adjacent j and, for each, a 32-row b by 64-column n
// output tile: the loads of x (8 adjacent floats per (b, k)) and of t
// (8 or 4 per (k, n)) and the stores of out stay coalesced, and no
// m-major copy of any operand is made around the kernel.
// 256 threads, thread = (j, 8 rows, 8 columns): an 8 x 8 register tile
// of accumulators fed by four float4 shared reads per k.  n tiles are the
// fastest grid axis, so the blocks that share an x tile run together and
// x comes from device memory about once.  fp32 FMAs on the CUDA cores,
// no tensor cores: the port computes what the fp32 reference computes.
//
// Later work, not done here: the tables are zero for m > l
// (core/sphere/legendre.py), so about half of the work could be
// skipped; wgmma/TMA pipelining; 3xTF32 tensor-core emulation.

#include <cuda_runtime.h>

namespace {

constexpr int TJ = 8;    // j per block (adjacent in memory)
constexpr int TB = 32;   // output rows (b) per j per block
constexpr int TN = 64;   // output columns (n) per j per block
constexpr int TK = 8;    // contraction depth staged per step
constexpr int THREADS = 256;
constexpr int XLD = TB + 4;  // padded rows: float4-aligned, few conflicts
constexpr int TLD = TN + 8;

// Register budget: two blocks per SM (<= 128 registers a thread), so one
// block's loads overlap the other's FMAs.  Each thread keeps one pointer
// into x and one into t and steps them along K, rather than recomputing
// strided 64-bit addresses for each of its loads.
template <int CSHIFT>
__global__ void __launch_bounds__(THREADS, 2)
legendre_kernel(const float* __restrict__ x, const float* __restrict__ t,
                float* __restrict__ out, int B, int K, int N, int J,
                long long sxb, long long sxk, long long stk, long long stn) {
    constexpr int TM = TJ >> CSHIFT;  // table orders one block needs
    static_assert(TJ * TB == THREADS, "one x load per thread per k");
    constexpr int TNQ = THREADS / TM;  // n covered by one t load pass
    constexpr int QPK = TN / TNQ;      // t load passes per k
    const int n0 = blockIdx.x * TN;
    const int b0 = blockIdx.y * TB;
    const int j0 = blockIdx.z * TJ;
    const int m0 = j0 >> CSHIFT;
    const int M = J >> CSHIFT;

    __shared__ __align__(16) float xs[TK][TJ][XLD];  // xs[k][j][b]
    __shared__ __align__(16) float ts[TK][TM][TLD];  // ts[k][m][n]

    const int tid = threadIdx.x;
    const int j = tid % TJ;
    const int r = tid / TJ;    // 0..31
    const int bg = r / 8;      // rows bg*8 .. bg*8+7
    const int ng = r % 8;      // columns ng*8 .. ng*8+7
    const int jm = j >> CSHIFT;

    // x loads: thread (j, row r) fetches x[b0 + r, k, j0 + j] for the TK
    // k of a step; a warp reads 4 rows of 8 adjacent floats and stores
    // them to 32 distinct banks.
    const bool x_ok = b0 + r < B && j0 + j < J;
    const float* xp = x + (b0 + r) * sxb + (j0 + j);
    // t loads: thread (m, n) fetches t[k, n0 + n (+ TNQ), m0 + m].
    const int tm_ = tid % TM, tn_ = tid / TM;
    const bool t_ok = m0 + tm_ < M;
    const float* tp = t + (n0 + tn_) * stn + (m0 + tm_);

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

    for (int k0 = 0; k0 < K; k0 += TK) {
#pragma unroll
        for (int kk = 0; kk < TK; ++kk)
            xs[kk][j][r] = (x_ok && k0 + kk < K) ? xp[kk * sxk] : 0.f;
#pragma unroll
        for (int q = 0; q < TK * QPK; ++q) {
            const int kk = q / QPK, nn = tn_ + TNQ * (q % QPK);
            ts[kk][tm_][nn] = (t_ok && k0 + kk < K && n0 + nn < N)
                                  ? tp[kk * stk + TNQ * (q % QPK) * stn]
                                  : 0.f;
        }
        xp += TK * sxk;
        tp += TK * stk;
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < TK; ++kk) {
            const float4 a0 = *reinterpret_cast<const float4*>(&xs[kk][j][bg * 8]);
            const float4 a1 =
                *reinterpret_cast<const float4*>(&xs[kk][j][bg * 8 + 4]);
            const float4 c0 = *reinterpret_cast<const float4*>(&ts[kk][jm][ng * 8]);
            const float4 c1 =
                *reinterpret_cast<const float4*>(&ts[kk][jm][ng * 8 + 4]);
            const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int cc = 0; cc < 8; ++cc)
                    acc[i][cc] = fmaf(a[i], c[cc], acc[i][cc]);
        }
        __syncthreads();
    }

    const int jg = j0 + j;
    if (jg >= J) return;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int b = b0 + bg * 8 + i;
        if (b >= B) continue;
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) {
            const int n = n0 + ng * 8 + cc;
            if (n < N) out[((size_t)b * N + n) * J + jg] = acc[i][cc];
        }
    }
}

}  // namespace

// x: (B, K, J) floats at strides (sxb, sxk, 1); t: (K, N, J >> cshift)
// floats at strides (stk, stn, 1); out: (B, N, J) contiguous floats.
// cshift is 0 (real x) or 1 (complex x, j = 2m + re/im).
// Returns cudaGetLastError() after the launch.
extern "C" int legendre_contract_launch(const float* x, const float* t,
                                        float* out, int B, int K, int N,
                                        int J, int cshift, long long sxb,
                                        long long sxk, long long stk,
                                        long long stn, void* stream) {
    dim3 grid((N + TN - 1) / TN, (B + TB - 1) / TB, (J + TJ - 1) / TJ);
    cudaStream_t s = (cudaStream_t)stream;
    if (cshift == 1)
        legendre_kernel<1><<<grid, THREADS, 0, s>>>(x, t, out, B, K, N, J,
                                                    sxb, sxk, stk, stn);
    else
        legendre_kernel<0><<<grid, THREADS, 0, s>>>(x, t, out, B, K, N, J,
                                                    sxb, sxk, stk, stn);
    return (int)cudaGetLastError();
}
