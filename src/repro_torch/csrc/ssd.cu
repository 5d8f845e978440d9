// Mamba-2 SSD intra-chunk step, for sm_90a.
//
// Replaces: src/repro/kernels/ssd/ssd.py::ssd_intra_chunk (Pallas body
// _ssd_kernel).  Per (chunk bc, head h), with cs = da_cs[bc, :, h] the
// inclusive cumsum of dt*A within the chunk and g = h / (H / G) the head's
// group:
//     att[l, s]  = (sum_n C[l, g, n] B[s, g, n]) * exp(cs[l] - cs[s])  (s <= l)
//                = 0                                                  (s >  l)
//     y[l, p]    = sum_s att[l, s] X[s, h, p]
//     st[p, n]   = sum_l X[l, h, p] B[l, g, n] exp(cs[L-1] - cs[l])
// as kernels/ssd/ref.py defines it: the mask is applied before exp, so
// exp never sees the positive cs[l] - cs[s] above the diagonal (the Pallas
// body multiplies exp(diff) by the mask and turns an overflow into
// inf * 0 = NaN once a chunk's |dA| sum passes ~88).
//
// Bound on the H100: operations.  At the prefill shape of mamba2-130m
// (BC = 512, L = 128, H = 24, P = 64, G = 1, N = 128) the data needs
// ~4.0e10 FLOPs (C B^T once per group on the s <= l taps) against 1.28 GB
// of device memory: 0.60 ms at the fp32 CUDA-core rate vs 0.38 ms at
// 3.35 TB/s.  This kernel does the dense work the TPU kernel does,
// 1.03e11 FLOPs (C B^T once per head, all L x L taps).
//
// Design: one block of 256 threads per (bc, h), fp32 SIMT throughout.
// The block's operands stay in shared memory and each input is read from
// device memory once per head (B twice: the state phase reloads it):
//   1. C B^T: C and B of the group are staged in N-slices of NK, stored
//      transposed (k-major, padded) so a warp reads them without bank
//      conflicts; each thread accumulates an 8 x 8 register tile of rows
//      ty + 16 i, columns tx + 16 j.  The mask and the decay are applied
//      to the tile, which lands in `att` (L x ATT_LD floats in shared
//      memory).
//   2. y = att @ X: X (L x P) staged whole; each thread owns 8 rows x 4
//      columns; only s up to the thread's last row is summed.
//   3. st = X^T (B * w): B times its weight w[l] = exp(cs[L-1] - cs[l])
//      reuses the `att` region (L x N); each thread owns 4 x 8 outputs.
// Shared memory is ~107 KB a block, so two blocks share an SM.  Tensor
// cores, TMA and computing C B^T once per group are later work.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int L_MAX = 128;    // chunk length; L_MAX in kernels/ssd/ops.py
constexpr int P_MAX = 64;     // head dim
constexpr int N_MAX = 128;    // state dim
constexpr int NK = 32;        // N-slice of C and B in phase 1
constexpr int T_LD = L_MAX + 1;   // transposed C / B slices: [NK][T_LD]
constexpr int ATT_LD = L_MAX + 16;  // rows ty and ty+1 land 16 banks apart

// dynamic shared memory, in floats
constexpr int SMEM_CS = L_MAX;
constexpr int SMEM_ATT = L_MAX * ATT_LD;
constexpr int SMEM_STAGE_T = 2 * NK * T_LD;
constexpr int SMEM_STAGE_X = L_MAX * P_MAX;
constexpr int SMEM_STAGE =
    SMEM_STAGE_T > SMEM_STAGE_X ? SMEM_STAGE_T : SMEM_STAGE_X;
constexpr int SMEM_FLOATS = SMEM_CS + SMEM_ATT + SMEM_STAGE;
constexpr size_t SMEM_BYTES = sizeof(float) * SMEM_FLOATS;

static_assert(N_MAX <= ATT_LD, "phase 3 keeps B (L x N) in the att region");
static_assert(THREADS == 256, "thread tiles assume a 16 x 16 thread grid");

__global__ void __launch_bounds__(THREADS, 2)
ssd_intra_chunk_kernel(const float* __restrict__ x,
                       const float* __restrict__ da_cs,
                       const float* __restrict__ b_mat,
                       const float* __restrict__ c_mat,
                       float* __restrict__ y, float* __restrict__ st,
                       int L, int H, int P, int G, int N) {
    extern __shared__ float smem[];
    float* cs = smem;                       // [L]
    float* att = cs + SMEM_CS;              // [L][ATT_LD]; phase 3: B * w
    float* stage = att + SMEM_ATT;          // Ct/Bt slices, then X [L][P]
    float* ct = stage;                      // [NK][T_LD]
    float* bt = stage + NK * T_LD;          // [NK][T_LD]
    float* xs = stage;                      // [L][P]

    const int tid = threadIdx.x;
    const int ty = tid / 16, tx = tid % 16;
    const long long bc = blockIdx.x / H;
    const int h = blockIdx.x % H;
    const int g = h / (H / G);

    const float* xp = x + (bc * L * H + h) * (long long)P;      // row l: + l*H*P
    const float* bp = b_mat + (bc * L * G + g) * (long long)N;  // row l: + l*G*N
    const float* cp = c_mat + (bc * L * G + g) * (long long)N;

    for (int l = tid; l < L; l += THREADS) cs[l] = da_cs[(bc * L + l) * H + h];

    // ---- phase 1: att = (C B^T) masked, times exp(cs[l] - cs[s]) --------
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int n0 = 0; n0 < N; n0 += NK) {
        __syncthreads();  // the previous slice is consumed
        for (int e = tid; e < L * NK; e += THREADS) {
            const int l = e / NK, k = e % NK;
            const bool in = n0 + k < N;
            ct[k * T_LD + l] = in ? cp[(long long)l * G * N + n0 + k] : 0.f;
            bt[k * T_LD + l] = in ? bp[(long long)l * G * N + n0 + k] : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int k = 0; k < NK; ++k) {
            float cv[8], bv[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) cv[i] = ct[k * T_LD + ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 8; ++j) bv[j] = bt[k * T_LD + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] += cv[i] * bv[j];
        }
    }
    __syncthreads();  // cs is visible; the staging area is free
    const float cs_end = cs[L - 1];

#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int l = ty + 16 * i;
        if (l >= L) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int s = tx + 16 * j;
            if (s >= L) continue;
            att[l * ATT_LD + s] = s <= l ? acc[i][j] * expf(cs[l] - cs[s]) : 0.f;
        }
    }
    for (int e = tid; e < L * P; e += THREADS) {
        const int l = e / P, p = e % P;
        xs[l * P + p] = xp[(long long)l * H * P + p];
    }
    __syncthreads();

    // ---- phase 2: y = att @ X --------------------------------------------
    {
        float yacc[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) yacc[i][j] = 0.f;
        // att[l][s] = 0 for s > l: stop after the thread's last row
        const int s_end = min(L, ty + 16 * 7 + 1);
        for (int s = 0; s < s_end; ++s) {
            float av[8], xv[4];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int l = ty + 16 * i;
                av[i] = l < L ? att[l * ATT_LD + s] : 0.f;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int p = tx + 16 * j;
                xv[j] = p < P ? xs[s * P + p] : 0.f;
            }
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) yacc[i][j] += av[i] * xv[j];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int l = ty + 16 * i;
            if (l >= L) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int p = tx + 16 * j;
                if (p < P) y[((bc * L + l) * H + h) * (long long)P + p] = yacc[i][j];
            }
        }
    }
    __syncthreads();  // att and cs are consumed

    // ---- phase 3: st = X^T (B * w), w[l] = exp(cs[L-1] - cs[l]) ------------
    float* w = cs;    // [L], in place of cs
    float* bw = att;  // [L][ATT_LD]
    for (int l = tid; l < L; l += THREADS) w[l] = expf(cs_end - cs[l]);
    __syncthreads();
    for (int e = tid; e < L * N; e += THREADS) {
        const int l = e / N, n = e % N;
        bw[l * ATT_LD + n] = bp[(long long)l * G * N + n] * w[l];
    }
    __syncthreads();
    {
        float sacc[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) sacc[i][j] = 0.f;
        for (int l = 0; l < L; ++l) {
            float xv[4], bv[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int p = ty + 16 * i;
                xv[i] = p < P ? xs[l * P + p] : 0.f;
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int n = tx + 16 * j;
                bv[j] = n < N ? bw[l * ATT_LD + n] : 0.f;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) sacc[i][j] += xv[i] * bv[j];
        }
        float* sp = st + (bc * H + h) * (long long)P * N;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int p = ty + 16 * i;
            if (p >= P) continue;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int n = tx + 16 * j;
                if (n < N) sp[(long long)p * N + n] = sacc[i][j];
            }
        }
    }
}

}  // namespace

// x (BC, L, H, P), da_cs (BC, L, H), b_mat and c_mat (BC, L, G, N) ->
// y (BC, L, H, P), st (BC, H, P, N); all contiguous fp32.  Takes
// 1 <= L <= 128, P <= 64, N <= 128 and H % G == 0 (the wrapper checks).
// Returns cudaGetLastError() after the launch.
extern "C" int ssd_intra_chunk_launch(const float* x, const float* da_cs,
                                      const float* b_mat, const float* c_mat,
                                      float* y, float* st, long long BC, int L,
                                      int H, int P, int G, int N, void* stream) {
    if (L < 1 || L > L_MAX || P < 1 || P > P_MAX || N < 1 || N > N_MAX ||
        G < 1 || H % G != 0 || BC * H > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    // above 48 KB of dynamic shared memory; set on every call (cheap), so
    // each device the kernel runs on has it
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_intra_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)(BC * H);
    ssd_intra_chunk_kernel<<<blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        x, da_cs, b_mat, c_mat, y, st, L, H, P, G, N);
    return (int)cudaGetLastError();
}
