// Mamba-2 SSD intra-chunk step, for sm_90a.
//
// Replaces: src/repro/kernels/ssd/ssd.py::ssd_intra_chunk (Pallas body
// _ssd_kernel).  Per (chunk bc, head h), with cs = da_cs[bc, :, h] the
// inclusive cumsum of dt*A within the chunk and g = h / (H / G) the head's
// group:
//     att[l, s]  = (sum_n C[l, g, n] B[s, g, n]) * exp(cs[l] - cs[s])  (s <= l)
//                = 0                                                  (s >  l)
//     y[l, p]    = sum_s att[l, s] X[s, h, p]
//     st[p, n]   = sum_l X[l, h, p] exp(cs[L-1] - cs[l]) B[l, g, n]
// as kernels/ssd/ref.py defines it: the mask is applied before exp, so
// exp never sees the positive cs[l] - cs[s] above the diagonal (the Pallas
// body multiplies exp(diff) by the mask and turns an overflow into
// inf * 0 = NaN once a chunk's |dA| sum passes ~88).
//
// Bound on the H100: at the prefill shape of mamba2-130m (BC = 512, L =
// 128, H = 24, P = 64, G = 1, N = 128) the data needs 3.98e10 FLOPs (C B^T
// once per group and att @ X on the s <= l taps, the state product whole)
// and 1.28 GB of device memory: 0.60 ms at the fp32 CUDA-core rate, and
// on the tensor cores in 3xTF32 (three TF32 products per product, 0.24 ms)
// the bytes bound it, 0.38 ms at 3.35 TB/s.
//
// Design: one block of 16 warps per (chunk, group, tile of heads).
// * C B^T once per group.  The block stages the group's B (L x N) and C
//   and forms the causal part of C B^T once, on the tensor cores: only
//   the 16 x 8 tiles (l-tile i, s-tile j) with j <= 2 i + 1, 72 of the
//   128 at L = 128.  Each tile is stored in the A-fragment order of the
//   att @ X product (one float4 a lane), so the product reads it with one
//   conflict-free 16-byte load a fragment.  It then walks its heads.
// * Causal tiles only.  att @ X contracts each 16-row l-tile over the
//   s-blocks up to its diagonal, 2 (i + 1) of 16.  The decay is applied
//   while the A fragment is built: exp(cs[l] - cs[s]) where s <= l and 0
//   elsewhere (the mask chooses before the product, so an overflowing
//   exp is never multiplied).  The decay is not factored into exp(cs[l])
//   exp(-cs[s]): those overflow exactly where the reference stays finite.
// * Tensor cores in 3xTF32 (tf32x3.cuh) for all three products: C B^T,
//   att @ X (l x s by s x p) and the state product X^T (w B) computed as
//   (w X)^T B, w[l] = exp(cs[L-1] - cs[l]) scaling X's rows as its A
//   fragments are built, so B is staged once a block and never rescaled.
//   Within each k-block of 8 the depth index runs over s (or l) in the
//   order 0 2 4 6 | 1 3 5 7: the C B^T accumulator a lane holds, columns
//   2t and 2t + 1, is then exactly its A fragment of att @ X, and X and B
//   are read at rows 2t and 2t + 1 (row pitches 68 and 132 floats put the
//   lanes of a fragment on 32 banks).
// * Copies overlap the products.  A ring of three slots, each one head's
//   X (L x P) and cs: the first two slots first hold C's two column
//   halves (C is needed only for C B^T); head j + 2's X is copied with
//   cp.async while head j is contracted, one barrier a head.  B and C are
//   read from device memory once a block, X once a head.
// * Warps: 16 a block (one block an SM: 210,432 bytes of shared memory).
//   Warps 0-15 form C B^T (a pair of l-tiles i and 7 - i and every fourth
//   s-tile each).  Per head, warps 0-7 compute y (a pair of l-tiles i and
//   7 - i, so that each warp has 18 s-blocks, times one half of P) and
//   warps 8-15 the state (one half of P times one quarter of N); the two
//   products share the head's staged X.  On the H100 (700 W,
//   tools/ssd_variants.py, prefill shape) 24 warps, 16 of them for the
//   state at 78 registers, took 1.255 ms against 1.143 ms for 16 at 119:
//   each group runs alone in ~0.9 ms (no_y 0.959 ms, no_state 0.895 ms),
//   so the two groups mostly overlap and each is held by its latency.
// * Heads per block: 24, a whole group of mamba2-130m: 512 blocks, 3.9
//   waves on 132 SMs, C B^T formed once a chunk.  On the H100 24 heads
//   took 1.143 ms, 12 1.183 ms, 8 1.224 ms and 6 1.289 ms: each smaller
//   tile forms C B^T again and exposes one more prologue (B and C staged,
//   C B^T formed before the first head), which costs more than the
//   quarter wave it saves.
// Every output is written once by one lane: the kernel is deterministic.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

// The tile constants a build may override (-DTUNE_HEADS_PER_BLOCK=12 ...:
// the autotuner's variants, kernels/autotune.py); without -D flags they
// are the values below.
#ifndef TUNE_THREADS
#define TUNE_THREADS 512
#endif
#ifndef TUNE_HEADS_PER_BLOCK
#define TUNE_HEADS_PER_BLOCK 24
#endif

namespace {

constexpr int L_MAX = 128;    // chunk length; L_MAX in kernels/ssd/ops.py
constexpr int P_MAX = 64;     // head dim
constexpr int N_MAX = 128;    // state dim
constexpr int THREADS = TUNE_THREADS;
constexpr int Y_WARPS = 8;    // warps 0..7: y; the others: the state
constexpr int S_WARPS = THREADS / 32 - Y_WARPS;
// a state warp's columns: one half of P times N_MAX / (S_WARPS / 2) of N
constexpr int S_NW = N_MAX / (S_WARPS / 2);
constexpr int S_NT = S_NW / 8;    // its n-tiles of 8
constexpr int HEADS_PER_BLOCK = TUNE_HEADS_PER_BLOCK;
constexpr int B_LD = N_MAX + 4;   // row pitch of B: 132 = 4 (mod 32)
constexpr int X_LD = P_MAX + 4;   // row pitch of X and of C's halves: 68
// one slot: a head's X [L_MAX][X_LD] and its cs [L_MAX]
constexpr int SLOT = L_MAX * X_LD + L_MAX;
constexpr int SLOTS = 3;
// causal 16 x 8 tiles of C B^T: l-tile i holds s-tiles 0 .. 2 i + 1
constexpr int TRI_TILES = (L_MAX / 16) * (L_MAX / 16 + 1);
constexpr int SMEM_FLOATS = L_MAX * B_LD + SLOTS * SLOT + TRI_TILES * 128;
constexpr size_t SMEM_BYTES = sizeof(float) * SMEM_FLOATS;

static_assert(Y_WARPS == 8 && S_WARPS % 2 == 0 && S_NW % 8 == 0,
              "y: 4 pairs of l-tiles x 2 halves of P; the state: 2 halves of "
              "P x whole n-tiles");
static_assert(THREADS % 32 == 0 && THREADS <= 1024 && THREADS / 32 >= 16,
              "whole warps, C B^T takes warps 0-15; at most 1024 threads");
static_assert(N_MAX % (S_WARPS / 2) == 0, "the state warps tile N");
static_assert(HEADS_PER_BLOCK >= 1, "at least one head a block");
static_assert(SMEM_BYTES <= 232448, "one block an SM");
static_assert(L_MAX * X_LD + L_MAX <= SLOT, "C's halves fit a slot");

struct Params {
    const float* x;
    const float* da_cs;
    const float* b;
    const float* c;
    float* y;
    float* st;
    int L, H, P, G, N;
    int ht;       // heads per block
    int tiles;    // head tiles per group
    int vec;      // 16-byte copies (P % 4 == N % 4 == 0, aligned inputs)
};

__host__ __device__ constexpr int round_up(int v, int m) {
    return (v + m - 1) / m * m;
}

// Start copying rows [0, rows) x columns [0, cols) of a row-major source
// (row pitch `pitch` floats) into shared memory (row pitch ld); elements
// outside rows_ok x cols_ok are zero-filled.  cols is a multiple of 4.
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* src, long long pitch,
                                           int rows, int rows_ok, int cols,
                                           int cols_ok, bool vec) {
    if (vec) {
        const int q = cols / 4;
        for (int e = threadIdx.x; e < rows * q; e += THREADS) {
            const int r = e / q, j = 4 * (e % q);
            const bool ok = r < rows_ok && j < cols_ok;
            tf32x3::cp_async16(dst + r * ld + j, ok ? src + r * pitch + j : src,
                               ok);
        }
    } else {
        for (int e = threadIdx.x; e < rows * cols; e += THREADS) {
            const int r = e / cols, j = e % cols;
            const bool ok = r < rows_ok && j < cols_ok;
            tf32x3::cp_async4(dst + r * ld + j, ok ? src + r * pitch + j : src,
                              ok);
        }
    }
}

// Start copying head h's X and cs of chunk bc into a slot.
__device__ __forceinline__ void stage_head(const Params& p, float* slot,
                                           long long bc, int h) {
    const int L = p.L, Lr = round_up(L, 16);
    stage_rows(slot, X_LD, p.x + (bc * L * p.H + h) * (long long)p.P,
               (long long)p.H * p.P, Lr, L, round_up(p.P, 16), p.P, p.vec);
    float* cs = slot + L_MAX * X_LD;
    for (int l = threadIdx.x; l < Lr; l += THREADS) {
        const bool ok = l < L;
        tf32x3::cp_async4(cs + l, p.da_cs + (ok ? (bc * L + l) * p.H + h : 0),
                          ok);
    }
}

// C B^T's causal tiles into tri, in att @ X's A-fragment order: warp w
// takes l-tiles q = w / 4 and 7 - q and the s-tiles j = w % 4 (mod 4).
__device__ __forceinline__ void form_cbt(const Params& p, const float* bs,
                                         const float* c0, const float* c1,
                                         float* tri, int warp, int lane) {
    const int gq = lane >> 2, t = lane & 3;
    const int q = warp >> 2, r = warp & 3;
    const int lt = round_up(p.L, 16) / 16;
    const int nkb = (p.N + 7) / 8;
#pragma unroll 1
    for (int side = 0; side < 2; ++side) {
        const int i = side ? L_MAX / 16 - 1 - q : q;
        if (i >= lt) continue;
        const int nt = 2 * i + 2;      // s-tiles on or below the diagonal
        float acc[4][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[jj][e] = 0.f;
#pragma unroll 2
        for (int kb = 0; kb < nkb; ++kb) {
            // A = C (l by n): a0 (l = 16 i + gq, n = 8 kb + t), a1 (l + 8),
            // a2 (n + 4), a3 (l + 8, n + 4)
            const float* ca = (kb < 8 ? c0 : c1) + (16 * i + gq) * X_LD +
                              8 * (kb & 7) + t;
            uint32_t ah[4], al[4];
            tf32x3::split(ca[0], ah[0], al[0]);
            tf32x3::split(ca[8 * X_LD], ah[1], al[1]);
            tf32x3::split(ca[4], ah[2], al[2]);
            tf32x3::split(ca[8 * X_LD + 4], ah[3], al[3]);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                const int j = r + 4 * jj;
                if (j >= nt) break;
                // B = B^T (n by s): b0 (n = 8 kb + t, s = 8 j + gq), b1 (n + 4)
                const float* bb = bs + (8 * j + gq) * B_LD + 8 * kb + t;
                uint32_t bh0, bl0, bh1, bl1;
                tf32x3::split(bb[0], bh0, bl0);
                tf32x3::split(bb[4], bh1, bl1);
                tf32x3::mma3(acc[jj], ah, al, bh0, bh1, bl0, bl1);
            }
        }
        // c0 (gq, 2t), c1 (gq, 2t + 1), c2 (gq + 8, 2t), c3 (gq + 8, 2t + 1)
        // -> att @ X's a0 a1 a2 a3 with the depth order 0 2 4 6 | 1 3 5 7
        float4* out = reinterpret_cast<float4*>(tri) + i * (i + 1) * 32 + lane;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
            const int j = r + 4 * jj;
            if (j >= nt) break;
            out[j * 32] = make_float4(acc[jj][0], acc[jj][2], acc[jj][1],
                                      acc[jj][3]);
        }
    }
}

// y for head h: warp w < Y_WARPS takes l-tiles q = w / 2 and 7 - q and
// the half w % 2 of P.
__device__ __forceinline__ void head_y(const Params& p, const float* xs,
                                       const float* cs, const float* tri,
                                       long long bc, int h, int warp,
                                       int lane) {
    const int gq = lane >> 2, t = lane & 3;
    const int q = warp >> 1, pb = 32 * (warp & 1);
    const int L = p.L, P = p.P;
    if (pb >= P) return;
    const int lt = round_up(L, 16) / 16;
    const int kbs = (L + 7) / 8;
#pragma unroll 1
    for (int side = 0; side < 2; ++side) {
        const int i = side ? L_MAX / 16 - 1 - q : q;
        if (i >= lt) continue;
        const int l0 = 16 * i + gq, l1 = l0 + 8;
        const float cs0 = cs[l0], cs1 = cs[l1];
        float acc[4][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[jj][e] = 0.f;
        const int nkb = min(2 * i + 2, kbs);
        const float4* cb = reinterpret_cast<const float4*>(tri) +
                           i * (i + 1) * 32 + lane;
#pragma unroll 2
        for (int kb = 0; kb < nkb; ++kb) {
            // a0 (l0, s0), a1 (l1, s0), a2 (l0, s0 + 1), a3 (l1, s0 + 1):
            // C B^T times exp(cs[l] - cs[s]) where s <= l, else 0 (the mask
            // picks 0 before any product, so an exp that overflows above
            // the diagonal is dropped, never multiplied)
            const int s0 = 8 * kb + 2 * t;
            const float4 v = cb[kb * 32];
            const float2 css = *reinterpret_cast<const float2*>(cs + s0);
            const float a0 = s0 <= l0 ? v.x * __expf(cs0 - css.x) : 0.f;
            const float a1 = s0 <= l1 ? v.y * __expf(cs1 - css.x) : 0.f;
            const float a2 = s0 < l0 ? v.z * __expf(cs0 - css.y) : 0.f;
            const float a3 = s0 < l1 ? v.w * __expf(cs1 - css.y) : 0.f;
            uint32_t ah[4], al[4];
            tf32x3::split(a0, ah[0], al[0]);
            tf32x3::split(a1, ah[1], al[1]);
            tf32x3::split(a2, ah[2], al[2]);
            tf32x3::split(a3, ah[3], al[3]);
            // B = X (s by p): b0 (s0, p0 + gq), b1 (s0 + 1, p0 + gq)
            const float* xb = xs + s0 * X_LD + pb + gq;
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                if (pb + 8 * jj >= P) break;
                uint32_t bh0, bl0, bh1, bl1;
                tf32x3::split(xb[8 * jj], bh0, bl0);
                tf32x3::split(xb[8 * jj + X_LD], bh1, bl1);
                tf32x3::mma3(acc[jj], ah, al, bh0, bh1, bl0, bl1);
            }
        }
        // c0 (l0, p), c1 (l0, p + 1), c2 (l1, p), c3 (l1, p + 1), p =
        // p0 + 2t
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int l = half ? l1 : l0;
            if (l >= L) break;
            float* yr = p.y + ((bc * L + l) * p.H + h) * (long long)P;
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                const int pp = pb + 8 * jj + 2 * t;
                if (pp >= P) break;
                const float e0 = acc[jj][2 * half], e1 = acc[jj][2 * half + 1];
                if (P % 2 == 0) {
                    *reinterpret_cast<float2*>(yr + pp) = make_float2(e0, e1);
                } else {
                    yr[pp] = e0;
                    if (pp + 1 < P) yr[pp + 1] = e1;
                }
            }
        }
    }
}

// The state of head h: warp w >= Y_WARPS takes the half of P (w - 8) /
// (S_WARPS / 2) and S_NW columns of N; depth l in the order of head_y.
__device__ __forceinline__ void head_state(const Params& p, const float* xs,
                                           const float* cs, const float* bs,
                                           long long bc, int h, int warp,
                                           int lane) {
    const int gq = lane >> 2, t = lane & 3;
    const int w8 = warp - Y_WARPS;
    const int pb = 32 * (w8 / (S_WARPS / 2));
    const int nb = S_NW * (w8 % (S_WARPS / 2));
    const int L = p.L, P = p.P, N = p.N;
    if (pb >= P || nb >= N) return;
    const float cs_end = cs[L - 1];
    float acc[2][S_NT][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < S_NT; ++nj)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
    const int kbs = (L + 7) / 8;
#pragma unroll 2
    for (int kb = 0; kb < kbs; ++kb) {
        const int l0 = 8 * kb + 2 * t;
        const float2 css = *reinterpret_cast<const float2*>(cs + l0);
        // rows past L hold zeros in X; their weight is 0 as well, so an
        // exp of the zero-filled cs cannot overflow into them
        const float w0 = l0 < L ? __expf(cs_end - css.x) : 0.f;
        const float w1 = l0 + 1 < L ? __expf(cs_end - css.y) : 0.f;
        // A = (w X)^T (p by l): a0 (p0 + gq, l0), a1 (p0 + gq + 8, l0),
        // a2 (p0 + gq, l0 + 1), a3 (p0 + gq + 8, l0 + 1)
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
            const float* xa = xs + l0 * X_LD + pb + 16 * mi + gq;
            tf32x3::split(xa[0] * w0, ah[mi][0], al[mi][0]);
            tf32x3::split(xa[8] * w0, ah[mi][1], al[mi][1]);
            tf32x3::split(xa[X_LD] * w1, ah[mi][2], al[mi][2]);
            tf32x3::split(xa[X_LD + 8] * w1, ah[mi][3], al[mi][3]);
        }
        // B = B (l by n): b0 (l0, n0 + gq), b1 (l0 + 1, n0 + gq)
        const float* bb = bs + l0 * B_LD + nb + gq;
#pragma unroll
        for (int nj = 0; nj < S_NT; ++nj) {
            if (nb + 8 * nj >= N) break;
            uint32_t bh0, bl0, bh1, bl1;
            tf32x3::split(bb[8 * nj], bh0, bl0);
            tf32x3::split(bb[8 * nj + B_LD], bh1, bl1);
            tf32x3::mma3(acc[0][nj], ah[0], al[0], bh0, bh1, bl0, bl1);
            if (pb + 16 < P)
                tf32x3::mma3(acc[1][nj], ah[1], al[1], bh0, bh1, bl0, bl1);
        }
    }
    // c0 (p, n), c1 (p, n + 1), c2 (p + 8, n), c3 (p + 8, n + 1), p =
    // p0 + gq, n = n0 + 2t
    float* sp = p.st + (bc * p.H + h) * (long long)P * N;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int pp = pb + 16 * mi + 8 * half + gq;
            if (pp >= P) continue;
#pragma unroll
            for (int nj = 0; nj < S_NT; ++nj) {
                const int n = nb + 8 * nj + 2 * t;
                if (n >= N) break;
                const float e0 = acc[mi][nj][2 * half];
                const float e1 = acc[mi][nj][2 * half + 1];
                float* o = sp + (long long)pp * N + n;
                if (N % 2 == 0) {
                    *reinterpret_cast<float2*>(o) = make_float2(e0, e1);
                } else {
                    o[0] = e0;
                    if (n + 1 < N) o[1] = e1;
                }
            }
        }
}

__global__ void __launch_bounds__(THREADS, 1)
ssd_intra_chunk_kernel(const Params p) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    float* bs = smem;                        // B [L_MAX][B_LD]
    float* slots = bs + L_MAX * B_LD;        // SLOTS x (X, cs)
    float* tri = slots + SLOTS * SLOT;       // C B^T's causal tiles

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int per_chunk = p.G * p.tiles;
    const long long bc = blockIdx.x / per_chunk;
    const int g = (blockIdx.x % per_chunk) / p.tiles;
    const int tile = blockIdx.x % p.tiles;
    const int rep = p.H / p.G;
    const int h0 = g * rep + tile * p.ht;
    const int nh = min(p.ht, rep - tile * p.ht);
    const int L = p.L, N = p.N, Lr = round_up(L, 16), Nr = round_up(N, 8);

    // head j's X lies in slot (j + 2) % 3: slots 0 and 1 first hold C
    auto slot = [&](int j) { return slots + ((j + 2) % SLOTS) * SLOT; };

    // B and C of the group (C's column halves in slots 0 and 1), then the
    // first head's X; C B^T waits for the first group only
    const long long pitch = (long long)p.G * N;
    const float* bsrc = p.b + (bc * L * p.G + g) * (long long)N;
    const float* csrc = p.c + (bc * L * p.G + g) * (long long)N;
    stage_rows(bs, B_LD, bsrc, pitch, Lr, L, Nr, N, p.vec);
    stage_rows(slots, X_LD, csrc, pitch, Lr, L, min(Nr, 64), N, p.vec);
    if (Nr > 64)
        stage_rows(slots + SLOT, X_LD, csrc + 64, pitch, Lr, L, Nr - 64,
                   N - 64, p.vec);
    tf32x3::cp_async_commit();
    stage_head(p, slot(0), bc, h0);
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<1>();
    __syncthreads();
    if (warp < 16)   // 4 pairs of l-tiles x 4 residues of the s-tile
        form_cbt(p, bs, slots, slots + SLOT, tri, warp, lane);
    __syncthreads();   // tri is complete; C's slots are free
    if (nh > 1) stage_head(p, slot(1), bc, h0 + 1);
    tf32x3::cp_async_commit();

    for (int j = 0; j < nh; ++j) {
        tf32x3::cp_async_wait<1>();
        __syncthreads();   // head j has landed; head j - 1 is consumed
        if (j + 2 < nh) stage_head(p, slot(j + 2), bc, h0 + j + 2);
        tf32x3::cp_async_commit();
        const float* xs = slot(j);
        const float* cs = xs + L_MAX * X_LD;
        if (warp < Y_WARPS)
            head_y(p, xs, cs, tri, bc, h0 + j, warp, lane);
        else
            head_state(p, xs, cs, bs, bc, h0 + j, warp, lane);
    }
}

}  // namespace

// The compiled constants: L_MAX, P_MAX, N_MAX, THREADS, HEADS_PER_BLOCK
// and the dynamic shared memory of a block in bytes; returns how many it
// wrote.
extern "C" int ssd_constants(int* out) {
    const int v[] = {L_MAX, P_MAX, N_MAX, THREADS, HEADS_PER_BLOCK,
                     (int)SMEM_BYTES};
    for (int i = 0; i < 6; ++i) out[i] = v[i];
    return 6;
}

// x (BC, L, H, P), da_cs (BC, L, H), b_mat and c_mat (BC, L, G, N) ->
// y (BC, L, H, P), st (BC, H, P, N); all contiguous fp32.  Takes
// 1 <= L <= 128, P <= 64, N <= 128 and H % G == 0 (the wrapper checks).
// Returns cudaGetLastError() after the launch.
extern "C" int ssd_intra_chunk_launch(const float* x, const float* da_cs,
                                      const float* b_mat, const float* c_mat,
                                      float* y, float* st, long long BC, int L,
                                      int H, int P, int G, int N, void* stream) {
    if (L < 1 || L > L_MAX || P < 1 || P > P_MAX || N < 1 || N > N_MAX ||
        G < 1 || H % G != 0)
        return (int)cudaErrorInvalidValue;
    Params p;
    p.x = x;
    p.da_cs = da_cs;
    p.b = b_mat;
    p.c = c_mat;
    p.y = y;
    p.st = st;
    p.L = L;
    p.H = H;
    p.P = P;
    p.G = G;
    p.N = N;
    const int rep = H / G;
    p.ht = HEADS_PER_BLOCK < rep ? HEADS_PER_BLOCK : rep;
    p.tiles = (rep + p.ht - 1) / p.ht;
    p.vec = P % 4 == 0 && N % 4 == 0 && (uintptr_t)x % 16 == 0 &&
            (uintptr_t)b_mat % 16 == 0 && (uintptr_t)c_mat % 16 == 0;
    const long long blocks = BC * G * p.tiles;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    // above 48 KB of dynamic shared memory; set on every call (cheap), so
    // each device the kernel runs on has it
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_intra_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const cudaStream_t s = (cudaStream_t)stream;
    ssd_intra_chunk_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES, s>>>(p);
    return (int)cudaGetLastError();
}
