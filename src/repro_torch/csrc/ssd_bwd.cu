// Backward of the Mamba-2 SSD intra-chunk step (csrc/ssd.cu), for sm_90a.
//
// Replaces no TPU kernel: the Pallas SSD kernel (src/repro/kernels/ssd/
// ssd.py::ssd_intra_chunk) has no VJP, and the JAX package differentiates
// the plain chunked scan (src/repro/models/ssm.py::ssd_chunked).  The
// port's training runs the forward through csrc/ssd.cu, so its backward
// is a kernel too; its plain version is autograd of kernels/ssd/ref.py::
// ssd_intra_chunk_ref.  Per (chunk bc, head h of group g), with cs =
// da_cs[bc, :, h], decay[l, s] = exp(cs[l] - cs[s]) for s <= l and 0
// elsewhere, CB = C B^T, att = CB * decay and w[l] = exp(cs[L-1] - cs[l]),
// given dy (BC, L, H, P) and dst (BC, H, P, N):
//     dX       = att^T dy + w * (B dst^T)
//     datt     = dy X^T                       (on the causal taps s <= l)
//     dCB_g    = sum_{h in g} datt_h * decay_h
//     dC       = dCB_g B
//     dB       = dCB_g^T C + sum_{h in g} (w_h * X_h) dst_h
//     dcs[l]  += sum_s M[l, s] - sum_s M[s, l],  M = datt * CB * decay
//     dcs[L-1] += sum_l dw[l] w[l];  dcs[l] -= dw[l] w[l],
//                 dw[l] = sum_p X[l, p] (B dst^T)[l, p]
// The mask is applied before exp, as in the forward: above the diagonal
// (and past the chunk's end) cs[l] - cs[s] may be positive and overflow,
// so exp is taken only where s <= l < L and the masked taps are exactly
// 0, never inf * 0.  exp(cs[l] - cs[s]) is never factored into
// exp(cs[l]) exp(-cs[s]): those overflow where the reference stays finite.
//
// Bound on the H100: operations.  At [lm-train]'s shape (BC = 256, L =
// 128, H = 24, P = 64, G = 1, N = 128) the data needs 4.04e10 FLOPs
// (kernels/ssd/ops.py::bwd_work: per head att^T dy and dy X^T on the
// causal taps, B dst^T and (w X) dst whole, per group C B^T again and dCB
// B, dCB^T C on the causal taps) and moves 0.88 GB: 0.603 ms at the fp32
// CUDA-core rate, 0.262 ms in 3xTF32 on the tensor cores.
//
// Design: two launches on the caller's stream, every product on the
// tensor cores in 3xTF32 (tf32x3.cuh, mma.sync.m16n8k8), the operands
// split with split_rn (hi rounded to nearest: the gradient bar leaves
// little room where sums cancel, and the cut split rounded 3-4 times more
// in a numpy emulation of this walk).
//  1. heads: one block of 16 warps per (chunk, group, tile of heads).  It
//     stages the group's B (L x N, row pitch 132) and C (in two column
//     halves, in the X and dy slots) and forms C B^T's causal 16 x 8
//     tiles once, as (B C^T) tiles (s-tile i, l-block j >= 2 i: 72 of 128
//     at L = 128), each stored per lane in the mma accumulator's order:
//     with the depth order 0 2 4 6 | 1 3 5 7 over l that is att^T's A
//     fragment, and element for element the layout of datt^T = X dy^T.
//     Then it walks its heads in order, each in three parts over one slot
//     of X, dy and dst (X and dy at row pitch 68, dst at 132: 102 KB):
//     (a) Z += (w X) dst, the state part of dB, accumulated over the tile's
//         heads in registers (32 a thread); dy is copied meanwhile;
//     (b) dX = (w B) dst^T, then tw = w dw from it and X, then + att^T dy
//         over the causal l-blocks only, the decay applied (masked) as the
//         A fragments are built; dX is written once;
//     (c) datt^T on the causal tiles only, dCB_h = datt^T * decay, M and
//         its row and column sums (double) by tile, and dCB_h added to the
//         tile's dCB in double, in registers (4-5 tiles a warp); the next
//         head's dst is copied meanwhile.  Then the next head's X and cs
//         are copied while warp 0 forms dcs from the tiles' sums and tw.
//     The block writes its dCB (rounded to float once) and Z once, as
//     partials, to a scratch of ssd_bwd_scratch floats.
//  2. group: per (chunk, group), the head tiles' partials summed in tile
//     order in double, then dC = dCB B and dB = Z + dCB^T C on the causal
//     tiles only, from one row-major dCB (pitch 132: conflict-free for
//     both A fragments).
// No (BC, H, L, L) tensor exists.  Shared memory: 226,304 bytes for a
// heads block (B 67.6 KB, C B^T 36.9 KB, the slot 102 KB, the sums 19
// KB): C is staged only while C B^T is formed, and one slot, not two: X
// and cs are copied exposed at the head's start (dy behind part (a), dst
// behind part (c)), as two slots would not fit beside B and C B^T.
// Registers: 16 warps of at most 128 a thread; Z (32) and dCB in double
// (40) stay a whole tile of heads, which pins the warps at 16.  Determinism: every output is written once by
// one lane, the partials and the sums of M are added in a fixed order,
// and nothing uses atomics: a second call is bitwise the same.  The sums
// that cancel (dcs's rows against its columns, dCB over up to 80 heads of
// either sign, the head tiles' partials) are taken in double; the product
// tiles accumulate in fp32 as 3xTF32 does.
//
// Measured on one H100 80GB HBM3 at 700 W (tools/ssd_variants.py --bwd,
// chip_smoke.py's [lm-train] (b); PERF.md): 1.74-1.90 ms at [lm-train]'s
// shape (2.9-3.2x the fp32 bound, 6.7-7.3x the 3xTF32 one; the first,
// fp32 four-launch design took 5.43 ms), 3.68 ms at the prefill shape
// (x 512 x 128 x 24 x 64), 5.11-5.25 ms at zamba2-2.7b's 80 heads (N 64;
// 16.0 ms before).  Launch 2 is 0.09 ms of it.  Left out one at a time,
// dX's products take 0.76 ms, datt^T's 0.37, Z's 0.28: the per-head
// products are held by the CUDA-core work around each mma (the splits,
// the per-k-block add; 128 registers a thread, and ptxas spills 44 bytes
// in one of the two kernels), not by the tensor cores.  Heads per block: 24 took 1.76 ms at the train shape, 12
// 1.79, 8 1.82, 16 2.05 (a ragged tile of 8); at 80 heads 16 took 4.91
// ms against 5.11 for 24, which stays: it is the train shape's best.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int L_MAX = 128;    // chunk length; L_MAX in kernels/ssd/ops.py
constexpr int P_MAX = 64;     // head dim
constexpr int N_MAX = 128;    // state dim
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int HEADS_PER_BLOCK = 24;  // heads a block of launch 1 takes
constexpr int LT = L_MAX / 16;       // tiles of 16 rows: 8
constexpr int LB = L_MAX / 8;        // blocks of 8: 16
constexpr int TRI = LT * (LT + 1);   // causal 16 x 8 tiles (j >= 2 i): 72
constexpr int NT = N_MAX / 8;        // n-tiles: 16
constexpr int B_LD = N_MAX + 4;      // 132 = 4 (mod 32): B, dst
constexpr int X_LD = P_MAX + 4;      // 68: X, dy, C's column halves
// launch 1's shared memory, in floats (the sums of M in double)
constexpr int OFF_X = L_MAX * B_LD;                  // after B
constexpr int OFF_DY = OFF_X + L_MAX * X_LD;
constexpr int OFF_Q = OFF_DY + L_MAX * X_LD;         // dst [P_MAX][B_LD]
constexpr int OFF_CBT = OFF_Q + P_MAX * B_LD;        // C B^T's tiles
constexpr int OFF_CS = OFF_CBT + TRI * 128;
constexpr int OFF_TW = OFF_CS + L_MAX;               // double [4][L_MAX]
constexpr int OFF_ROW = OFF_TW + 2 * 4 * L_MAX;      // double [TRI][16]
constexpr int OFF_COL = OFF_ROW + 2 * TRI * 16;      // double [TRI][8]
constexpr int HEADS_SMEM = OFF_COL + 2 * TRI * 8;
// one block's partials: dCB's tiles, then Z's (l-tile, n-tile) tiles
constexpr int PART_DCB = TRI * 128;
constexpr int PART = PART_DCB + LT * NT * 128;
// launch 2's shared memory: dCB [l][s], B, C
constexpr int D_LD = L_MAX + 4;      // 132
constexpr int B2_LD = N_MAX + 8;     // 136 = 8 (mod 32)
constexpr int GROUP_SMEM = L_MAX * D_LD + L_MAX * B2_LD + L_MAX * B_LD;

static_assert(THREADS == 512 && L_MAX == 128 && P_MAX == 64 && N_MAX == 128,
              "the warp assignments below take 16 warps and these sizes");
static_assert(4 * WARPS + WARPS / 2 == TRI, "4 or 5 causal tiles a warp");
static_assert(HEADS_PER_BLOCK >= 1, "at least one head a block");
static_assert(sizeof(float) * HEADS_SMEM <= 232448 &&
              sizeof(float) * GROUP_SMEM <= 232448, "one block an SM");
static_assert(OFF_TW % 2 == 0 && OFF_ROW % 2 == 0 && OFF_COL % 2 == 0,
              "the double arrays are 8-byte aligned");
static_assert(L_MAX * X_LD >= L_MAX * 64, "C's halves fit the X and dy slots");

struct Params {
    const float* x;
    const float* da_cs;
    const float* b;
    const float* c;
    const float* dy;
    const float* dst;
    float* dx;
    float* dda;
    float* db;
    float* dc;
    float* part;   // scratch: PART floats per (chunk, group, head tile)
    int L, H, P, G, N;
    int ht;        // heads per block
    int tiles;     // head tiles per group
    int vec;       // 16-byte copies (P % 4 == N % 4 == 0, aligned inputs)
};

__host__ __device__ constexpr int round_up(int v, int m) {
    return (v + m - 1) / m * m;
}

// Causal tile k (0 <= k < TRI) in (s-tile i, l-block j) order: i = 0 has
// j = 0 .. 15, i = 1 has j = 2 .. 15, ...
__device__ __forceinline__ int tri_index(int i, int j) {
    return i * (LB + 1 - i) + j - 2 * i;
}
__device__ __forceinline__ void tri_tile(int k, int& i, int& j) {
    i = 0;
    while (k >= LB - 2 * i) {
        k -= LB - 2 * i;
        ++i;
    }
    j = 2 * i + k;
}

// the A fragment (a0 a1 a2 a3) as the mma reads it, hi and lo
__device__ __forceinline__ void split4(float a0, float a1, float a2, float a3,
                                       uint32_t (&h)[4], uint32_t (&l)[4]) {
    tf32x3::split_rn(a0, h[0], l[0]);
    tf32x3::split_rn(a1, h[1], l[1]);
    tf32x3::split_rn(a2, h[2], l[2]);
    tf32x3::split_rn(a3, h[3], l[3]);
}

// c += a * (b0, b1), b split here.  The three mma of one k-block go into
// a zeroed tile, added to c with one fp32 add a value: the tensor cores'
// adder rounds toward zero, and a cut at every mma into a large
// accumulator biases a long sum (7.8e-4 past rtol at [lm-train]'s shape,
// 1.3e-3 at 80 heads, on the H100, where fp32 adds round to nearest).
__device__ __forceinline__ void mma_rn(float (&c)[4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], float b0,
                                       float b1) {
    uint32_t bh0, bl0, bh1, bl1;
    tf32x3::split_rn(b0, bh0, bl0);
    tf32x3::split_rn(b1, bh1, bl1);
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    tf32x3::mma3(d, ah, al, bh0, bh1, bl0, bl1);
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] += d[e];
}

// the sum over the lanes whose index differs only in the bits lo .. hi
// (powers of two), in a fixed butterfly
__device__ __forceinline__ double lane_sum(double v, int lo, int hi) {
    for (int off = lo; off <= hi; off <<= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
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
        for (int e = threadIdx.x; e < rows * q; e += blockDim.x) {
            const int r = e / q, j = 4 * (e % q);
            const bool ok = r < rows_ok && j < cols_ok;
            tf32x3::cp_async16(dst + r * ld + j, ok ? src + r * pitch + j : src,
                               ok);
        }
    } else {
        for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
            const int r = e / cols, j = e % cols;
            const bool ok = r < rows_ok && j < cols_ok;
            tf32x3::cp_async4(dst + r * ld + j, ok ? src + r * pitch + j : src,
                              ok);
        }
    }
}

// head h's X (or dy: `src` p.x or p.dy) of chunk bc into a slot
__device__ __forceinline__ void stage_lp(const Params& p, float* slot,
                                         const float* src, long long bc,
                                         int h) {
    stage_rows(slot, X_LD, src + (bc * p.L * p.H + h) * (long long)p.P,
               (long long)p.H * p.P, round_up(p.L, 16), p.L,
               round_up(p.P, 8), p.P, p.vec);
}

__device__ __forceinline__ void stage_cs(const Params& p, float* cs,
                                         long long bc, int h) {
    const int L = p.L;
    for (int l = threadIdx.x; l < round_up(L, 16); l += blockDim.x) {
        const bool ok = l < L;
        tf32x3::cp_async4(cs + l, p.da_cs + (ok ? (bc * L + l) * p.H + h : 0),
                          ok);
    }
}

__device__ __forceinline__ void stage_dst(const Params& p, float* qs,
                                          long long bc, int h) {
    stage_rows(qs, B_LD, p.dst + (bc * p.H + h) * (long long)p.P * p.N, p.N,
               round_up(p.P, 8), p.P, round_up(p.N, 8), p.N, p.vec);
}

// The causal tiles of C B^T as (B C^T) tiles into cbt: warp w takes
// tiles 4 w .. 4 w + 3 and, for w < 8, tile 64 + w.  c0 / c1 hold C's
// column halves.
__device__ __forceinline__ void form_cbt(const Params& p, const float* bs,
                                         const float* c0, const float* c1,
                                         float* cbt, int warp, int lane) {
    const int gq = lane >> 2, t = lane & 3;
    const int nkb = (p.N + 7) / 8;
#pragma unroll 1
    for (int kk = 0; kk < 5; ++kk) {
        const int k = kk < 4 ? 4 * warp + kk : (warp < WARPS / 2 ? 64 + warp
                                                               : -1);
        if (k < 0) break;
        int i, j;
        tri_tile(k, i, j);
        if (8 * j >= p.L) continue;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
        for (int kb = 0; kb < nkb; ++kb) {
            // A = B (s by n): a0 (s = 16 i + gq, n = 8 kb + t), a1 (s + 8),
            // a2 (n + 4), a3 (s + 8, n + 4)
            const float* ba = bs + (16 * i + gq) * B_LD + 8 * kb + t;
            uint32_t ah[4], al[4];
            split4(ba[0], ba[8 * B_LD], ba[4], ba[8 * B_LD + 4], ah, al);
            // B = C^T (n by l): b0 (n = 8 kb + t, l = 8 j + gq), b1 (n + 4)
            const float* cb = (kb < 8 ? c0 : c1) + (8 * j + gq) * X_LD +
                              8 * (kb & 7) + t;
            mma_rn(acc, ah, al, cb[0], cb[4]);
        }
        reinterpret_cast<float4*>(cbt)[k * 32 + lane] =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
}

// (a) Z += (w X) dst: warp w takes l-tile w / 2 and the n-tiles 8 (w % 2)
// .. + 7; depth p in the order 0 2 4 6 | 1 3 5 7, so that dst's rows 2t
// and 2t + 1 fall on distinct banks.
__device__ __forceinline__ void head_z(const Params& p, const float* xs,
                                       const float* qs, const float* cs,
                                       float (&z)[8][4], int warp, int lane) {
    const int gq = lane >> 2, t = lane & 3;
    const int zl = warp >> 1, n0 = 64 * (warp & 1);
    const int L = p.L, N = p.N;
    if (16 * zl >= L || n0 >= N) return;
    const float cs_end = cs[L - 1];
    const int l0 = 16 * zl + gq, l1 = l0 + 8;
    // rows past L hold zeros in X; their weight is 0 as well
    const float w0 = l0 < L ? __expf(cs_end - cs[l0]) : 0.f;
    const float w1 = l1 < L ? __expf(cs_end - cs[l1]) : 0.f;
    const int nkb = (p.P + 7) / 8;
#pragma unroll 1
    for (int kb = 0; kb < nkb; ++kb) {
        // A = (w X) (l by p): a0 (l0, p = 8 kb + 2t), a1 (l1, p), a2 (l0,
        // p + 1), a3 (l1, p + 1)
        const float2 x0 = *reinterpret_cast<const float2*>(
            xs + l0 * X_LD + 8 * kb + 2 * t);
        const float2 x1 = *reinterpret_cast<const float2*>(
            xs + l1 * X_LD + 8 * kb + 2 * t);
        uint32_t ah[4], al[4];
        split4(w0 * x0.x, w1 * x1.x, w0 * x0.y, w1 * x1.y, ah, al);
        // B = dst (p by n): b0 (p = 8 kb + 2t, n), b1 (p + 1, n)
        const float* qb = qs + (8 * kb + 2 * t) * B_LD + n0 + gq;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            if (n0 + 8 * nt >= N) break;
            mma_rn(z[nt], ah, al, qb[8 * nt], qb[8 * nt + B_LD]);
        }
    }
}

// (b) dX of head h: warp w takes s-tiles q = w / 4 and 7 - q and the
// p-tiles 2 (w % 4) and 2 (w % 4) + 1; its partial of tw (over its 16 p)
// goes to twp[w % 4].
__device__ __forceinline__ void head_dx(const Params& p, const float* bs,
                                        const float* xs, const float* dys,
                                        const float* qs, const float* cs,
                                        const float* cbt, double* twp,
                                        long long bc, int h, int warp,
                                        int lane) {
    const int gq = lane >> 2, t = lane & 3;
    const int q = warp >> 2, ph = warp & 3, p0 = 16 * ph;
    const int L = p.L, P = p.P, N = p.N;
    const float cs_end = cs[L - 1];
    const int nkb = (N + 7) / 8, lkb = (L + 7) / 8;
#pragma unroll 1
    for (int side = 0; side < 2; ++side) {
        const int i = side ? LT - 1 - q : q;
        if (16 * i >= L) continue;
        const int s0 = 16 * i + gq, s1 = s0 + 8;
        const float w0 = s0 < L ? __expf(cs_end - cs[s0]) : 0.f;
        const float w1 = s1 < L ? __expf(cs_end - cs[s1]) : 0.f;
        float acc[2][4];
#pragma unroll
        for (int pt = 0; pt < 2; ++pt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[pt][e] = 0.f;
        if (p0 < P) {
            // (w B) dst^T over n: A = w B (s by n), B = dst^T (n by p):
            // b0 (n = 8 kb + t, p = pp + gq), b1 (n + 4)
#pragma unroll 2
            for (int kb = 0; kb < nkb; ++kb) {
                const float* ba = bs + s0 * B_LD + 8 * kb + t;
                uint32_t ah[4], al[4];
                split4(w0 * ba[0], w1 * ba[8 * B_LD], w0 * ba[4],
                       w1 * ba[8 * B_LD + 4], ah, al);
#pragma unroll
                for (int pt = 0; pt < 2; ++pt) {
                    const int pp = p0 + 8 * pt;
                    if (pp >= P) break;
                    const float* qb = qs + (pp + gq) * B_LD + 8 * kb + t;
                    mma_rn(acc[pt], ah, al, qb[0], qb[4]);
                }
            }
        }
        // tw[s] = w[s] dw[s] = sum_p X[s, p] (w B dst^T)[s, p]: the warp's
        // 16 columns; c0 (s0, p), c1 (s0, p + 1), c2 (s1, p), c3 (s1,
        // p + 1), p = pp + 2t (X is zero past P)
        double r0 = 0.0, r1 = 0.0;
#pragma unroll
        for (int pt = 0; pt < 2; ++pt) {
            if (p0 + 8 * pt >= P) break;   // past round_up(P, 8): not staged
            const int pp = p0 + 8 * pt + 2 * t;
            r0 += (double)xs[s0 * X_LD + pp] * acc[pt][0] +
                  (double)xs[s0 * X_LD + pp + 1] * acc[pt][1];
            r1 += (double)xs[s1 * X_LD + pp] * acc[pt][2] +
                  (double)xs[s1 * X_LD + pp + 1] * acc[pt][3];
        }
        r0 = lane_sum(r0, 1, 2);
        r1 = lane_sum(r1, 1, 2);
        if (t == 0) {
            twp[ph * L_MAX + s0] = r0;
            twp[ph * L_MAX + s1] = r1;
        }
        if (p0 >= P) continue;
        // + att^T dy over the l-blocks kb >= 2 i: A = att^T (s by l) from
        // the stored (B C^T) tile, depth l in the order 0 2 4 6 | 1 3 5 7;
        // B = dy (l by p): b0 (l = 8 kb + 2t, p = pp + gq), b1 (l + 1)
        const float cs0 = cs[s0], cs1 = cs[s1];
        const float4* cb = reinterpret_cast<const float4*>(cbt) +
                           tri_index(i, 2 * i) * 32 + lane;
#pragma unroll 2
        for (int kb = 2 * i; kb < lkb; ++kb) {
            const int l = 8 * kb + 2 * t;
            const float4 v = cb[(kb - 2 * i) * 32];
            const float2 csl = *reinterpret_cast<const float2*>(cs + l);
            // the mask first: exp only where s <= l < L
            const float a0 = s0 <= l && l < L ? v.x * __expf(csl.x - cs0) : 0.f;
            const float a1 = s1 <= l && l < L ? v.z * __expf(csl.x - cs1) : 0.f;
            const float a2 =
                s0 <= l + 1 && l + 1 < L ? v.y * __expf(csl.y - cs0) : 0.f;
            const float a3 =
                s1 <= l + 1 && l + 1 < L ? v.w * __expf(csl.y - cs1) : 0.f;
            uint32_t ah[4], al[4];
            split4(a0, a1, a2, a3, ah, al);
            const float* db_ = dys + l * X_LD + gq;
#pragma unroll
            for (int pt = 0; pt < 2; ++pt) {
                const int pp = p0 + 8 * pt;
                if (pp >= P) break;
                mma_rn(acc[pt], ah, al, db_[pp], db_[pp + X_LD]);
            }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int s = half ? s1 : s0;
            if (s >= L) break;
            float* dxr = p.dx + ((bc * L + s) * p.H + h) * (long long)P;
#pragma unroll
            for (int pt = 0; pt < 2; ++pt) {
                const int pp = p0 + 8 * pt + 2 * t;
                if (pp >= P) break;
                const float e0 = acc[pt][2 * half], e1 = acc[pt][2 * half + 1];
                if (P % 2 == 0) {
                    *reinterpret_cast<float2*>(dxr + pp) = make_float2(e0, e1);
                } else {
                    dxr[pp] = e0;
                    if (pp + 1 < P) dxr[pp + 1] = e1;
                }
            }
        }
    }
}

// (c) datt^T = X dy^T on warp w's causal tiles (those of form_cbt), dCB_h
// = datt^T * decay into dcb (double), the row and column sums of M^T =
// dCB_h * (B C^T) by tile into rowp / colp.
__device__ __forceinline__ void head_datt(const Params& p, const float* xs,
                                          const float* dys, const float* cs,
                                          const float* cbt, double* rowp,
                                          double* colp, double (&dcb)[5][4],
                                          int warp, int lane) {
    const int gq = lane >> 2, t = lane & 3;
    const int L = p.L, nkb = (p.P + 7) / 8;
#pragma unroll
    for (int kk = 0; kk < 5; ++kk) {
        const int k = kk < 4 ? 4 * warp + kk : (warp < WARPS / 2 ? 64 + warp
                                                               : -1);
        if (k < 0) break;
        int i, j;
        tri_tile(k, i, j);
        if (8 * j >= L) continue;
        const int s0 = 16 * i + gq, s1 = s0 + 8, l = 8 * j + 2 * t;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
        for (int kb = 0; kb < nkb; ++kb) {
            // A = X (s by p): a0 (s0, p = 8 kb + t), a1 (s1, p), a2 (s0,
            // p + 4), a3 (s1, p + 4); B = dy^T (p by l): b0 (p, l = 8 j +
            // gq), b1 (p + 4, l)
            const float* xa = xs + s0 * X_LD + 8 * kb + t;
            uint32_t ah[4], al[4];
            split4(xa[0], xa[8 * X_LD], xa[4], xa[8 * X_LD + 4], ah, al);
            const float* yb = dys + (8 * j + gq) * X_LD + 8 * kb + t;
            mma_rn(acc, ah, al, yb[0], yb[4]);
        }
        // c0 (s0, l), c1 (s0, l + 1), c2 (s1, l), c3 (s1, l + 1)
        const float4 v = reinterpret_cast<const float4*>(cbt)[k * 32 + lane];
        const float cb[4] = {v.x, v.y, v.z, v.w};
        const float2 csl = *reinterpret_cast<const float2*>(cs + l);
        const float css[2] = {cs[s0], cs[s1]};
        double m[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int s = e < 2 ? s0 : s1, le = l + (e & 1);
            const float cl = e & 1 ? csl.y : csl.x;
            // the mask first: exp only where s <= l < L
            const float d = s <= le && le < L
                                ? acc[e] * __expf(cl - css[e >> 1]) : 0.f;
            dcb[kk][e] += (double)d;
            m[e] = (double)d * cb[e];
        }
        // rows s0, s1 over the tile's 8 columns (the lanes of one gq);
        // columns l, l + 1 over its 16 rows (the lanes of one t)
        const double r0 = lane_sum(m[0] + m[1], 1, 2);
        const double r1 = lane_sum(m[2] + m[3], 1, 2);
        const double c0 = lane_sum(m[0] + m[2], 4, 16);
        const double c1 = lane_sum(m[1] + m[3], 4, 16);
        if (t == 0) {
            rowp[k * 16 + gq] = r0;
            rowp[k * 16 + gq + 8] = r1;
        }
        if (gq == 0) {
            colp[k * 8 + 2 * t] = c0;
            colp[k * 8 + 2 * t + 1] = c1;
        }
    }
}

// dcs of head h, by warp 0: the column sums of M^T minus its row sums
// (rows of M minus its columns), minus tw, plus sum(tw) at L - 1; every
// sum in a fixed order, in double.
__device__ __forceinline__ void head_dcs(const Params& p, const double* twp,
                                         const double* rowp,
                                         const double* colp, long long bc,
                                         int h, int lane) {
    const int L = p.L, jmax = (L + 7) / 8;
    double tw[L_MAX / 32], tot = 0.0;
#pragma unroll
    for (int r = 0; r < L_MAX / 32; ++r) {
        const int x = lane + 32 * r;
        double v = 0.0;
        if (x < L)
            for (int ph = 0; ph < 4; ++ph) v += twp[ph * L_MAX + x];
        tw[r] = v;
        tot += v;
    }
    tot = lane_sum(tot, 1, 16);
#pragma unroll
    for (int r = 0; r < L_MAX / 32; ++r) {
        const int x = lane + 32 * r;
        if (x >= L) break;
        const int jx = x >> 3, ix = x >> 4;
        double col = 0.0, row = 0.0;
        for (int i = 0; i <= jx / 2; ++i)
            col += colp[tri_index(i, jx) * 8 + (x & 7)];
        for (int j = 2 * ix; j < jmax; ++j)
            row += rowp[tri_index(ix, j) * 16 + (x & 15)];
        const double d = col - row - tw[r] + (x == L - 1 ? tot : 0.0);
        p.dda[(bc * L + x) * p.H + h] = (float)d;
    }
}

__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_heads(const Params p) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    float* bs = smem;                       // B [L_MAX][B_LD]
    float* xs = smem + OFF_X;               // X [L_MAX][X_LD]
    float* dys = smem + OFF_DY;             // dy [L_MAX][X_LD]
    float* qs = smem + OFF_Q;               // dst [P_MAX][B_LD]
    float* cbt = smem + OFF_CBT;            // (B C^T)'s causal tiles
    float* cs = smem + OFF_CS;              // cs [L_MAX]
    double* twp = reinterpret_cast<double*>(smem + OFF_TW);
    double* rowp = reinterpret_cast<double*>(smem + OFF_ROW);
    double* colp = reinterpret_cast<double*>(smem + OFF_COL);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int per_chunk = p.G * p.tiles;
    const long long bc = blockIdx.x / per_chunk;
    const int g = (blockIdx.x % per_chunk) / p.tiles;
    const int tile = blockIdx.x % p.tiles;
    const int rep = p.H / p.G;
    const int h0 = g * rep + tile * p.ht;
    const int nh = min(p.ht, rep - tile * p.ht);
    const int L = p.L, N = p.N, Lr = round_up(L, 16), Nr = round_up(N, 8);

    // B and C of the group (C's column halves in the X and dy slots) and
    // the first head's dst; C B^T; then the first head's X and cs
    const long long pitch = (long long)p.G * N;
    const float* bsrc = p.b + (bc * L * p.G + g) * (long long)N;
    const float* csrc = p.c + (bc * L * p.G + g) * (long long)N;
    stage_rows(bs, B_LD, bsrc, pitch, Lr, L, Nr, N, p.vec);
    stage_rows(xs, X_LD, csrc, pitch, Lr, L, min(Nr, 64), N, p.vec);
    if (Nr > 64)
        stage_rows(dys, X_LD, csrc + 64, pitch, Lr, L, Nr - 64, N - 64,
                   p.vec);
    stage_dst(p, qs, bc, h0);
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<0>();
    __syncthreads();
    form_cbt(p, bs, xs, dys, cbt, warp, lane);
    __syncthreads();   // C's slots are free
    stage_lp(p, xs, p.x, bc, h0);
    stage_cs(p, cs, bc, h0);
    tf32x3::cp_async_commit();

    float z[8][4];
    double dcb[5][4];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) z[a][e] = 0.f;
#pragma unroll
    for (int a = 0; a < 5; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) dcb[a][e] = 0.0;

    for (int jh = 0; jh < nh; ++jh) {
        const int h = h0 + jh;
        tf32x3::cp_async_wait<0>();
        __syncthreads();   // X, cs and dst of h have landed; h - 1 is done
        stage_lp(p, dys, p.dy, bc, h);
        tf32x3::cp_async_commit();
        head_z(p, xs, qs, cs, z, warp, lane);
        tf32x3::cp_async_wait<0>();
        __syncthreads();   // dy has landed
        head_dx(p, bs, xs, dys, qs, cs, cbt, twp, bc, h, warp, lane);
        __syncthreads();   // dst is consumed
        if (jh + 1 < nh) stage_dst(p, qs, bc, h + 1);
        tf32x3::cp_async_commit();
        head_datt(p, xs, dys, cs, cbt, rowp, colp, dcb, warp, lane);
        __syncthreads();   // X, dy, cs consumed; the sums are complete
        if (jh + 1 < nh) {
            stage_lp(p, xs, p.x, bc, h + 1);
            stage_cs(p, cs, bc, h + 1);
        }
        tf32x3::cp_async_commit();
        if (warp == 0) head_dcs(p, twp, rowp, colp, bc, h, lane);
    }

    // the partials: dCB's tiles (every tile, zeros past the chunk), then
    // Z's, each a float4 a lane in the accumulator's order
    float4* part = reinterpret_cast<float4*>(p.part +
                                             (long long)blockIdx.x * PART);
#pragma unroll
    for (int kk = 0; kk < 5; ++kk) {
        const int k = kk < 4 ? 4 * warp + kk : (warp < WARPS / 2 ? 64 + warp
                                                               : -1);
        if (k < 0) break;
        part[k * 32 + lane] = make_float4((float)dcb[kk][0], (float)dcb[kk][1],
                                          (float)dcb[kk][2], (float)dcb[kk][3]);
    }
    const int zl = warp >> 1, nt0 = 8 * (warp & 1);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
        part[PART_DCB / 4 + (zl * NT + nt0 + nt) * 32 + lane] =
            make_float4(z[nt][0], z[nt][1], z[nt][2], z[nt][3]);
}

// 2. Per (chunk, group): dCB and Z summed over the head tiles, then dC =
// dCB B and dB = Z + dCB^T C.  Warp w takes the row tiles q = w / 4 and
// 7 - q of both and the n-tiles 4 (w % 4) .. + 3.
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_group(const Params p) {
    extern __shared__ float4 smem4[];
    float* ds = reinterpret_cast<float*>(smem4);    // dCB [L_MAX][D_LD]
    float* bs = ds + L_MAX * D_LD;                   // B [L_MAX][B2_LD]
    float* cs2 = bs + L_MAX * B2_LD;                 // C [L_MAX][B_LD]
    const long long bc = blockIdx.x / p.G;
    const int g = blockIdx.x % p.G;
    const int L = p.L, N = p.N, Lr = round_up(L, 16), Nr = round_up(N, 8);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gq = lane >> 2, t = lane & 3;
    const long long pitch = (long long)p.G * N;
    const long long off = (bc * L * p.G + g) * (long long)N;
    stage_rows(bs, B2_LD, p.b + off, pitch, Lr, L, Nr, N, p.vec);
    stage_rows(cs2, B_LD, p.c + off, pitch, Lr, L, Nr, N, p.vec);
    tf32x3::cp_async_commit();
    const float* part = p.part + (long long)blockIdx.x * p.tiles * PART;
    // dCB: the tiles' partials in tile order, then into [l][s]
    for (int e = threadIdx.x; e < PART_DCB; e += THREADS) {
        double v = 0.0;
        for (int k = 0; k < p.tiles; ++k) v += part[(long long)k * PART + e];
        int i, j;
        tri_tile(e >> 7, i, j);
        const int ln = (e >> 2) & 31, c = e & 3;
        const int s = 16 * i + (ln >> 2) + 8 * (c >> 1);
        const int l = 8 * j + 2 * (ln & 3) + (c & 1);
        ds[l * D_LD + s] = (float)v;
    }
    tf32x3::cp_async_wait<0>();
    __syncthreads();
    const int q = warp >> 2, nb = 32 * (warp & 3);
    const int lkb = (L + 7) / 8;
#pragma unroll 1
    for (int side = 0; side < 2; ++side) {
        const int i = side ? LT - 1 - q : q;
        if (16 * i >= L || nb >= N) continue;
        const int r0 = 16 * i + gq, r1 = r0 + 8;
        // dC (l by n) = dCB (l by s) B (s by n) over s-blocks kb <= 2 i + 1
        float acc[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
        const int kend = min(2 * i + 2, lkb);
#pragma unroll 2
        for (int kb = 0; kb < kend; ++kb) {
            // a0 (l = r0, s = 8 kb + t), a1 (r1, s), a2 (r0, s + 4), a3
            const float* da = ds + r0 * D_LD + 8 * kb + t;
            uint32_t ah[4], al[4];
            split4(da[0], da[8 * D_LD], da[4], da[8 * D_LD + 4], ah, al);
            // b0 (s = 8 kb + t, n = nb + 8 nt + gq), b1 (s + 4)
            const float* bb = bs + (8 * kb + t) * B2_LD + nb + gq;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                if (nb + 8 * nt >= N) break;
                mma_rn(acc[nt], ah, al, bb[8 * nt], bb[8 * nt + 4 * B2_LD]);
            }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int l = half ? r1 : r0;
            if (l >= L) break;
            float* o = p.dc + ((bc * L + l) * p.G + g) * (long long)N;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                const int n = nb + 8 * nt + 2 * t;
                if (n >= N) break;
                o[n] = acc[nt][2 * half];
                if (n + 1 < N) o[n + 1] = acc[nt][2 * half + 1];
            }
        }
        // dB (s by n) = Z + dCB^T (s by l) C (l by n) over l-blocks kb >=
        // 2 i; Z's partials in tile order
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
            const int zt = i * NT + nb / 8 + nt;
            double v[4] = {0.0, 0.0, 0.0, 0.0};
            for (int k = 0; k < p.tiles; ++k) {
                const float4 zv = reinterpret_cast<const float4*>(
                    part + (long long)k * PART + PART_DCB)[zt * 32 + lane];
                v[0] += zv.x;
                v[1] += zv.y;
                v[2] += zv.z;
                v[3] += zv.w;
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nt][e] = (float)v[e];
        }
#pragma unroll 2
        for (int kb = 2 * i; kb < lkb; ++kb) {
            // depth l in the order 0 2 4 6 | 1 3 5 7: a0 (s = r0, l = 8 kb
            // + 2t), a1 (r1, l), a2 (r0, l + 1), a3 (r1, l + 1)
            const float* da = ds + (8 * kb + 2 * t) * D_LD + r0;
            uint32_t ah[4], al[4];
            split4(da[0], da[8], da[D_LD], da[D_LD + 8], ah, al);
            // b0 (l = 8 kb + 2t, n), b1 (l + 1, n)
            const float* cb = cs2 + (8 * kb + 2 * t) * B_LD + nb + gq;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                if (nb + 8 * nt >= N) break;
                mma_rn(acc[nt], ah, al, cb[8 * nt], cb[8 * nt + B_LD]);
            }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int s = half ? r1 : r0;
            if (s >= L) break;
            float* o = p.db + ((bc * L + s) * p.G + g) * (long long)N;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                const int n = nb + 8 * nt + 2 * t;
                if (n >= N) break;
                o[n] = acc[nt][2 * half];
                if (n + 1 < N) o[n + 1] = acc[nt][2 * half + 1];
            }
        }
    }
}

__host__ int heads_per_block(int rep) {
    return HEADS_PER_BLOCK < rep ? HEADS_PER_BLOCK : rep;
}

}  // namespace

// The compiled constants: L_MAX, P_MAX, N_MAX; returns how many it wrote.
extern "C" int ssd_bwd_constants(int* out) {
    const int v[] = {L_MAX, P_MAX, N_MAX};
    for (int i = 0; i < 3; ++i) out[i] = v[i];
    return 3;
}

// The scratch one call takes, in floats: a partial of dCB and Z per
// (chunk, group, head tile).
extern "C" long long ssd_bwd_scratch(long long BC, int H, int G) {
    if (BC < 1 || G < 1 || H < G) return 0;
    const int rep = H / G, ht = heads_per_block(rep);
    return BC * G * ((rep + ht - 1) / ht) * (long long)PART;
}

// x, dy (BC, L, H, P), da_cs (BC, L, H), b_mat, c_mat (BC, L, G, N), dst
// (BC, H, P, N) -> dx (BC, L, H, P), dda (BC, L, H), db, dc (BC, L, G,
// N); scratch `part` of ssd_bwd_scratch(...) floats.  All contiguous fp32.
// Takes 1 <= L <= 128, P <= 64, N <= 128 and H % G == 0 (the wrapper
// checks).  Two launches; returns cudaGetLastError() after them.
extern "C" int ssd_bwd_launch(const float* x, const float* da_cs,
                              const float* b_mat, const float* c_mat,
                              const float* dy, const float* dst, float* dx,
                              float* dda, float* db, float* dc, float* part,
                              long long BC, int L, int H, int P, int G, int N,
                              void* stream) {
    if (BC < 1 || L < 1 || L > L_MAX || P < 1 || P > P_MAX || N < 1 ||
        N > N_MAX || G < 1 || H % G != 0)
        return (int)cudaErrorInvalidValue;
    Params p;
    p.x = x;
    p.da_cs = da_cs;
    p.b = b_mat;
    p.c = c_mat;
    p.dy = dy;
    p.dst = dst;
    p.dx = dx;
    p.dda = dda;
    p.db = db;
    p.dc = dc;
    p.part = part;
    p.L = L;
    p.H = H;
    p.P = P;
    p.G = G;
    p.N = N;
    const int rep = H / G;
    p.ht = heads_per_block(rep);
    p.tiles = (rep + p.ht - 1) / p.ht;
    p.vec = P % 4 == 0 && N % 4 == 0 && (uintptr_t)x % 16 == 0 &&
            (uintptr_t)dy % 16 == 0 && (uintptr_t)dst % 16 == 0 &&
            (uintptr_t)b_mat % 16 == 0 && (uintptr_t)c_mat % 16 == 0;
    const long long heads = BC * G * p.tiles, groups = BC * G;
    if (heads > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const size_t heads_bytes = sizeof(float) * HEADS_SMEM;
    const size_t group_bytes = sizeof(float) * GROUP_SMEM;
    // above 48 KB of dynamic shared memory; set on every call (cheap), so
    // each device the kernels run on has it
    cudaError_t err;
    if ((err = cudaFuncSetAttribute(
             ssd_bwd_heads, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)heads_bytes)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             ssd_bwd_group, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)group_bytes)) != cudaSuccess)
        return (int)err;
    const cudaStream_t s = (cudaStream_t)stream;
    ssd_bwd_heads<<<(unsigned)heads, THREADS, heads_bytes, s>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_bwd_group<<<(unsigned)groups, THREADS, group_bytes, s>>>(p);
    return (int)cudaGetLastError();
}
