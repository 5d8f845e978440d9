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
// have any strides but a unit one on j and m; out is contiguous.  ext
// (2, 2, M) int32 gives, per order, the half-open rows [k_lo, k_hi) and
// columns [n_lo, n_hi) that hold its nonzeros (core/sphere/sht.py::
// order_extents, read from the table's data).
//
// What bounds it on the H100: operations.  At the fcn3_full latent (K = N
// = M = 360, B ~ 1350 complex rows for 2 members) the dense product is
// ~250 GFLOP on ~3 GB of operands; the tables are zero for l < m, so the
// work the data needs is ~110 GFLOP, far above the ridge of the card's
// fp32 or TF32 rate over 3.35 TB/s.  The earlier design contracted the
// whole K x N table of every order in SIMT fp32 FMAs (24 TFLOP/s dense)
// behind two barriers per step with no copy in flight, 1.8x slower than
// torch.bmm on m-major operands (PERF.md).
//
// Design:
// * The zeros are skipped from the table's own data.  A block owns TJ = 8
//   adjacent j (TJ >> CSHIFT orders), a 32-row b tile and a 64-column n
//   tile, and takes the union of its orders' extents: the k loop runs
//   over the union's rows alone (inverse SHT: k >= m), and the column
//   tiles of a (b, j) tile start at the union's first column, 8-aligned
//   (forward SHT: n >= m), not on a fixed grid.  The grid has two spare
//   column blocks per (b, j) tile; the blocks past the live tiles write
//   the zeros left and right of them.  Rows and columns outside the union
//   are zero-filled in shared memory, so any table, triangular or not,
//   comes out exact.
// * Tensor cores in 3xTF32 (tf32x3.cuh): each order's product runs on
//   mma.sync.m16n8k8 with a TF32 hi/lo split of both operands, fp32
//   accuracy.  Warp (c, bh, nh) owns j0 + 4c .. + 3, 16 rows b and 32
//   columns n (four n8 tiles): the x fragments are split once and feed
//   four tiles, the table fragments once per order (the re and im j of a
//   complex order share them, their products interleaved).
// * The m-minor layout is read in place.  x and the table are staged as
//   (k, b) and (k, n) rows of 32 bytes (TJ floats of x, TJ or TJ / 2
//   orders of the table) with 16-byte cp.async (4-byte copies when a
//   stride or extent is not a multiple of 4), into a two-stage ring:
//   the next 16-deep k slab is in flight while this one is contracted,
//   one barrier per slab.  Each thread's copies keep the same rows from
//   slab to slab, so their addresses are set up once per block, and so
//   are each lane's fragment offsets.  The 16-byte chunks are
//   XOR-swizzled by (k mod 4, row parity), so the fragment loads, one
//   float4 over 4 adjacent j per element, hit 8 distinct bank quads in
//   each quarter warp.  out is written as float4 over the same 4 j.
// * Registers bound the tile: at two blocks of 256 threads per SM (128
//   registers a thread) the 64 accumulators, the split x fragments and
//   the table fragments just fit; wider warp tiles or one block per SM
//   ran slower on the H100.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

// The tile constants a build may override (-DTUNE_TB=64 ...: the
// autotuner's variants, kernels/autotune.py); without -D flags they are
// the values above, tuned by hand on the H100.
#ifndef TUNE_TB
#define TUNE_TB 32
#endif
#ifndef TUNE_TN
#define TUNE_TN 64
#endif
#ifndef TUNE_TK
#define TUNE_TK 16
#endif
#ifndef TUNE_STAGES
#define TUNE_STAGES 2
#endif

namespace {

constexpr int TJ = 8;          // j per block (adjacent in memory)
constexpr int TB = TUNE_TB;    // output rows (b) per block
constexpr int TN = TUNE_TN;    // output columns (n) per block
constexpr int TK = TUNE_TK;    // contraction depth per stage
constexpr int STAGES = TUNE_STAGES;
constexpr int NT = 4;    // n8 tiles per warp
// warps: 2 halves of j x TB / 16 row groups x TN / (8 NT) column groups
constexpr int WB = TB / 16, WN = TN / (8 * NT);
constexpr int THREADS = 64 * WB * WN;
constexpr int MIN_BLOCKS = THREADS <= 256 ? 2 : 1;
static_assert(TB >= 16 && TB % 16 == 0, "row groups of the mma's 16 rows");
static_assert(TN >= 8 * NT && TN % (8 * NT) == 0,
              "column groups of NT n8 tiles");
static_assert(TK >= 8 && TK % 8 == 0, "whole k8 steps of the mma per slab");
static_assert(STAGES >= 2, "a ring of at least two slabs");
static_assert(THREADS <= 1024, "threads per block");

struct Params {
    const float* x;
    const float* t;
    const int* ext;
    float* out;
    int B, K, N, J, M;
    long long sxb, sxk, stk, stn;
    int vx, vt, vo;   // 16-byte paths for x loads, table loads, stores
};

// floats of one stage: the x slab, then the table slab
template <int CSHIFT>
__host__ __device__ constexpr int stage_floats() {
    return TK * TB * TJ + TK * TN * (TJ >> CSHIFT);
}

// shared memory of one block, the ring of STAGES slabs (the real path's
// is the larger); a block has at most 227 KB
static_assert(sizeof(float) * STAGES * stage_floats<0>() <= 232448,
              "the ring fits a block's shared memory");

__device__ __forceinline__ float pick(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 16-byte chunk of the x slab: row (kl, bl), half c (j0 + 4c .. + 3)
__device__ __forceinline__ int x_chunk(int kl, int bl, int c) {
    return (2 * (kl * TB + bl) + c) ^ ((kl & 3) | ((bl & 1) << 2));
}

// 16-byte chunk of the table slab: row (kl, nl), chunk c of TCH
template <int TCH>
__device__ __forceinline__ int t_chunk(int kl, int nl, int c) {
    return TCH == 2 ? (2 * (kl * TN + nl) + c) ^ ((kl & 3) | ((nl & 1) << 2))
                    : (kl * TN + nl) ^ ((kl & 3) << 1);
}

// One thread's share of staging a slab, fixed for the whole block: its
// x copies read row (b, half) at slab rows kx + q * KXS, its table copies
// read row (n, chunk) at slab rows kt + q * KTS.
constexpr int PX = TK * TB * 2 / THREADS, KXS = THREADS / (2 * TB);
static_assert((THREADS / 2) % TB == 0 && (TK * TB * 2) % THREADS == 0,
              "x copies: whole rows per pass");
static_assert((THREADS / 2) % TN == 0 && (TK * TN) % THREADS == 0,
              "table copies: whole rows per pass");
static_assert(PX >= 1 && THREADS % TN == 0 && TK * TN >= THREADS,
              "every thread copies x and (real and complex) table rows");
template <int TCH>
struct Copies {
    static constexpr int PT = TK * TN * TCH / THREADS;
    static constexpr int KTS = THREADS / (TN * TCH);
};

struct Plan {
    const float* xsrc;   // &x[b, 0, j] (x itself when b is out of range)
    const float* tsrc;   // &t[0, n, m] (t itself when n is not live)
    int kx, xb, xh;      // first slab row, row b (local), half of x copies
    int kt, tn, tc;      // first slab row, column n (local), chunk of t
    int xlen, tlen;      // floats of the 16-byte chunk inside x / t (0..4)
};

template <int CSHIFT>
__device__ __forceinline__ Plan make_plan(const Params& p, int b0, int n0,
                                          int nlo, int nhi, int j0) {
    constexpr int TCH = (TJ >> CSHIFT) / 4;
    Plan pl;
    const int tid = threadIdx.x;
    pl.xh = tid & 1;
    pl.xb = (tid >> 1) % TB;
    pl.kx = (tid >> 1) / TB;
    const int b = b0 + pl.xb, j = j0 + 4 * pl.xh;
    pl.xlen = b < p.B ? max(0, min(4, p.J - j)) : 0;
    pl.xsrc = pl.xlen ? p.x + b * p.sxb + j : p.x;
    const int row = TCH == 2 ? tid >> 1 : tid;
    pl.tc = TCH == 2 ? tid & 1 : 0;
    pl.tn = row % TN;
    pl.kt = row / TN;
    const int n = n0 + pl.tn, m = (j0 >> CSHIFT) + 4 * pl.tc;
    pl.tlen = n >= nlo && n < nhi ? max(0, min(4, p.M - m)) : 0;
    pl.tsrc = pl.tlen ? p.t + n * p.stn + m : p.t;
    return pl;
}

// Issue the copies of slab rows ks .. ks + TK (zero-filled from khi on).
template <int CSHIFT>
__device__ __forceinline__ void stage_slab(const Params& p, const Plan& pl,
                                           float* buf, int ks, int khi) {
    constexpr int TCH = (TJ >> CSHIFT) / 4;
    float* xs = buf;
    float* ts = buf + TK * TB * TJ;
#pragma unroll
    for (int q = 0; q < PX; ++q) {
        const int kl = pl.kx + q * KXS, k = ks + kl;
        const int n = k < khi ? pl.xlen : 0;
        const float* src = n ? pl.xsrc + k * p.sxk : p.x;
        float* dst = xs + 4 * x_chunk(kl, pl.xb, pl.xh);
        if (p.vx) {
            tf32x3::cp_async16(dst, src, n > 0);
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
                tf32x3::cp_async4(dst + e, e < n ? src + e : p.x, e < n);
        }
    }
#pragma unroll
    for (int q = 0; q < Copies<TCH>::PT; ++q) {
        const int kl = pl.kt + q * Copies<TCH>::KTS, k = ks + kl;
        const int n = k < khi ? pl.tlen : 0;
        const float* src = n ? pl.tsrc + k * p.stk : p.t;
        float* dst = ts + 4 * t_chunk<TCH>(kl, pl.tn, pl.tc);
        if (p.vt) {
            tf32x3::cp_async16(dst, src, n > 0);
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
                tf32x3::cp_async4(dst + e, e < n ? src + e : p.t, e < n);
        }
    }
}

// Union of the extents of orders [m_beg, m_end) (clipped to M): rows
// [klo, khi), columns [nlo, nhi); empty (klo >= khi) when none has a
// nonzero.
struct Ext {
    int klo, khi, nlo, nhi;
};

__device__ __forceinline__ Ext extents_union(const Params& p, int m_beg,
                                             int m_end) {
    Ext u{p.K, 0, p.N, 0};
    for (int m = m_beg; m < min(m_end, p.M); ++m) {
        const int a = p.ext[m], b = p.ext[p.M + m];
        const int c = p.ext[2 * p.M + m], d = p.ext[3 * p.M + m];
        if (a < b && c < d) {
            u.klo = min(u.klo, max(a, 0));
            u.khi = max(u.khi, min(b, p.K));
            u.nlo = min(u.nlo, max(c, 0));
            u.nhi = max(u.nhi, min(d, p.N));
        }
    }
    return u;
}

// out[b0 .. b0 + TB, c0 .. c1, j0 .. j0 + TJ] = 0 (clipped to the shape).
__device__ __forceinline__ void write_zeros(const Params& p, int b0, int c0,
                                            int c1, int j0) {
    const int w = c1 - c0;
    for (int i = threadIdx.x; i < TB * TN * TJ; i += THREADS) {
        const int jj = i % TJ, n = (i / TJ) % TN, bl = i / (TJ * TN);
        const int b = b0 + bl, j = j0 + jj;
        if (n < w && b < p.B && j < p.J)
            p.out[((size_t)b * p.N + c0 + n) * p.J + j] = 0.f;
    }
}

template <int CSHIFT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
legendre_kernel(const Params p) {
    constexpr int TM = TJ >> CSHIFT;   // table orders one block needs
    constexpr int TCH = TM / 4;        // 16-byte chunks per table row
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    constexpr int SF = stage_floats<CSHIFT>();

    const int b0 = blockIdx.y * TB;
    const int j0 = blockIdx.z * TJ;
    const int m0 = j0 >> CSHIFT;

    // The union of the extents of the block's orders.  The live column
    // tiles start at its first column (8-aligned), not on a fixed grid;
    // the blocks of this (b, j) tile past them write the zeros left of it
    // and right of the live tiles (the grid has two spare column blocks).
    const Ext u = extents_union(p, m0, m0 + TM);
    const bool any = u.klo < u.khi;
    const int lo8 = any ? (u.nlo & ~7) : 0;
    const int n_live = any ? (u.nhi - lo8 + TN - 1) / TN : 0;
    if ((int)blockIdx.x >= n_live) {
        const int z = blockIdx.x - n_live, z_left = (lo8 + TN - 1) / TN;
        const int c0 = z < z_left ? z * TN : lo8 + (n_live + z - z_left) * TN;
        const int c1 = min(c0 + TN, z < z_left ? lo8 : p.N);
        write_zeros(p, b0, c0, c1, j0);
        return;
    }
    const int n0 = lo8 + blockIdx.x * TN;
    const int klo = u.klo, khi = u.khi, nlo = u.nlo, nhi = u.nhi;

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int c = warp & 1;                   // j0 + 4c .. + 3
    const int bw = ((warp >> 1) % WB) * 16;   // rows bw .. bw + 15
    const int nw = ((warp >> 1) / WB) * 8 * NT;   // columns nw .. + 8 NT - 1

    float acc[NT][4][4];   // [n8 tile][j][fragment]
#pragma unroll
    for (int a = 0; a < NT; ++a)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[a][jj][e] = 0.f;

    {
        // ring of STAGES slabs: slab st + STAGES - 1 is issued while slab
        // st is contracted; one barrier per slab
        const Plan pl = make_plan<CSHIFT>(p, b0, n0, nlo, nhi, j0);
        const int steps = (khi - klo + TK - 1) / TK;
        for (int st = 0; st < STAGES - 1; ++st) {
            if (st < steps)
                stage_slab<CSHIFT>(p, pl, smem + st * SF, klo + st * TK, khi);
            tf32x3::cp_async_commit();
        }
        // this lane's fragment chunks for slab rows 0..7 and n8 tile 0;
        // rows 8..15 and tile a sit a constant number of chunks further
        int xo[4], to[2];
#pragma unroll
        for (int e = 0; e < 4; ++e)
            xo[e] = x_chunk(tq + 4 * (e >> 1), bw + g + 8 * (e & 1), c);
#pragma unroll
        for (int e = 0; e < 2; ++e)
            to[e] = t_chunk<TCH>(tq + 4 * e, nw + g, TCH == 2 ? c : 0);
        for (int st = 0; st < steps; ++st) {
            tf32x3::cp_async_wait<STAGES - 2>();
            __syncthreads();
            const int nx = st + STAGES - 1;
            if (nx < steps)
                stage_slab<CSHIFT>(p, pl, smem + (nx % STAGES) * SF,
                                   klo + nx * TK, khi);
            tf32x3::cp_async_commit();
            const float4* xs =
                reinterpret_cast<const float4*>(smem + (st % STAGES) * SF);
            const float4* ts = xs + TK * TB * TJ / 4;
#pragma unroll 1
            for (int kk = 0; kk < TK; kk += 8, xs += 16 * TB, ts += 8 * TN * TCH) {
                // A fragments of the 4 j: element e = row g (+8 if e & 1),
                // column tq (+4 if e & 2); one float4 holds the 4 j
                uint32_t ah[4][4], al[4][4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float4 v = xs[xo[e]];
#pragma unroll
                    for (int jj = 0; jj < 4; ++jj)
                        tf32x3::split(pick(v, jj), ah[jj][e], al[jj][e]);
                }
#pragma unroll
                for (int a = 0; a < NT; ++a) {
                    // B fragments: (k = tq, n = g) and (k = tq + 4, n = g)
                    const float4 v0 = ts[to[0] + 8 * TCH * a];
                    const float4 v1 = ts[to[1] + 8 * TCH * a];
#pragma unroll
                    for (int mi = 0; mi < 4 >> CSHIFT; ++mi) {
                        // real: order j; complex: orders 2c, 2c + 1 of
                        // the chunk, each for its re and im j
                        const int sel = CSHIFT ? 2 * c + mi : mi;
                        uint32_t bh0, bl0, bh1, bl1;
                        tf32x3::split(pick(v0, sel), bh0, bl0);
                        tf32x3::split(pick(v1, sel), bh1, bl1);
                        if (CSHIFT) {   // re and im j of the order
                            const int jj = 2 * mi;
                            tf32x3::mma3x2(acc[a][jj], ah[jj], al[jj],
                                           acc[a][jj + 1], ah[jj + 1],
                                           al[jj + 1], bh0, bh1, bl0, bl1);
                        } else {
                            tf32x3::mma3(acc[a][mi], ah[mi], al[mi], bh0, bh1,
                                         bl0, bl1);
                        }
                    }
                }
            }
        }
    }

    // acc[a][jj]: c0 (b = g, n = 2tq), c1 (g, 2tq + 1), c2 (g + 8, 2tq),
    // c3 (g + 8, 2tq + 1), for j = j0 + 4c + jj
    const int j = j0 + 4 * c;
#pragma unroll
    for (int a = 0; a < NT; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int b = b0 + bw + g + 8 * (e >> 1);
            const int n = n0 + nw + 8 * a + 2 * tq + (e & 1);
            if (b >= p.B || n >= p.N || j >= p.J) continue;
            float* o = p.out + ((size_t)b * p.N + n) * p.J + j;
            if (p.vo) {
                *reinterpret_cast<float4*>(o) = make_float4(
                    acc[a][0][e], acc[a][1][e], acc[a][2][e], acc[a][3][e]);
            } else {
#pragma unroll
                for (int jj = 0; jj < 4; ++jj)
                    if (j + jj < p.J) o[jj] = acc[a][jj][e];
            }
        }
}

template <int CSHIFT>
int launch(const Params& p, cudaStream_t stream) {
    const int smem = (int)(sizeof(float) * STAGES * stage_floats<CSHIFT>());
    cudaError_t e = cudaFuncSetAttribute(
        legendre_kernel<CSHIFT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    // two spare column blocks per (b, j) tile: see the kernel
    dim3 grid((p.N + TN - 1) / TN + 2, (p.B + TB - 1) / TB,
              (p.J + TJ - 1) / TJ);
    legendre_kernel<CSHIFT><<<grid, THREADS, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

bool aligned16(const void* ptr) { return (uintptr_t)ptr % 16 == 0; }

}  // namespace

// The compiled tile: TJ, TB, TN, TK, STAGES, THREADS and the dynamic
// shared memory of a block for real and for complex x, in bytes; returns
// how many it wrote (the wrapper reads its grid limits from here).
extern "C" int legendre_constants(int* out) {
    const int v[] = {TJ, TB, TN, TK, STAGES, THREADS,
                     (int)(sizeof(float) * STAGES * stage_floats<0>()),
                     (int)(sizeof(float) * STAGES * stage_floats<1>())};
    for (int i = 0; i < 8; ++i) out[i] = v[i];
    return 8;
}

// x: (B, K, J) floats at strides (sxb, sxk, 1); t: (K, N, J >> cshift)
// floats at strides (stk, stn, 1); ext: (2, 2, J >> cshift) int32; out:
// (B, N, J) contiguous floats.  cshift is 0 (real x) or 1 (complex x,
// j = 2m + re/im).  Returns cudaGetLastError() after the launch.
extern "C" int legendre_contract_launch(const float* x, const float* t,
                                        const int* ext, float* out, int B,
                                        int K, int N, int J, int cshift,
                                        long long sxb, long long sxk,
                                        long long stk, long long stn,
                                        void* stream) {
    Params p;
    p.x = x;
    p.t = t;
    p.ext = ext;
    p.out = out;
    p.B = B;
    p.K = K;
    p.N = N;
    p.J = J;
    p.M = J >> cshift;
    p.sxb = sxb;
    p.sxk = sxk;
    p.stk = stk;
    p.stn = stn;
    p.vx = aligned16(x) && sxb % 4 == 0 && sxk % 4 == 0 && J % 4 == 0;
    p.vt = aligned16(t) && stk % 4 == 0 && stn % 4 == 0 && p.M % 4 == 0;
    p.vo = aligned16(out) && J % 4 == 0;
    cudaStream_t s = (cudaStream_t)stream;
    return cshift == 1 ? launch<1>(p, s) : launch<0>(p, s);
}
