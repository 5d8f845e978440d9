// Transpose of the banded DISCO contraction (its gradient in x), for
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
// g (B, K, H_out, W_out), gx (B, H_in, W_in = W_out * stride); fp32.  psi
// is read as the forward reads it, its live taps (core/sphere/disco.py::
// band_live_taps: per slice (s, d_lo, span, offset), psi packed to (T, 8),
// each slice zero-padded to a multiple of 8 taps), here grouped by input
// row (band_row_taps: in_ptr (H_in + 1), in_ent (E, 2) = (h, slice),
// in_order (H_in) heaviest first).
//
// What bounds it on the H100: operations, as for the forward (the same
// products: 2 * K FLOP per output and live tap).  At fcn3_full the band
// is 94-97 % zeros; the earlier design multiplied the whole dense band
// in fp32 FMAs (12-13 TFLOP/s of dense work, 109-187x its fp32 bound).
//
// Design:
// * Only the live taps.  A block owns one input row r, a tile of TV = 256
//   input longitudes v and TBP = 16 planes, and walks r's slices from the
//   lists; within a slice only [d_lo, d_lo + span) is contracted (zeros
//   inside a span are multiplied, so the result is exact for any psi).
//   Every gx element is written once by one thread, no atomics: the
//   kernel is deterministic.  Rows go heaviest first within each plane
//   tile, and the plane tile is the slowest grid index, so the blocks in
//   flight share the g rows that neighbouring input rows read (each g row
//   is read once per slice, up to 7 times, by rows close to each other).
// * Tensor cores, 3xTF32 (tf32x3.cuh).  Per slice and basis function k
//   the contribution is a GEMM with a Toeplitz operand:
//       Out[b, v] += sum_u G[b, u] * T[u, v],  G[b, u] = g[b, k, h, u],
//       T[u, v] = P[v - c - stride * u, k]  (0 outside the span),
//   with c = d_lo + off0 and P the packed taps.  Planes are the mma's M =
//   16 rows, longitudes v its N = 8 columns (at stride S an n-tile holds 8
//   longitudes of one parity, v = V + par + S * (8 j + n)), the depth runs
//   over u.  For n-tile j and u-block i (8 u) the operand depends only on
//   delta = i - j: B_delta[q, n] = P[base + par - 8 S delta + S (n - q)].
//   Each warp owns 32 longitudes, so it splits the B fragments of every
//   delta of a piece once, into registers, then walks its u-blocks,
//   splitting each G fragment once and feeding it to every n-tile it
//   reaches.  T is read by index from the staged taps, with zero margins
//   around the piece, and never materialised.  Depth efficiency is
//   taps / (8 * (taps / 8 + 1)) at stride 1: 50 % at 8 taps, 89 % at 64.
// * Any stride.  Strides 1 and 2 (the fcn3 geometries) are compiled in
//   as above.  Above 2 a warp's 32 longitudes no longer split into whole
//   n-tiles of each residue class, so the generic path (S = 0, the
//   stride read from Params) gives each block one residue class cls of v
//   mod stride and TV longitudes of it, v = cls + stride * n: per class
//   the transpose is a stride-1 Toeplitz product over u with the taps
//   read stride apart, B_delta[q, n] = P[base - 8 S delta + S (n - q)].
//   u0 = floor((v0 - c - taps) / S) still pins base to [taps, taps + S -
//   1], so the reads reach taps base - 8 S nd - 7 S >= -16 S + 2 (nd <=
//   (taps + 9 S - 2) / (8 S)) up to base + 7 S <= taps + 8 S - 1: the
//   margins of 16 S zero taps cover them, and nd <= DM_ANY = 3 for every
//   stride above 2.  Speed is not its aim: no fcn3 configuration trains
//   at a stride above 2.
// * Asynchronous staging.  Slices are cut into pieces of at most CH = 64
//   taps; the unit of the pipeline is one (piece, k): that basis
//   function's taps of the piece with their zero margins (k-major, so the
//   B loads are conflict-free) and each plane's g window, TV / S + taps + 3
//   columns at most (the longitude wrapped by index arithmetic, 16-byte
//   cp.async when W_out is a multiple of 4, 4-byte otherwise).  The g
//   window of a plane holds one of its K = 7 rows per stage: a stage with
//   all seven would take 145 KB.  A three-stage ring keeps two units in
//   flight while one is contracted, one barrier per unit; each cursor
//   (load, contract) reads a piece's descriptor from the lists once, not
//   once per unit.  Window rows are 4 * odd floats long, so the A fragment
//   loads hit 32 distinct banks.  Strides 1 and 2 (the fcn3 geometries)
//   are compiled in.
// * Resources: 256 threads, at most 80 registers a thread
//   (__launch_bounds__(256, 3)), 63,360 bytes of shared memory per block
//   at stride 1 (3 stages of 96 + 16 * 324 floats; 34,560 at stride 2):
//   three blocks per SM.  ptxas (CUDA 12.8) gives stride 1 its 80
//   registers without spills; stride 2 (twice the B fragments) spills 56
//   bytes.  On the H100 (700 W, tools/disco_transpose_variants.py) three
//   blocks of 80 registers ran 15-16 % faster at the fcn3_full shapes
//   than two of 128 with four stages; five stages, blocks of 128 threads
//   and 128 longitudes, CH = 32 or 48, or four blocks of 64 registers at
//   CH = 32 (3 % faster at the latent, 2 % slower at the decoder) did not
//   beat it.  The kernel is bound by the warps it has in flight and by
//   the bytes it stages (see PERF.md).

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

// The tile constants a build may override (-DTUNE_CH=32 ...: the
// autotuner's variants, kernels/autotune.py); without -D flags they are
// the values above.
#ifndef TUNE_CH
#define TUNE_CH 64
#endif
#ifndef TUNE_STAGES
#define TUNE_STAGES 3
#endif
#ifndef TUNE_MIN_BLOCKS
#define TUNE_MIN_BLOCKS 3
#endif

namespace {

constexpr int TV = 256;     // input longitudes per block
constexpr int VW = 32;      // input longitudes per warp
constexpr int TBP = 16;     // planes per block: the mma's 16 rows
constexpr int CH = TUNE_CH;       // taps per staged piece of a slice
constexpr int THREADS = 256;
constexpr int STAGES = TUNE_STAGES;
constexpr int MIN_BLOCKS = TUNE_MIN_BLOCKS;
static_assert(TV == VW * (THREADS / 32), "the warps tile the longitudes");
static_assert(THREADS % TBP == 0, "whole threads per plane window");
static_assert(CH >= 8 && CH % 8 == 0, "whole u-blocks of 8 taps per piece");
static_assert(STAGES >= 2, "a ring of at least two units");
// registers a thread may take at MIN_BLOCKS blocks an SM: below 64 the
// fragments of a piece's deltas no longer fit at stride 1
static_assert(MIN_BLOCKS >= 1 && 65536 / (THREADS * MIN_BLOCKS) >= 64,
              "the fragments fit the register budget");

struct Params {
    const float* g;
    const int* in_ptr;
    const int2* in_ent;    // (h, slice)
    const int* in_order;
    const int4* tap_ent;   // (s, d_lo, span, offset)
    const float* tap_psi;  // (T, 8)
    float* gx;
    int B, K, H_out, W_out, H_in, W_in, D;
    int S;                 // the stride
    int n_vt, n_pt;        // longitude tiles (x classes at S > 2), plane tiles
    int vec;               // 16-byte loads (W_out % 4 == 0, g aligned)
};

__host__ __device__ constexpr int round_up(int v, int m) {
    return (v + m - 1) / m * m;
}

// Zero taps staged on either side of a piece, and the staged taps of one
// basis function: the B loads reach taps -16 S + 2 .. taps + 9 S - 2.
__host__ __device__ constexpr int margin(int s) { return 16 * s; }
__host__ __device__ constexpr int psi_floats(int s) {
    return CH + 2 * margin(s);
}
// The most u-block offsets delta a piece of `taps` taps needs, less one.
__host__ __device__ constexpr int deltas(int taps, int s) {
    return (taps + 9 * s - 2) / (8 * s);
}
// Floats of one plane's g window: TV / S + 8 * deltas + 3 (alignment
// shift) at most, rounded up to 4 * odd.
__host__ __device__ constexpr int window_floats(int s) {
    return ((TV / s + 8 * deltas(CH, s) + 3 + 3) / 4 | 1) * 4;
}
__host__ __device__ constexpr int stage_floats(int s) {
    return psi_floats(s) + TBP * window_floats(s);
}
// The generic path (S = 0): deltas(CH, s) is 3 at s = 3 and 4 and falls
// below as s grows; a block's window holds TV longitudes of one class.
constexpr int DM_ANY = 3;
static_assert(deltas(CH, 3) <= DM_ANY && deltas(CH, 4) <= DM_ANY,
              "the generic path holds DM_ANY + 1 deltas");
constexpr int WIN_ANY = ((TV + 8 * DM_ANY + 3 + 3) / 4 | 1) * 4;
__host__ __device__ constexpr int stage_floats_any(int s) {
    return psi_floats(s) + TBP * WIN_ANY;
}

// the ring at the compiled strides fits a block's 227 KB
static_assert(sizeof(float) * STAGES * stage_floats(1) <= 232448 &&
                  sizeof(float) * STAGES * stage_floats(2) <= 232448,
              "the ring fits a block's shared memory");

// The stride: compiled in, or read from p on the generic path.
template <int S>
__device__ __forceinline__ int stride_of(const Params& p) {
    return S ? S : p.S;
}

// One piece of a slice: output row h, its padded taps, their first row in
// tap_psi, the deltas it needs (nd + 1 of them), the block's g window
// (first column col0, shift floats of alignment before u = U), base =
// v0 - c - S * U, in [taps, taps + S - 1], and whether it is the slice's
// last piece.
struct Piece {
    int h, taps, psi, nd, base, col0, shift;
    bool last;
};

template <int S>
__device__ __forceinline__ Piece piece_of(const Params& p, int e, int pc,
                                          int v0) {
    const int s = stride_of<S>(p);
    const int2 he = p.in_ent[e];
    const int4 ent = p.tap_ent[he.y];
    Piece q;
    q.h = he.x;
    q.taps = min(CH, round_up(ent.z, 8) - pc * CH);
    q.last = (pc + 1) * CH >= round_up(ent.z, 8);
    q.psi = ent.w + pc * CH;
    q.nd = deltas(q.taps, s);
    // tap 0 of the piece takes output w to input longitude w * S + c
    const int c = ent.y + pc * CH - p.D / 2;
    const int num = v0 - c - q.taps;
    const int u0 = num >= 0 ? num / s : -((-num + s - 1) / s);
    q.base = v0 - c - s * u0;
    int u = u0 % p.W_out;
    if (u < 0) u += p.W_out;
    q.shift = p.vec ? (u & 3) : 0;
    q.col0 = u - q.shift;
    return q;
}

// The pipeline walks units (slice e, piece pc, basis k), k fastest; a
// cursor keeps the descriptor of its piece, read from the lists once per
// piece.
template <int S>
struct Cursor {
    int e, pc, k;
    Piece q;

    __device__ __forceinline__ Cursor(const Params& p, int e0, int e_end,
                                      int v0)
        : e(e0), pc(0), k(0) {
        if (e < e_end) q = piece_of<S>(p, e, pc, v0);
    }

    __device__ __forceinline__ void advance(const Params& p, int e_end,
                                            int v0) {
        if (++k < p.K) return;
        k = 0;
        if (q.last) {
            ++e;
            pc = 0;
        } else {
            ++pc;
        }
        if (e < e_end) q = piece_of<S>(p, e, pc, v0);
    }
};

// Start the copies of (piece q, basis k) into stage buffer buf: the taps
// of k with their zero margins, then each plane's g window.
template <int S>
__device__ __forceinline__ void stage(const Params& p, float* buf,
                                      const Piece& q, int k, int b0) {
    const int s = stride_of<S>(p);
    const float* psrc = p.tap_psi + (size_t)q.psi * 8 + k;
    for (int i = threadIdx.x; i < psi_floats(s); i += THREADS) {
        const int tau = i - margin(s);
        const bool ok = tau >= 0 && tau < q.taps;
        tf32x3::cp_async4(buf + i, psrc + (ok ? (size_t)tau * 8 : 0), ok);
    }

    // TPP threads copy each plane's window; the column wraps by a
    // subtraction (the window may be wider than the circle)
    constexpr int TPP = THREADS / TBP;
    const int bb = threadIdx.x / TPP, k0 = threadIdx.x % TPP;
    const int b = b0 + bb;
    const bool ok = b < p.B;
    const float* row =
        p.g + (((size_t)(ok ? b : 0) * p.K + k) * p.H_out + q.h) * p.W_out;
    float* gs = buf + psi_floats(s) + bb * (S ? window_floats(S) : WIN_ANY);
    // the window: TV / S longitudes' columns, or TV of one class
    const int ncols = q.shift + (S ? TV / S : TV) + 8 * q.nd;
    const int width = p.vec ? 4 : 1;          // floats per copy
    const int n = p.vec ? (ncols + 3) >> 2 : ncols;
    int col = q.col0 + width * k0;
    while (col >= p.W_out) col -= p.W_out;
    for (int j = k0; j < n; j += TPP) {
        if (p.vec)
            tf32x3::cp_async16(gs + 4 * j, row + col, ok);
        else
            tf32x3::cp_async4(gs + j, row + col, ok);
        col += width * TPP;
        while (col >= p.W_out) col -= p.W_out;
    }
}

template <int S>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
disco_band_bwd_kernel(const Params p) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    // n-tiles of one parity a warp, parities a block (one class at S = 0)
    constexpr int NT = S ? VW / (8 * S) : VW / 8;
    constexpr int NPAR = S ? S : 1;
    constexpr int DM = S ? deltas(CH, S) : DM_ANY;
    constexpr int WIN = S ? window_floats(S) : WIN_ANY;
    const int s = stride_of<S>(p);
    const int SF = S ? stage_floats(S) : stage_floats_any(s);

    const int per_pt = p.H_in * p.n_vt;
    const int b0 = (blockIdx.x / per_pt) * TBP;
    const int rem = blockIdx.x % per_pt;
    const int r = p.in_order[rem / p.n_vt];
    const int tile = rem % p.n_vt;
    // the block's first longitude; consecutive outputs lie 1 apart, or
    // stride apart on the generic path (class tile % s, TV of them)
    const int v0 = S ? tile * TV : tile % s + s * (tile / s) * TV;
    const int vstep = S ? 1 : s;

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gq = lane >> 2, t = lane & 3;

    float acc[NPAR][NT][4];
#pragma unroll
    for (int par = 0; par < NPAR; ++par)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[par][j][i] = 0.f;

    // ring of STAGES units: unit i + STAGES - 1 is loaded while unit i is
    // contracted; one barrier per unit
    const int e_end = p.in_ptr[r + 1];
    Cursor<S> load(p, p.in_ptr[r], e_end, v0);   // next unit to load
    Cursor<S> comp = load;                       // next unit to contract
    for (int i = 0; i < STAGES - 1; ++i) {
        if (load.e < e_end) {
            stage<S>(p, smem + i * SF, load.q, load.k, b0);
            load.advance(p, e_end, v0);
        }
        tf32x3::cp_async_commit();
    }
    for (int i = 0; comp.e < e_end; ++i) {
        tf32x3::cp_async_wait<STAGES - 2>();
        __syncthreads();
        if (load.e < e_end) {
            stage<S>(p, smem + ((i + STAGES - 1) % STAGES) * SF, load.q,
                     load.k, b0);
            load.advance(p, e_end, v0);
        }
        tf32x3::cp_async_commit();

        const Piece q = comp.q;
        comp.advance(p, e_end, v0);
        const float* ps = smem + (i % STAGES) * SF + margin(s);
        // B fragments of every delta this piece needs: b0 is (u-row t,
        // column gq), b1 (t + 4, gq)
        uint32_t bh[NPAR][DM + 1][2], bl[NPAR][DM + 1][2];
#pragma unroll
        for (int d = 0; d <= DM; ++d) {
            if (d > q.nd) break;
#pragma unroll
            for (int par = 0; par < NPAR; ++par) {
                const int tau = q.base + par - 8 * s * d + s * (gq - t);
                tf32x3::split(ps[tau], bh[par][d][0], bl[par][d][0]);
                tf32x3::split(ps[tau - 4 * s], bh[par][d][1], bl[par][d][1]);
            }
        }
        // this lane's A column t of plane gq in the warp's window
        const float* ga = ps - margin(s) + psi_floats(s) + gq * WIN +
                          q.shift + warp * (S ? VW / S : VW) + t;
#pragma unroll
        for (int i = 0; i < NT + DM; ++i) {
            if (i >= NT + q.nd) break;
            uint32_t ah[4], al[4];
            const float* gi = ga + 8 * i;
            tf32x3::split(gi[0], ah[0], al[0]);
            tf32x3::split(gi[8 * WIN], ah[1], al[1]);
            tf32x3::split(gi[4], ah[2], al[2]);
            tf32x3::split(gi[8 * WIN + 4], ah[3], al[3]);
#pragma unroll
            for (int d = 0; d <= DM; ++d) {
                const int j = i - d;
                if (j < 0 || j >= NT) continue;
                if (d > q.nd) break;
#pragma unroll
                for (int par = 0; par < NPAR; ++par)
                    tf32x3::mma3(acc[par][j], ah, al, bh[par][d][0],
                                 bh[par][d][1], bl[par][d][0], bl[par][d][1]);
            }
        }
    }

    // c0 (plane gq, n = 2t), c1 (gq, 2t + 1), c2 (gq + 8, 2t), c3 (gq + 8,
    // 2t + 1); n-tile j of parity par holds v = V + par + S * (8 j + n)
    const int vw = v0 + vstep * warp * VW;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int b = b0 + gq + 8 * half;
        if (b >= p.B) break;
        float* o = p.gx + ((size_t)b * p.H_in + r) * p.W_in;
#pragma unroll
        for (int par = 0; par < NPAR; ++par)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const int v = vw + par + s * (8 * j + 2 * t + i);
                    if (v < p.W_in) o[v] = acc[par][j][2 * half + i];
                }
    }
}

template <int S>
int launch(const Params& p, cudaStream_t stream) {
    const int smem = (int)(sizeof(float) * STAGES *
                           (S ? stage_floats(S) : stage_floats_any(p.S)));
    cudaError_t e = cudaFuncSetAttribute(
        disco_band_bwd_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    const long long blocks = (long long)p.n_pt * p.H_in * p.n_vt;
    disco_band_bwd_kernel<S><<<(unsigned)blocks, THREADS, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace

// The compiled tile: TV, TBP, CH, STAGES, MIN_BLOCKS, THREADS, DM_ANY;
// returns how many it wrote (the wrapper reads its grid limits here).
extern "C" int disco_band_bwd_constants(int* out) {
    const int v[] = {TV, TBP, CH, STAGES, MIN_BLOCKS, THREADS, DM_ANY};
    for (int i = 0; i < 7; ++i) out[i] = v[i];
    return 7;
}

// Dynamic shared memory one block takes at `stride` (>= 1), in bytes.
extern "C" long long disco_band_bwd_smem_bytes(int stride) {
    return (long long)sizeof(float) * STAGES *
           (stride <= 2 ? stage_floats(stride) : stage_floats_any(stride));
}

// g (B, K, H_out, W_out); the live taps tap_ent (E, 4), tap_psi (T, 8);
// their lists by input row in_ptr (H_in + 1), in_ent (E, 2), in_order
// (H_in); gx (B, H_in, W_out * stride); all contiguous.  D is the band's
// width (off0 = -(D / 2)).  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a basis count outside 1..8 or a stride below
// 1; the attribute call fails for a stride whose stage exceeds the shared
// memory of a block).
extern "C" int disco_band_bwd_launch(const float* g, const int* in_ptr,
                                     const int* in_ent, const int* in_order,
                                     const int* tap_ent,
                                     const float* tap_psi, float* gx, int B,
                                     int K, int H_out, int W_out, int H_in,
                                     int D, int stride, void* stream) {
    if (K < 1 || K > 8 || stride < 1) return (int)cudaErrorInvalidValue;
    Params p;
    p.g = g;
    p.in_ptr = in_ptr;
    p.in_ent = reinterpret_cast<const int2*>(in_ent);
    p.in_order = in_order;
    p.tap_ent = reinterpret_cast<const int4*>(tap_ent);
    p.tap_psi = tap_psi;
    p.gx = gx;
    p.B = B;
    p.K = K;
    p.H_out = H_out;
    p.W_out = W_out;
    p.H_in = H_in;
    p.W_in = W_out * stride;
    p.D = D;
    p.S = stride;
    p.n_vt = stride <= 2 ? (p.W_in + TV - 1) / TV
                         : stride * ((W_out + TV - 1) / TV);
    p.n_pt = (B + TBP - 1) / TBP;
    p.vec = (W_out % 4 == 0) && ((uintptr_t)g % 16 == 0);
    cudaStream_t st = (cudaStream_t)stream;
    return stride == 1 ? launch<1>(p, st)
         : stride == 2 ? launch<2>(p, st)
                       : launch<0>(p, st);
}
