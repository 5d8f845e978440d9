// Banded DISCO contraction on the sphere, for sm_90a.
//
// Replaces: src/repro/kernels/disco/disco.py::disco_band_contract (Pallas
// body _disco_kernel) together with the roll and latitude gather that
// src/repro/kernels/dispatch.py::disco_conv_banded_buffers does before it.
//
// Computes, with off0 = -(D / 2):
//     out[b, k, h, w] = sum_{s, d} psi[k, h, s, d]
//                       * x[b, lat_idx[h, s], (w*stride + d + off0) mod W_in]
// x (B, H_in, W_in), lat_idx (H_out, S) int32, out (B, K, H_out, W_out)
// with W_out = W_in / stride; all fp32.  psi is read as its live taps
// (core/sphere/disco.py::band_live_taps): for each output row h a list of
// the slices (s, d_lo, span, offset) with a nonzero, and psi packed to
// those taps, (T, 8) floats, each slice zero-padded to a multiple of 8
// taps and the basis to 8 functions.
//
// What bounds it on the H100: operations.  At fcn3_full the band is 94-97 %
// zeros (the geodesic disk meets an input ring in one short interval); the
// taps that are left still cost 2*K FLOP per output and tap, ~1.5e11 FLOP
// per launch at the encoder against 1.5 GB moved.  The earlier design
// looped over every (s, d) of the dense band in fp32 FMAs: 31-34 TFLOP/s
// of dense band work, nearly all of it on zeros.
//
// Design:
// * Only the live taps.  A block owns one output row h, a tile of TW = 128
//   longitudes and TBP = 16 input planes, and walks the row's slices from
//   the list; all-zero slices are not in it, and within a slice only
//   [d_lo, d_lo + span) is contracted (zeros inside a span are multiplied,
//   so the result is exact for any psi).
// * Tensor cores.  Per slice and plane the row is a small GEMM
//   out[w, k] += sum_t A[w, t] * P[t, k] with A[w, t] = window[(w - w0) *
//   stride + t]: a Toeplitz read of the staged input window, loaded into
//   mma.sync.m16n8k8 fragments by index and never materialised; P is the
//   packed psi, K = 7 padded to the mma's N = 8.  Warp i owns the 16
//   longitudes w0 + 16 i .. + 15 for all 16 planes, so each psi fragment
//   is split once and feeds 16 planes, taken in pairs whose products
//   interleave.  The products are 3xTF32 (tf32x3.cuh): fp32 accuracy,
//   no plain TF32.
// * Asynchronous staging.  A slice is staged in pieces of at most CH =
//   128 taps, so a stage holds CH taps whatever the band's width (D = 641
//   at the decoder) and two blocks fit on an SM.  A three-stage ring in
//   shared memory holds one piece each: its packed psi and, per plane,
//   the input window it needs, (TW - 1) * stride + taps (+ at most 3 for
//   alignment) columns, read through lat_idx with the longitude wrapped
//   by index arithmetic, in 16-byte cp.async chunks (4-byte ones when
//   W_in is not a multiple of 4).  The next two pieces are in flight
//   while the current one is contracted, one barrier per piece.  Strides 1 and 2
//   (the fcn3 geometries) are compiled in, so the window layout and the
//   fragment offsets are constants.
// * Load balance.  The near-pole rows carry up to 25x the median taps, so
//   the 1-D grid walks the rows heaviest first (row_order, from the
//   builder), all tiles of a row together.  Every output is written once
//   by one thread, no atomics: the kernel is deterministic.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

// The tile constants a build may override (-DTUNE_CH=64 ...: the
// autotuner's variants, kernels/autotune.py); without -D flags they are
// the values above.
#ifndef TUNE_TBP
#define TUNE_TBP 16
#endif
#ifndef TUNE_CH
#define TUNE_CH 128
#endif
#ifndef TUNE_STAGES
#define TUNE_STAGES 3
#endif
#ifndef TUNE_MIN_BLOCKS
#define TUNE_MIN_BLOCKS 2
#endif

namespace {

constexpr int TW = 128;   // output longitudes per block: 8 warps x 16 rows
constexpr int TBP = TUNE_TBP;   // input planes per block
constexpr int TAP = 8;    // taps per mma step; spans are padded to it
constexpr int CH = TUNE_CH;     // taps per staged piece of a slice
constexpr int THREADS = 256;
constexpr int STAGES = TUNE_STAGES;
constexpr int MIN_BLOCKS = TUNE_MIN_BLOCKS;
static_assert(THREADS % TBP == 0 && TBP % 2 == 0,
              "whole threads per plane window; planes in pairs");
static_assert(TW == 16 * (THREADS / 32), "8 warps of the mma's 16 rows");
static_assert(CH >= TAP && CH % TAP == 0, "whole mma steps per piece");
static_assert(STAGES >= 2, "a ring of at least two pieces");
// registers a thread may take at MIN_BLOCKS blocks an SM: the 4 * TBP
// accumulators and about 48 for fragments and addresses must fit
static_assert(MIN_BLOCKS >= 1 &&
                  65536 / (THREADS * MIN_BLOCKS) >= 4 * TBP + 48,
              "the accumulators fit the register budget");

struct Params {
    const float* x;
    const int* lat_idx;
    const int* tap_ptr;
    const int4* tap_ent;   // (s, d_lo, span, offset)
    const float* tap_psi;  // (T, 8)
    const int* row_order;
    float* out;
    int B, H_in, W_in, K, H_out, S, D, stride, W_out;
    int n_wt, n_pt;        // longitude tiles and plane tiles per row
    int vec;               // 16-byte loads (W_in % 4 == 0, x aligned)
};

__host__ __device__ constexpr int round_up(int v, int m) {
    return (v + m - 1) / m * m;
}

// Floats of one plane's window in a stage, and of one stage: a piece's
// psi (CH taps x 8), then TBP plane windows.
__host__ __device__ constexpr int window_floats(int stride) {
    return round_up((TW - 1) * stride + CH + 3, 4);
}
__host__ __device__ constexpr int stage_floats(int stride) {
    return CH * 8 + TBP * window_floats(stride);
}

// the ring at the compiled strides fits a block's 227 KB
static_assert(sizeof(float) * STAGES * stage_floats(2) <= 232448,
              "the ring fits a block's shared memory at stride 2");

// The slices are staged and contracted in pieces of at most CH taps: piece
// pc of slice e holds its taps [pc * CH, min((pc + 1) * CH, span)).
__device__ __forceinline__ void next_piece(const Params& p, int& e, int& pc) {
    if ((pc + 1) * CH < round_up(p.tap_ent[e].z, TAP)) {
        ++pc;
    } else {
        ++e;
        pc = 0;
    }
}

// Taps of piece pc of slice ent, and the input column of window position 0
// (the piece's first tap for output w0), aligned down to 4 floats with
// the remainder in shift when the window is read in 16-byte chunks.
struct Piece {
    int d0, taps, psi, c0, shift;
};

template <int STRIDE>
__device__ __forceinline__ Piece piece_of(const Params& p, int4 ent, int pc,
                                          int w0) {
    const int stride = STRIDE ? STRIDE : p.stride;
    Piece q;
    q.d0 = ent.y + pc * CH;
    q.taps = min(CH, round_up(ent.z, TAP) - pc * CH);
    q.psi = ent.w + pc * CH;
    int c0 = (w0 * stride + q.d0 - p.D / 2) % p.W_in;
    if (c0 < 0) c0 += p.W_in;
    q.shift = p.vec ? (c0 & 3) : 0;
    q.c0 = c0 - q.shift;
    return q;
}

// Issue the copies of piece pc of slice ent into stage buffer buf (psi
// then the windows).
template <int STRIDE>
__device__ __forceinline__ void stage_piece(const Params& p, float* buf,
                                            int4 ent, int pc, int h, int w0,
                                            int b0) {
    const int stride = STRIDE ? STRIDE : p.stride;
    const Piece q = piece_of<STRIDE>(p, ent, pc, w0);
    const int r = p.lat_idx[h * p.S + ent.x];
    const int ncols = q.shift + (TW - 1) * stride + q.taps;

    const float* psrc = p.tap_psi + (size_t)q.psi * 8;
    for (int i = threadIdx.x; i < q.taps * 2; i += THREADS)
        tf32x3::cp_async16(buf + 4 * i, psrc + 4 * i, true);

    // TPP threads copy each plane's window: no division per copy, and the
    // column wraps by a subtraction
    constexpr int TPP = THREADS / TBP;
    const int bb = threadIdx.x / TPP, k0 = threadIdx.x % TPP;
    const int b = b0 + bb;
    const bool ok = b < p.B;
    const float* row = p.x + ((size_t)(ok ? b : 0) * p.H_in + r) * p.W_in;
    float* xs = buf + CH * 8 + bb * window_floats(stride);
    const int width = p.vec ? 4 : 1;          // floats per copy
    const int n = p.vec ? (ncols + 3) >> 2 : ncols;
    int col = q.c0 + width * k0;
    while (col >= p.W_in) col -= p.W_in;
    for (int k = k0; k < n; k += TPP) {
        if (p.vec)
            tf32x3::cp_async16(xs + 4 * k, row + col, ok);
        else
            tf32x3::cp_async4(xs + k, row + col, ok);
        col += width * TPP;
        while (col >= p.W_in) col -= p.W_in;
    }
}

// STRIDE 1 or 2 fixes the window layout at compile time (the fcn3
// geometries); 0 reads the stride from p.
template <int STRIDE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
disco_band_kernel(const Params p) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int stride = STRIDE ? STRIDE : p.stride;
    const int xld = window_floats(stride);
    const int sf = stage_floats(stride);

    const int per_row = p.n_wt * p.n_pt;
    const int h = p.row_order[blockIdx.x / per_row];
    const int rem = blockIdx.x % per_row;
    const int w0 = (rem % p.n_wt) * TW;
    const int b0 = (rem / p.n_wt) * TBP;

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;

    float acc[TBP][4];
#pragma unroll
    for (int q = 0; q < TBP; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[q][i] = 0.f;

    // ring of STAGES pieces: piece i + STAGES - 1 is issued while piece i
    // is contracted; one barrier per piece
    const int e_end = p.tap_ptr[h + 1];
    int le = p.tap_ptr[h], lpc = 0;   // next piece to issue
    int ce = le, cpc = 0;             // next piece to contract
    for (int i = 0; i < STAGES - 1; ++i) {
        if (le < e_end) {
            stage_piece<STRIDE>(p, smem + i * sf, p.tap_ent[le], lpc, h, w0,
                                b0);
            next_piece(p, le, lpc);
        }
        tf32x3::cp_async_commit();
    }
    for (int i = 0; ce < e_end; ++i) {
        tf32x3::cp_async_wait<STAGES - 2>();
        __syncthreads();
        if (le < e_end) {
            stage_piece<STRIDE>(p, smem + ((i + STAGES - 1) % STAGES) * sf,
                        p.tap_ent[le], lpc, h, w0, b0);
            next_piece(p, le, lpc);
        }
        tf32x3::cp_async_commit();

        const Piece q = piece_of<STRIDE>(p, p.tap_ent[ce], cpc, w0);
        next_piece(p, ce, cpc);
        const float* ps = smem + (i % STAGES) * sf;
        // this lane's A column t for output row g of the warp's 16
        const float* xa = ps + CH * 8 + q.shift + (warp * 16 + g) * stride + t;
        const int r8 = 8 * stride;   // rows g and g + 8
        for (int k0 = 0; k0 < q.taps; k0 += TAP) {
            uint32_t bh0, bl0, bh1, bl1;
            tf32x3::split(ps[(k0 + t) * 8 + g], bh0, bl0);
            tf32x3::split(ps[(k0 + t + 4) * 8 + g], bh1, bl1);
#pragma unroll
            for (int j = 0; j < TBP; j += 2) {   // planes in pairs
                uint32_t ah[2][4], al[2][4];
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    const float* xq = xa + (j + u) * xld + k0;
                    tf32x3::split(xq[0], ah[u][0], al[u][0]);
                    tf32x3::split(xq[r8], ah[u][1], al[u][1]);
                    tf32x3::split(xq[4], ah[u][2], al[u][2]);
                    tf32x3::split(xq[r8 + 4], ah[u][3], al[u][3]);
                }
                tf32x3::mma3x2(acc[j], ah[0], al[0], acc[j + 1], ah[1], al[1],
                               bh0, bh1, bl0, bl1);
            }
        }
    }

    // c0 (w = g, k = 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
    const int wa = w0 + warp * 16 + g, wb = wa + 8;
    const size_t plane = (size_t)p.H_out * p.W_out;
#pragma unroll
    for (int q = 0; q < TBP; ++q) {
        const int b = b0 + q;
        if (b >= p.B) break;
        float* o = p.out + (size_t)b * p.K * plane + (size_t)h * p.W_out;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int k = 2 * t + i;
            if (k >= p.K) continue;
            if (wa < p.W_out) o[k * plane + wa] = acc[q][i];
            if (wb < p.W_out) o[k * plane + wb] = acc[q][2 + i];
        }
    }
}

template <int STRIDE>
int launch(const Params& p, cudaStream_t stream) {
    const int smem = (int)(sizeof(float) * STAGES * stage_floats(p.stride));
    cudaError_t e = cudaFuncSetAttribute(
        disco_band_kernel<STRIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    const long long blocks = (long long)p.H_out * p.n_wt * p.n_pt;
    disco_band_kernel<STRIDE><<<(unsigned)blocks, THREADS, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace

// The compiled tile: TW, TBP, CH, STAGES, MIN_BLOCKS, THREADS; returns how
// many it wrote (the wrapper reads its grid limits from here).
extern "C" int disco_band_constants(int* out) {
    const int v[] = {TW, TBP, CH, STAGES, MIN_BLOCKS, THREADS};
    for (int i = 0; i < 6; ++i) out[i] = v[i];
    return 6;
}

// Dynamic shared memory one block takes at `stride`, in bytes.
extern "C" long long disco_band_smem_bytes(int stride) {
    return (long long)sizeof(float) * STAGES * stage_floats(stride);
}

// x (B, H_in, W_in), lat_idx (H_out, S), the live taps tap_ptr (H_out + 1),
// tap_ent (E, 4), tap_psi (T, 8), row_order (H_out), out (B, K, H_out,
// W_in / stride); all contiguous.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a basis count outside 1..8).
extern "C" int disco_band_launch(const float* x, const int* lat_idx,
                                 const int* tap_ptr, const int* tap_ent,
                                 const float* tap_psi, const int* row_order,
                                 float* out, int B, int H_in, int W_in, int K,
                                 int H_out, int S, int D, int stride,
                                 void* stream) {
    if (K < 1 || K > 8) return (int)cudaErrorInvalidValue;
    Params p;
    p.x = x;
    p.lat_idx = lat_idx;
    p.tap_ptr = tap_ptr;
    p.tap_ent = reinterpret_cast<const int4*>(tap_ent);
    p.tap_psi = tap_psi;
    p.row_order = row_order;
    p.out = out;
    p.B = B;
    p.H_in = H_in;
    p.W_in = W_in;
    p.K = K;
    p.H_out = H_out;
    p.S = S;
    p.D = D;
    p.stride = stride;
    p.W_out = W_in / stride;
    p.n_wt = (p.W_out + TW - 1) / TW;
    p.n_pt = (B + TBP - 1) / TBP;
    p.vec = (W_in % 4 == 0) && ((uintptr_t)x % 16 == 0);
    cudaStream_t st = (cudaStream_t)stream;
    return stride == 1 ? launch<1>(p, st)
         : stride == 2 ? launch<2>(p, st)
                       : launch<0>(p, st);
}
