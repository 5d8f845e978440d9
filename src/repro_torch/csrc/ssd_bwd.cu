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
// cs[l] - cs[s] is positive and may overflow, so exp is taken only where
// s <= l and the masked taps are exactly 0, never inf * 0.
//
// Bound on the H100: operations.  At the mamba2-130m prefill shape (BC =
// 512, L = 128, H = 24, P = 64, G = 1, N = 128) the data needs 8.08e10
// FLOPs (kernels/ssd/ops.py::bwd_work: per head att^T dy and dy X^T on
// the causal taps, B dst^T and (w X) dst whole, per group C B^T again
// and dCB B, dCB^T C on the causal taps) and moves 1.76 GB (x, da_cs, B,
// C, dy, dst in; dx, dda_cs, dB, dC out): 1.21 ms at the fp32 CUDA-core
// rate, 0.49 ms in 3xTF32 on the tensor cores, 0.52 ms for the bytes.
//
// Measured (chip_smoke.py's [lm-train] (b), one H100 80GB HBM3 at 700 W):
// 10.6 ms at the prefill shape, 8.8x that bound: the first, simple
// design below, in fp32 on the CUDA cores.
//
// Design: a simple kernel that is right, in fp32 on the CUDA cores, in
// four launches on the caller's stream, each a block of 256 threads with
// register tiles over shared memory (row pitches of an odd number of
// floats: a warp's rows fall on distinct banks):
//   1. cb:    per (chunk, group), C B^T -> scratch cb (BC, G, L, L), zero
//             above the diagonal (recomputed here, not saved by the
//             forward);
//   2. head:  per (chunk, head), with CB, X, dy and cs staged: the att^T
//             dy part of dX; datt, dCB_h = datt * decay -> scratch dcbh
//             (BC, H, L, L); dcs's decay part, its row sums by shuffles
//             and its column sums through one partial a warp, added in
//             warp order;
//   3. group: per (chunk, group), dCB_g = sum of the group's dcbh in
//             head order, then dC = dCB_g B and dB = dCB_g^T C;
//   4. state: per (chunk, group), the group's heads in order: B dst^T,
//             w (B dst^T) added to dX, dw and dcs's w part, and sum_h
//             (w_h X_h) dst_h accumulated in registers over the heads,
//             added to dB at the end.
// dB and dC sum over the heads of a group in one fixed order (the heads
// of a group are never split over blocks of steps 3 and 4, whatever
// their number: zamba2-2.7b's 80 heads go through one block a chunk),
// every partial is added in a fixed order, and no step uses atomics: the
// gradients are the same from run to run.  The sums that cancel (dcs's
// rows against its columns, dCB over up to 80 heads of either sign) are
// taken in double, rounded to float once.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int L_MAX = 128;    // chunk length; L_MAX in kernels/ssd/ops.py
constexpr int P_MAX = 64;     // head dim
constexpr int N_MAX = 128;    // state dim
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LL = L_MAX + 1;     // row pitch of an L x L tile: 129
constexpr int XL = P_MAX + 1;     // row pitch of an L x P tile: 65
constexpr int NL = N_MAX + 1;     // row pitch of an L x N or P x N tile

// shared memory of each step, in floats
constexpr int CB_SMEM = 2 * L_MAX * NL;
// (the column and row sums of dcs: doubles, two floats each)
constexpr int HEAD_SMEM = L_MAX * LL + 2 * L_MAX * XL + L_MAX +
                          2 * (WARPS * L_MAX + L_MAX);
constexpr int GROUP_SMEM = L_MAX * LL + 2 * L_MAX * NL;
constexpr int STATE_SMEM = L_MAX * NL + L_MAX * XL + P_MAX * NL + 2 * L_MAX +
                           1;

static_assert(THREADS == 256, "the register tiles below take 256 threads");
static_assert(L_MAX == 128 && P_MAX == 64 && N_MAX == 128,
              "the register tiles below cover these sizes");
static_assert(sizeof(float) * GROUP_SMEM <= 232448 &&
              sizeof(float) * HEAD_SMEM <= 232448 &&
              sizeof(float) * STATE_SMEM <= 232448 &&
              sizeof(float) * CB_SMEM <= 232448, "one block an SM");

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
    float* cb;      // scratch (BC, G, L, L)
    float* dcbh;    // scratch (BC, H, L, L)
    int L, H, P, G, N;
};

// rows x cols of a row-major source (row pitch `pitch` floats) into
// shared memory (row pitch ld) over rows_max x cols_max, zero outside.
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      long long pitch, int rows, int cols,
                                      int rows_max, int cols_max) {
    for (int e = threadIdx.x; e < rows_max * cols_max; e += THREADS) {
        const int r = e / cols_max, j = e % cols_max;
        dst[r * ld + j] = (r < rows && j < cols) ? src[r * pitch + j] : 0.f;
    }
}

// the sum over the `width` lanes of each aligned group, in a fixed
// butterfly
template <typename T>
__device__ __forceinline__ T group_sum(T v, int width) {
    for (int off = width / 2; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// 1. cb[bc, g] = C B^T, zero above the diagonal.  Thread t: rows l = t /
// 16 + 16 a and columns s = t % 16 + 16 b, a, b < 8.
__global__ void __launch_bounds__(THREADS)
ssd_bwd_cb(const Params p) {
    extern __shared__ float4 smem4[];
    float* cs_ = reinterpret_cast<float*>(smem4);   // C [L_MAX][NL]
    float* bs = cs_ + L_MAX * NL;                    // B [L_MAX][NL]
    const long long bc = blockIdx.x / p.G;
    const int g = blockIdx.x % p.G;
    const int L = p.L, N = p.N;
    const long long pitch = (long long)p.G * N;
    stage(cs_, NL, p.c + (bc * L * p.G + g) * (long long)N, pitch, L, N,
          L_MAX, N_MAX);
    stage(bs, NL, p.b + (bc * L * p.G + g) * (long long)N, pitch, L, N,
          L_MAX, N_MAX);
    __syncthreads();
    const int i = threadIdx.x / 16, j = threadIdx.x % 16;
    float acc[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
    for (int n = 0; n < N; ++n) {
        float cv[8], bv[8];
#pragma unroll
        for (int a = 0; a < 8; ++a) cv[a] = cs_[(i + 16 * a) * NL + n];
#pragma unroll
        for (int b = 0; b < 8; ++b) bv[b] = bs[(j + 16 * b) * NL + n];
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(cv[a], bv[b], acc[a][b]);
    }
    float* out = p.cb + (bc * p.G + g) * (long long)L * L;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
        const int l = i + 16 * a;
        if (l >= L) continue;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
            const int s = j + 16 * b;
            if (s < L) out[l * L + s] = s <= l ? acc[a][b] : 0.f;
        }
    }
}

// 2. Per (chunk, head): the att^T dy part of dX, dCB_h into dcbh and the
// decay part of dcs.
__global__ void __launch_bounds__(THREADS)
ssd_bwd_head(const Params p) {
    extern __shared__ float4 smem4[];
    float* cbs = reinterpret_cast<float*>(smem4);   // CB [L_MAX][LL]
    float* xs = cbs + L_MAX * LL;                    // X  [L_MAX][XL]
    float* dys = xs + L_MAX * XL;                    // dy [L_MAX][XL]
    float* cs = dys + L_MAX * XL;                    // cs [L_MAX]
    // at an even float offset: 8-byte aligned
    double* colp = reinterpret_cast<double*>(cs + L_MAX);  // [WARPS][L_MAX]
    double* rows = colp + WARPS * L_MAX;             // [L_MAX]
    const long long bc = blockIdx.x / p.H;
    const int h = blockIdx.x % p.H;
    const int g = h / (p.H / p.G);
    const int L = p.L, P = p.P, H = p.H;
    const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
    stage(cbs, LL, p.cb + (bc * p.G + g) * (long long)L * L, L, L, L, L_MAX,
          L_MAX);
    const long long xoff = (bc * L * H + h) * (long long)P;
    stage(xs, XL, p.x + xoff, (long long)H * P, L, P, L_MAX, P_MAX);
    stage(dys, XL, p.dy + xoff, (long long)H * P, L, P, L_MAX, P_MAX);
    for (int l = t; l < L_MAX; l += THREADS)
        cs[l] = l < L ? p.da_cs[(bc * L + l) * H + h] : 0.f;
    __syncthreads();

    {   // dX[s, p] = sum_{l >= s} att[l, s] dy[l, p]: s = t / 8 + 32 a
        // (a < 4), p = t % 8 + 8 b (b < 8)
        const int si = t / 8, pj = t % 8;
        float acc[4][8], csv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            csv[a] = cs[si + 32 * a];
#pragma unroll
            for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
        }
        for (int l = si; l < L; ++l) {
            const float csl = cs[l];
            float att[4], dv[8];
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                const int s = si + 32 * a;
                // the mask first: exp only where s <= l
                att[a] = s <= l ? cbs[l * LL + s] * __expf(csl - csv[a]) : 0.f;
            }
#pragma unroll
            for (int b = 0; b < 8; ++b) dv[b] = dys[l * XL + pj + 8 * b];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int b = 0; b < 8; ++b)
                    acc[a][b] = fmaf(att[a], dv[b], acc[a][b]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            const int s = si + 32 * a;
            if (s >= L) continue;
            float* dxr = p.dx + ((bc * L + s) * H + h) * (long long)P;
#pragma unroll
            for (int b = 0; b < 8; ++b) {
                const int pp = pj + 8 * b;
                if (pp < P) dxr[pp] = acc[a][b];
            }
        }
    }

    {   // datt[l, s] = sum_p dy[l, p] X[s, p]: l = t / 16 + 16 a, s = t %
        // 16 + 16 b (a, b < 8)
        const int li = t / 16, sj = t % 16;
        float acc[8][8];
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
        for (int pp = 0; pp < P; ++pp) {
            float dv[8], xv[8];
#pragma unroll
            for (int a = 0; a < 8; ++a) dv[a] = dys[(li + 16 * a) * XL + pp];
#pragma unroll
            for (int b = 0; b < 8; ++b) xv[b] = xs[(sj + 16 * b) * XL + pp];
#pragma unroll
            for (int a = 0; a < 8; ++a)
#pragma unroll
                for (int b = 0; b < 8; ++b)
                    acc[a][b] = fmaf(dv[a], xv[b], acc[a][b]);
        }
        // the sums of M in double: its row and column sums cancel
        // (dcs = rows - columns), and each adds 128 terms of either sign
        double rowp[8], colr[8];
#pragma unroll
        for (int b = 0; b < 8; ++b) colr[b] = 0.0;
        float* out = p.dcbh + (bc * H + h) * (long long)L * L;
#pragma unroll
        for (int a = 0; a < 8; ++a) {
            const int l = li + 16 * a;
            rowp[a] = 0.0;
#pragma unroll
            for (int b = 0; b < 8; ++b) {
                const int s = sj + 16 * b;
                const bool tap = l < L && s <= l;
                const float dcb = tap ? acc[a][b] * __expf(cs[l] - cs[s]) : 0.f;
                const float m = dcb * cbs[l * LL + s];
                rowp[a] += m;
                colr[b] += m;
                if (l < L && s < L) out[l * L + s] = dcb;
            }
        }
        // row sums: over the 16 lanes of the same li; column sums: over
        // the two li of a warp, then over the warps in order
#pragma unroll
        for (int a = 0; a < 8; ++a) {
            const double r = group_sum(rowp[a], 16);
            if (sj == 0) rows[li + 16 * a] = r;
        }
#pragma unroll
        for (int b = 0; b < 8; ++b) {
            const double c = colr[b] +
                             __shfl_xor_sync(0xffffffffu, colr[b], 16);
            if (lane < 16) colp[warp * L_MAX + sj + 16 * b] = c;
        }
    }
    __syncthreads();
    for (int l = t; l < L; l += THREADS) {
        double c = 0.0;
        for (int w = 0; w < WARPS; ++w) c += colp[w * L_MAX + l];
        p.dda[(bc * L + l) * H + h] = (float)(rows[l] - c);
    }
}

// 3. Per (chunk, group): dCB_g, then dC = dCB_g B and dB = dCB_g^T C.
__global__ void __launch_bounds__(THREADS)
ssd_bwd_group(const Params p) {
    extern __shared__ float4 smem4[];
    float* ds = reinterpret_cast<float*>(smem4);    // dCB_g [L_MAX][LL]
    float* bs = ds + L_MAX * LL;                     // B [L_MAX][NL]
    float* cs_ = bs + L_MAX * NL;                    // C [L_MAX][NL]
    const long long bc = blockIdx.x / p.G;
    const int g = blockIdx.x % p.G;
    const int L = p.L, N = p.N, rep = p.H / p.G;
    const int t = threadIdx.x;
    const float* src = p.dcbh + (bc * p.H + (long long)g * rep) * L * L;
    for (int e = t; e < L_MAX * L_MAX; e += THREADS) {
        const int l = e / L_MAX, s = e % L_MAX;
        double v = 0.0;   // up to 80 heads of either sign
        if (l < L && s < L)
            for (int k = 0; k < rep; ++k)    // the heads in order
                v += src[(long long)k * L * L + l * L + s];
        ds[l * LL + s] = (float)v;
    }
    const long long pitch = (long long)p.G * N;
    const long long off = (bc * L * p.G + g) * (long long)N;
    stage(bs, NL, p.b + off, pitch, L, N, L_MAX, N_MAX);
    stage(cs_, NL, p.c + off, pitch, L, N, L_MAX, N_MAX);
    __syncthreads();
    const int ri = t / 16, nj = t % 16;
    {   // dC[l, n] = sum_{s <= l} dCB[l, s] B[s, n]
        float acc[8][8];
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
        for (int s = 0; s < L; ++s) {
            float dv[8], bv[8];
#pragma unroll
            for (int a = 0; a < 8; ++a) dv[a] = ds[(ri + 16 * a) * LL + s];
#pragma unroll
            for (int b = 0; b < 8; ++b) bv[b] = bs[s * NL + nj + 16 * b];
#pragma unroll
            for (int a = 0; a < 8; ++a)
#pragma unroll
                for (int b = 0; b < 8; ++b)
                    acc[a][b] = fmaf(dv[a], bv[b], acc[a][b]);
        }
#pragma unroll
        for (int a = 0; a < 8; ++a) {
            const int l = ri + 16 * a;
            if (l >= L) continue;
            float* o = p.dc + ((bc * L + l) * p.G + g) * (long long)N;
#pragma unroll
            for (int b = 0; b < 8; ++b) {
                const int n = nj + 16 * b;
                if (n < N) o[n] = acc[a][b];
            }
        }
    }
    {   // dB[s, n] = sum_{l >= s} dCB[l, s] C[l, n]
        float acc[8][8];
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
        for (int l = 0; l < L; ++l) {
            float dv[8], cv[8];
#pragma unroll
            for (int a = 0; a < 8; ++a) dv[a] = ds[l * LL + ri + 16 * a];
#pragma unroll
            for (int b = 0; b < 8; ++b) cv[b] = cs_[l * NL + nj + 16 * b];
#pragma unroll
            for (int a = 0; a < 8; ++a)
#pragma unroll
                for (int b = 0; b < 8; ++b)
                    acc[a][b] = fmaf(dv[a], cv[b], acc[a][b]);
        }
#pragma unroll
        for (int a = 0; a < 8; ++a) {
            const int s = ri + 16 * a;
            if (s >= L) continue;
            float* o = p.db + ((bc * L + s) * p.G + g) * (long long)N;
#pragma unroll
            for (int b = 0; b < 8; ++b) {
                const int n = nj + 16 * b;
                if (n < N) o[n] = acc[a][b];
            }
        }
    }
}

// 4. Per (chunk, group), the group's heads in order: the state's part of
// dX, dcs and dB.
__global__ void __launch_bounds__(THREADS)
ssd_bwd_state(const Params p) {
    extern __shared__ float4 smem4[];
    float* bs = reinterpret_cast<float*>(smem4);    // B [L_MAX][NL]
    float* xs = bs + L_MAX * NL;                     // X [L_MAX][XL]
    float* qs = xs + L_MAX * XL;                     // dst [P_MAX][NL]
    float* cs = qs + P_MAX * NL;                     // cs [L_MAX]
    float* tw = cs + L_MAX;                          // dw * w [L_MAX]
    float* tot = tw + L_MAX;                         // sum of tw [1]
    const long long bc = blockIdx.x / p.G;
    const int g = blockIdx.x % p.G;
    const int L = p.L, P = p.P, N = p.N, H = p.H, rep = H / p.G;
    const int t = threadIdx.x, lane = t & 31;
    stage(bs, NL, p.b + (bc * L * p.G + g) * (long long)N,
          (long long)p.G * N, L, N, L_MAX, N_MAX);
    // sum_h (w_h X_h) dst_h: s = t / 16 + 16 a, n = t % 16 + 16 b
    const int ri = t / 16, nj = t % 16;
    float accb[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) accb[a][b] = 0.f;
    for (int k = 0; k < rep; ++k) {
        const int h = g * rep + k;
        __syncthreads();   // the previous head is consumed
        stage(xs, XL, p.x + (bc * L * H + h) * (long long)P, (long long)H * P,
              L, P, L_MAX, P_MAX);
        stage(qs, NL, p.dst + (bc * H + h) * (long long)P * N, N, P, N, P_MAX,
              N_MAX);
        for (int l = t; l < L_MAX; l += THREADS)
            cs[l] = l < L ? p.da_cs[(bc * L + l) * H + h] : 0.f;
        __syncthreads();
        const float cs_end = cs[L - 1];
        {   // U = B dst^T: s = t / 8 + 32 a (a < 4), p = t % 8 + 8 b
            const int si = t / 8, pj = t % 8;
            float u[4][8];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int b = 0; b < 8; ++b) u[a][b] = 0.f;
            for (int n = 0; n < N; ++n) {
                float bv[4], qv[8];
#pragma unroll
                for (int a = 0; a < 4; ++a) bv[a] = bs[(si + 32 * a) * NL + n];
#pragma unroll
                for (int b = 0; b < 8; ++b) qv[b] = qs[(pj + 8 * b) * NL + n];
#pragma unroll
                for (int a = 0; a < 4; ++a)
#pragma unroll
                    for (int b = 0; b < 8; ++b)
                        u[a][b] = fmaf(bv[a], qv[b], u[a][b]);
            }
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                const int s = si + 32 * a;
                const float w = s < L ? __expf(cs_end - cs[s]) : 0.f;
                float dw = 0.f;
#pragma unroll
                for (int b = 0; b < 8; ++b)
                    dw = fmaf(xs[s * XL + pj + 8 * b], u[a][b], dw);
                dw = group_sum(dw, 8);
                if (pj == 0) tw[s] = dw * w;
                if (s < L) {
                    float* dxr = p.dx + ((bc * L + s) * H + h) * (long long)P;
#pragma unroll
                    for (int b = 0; b < 8; ++b) {
                        const int pp = pj + 8 * b;
                        if (pp < P) dxr[pp] = fmaf(w, u[a][b], dxr[pp]);
                    }
                }
            }
        }
        {   // accb += (w X) dst
            float wv[8];
#pragma unroll
            for (int a = 0; a < 8; ++a) {
                const int s = ri + 16 * a;
                wv[a] = s < L ? __expf(cs_end - cs[s]) : 0.f;
            }
            for (int pp = 0; pp < P; ++pp) {
                float xv[8], qv[8];
#pragma unroll
                for (int a = 0; a < 8; ++a)
                    xv[a] = xs[(ri + 16 * a) * XL + pp] * wv[a];
#pragma unroll
                for (int b = 0; b < 8; ++b) qv[b] = qs[pp * NL + nj + 16 * b];
#pragma unroll
                for (int a = 0; a < 8; ++a)
#pragma unroll
                    for (int b = 0; b < 8; ++b)
                        accb[a][b] = fmaf(xv[a], qv[b], accb[a][b]);
            }
        }
        __syncthreads();   // tw is complete
        if (t < 32) {      // its sum over l in a fixed order
            double v = 0.0;
            for (int l = lane; l < L; l += 32) v += tw[l];
            v = group_sum(v, 32);
            if (lane == 0) *tot = (float)v;
        }
        __syncthreads();
        for (int l = t; l < L; l += THREADS) {
            float* d = p.dda + (bc * L + l) * H + h;
            *d = *d - tw[l] + (l == L - 1 ? *tot : 0.f);
        }
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
        const int s = ri + 16 * a;
        if (s >= L) continue;
        float* o = p.db + ((bc * L + s) * p.G + g) * (long long)N;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
            const int n = nj + 16 * b;
            if (n < N) o[n] += accb[a][b];
        }
    }
}

}  // namespace

// The compiled constants: L_MAX, P_MAX, N_MAX; returns how many it wrote.
extern "C" int ssd_bwd_constants(int* out) {
    const int v[] = {L_MAX, P_MAX, N_MAX};
    for (int i = 0; i < 3; ++i) out[i] = v[i];
    return 3;
}

// x, dy (BC, L, H, P), da_cs (BC, L, H), b_mat, c_mat (BC, L, G, N), dst
// (BC, H, P, N) -> dx (BC, L, H, P), dda (BC, L, H), db, dc (BC, L, G,
// N); scratch cb (BC * G * L * L floats) and dcbh (BC * H * L * L).  All
// contiguous fp32.  Takes 1 <= L <= 128, P <= 64, N <= 128 and H % G ==
// 0 (the wrapper checks).  Returns cudaGetLastError() after the launches.
extern "C" int ssd_bwd_launch(const float* x, const float* da_cs,
                              const float* b_mat, const float* c_mat,
                              const float* dy, const float* dst, float* dx,
                              float* dda, float* db, float* dc, float* cb,
                              float* dcbh, long long BC, int L, int H, int P,
                              int G, int N, void* stream) {
    if (BC < 1 || L < 1 || L > L_MAX || P < 1 || P > P_MAX || N < 1 ||
        N > N_MAX || G < 1 || H % G != 0)
        return (int)cudaErrorInvalidValue;
    if (BC * H > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
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
    p.cb = cb;
    p.dcbh = dcbh;
    p.L = L;
    p.H = H;
    p.P = P;
    p.G = G;
    p.N = N;
    const cudaStream_t s = (cudaStream_t)stream;
    const size_t cb_bytes = sizeof(float) * CB_SMEM;
    const size_t head_bytes = sizeof(float) * HEAD_SMEM;
    const size_t group_bytes = sizeof(float) * GROUP_SMEM;
    const size_t state_bytes = sizeof(float) * STATE_SMEM;
    // above 48 KB of dynamic shared memory; set on every call (cheap), so
    // each device the kernels run on has it
    cudaError_t err;
    if ((err = cudaFuncSetAttribute(
             ssd_bwd_cb, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)cb_bytes)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             ssd_bwd_head, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)head_bytes)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             ssd_bwd_group, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)group_bytes)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             ssd_bwd_state, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)state_bytes)) != cudaSuccess)
        return (int)err;
    const unsigned groups = (unsigned)(BC * G), heads = (unsigned)(BC * H);
    ssd_bwd_cb<<<groups, THREADS, cb_bytes, s>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_bwd_head<<<heads, THREADS, head_bytes, s>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_bwd_group<<<groups, THREADS, group_bytes, s>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_bwd_state<<<groups, THREADS, state_bytes, s>>>(p);
    return (int)cudaGetLastError();
}
