// Shared device helpers of the tensor-core kernels (legendre.cu,
// disco_band.cu): the 3xTF32 product on mma.sync.m16n8k8 and cp.async.
//
// 3xTF32 keeps fp32 accuracy on the TF32 tensor cores: each operand is
// split a = a_hi + a_lo with a_hi = a cut to TF32 (its 10 leading mantissa
// bits, one LOP) and a_lo = a - a_hi (exact in fp32, |a_lo| < 2^-10 |a|;
// the tensor core reads its 10 leading mantissa bits), and a*b is
// accumulated in fp32 as a_lo*b_hi + a_hi*b_lo + a_hi*b_hi.  The dropped
// a_lo*b_lo and the cut of the low parts leave < 3 * 2^-20 of |a*b| per
// product, against ~2^-11 for one plain TF32 product.  (cvt.rna.tf32.f32
// rounds instead of cutting, but it is not one fast instruction: both
// kernels ran slower with it on the H100.)
//
// Fragment layout of m16n8k8 (lane = 4 * g + t, g = lane / 4, t = lane % 4):
//   A (16 x 8, row-major):  a0 (g, t)   a1 (g + 8, t)   a2 (g, t + 4)   a3 (g + 8, t + 4)
//   B (8 x 8, k by n):      b0 (k = t, n = g)           b1 (k = t + 4, n = g)
//   C (16 x 8):             c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)

#pragma once

#include <cstdint>

namespace tf32x3 {

// v = hi + lo, both as the 32-bit registers the mma reads.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
    hi = __float_as_uint(v) & 0xffffe000u;
    lo = __float_as_uint(v - __uint_as_float(hi));
}

// v = hi + lo with hi rounded to the nearest TF32 value (ties away from
// zero: one more integer add than split).  |lo| <= 2^-11 |v|, half of
// split's bound, so the cut of lo and the dropped lo * lo leave ~2^-22 of
// |a*b| per product: ssd_bwd.cu takes it for sums that cancel.
__device__ __forceinline__ void split_rn(float v, uint32_t& hi, uint32_t& lo) {
    hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(v - __uint_as_float(hi));
}

// Not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32, the small cross terms first.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], uint32_t bhi0,
                                     uint32_t bhi1, uint32_t blo0,
                                     uint32_t blo1) {
    mma(c, alo, bhi0, bhi1);
    mma(c, ahi, blo0, blo1);
    mma(c, ahi, bhi0, bhi1);
}

// Two products that share b, interleaved so that no mma waits on the one
// before it: c += a * b and d += e * b.
__device__ __forceinline__ void mma3x2(float (&c)[4], const uint32_t (&ahi)[4],
                                       const uint32_t (&alo)[4], float (&d)[4],
                                       const uint32_t (&ehi)[4],
                                       const uint32_t (&elo)[4], uint32_t bhi0,
                                       uint32_t bhi1, uint32_t blo0,
                                       uint32_t blo1) {
    mma(c, alo, bhi0, bhi1);
    mma(d, elo, bhi0, bhi1);
    mma(c, ahi, blo0, blo1);
    mma(d, ehi, blo0, blo1);
    mma(c, ahi, bhi0, bhi1);
    mma(d, ehi, bhi0, bhi1);
}

// Asynchronous copies global -> shared; with ok == false nothing is read
// and the destination is zero-filled (src-size 0).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    const int n = ok ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool ok) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    const int n = ok ? 4 : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tf32x3
