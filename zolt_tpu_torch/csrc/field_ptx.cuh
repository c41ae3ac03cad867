// Word products of BN254 field elements as PTX carry chains.
//
// field.cuh multiplies with 64-bit C arithmetic, which the compiler lowers
// to a product and separate adds and compares per word. Here each row of a
// schoolbook product is one chain of mad.lo.cc / madc.hi.cc, where the
// carry rides in the flag register from word to word. A chain stays inside
// one asm statement: the flag does not survive between statements.
//
// Functions:
//   add_p, sub_p       a ± b mod p, canonical;
//   mont_mul(a, b)     a*b*R^{-1} mod p, canonical (CIOS, one REDC);
//   mac_wide(acc, a, b) acc += a*b as an unreduced 544-bit integer;
//   wide_term(acc, j)  the three Montgomery products whose sum mod p is
//                      acc*R^{-1}: one reduction for a whole sum of
//                      products;
//   mul_wide(x, acc, b) x = acc*b, a 544-bit sum times an element, kept
//                      as an 832-bit integer;
//   xwide_term(x, j)   the four Montgomery products whose sum mod p is
//                      x*R^{-2}.
// Their inputs are canonical (< p < 2^254). add_p, sub_p and mont_mul
// take the modulus as a template parameter (field.cuh: FrMod, the
// default, or FpMod); the wide sums serve the Fr kernels only.
#pragma once

#include "field.cuh"

namespace zfr {

// R mod p, R = 2^256: mont_mul(x, R mod p) is x mod p.
__device__ __forceinline__ Fr r_mod_p() {
    Fr r;
    r.w[0] = 0x4ffffffbu; r.w[1] = 0xac96341cu; r.w[2] = 0x9f60cd29u;
    r.w[3] = 0x36fc7695u; r.w[4] = 0x7879462eu; r.w[5] = 0x666ea36fu;
    r.w[6] = 0x9a07df2fu; r.w[7] = 0x0e0a77c1u;
    return r;
}

// R^{-1} mod p: mont_mul(x, R^{-1} mod p) is x*R^{-2} mod p.
__device__ __forceinline__ Fr rinv_mod_p() {
    Fr r;
    r.w[0] = 0x6db1194eu; r.w[1] = 0xdc5ba005u; r.w[2] = 0xe111ec87u;
    r.w[3] = 0x090ef5a9u; r.w[4] = 0xaeb85d5du; r.w[5] = 0xc8260de4u;
    r.w[6] = 0x82c5551cu; r.w[7] = 0x15ebf951u;
    return r;
}

// R^2 mod p: mont_mul(x, R^2 mod p) is x*R mod p.
__device__ __forceinline__ Fr r2_mod_p() {
    Fr r;
    r.w[0] = 0xae216da7u; r.w[1] = 0x1bb8e645u; r.w[2] = 0xe35c59e3u;
    r.w[3] = 0x53fe3ab1u; r.w[4] = 0x53bb8085u; r.w[5] = 0x8c49833du;
    r.w[6] = 0x7f4e44a5u; r.w[7] = 0x0216d0b1u;
    return r;
}

// t[O..O+7] += lo(a*b[j]); the carry out is added to t[O+8].
template <int O, int N>
__device__ __forceinline__ void mad_lo_row(uint32_t (&t)[N], uint32_t a,
                                           const uint32_t (&b)[8]) {
    static_assert(O + 8 < N, "row past the accumulator");
    asm("mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.lo.cc.u32 %1, %9, %11, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
        "madc.lo.cc.u32 %3, %9, %13, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %14, %4;\n\t"
        "madc.lo.cc.u32 %5, %9, %15, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %16, %6;\n\t"
        "madc.lo.cc.u32 %7, %9, %17, %7;\n\t"
        "addc.u32 %8, %8, 0;"
        : "+r"(t[O]), "+r"(t[O + 1]), "+r"(t[O + 2]), "+r"(t[O + 3]),
          "+r"(t[O + 4]), "+r"(t[O + 5]), "+r"(t[O + 6]), "+r"(t[O + 7]),
          "+r"(t[O + 8])
        : "r"(a), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]),
          "r"(b[5]), "r"(b[6]), "r"(b[7]));
}

// t[O+1..O+8] += hi(a*b[j]); the carry out is added to t[O+9].
template <int O, int N>
__device__ __forceinline__ void mad_hi_row(uint32_t (&t)[N], uint32_t a,
                                           const uint32_t (&b)[8]) {
    static_assert(O + 9 < N, "row past the accumulator");
    asm("mad.hi.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %11, %1;\n\t"
        "madc.hi.cc.u32 %2, %9, %12, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %13, %3;\n\t"
        "madc.hi.cc.u32 %4, %9, %14, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %15, %5;\n\t"
        "madc.hi.cc.u32 %6, %9, %16, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %17, %7;\n\t"
        "addc.u32 %8, %8, 0;"
        : "+r"(t[O + 1]), "+r"(t[O + 2]), "+r"(t[O + 3]), "+r"(t[O + 4]),
          "+r"(t[O + 5]), "+r"(t[O + 6]), "+r"(t[O + 7]), "+r"(t[O + 8]),
          "+r"(t[O + 9])
        : "r"(a), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]),
          "r"(b[5]), "r"(b[6]), "r"(b[7]));
}

template <class M>
__device__ __forceinline__ void p_words(uint32_t (&p)[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i] = M::word(i);
}

// a + b mod p: one carry chain for the sum, one borrow chain for sum − p,
// then a select.
template <class M = FrMod>
__device__ __forceinline__ Fr add_p(const Fr& a, const Fr& b) {
    uint32_t s[8], c, d[8], keep, p[8];
    p_words<M>(p);
    asm("add.cc.u32 %0, %9, %17;\n\t"
        "addc.cc.u32 %1, %10, %18;\n\t"
        "addc.cc.u32 %2, %11, %19;\n\t"
        "addc.cc.u32 %3, %12, %20;\n\t"
        "addc.cc.u32 %4, %13, %21;\n\t"
        "addc.cc.u32 %5, %14, %22;\n\t"
        "addc.cc.u32 %6, %15, %23;\n\t"
        "addc.cc.u32 %7, %16, %24;\n\t"
        "addc.u32 %8, %25, %25;"
        : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(s[4]),
          "=r"(s[5]), "=r"(s[6]), "=r"(s[7]), "=r"(c)
        : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]),
          "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(b.w[0]), "r"(b.w[1]),
          "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]),
          "r"(b.w[7]), "r"(0u));
    // keep = c − borrow(s − p): all ones when the sum is below p
    asm("sub.cc.u32 %0, %9, %18;\n\t"
        "subc.cc.u32 %1, %10, %19;\n\t"
        "subc.cc.u32 %2, %11, %20;\n\t"
        "subc.cc.u32 %3, %12, %21;\n\t"
        "subc.cc.u32 %4, %13, %22;\n\t"
        "subc.cc.u32 %5, %14, %23;\n\t"
        "subc.cc.u32 %6, %15, %24;\n\t"
        "subc.cc.u32 %7, %16, %25;\n\t"
        "subc.u32 %8, %17, 0;"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]),
          "=r"(d[5]), "=r"(d[6]), "=r"(d[7]), "=r"(keep)
        : "r"(s[0]), "r"(s[1]), "r"(s[2]), "r"(s[3]), "r"(s[4]), "r"(s[5]),
          "r"(s[6]), "r"(s[7]), "r"(c), "r"(p[0]), "r"(p[1]), "r"(p[2]),
          "r"(p[3]), "r"(p[4]), "r"(p[5]), "r"(p[6]), "r"(p[7]));
    Fr r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.w[i] = keep == 0xffffffffu ? s[i] : d[i];
    return r;
}

// c ? a : b, word by word, without a branch.
__device__ __forceinline__ Fr pick(bool c, const Fr& a, const Fr& b) {
    Fr r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.w[i] = c ? a.w[i] : b.w[i];
    return r;
}

// a − b mod p: one borrow chain, then p added back under the borrow's mask.
template <class M = FrMod>
__device__ __forceinline__ Fr sub_p(const Fr& a, const Fr& b) {
    uint32_t d[8], mask, p[8];
    p_words<M>(p);
    asm("sub.cc.u32 %0, %9, %17;\n\t"
        "subc.cc.u32 %1, %10, %18;\n\t"
        "subc.cc.u32 %2, %11, %19;\n\t"
        "subc.cc.u32 %3, %12, %20;\n\t"
        "subc.cc.u32 %4, %13, %21;\n\t"
        "subc.cc.u32 %5, %14, %22;\n\t"
        "subc.cc.u32 %6, %15, %23;\n\t"
        "subc.cc.u32 %7, %16, %24;\n\t"
        "subc.u32 %8, %25, %25;"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]),
          "=r"(d[5]), "=r"(d[6]), "=r"(d[7]), "=r"(mask)
        : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]),
          "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(b.w[0]), "r"(b.w[1]),
          "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]),
          "r"(b.w[7]), "r"(0u));
    asm("add.cc.u32 %0, %0, %8;\n\t"
        "addc.cc.u32 %1, %1, %9;\n\t"
        "addc.cc.u32 %2, %2, %10;\n\t"
        "addc.cc.u32 %3, %3, %11;\n\t"
        "addc.cc.u32 %4, %4, %12;\n\t"
        "addc.cc.u32 %5, %5, %13;\n\t"
        "addc.cc.u32 %6, %6, %14;\n\t"
        "addc.u32 %7, %7, %15;"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "r"(p[0] & mask), "r"(p[1] & mask), "r"(p[2] & mask),
          "r"(p[3] & mask), "r"(p[4] & mask), "r"(p[5] & mask),
          "r"(p[6] & mask), "r"(p[7] & mask));
    Fr r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.w[i] = d[i];
    return r;
}

// CIOS row i: t += a_i*b, then t += m*p with m = t[0]*(-p^{-1}) so that
// t[0] becomes 0, then t >>= 32. With t < 2p on entry every partial sum
// stays below 2^288, so t[9] is never set and the result is < 2p.
template <int I, class M>
__device__ __forceinline__ void cios_row(uint32_t (&t)[10], const Fr& a,
                                         const uint32_t (&b)[8],
                                         const uint32_t (&p)[8]) {
    mad_lo_row<0>(t, a.w[I], b);
    mad_hi_row<0>(t, a.w[I], b);
    const uint32_t m = t[0] * M::INV;
    mad_lo_row<0>(t, m, p);
    mad_hi_row<0>(t, m, p);
#pragma unroll
    for (int j = 0; j < 9; ++j) t[j] = t[j + 1];
    t[9] = 0u;
}

// a*b*R^{-1} mod p.
template <class M = FrMod>
__device__ __forceinline__ Fr mont_mul(const Fr& a, const Fr& b) {
    uint32_t t[10], p[8];
#pragma unroll
    for (int i = 0; i < 10; ++i) t[i] = 0u;
    p_words<M>(p);
    cios_row<0, M>(t, a, b.w, p);
    cios_row<1, M>(t, a, b.w, p);
    cios_row<2, M>(t, a, b.w, p);
    cios_row<3, M>(t, a, b.w, p);
    cios_row<4, M>(t, a, b.w, p);
    cios_row<5, M>(t, a, b.w, p);
    cios_row<6, M>(t, a, b.w, p);
    cios_row<7, M>(t, a, b.w, p);
    Fr r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.w[i] = t[i];
    return cond_sub_p<M>(r, t[8]);
}

// Words of an unreduced sum of products. A sum of m products of canonical
// elements is below m*p^2 < m*2^508; 17 words hold it for m < 2^36. The
// product evals sum one product per live pair of a table, and a table has
// fewer than 2^32 entries: 2^32 are 128 GiB, more than the card holds.
constexpr int WIDE = 17;

// t[0..16] = a*b (t[16] stays 0: the product is < 2^508).
template <int I>
__device__ __forceinline__ void product_row(uint32_t (&t)[WIDE], const Fr& a,
                                            const uint32_t (&b)[8]) {
    mad_lo_row<I>(t, a.w[I], b);
    mad_hi_row<I>(t, a.w[I], b);
}

// acc += a*b, unreduced.
__device__ __forceinline__ void mac_wide(uint32_t (&acc)[WIDE], const Fr& a,
                                         const Fr& b) {
    uint32_t t[WIDE];
#pragma unroll
    for (int i = 0; i < WIDE; ++i) t[i] = 0u;
    product_row<0>(t, a, b.w);
    product_row<1>(t, a, b.w);
    product_row<2>(t, a, b.w);
    product_row<3>(t, a, b.w);
    product_row<4>(t, a, b.w);
    product_row<5>(t, a, b.w);
    product_row<6>(t, a, b.w);
    product_row<7>(t, a, b.w);
    asm("add.cc.u32 %0, %0, %17;\n\t"
        "addc.cc.u32 %1, %1, %18;\n\t"
        "addc.cc.u32 %2, %2, %19;\n\t"
        "addc.cc.u32 %3, %3, %20;\n\t"
        "addc.cc.u32 %4, %4, %21;\n\t"
        "addc.cc.u32 %5, %5, %22;\n\t"
        "addc.cc.u32 %6, %6, %23;\n\t"
        "addc.cc.u32 %7, %7, %24;\n\t"
        "addc.cc.u32 %8, %8, %25;\n\t"
        "addc.cc.u32 %9, %9, %26;\n\t"
        "addc.cc.u32 %10, %10, %27;\n\t"
        "addc.cc.u32 %11, %11, %28;\n\t"
        "addc.cc.u32 %12, %12, %29;\n\t"
        "addc.cc.u32 %13, %13, %30;\n\t"
        "addc.cc.u32 %14, %14, %31;\n\t"
        "addc.cc.u32 %15, %15, %32;\n\t"
        "addc.u32 %16, %16, 0;"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]),
          "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]),
          "+r"(acc[8]), "+r"(acc[9]), "+r"(acc[10]), "+r"(acc[11]),
          "+r"(acc[12]), "+r"(acc[13]), "+r"(acc[14]), "+r"(acc[15]),
          "+r"(acc[16])
        : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]),
          "r"(t[6]), "r"(t[7]), "r"(t[8]), "r"(t[9]), "r"(t[10]),
          "r"(t[11]), "r"(t[12]), "r"(t[13]), "r"(t[14]), "r"(t[15]));
}

// acc*R^{-1} mod p for any 17-word acc: with acc = lo + mid*2^256 +
// hi*2^512, that is the sum mod p of three independent Montgomery
// products, wide_term(acc, 0..2): lo by 1, mid by R mod p, hi by R^2 mod p.
// CIOS takes any first operand below 2^256 when the second is below p. The
// operands are picked without a branch, so the lanes of a warp can compute
// the three terms in step.
__device__ __forceinline__ Fr wide_term(const uint32_t (&acc)[WIDE], int j) {
    const Fr r1 = r_mod_p(), r2 = r2_mod_p();
    Fr a, b;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const uint32_t hi = i == 0 ? acc[16] : 0u;
        a.w[i] = j == 0 ? acc[i] : j == 1 ? acc[8 + i] : hi;
        b.w[i] = j == 0 ? (i == 0 ? 1u : 0u) : j == 1 ? r1.w[i] : r2.w[i];
    }
    return mont_mul(a, b);
}

// Words of a 544-bit sum times an element: below 2^(544+256) = 2^800, and
// a sum of such products over fewer than 2^32 pairs stays below 2^832.
constexpr int XWIDE = 26;

// x += a[I..]*b row by row; row I's partial product ends below word I+9.
template <int I>
__device__ __forceinline__ void wide_rows(uint32_t (&x)[XWIDE],
                                          const uint32_t (&a)[WIDE],
                                          const uint32_t (&b)[8]) {
    if constexpr (I < WIDE) {
        mad_lo_row<I>(x, a[I], b);
        mad_hi_row<I>(x, a[I], b);
        wide_rows<I + 1>(x, a, b);
    }
}

// x = a*b for a 17-word a (x[25] stays 0).
__device__ __forceinline__ void mul_wide(uint32_t (&x)[XWIDE],
                                         const uint32_t (&a)[WIDE],
                                         const Fr& b) {
#pragma unroll
    for (int i = 0; i < XWIDE; ++i) x[i] = 0u;
    wide_rows<0>(x, a, b.w);
}

// x*R^{-2} mod p for any 26-word x: with x = x0 + x1*2^256 + x2*2^512 +
// x3*2^768, the sum mod p of four Montgomery products, xwide_term(x, 0..3):
// x0 by R^{-1} mod p, x1 by 1, x2 by R mod p and x3 by R^2 mod p. Picked
// without a branch, as in wide_term.
__device__ __forceinline__ Fr xwide_term(const uint32_t (&x)[XWIDE], int j) {
    const Fr ri = rinv_mod_p(), r1 = r_mod_p(), r2 = r2_mod_p();
    Fr a, b;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const uint32_t top = i < XWIDE - 24 ? x[24 + (i < 2 ? i : 0)] : 0u;
        a.w[i] = j == 0 ? x[i] : j == 1 ? x[8 + i] : j == 2 ? x[16 + i] : top;
        b.w[i] = j == 0 ? ri.w[i] : j == 1 ? (i == 0 ? 1u : 0u)
                 : j == 2 ? r1.w[i] : r2.w[i];
    }
    return mont_mul(a, b);
}

}  // namespace zfr
