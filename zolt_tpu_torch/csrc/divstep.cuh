// The fixed-length divstep inverse of kernel F (field_inv.cu): x^{-1} mod p
// of one integer 0 <= x < p, with 0^{-1} = 0, for the BN254 moduli.
//
// Bernstein and Yang's "safegcd" (ePrint 2019/266) in the constant-time
// form of secp256k1's modinv32 (its half-delta divsteps, zeta = -(delta +
// 1/2)), on signed 30-bit limbs:
//   f = p, g = x, d = 0, e = 1, zeta = -1;
//   20 batches of 30 divsteps: each batch runs its divsteps on the low
//   words of f and g only and collects their 2x2 transition matrix
//   t = (u v; q r), |u| + |v| <= 2^30 and |q| + |r| <= 2^30; then
//     (f, g) <- t (f, g) / 2^30          (exact),
//     (d, e) <- t (d, e) / 2^30 mod p    (a multiple of p added so that
//                                         the division is exact),
//   as signed multiply-adds on the nine limbs, which keep the invariants
//   f = d x and g = e x mod p, and d, e in (-2p, p).
// 600 divsteps bring g to 0 for every x below 2^256 (the bound is 590,
// Bernstein and Yang's analysis as secp256k1 applies it); then f = +-1
// and d = +-x^{-1}, which the end negates and brings into [0, p). The
// batch count does not depend on x, so the lanes of a warp never diverge:
// every branch below is a mask.
//
// Plain integer C++ (32 x 32 -> 64-bit signed products, no PTX), so the
// same source compiles for the host: the Python model of it is
// field/inverse.py divstep_inverse_model, which the CPU tests hold to
// Python's pow.
#pragma once

#include <cstdint>

#ifndef ZFR_HD
#define ZFR_HD __device__ __forceinline__
#endif

namespace zfr {

constexpr int DIVSTEP_BATCH = 30;     // divsteps a transition matrix
constexpr int DIVSTEP_BATCHES = 20;   // 600 >= 590 divsteps
constexpr int32_t M30 = (int32_t)(0xffffffffu >> 2);

// A signed integer as nine limbs, Σ v[i]·2^(30 i): limbs 0-7 in
// [0, 2^30) once normalized, limb 8 signed.
struct S30 {
    int32_t v[9];
};

struct Trans {
    int32_t u, v, q, r;
};

// The moduli's limbs and p^{-1} mod 2^30.
struct FrDiv {
    static ZFR_HD int32_t p30(int i) {
        switch (i) {
            case 0: return 0x30000001;
            case 1: return 0x0f87d64f;
            case 2: return 0x1b970914;
            case 3: return 0x0cfa121e;
            case 4: return 0x01585d28;
            case 5: return 0x0116da06;
            case 6: return 0x1a029b85;
            case 7: return 0x139cb84c;
            default: return 0x3064;
        }
    }
    static constexpr uint32_t INV30 = 0x10000001u;
};

struct FpDiv {
    static ZFR_HD int32_t p30(int i) {
        switch (i) {
            case 0: return 0x187cfd47;
            case 1: return 0x3082305b;
            case 2: return 0x071ca8d3;
            case 3: return 0x205aa45a;
            case 4: return 0x01585d97;
            case 5: return 0x0116da06;
            case 6: return 0x1a029b85;
            case 7: return 0x139cb84c;
            default: return 0x3064;
        }
    }
    static constexpr uint32_t INV30 = 0x1b799c77u;
};

// 30 divsteps on the low words of f (odd) and g; returns the new zeta and
// the batch's matrix in t. Entries are kept mod 2^32: they lie in
// [-2^30, 2^30], so their casts to int32 are exact.
ZFR_HD int32_t divsteps_30(int32_t zeta, uint32_t f0, uint32_t g0,
                           Trans& t) {
    uint32_t u = 1u, v = 0u, q = 0u, r = 1u, f = f0, g = g0;
#pragma unroll
    for (int i = 0; i < DIVSTEP_BATCH; ++i) {
        // mask1: zeta < 0; mask2: g odd
        uint32_t mask1 = (uint32_t)(zeta >> 31);
        const uint32_t mask2 = 0u - (g & 1u);
        // g, q, r += (f, u, v), negated where zeta < 0, where g is odd
        const uint32_t x = (f ^ mask1) - mask1;
        const uint32_t y = (u ^ mask1) - mask1;
        const uint32_t z = (v ^ mask1) - mask1;
        g += x & mask2;
        q += y & mask2;
        r += z & mask2;
        // where zeta < 0 and g was odd: swap, zeta -> -zeta - 2; else
        // zeta -> zeta - 1
        mask1 &= mask2;
        zeta = (zeta ^ (int32_t)mask1) - 1;
        f += g & mask1;
        u += q & mask1;
        v += r & mask1;
        g >>= 1;
        u <<= 1;
        v <<= 1;
    }
    t.u = (int32_t)u;
    t.v = (int32_t)v;
    t.q = (int32_t)q;
    t.r = (int32_t)r;
    return zeta;
}

// (f, g) <- t (f, g) / 2^30: the low 30 bits of both products are zero.
ZFR_HD void update_fg(S30& f, S30& g, const Trans& t) {
    int64_t cf = (int64_t)t.u * f.v[0] + (int64_t)t.v * g.v[0];
    int64_t cg = (int64_t)t.q * f.v[0] + (int64_t)t.r * g.v[0];
    cf >>= 30;
    cg >>= 30;
#pragma unroll
    for (int i = 1; i < 9; ++i) {
        const int32_t fi = f.v[i], gi = g.v[i];
        cf += (int64_t)t.u * fi + (int64_t)t.v * gi;
        cg += (int64_t)t.q * fi + (int64_t)t.r * gi;
        f.v[i - 1] = (int32_t)cf & M30;
        g.v[i - 1] = (int32_t)cg & M30;
        cf >>= 30;
        cg >>= 30;
    }
    f.v[8] = (int32_t)cf;
    g.v[8] = (int32_t)cg;
}

// (d, e) <- (t (d, e) + p (md, me)) / 2^30, md and me chosen so that the
// low 30 bits are zero and d, e stay in (-2p, p).
template <class D>
ZFR_HD void update_de(S30& d, S30& e, const Trans& t) {
    const int32_t sd = d.v[8] >> 31, se = e.v[8] >> 31;
    int32_t md = (t.u & sd) + (t.v & se);
    int32_t me = (t.q & sd) + (t.r & se);
    int64_t cd = (int64_t)t.u * d.v[0] + (int64_t)t.v * e.v[0];
    int64_t ce = (int64_t)t.q * d.v[0] + (int64_t)t.r * e.v[0];
    md -= (int32_t)((D::INV30 * (uint32_t)cd + (uint32_t)md) & (uint32_t)M30);
    me -= (int32_t)((D::INV30 * (uint32_t)ce + (uint32_t)me) & (uint32_t)M30);
    cd += (int64_t)D::p30(0) * md;
    ce += (int64_t)D::p30(0) * me;
    cd >>= 30;
    ce >>= 30;
#pragma unroll
    for (int i = 1; i < 9; ++i) {
        const int32_t di = d.v[i], ei = e.v[i];
        cd += (int64_t)t.u * di + (int64_t)t.v * ei;
        ce += (int64_t)t.q * di + (int64_t)t.r * ei;
        cd += (int64_t)D::p30(i) * md;
        ce += (int64_t)D::p30(i) * me;
        d.v[i - 1] = (int32_t)cd & M30;
        e.v[i - 1] = (int32_t)ce & M30;
        cd >>= 30;
        ce >>= 30;
    }
    d.v[8] = (int32_t)cd;
    e.v[8] = (int32_t)ce;
}

// Carries limbs 0-7 into the next limb: limbs 0-7 into [0, 2^30).
ZFR_HD void carry30(S30& a) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        a.v[i + 1] += a.v[i] >> 30;
        a.v[i] &= M30;
    }
}

// a + p where a < 0 (its top limb's sign), limb by limb.
template <class D>
ZFR_HD void add_p_if_negative(S30& a) {
    const int32_t neg = a.v[8] >> 31;
#pragma unroll
    for (int i = 0; i < 9; ++i) a.v[i] += D::p30(i) & neg;
}

// d in (-2p, p) -> d·sign(f) mod p in [0, p).
template <class D>
ZFR_HD void normalize(S30& d, int32_t f_top) {
    add_p_if_negative<D>(d);
    const int32_t neg = f_top >> 31;
#pragma unroll
    for (int i = 0; i < 9; ++i) d.v[i] = (d.v[i] ^ neg) - neg;
    carry30(d);
    add_p_if_negative<D>(d);
    carry30(d);
}

// 8 little-endian 32-bit words (< 2^256) <-> nine 30-bit limbs.
ZFR_HD S30 s30_of_words(const uint32_t (&w)[8]) {
    S30 a;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
        const int bit = 30 * i, k = bit >> 5, s = bit & 31;
        uint64_t x = w[k] >> s;
        if (k + 1 < 8 && s > 2) x |= (uint64_t)w[k + 1] << (32 - s);
        a.v[i] = (int32_t)(x & (i < 8 ? (uint64_t)M30 : 0xffffu));
    }
    return a;
}

// A normalized a in [0, 2^256) -> 8 words. Word k starts at bit s <= 14
// of limb i, so limbs i and i + 1 hold its 32 bits.
ZFR_HD void words_of_s30(const S30& a, uint32_t (&w)[8]) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const int i = 32 * k / 30, s = 32 * k % 30;
        w[k] = (uint32_t)(((uint64_t)(uint32_t)a.v[i] >> s) |
                          ((uint64_t)(uint32_t)a.v[i + 1] << (30 - s)));
    }
}

// out = x^{-1} mod p (0 -> 0) for x < p, as 8 words.
template <class D>
ZFR_HD void divstep_inverse(const uint32_t (&x)[8], uint32_t (&out)[8]) {
    S30 f, g = s30_of_words(x), d, e;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
        f.v[i] = D::p30(i);
        d.v[i] = 0;
        e.v[i] = i == 0 ? 1 : 0;
    }
    int32_t zeta = -1;
#pragma unroll 1
    for (int b = 0; b < DIVSTEP_BATCHES; ++b) {
        Trans t;
        zeta = divsteps_30(zeta, (uint32_t)f.v[0], (uint32_t)g.v[0], t);
        update_de<D>(d, e, t);
        update_fg(f, g, t);
    }
    normalize<D>(d, f.v[8]);
    words_of_s30(d, out);
}

}  // namespace zfr
