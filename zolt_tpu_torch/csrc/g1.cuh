// BN254 G1 in Jacobian coordinates over Fp, for the port's G1 kernels.
//
// A point is (X, Y, Z), each 8 words of Fp Montgomery form (field.cuh);
// Z = 0 is the identity, and (X, Y, Z) is the affine (X/Z^2, Y/Z^3). The
// curve is y^2 = x^3 + 3 (a = 0), so the formulas are the EFD's a = 0
// ones: dbl-2009-l (7 products), add-2007-bl (16) and its mixed form
// madd-2007-bl with Z2 = 1 (11). The products are field_ptx.cuh's CIOS
// mont_mul over FpMod, called and not inlined: a product is some 640
// instructions, so a kernel that inlines the 11-16 of a point formula in
// a loop spans over 100 KB of code and misses the instruction cache. One
// called copy keeps a kernel's loop in the cache and its registers under
// 100: the same words out, and on an H100 kernel B 1.2x to 3.1x faster,
// the more so the more lanes a row (experiments/g1_kernels/run.sh).
//
// jac_double and jac_add give the words of the JAX package's pt_double and
// pt_add (zolt_tpu/curve/device.py) for every input: those compute every
// case and mask, because a TPU has no branches; here a thread branches on
// the identity, the doubling and the inverse, and computes the masked-out
// words only where JAX's output keeps them (the inverse case keeps the
// general formula's X and Y beside Z = 0). jac_add_affine only has to be
// the same group element: the row MSM and the Pippenger are held to the
// host tier in affine form.
#pragma once

#include "field_ptx.cuh"

namespace zg1 {

using Fe = zfr::Fr;

struct Jac {
    Fe x, y, z;
};

static __device__ __noinline__ Fe mul(const Fe& a, const Fe& b) {
    return zfr::mont_mul<zfr::FpMod>(a, b);
}
__device__ __forceinline__ Fe sqr(const Fe& a) { return mul(a, a); }
__device__ __forceinline__ Fe add(const Fe& a, const Fe& b) {
    return zfr::add_p<zfr::FpMod>(a, b);
}
__device__ __forceinline__ Fe sub(const Fe& a, const Fe& b) {
    return zfr::sub_p<zfr::FpMod>(a, b);
}
__device__ __forceinline__ Fe dbl(const Fe& a) { return add(a, a); }

__device__ __forceinline__ bool is_zero(const Fe& a) {
    uint32_t o = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) o |= a.w[i];
    return o == 0u;
}

__device__ __forceinline__ Fe fp_one() {
    Fe r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.w[i] = zfr::FpMod::one_word(i);
    return r;
}

__device__ __forceinline__ Jac identity() {
    Jac r;
    r.x = zfr::zero();
    r.y = zfr::zero();
    r.z = zfr::zero();
    return r;
}

// dbl-2009-l. The identity (Z = 0) maps to Z3 = 0, as in JAX.
__device__ __forceinline__ Jac jac_double(const Jac& p) {
    const Fe A = sqr(p.x), B = sqr(p.y), C = sqr(B);
    const Fe D = dbl(sub(sub(sqr(add(p.x, B)), A), C));
    const Fe E = add(dbl(A), A);
    const Fe F = sqr(E);
    Jac r;
    r.x = sub(F, dbl(D));
    r.y = sub(mul(E, sub(D, r.x)), dbl(dbl(dbl(C))));
    r.z = dbl(mul(p.y, p.z));
    return r;
}

// add-2007-bl with JAX's edge handling: P + O = P, O + Q = Q, P + P by
// doubling, P + (-P) = O (Z3 = 0 beside the general formula's X3, Y3).
__device__ __forceinline__ Jac jac_add(const Jac& a, const Jac& b) {
    if (is_zero(a.z)) return b;
    if (is_zero(b.z)) return a;
    const Fe Z1Z1 = sqr(a.z), Z2Z2 = sqr(b.z);
    const Fe U1 = mul(a.x, Z2Z2), U2 = mul(b.x, Z1Z1);
    const Fe S1 = mul(a.y, mul(b.z, Z2Z2));
    const Fe S2 = mul(b.y, mul(a.z, Z1Z1));
    const Fe H = sub(U2, U1);
    const Fe rr = dbl(sub(S2, S1));
    const bool h0 = is_zero(H);
    if (h0 && is_zero(rr)) return jac_double(a);
    const Fe I = sqr(dbl(H));
    const Fe J = mul(H, I);
    const Fe V = mul(U1, I);
    Jac r;
    r.x = sub(sub(sqr(rr), J), dbl(V));
    r.y = sub(mul(rr, sub(V, r.x)), dbl(mul(S1, J)));
    r.z = h0 ? zfr::zero()
             : mul(sub(sub(sqr(add(a.z, b.z)), Z1Z1), Z2Z2), H);
    return r;
}

// madd-2007-bl: a + (x2, y2, 1) for an affine point that is not the
// identity (the caller skips those).
__device__ __forceinline__ Jac jac_add_affine(const Jac& a, const Fe& x2,
                                              const Fe& y2) {
    if (is_zero(a.z)) {
        Jac r;
        r.x = x2;
        r.y = y2;
        r.z = fp_one();
        return r;
    }
    const Fe Z1Z1 = sqr(a.z);
    const Fe U2 = mul(x2, Z1Z1);
    const Fe S2 = mul(y2, mul(a.z, Z1Z1));
    const Fe H = sub(U2, a.x);
    const Fe rr = dbl(sub(S2, a.y));
    if (is_zero(H)) return is_zero(rr) ? jac_double(a) : identity();
    const Fe HH = sqr(H);
    const Fe I = dbl(dbl(HH));
    const Fe J = mul(H, I);
    const Fe V = mul(a.x, I);
    Jac r;
    r.x = sub(sub(sqr(rr), J), dbl(V));
    r.y = sub(mul(rr, sub(V, r.x)), dbl(mul(a.y, J)));
    r.z = sub(sub(sqr(add(a.z, H)), Z1Z1), HH);
    return r;
}

// The sum of a point over the 32 lanes of a warp, in lane 0 (the other
// lanes' results are partial). Every lane of the warp must call it.
__device__ __forceinline__ Jac warp_sum(Jac acc) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        Jac o;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            o.x.w[i] = __shfl_down_sync(0xffffffffu, acc.x.w[i], off);
            o.y.w[i] = __shfl_down_sync(0xffffffffu, acc.y.w[i], off);
            o.z.w[i] = __shfl_down_sync(0xffffffffu, acc.z.w[i], off);
        }
        acc = jac_add(acc, o);
    }
    return acc;
}

// A point as three (n, 8) word arrays.
__device__ __forceinline__ Jac load_jac(const uint32_t* x, const uint32_t* y,
                                        const uint32_t* z, long long i) {
    Jac r;
    r.x = zfr::load(x, i);
    r.y = zfr::load(y, i);
    r.z = zfr::load(z, i);
    return r;
}

__device__ __forceinline__ void store_jac(uint32_t* x, uint32_t* y,
                                          uint32_t* z, long long i,
                                          const Jac& p) {
    zfr::store(x, i, p.x);
    zfr::store(y, i, p.y);
    zfr::store(z, i, p.z);
}

}  // namespace zg1
