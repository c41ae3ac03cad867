// BN254 field arithmetic for the port's Hopper kernels.
//
// An element is 8 little-endian 32-bit words in Montgomery form with
// R = 2^256: the same 32 bytes that the host FrVec tier holds and the same
// residue as the JAX package's 16x16-bit limbs. Every function takes and
// returns canonical residues (< p), so results are byte-identical to any
// other exact implementation, whatever the order of the sums.
//
// Two moduli: Fr, the scalar field of the sumcheck kernels, and Fp, the
// base field of the G1 kernels (g1.cuh). The element type is one struct
// (`Fr`, named for the field the first kernels served); the modulus is a
// template parameter of the arithmetic, FrMod by default, so the Fr
// kernels read as before and compile to the same code. Both moduli are
// below 2^254, which every lazy step of field_ptx.cuh relies on (a sum of
// two canonical elements fits 255 bits; CIOS keeps t < 2p < 2^255).
//
// This header holds the element type, its loads and stores and the final
// conditional subtract; the arithmetic is field_ptx.cuh's carry chains.
#pragma once

#include <cstdint>

namespace zfr {

// r = 0x30644e72e131a029b85045b68181585d2833e84879b9709143e1f593f0000001
struct FrMod {
    static __device__ __forceinline__ uint32_t word(int i) {
        switch (i) {
            case 0: return 0xf0000001u;
            case 1: return 0x43e1f593u;
            case 2: return 0x79b97091u;
            case 3: return 0x2833e848u;
            case 4: return 0x8181585du;
            case 5: return 0xb85045b6u;
            case 6: return 0xe131a029u;
            default: return 0x30644e72u;
        }
    }
    static constexpr uint32_t INV = 0xefffffffu;    // -p^{-1} mod 2^32
    // R mod p: the Montgomery form of 1 (field_ptx.cuh r_mod_p)
    static __device__ __forceinline__ uint32_t one_word(int i) {
        switch (i) {
            case 0: return 0x4ffffffbu;
            case 1: return 0xac96341cu;
            case 2: return 0x9f60cd29u;
            case 3: return 0x36fc7695u;
            case 4: return 0x7879462eu;
            case 5: return 0x666ea36fu;
            case 6: return 0x9a07df2fu;
            default: return 0x0e0a77c1u;
        }
    }
};

// p = 0x30644e72e131a029b85045b68181585d97816a916871ca8d3c208c16d87cfd47
struct FpMod {
    static __device__ __forceinline__ uint32_t word(int i) {
        switch (i) {
            case 0: return 0xd87cfd47u;
            case 1: return 0x3c208c16u;
            case 2: return 0x6871ca8du;
            case 3: return 0x97816a91u;
            case 4: return 0x8181585du;
            case 5: return 0xb85045b6u;
            case 6: return 0xe131a029u;
            default: return 0x30644e72u;
        }
    }
    static constexpr uint32_t INV = 0xe4866389u;    // -p^{-1} mod 2^32
    // R mod p: the Montgomery form of 1
    static __device__ __forceinline__ uint32_t one_word(int i) {
        switch (i) {
            case 0: return 0xc58f0d9du;
            case 1: return 0xd35d438du;
            case 2: return 0xf5c70b3du;
            case 3: return 0x0a78eb28u;
            case 4: return 0x7879462cu;
            case 5: return 0x666ea36fu;
            case 6: return 0x9a07df2fu;
            default: return 0x0e0a77c1u;
        }
    }
};

struct Fr {
    uint32_t w[8];
};

__device__ __forceinline__ Fr zero() {
    Fr r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.w[i] = 0u;
    return r;
}

// 16-byte vector loads: an element is two uint4, neighbouring threads
// read neighbouring elements.
__device__ __forceinline__ Fr load(const uint32_t* base, long long idx) {
    const uint4* p = reinterpret_cast<const uint4*>(base + 8 * idx);
    uint4 a = p[0], b = p[1];
    Fr r;
    r.w[0] = a.x; r.w[1] = a.y; r.w[2] = a.z; r.w[3] = a.w;
    r.w[4] = b.x; r.w[5] = b.y; r.w[6] = b.z; r.w[7] = b.w;
    return r;
}

__device__ __forceinline__ void store(uint32_t* base, long long idx,
                                      const Fr& v) {
    uint4* p = reinterpret_cast<uint4*>(base + 8 * idx);
    p[0] = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
    p[1] = make_uint4(v.w[4], v.w[5], v.w[6], v.w[7]);
}

// t - p if (carry:t) >= p, else t.
template <class M = FrMod>
__device__ __forceinline__ Fr cond_sub_p(const Fr& t, uint32_t carry) {
    Fr d;
    int64_t borrow = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        int64_t s = (int64_t)t.w[i] - (int64_t)M::word(i) + borrow;
        d.w[i] = (uint32_t)s;
        borrow = s >> 32;            // 0 or -1
    }
    bool take = (borrow == 0) || (carry != 0);
    Fr r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.w[i] = take ? d.w[i] : t.w[i];
    return r;
}

}  // namespace zfr
