// BN254 scalar-field arithmetic for the port's Hopper kernels.
//
// An element is 8 little-endian 32-bit words in Montgomery form with
// R = 2^256: the same 32 bytes that the host FrVec tier holds and the same
// residue as the JAX package's 16x16-bit limbs. Every function takes and
// returns canonical residues (< p), so results are byte-identical to any
// other exact implementation, whatever the order of the sums.
//
// Multiplication is CIOS Montgomery (separated operand scanning with the
// reduction interleaved) on 32-bit words with 64-bit products, all in
// registers. p < 2^254, so the CIOS accumulator never needs a ninth word
// beyond one carry bit and the result is < 2p before the final subtract.
#pragma once

#include <cstdint>

namespace zfr {

// p = 0x30644e72e131a029b85045b68181585d2833e84879b9709143e1f593f0000001
__device__ __forceinline__ uint32_t p_word(int i) {
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

// -p^{-1} mod 2^32
constexpr uint32_t P_INV = 0xefffffffu;

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
__device__ __forceinline__ Fr cond_sub_p(const Fr& t, uint32_t carry) {
    Fr d;
    int64_t borrow = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        int64_t s = (int64_t)t.w[i] - (int64_t)p_word(i) + borrow;
        d.w[i] = (uint32_t)s;
        borrow = s >> 32;            // 0 or -1
    }
    bool take = (borrow == 0) || (carry != 0);
    Fr r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.w[i] = take ? d.w[i] : t.w[i];
    return r;
}

__device__ __forceinline__ Fr add(const Fr& a, const Fr& b) {
    Fr s;
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        uint64_t v = (uint64_t)a.w[i] + b.w[i] + c;
        s.w[i] = (uint32_t)v;
        c = v >> 32;
    }
    return cond_sub_p(s, (uint32_t)c);
}

__device__ __forceinline__ Fr sub(const Fr& a, const Fr& b) {
    Fr d;
    int64_t borrow = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        int64_t s = (int64_t)a.w[i] - (int64_t)b.w[i] + borrow;
        d.w[i] = (uint32_t)s;
        borrow = s >> 32;
    }
    if (borrow != 0) {
        uint64_t c = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            uint64_t v = (uint64_t)d.w[i] + p_word(i) + c;
            d.w[i] = (uint32_t)v;
            c = v >> 32;
        }
    }
    return d;
}

// a*b*R^{-1} mod p.
__device__ __forceinline__ Fr mul(const Fr& a, const Fr& b) {
    uint32_t t[10];
#pragma unroll
    for (int i = 0; i < 10; ++i) t[i] = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            uint64_t s = (uint64_t)a.w[i] * b.w[j] + t[j] + c;
            t[j] = (uint32_t)s;
            c = s >> 32;
        }
        uint64_t s = (uint64_t)t[8] + c;
        t[8] = (uint32_t)s;
        t[9] = (uint32_t)(s >> 32);
        uint32_t m = t[0] * P_INV;
        c = ((uint64_t)m * p_word(0) + t[0]) >> 32;
#pragma unroll
        for (int j = 1; j < 8; ++j) {
            uint64_t v = (uint64_t)m * p_word(j) + t[j] + c;
            t[j - 1] = (uint32_t)v;
            c = v >> 32;
        }
        s = (uint64_t)t[8] + c;
        t[7] = (uint32_t)s;
        t[8] = t[9] + (uint32_t)(s >> 32);
    }
    Fr r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.w[i] = t[i];
    return cond_sub_p(r, t[8]);
}

__device__ __forceinline__ Fr shfl_down(const Fr& v, int delta) {
    Fr r;
#pragma unroll
    for (int i = 0; i < 8; ++i)
        r.w[i] = __shfl_down_sync(0xffffffffu, v.w[i], delta);
    return r;
}

// Field sum of NV values per thread over the block (blockDim.x a multiple
// of 32, at most 1024). Thread 0 returns the block totals in `v`.
template <int NV>
__device__ __forceinline__ void block_sum(Fr (&v)[NV]) {
    __shared__ Fr warp_part[32][NV];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < NV; ++k)
        for (int d = 16; d > 0; d >>= 1) v[k] = add(v[k], shfl_down(v[k], d));
    if (lane == 0) {
#pragma unroll
        for (int k = 0; k < NV; ++k) warp_part[warp][k] = v[k];
    }
    __syncthreads();
    if (warp == 0) {
        const int nwarps = blockDim.x >> 5;
#pragma unroll
        for (int k = 0; k < NV; ++k) {
            v[k] = lane < nwarps ? warp_part[lane][k] : zero();
            for (int d = 16; d > 0; d >>= 1)
                v[k] = add(v[k], shfl_down(v[k], d));
        }
    }
}

}  // namespace zfr

namespace {

// Second pass shared by the reducing kernels: out[k] = Σ_b partials[b][k]
// for k < width, one block. (Anonymous namespace: each kernel source
// instantiates its own copy.)
template <int NV>
__global__ void zfr_reduce_partials(const uint32_t* __restrict__ partials,
                                    int nparts, int width,
                                    uint32_t* __restrict__ out) {
    using namespace zfr;
    Fr acc[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) acc[k] = zero();
    for (int b = threadIdx.x; b < nparts; b += blockDim.x) {
#pragma unroll
        for (int k = 0; k < NV; ++k)
            if (k < width) acc[k] = add(acc[k], load(partials, (long long)b * NV + k));
    }
    block_sum<NV>(acc);
    if (threadIdx.x == 0) {
#pragma unroll
        for (int k = 0; k < NV; ++k)
            if (k < width) store(out, k, acc[k]);
    }
}

}  // namespace
