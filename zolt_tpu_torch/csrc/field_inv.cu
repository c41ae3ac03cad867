// Kernel F: fixed-exponent powers and batch inversion of BN254 field
// elements (Fr or Fp, Montgomery form, canonical in and out).
//
//   pow_fixed:     out[i] = a[i]^e for a public exponent e, its bits given
//                  LSB first as a device array of bytes (any length; 0 bits
//                  is e = 0 and the array is never read);
//   batch_inverse: out[i] = a[i]^{-1}, zeros written as zeros.
//
// Replaces no Pallas kernel: it replaces the XLA code of
// zolt_tpu/field/limb.py mont_pow_fixed (a lax.scan of products over the
// exponent's bits), inverse (its Fermat inverse a^(p-2)) and batch_inverse
// (prefix and suffix products by associative_scan around one Fermat
// inverse). In torch ops on the card a Fermat inverse would be about 380
// dependent Montgomery products of some 500 launches each.
//
// Bound on Hopper: integer products, not bytes. A Montgomery product is
// 272 IMADs (field_ptx.cuh CIOS); an element moves 64 bytes. pow_fixed is a
// thread an element, its square-and-multiply chain in registers.
// batch_inverse is the Montgomery trick over chunks of c entries, the
// chunk's entries strided by the chunk count (entry t + j*T is entry j of
// chunk t), so a warp reads 32 neighbouring elements at each step:
//   1. the running product of the chunk's non-zero entries, each prefix
//      stored in `out` (zero entries store it unchanged);
//   2. the inverse of the chunk's product by the fixed-length divstep
//      inverse (divstep.cuh: 20 batches of 30 divsteps on signed 30-bit
//      limbs, a chain of some 35 µs on an H100 where the Fermat chain it
//      replaced, 379 dependent Montgomery products, took some 380 µs;
//      PERF.md), then one Montgomery product by R^3 mod p: the divsteps
//      invert the word x = aR, and x^{-1}·R^3·R^{-1} = a^{-1}R;
//   3. back-substitution from the chunk's last entry: out = inv * prefix
//      of the entries before it, inv *= entry.
// Three products an entry and one inverse a chunk; the wrapper picks c
// so that the launch has about 132 x 256 threads (field/inverse.py
// chunk_of, from chip_smoke.py's sweep). A block-level product tree with
// one inverse a block was slower at every size swept (PERF.md).
#include <cuda_runtime.h>

#include "divstep.cuh"
#include "field_ptx.cuh"

namespace {

constexpr int THREADS = 256;

using zfr::Fr;

template <class M>
__device__ __forceinline__ Fr one_mont() {
    Fr r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.w[i] = M::one_word(i);
    return r;
}

__device__ __forceinline__ bool is_zero(const Fr& a) {
    uint32_t o = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) o |= a.w[i];
    return o == 0u;
}

// Each field's divstep constants and R^3 mod p.
template <class M>
struct Inv;

template <>
struct Inv<zfr::FrMod> {
    using D = zfr::FrDiv;
    static __device__ __forceinline__ uint32_t r3(int i) {
        switch (i) {
            case 0: return 0xb4bf0040u;
            case 1: return 0x5e94d8e1u;
            case 2: return 0x1cfbb6b8u;
            case 3: return 0x2a489cbeu;
            case 4: return 0xa19fcfedu;
            case 5: return 0x893cc664u;
            case 6: return 0x7fcc657cu;
            default: return 0x0cf8594bu;
        }
    }
};

template <>
struct Inv<zfr::FpMod> {
    using D = zfr::FpDiv;
    static __device__ __forceinline__ uint32_t r3(int i) {
        switch (i) {
            case 0: return 0xda1530dfu;
            case 1: return 0xb1cd6dafu;
            case 2: return 0xa7283db6u;
            case 3: return 0x62f210e6u;
            case 4: return 0x0ada0afbu;
            case 5: return 0xef7f0b0cu;
            case 6: return 0x2d592544u;
            default: return 0x20fd6e90u;
        }
    }
};

// The Montgomery form of a^{-1} from that of a (0 -> 0).
template <class M>
__device__ __noinline__ Fr mont_inverse(const Fr& a) {
    Fr y, c;
    zfr::divstep_inverse<typename Inv<M>::D>(a.w, y.w);
#pragma unroll
    for (int i = 0; i < 8; ++i) c.w[i] = Inv<M>::r3(i);
    return zfr::mont_mul<M>(y, c);
}

template <class M>
__global__ void __launch_bounds__(THREADS)
pow_kernel(const uint32_t* a, uint32_t* out, long long n,
           const uint8_t* bits, int nbits) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    const Fr x = zfr::load(a, i);
    Fr acc = one_mont<M>();
#pragma unroll 1
    for (int b = nbits - 1; b >= 0; --b) {
        acc = zfr::mont_mul<M>(acc, acc);
        if (__ldg(bits + b)) acc = zfr::mont_mul<M>(acc, x);
    }
    zfr::store(out, i, acc);
}

template <class M>
__global__ void __launch_bounds__(THREADS)
batch_inverse_kernel(const uint32_t* a, uint32_t* out, long long n,
                     int chunk, long long nchunks) {
    const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (t >= nchunks) return;
    // entries of this chunk: t + j*nchunks < n, j < chunk
    long long len = (n - t + nchunks - 1) / nchunks;
    const int c = len < chunk ? (int)len : chunk;
    Fr run = one_mont<M>();
#pragma unroll 1
    for (int j = 0; j < c; ++j) {
        const long long i = t + j * nchunks;
        const Fr x = zfr::load(a, i);
        if (!is_zero(x)) run = zfr::mont_mul<M>(run, x);
        zfr::store(out, i, run);
    }
    Fr inv = mont_inverse<M>(run);
#pragma unroll 1
    for (int j = c - 1; j >= 0; --j) {
        const long long i = t + j * nchunks;
        const Fr x = zfr::load(a, i);
        if (is_zero(x)) {
            zfr::store(out, i, zfr::zero());
            continue;
        }
        const Fr prev = j ? zfr::load(out, i - nchunks) : one_mont<M>();
        zfr::store(out, i, zfr::mont_mul<M>(inv, prev));
        inv = zfr::mont_mul<M>(inv, x);
    }
}

int blocks_for(long long threads) {
    return (int)((threads + THREADS - 1) / THREADS);
}

}  // namespace

// out[i] = a[i]^e over n elements ((n, 8) words, 16-byte aligned) of field
// 0 (Fr) or 1 (Fp); e's nbits bits LSB first, one byte each (unread when
// nbits is 0). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments out of range.
extern "C" int zfr_pow_fixed(const void* a, void* out, long long n,
                             const void* bits, int nbits, int field,
                             void* stream) {
    if (n < 0 || nbits < 0 || (nbits > 0 && bits == nullptr) ||
        (field != 0 && field != 1))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    cudaStream_t s = (cudaStream_t)stream;
    const uint32_t* src = (const uint32_t*)a;
    uint32_t* dst = (uint32_t*)out;
    const uint8_t* b = (const uint8_t*)bits;
    if (field == 0)
        pow_kernel<zfr::FrMod><<<blocks_for(n), THREADS, 0, s>>>(
            src, dst, n, b, nbits);
    else
        pow_kernel<zfr::FpMod><<<blocks_for(n), THREADS, 0, s>>>(
            src, dst, n, b, nbits);
    return (int)cudaGetLastError();
}

// out[i] = a[i]^{-1} (0 -> 0) over n entries of field 0 (Fr) or 1 (Fp), a
// thread a chunk of `chunk` entries strided by the chunk count.
extern "C" int zfr_batch_inverse(const void* a, void* out, long long n,
                                 int chunk, int field, void* stream) {
    if (n < 0 || chunk < 1 || (field != 0 && field != 1))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    const long long nchunks = (n + chunk - 1) / chunk;
    cudaStream_t s = (cudaStream_t)stream;
    const uint32_t* src = (const uint32_t*)a;
    uint32_t* dst = (uint32_t*)out;
    if (field == 0)
        batch_inverse_kernel<zfr::FrMod><<<blocks_for(nchunks), THREADS, 0,
                                           s>>>(src, dst, n, chunk, nchunks);
    else
        batch_inverse_kernel<zfr::FpMod><<<blocks_for(nchunks), THREADS, 0,
                                           s>>>(src, dst, n, chunk, nchunks);
    return (int)cudaGetLastError();
}
