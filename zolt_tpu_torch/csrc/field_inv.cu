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
// batch_inverse is the Montgomery trick a thread a chunk of c entries, the
// chunk's entries strided by the thread count (entry t + j*T is entry j of
// chunk t), so a warp reads 32 neighbouring elements at each step:
//   1. the running product of the chunk's non-zero entries, each prefix
//      stored in `out` (zero entries store it unchanged);
//   2. one Fermat inverse of the chunk's product (253 squarings from the
//      top bit of p - 2, which is bit 253 for both moduli);
//   3. back-substitution from the chunk's last entry: out = inv * prefix
//      of the entries before it, inv *= entry.
// Three products an entry and one Fermat inverse a chunk; the wrapper
// picks c so that the launch has about 132 x 128 threads (field/inverse.py
// chunk_of). The Fermat inverse is one chain of dependent products, so a
// launch costs at least that chain's latency, whatever n.
#include <cuda_runtime.h>

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

// Word k of p - 2 (p's low word is odd and above 2: no borrow).
template <class M>
__device__ __forceinline__ uint32_t exp_word(int k) {
    return M::word(k) - (k == 0 ? 2u : 0u);
}

// a^(p-2): square-and-multiply from bit 252 with the accumulator at a
// (bit 253, the top bit of p - 2). inverse(0) = 0.
template <class M>
__device__ Fr fermat_inverse(const Fr& a) {
    Fr acc = a;
#pragma unroll 1
    for (int i = 252; i >= 0; --i) {
        acc = zfr::mont_mul<M>(acc, acc);
        if ((exp_word<M>(i >> 5) >> (i & 31)) & 1u)
            acc = zfr::mont_mul<M>(acc, a);
    }
    return acc;
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
    Fr inv = fermat_inverse<M>(run);
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
