// Kernels C, D and E: the device stages of the Pippenger MSM Σ_i s_i · P_i
// over BN254 G1, with 8-bit windows (msm/pippenger.py).
//
// E, scalar_digits: each scalar's 32 window digits from its Fr Montgomery
// words, a Montgomery product by the integer 1 (one REDC) whose canonical
// little-endian words are the digits. Replaces the host decode of the
// JAX package's HyperKZG commit (zolt_tpu/pcs/hyperkzg.py:50) and its
// digits in Python ints (zolt_tpu/msm/pippenger.py _digits): a commit of
// a tensor on the card reads its scalars there. One thread a scalar.
//
// C, bucket_accumulate: for each (window, digit) bucket b, the sum of the
// points whose scalar has that digit in that window,
//
//   S_b = Σ_{j in [seg[b], seg[b+1])} P[ent[j] mod n]
//
// over the entries (window · n + point) sorted by bucket (torch.sort in the
// wrapper; entries of digit 0 are dropped before it). Replaces
// zolt_tpu/msm/pippenger.py _bucket_totals, a Hillis–Steele segmented scan
// over every entry (N log N Jacobian adds, each level a full pass over
// HBM) and a searchsorted gather of each segment's last element. Here one
// warp takes one bucket: its lanes walk the segment with mixed additions
// (the points are affine), N adds in all, and meet by shuffles.
//
// D, window_sums: for each window, Σ_b b · S_b by the running sum
// (acc += S_b, tot += acc, b from 255 down to 1). Replaces
// pippenger._window_sums, a lax.scan of 255 steps batched over the
// windows. One thread a window, 510 Jacobian additions in sequence: a
// latency chain, slow but small beside C. The 32 window totals are
// combined on the host.
//
// Bound on Hopper: operations. A mixed addition is 11 Montgomery products
// (about 3000 IMADs) for 68 bytes read.
#include <cuda_runtime.h>

#include "g1.cuh"

namespace {

constexpr int THREADS = 128;            // four buckets a block
constexpr int BUCKETS = 256;

__global__ void __launch_bounds__(THREADS)
bucket_kernel(const int* __restrict__ ent, const int* __restrict__ seg,
              int nbuckets, const uint32_t* __restrict__ pts,
              const uint8_t* __restrict__ valid, int n, uint32_t* ox,
              uint32_t* oy, uint32_t* oz) {
    const int b = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
    if (b >= nbuckets) return;             // whole warps only
    const int lane = threadIdx.x % 32;
    zg1::Jac acc = zg1::identity();
    for (int j = seg[b] + lane; j < seg[b + 1]; j += 32) {
        const int i = ent[j] % n;
        if (!valid[i]) continue;
        acc = zg1::jac_add_affine(acc, zfr::load(pts, 2LL * i),
                                  zfr::load(pts, 2LL * i + 1));
    }
    acc = zg1::warp_sum(acc);
    if (lane == 0) zg1::store_jac(ox, oy, oz, b, acc);
}

__global__ void __launch_bounds__(THREADS)
digits_kernel(const uint32_t* __restrict__ words, long long n,
              uint32_t* out) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    zfr::Fr one = zfr::zero();
    one.w[0] = 1u;
    zfr::store(out, i, zfr::mont_mul(zfr::load(words, i), one));
}

__global__ void window_kernel(const uint32_t* bx, const uint32_t* by,
                              const uint32_t* bz, int nwin, uint32_t* ox,
                              uint32_t* oy, uint32_t* oz) {
    const int w = blockIdx.x * blockDim.x + threadIdx.x;
    if (w >= nwin) return;
    zg1::Jac acc = zg1::identity(), tot = zg1::identity();
    for (int b = BUCKETS - 1; b > 0; --b) {
        acc = zg1::jac_add(acc, zg1::load_jac(bx, by, bz,
                                              (long long)w * BUCKETS + b));
        tot = zg1::jac_add(tot, acc);
    }
    zg1::store_jac(ox, oy, oz, w, tot);
}

}  // namespace

// words: (n, 8) int32 Fr Montgomery words, 16-byte aligned; out: (n, 8)
// int32, the canonical words ((n, 32) digit bytes).
extern "C" int zg1_scalar_digits(const void* words, long long n, void* out,
                                 void* stream) {
    const long long blocks = (n + THREADS - 1) / THREADS;
    if (n < 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    digits_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, n, (uint32_t*)out);
    return (int)cudaGetLastError();
}

// ent: (total,) int32 entries sorted by bucket; seg: (nbuckets + 1,) int32
// segment offsets into ent; pts: (n, 16) int32, a point's x words then its
// y words; valid: (n,) u8, 0 for the identity; out: three (nbuckets, 8)
// int32 arrays. Returns cudaGetLastError() after the launch.
extern "C" int zg1_bucket_accumulate(const void* ent, const void* seg,
                                     int nbuckets, const void* pts,
                                     const void* valid, int n, void* ox,
                                     void* oy, void* oz, void* stream) {
    if (nbuckets < 0 || n < 1) return (int)cudaErrorInvalidValue;
    if (nbuckets == 0) return (int)cudaSuccess;
    const int per = THREADS / 32;
    bucket_kernel<<<(nbuckets + per - 1) / per, THREADS, 0,
                    (cudaStream_t)stream>>>(
        (const int*)ent, (const int*)seg, nbuckets, (const uint32_t*)pts,
        (const uint8_t*)valid, n, (uint32_t*)ox, (uint32_t*)oy,
        (uint32_t*)oz);
    return (int)cudaGetLastError();
}

// b*: three (nwin * 256, 8) int32 bucket arrays; out: three (nwin, 8).
extern "C" int zg1_window_sums(const void* bx, const void* by, const void* bz,
                               int nwin, void* ox, void* oy, void* oz,
                               void* stream) {
    if (nwin < 0) return (int)cudaErrorInvalidValue;
    if (nwin == 0) return (int)cudaSuccess;
    window_kernel<<<(nwin + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)bx, (const uint32_t*)by, (const uint32_t*)bz, nwin,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz);
    return (int)cudaGetLastError();
}
