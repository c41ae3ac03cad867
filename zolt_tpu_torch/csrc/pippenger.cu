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
// zolt_tpu/msm/pippenger.py:55 _bucket_totals, a Hillis–Steele segmented
// scan over every entry (N log N Jacobian adds, each level a full pass
// over HBM) and a searchsorted gather of each segment's last element.
//
// Bound on Hopper: operations. A mixed addition is 11 Montgomery products
// (about 3000 IMADs) for 68 bytes read (a 64-byte affine point and its
// 4-byte entry). Real scalars fill the buckets very unevenly: the
// internal prover's RAM values put 44,869 of 512,299 entries in one
// bucket, random scalars put some 2^16 / 48 in each of window 31's
// buckets (r < 2^254). So the work is cut by entries, not by buckets. The
// wrapper (msm/pippenger.py bucket_chunks) cuts each bucket's segment
// into chunks of at most CHUNK = 16 entries, and each pass's partial sums,
// which stay grouped by bucket, the same way, until a bucket holds at
// most 16 partials; its last pass has one chunk a bucket. A bucket of m
// entries takes ceil(log_16 m) passes, at most ceil(log_16 n), and no
// chunk is longer than 16 however skewed the buckets are, so a bucket of
// 44,869 entries costs a chain of 16 mixed additions and three levels of
// five full ones (not the 1,403 a lane of one warp walked). One launch a
// pass, all on one stream:
//
//   bucket_kernel<1>: a thread a chunk of entries, mixed additions,
//     skipping the identity points (`valid` 0). About N / 16 threads:
//     134K at n = 2^16 random scalars, 32K on the RAM poly.
//   bucket_kernel<4>: four lanes a chunk of Jacobian partials (each lane
//     at most four, full additions that handle P + P, P + (−P) and the
//     identity), the group's lanes meeting in two levels of shuffles.
//
// The last pass writes each bucket's sum, the identity (Z = 0) for an
// empty one.
//
// D, window_sums: for each window, Σ_b b · S_b. Replaces
// pippenger._window_sums, a lax.scan of 255 running-sum steps (acc += S_b,
// tot += acc) batched over the windows: 510 Jacobian additions in one
// serial chain a window, which on a GPU is one thread a window and one
// chain of latency with the rest of the card idle. Here by bit planes,
// as window_sums_plain computes it: Σ_b b·S_b = Σ_{k<8} 2^k · T_k, T_k the
// sum of the 128 buckets whose index has bit k set. A block takes a
// window and warp k its T_k: each lane adds its four buckets in a tree
// of two levels, the warp's lanes meet in five levels of shuffles, the
// warp doubles its sum k times, and the eight 2^k · T_k meet in three
// more levels. The chain is 10 additions and 7 doublings deep (209
// products) instead of 510 additions (8160); a window takes 1023
// additions and 28 doublings in all, twice the running sum's, across 256
// threads. An empty bucket (Z = 0) costs a compare, no product. The 32
// window totals are combined on the host.
//
// D is bound by operations too; E by bytes (one product a scalar for 64
// bytes).
#include <cuda_runtime.h>

#include "g1.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int BUCKETS = 256;

// The sum of the affine points of entries [lo, hi). Loading the next
// entry's point ahead of the current addition gained 1-2 % on an H100
// and took 114 registers (experiments/g1_kernels/compare_g1.py): the
// gather is short beside 11 called products, and the other warps hide it.
__device__ __forceinline__ zg1::Jac entries_sum(
        const int* __restrict__ ent, const uint32_t* __restrict__ pts,
        const uint8_t* __restrict__ valid, int n, int lo, int hi) {
    zg1::Jac acc = zg1::identity();
    for (int j = lo; j < hi; ++j) {
        const int i = ent[j] % n;
        if (valid[i])
            acc = zg1::jac_add_affine(acc, zfr::load(pts, 2LL * i),
                                      zfr::load(pts, 2LL * i + 1));
    }
    return acc;
}

// Chunk c of a pass is [bounds[c], bounds[c+1]); LANES lanes take it.
// LANES = 1: a chunk of entries (ent, pts, valid); LANES = 4: a chunk of
// the previous pass's Jacobian partials (ix, iy, iz), lane j taking
// every fourth from the j-th. Writes chunk c's sum to row c of o*.
template <int LANES>
__global__ void __launch_bounds__(THREADS)
bucket_kernel(const int* __restrict__ bounds, int nchunks,
              const int* __restrict__ ent, const uint32_t* __restrict__ pts,
              const uint8_t* __restrict__ valid, int n,
              const uint32_t* __restrict__ ix,
              const uint32_t* __restrict__ iy,
              const uint32_t* __restrict__ iz, uint32_t* ox, uint32_t* oy,
              uint32_t* oz) {
    const long long c = ((long long)blockIdx.x * THREADS + threadIdx.x) /
                        LANES;
    const int lane = threadIdx.x % LANES;
    const bool live = c < nchunks;         // dead lanes still shuffle
    zg1::Jac acc = zg1::identity();
    if constexpr (LANES == 1) {
        if (!live) return;
        acc = entries_sum(ent, pts, valid, n, bounds[c], bounds[c + 1]);
    } else {
        if (live)
            for (int t = bounds[c] + lane; t < bounds[c + 1]; t += LANES)
                acc = zg1::jac_add(acc, zg1::load_jac(ix, iy, iz, t));
#pragma unroll
        for (int off = LANES / 2; off > 0; off >>= 1) {
            zg1::Jac o;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                o.x.w[i] = __shfl_xor_sync(0xffffffffu, acc.x.w[i], off);
                o.y.w[i] = __shfl_xor_sync(0xffffffffu, acc.y.w[i], off);
                o.z.w[i] = __shfl_xor_sync(0xffffffffu, acc.z.w[i], off);
            }
            acc = zg1::jac_add(acc, o);
        }
    }
    if (live && lane == 0) zg1::store_jac(ox, oy, oz, c, acc);
}

constexpr int REDUCE_LANES = 4;

__global__ void __launch_bounds__(THREADS)
digits_kernel(const uint32_t* __restrict__ words, long long n,
              uint32_t* out) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    zfr::Fr one = zfr::zero();
    one.w[0] = 1u;
    zfr::store(out, i, zfr::mont_mul(zfr::load(words, i), one));
}

constexpr int WINDOW_BITS = 8;           // a warp a bit of the digit

// The point over the lanes of each aligned group of `width` lanes, in
// every lane of the group (a butterfly). Every lane of the warp calls it.
__device__ __forceinline__ zg1::Jac lanes_sum(zg1::Jac acc, int width) {
    for (int off = width / 2; off > 0; off >>= 1) {
        zg1::Jac o;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            o.x.w[i] = __shfl_xor_sync(0xffffffffu, acc.x.w[i], off);
            o.y.w[i] = __shfl_xor_sync(0xffffffffu, acc.y.w[i], off);
            o.z.w[i] = __shfl_xor_sync(0xffffffffu, acc.z.w[i], off);
        }
        acc = zg1::jac_add(acc, o);
    }
    return acc;
}

__global__ void __launch_bounds__(WINDOW_BITS * 32)
window_kernel(const uint32_t* __restrict__ bx,
              const uint32_t* __restrict__ by,
              const uint32_t* __restrict__ bz, uint32_t* ox, uint32_t* oy,
              uint32_t* oz) {
    __shared__ zg1::Jac part[WINDOW_BITS];
    const int w = blockIdx.x;
    const int k = threadIdx.x / 32, lane = threadIdx.x % 32;
    // the i-th of the 128 bucket indices with bit k set
    const auto bucket = [k, w](int i) {
        const int b = ((i >> k) << (k + 1)) | (1 << k) | (i & ((1 << k) - 1));
        return (long long)w * BUCKETS + b;
    };
    const zg1::Jac s01 = zg1::jac_add(
        zg1::load_jac(bx, by, bz, bucket(lane)),
        zg1::load_jac(bx, by, bz, bucket(lane + 32)));
    const zg1::Jac s23 = zg1::jac_add(
        zg1::load_jac(bx, by, bz, bucket(lane + 64)),
        zg1::load_jac(bx, by, bz, bucket(lane + 96)));
    zg1::Jac t = lanes_sum(zg1::jac_add(s01, s23), 32);
    for (int i = 0; i < k; ++i) t = zg1::jac_double(t);
    if (lane == 0) part[k] = t;
    __syncthreads();
    if (k != 0) return;
    t = lanes_sum(lane < WINDOW_BITS ? part[lane] : zg1::identity(),
                  WINDOW_BITS);
    if (lane == 0) zg1::store_jac(ox, oy, oz, w, t);
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

// ent: (total,) int32 entries sorted by bucket; bounds: the npass passes'
// chunk offsets, int32, back to back (pass p's chunks[p] + 1 of them;
// msm/pippenger.py bucket_chunks), on the card; chunks: (npass,) int32 on
// the host, the last pass's the bucket count; pts: (n, 16) int32, a
// point's x words then its y words; valid: (n,) u8, 0 for the identity;
// p*: three (Σ chunks[:-1], 8) int32 scratch arrays for the partials;
// out: three (chunks[npass - 1], 8) int32 arrays. Launches one kernel a
// pass on `stream`; returns the first non-zero cudaGetLastError().
extern "C" int zg1_bucket_accumulate(const void* ent, const void* bounds,
                                     const int* chunks, int npass,
                                     const void* pts, const void* valid,
                                     int n, void* px, void* py, void* pz,
                                     void* ox, void* oy, void* oz,
                                     void* stream) {
    if (npass < 1 || n < 1) return (int)cudaErrorInvalidValue;
    const int* b = (const int*)bounds;
    const uint32_t *ix = nullptr, *iy = nullptr, *iz = nullptr;
    long long at = 0;                      // the next partials' first row
    for (int p = 0; p < npass; ++p) {
        const int m = chunks[p];
        if (m < 0) return (int)cudaErrorInvalidValue;
        uint32_t *dx = (uint32_t*)ox, *dy = (uint32_t*)oy,
                 *dz = (uint32_t*)oz;
        if (p + 1 < npass) {
            dx = (uint32_t*)px + 8 * at;
            dy = (uint32_t*)py + 8 * at;
            dz = (uint32_t*)pz + 8 * at;
        }
        const int lanes = p == 0 ? 1 : REDUCE_LANES;
        const long long grid = ((long long)m * lanes + THREADS - 1) / THREADS;
        if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
        if (m > 0) {
            if (p == 0)
                bucket_kernel<1><<<(unsigned)grid, THREADS, 0,
                                   (cudaStream_t)stream>>>(
                    b, m, (const int*)ent, (const uint32_t*)pts,
                    (const uint8_t*)valid, n, nullptr, nullptr, nullptr, dx,
                    dy, dz);
            else
                bucket_kernel<REDUCE_LANES><<<(unsigned)grid, THREADS, 0,
                                              (cudaStream_t)stream>>>(
                    b, m, nullptr, nullptr, nullptr, n, ix, iy, iz, dx, dy,
                    dz);
            const int rc = (int)cudaGetLastError();
            if (rc) return rc;
        }
        ix = dx;
        iy = dy;
        iz = dz;
        if (p + 1 < npass) at += m;
        b += m + 1;
    }
    return (int)cudaSuccess;
}

// b*: three (nwin * 256, 8) int32 bucket arrays; out: three (nwin, 8).
extern "C" int zg1_window_sums(const void* bx, const void* by, const void* bz,
                               int nwin, void* ox, void* oy, void* oz,
                               void* stream) {
    if (nwin < 0) return (int)cudaErrorInvalidValue;
    if (nwin == 0) return (int)cudaSuccess;
    window_kernel<<<nwin, WINDOW_BITS * 32, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)bx, (const uint32_t*)by, (const uint32_t*)bz,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz);
    return (int)cudaGetLastError();
}
