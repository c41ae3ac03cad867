// Kernel G: the round evaluations of product sumchecks of any number of
// factors k >= 1 and any degree >= 0, several groups in one launch,
//
//   evals[t] = Σ_{i < live_pairs} Π_{j<k} (lo_j[i] + t·(hi_j[i] − lo_j[i]))
//   t = 0..degree,  lo_j[i] = tab_j[2i], hi_j[i] = tab_j[2i+1]
//
// as finished, canonical (degree+1, 8) Montgomery words. The groups of
// k = 2 or 3 and degree <= 3 take kernels 2-3 (product_evals.cu); the
// wrapper (field/evals.py) sends every other group here. Replaces no
// Pallas kernel: it replaces the XLA code the JAX package runs for them,
// zolt_tpu/parallel/stage_engine.py _evals_fixed (:173) and the
// ProductSumcheck round of zolt_tpu/sumcheck/driver.py (:92).
//
// Runtime k: a thread a pair walks the factors outermost, keeping a running
// product a point, and adds each point's last product, unreduced, into a
// 544-bit integer (17 words) as kernels 2-3 do. The points a thread holds
// are capped at PTS (4: 4 x (8 + 17) words of products and sums), whatever
// k. The wrapper cuts a group's points into descriptors of at most PTS
// points each (t0 .. t0 + npts − 1), each with blocks of its own, all in
// one launch; a descriptor re-reads the group's tables. Every point is
// summed, whatever the degree, so every row is exact by construction.
//
// Each block sums its threads' integers column by column in shared memory;
// a descriptor's blocks meet in one integer sum by atomics and a ticket
// (ticket.cuh, as kernels 2-3); the finishing block reduces each point once
// (wide_term's three Montgomery products on three threads) and writes its
// rows.
//
// Bound on the H100 (the wrapper's work_any): k·64 bytes a live pair read
// once, the evals written once; IMADs, a point a pair: k − 2 Montgomery
// products (272 IMADs) and one wide product (128), none for k = 1; over
// min(degree, k) + 1 points, which fix the rest (Σ Π is of degree k in t),
// so a group of degree > k sums more points than its bound counts. At k = 4, degree 4 and 2^15 pairs that is
// 5 x 672 x 2^15 = 110 M IMADs, 6.6 µs at 132 SMs x 64 IMAD/clk x 1.98 GHz,
// against 8.4 MB of reads, 2.5 µs at 3.35 TB/s: bound by the integer pipes
// for every k >= 3.
#include <cuda_runtime.h>

#include "field_ptx.cuh"
#include "ticket.cuh"

namespace {

constexpr int MAX_DESCS = 16;
constexpr int PTS = 4;           // points a descriptor
constexpr int THREADS = 128;
constexpr int COLS = PTS * zfr::WIDE;
constexpr int SLOT = COLS + 1;   // the column sums, a ticket
constexpr int ROW = THREADS + 1; // padded: no bank conflicts

struct Desc {
    const uint32_t* tabs;        // (k, n, 8) words
    uint32_t* out;               // the group's (degree + 1, 8) words
    long long n, live_pairs;
    int k;
    int t0, npts;                // the points summed: t0 .. t0 + npts − 1
    int block0, nblocks;
};

struct Batch {
    Desc d[MAX_DESCS];
    int ndescs;
    // per descriptor: 64-bit column sums and a ticket, zero between
    // launches
    unsigned long long* scratch;
};

// This thread's unreduced sums of points t0 .. t0 + npts − 1 over its
// pairs, into column threadIdx.x of cols (word w of point t in row
// t*WIDE + w).
__device__ __forceinline__ void point_sums(const Desc& g, int block,
                                           uint32_t (*cols)[ROW]) {
    using namespace zfr;
    uint32_t acc[PTS][WIDE];
#pragma unroll
    for (int t = 0; t < PTS; ++t)
#pragma unroll
        for (int w = 0; w < WIDE; ++w) acc[t][w] = 0u;
    // R mod p: a single factor's sum is Σ v·R·R^{-1} = Σ v
    const Fr one = r_mod_p();
    const long long stride = (long long)g.nblocks * THREADS;
    for (long long i = (long long)block * THREADS + threadIdx.x;
         i < g.live_pairs; i += stride) {
        Fr prod[PTS];
#pragma unroll
        for (int t = 0; t < PTS; ++t) prod[t] = one;
#pragma unroll 1
        for (int j = 0; j < g.k; ++j) {
            const uint32_t* tab = g.tabs + (long long)j * g.n * 8;
            const Fr lo = load(tab, 2 * i), hi = load(tab, 2 * i + 1);
            const Fr d = sub_p(hi, lo);
            Fr v = lo;
#pragma unroll 1
            for (int s = 0; s < g.t0; ++s) v = add_p(v, d);
#pragma unroll
            for (int t = 0; t < PTS; ++t) {
                if (t < g.npts) {
                    if (j == g.k - 1) mac_wide(acc[t], prod[t], v);
                    else if (j == 0) prod[t] = v;
                    else prod[t] = mont_mul(prod[t], v);
                }
                if (t + 1 < PTS) v = add_p(v, d);
            }
        }
    }
#pragma unroll
    for (int t = 0; t < PTS; ++t)
        if (t < g.npts)
#pragma unroll
            for (int w = 0; w < WIDE; ++w) cols[t * WIDE + w][threadIdx.x] =
                acc[t][w];
}

__global__ void __launch_bounds__(THREADS)
product_evals_any_kernel(const __grid_constant__ Batch batch) {
    using namespace zfr;
    __shared__ uint32_t cols[COLS][ROW];
    __shared__ unsigned long long s64[COLS];
    __shared__ Fr terms[PTS][3];
    int gi = 0;
    while (gi + 1 < batch.ndescs && (int)blockIdx.x >= batch.d[gi + 1].block0)
        ++gi;
    const Desc& g = batch.d[gi];
    const int tid = threadIdx.x;
    const int ncols = g.npts * WIDE;
    const int block = blockIdx.x - g.block0;
    point_sums(g, block, cols);
    __syncthreads();
    // thread c adds row c over the block's threads (< 2^39); a descriptor
    // of more than one block adds that into its column sums (< 2^49 for
    // 1024 blocks), ticket.cuh
    if (tid < ncols) {
        unsigned long long s = 0;
#pragma unroll 8
        for (int i = 0; i < THREADS; ++i) s += cols[tid][i];
        s64[tid] = s;
    }
    __syncthreads();
    if (!block_total(s64, ncols, batch.scratch + gi * SLOT, COLS, g.nblocks))
        return;
    if (tid < 3 * g.npts) {
        uint32_t w[WIDE];
        normalize(s64 + tid / 3 * WIDE, w);
        terms[tid / 3][tid % 3] = wide_term(w, tid % 3);
    }
    __syncthreads();
    if (tid < g.npts)
        store(g.out, g.t0 + tid,
              add_p(add_p(terms[tid][0], terms[tid][1]), terms[tid][2]));
}

}  // namespace

// One descriptor as the host describes it.
struct ZfrAnyDesc {
    const void* tabs;            // (k, n, 8) int32, 16-byte aligned
    void* out;                   // the group's (degree + 1, 8) int32
    long long n, live_pairs;
    int k, t0, npts, nblocks;
};

// Launches one kernel over `ndescs` descriptors (1..16) on `stream`.
// scratch: 16 * (4 * 17 + 1) unsigned 64-bit words that are zero, and that
// the kernel leaves zero. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a descriptor out of range.
extern "C" int zfr_product_evals_any(const ZfrAnyDesc* descs, int ndescs,
                                     void* scratch, void* stream) {
    if (ndescs < 1 || ndescs > MAX_DESCS) return (int)cudaErrorInvalidValue;
    Batch batch;
    batch.ndescs = ndescs;
    batch.scratch = (unsigned long long*)scratch;
    int grid = 0;
    for (int i = 0; i < ndescs; ++i) {
        const ZfrAnyDesc& h = descs[i];
        if (h.k < 1 || h.t0 < 0 || h.npts < 1 || h.npts > PTS ||
            h.nblocks < 1 || h.live_pairs < 0 || 2 * h.live_pairs > h.n)
            return (int)cudaErrorInvalidValue;
        Desc& g = batch.d[i];
        g.tabs = (const uint32_t*)h.tabs;
        g.out = (uint32_t*)h.out;
        g.n = h.n;
        g.live_pairs = h.live_pairs;
        g.k = h.k;
        g.t0 = h.t0;
        g.npts = h.npts;
        g.block0 = grid;
        g.nblocks = h.nblocks;
        grid += h.nblocks;
    }
    product_evals_any_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        batch);
    return (int)cudaGetLastError();
}
