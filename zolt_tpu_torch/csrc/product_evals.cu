// Kernels 2 and 3: the round evaluations of K-factor product sumchecks,
// several instances ("groups") in one launch,
//
//   evals[t] = Σ_{i < live_pairs} Π_{j<K} (lo_j[i] + t·(hi_j[i] − lo_j[i]))
//   t = 0..degree,  lo_j[i] = tab_j[2i], hi_j[i] = tab_j[2i+1]
//
// Replaces zolt_tpu/field/pallas_redc.py eval_rows_k2 (_eval_rows_k2_kernel
// :697-766, with the host decode_eval_rows_k2 :922-949) for K = 2, and
// eval_rows_k3 (_eval_rows_k3_kernel :808-885, with decode_eval_rows_k3
// :888-919) for K = 3. The TPU forms sum raw byte-plane products on the
// matrix unit and finish on the host with one ·R^{-K}, exact only for
// n < 2^25. Here the sums are exact for any n and the output is the
// finished, canonical (degree+1, 8) Montgomery words.
//
// One launch takes up to 16 groups, each with its own table, k in {2, 3},
// n, live prefix, degree <= 3 and output. The descriptors go by value as
// the kernel's parameter. Each block serves one group (blocks are split
// over the groups by a prefix sum of their block counts), so the branch on
// k is uniform in a block.
//
// Two schedules, chosen per group by its live pair count (the wrapper's
// SPLIT_MAX_PAIRS, 2^13), uniform in a block:
// - one thread a pair, for large groups. It walks its pairs and adds each
//   point's last product, unreduced, into a 544-bit integer (17 words a
//   point in registers). It issues the fewest instructions a pair.
// - four threads a pair, one point each, for small groups. A thread runs
//   one product chain (K = 2) or two (K = 3) where a thread a pair runs 3
//   or 7 in a row. Below about 2^13 live pairs the grid is under a wave
//   and that chain is the launch's critical path; above it the split issues
//   about twice the instructions and loses (PERF.md, both schedules timed
//   at each live count by chip_smoke.py).
// One kernel holds both (164 registers, no spills, 3 blocks of 128 an SM).
//
// Single pass, one reduction a point. A block adds its threads' integers
// column by column in shared memory; the blocks of a group then meet in
// one integer sum by atomics and a ticket (ticket.cuh, shared with
// gruen_round.cu). The finishing block reduces each point's sum once
// (field_ptx.cuh wide_term, its three Montgomery products on three
// threads) and writes the evals. Integer sums do not depend on the order
// of the blocks.
//
// Fewer products:
// - K = 2: Σ (a0 + tΔa)(b0 + tΔb) is quadratic in t, so only t = 0, 1, 2
//   are summed; degree 3 (ValFinal) gets p(3) = p(0) + 3(p(2) − p(1)) on
//   the finished sums. 3 products a pair.
// - K = 3: u_t = x_t·y_t is quadratic in t: u_0, u_1, u_2 are reduced
//   products and u_3 = u_0 + 3(u_2 − u_1) takes additions only; then u_t·z_t
//   at the 4 points. 7 products a pair.
// Word products are PTX carry chains (field_ptx.cuh).
//
// Bound on the H100, counted as IMADs (a 32x32-bit word product is two,
// lo and hi): a 256x256-bit product is 128, a Montgomery product with its
// REDC 272. K = 3, degree 3: 3·272 + 4·128 = 1328 IMADs per pair; K = 2,
// degree 2: 3·128 = 384. At 2^15 pairs that is 43.5 M and 12.6 M IMADs,
// 2.6 and 0.75 µs at 132 SMs × 64 IMAD/clk × 1.98 GHz; the bytes (K·64 per
// live pair, 6.3 and 4.2 MB) take 1.9 and 1.25 µs at 3.35 TB/s. So K = 3 is
// bound by the integer pipes and K = 2 by HBM.
//
// Tensor cores and TMA do not serve it. The TPU's trick, int8 byte planes
// on the matrix unit, costs 1024 MACs per 256-bit product where the
// integer pipes need 64 word products, brings back the n < 2^25 bound, and
// needs a decode. Each entry is read once, so 16-byte vector loads
// already stream it; TMA would only stage it through shared memory.
#include <cuda_runtime.h>

#include "field_ptx.cuh"
#include "ticket.cuh"

namespace {

constexpr int MAX_GROUPS = 16;
constexpr int MAX_DEG1 = 4;    // degree <= 3
constexpr int THREADS = 128;

struct Group {
    const uint32_t* tabs;      // (k, n, 8) words
    uint32_t* out;             // (degree + 1, 8) words
    long long n, live_pairs;
    int k, degree;
    int lanes;                 // threads a pair: 1, or 4 (one a point)
    int block0, nblocks;       // this group's blocks of the grid
};

constexpr int COLS = MAX_DEG1 * zfr::WIDE;   // words of a group's sums
constexpr int SLOT = COLS + 1;               // the column sums, a ticket

struct Batch {
    Group g[MAX_GROUPS];
    int ngroups;
    // per group slot: 64-bit column sums and a ticket, zero between launches
    unsigned long long* scratch;
};

// Points summed per pair: K = 2 stops at t = 2 (quadratic).
__device__ __forceinline__ int summed_points(int k, int degree) {
    return k == 2 ? min(degree, 2) + 1 : degree + 1;
}

constexpr int ROW = THREADS + 1;             // padded: no bank conflicts

// 2·b − a: the next point of a line through a (t) and b (t + 1).
__device__ __forceinline__ zfr::Fr next_point(const zfr::Fr& a,
                                              const zfr::Fr& b) {
    return zfr::add_p(b, zfr::sub_p(b, a));
}

// This thread's unreduced sums of its pairs of group g, one per point,
// into column threadIdx.x of cols (word w of point t in row t*WIDE + w).
template <int K>
__device__ __forceinline__ void pair_sums(const Group& g, int block,
                                            uint32_t (*cols)[ROW]) {
    using namespace zfr;
    constexpr int NACC = K == 2 ? 3 : 4;
    uint32_t acc[NACC][WIDE];
#pragma unroll
    for (int t = 0; t < NACC; ++t)
#pragma unroll
        for (int w = 0; w < WIDE; ++w) acc[t][w] = 0u;
    const int np = summed_points(K, g.degree);
    const long long stride = (long long)g.nblocks * THREADS;
    const uint32_t* x = g.tabs;
    const uint32_t* y = g.tabs + g.n * 8;
    for (long long i = (long long)block * THREADS + threadIdx.x;
         i < g.live_pairs; i += stride) {
        const Fr x0 = load(x, 2 * i), x1 = load(x, 2 * i + 1);
        const Fr y0 = load(y, 2 * i), y1 = load(y, 2 * i + 1);
        if constexpr (K == 2) {
            mac_wide(acc[0], x0, y0);
            if (np > 1) mac_wide(acc[1], x1, y1);
            if (np > 2) mac_wide(acc[2], next_point(x0, x1), next_point(y0, y1));
        } else {
            const uint32_t* z = g.tabs + 2 * g.n * 8;
            const Fr z0 = load(z, 2 * i), z1 = load(z, 2 * i + 1);
            const Fr u0 = mont_mul(x0, y0);
            mac_wide(acc[0], u0, z0);
            if (np > 1) {
                const Fr u1 = mont_mul(x1, y1);
                mac_wide(acc[1], u1, z1);
                if (np > 2) {
                    const Fr z2 = next_point(z0, z1);
                    const Fr u2 = mont_mul(next_point(x0, x1),
                                           next_point(y0, y1));
                    mac_wide(acc[2], u2, z2);
                    if (np > 3) {
                        const Fr d = sub_p(u2, u1);
                        const Fr u3 = add_p(u0, add_p(d, add_p(d, d)));
                        mac_wide(acc[3], u3, next_point(z1, z2));
                    }
                }
            }
        }
    }
#pragma unroll
    for (int t = 0; t < NACC; ++t)
        if (t < np)
#pragma unroll
            for (int w = 0; w < WIDE; ++w)
                cols[t * WIDE + w][threadIdx.x] = acc[t][w];
}


constexpr int LANES = 4;                     // the split: threads a pair
constexpr int SPLIT_PAIRS = THREADS / LANES; // pairs a split block takes

// lo + t·(hi − lo) for t = 0, 1, 2, given d = hi − lo.
__device__ __forceinline__ zfr::Fr at_point(int t, const zfr::Fr& lo,
                                            const zfr::Fr& hi,
                                            const zfr::Fr& d) {
    return zfr::add_p(zfr::pick(t == 0, lo, hi),
                      zfr::pick(t == 2, d, zfr::zero()));
}

// The split: this thread's unreduced sum of point t = lane % 4 over its
// pairs of group g, into column threadIdx.x / 4 of rows t*WIDE .. t*WIDE +
// 16 of cols. The four lanes of a pair read the same entries, which a
// warp's load serves once. Every lane runs the same code (no divergence)
// except where K = 3 extrapolates u_3; lanes past the group's points
// compute values nobody reads.
template <int K>
__device__ __forceinline__ void point_sums(const Group& g, int block,
                                           uint32_t (*cols)[ROW]) {
    using namespace zfr;
    uint32_t acc[WIDE];
#pragma unroll
    for (int w = 0; w < WIDE; ++w) acc[w] = 0u;
    const int lane = threadIdx.x % LANES;
    const int t = K == 2 ? min(lane, 2) : lane;
    const int tt = min(lane, 2);
    const long long stride = (long long)g.nblocks * SPLIT_PAIRS;
    const uint32_t* x = g.tabs;
    const uint32_t* y = g.tabs + g.n * 8;
    const uint32_t* z = g.tabs + 2 * g.n * 8;
    // the loop runs alike in a whole warp (the shuffles below need every
    // lane): a pair past the live prefix reads as zeros, a zero product
    const long long first = (long long)block * SPLIT_PAIRS
                            + threadIdx.x / 32 * (32 / LANES);
    for (long long i0 = first; i0 < g.live_pairs; i0 += stride) {
        const long long i = i0 + (threadIdx.x % 32) / LANES;
        Fr x0 = zero(), x1 = zero(), y0 = zero(), y1 = zero();
        Fr z0 = zero(), z1 = zero();
        if (i < g.live_pairs) {
            x0 = load(x, 2 * i); x1 = load(x, 2 * i + 1);
            y0 = load(y, 2 * i); y1 = load(y, 2 * i + 1);
            if (K == 3) { z0 = load(z, 2 * i); z1 = load(z, 2 * i + 1); }
        }
        const Fr xt = at_point(tt, x0, x1, sub_p(x1, x0));
        const Fr yt = at_point(tt, y0, y1, sub_p(y1, y0));
        if constexpr (K == 2) {
            mac_wide(acc, xt, yt);
        } else {
            const Fr dz = sub_p(z1, z0);
            // z_3 = z_1 + 2·dz
            const Fr zt = add_p(pick(t == 0, z0, z1),
                                t == 3 ? add_p(dz, dz)
                                       : pick(t == 2, dz, zero()));
            Fr u = mont_mul(xt, yt);        // lane 3: u_2, as lane 2
            // u_3 = u_0 + 3(u_2 − u_1), from the pair's lanes 0 and 1
            const int base = threadIdx.x & ~(LANES - 1) & 31;
            Fr u0, u1;
#pragma unroll
            for (int w = 0; w < 8; ++w) {
                u0.w[w] = __shfl_sync(0xffffffffu, u.w[w], base);
                u1.w[w] = __shfl_sync(0xffffffffu, u.w[w], base + 1);
            }
            if (t == 3) {
                const Fr d = sub_p(u, u1);
                u = add_p(u0, add_p(d, add_p(d, d)));
            }
            mac_wide(acc, u, zt);
        }
    }
#pragma unroll
    for (int w = 0; w < WIDE; ++w)
        cols[lane * WIDE + w][threadIdx.x / LANES] = acc[w];
}

__global__ void __launch_bounds__(THREADS)
product_evals_kernel(const __grid_constant__ Batch batch) {
    using namespace zfr;
    __shared__ uint32_t cols[COLS][ROW];
    __shared__ unsigned long long s64[COLS];
    __shared__ Fr terms[MAX_DEG1][3];
    int gi = 0;
    while (gi + 1 < batch.ngroups && (int)blockIdx.x >= batch.g[gi + 1].block0)
        ++gi;
    const Group& g = batch.g[gi];
    const int tid = threadIdx.x;
    const int np = summed_points(g.k, g.degree);
    const int ncols = np * WIDE;
    const int block = blockIdx.x - g.block0;
    if (g.lanes == 1) {
        if (g.k == 2) pair_sums<2>(g, block, cols);
        else pair_sums<3>(g, block, cols);
    } else {
        if (g.k == 2) point_sums<2>(g, block, cols);
        else point_sums<3>(g, block, cols);
    }
    __syncthreads();
    // thread c adds row c over the block's pairs (< 2^39); a group of more
    // than one block adds that into the group's column sums (< 2^49 for
    // 1024 blocks), ticket.cuh
    if (tid < ncols) {
        const int width = THREADS / g.lanes;
        unsigned long long s = 0;
#pragma unroll 8
        for (int i = 0; i < width; ++i) s += cols[tid][i];
        s64[tid] = s;
    }
    __syncthreads();
    if (!block_total(s64, ncols, batch.scratch + gi * SLOT, COLS, g.nblocks))
        return;
    // one reduction a point, its three Montgomery products on three threads
    if (tid < 3 * np) {
        uint32_t w[WIDE];
        normalize(s64 + tid / 3 * WIDE, w);
        terms[tid / 3][tid % 3] = wide_term(w, tid % 3);
    }
    __syncthreads();
    if (tid == 0) {
        Fr out[MAX_DEG1];
#pragma unroll
        for (int t = 0; t < MAX_DEG1; ++t)
            out[t] = t < np ? add_p(add_p(terms[t][0], terms[t][1]),
                                    terms[t][2])
                            : zero();
        if (g.k == 2 && g.degree == 3) {
            const Fr d = sub_p(out[2], out[1]);
            out[3] = add_p(out[0], add_p(d, add_p(d, d)));
        }
#pragma unroll
        for (int t = 0; t < MAX_DEG1; ++t)
            if (t <= g.degree) store(g.out, t, out[t]);
    }
}

}  // namespace

// One group as the host describes it.
struct ZfrEvalGroup {
    const void* tabs;          // (k, n, 8) int32, 16-byte aligned
    void* out;                 // (degree + 1, 8) int32
    long long n, live_pairs;
    int k, degree, lanes, nblocks;
};

// Launches one grouped kernel over `ngroups` groups (1..16) on `stream`.
// scratch: 16 * (4 * 17 + 1) unsigned 64-bit words that are zero, and that
// the kernel leaves zero. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a descriptor out of range.
extern "C" int zfr_product_evals(const ZfrEvalGroup* groups, int ngroups,
                                 void* scratch, void* stream) {
    if (ngroups < 1 || ngroups > MAX_GROUPS) return (int)cudaErrorInvalidValue;
    Batch batch;
    batch.ngroups = ngroups;
    batch.scratch = (unsigned long long*)scratch;
    int grid = 0;
    for (int i = 0; i < ngroups; ++i) {
        const ZfrEvalGroup& h = groups[i];
        if ((h.k != 2 && h.k != 3) || h.degree < 0 || h.degree >= MAX_DEG1 ||
            (h.lanes != 1 && h.lanes != LANES) || h.nblocks < 1 ||
            h.live_pairs < 0 || 2 * h.live_pairs > h.n)
            return (int)cudaErrorInvalidValue;
        Group& g = batch.g[i];
        g.tabs = (const uint32_t*)h.tabs;
        g.out = (uint32_t*)h.out;
        g.n = h.n;
        g.live_pairs = h.live_pairs;
        g.k = h.k;
        g.degree = h.degree;
        g.lanes = h.lanes;
        g.block0 = grid;
        g.nblocks = h.nblocks;
        grid += h.nblocks;
    }
    product_evals_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(batch);
    return (int)cudaGetLastError();
}
