// Kernel 4: the eq-weighted (Gruen) round of stage 1's streaming-outer
// remaining rounds and of stage 2's ProductVirtualRemainder, with the fold
// of the previous round's challenge in the same pass. Three modes:
//
//   eval:       t0 = Σ_{i < pairs} e_i · a0_i · b0_i
//               t∞ = Σ_{i < pairs} e_i · (a1_i − a0_i)·(b1_i − b0_i)
//               a0_i = az[2i], a1_i = az[2i+1], b0_i, b1_i of bz alike,
//               e_i = E_out[off_out + (i >> h_in)]
//                     · E_in[off_in + (i & (2^h_in − 1))]
//   fold:       az'[i] = az[2i] + r·(az[2i+1] − az[2i]) for i < fold_pairs,
//               and bz' alike, into new tables of fold_pairs entries
//   fold, eval: the fold by round j's r, then round j+1's eval over
//               az', bz' (pairs = fold_pairs / 2)
//
// Replaces zolt_tpu/field/pallas_kernels.py product_round (_round_kernel),
// and its production form, the XLA zolt_tpu/zkvm/device_outer.py
// _eval_fixed with the _eq_gather and _fold_fixed. product_round evals and
// folds by the same r in one pass, which no Fiat–Shamir round can use (r is
// drawn from those evals); here a pass folds by the r drawn from the
// previous round's evals and evaluates the next round. The eq weight comes
// from the resident flat prefix-table stacks at the round's level offsets;
// the 2^n eq table is never built.
//
// The fused pass: next-round pair i reads az[4i..4i+3] and bz[4i..4i+3],
// folds them into az'[2i], az'[2i+1], bz'[2i], bz'[2i+1], writes those four
// and takes its products from the folded values in registers: one read of
// the old tables and one write of the new ones per round.
//
// Lazy products. A pair makes two reduced products, a0·b0 and Δa·Δb, and
// adds each times its "inner" eq factor into a 544-bit integer: no
// reduction. The "outer" factor, which a thread's pairs share, multiplies
// the thread's or the block's sum once, kept as an 832-bit integer
// (field_ptx.cuh mul_wide). Which factor is outer:
// - E_out, when a block's pairs lie in one E_out row (chunk <= 2^h_in, the
//   early rounds): the block adds its threads' sums first and weights the
//   block's sum once;
// - E_in, when h_in = 0 (the late rounds: E_in has one entry): likewise
//   once a block;
// - E_in, in between (0 < h_in, 2^h_in < chunk, 2^h_in dividing the pairs
//   a block step takes): every pair of a thread has the same E_in index,
//   and the thread weights its own sum once.
// Value: inner (xR) times a product (yR) sums to (Σ xy)R^2; times the
// outer factor, (Σ e·y)R^3; the finishing block reduces it once by R^{-2}
// (xwide_term, four Montgomery products on four threads a sum).
//
// One pass, no reduce launch: the blocks meet in one integer sum
// (ticket.cuh, shared with product_evals.cu), so the result does not
// depend on the order of the blocks.
//
// Two threads a pair: lane 0 folds az and sums t0, lane 1 folds bz and
// sums t∞, and they swap their pairs by warp shuffles. Most rounds are
// latency: the split halves a pair's serial chain of products. A pass that
// folds always takes this schedule. An eval-only pass (an engine's first
// round) takes a thread a pair past field/gruen.py SPLIT_MAX_PAIRS pairs,
// where a lane's one product no longer pays for its block's finish.
//
// Bound on Hopper, counted as IMADs (a 32x32-bit word product is two): a
// Montgomery product 272, a 256x256-bit product kept wide 128; per eval
// pair 2·272 + 2·128, per folded entry 272. At 2^16 pairs that is 52 M
// IMADs, 3.1 µs at the integer peak, above the 8.4 MB of az/bz at HBM
// speed (2.5 µs): operations bind it.
#include <cuda_runtime.h>

#include "field_ptx.cuh"
#include "ticket.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int LANES = 2;                    // the split: threads a pair
constexpr int NSUM = 2;                     // t0, t∞
constexpr int COLS = NSUM * zfr::XWIDE;     // words of the two sums
constexpr int ROW = THREADS + 1;            // padded: no bank conflicts
constexpr int FOLD = 1, EVAL = 2;           // mode bits

struct Round {
    const uint32_t* az;        // the input tables
    const uint32_t* bz;
    uint32_t* out;             // (2, fold_pairs, 8): az', bz'
    const uint32_t* e_out;     // the flat prefix-table stacks
    const uint32_t* e_in;
    uint32_t* evals;           // (2, 8): t0, t∞
    unsigned long long* scratch;   // COLS sums and a ticket, zero between
    zfr::Fr r;                 // the fold's challenge (Montgomery words)
    long long fold_pairs;      // pairs folded (fold modes)
    long long pairs;           // pairs evaluated (eval modes)
    long long chunk;           // consecutive quads a block takes
    long long off_out, off_in;
    int h_in, lanes, mode, nblocks;
};

// lo + r·(hi − lo) of pair i of t, or zero past the live pairs. The loads
// are predicated, not branched around, so the independent folds of a
// thread overlap (their Montgomery products are its longest chain).
__device__ __forceinline__ zfr::Fr fold_pair(const uint32_t* t, long long i,
                                             long long live,
                                             const zfr::Fr& r) {
    zfr::Fr lo = zfr::zero(), hi = zfr::zero();
    if (i < live) {
        lo = zfr::load(t, 2 * i);
        hi = zfr::load(t, 2 * i + 1);
    }
    return zfr::add_p(lo, zfr::mont_mul(zfr::sub_p(hi, lo), r));
}

__device__ __forceinline__ zfr::Fr swap_lanes(const zfr::Fr& v) {
    zfr::Fr r;
#pragma unroll
    for (int i = 0; i < 8; ++i)
        r.w[i] = __shfl_xor_sync(0xffffffffu, v.w[i], 1);
    return r;
}

// The eq factor every pair of this thread shares, or zero where it has
// none. A block in one E_out row: E_out of the row; h_in = 0: E_in's one
// entry; else (2^h_in divides a block step) E_in at the thread's slot.
__device__ __forceinline__ zfr::Fr outer_factor(const Round& R, int slot) {
    const long long row = 1LL << R.h_in;
    const long long first = blockIdx.x * R.chunk;
    if (R.chunk <= row)
        return first < R.pairs
            ? zfr::load(R.e_out, R.off_out + (first >> R.h_in)) : zfr::zero();
    const long long col = R.h_in ? slot & (row - 1) : 0;
    return col < R.pairs ? zfr::load(R.e_in, R.off_in + col) : zfr::zero();
}

// pair i of t, or zeros past the live pairs
__device__ __forceinline__ void load_pair(const uint32_t* t, long long i,
                                          long long live, zfr::Fr& lo,
                                          zfr::Fr& hi) {
    lo = zfr::zero();
    hi = zfr::zero();
    if (i < live) {
        lo = zfr::load(t, 2 * i);
        hi = zfr::load(t, 2 * i + 1);
    }
}

// This thread's share of the pass: the quads block*chunk + slot + PB*j,
// j < chunk/PB (a quad is a next-round pair: two pairs to fold, one pair
// to evaluate). Its unreduced sums go to column slot of cols (sum s in
// rows s*XWIDE ..): the 17-word sums, or, weighted by its own outer
// factor, 26 words. In the split, lane 0 takes az and t0, lane 1 bz and
// t∞, and they swap their pairs by shuffles. Every lane of a warp runs
// the same loop (the shuffles need them all): a quad past the live prefix
// reads zeros. The eq factor's load is issued first: it does not wait for
// the fold's stores. L = 1 (a thread a pair) only evaluates.
template <int L>
__device__ __forceinline__ void round_pass(const Round& R,
                                           const zfr::Fr& outer,
                                           uint32_t (*cols)[ROW]) {
    using namespace zfr;
    constexpr int PB = THREADS / L;         // quads a block step takes
    constexpr int NACC = L == 1 ? NSUM : 1;
    const int tid = threadIdx.x;
    const int lane = tid % L, slot = tid / L;
    const bool eval = R.mode & EVAL;
    const long long mask = (1LL << R.h_in) - 1;
    const bool by_row = R.chunk <= mask + 1;
    uint32_t acc[NACC][WIDE];
#pragma unroll
    for (int s = 0; s < NACC; ++s)
#pragma unroll
        for (int w = 0; w < WIDE; ++w) acc[s][w] = 0u;
    const int steps = (int)(R.chunk / PB);
    for (int j = 0; j < steps; ++j) {
        const long long q = blockIdx.x * R.chunk + slot + (long long)PB * j;
        Fr inner = zero();
        if (eval && q < R.pairs)
            inner = by_row ? load(R.e_in, R.off_in + (q & mask))
                           : load(R.e_out, R.off_out + (q >> R.h_in));
        Fr a0, a1, b0, b1;
        if constexpr (L == 1) {
            load_pair(R.az, q, R.pairs, a0, a1);
            load_pair(R.bz, q, R.pairs, b0, b1);
        } else {
            const uint32_t* t = lane ? R.bz : R.az;
            Fr x0, x1;
            if (R.mode & FOLD) {
                const long long F = R.fold_pairs;
                uint32_t* o = R.out + lane * F * 8;
                x0 = fold_pair(t, 2 * q, F, R.r);
                x1 = fold_pair(t, 2 * q + 1, F, R.r);
                if (2 * q < F) store(o, 2 * q, x0);
                if (2 * q + 1 < F) store(o, 2 * q + 1, x1);
            } else {
                load_pair(t, q, R.pairs, x0, x1);
            }
            const Fr y0 = swap_lanes(x0), y1 = swap_lanes(x1);
            a0 = pick(lane == 0, x0, y0);
            a1 = pick(lane == 0, x1, y1);
            b0 = pick(lane == 0, y0, x0);
            b1 = pick(lane == 0, y1, x1);
        }
        if (!eval) continue;
        if constexpr (L == 1) {
            mac_wide(acc[0], mont_mul(a0, b0), inner);
            mac_wide(acc[1], mont_mul(sub_p(a1, a0), sub_p(b1, b0)), inner);
        } else {
            // lane 0: a0·b0, lane 1: Δa·Δb
            const Fr x = pick(lane == 0, a0, sub_p(a1, a0));
            const Fr y = pick(lane == 0, b0, sub_p(b1, b0));
            mac_wide(acc[0], mont_mul(x, y), inner);
        }
    }
    if (!eval) return;
    const bool per_thread = !by_row && R.h_in != 0;
#pragma unroll
    for (int s = 0; s < NACC; ++s) {
        const int sum = L == 1 ? s : lane;
        if (per_thread) {
            uint32_t x[XWIDE];
            mul_wide(x, acc[s], outer);
#pragma unroll
            for (int w = 0; w < XWIDE; ++w)
                cols[sum * XWIDE + w][slot] = x[w];
        } else {
#pragma unroll
            for (int w = 0; w < WIDE; ++w)
                cols[sum * XWIDE + w][slot] = acc[s][w];
        }
    }
}

__global__ void
gruen_round_kernel(const __grid_constant__ Round R) {
    using namespace zfr;
    __shared__ uint32_t cols[COLS][ROW];
    __shared__ unsigned long long s64[COLS];
    __shared__ Fr terms[NSUM][4];
    const int tid = threadIdx.x;
    const bool eval = R.mode & EVAL;
    const Fr outer = eval ? outer_factor(R, tid / R.lanes) : zero();
    if (R.lanes == 1) round_pass<1>(R, outer, cols);
    else round_pass<LANES>(R, outer, cols);
    if (!eval) return;
    __syncthreads();
    const int width = THREADS / R.lanes;
    const bool by_row = R.chunk <= (1LL << R.h_in);
    if (!by_row && R.h_in != 0) {
        // each thread weighted its own sums: add the 26-word products
        if (tid < COLS) {
            unsigned long long s = 0;
#pragma unroll 8
            for (int i = 0; i < width; ++i) s += cols[tid][i];
            s64[tid] = s;
        }
    } else {
        // the block's two 544-bit sums, then one product each by the
        // factor the whole block shares
        if (tid < NSUM * WIDE) {
            const int row = tid / WIDE * XWIDE + tid % WIDE;
            unsigned long long s = 0;
#pragma unroll 8
            for (int i = 0; i < width; ++i) s += cols[row][i];
            s64[row] = s;
        }
        __syncthreads();
        if (tid < NSUM) {
            uint32_t w[WIDE], x[XWIDE];
            normalize(s64 + tid * XWIDE, w);
            mul_wide(x, w, outer);
#pragma unroll
            for (int i = 0; i < XWIDE; ++i) s64[tid * XWIDE + i] = x[i];
        }
    }
    __syncthreads();
    if (!block_total(s64, COLS, R.scratch, COLS, R.nblocks)) return;
    if (tid < NSUM * 4) {
        uint32_t x[XWIDE];
        normalize(s64 + tid / 4 * XWIDE, x);
        terms[tid / 4][tid % 4] = xwide_term(x, tid % 4);
    }
    __syncthreads();
    if (tid < NSUM)
        store(R.evals, tid, add_p(add_p(terms[tid][0], terms[tid][1]),
                                  add_p(terms[tid][2], terms[tid][3])));
}

}  // namespace

// One round as the host describes it.
struct ZfrGruenRound {
    const void* az;            // (>= 2 * max(fold_pairs, pairs), 8) int32
    const void* bz;
    void* out;                 // (2, fold_pairs, 8) int32 (fold modes)
    const void* e_out;         // flat prefix-table stacks, (m, 8) int32
    const void* e_in;
    void* evals;               // (2, 8) int32 (eval modes)
    void* scratch;             // COLS + 1 unsigned 64-bit words, zero
    long long fold_pairs, pairs, off_out, off_in;
    uint32_t r[8];
    int h_in, lanes, steps, mode;   // steps: quads a thread takes
};

// Launches one pass on `stream`. mode: 1 fold, 2 eval, 3 fold then eval
// (pairs must then be fold_pairs / 2); a fold takes LANES lanes. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// descriptor out of range.
extern "C" int zfr_gruen_round(const ZfrGruenRound* h, void* stream) {
    const bool fold = h->mode & FOLD, eval = h->mode & EVAL;
    if (h->mode < 1 || h->mode > 3 || (h->lanes != 1 && h->lanes != LANES) ||
        (fold && h->lanes != LANES) ||
        h->steps < 1 || h->h_in < 0 || h->h_in > 62 || h->fold_pairs < 0 ||
        h->pairs < 0 || (fold && eval && h->pairs != h->fold_pairs / 2) ||
        (!eval && h->pairs != 0) || (!fold && h->fold_pairs != 0))
        return (int)cudaErrorInvalidValue;
    Round R;
    R.az = (const uint32_t*)h->az;
    R.bz = (const uint32_t*)h->bz;
    R.out = (uint32_t*)h->out;
    R.e_out = (const uint32_t*)h->e_out;
    R.e_in = (const uint32_t*)h->e_in;
    R.evals = (uint32_t*)h->evals;
    R.scratch = (unsigned long long*)h->scratch;
    for (int w = 0; w < 8; ++w) R.r.w[w] = h->r[w];
    R.fold_pairs = h->fold_pairs;
    R.pairs = h->pairs;
    R.chunk = (long long)(THREADS / h->lanes) * h->steps;
    R.off_out = h->off_out;
    R.off_in = h->off_in;
    R.h_in = h->h_in;
    R.lanes = h->lanes;
    R.mode = h->mode;
    // a block's quads lie in one E_out row, or each thread's share one
    // E_in index (2^h_in divides the quads a block step takes)
    const long long row = 1LL << h->h_in;
    if (eval && R.chunk > row && row > THREADS / h->lanes)
        return (int)cudaErrorInvalidValue;
    const long long quads = fold ? (h->fold_pairs + 1) / 2 : h->pairs;
    const long long nblocks = quads ? (quads + R.chunk - 1) / R.chunk : 1;
    if (nblocks > (1LL << 24)) return (int)cudaErrorInvalidValue;
    R.nblocks = (int)nblocks;
    gruen_round_kernel<<<R.nblocks, THREADS, 0, (cudaStream_t)stream>>>(R);
    return (int)cudaGetLastError();
}
