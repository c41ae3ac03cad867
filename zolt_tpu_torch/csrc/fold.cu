// Kernel 1: the sumcheck challenge fold of the live prefix of several table
// stacks ("groups") in one launch,
//
//   out[j][i] = t[j][2i] + r·(t[j][2i+1] − t[j][2i])   for i < live_pairs
//
// for each group's k tables t[j] and its own challenge r. The output holds
// the new live prefix only, (k, live_pairs, 8): nothing is written behind
// it, since no reader of the port's engines looks past the live prefix.
//
// Replaces the TPU kernels of zolt_tpu/field/pallas_redc.py that compute
// this one function: fold_tail (_fold_tail_kernel), fold_tail_stack
// (_fold_tail_stack_kernel), fold_rows_stack (_fold_rows_stack_kernel) and
// the superseded fold_shared (_fold_kernel). Their byte-plane Toeplitz
// products, bf16 dots, packed 128-lane rows and fixed-size tables behind a
// zero tail exist for the TPU's matrix unit, its lane tiling and XLA's
// static shapes; here each thread folds one pair with one CIOS Montgomery
// product (field_ptx.cuh mont_mul; lo + r·(hi − lo) equals the TPU's
// single REDC of (1−r)·lo + r·hi, both canonical).
//
// Bound on Hopper: a memory-bound stream. Per live pair it reads 64 bytes
// and writes 32 (16-byte vector loads and stores); the product is 272
// IMADs, below the integer pipes' rate at HBM speed. The grid is sized to
// the live work, never to the table, so a round with few live pairs costs
// little more than the launch; and all of a round's engines fold in one
// launch. Up to 16 groups go by value in a __grid_constant__ parameter, as
// in product_evals.cu; blocks find their group from a prefix of block
// counts and their table from their block index within the group.
// Out of place: an in-place fold races (element i is written while pair
// 2i/2i+1 may still be read by another block).
#include <cuda_runtime.h>

#include "field_ptx.cuh"

namespace {

constexpr int MAX_GROUPS = 16;
constexpr int THREADS = 256;
constexpr int MAX_BLOCKS_A_TABLE = 1024;   // threads walk further pairs

struct Group {
    const uint32_t* src;       // k tables of src_n entries
    uint32_t* dst;             // k tables of live_pairs entries
    long long src_n, live_pairs;
    zfr::Fr r;                 // Montgomery words of the challenge
    int k;
    int block0, per_table;     // this group's first block; blocks a table
};

struct Batch {
    Group g[MAX_GROUPS];
    int ngroups;
};

__global__ void __launch_bounds__(THREADS)
fold_kernel(const __grid_constant__ Batch batch) {
    using namespace zfr;
    int gi = 0;
    while (gi + 1 < batch.ngroups && (int)blockIdx.x >= batch.g[gi + 1].block0)
        ++gi;
    const Group& g = batch.g[gi];
    const int b = blockIdx.x - g.block0;
    const int j = b / g.per_table;
    const uint32_t* tab = g.src + j * g.src_n * 8;
    uint32_t* dst = g.dst + j * g.live_pairs * 8;
    const long long stride = (long long)g.per_table * THREADS;
    for (long long i = (long long)(b - j * g.per_table) * THREADS +
                       threadIdx.x;
         i < g.live_pairs; i += stride) {
        const Fr lo = load(tab, 2 * i), hi = load(tab, 2 * i + 1);
        store(dst, i, add_p(lo, mont_mul(sub_p(hi, lo), g.r)));
    }
}

}  // namespace

// One group as the host describes it.
struct ZfrFoldGroup {
    const void* src;           // (k, src_n, 8) int32, 16-byte aligned
    void* dst;                 // (k, live_pairs, 8) int32, 16-byte aligned
    long long src_n, live_pairs;
    uint32_t r[8];             // the challenge's Montgomery words
    int k;
};

// Launches one grouped fold over `ngroups` groups (1..16) on `stream`.
// Groups with no live pair take no block. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a descriptor out of range.
extern "C" int zfr_fold(const ZfrFoldGroup* groups, int ngroups,
                        void* stream) {
    if (ngroups < 1 || ngroups > MAX_GROUPS) return (int)cudaErrorInvalidValue;
    Batch batch;
    int used = 0, grid = 0;
    for (int i = 0; i < ngroups; ++i) {
        const ZfrFoldGroup& h = groups[i];
        if (h.k < 1 || h.live_pairs < 0 || 2 * h.live_pairs > h.src_n)
            return (int)cudaErrorInvalidValue;
        if (h.live_pairs == 0) continue;
        Group& g = batch.g[used++];
        g.src = (const uint32_t*)h.src;
        g.dst = (uint32_t*)h.dst;
        g.src_n = h.src_n;
        g.live_pairs = h.live_pairs;
        for (int w = 0; w < 8; ++w) g.r.w[w] = h.r[w];
        g.k = h.k;
        long long per = (h.live_pairs + THREADS - 1) / THREADS;
        if (per > MAX_BLOCKS_A_TABLE) per = MAX_BLOCKS_A_TABLE;
        g.per_table = (int)per;
        g.block0 = grid;
        grid += g.k * g.per_table;
    }
    if (used == 0) return (int)cudaSuccess;
    batch.ngroups = used;
    fold_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(batch);
    return (int)cudaGetLastError();
}
