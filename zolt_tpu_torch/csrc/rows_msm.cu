// Kernel B: the fixed-basis row MSMs of small-scalar polynomials by
// subset sums,
//
//   out[row] = Σ_k 2^k · Σ_g table[g][byte_k(row, g)]      k < nplanes
//
// where byte_k(row, g) packs bit k of the row's 8 scalars of column group g
// (bit j for column 8g + j) and table[g][s] is the affine sum of the basis
// points of group g that the subset s picks (native
// bn254_g1_subset_tables_mont: Montgomery words, `valid` 0 where the sum
// is the identity). With scalars below 2^nplanes that is Σ_c v_c · P_c,
// the Dory row commitment of one matrix row.
//
// Replaces zolt_tpu/msm/rows_device.py _plane_sums (a gather of every
// (plane, row, group) table point into HBM, then a log2(groups) tree of
// batched Jacobian adds, in chunks of SLOT_CAP points) and _horner_planes
// (Horner over the planes by batched doublings).
//
// Bound on Hopper: operations. A mixed addition is 11 Montgomery products
// of 272 IMADs for 64 bytes of table and 8 of scalars. The rows are
// sparse and skewed: the sound prove's one-hot cubes average 13 non-zero
// subset bytes a row among 128 groups, most rows none and the rest near
// all; a compat row has up to 128 over 32 groups and four planes. So a
// row gets the lanes its work needs, LANES of them (4 or 8, chosen by the
// wrapper from the density of the points it counts): lane j of a row
// takes a contiguous share of the row's groups, skips ahead to its next
// non-zero subset byte whose table entry is not the identity (a cheap
// scan over the u8 scalars), and only then adds, so the lanes of a warp
// issue their mixed additions together and a warp carries 32 / LANES
// rows. Horner over the planes runs on each lane's accumulator (doubling
// distributes over the sum). The row's lanes meet in log2(LANES) levels
// of shuffles. One Jacobian point a row goes out; nothing is gathered
// into device memory.
#include <cuda_runtime.h>

#include "g1.cuh"

namespace {

constexpr int THREADS = 128;

// bit k of each of the 8 bytes of v, packed: bit j from byte j. The
// multiply moves byte j's bit (at 8j) to bit 56 + j; no two partial
// products share a bit, so nothing carries into the top byte.
__device__ __forceinline__ uint32_t subset_byte(uint64_t v, int k) {
    const uint64_t m = (v >> k) & 0x0101010101010101ull;
    return (uint32_t)((m * 0x0102040810204080ull) >> 56);
}

template <int LANES>
__global__ void __launch_bounds__(THREADS)
row_msm_kernel(const uint8_t* __restrict__ vals, long long rows, int cols,
               int nplanes, const uint32_t* __restrict__ table,
               const uint8_t* __restrict__ valid, uint32_t* ox, uint32_t* oy,
               uint32_t* oz) {
    const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
    const long long row = t / LANES;
    const int j = threadIdx.x % LANES;
    const bool live = row < rows;          // dead lanes still shuffle
    const int nch = cols / 8;
    const int per = (nch + LANES - 1) / LANES;
    const int g0 = min(nch, j * per), g1 = min(nch, g0 + per);
    const uint64_t* v =
        reinterpret_cast<const uint64_t*>(vals + (live ? row : 0) * cols);
    zg1::Jac acc = zg1::identity();
    for (int k = nplanes - 1; live && k >= 0; --k) {
        if (k != nplanes - 1) acc = zg1::jac_double(acc);
        for (int g = g0;; ++g) {
            long long e = 0;
            for (; g < g1; ++g) {          // the next point to add
                const uint32_t s = subset_byte(v[g], k);
                e = (long long)g * 256 + s;
                if (s != 0 && valid[e]) break;
            }
            if (g >= g1) break;
            acc = zg1::jac_add_affine(acc, zfr::load(table, 2 * e),
                                      zfr::load(table, 2 * e + 1));
        }
    }
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
    if (live && j == 0) zg1::store_jac(ox, oy, oz, row, acc);
}

template <int LANES>
int launch(const void* vals, long long rows, int cols, int nplanes,
           const void* table, const void* valid, void* ox, void* oy,
           void* oz, void* stream) {
    const long long grid = (rows * LANES + THREADS - 1) / THREADS;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    row_msm_kernel<LANES><<<(unsigned)grid, THREADS, 0,
                            (cudaStream_t)stream>>>(
        (const uint8_t*)vals, rows, cols, nplanes, (const uint32_t*)table,
        (const uint8_t*)valid, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz);
    return (int)cudaGetLastError();
}

}  // namespace

// vals: (rows, cols) u8 scalars below 2^nplanes, 8-byte aligned; lanes: a
// row's lanes, 4 or 8; table: (cols / 8 * 256, 16) int32, an
// entry's x words then its y words; valid: (cols / 8 * 256,) u8; out:
// three (rows, 8) int32 arrays, 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int zg1_row_msm(const void* vals, long long rows, int cols,
                           int nplanes, int lanes, const void* table,
                           const void* valid, void* ox, void* oy, void* oz,
                           void* stream) {
    if (rows < 0 || cols < 8 || cols % 8 || nplanes < 1 || nplanes > 8)
        return (int)cudaErrorInvalidValue;
    if (rows == 0) return (int)cudaSuccess;
    switch (lanes) {
#define ZG1_LANES(n)                                                      \
    case n:                                                               \
        return launch<n>(vals, rows, cols, nplanes, table, valid, ox, oy, \
                         oz, stream);
        ZG1_LANES(4) ZG1_LANES(8)
#undef ZG1_LANES
        default:
            return (int)cudaErrorInvalidValue;
    }
}
