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
// (Horner over the planes by batched doublings). Here one warp takes one
// row: each lane forms its groups' subset bytes from the row's u8 scalars
// in registers (no index planes), runs Horner over the planes on its own
// accumulator (doubling distributes over the sum, so each lane may), adds
// the table points with mixed additions, skipping the identity entries
// (byte 0, and sums that cancel), and the warp's 32 partial sums meet by
// shuffles. One Jacobian point a row goes out. Nothing is gathered into
// device memory, so nothing is chunked.
//
// Bound on Hopper: operations. A mixed addition is 11 Montgomery products
// of 272 IMADs for 64 bytes of table and 8 of scalars; the one-hot cubes of
// sound mode have few non-zero bytes, and their rows are cheap.
#include <cuda_runtime.h>

#include "g1.cuh"

namespace {

constexpr int THREADS = 128;           // four rows a block
constexpr int ROWS_A_BLOCK = THREADS / 32;

// bit k of each of the 8 bytes of v, packed: bit j from byte j. The
// multiply moves byte j's bit (at 8j) to bit 56 + j; no two partial
// products share a bit, so nothing carries into the top byte.
__device__ __forceinline__ uint32_t subset_byte(uint64_t v, int k) {
    const uint64_t m = (v >> k) & 0x0101010101010101ull;
    return (uint32_t)((m * 0x0102040810204080ull) >> 56);
}

__global__ void __launch_bounds__(THREADS)
row_msm_kernel(const uint8_t* __restrict__ vals, long long rows, int cols,
               int nplanes, const uint32_t* __restrict__ table,
               const uint8_t* __restrict__ valid, uint32_t* ox, uint32_t* oy,
               uint32_t* oz) {
    const long long row = (long long)blockIdx.x * ROWS_A_BLOCK +
                          threadIdx.x / 32;
    if (row >= rows) return;               // whole warps only
    const int lane = threadIdx.x % 32;
    const int nch = cols / 8;
    const uint64_t* v = reinterpret_cast<const uint64_t*>(vals + row * cols);
    zg1::Jac acc = zg1::identity();
    for (int k = nplanes - 1; k >= 0; --k) {
        if (k != nplanes - 1) acc = zg1::jac_double(acc);
        for (int g = lane; g < nch; g += 32) {
            const uint32_t s = subset_byte(v[g], k);
            const long long e = (long long)g * 256 + s;
            if (s == 0 || !valid[e]) continue;
            const zfr::Fr x = zfr::load(table, 2 * e);
            const zfr::Fr y = zfr::load(table, 2 * e + 1);
            acc = zg1::jac_add_affine(acc, x, y);
        }
    }
    acc = zg1::warp_sum(acc);
    if (lane == 0) zg1::store_jac(ox, oy, oz, row, acc);
}

}  // namespace

// vals: (rows, cols) u8 scalars below 2^nplanes, 8-byte aligned; table:
// (cols / 8 * 256, 16) int32, an entry's x words then its y words; valid:
// (cols / 8 * 256,) u8; out: three (rows, 8) int32 arrays, 16-byte aligned.
// Returns cudaGetLastError() after the launch.
extern "C" int zg1_row_msm(const void* vals, long long rows, int cols,
                           int nplanes, const void* table, const void* valid,
                           void* ox, void* oy, void* oz, void* stream) {
    if (rows < 0 || cols < 8 || cols % 8 || nplanes < 1 || nplanes > 8)
        return (int)cudaErrorInvalidValue;
    const long long grid = (rows + ROWS_A_BLOCK - 1) / ROWS_A_BLOCK;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (rows == 0) return (int)cudaSuccess;
    row_msm_kernel<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)vals, rows, cols, nplanes, (const uint32_t*)table,
        (const uint8_t*)valid, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz);
    return (int)cudaGetLastError();
}
