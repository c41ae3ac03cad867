// The single-pass finish shared by the reducing kernels (product_evals.cu,
// gruen_round.cu): a sum across the blocks of one launch, in integers, that
// does not depend on the order of the blocks.
//
// Each block holds its column sums, 64-bit integers, in shared memory. A
// group of one block is done. In a larger group each block adds its sums
// into the group's slot in device memory (integer atomics, which commute)
// and takes a ticket from the slot's counter; the block that takes the last
// ticket takes the totals and leaves the slot and the counter at zero for
// the next launch, so the caller allocates nothing per launch.
#pragma once

namespace zfr {

// s64: this block's ncols column sums (shared memory; ncols <= blockDim.x).
// slot: the group's ncols sums and, at slot[ncols_max], its ticket, zero
// between launches. Every thread of the block calls it; it returns the same
// in every thread: true in the block that finishes, which then holds the
// group's totals in s64.
__device__ __forceinline__ bool block_total(unsigned long long* s64,
                                            int ncols,
                                            unsigned long long* slot,
                                            int ncols_max, int nblocks) {
    __shared__ bool last;
    if (nblocks == 1) return true;
    const int tid = threadIdx.x;
    if (tid < ncols) {
        atomicAdd(slot + tid, s64[tid]);
        __threadfence();
    }
    __syncthreads();
    if (tid == 0) {
        last = atomicAdd(slot + ncols_max, 1ull) ==
               (unsigned long long)nblocks - 1;
        if (last) slot[ncols_max] = 0ull;
    }
    __syncthreads();
    if (!last) return false;
    __threadfence();
    if (tid < ncols) s64[tid] = atomicExch(slot + tid, 0ull);
    __syncthreads();
    return true;
}

// Carry-normalizes NW 64-bit column sums into NW words. The callers' sums
// are below 2^(32 NW), so nothing carries out.
template <int NW>
__device__ __forceinline__ void normalize(const unsigned long long* s,
                                          uint32_t (&w)[NW]) {
    unsigned long long carry = 0;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
        const unsigned long long v = s[i] + carry;
        w[i] = (uint32_t)v;
        carry = v >> 32;
    }
}

}  // namespace zfr
