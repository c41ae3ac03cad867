// Kernel 1: the sumcheck challenge fold over a stack of fixed-size tables.
//
//   out[j][i] = t[j][2i] + r·(t[j][2i+1] − t[j][2i])   for i < live_pairs
//   out[j][i] = 0                                        for live_pairs <= i < n
//
// Replaces the TPU kernels of zolt_tpu/field/pallas_redc.py that compute
// this one function: fold_tail (_fold_tail_kernel), fold_tail_stack
// (_fold_tail_stack_kernel), fold_rows_stack (_fold_rows_stack_kernel) and
// the superseded fold_shared (_fold_kernel). Their byte-plane Toeplitz
// products, bf16 dots and packed 128-lane rows exist only for the TPU's
// matrix unit and lane tiling; here each thread folds one pair with one
// CIOS Montgomery multiply in registers (lo + r·(hi − lo) equals the TPU's
// single REDC of (1−r)·lo + r·hi, both canonical).
//
// Bound on Hopper: a memory-bound stream. Per live pair it reads 64 bytes
// and writes 32; a dead slot writes 32 zero bytes and reads nothing (the
// zero tail is an invariant the round-eval sums rely on). The multiply is
// ~64 IMADs per pair, far below the integer pipes' rate at HBM speed.
// Out of place: an in-place fold races (element i is written while pair
// 2i/2i+1 may still be read by another block).
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

struct R8 {
    uint32_t w[8];
};

__global__ void __launch_bounds__(256)
fold_kernel(const uint32_t* __restrict__ tabs, uint32_t* __restrict__ out,
            R8 r, long long n, long long live_pairs) {
    using namespace zfr;
    const long long j = blockIdx.y;
    const uint32_t* tab = tabs + j * n * 8;
    uint32_t* dst = out + j * n * 8;
    Fr rr;
#pragma unroll
    for (int i = 0; i < 8; ++i) rr.w[i] = r.w[i];
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        if (i < live_pairs) {
            Fr lo = load(tab, 2 * i), hi = load(tab, 2 * i + 1);
            store(dst, i, add(lo, mul(sub(hi, lo), rr)));
        } else {
            store(dst, i, zero());
        }
    }
}

}  // namespace

// tabs, out: (k, n, 8) int32 device buffers (16-byte aligned); r: the
// challenge's 8 Montgomery words (host memory); stream: a cudaStream_t.
// Returns cudaGetLastError() after the launch.
extern "C" int zfr_fold(const void* tabs, void* out, const uint32_t* r,
                        int k, long long n, long long live_pairs,
                        void* stream) {
    R8 rv;
    for (int i = 0; i < 8; ++i) rv.w[i] = r[i];
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 4096) blocks = 4096;
    if (blocks < 1) blocks = 1;
    dim3 grid((unsigned)blocks, (unsigned)k);
    fold_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)tabs, (uint32_t*)out, rv, n, live_pairs);
    return (int)cudaGetLastError();
}
