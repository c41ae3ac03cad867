// Kernels 2 and 3: the round evaluations of a K-factor product sumcheck,
//
//   evals[t] = Σ_{i < live_pairs} Π_{j<K} (lo_j[i] + t·(hi_j[i] − lo_j[i]))
//   t = 0..degree,  lo_j[i] = tab_j[2i], hi_j[i] = tab_j[2i+1]
//
// K = 2 replaces zolt_tpu/field/pallas_redc.py eval_rows_k2
// (_eval_rows_k2_kernel plus the host decode_eval_rows_k2); K = 3 replaces
// eval_rows_k3 (_eval_rows_k3_kernel plus decode_eval_rows_k3). The TPU
// forms accumulate raw byte-plane products on the matrix unit and finish
// on the host with one ·R^{-K}; they are exact only for n < 2^25. Here each
// thread extends its pairs in the field, multiplies in registers and keeps
// canonical field sums, so any n is exact and the output is the finished
// (degree+1, 8) Montgomery evals: no host decode.
//
// Layout of the reduction: pass 1 is a grid-stride loop, one field
// accumulator per t in each thread, a warp-shuffle and shared-memory block
// sum, one partial per block; pass 2 (one block) sums the partials. Sums
// are mod p, so their order does not change a byte.
//
// Bound on Hopper: a memory-bound stream of K·64 bytes per live pair
// (dead pairs are zero and are not read). Per pair it does (K−1)·(degree+1)
// Montgomery multiplies (~64 IMADs each): about 400 IMADs per 192 bytes
// for K = 3, degree 3, which keeps the integer pipes, not HBM, close to
// the limit; register pressure (K·16 + 4·8 live words) caps occupancy.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int MAX_DEG1 = 4;   // degree <= 3

template <int K>
__global__ void __launch_bounds__(128)
product_evals_kernel(const uint32_t* __restrict__ tabs, long long n,
                     long long live_pairs, int degree,
                     uint32_t* __restrict__ partials) {
    using namespace zfr;
    Fr acc[MAX_DEG1];
#pragma unroll
    for (int t = 0; t < MAX_DEG1; ++t) acc[t] = zero();
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < live_pairs; i += stride) {
        Fr v[K], d[K];
#pragma unroll
        for (int j = 0; j < K; ++j) {
            const uint32_t* tab = tabs + (long long)j * n * 8;
            v[j] = load(tab, 2 * i);
            d[j] = sub(load(tab, 2 * i + 1), v[j]);
        }
#pragma unroll
        for (int t = 0; t < MAX_DEG1; ++t) {
            if (t <= degree) {
                if (t > 0) {
#pragma unroll
                    for (int j = 0; j < K; ++j) v[j] = add(v[j], d[j]);
                }
                Fr prod = v[0];
#pragma unroll
                for (int j = 1; j < K; ++j) prod = mul(prod, v[j]);
                acc[t] = add(acc[t], prod);
            }
        }
    }
    block_sum<MAX_DEG1>(acc);
    if (threadIdx.x == 0) {
#pragma unroll
        for (int t = 0; t < MAX_DEG1; ++t)
            store(partials, (long long)blockIdx.x * MAX_DEG1 + t, acc[t]);
    }
}

template <int K>
int launch(const void* tabs, long long n, long long live_pairs, int degree,
           void* partials, int nblocks, void* out, cudaStream_t s) {
    product_evals_kernel<K><<<nblocks, 128, 0, s>>>(
        (const uint32_t*)tabs, n, live_pairs, degree, (uint32_t*)partials);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    zfr_reduce_partials<MAX_DEG1><<<1, 256, 0, s>>>(
        (const uint32_t*)partials, nblocks, degree + 1, (uint32_t*)out);
    return (int)cudaGetLastError();
}

}  // namespace

// tabs: (k, n, 8) int32 device buffer, k in {2, 3}; partials: scratch of
// nblocks * 4 elements (nblocks * 128 bytes); out: (degree+1, 8) int32.
// Returns cudaGetLastError() after the launches (or cudaErrorInvalidValue
// for k or degree out of range).
extern "C" int zfr_product_evals(const void* tabs, int k, long long n,
                                 long long live_pairs, int degree,
                                 void* partials, int nblocks, void* out,
                                 void* stream) {
    if (degree < 0 || degree >= MAX_DEG1 || nblocks < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (k == 2) return launch<2>(tabs, n, live_pairs, degree, partials, nblocks, out, s);
    if (k == 3) return launch<3>(tabs, n, live_pairs, degree, partials, nblocks, out, s);
    return (int)cudaErrorInvalidValue;
}
