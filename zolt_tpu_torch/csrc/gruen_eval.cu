// Kernel 4: the eq-weighted (Gruen) round of stage 1's streaming-outer
// remaining rounds and of stage 2's ProductVirtualRemainder,
//
//   t0 = Σ_{i < live_pairs} e_i · az[2i] · bz[2i]
//   t∞ = Σ_{i < live_pairs} e_i · (az[2i+1] − az[2i]) · (bz[2i+1] − bz[2i])
//   e_i = E_out[off_out + (i >> h_in)] · E_in[off_in + (i & (2^h_in − 1))]
//
// Replaces the eval half of zolt_tpu/field/pallas_kernels.py product_round
// (_round_kernel), whose production form is the XLA
// zolt_tpu/zkvm/device_outer.py _eval_fixed with the _eq_gather. The eq
// weight is formed in-kernel from the resident flat prefix-table stacks at
// the round's level offsets; the 2^n eq table is never built. The fold half
// of product_round is kernel 1 (fold.cu): eval and fold stay separate
// launches because the challenge exists only after the evals are absorbed.
//
// Bound on Hopper: a memory-bound stream of 128 bytes of az/bz per live
// pair; the E_out/E_in stacks are small (2^(n/2) entries) and stay in L2.
// Five Montgomery multiplies per pair (~320 IMADs) put the integer pipes
// near their limit at HBM speed. Reduction as in product_evals.cu: a
// per-block field sum, then one block over the partials.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

__global__ void __launch_bounds__(128)
gruen_eval_kernel(const uint32_t* __restrict__ az,
                  const uint32_t* __restrict__ bz,
                  const uint32_t* __restrict__ e_out,
                  const uint32_t* __restrict__ e_in, long long off_out,
                  long long off_in, int h_in, long long live_pairs,
                  uint32_t* __restrict__ partials) {
    using namespace zfr;
    Fr acc[2] = {zero(), zero()};
    const long long mask = (1LL << h_in) - 1;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < live_pairs; i += stride) {
        Fr e = mul(load(e_out, off_out + (i >> h_in)),
                   load(e_in, off_in + (i & mask)));
        Fr a0 = load(az, 2 * i), a1 = load(az, 2 * i + 1);
        Fr b0 = load(bz, 2 * i), b1 = load(bz, 2 * i + 1);
        acc[0] = add(acc[0], mul(e, mul(a0, b0)));
        acc[1] = add(acc[1], mul(e, mul(sub(a1, a0), sub(b1, b0))));
    }
    block_sum<2>(acc);
    if (threadIdx.x == 0) {
        store(partials, 2LL * blockIdx.x, acc[0]);
        store(partials, 2LL * blockIdx.x + 1, acc[1]);
    }
}

}  // namespace

// az, bz: (n, 8) int32 device buffers; e_out, e_in: the flat prefix-table
// stacks, (m, 8) int32; partials: scratch of nblocks * 2 elements; out:
// (2, 8) int32 [t0, t∞]. Returns cudaGetLastError() after the launches.
extern "C" int zfr_gruen_eval(const void* az, const void* bz,
                              const void* e_out, const void* e_in,
                              long long off_out, long long off_in, int h_in,
                              long long live_pairs, void* partials,
                              int nblocks, void* out, void* stream) {
    if (h_in < 0 || h_in > 62 || nblocks < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    gruen_eval_kernel<<<nblocks, 128, 0, s>>>(
        (const uint32_t*)az, (const uint32_t*)bz, (const uint32_t*)e_out,
        (const uint32_t*)e_in, off_out, off_in, h_in, live_pairs,
        (uint32_t*)partials);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    zfr_reduce_partials<2><<<1, 256, 0, s>>>(
        (const uint32_t*)partials, nblocks, 2, (uint32_t*)out);
    return (int)cudaGetLastError();
}
