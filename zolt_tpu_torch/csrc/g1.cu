// Kernel A: batched BN254 G1 Jacobian addition and doubling over Fp,
//
//   out[i] = a[i] + b[i]      (zg1_add)
//   out[i] = 2 a[i]           (zg1_double)
//
// Replaces zolt_tpu/curve/device.py pt_add and pt_double, which XLA
// vectorizes over the batch with every edge case computed and masked. Here
// one thread takes one pair and branches (g1.cuh jac_add, jac_double); the
// output words equal JAX's. The point formulas are the G1 kernels' device
// functions: the row MSM (rows_msm.cu) and the Pippenger (pippenger.cu)
// call them inside their own loops, so this launch is for whole batches
// only (tests and chip_smoke.py).
//
// Bound on Hopper: operations. A pair reads 192 bytes and writes 96, and
// an addition is 16 Montgomery products of 272 IMADs: some 15 IMADs a byte,
// above the card's 5 at HBM speed.
#include <cuda_runtime.h>

#include "g1.cuh"

namespace {

constexpr int THREADS = 128;

struct Points {
    const uint32_t *x, *y, *z;
};

struct Out {
    uint32_t *x, *y, *z;
};

__global__ void __launch_bounds__(THREADS)
g1_add_kernel(Points a, Points b, Out o, long long n) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    const zg1::Jac p = zg1::load_jac(a.x, a.y, a.z, i);
    const zg1::Jac q = zg1::load_jac(b.x, b.y, b.z, i);
    zg1::store_jac(o.x, o.y, o.z, i, zg1::jac_add(p, q));
}

__global__ void __launch_bounds__(THREADS)
g1_double_kernel(Points a, Out o, long long n) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    const zg1::Jac p = zg1::load_jac(a.x, a.y, a.z, i);
    zg1::store_jac(o.x, o.y, o.z, i, zg1::jac_double(p));
}

long long blocks(long long n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// Each pointer is an (n, 8) int32 array of Fp Montgomery words, 16-byte
// aligned. Returns cudaGetLastError() after the launch.
extern "C" int zg1_add(const void* ax, const void* ay, const void* az,
                       const void* bx, const void* by, const void* bz,
                       void* ox, void* oy, void* oz, long long n,
                       void* stream) {
    if (n < 0 || blocks(n) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    Points a{(const uint32_t*)ax, (const uint32_t*)ay, (const uint32_t*)az};
    Points b{(const uint32_t*)bx, (const uint32_t*)by, (const uint32_t*)bz};
    Out o{(uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz};
    g1_add_kernel<<<(unsigned)blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
        a, b, o, n);
    return (int)cudaGetLastError();
}

extern "C" int zg1_double(const void* ax, const void* ay, const void* az,
                          void* ox, void* oy, void* oz, long long n,
                          void* stream) {
    if (n < 0 || blocks(n) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    Points a{(const uint32_t*)ax, (const uint32_t*)ay, (const uint32_t*)az};
    Out o{(uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz};
    g1_double_kernel<<<(unsigned)blocks(n), THREADS, 0,
                       (cudaStream_t)stream>>>(a, o, n);
    return (int)cudaGetLastError();
}
