// Kernel A: BN254 G1 Jacobian point sums over Fp, three entries,
//
//   out[i] = a[i] + b[i]                                  (zg1_add)
//   out[i] = 2 a[i]                                       (zg1_double)
//   out[i] = ((s_0[i] + s_1[i]) + s_2[i]) + ... + s_{k-1}[i]   (zg1_sum)
//
// Replaces zolt_tpu/curve/device.py pt_add and pt_double, which XLA
// vectorizes over the batch with every edge case computed and masked, and
// the fori_loop of pt_add over the gathered bucket arrays in
// zolt_tpu/msm/pippenger.py msm_mesh (zg1_sum, the left fold in the same
// order). The output words equal JAX's. The point formulas are g1.cuh's
// (add-2007-bl, dbl-2009-l, one called Fp product); the row MSM
// (rows_msm.cu) and the Pippenger (pippenger.cu) call those inside their
// own loops.
//
// zg1_sum, on the mesh's ladder: a pass folds k shards' arrays of 2048
// bucket points, k − 1 dependent additions a point. A thread a pair would
// fill 16 of the 132 SMs, and its 16 products in a row would make a step
// cost one addition's latency, far from any bound. So the fold runs in
// one launch, k − 1 steps inside the kernel, and a pair takes L lanes (4
// or 8; the wrapper picks it from n): add-2007-bl's 16 products form five
// layers of independent ones, {Z1Z1, Z2Z2, (Z1+Z2)²}, {U1, U2, Z2·Z2Z2,
// Z1·Z1Z1}, {S1, S2, I, Z3}, {J, V, rr²}, {rr·(V−X3), S1·J}, and
// dbl-2009-l's 7 three, {A, B, Y1·Z1}, {C, (X1+B)², E²}, {E·(D−X3)}.
// Lane l of a pair takes products l, l+L, ... of each layer and leaves
// them in the pair's slots in shared memory; the pair's lanes each hold
// the whole state and do the cheap additions themselves. A step is 5
// products deep, not 16, at both L (no layer has more than four
// products); 8 lanes spread few pairs over twice the SMs. Each step's
// next point loads while the step computes.
//
// zg1_add and zg1_double, batches: a thread a pair (g1.cuh jac_add,
// jac_double, branching on the case). Bound by operations: a pair reads
// 192 bytes and writes 96, an addition is 16 products of 272 IMADs, some
// 15 IMADs a byte, above the card's 5 at HBM speed. No path of the port
// launches them; tests and chip_smoke.py hold them to JAX's words.
#include <cuda_runtime.h>

#include "g1.cuh"

namespace {

using zg1::Fe;
using zg1::Jac;

constexpr int THREADS = 128;

struct Points {
    const uint32_t *x, *y, *z;
};

struct Out {
    uint32_t *x, *y, *z;
};

long long blocks(long long n, int per_block) {
    return (n + per_block - 1) / per_block;
}

// ---------------------------------------------------------------------------
// zg1_sum: L lanes a pair
// ---------------------------------------------------------------------------

// The widest layer, and a pair's words of slots (one more than the
// elements', so that the pairs of a warp read them from different banks).
constexpr int SLOTS = 4;
constexpr int SLOT_STRIDE = SLOTS * 8 + 1;

// The L lanes of one pair: its lane, the group's lanes in the warp, and
// the pair's slots.
struct Group {
    int lane;
    unsigned mask;
    uint32_t* slot;
};

// The products a[k]*b[k], k < K, of one layer: lane l takes k = l, l + L,
// ...; every lane of the group returns all K. The operands are picked
// without an indexed array, so they stay in registers.
template <int L, int K>
__device__ __forceinline__ void layer(const Group& g, const Fe (&a)[K],
                                      const Fe (&b)[K], Fe (&r)[K]) {
    static_assert(K <= SLOTS, "a layer wider than the slots");
#pragma unroll
    for (int i = 0; i < (K + L - 1) / L; ++i) {
        const int k = g.lane + i * L;
        if (k < K) {
            Fe x = a[0], y = b[0];
#pragma unroll
            for (int j = 1; j < K; ++j) {
                x = zfr::pick(k == j, a[j], x);
                y = zfr::pick(k == j, b[j], y);
            }
            const Fe p = zg1::mul(x, y);
#pragma unroll
            for (int w = 0; w < 8; ++w) g.slot[k * 8 + w] = p.w[w];
        }
    }
    __syncwarp(g.mask);
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
        for (int w = 0; w < 8; ++w) r[k].w[w] = g.slot[k * 8 + w];
    __syncwarp(g.mask);        // the slots are free for the next layer
}

// dbl-2009-l on the group's lanes: the words of g1.cuh's jac_double.
template <int L>
__device__ __forceinline__ Jac double_lanes(const Group& g, const Jac& p) {
    Fe r1[3], r2[3], r3[1];
    layer<L, 3>(g, {p.x, p.y, p.y}, {p.x, p.y, p.z}, r1);
    const Fe A = r1[0], B = r1[1];
    const Fe E = zg1::add(zg1::dbl(A), A);
    const Fe XB = zg1::add(p.x, B);
    layer<L, 3>(g, {B, XB, E}, {B, XB, E}, r2);
    const Fe C = r2[0];
    const Fe D = zg1::dbl(zg1::sub(zg1::sub(r2[1], A), C));
    Jac r;
    r.x = zg1::sub(r2[2], zg1::dbl(D));
    layer<L, 1>(g, {E}, {zg1::sub(D, r.x)}, r3);
    r.y = zg1::sub(r3[0], zg1::dbl(zg1::dbl(zg1::dbl(C))));
    r.z = zg1::dbl(r1[2]);
    return r;
}

// add-2007-bl with JAX's edge handling on the group's lanes: the words of
// g1.cuh's jac_add. Every case is the same for the group's lanes (they hold
// the same state). P + (−P) needs no branch: Z3 is a product by H = 0.
template <int L>
__device__ __forceinline__ Jac add_lanes(const Group& g, const Jac& a,
                                         const Jac& b) {
    if (zg1::is_zero(a.z)) return b;
    if (zg1::is_zero(b.z)) return a;
    Fe r1[3], r2[4], r3[4], r4[3], r5[2];
    const Fe Zs = zg1::add(a.z, b.z);
    layer<L, 3>(g, {a.z, b.z, Zs}, {a.z, b.z, Zs}, r1);
    const Fe Z1Z1 = r1[0], Z2Z2 = r1[1];
    layer<L, 4>(g, {a.x, b.x, b.z, a.z}, {Z2Z2, Z1Z1, Z2Z2, Z1Z1}, r2);
    const Fe U1 = r2[0];
    const Fe H = zg1::sub(r2[1], U1);
    const Fe H2 = zg1::dbl(H);
    const Fe Zh = zg1::sub(zg1::sub(r1[2], Z1Z1), Z2Z2);
    layer<L, 4>(g, {a.y, b.y, H2, Zh}, {r2[2], r2[3], H2, H}, r3);
    const Fe S1 = r3[0], I = r3[2];
    const Fe rr = zg1::dbl(zg1::sub(r3[1], S1));
    if (zg1::is_zero(H) && zg1::is_zero(rr)) return double_lanes<L>(g, a);
    layer<L, 3>(g, {H, U1, rr}, {I, I, rr}, r4);
    const Fe J = r4[0], V = r4[1];
    Jac r;
    r.x = zg1::sub(zg1::sub(r4[2], J), zg1::dbl(V));
    layer<L, 2>(g, {rr, S1}, {zg1::sub(V, r.x), J}, r5);
    r.y = zg1::sub(r5[0], zg1::dbl(r5[1]));
    r.z = r3[3];
    return r;
}

// s: (k, n, 8) word arrays, array j's point i at j*n + i. A pair's L lanes
// are neighbours in one warp (L divides 32) and leave together.
template <int L>
__global__ void __launch_bounds__(THREADS)
g1_sum_kernel(Points s, Out o, int k, long long n) {
    static_assert(L >= 4 && L <= 8 && 32 % L == 0,
                  "a pair's lanes within a warp, a layer on one round");
    constexpr int PAIRS = THREADS / L;
    __shared__ uint32_t slots[PAIRS * SLOT_STRIDE];
    const int t = threadIdx.x;
    const long long i = (long long)blockIdx.x * PAIRS + t / L;
    if (i >= n) return;
    Group g;
    g.lane = t % L;
    g.mask = ((1u << L) - 1u) << (t % 32 / L * L);
    g.slot = slots + t / L * SLOT_STRIDE;
    Jac acc = zg1::load_jac(s.x, s.y, s.z, i);
    Jac next = acc;
    if (k > 1) next = zg1::load_jac(s.x, s.y, s.z, n + i);
    for (int j = 1; j < k; ++j) {
        const Jac b = next;    // the next array's point loads during the add
        if (j + 1 < k)
            next = zg1::load_jac(s.x, s.y, s.z, (long long)(j + 1) * n + i);
        acc = add_lanes<L>(g, acc, b);
    }
    if (g.lane == 0) zg1::store_jac(o.x, o.y, o.z, i, acc);
}

// ---------------------------------------------------------------------------
// zg1_add, zg1_double: a thread a pair
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
g1_add_kernel(Points a, Points b, Out o, long long n) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    const Jac p = zg1::load_jac(a.x, a.y, a.z, i);
    const Jac q = zg1::load_jac(b.x, b.y, b.z, i);
    zg1::store_jac(o.x, o.y, o.z, i, zg1::jac_add(p, q));
}

__global__ void __launch_bounds__(THREADS)
g1_double_kernel(Points a, Out o, long long n) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    const Jac p = zg1::load_jac(a.x, a.y, a.z, i);
    zg1::store_jac(o.x, o.y, o.z, i, zg1::jac_double(p));
}

template <int L>
int launch_sum(Points s, Out o, int k, long long n, cudaStream_t st) {
    const long long grid = blocks(n, THREADS / L);
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    g1_sum_kernel<L><<<(unsigned)grid, THREADS, 0, st>>>(s, o, k, n);
    return (int)cudaGetLastError();
}

}  // namespace

// Each pointer is an (n, 8) int32 array of Fp Montgomery words, 16-byte
// aligned. Returns cudaGetLastError() after the launch.
extern "C" int zg1_add(const void* ax, const void* ay, const void* az,
                       const void* bx, const void* by, const void* bz,
                       void* ox, void* oy, void* oz, long long n,
                       void* stream) {
    if (n < 0 || blocks(n, THREADS) > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    Points a{(const uint32_t*)ax, (const uint32_t*)ay, (const uint32_t*)az};
    Points b{(const uint32_t*)bx, (const uint32_t*)by, (const uint32_t*)bz};
    Out o{(uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz};
    g1_add_kernel<<<(unsigned)blocks(n, THREADS), THREADS, 0,
                    (cudaStream_t)stream>>>(a, b, o, n);
    return (int)cudaGetLastError();
}

extern "C" int zg1_double(const void* ax, const void* ay, const void* az,
                          void* ox, void* oy, void* oz, long long n,
                          void* stream) {
    if (n < 0 || blocks(n, THREADS) > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    Points a{(const uint32_t*)ax, (const uint32_t*)ay, (const uint32_t*)az};
    Out o{(uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz};
    g1_double_kernel<<<(unsigned)blocks(n, THREADS), THREADS, 0,
                       (cudaStream_t)stream>>>(a, o, n);
    return (int)cudaGetLastError();
}

// sx, sy, sz: (k, n, 8) int32 arrays of Fp Montgomery words (k >= 1),
// 16-byte aligned; out: (n, 8) each. `lanes` (4 or 8) a pair.
extern "C" int zg1_sum(const void* sx, const void* sy, const void* sz,
                       void* ox, void* oy, void* oz, long long n, int k,
                       int lanes, void* stream) {
    if (k < 1 || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    Points s{(const uint32_t*)sx, (const uint32_t*)sy, (const uint32_t*)sz};
    Out o{(uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz};
    cudaStream_t st = (cudaStream_t)stream;
    switch (lanes) {
        case 4: return launch_sum<4>(s, o, k, n, st);
        case 8: return launch_sum<8>(s, o, k, n, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
