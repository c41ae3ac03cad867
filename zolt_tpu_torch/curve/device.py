"""Batched BN254 G1 Jacobian arithmetic on torch tensors (Fp words).

A point batch is a triple (X, Y, Z) of (..., 8) int32 tensors of Fp
Montgomery words (field/limb.py, FP_C); Z == 0 encodes the identity. The
formulas are the a = 0 EFD ones, dbl-2009-l (7 products) and add-2007-bl
(16), as in zolt_tpu/curve/device.py.

`pt_add`, `pt_double` and `pt_sum` are the wrappers of kernel A
(csrc/g1.cu: a thread a pair for the batch add and the doubling,
branching on the identity, doubling and inverse cases, and the left fold
of k arrays in one launch on `lanes_per_pair` lanes a pair): on CUDA
tensors they launch it, or raise; on CPU tensors they run `pt_add_plain`,
`pt_double_plain` and `pt_sum_plain`, JAX's formulas with its
select-based edge handling. All give JAX's words for every input. Each
wrapper counts its launches in `.counts`.

The row MSM and the Pippenger (msm/) run these formulas inside their own
kernels; the plain versions of those kernels call the plain functions here.
"""

from __future__ import annotations

import torch

from .. import _build
from ..field import limb
from ..field.limb import FP_C

F = FP_C


def _mul(a, b):
    return limb.mont_mul(a, b, F)


def _sqr(a):
    return limb.mont_mul(a, a, F)


def _add(a, b):
    return limb.add(a, b, F)


def _sub(a, b):
    return limb.sub(a, b, F)


def _dbl(a):  # 2a
    return limb.add(a, a, F)


def pt_infinity(shape=(), device="cpu"):
    z = limb.zeros(shape, device)
    return z, z, z


def pt_is_inf(pt) -> torch.Tensor:
    return limb.is_zero(pt[2])


def pt_double_plain(pt):
    """dbl-2009-l: 2P in Jacobian coordinates (the identity stays Z = 0)."""
    X1, Y1, Z1 = pt
    A = _sqr(X1)
    B = _sqr(Y1)
    C = _sqr(B)
    D = _dbl(_sub(_sub(_sqr(_add(X1, B)), A), C))
    E = _add(_dbl(A), A)  # 3A
    Fq = _sqr(E)
    X3 = _sub(Fq, _dbl(D))
    Y3 = _sub(_mul(E, _sub(D, X3)), _dbl(_dbl(_dbl(C))))  # E(D-X3) - 8C
    Z3 = _dbl(_mul(Y1, Z1))
    return X3, Y3, Z3


def pt_add_plain(pa, pb):
    """add-2007-bl with full edge handling (identity, doubling, inverse),
    every case computed and selected, as zolt_tpu/curve/device.pt_add."""
    X1, Y1, Z1 = pa
    X2, Y2, Z2 = pb
    Z1Z1 = _sqr(Z1)
    Z2Z2 = _sqr(Z2)
    U1 = _mul(X1, Z2Z2)
    U2 = _mul(X2, Z1Z1)
    S1 = _mul(Y1, _mul(Z2, Z2Z2))
    S2 = _mul(Y2, _mul(Z1, Z1Z1))
    H = _sub(U2, U1)
    rr = _dbl(_sub(S2, S1))
    I = _sqr(_dbl(H))
    J = _mul(H, I)
    V = _mul(U1, I)
    X3 = _sub(_sub(_sqr(rr), J), _dbl(V))
    Y3 = _sub(_mul(rr, _sub(V, X3)), _dbl(_mul(S1, J)))
    Z3 = _mul(_sub(_sub(_sqr(_add(Z1, Z2)), Z1Z1), Z2Z2), H)

    a_inf = limb.is_zero(Z1)
    b_inf = limb.is_zero(Z2)
    h_zero = limb.is_zero(H)
    r_zero = limb.is_zero(rr)
    finite = ~(a_inf | b_inf)
    need_double = h_zero & r_zero & finite
    to_inf = h_zero & ~r_zero & finite      # opposite points

    dX, dY, dZ = pt_double_plain(pa)
    X3 = limb.select(need_double, dX, X3)
    Y3 = limb.select(need_double, dY, Y3)
    Z3 = limb.select(need_double, dZ, Z3)
    Z3 = limb.select(to_inf, torch.zeros_like(Z3), Z3)
    X3 = limb.select(a_inf, X2, limb.select(b_inf, X1, X3))
    Y3 = limb.select(a_inf, Y2, limb.select(b_inf, Y1, Y3))
    Z3 = limb.select(a_inf, Z2, limb.select(b_inf, Z1, Z3))
    return X3, Y3, Z3


# ---------------------------------------------------------------------------
# kernel A
# ---------------------------------------------------------------------------

def _flat(pts, shape, dev) -> list[torch.Tensor]:
    out = []
    for c in pts:
        if c.dtype != torch.int32 or c.shape != shape or c.device != dev:
            raise ValueError(f"point coordinates must be int32 {tuple(shape)} "
                             f"on {dev}, got {c.dtype} {tuple(c.shape)} on "
                             f"{c.device}")
        out.append(c.reshape(-1, 8).contiguous())
    return out


def _launch(name: str, pts, out_shape, *extra) -> tuple:
    """Kernel A's entry `name` on the CUDA word tensors `pts`, into three
    new tensors of `out_shape`: name(*pts, *outs, points out, *extra,
    stream)."""
    shape, dev = pts[0].shape, pts[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} has no kernel for device {dev}")
    if shape[-1] != 8:
        raise ValueError(f"{name} takes (..., 8) words, got {tuple(shape)}")
    ins = _flat(pts, shape, dev)
    outs = [torch.empty(out_shape, dtype=torch.int32, device=dev)
            for _ in range(3)]
    n = outs[0].numel() // 8
    with torch.cuda.device(dev):
        fn = getattr(_build.kernels().lib, name)
        rc = fn(*[t.data_ptr() for t in ins + outs], n, *extra,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"{name} ({tuple(shape)} words in)")
    return tuple(outs)


def pt_add(pa, pb):
    """P + Q for each pair of the batch: kernel A on CUDA tensors,
    `pt_add_plain` on CPU tensors."""
    if pa[0].device.type == "cpu" and pb[0].device.type == "cpu":
        return pt_add_plain(pa, pb)
    out = _launch("zg1_add", tuple(pa) + tuple(pb), pa[0].shape)
    pt_add.counts["launches"] += 1
    return out


def pt_double(pt):
    """2P for each point of the batch: kernel A on CUDA tensors,
    `pt_double_plain` on CPU tensors."""
    if pt[0].device.type == "cpu":
        return pt_double_plain(pt)
    out = _launch("zg1_double", tuple(pt), pt[0].shape)
    pt_double.counts["launches"] += 1
    return out


pt_add.counts = {"launches": 0}
pt_double.counts = {"launches": 0}


def pt_sum_plain(stack):
    """The left fold ((s_0 + s_1) + s_2) + ... + s_{k-1} of a stacked
    triple of (k, n, 8) words by `pt_add_plain`: the words of JAX's
    fori_loop of pt_add over msm_mesh's gathered bucket arrays."""
    acc = tuple(c[0] for c in stack)
    for j in range(1, stack[0].shape[0]):
        acc = pt_add_plain(acc, tuple(c[j] for c in stack))
    return acc


def lanes_per_pair(n: int) -> int:
    """The lanes a pair takes in zg1_sum for a fold of n-point arrays: 8
    up to 2048 points (msm_mesh's 8 windows a pass), else 4 (its 4096 and
    8192 at 16 and 32). A step is 5 products deep at both (no layer of the
    addition has more than four); few pairs on 8 lanes spread over twice
    the SMs. From chip_smoke.py's lanes sweep on one H100 (PERF.md): 8
    lanes at or below 4 at 2048 pairs, 4 fastest at 4096 and 8192."""
    return 8 if n <= 2048 else 4


def pt_sum(stack):
    """The left fold of a stacked triple of (k, n, 8) words (k >= 1) over
    its first axis -> (n, 8) words: kernel A's zg1_sum on CUDA tensors, in
    one launch on `lanes_per_pair(n)` lanes a pair; `pt_sum_plain` on CPU
    tensors."""
    shape = stack[0].shape
    if len(shape) != 3 or shape[0] < 1 or shape[2] != 8:
        raise ValueError(f"pt_sum takes (k, n, 8) words, got {tuple(shape)}")
    if stack[0].device.type == "cpu":
        return pt_sum_plain(stack)
    out = _launch("zg1_sum", tuple(stack), (shape[1], 8), shape[0],
                  lanes_per_pair(shape[1]))
    pt_sum.counts["launches"] += 1
    return out


pt_sum.counts = {"launches": 0}


def add_work(pa, pb) -> tuple[int, int]:
    """Bytes and IMADs kernel A needs to add these pairs, by the case each
    pair takes in g1.cuh `jac_add`: every pair read once and its sum
    written once; no product where an operand is the identity, 8 and a
    doubling's 7 for P + P, 14 for P + (−P) (Z3 is not formed), 16 for a
    generic pair."""
    X1, Y1, Z1 = pa
    X2, Y2, Z2 = pb
    n = Z1[..., 0].numel()
    Z1Z1, Z2Z2 = _sqr(Z1), _sqr(Z2)
    h0 = limb.is_zero(_sub(_mul(X2, Z1Z1), _mul(X1, Z2Z2)))
    r0 = limb.is_zero(_sub(_mul(Y2, _mul(Z1, Z1Z1)), _mul(Y1, _mul(Z2, Z2Z2))))
    finite = ~(limb.is_zero(Z1) | limb.is_zero(Z2))
    dbl = int((finite & h0 & r0).sum())
    inv = int((finite & h0 & ~r0).sum())
    gen = int(finite.sum()) - dbl - inv
    prods = dbl * (8 + 7) + inv * 14 + gen * 16
    return n * 96 * 3, prods * limb.MONT_IMADS


def sum_work(stack) -> tuple[int, int]:
    """Bytes and IMADs kernel A needs to fold these k arrays: each point
    read once and the n sums written once; each step's products by the
    case its inputs take (the running sum and the next array), as
    `add_work` counts them."""
    k, n = stack[0].shape[0], stack[0].shape[1]
    acc, imads = tuple(c[0] for c in stack), 0
    for j in range(1, k):
        nxt = tuple(c[j] for c in stack)
        imads += add_work(acc, nxt)[1]
        acc = pt_add_plain(acc, nxt)
    return (k + 1) * n * 96, imads


def double_work(n: int) -> tuple[int, int]:
    """Bytes and IMADs of n doublings by kernel A: each point read once and
    written once, 7 products (the identity too)."""
    return n * 96 * 2, n * 7 * limb.MONT_IMADS


# ---------------------------------------------------------------------------
# host <-> device
# ---------------------------------------------------------------------------

def from_affine_host(points, device="cpu"):
    """List of host affine points (or None) -> Jacobian triple (Z = 1; the
    identity is (0, 1, 0), as in JAX)."""
    xs, ys, zs = [], [], []
    for pt in points:
        if pt is None:
            xs.append(0)
            ys.append(1)
            zs.append(0)
        else:
            xs.append(pt[0])
            ys.append(pt[1])
            zs.append(1)
    return tuple(limb.encode(v, F, device) for v in (xs, ys, zs))


def to_affine_host(pt) -> list:
    """Jacobian triple -> list of host affine points (or None)."""
    from . import host

    X, Y, Z = (limb.decode(c.reshape(-1, 8), F) for c in pt)
    return [host.jacobian_to_affine(x, y, z) for x, y, z in zip(X, Y, Z)]
