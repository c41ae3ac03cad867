"""Kernel F: fixed-exponent powers and batch inversion of field elements.

    pow_fixed(a, bits)   a^e elementwise, e = Σ bits[i]·2^i, a public
                         exponent (bits LSB first, any length)
    batch_inverse(a)     a^{-1} elementwise, zeros mapping to zeros

over (..., 8) int32 Montgomery words of Fr or Fp (field/limb.py; the
field's FieldConst picks the modulus). On CUDA tensors they launch
csrc/field_inv.cu, which replaces the XLA code of zolt_tpu/field/limb.py
(mont_pow_fixed, inverse and batch_inverse), or raise; on CPU tensors they
run `pow_fixed_plain` and `batch_inverse_plain`, the torch versions of the
same functions. limb.mont_pow_fixed, limb.inverse and limb.batch_inverse
call them.

The batch inversion is the Montgomery trick over chunks of c entries
(`chunk_of`): entry t + j·T of the flattened batch is entry j of chunk t,
T = ceil(m / c) chunks, so neighbouring threads read neighbouring entries.
A chunk's running product of its non-zero entries, its inverse, then
back-substitution; zeros are written as zeros. On the card the inverse is
the fixed-length divstep inverse of csrc/divstep.cuh (Bernstein-Yang
safegcd: DIVSTEP_BATCHES batches of DIVSTEP_BATCH divsteps on signed
30-bit limbs) and one Montgomery product by `divstep_constant`;
`divstep_inverse_model` is its word-exact model in Python ints, which the
CPU tests hold to Python's pow (the kernel runs only on a card). The
plain version takes a Fermat inverse a chunk: every result is a
canonical residue, so the words equal the kernel's and JAX's, whose
prefix and suffix scans group the products otherwise.

Counters, plain integers in `pow_fixed.counts` and `batch_inverse.counts`:
"launches", "elements", and the "bytes" and "imads" the function needs
(`pow_work`, `inverse_work`; batch_inverse counts every entry as non-zero,
since it does not read the data back to the host). They count the
function's work, not the kernel's: a batch inversion needs one inverse,
whatever number of chunks the kernel inverts, so the chunks' extra
inverses are the kernel's cost and show against the bound.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import limb

# Threads a launch aims for, and the most entries a chunk: a chunk costs
# an inverse and a chain of 3c dependent products. Set from
# chip_smoke.py's sweep over 132 x 32 .. 132 x 512 threads at 2^12, 2^16
# and 2^18 on an H100: 132 x 256 was the fastest at 2^16 and 2^18 and tied
# at 2^12, and faster than one inverse a block of 256 chunks through a
# product tree at every size (PERF.md).
TARGET_THREADS = 132 * 256
MAX_CHUNK = 64
_FIELDS = {"fr": 0, "fp": 1}      # csrc/field_inv.cu field ids
# csrc/divstep.cuh: divsteps a transition matrix, and batches an inverse
# (600 divsteps; 590 take any input below 2^256 to g = 0).
DIVSTEP_BATCH = 30
DIVSTEP_BATCHES = 20


def chunk_of(m: int) -> int:
    """Entries a thread takes through one running product, for m
    entries."""
    return max(1, min(MAX_CHUNK, -(-m // TARGET_THREADS)))


def fermat_products(f: limb.FieldConst) -> int:
    """Montgomery products of one Fermat inverse (the plain version's): a
    square-and-multiply from the top bit of p − 2 (bit 253 for both
    moduli), which starts the accumulator at the base."""
    bits = f.p_minus_2_bits
    return len(bits) - 1 + sum(bits) - 1


def pow_work(n: int, bits) -> tuple[int, int]:
    """Bytes and IMADs of pow_fixed over n elements: each element read
    once and written once, the bits read once; a squaring at every bit and
    a product at every set bit, as the kernel runs them."""
    return 64 * n + len(bits), n * (len(bits) + sum(bits)) * limb.MONT_IMADS


def inverse_work(n: int, nonzero: int, f: limb.FieldConst
                 ) -> tuple[int, int]:
    """Bytes and IMADs a batch inversion of n entries, `nonzero` of them
    non-zero, needs: each entry read once and written once; three products
    a non-zero entry (the running product, its inverse, the next inverse)
    and one inverse for the whole batch, charged as a Fermat inverse's
    fermat_products(f) products (0.2 % of the IMADs at 2^16 entries). The
    kernel's chunks each pay an inverse of their own, which this does not
    count; an inverse is also a chain of dependent steps, a latency floor
    apart from this bound."""
    return 64 * n, (3 * nonzero + fermat_products(f)) * limb.MONT_IMADS


def divstep_constant(f: limb.FieldConst) -> int:
    """R^3 mod p: the kernel's divsteps invert the word x = aR, and one
    Montgomery product by this gives x^{-1}·R^3·R^{-1} = a^{-1}R, the
    Montgomery form of a^{-1}. The divsteps leave no power of two behind:
    each batch divides (d, e) by 2^30 exactly mod p."""
    return pow(2, 768, f.params.p)


_M32 = (1 << 32) - 1
_M30 = (1 << 30) - 1


def _s32(w: int) -> int:
    return w - (1 << 32) if w >> 31 else w


def _divsteps(zeta: int, f0: int, g0: int) -> tuple[int, tuple]:
    """csrc/divstep.cuh divsteps_30: DIVSTEP_BATCH divsteps on the low
    words of f and g in 32-bit arithmetic; the new zeta and the batch's
    matrix (u, v, q, r) as signed ints."""
    u, v, q, r, f, g = 1, 0, 0, 1, f0 & _M32, g0 & _M32
    for _ in range(DIVSTEP_BATCH):
        mask1 = _M32 if zeta < 0 else 0
        mask2 = _M32 if g & 1 else 0
        x = ((f ^ mask1) - mask1) & _M32
        y = ((u ^ mask1) - mask1) & _M32
        z = ((v ^ mask1) - mask1) & _M32
        g = (g + (x & mask2)) & _M32
        q = (q + (y & mask2)) & _M32
        r = (r + (z & mask2)) & _M32
        mask1 &= mask2
        zeta = (~zeta if mask1 else zeta) - 1
        f = (f + (g & mask1)) & _M32
        u = (u + (q & mask1)) & _M32
        v = (v + (r & mask1)) & _M32
        g >>= 1
        u = (u << 1) & _M32
        v = (v << 1) & _M32
    return zeta, (_s32(u), _s32(v), _s32(q), _s32(r))


def divstep_inverse_model(x: int, f: limb.FieldConst = limb.FR_C) -> int:
    """The kernel's inverse of one Montgomery word x = aR (0 <= x < p) in
    Python ints: the word of a^{-1}R, 0 for 0. The same batches, the same
    count and the same final constant as csrc/divstep.cuh and
    field_inv.cu mont_inverse; the limb sums the kernel keeps in 64 bits
    are checked to fit, and g must reach 0."""
    p = f.params.p
    inv30 = pow(p, -1, 1 << 30)
    d, e, fv, g, zeta = 0, 1, p, x, -1
    for _ in range(DIVSTEP_BATCHES):
        zeta, (u, v, q, r) = _divsteps(zeta, fv & _M30, g & _M30)
        assert abs(u) + abs(v) <= 1 << 30 and abs(q) + abs(r) <= 1 << 30
        # md, me: t·(d, e) + p·(md, me) has 30 zero low bits
        md = (u if d < 0 else 0) + (v if e < 0 else 0)
        me = (q if d < 0 else 0) + (r if e < 0 else 0)
        cd = u * (d & _M30) + v * (e & _M30)
        ce = q * (d & _M30) + r * (e & _M30)
        md -= (inv30 * cd + md) & _M30
        me -= (inv30 * ce + me) & _M30
        nd, ne = u * d + v * e + p * md, q * d + r * e + p * me
        nf, ng = u * fv + v * g, q * fv + r * g
        assert not (nd | ne | nf | ng) & _M30
        d, e, fv, g = nd >> 30, ne >> 30, nf >> 30, ng >> 30
        assert -2 * p < d < p and -2 * p < e < p
    assert g == 0 and (fv in (1, -1) or x == 0)
    # normalize: d·sign(f) into [0, p)
    d = (d + p if d < 0 else d) * (-1 if fv < 0 else 1)
    d = d + p if d < 0 else d
    assert 0 <= d < p
    # one Montgomery product by R^3 mod p
    r_inv = pow(1 << 256, -1, p)
    return d * divstep_constant(f) * r_inv % p


def _check(a: torch.Tensor, who: str) -> None:
    if a.dtype != torch.int32 or a.dim() < 1 or a.shape[-1] != 8:
        raise ValueError(f"{who} takes (..., 8) int32 words, got "
                         f"{tuple(a.shape)} {a.dtype}")


def pow_fixed_plain(a: torch.Tensor, bits, f: limb.FieldConst = limb.FR_C
                    ) -> torch.Tensor:
    """The torch version of pow_fixed (any device): the kernel's
    square-and-multiply from the top bit down."""
    acc = limb.one_mont(a.shape[:-1], f, a.device).contiguous()
    for b in reversed(bits):
        acc = limb.mont_sqr(acc, f)
        if b:
            acc = limb.mont_mul(acc, a, f)
    return acc


def batch_inverse_plain(a: torch.Tensor, f: limb.FieldConst = limb.FR_C
                        ) -> torch.Tensor:
    """The torch version of batch_inverse (any device): the kernel's
    chunks of chunk_of(m) entries, their running products, one inverse a
    chunk (a Fermat inverse here), the back-substitution."""
    x = a.reshape(-1, 8)
    m = x.shape[0]
    c = chunk_of(m)
    t = -(-m // c)
    xs = torch.cat([x, limb.zeros((t * c - m,), x.device)]).reshape(c, t, 8)
    zero = limb.is_zero(xs)
    one = limb.one_mont((t,), f, x.device).contiguous()
    run, prefix = one, []
    for j in range(c):
        run = limb.select(zero[j], run, limb.mont_mul(run, xs[j], f))
        prefix.append(run)
    inv = pow_fixed_plain(run, f.p_minus_2_bits, f)
    out = [None] * c
    for j in reversed(range(c)):
        prev = prefix[j - 1] if j else one
        out[j] = limb.select(zero[j], torch.zeros_like(prev),
                             limb.mont_mul(inv, prev, f))
        inv = limb.select(zero[j], inv, limb.mont_mul(inv, xs[j], f))
    return torch.stack(out).reshape(t * c, 8)[:m].reshape(a.shape)


def _prepare(a: torch.Tensor, who: str) -> tuple[torch.Tensor, torch.Tensor]:
    if a.device.type != "cuda":
        raise ValueError(f"{who} has no kernel for device {a.device}")
    x = a.contiguous()
    if x.data_ptr() % 16:
        raise ValueError(f"{who} needs 16-byte aligned words")
    return x, torch.empty_like(x)


def _count(counts: dict, n: int, work: tuple[int, int]) -> None:
    counts["launches"] += 1
    counts["elements"] += n
    counts["bytes"] += work[0]
    counts["imads"] += work[1]


def pow_fixed(a: torch.Tensor, bits, f: limb.FieldConst = limb.FR_C
              ) -> torch.Tensor:
    """a^e elementwise, e given by its LSB-first bits (a tuple of 0/1;
    empty is e = 0, whose power is 1). Montgomery in and out."""
    _check(a, "pow_fixed")
    bits = tuple(1 if b else 0 for b in bits)
    if a.device.type == "cpu":
        return pow_fixed_plain(a, bits, f)
    x, out = _prepare(a, "pow_fixed")
    n = x.numel() // 8
    if n:
        bt = (torch.tensor(bits, dtype=torch.uint8, device=x.device)
              if bits else None)
        with torch.cuda.device(x.device):
            rc = _build.kernels().lib.zfr_pow_fixed(
                x.data_ptr(), out.data_ptr(), n,
                None if bt is None else bt.data_ptr(), len(bits),
                _FIELDS[f.name], torch.cuda.current_stream().cuda_stream)
        _build.check(rc, f"pow_fixed ({n} elements, {len(bits)} bits)")
        _count(pow_fixed.counts, n, pow_work(n, bits))
    return out


pow_fixed.counts = dict.fromkeys(("launches", "elements", "bytes", "imads"),
                                 0)


def batch_inverse(a: torch.Tensor, f: limb.FieldConst = limb.FR_C
                  ) -> torch.Tensor:
    """The inverse of every element of an (n, ..., 8) batch, n >= 1, zeros
    mapping to zeros. Montgomery in and out."""
    _check(a, "batch_inverse")
    if a.dim() < 2 or a.shape[0] < 1:
        raise ValueError(f"batch_inverse takes an (n, ..., 8) batch with "
                         f"n >= 1, got {tuple(a.shape)}")
    if a.device.type == "cpu":
        return batch_inverse_plain(a, f)
    x, out = _prepare(a, "batch_inverse")
    m = x.numel() // 8
    if m:
        c = chunk_of(m)
        with torch.cuda.device(x.device):
            rc = _build.kernels().lib.zfr_batch_inverse(
                x.data_ptr(), out.data_ptr(), m, c, _FIELDS[f.name],
                torch.cuda.current_stream().cuda_stream)
        _build.check(rc, f"batch_inverse ({m} entries, chunks of {c})")
        _count(batch_inverse.counts, m, inverse_work(m, m, f))
    return out


batch_inverse.counts = dict.fromkeys(
    ("launches", "elements", "bytes", "imads"), 0)
