"""BN254 field arithmetic on torch tensors.

An element is a `torch.int32` tensor of shape (..., 8): eight little-endian
32-bit words of its Montgomery form with R = 2^256. These are the same 32
bytes the host FrVec tier holds (native/frvec.py) and the same residue as
the JAX package's (..., 16) u16-in-u32 limbs (zolt_tpu/field/limb.py), so
moving data between the three is a byte reinterpretation.

The arithmetic below is the plain torch reference for the CUDA kernels of
csrc/ and the device code of parallel/ and zkvm/device_outer.py, plus
the JAX package's helpers around it (mont_sqr, to_mont, from_mont,
one_mont, eq, const_vec). The exponentiations (mont_pow_fixed, inverse,
batch_inverse) go through field/inverse.py: kernel F on a CUDA tensor,
its plain version on a CPU tensor. The arithmetic here splits
words into 16 limbs of 16 bits held in int64, where every partial product
and column sum is exact, and runs unchanged on CPU or CUDA tensors. torch's
unsigned 32-bit support is partial (especially on CUDA), so words keep
int32 bit patterns and every right shift is masked. Every function returns
canonical residues (< p), so results are byte-identical to any other exact
implementation.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .params import FP, FR, R, FieldParams

_MASK16 = 0xFFFF
_MASK32 = 0xFFFFFFFF


class FieldConst(NamedTuple):
    name: str
    params: FieldParams
    p16: tuple[int, ...]     # modulus, 16 little-endian 16-bit limbs
    inv: int                 # -p^{-1} mod 2^16
    r_words: tuple[int, ...]   # R mod p (the Montgomery form of 1), 8 words
    r2_words: tuple[int, ...]  # R^2 mod p (to_mont's multiplier), 8 words
    p_minus_2_bits: tuple[int, ...]  # bits of p - 2, LSB first (inverse)


def _words8(x: int) -> tuple[int, ...]:
    return tuple((x >> (32 * i)) & _MASK32 for i in range(8))


def _mk_const(fp: FieldParams) -> FieldConst:
    e = fp.p - 2
    return FieldConst(fp.name, fp, tuple(fp.p_limbs), fp.inv,
                      _words8(fp.r), _words8(fp.r2),
                      tuple((e >> i) & 1 for i in range(e.bit_length())))


FR_C = _mk_const(FR)
FP_C = _mk_const(FP)

# The CUDA kernels' work, counted as the H100's 32-bit multiply-adds
# (IMADs; a 32x32-bit word product is two, its lo and hi halves): a 256 x
# 256-bit product kept wide, and a Montgomery product with its REDC. The
# wrappers add up the work of their launches by these counts.
WIDE_IMADS = 128
MONT_IMADS = 272


def _p16(f: FieldConst, device) -> torch.Tensor:
    return torch.tensor(f.p16, dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# words <-> 16-bit limbs
# ---------------------------------------------------------------------------

def to_limbs16(w: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 words -> (..., 16) int64 limbs of 16 bits."""
    x = w.to(torch.int64) & _MASK32
    return torch.stack([x & _MASK16, (x >> 16) & _MASK16],
                       dim=-1).reshape(*w.shape[:-1], 16)


def from_limbs16(limbs: torch.Tensor) -> torch.Tensor:
    """(..., 16) int64 canonical 16-bit limbs -> (..., 8) int32 words."""
    pairs = limbs.reshape(*limbs.shape[:-1], 8, 2)
    x = pairs[..., 0] | (pairs[..., 1] << 16)
    x = x - (((x >> 31) & 1) << 32)            # two's-complement int32 value
    return x.to(torch.int32)


def _propagate(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Carry/borrow chain over the last axis of int64 columns (signed
    carries, arithmetic shift): (16-bit limbs, final carry).

    On a GPU the chain runs limb by limb: one step per limb, and no step
    waits for the host. On the CPU every limb passes its carry up at once,
    until no limb has one: a few passes for most inputs, each ending in a
    test of the data, which on a GPU would be a host sync."""
    carry = torch.zeros(t.shape[:-1], dtype=torch.int64, device=t.device)
    if t.device.type != "cpu":
        out = []
        for j in range(t.shape[-1]):
            v = t[..., j] + carry
            out.append(v & _MASK16)
            carry = v >> 16
        return torch.stack(out, dim=-1), carry
    v = t.clone()
    while True:
        c = v >> 16
        if not c.any():
            return v, carry
        v &= _MASK16
        v[..., 1:] += c[..., :-1]
        carry += c[..., -1]


def _cond_sub_p(limbs, extra, f: FieldConst):
    """limbs − p where (extra:limbs) >= p, else limbs."""
    diff, borrow = _propagate(limbs - _p16(f, limbs.device))
    take = (borrow == 0) | (extra != 0)
    return torch.where(take.unsqueeze(-1), diff, limbs)


# ---------------------------------------------------------------------------
# Field operations on (..., 8) int32 words
# ---------------------------------------------------------------------------

def add(a: torch.Tensor, b: torch.Tensor, f: FieldConst = FR_C) -> torch.Tensor:
    s, carry = _propagate(to_limbs16(a) + to_limbs16(b))
    return from_limbs16(_cond_sub_p(s, carry, f))


def sub(a: torch.Tensor, b: torch.Tensor, f: FieldConst = FR_C) -> torch.Tensor:
    d, borrow = _propagate(to_limbs16(a) - to_limbs16(b))
    fixed, _ = _propagate(d + _p16(f, d.device))
    return from_limbs16(torch.where((borrow != 0).unsqueeze(-1), fixed, d))


def neg(a: torch.Tensor, f: FieldConst = FR_C) -> torch.Tensor:
    return sub(torch.zeros_like(a), a, f)


def mont_mul(a: torch.Tensor, b: torch.Tensor,
             f: FieldConst = FR_C) -> torch.Tensor:
    """a·b·R^{-1} mod p: 16x16 limb column sums, then 16 REDC steps.

    Overflow audit (int64): a column holds at most 16 limb products
    (< 2^32 each) plus 16 m·p_j terms (< 2^32 each) plus carries, < 2^38.
    The result is < 2p before the final conditional subtract."""
    la, lb = torch.broadcast_tensors(to_limbs16(a), to_limbs16(b))
    shape = la.shape[:-1]
    t = torch.zeros(*shape, 33, dtype=torch.int64, device=la.device)
    for i in range(16):
        t[..., i:i + 16] += la[..., i:i + 1] * lb
    p16 = _p16(f, la.device)
    for i in range(16):
        m = ((t[..., i] & _MASK16) * f.inv) & _MASK16
        t[..., i:i + 16] += m.unsqueeze(-1) * p16
        t[..., i + 1] += t[..., i] >> 16       # low 16 bits are now zero
    limbs, carry = _propagate(t[..., 16:32])
    return from_limbs16(_cond_sub_p(limbs, carry + t[..., 32], f))


def mont_sqr(a: torch.Tensor, f: FieldConst = FR_C) -> torch.Tensor:
    return mont_mul(a, a, f)


def const_vec(words, device="cpu") -> torch.Tensor:
    """8 unsigned 32-bit words (a FieldConst's r_words, say) -> an (8,)
    int32 tensor of the same bits."""
    return torch.tensor([w - ((w >> 31) << 32) for w in words],
                        dtype=torch.int32, device=device)


def to_mont(a: torch.Tensor, f: FieldConst = FR_C) -> torch.Tensor:
    """Canonical residues -> Montgomery form (a product by R^2)."""
    return mont_mul(a, const_vec(f.r2_words, a.device), f)


def from_mont(a: torch.Tensor, f: FieldConst = FR_C) -> torch.Tensor:
    """Montgomery form -> canonical residues (a product by 1)."""
    return mont_mul(a, const_vec(_words8(1), a.device), f)


def one_mont(shape=(), f: FieldConst = FR_C, device="cpu") -> torch.Tensor:
    """The Montgomery form of 1, shaped (*shape, 8)."""
    return const_vec(f.r_words, device).expand(tuple(shape) + (8,))


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per element of the batch: all words equal."""
    return (a == b).all(dim=-1)


def mont_pow_fixed(a: torch.Tensor, e_bits, f: FieldConst = FR_C
                   ) -> torch.Tensor:
    """a^e elementwise for a public exponent e given by its LSB-first bits
    (any length; no bits is e = 0). Montgomery in and out. On a CUDA
    tensor kernel F (field/inverse.py) runs it, on a CPU tensor its plain
    version."""
    from . import inverse as inv

    return inv.pow_fixed(a, tuple(e_bits), f)


def inverse(a: torch.Tensor, f: FieldConst = FR_C) -> torch.Tensor:
    """Fermat inverse a^(p-2) elementwise; inverse(0) = 0."""
    return mont_pow_fixed(a, f.p_minus_2_bits, f)


def batch_inverse(a: torch.Tensor, f: FieldConst = FR_C) -> torch.Tensor:
    """The inverse of every element of an (n, ..., 8) batch, n >= 1, zeros
    mapping to zeros: the Montgomery trick (field/inverse.py, kernel F on
    a CUDA tensor). Elementwise inversion does not depend on how the
    batch is grouped, so the result equals `inverse` word for word."""
    from . import inverse as inv

    return inv.batch_inverse(a, f)


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cond ? a : b, with cond shaped like the batch (no word axis)."""
    return torch.where(cond.unsqueeze(-1), a, b)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """Per element of the batch: all words zero."""
    return (a == 0).all(dim=-1)


def zeros(shape=(), device="cpu") -> torch.Tensor:
    """Zero words shaped (*shape, 8)."""
    return torch.zeros(tuple(shape) + (8,), dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Host boundary: Python ints, JAX limbs, FrVec bytes
# ---------------------------------------------------------------------------

def _words_of(values: list[int]) -> np.ndarray:
    buf = b"".join(int(v).to_bytes(32, "little") for v in values)
    return np.frombuffer(buf, dtype="<i4").reshape(len(values), 8)


def ints_to_words(xs) -> torch.Tensor:
    """Raw (not Montgomery) 256-bit ints -> (n, 8) int32 words (CPU)."""
    return torch.from_numpy(_words_of(list(xs)).copy())


def words_to_ints(a: torch.Tensor) -> list[int]:
    """(..., 8) words -> raw ints, flattened over the batch."""
    b = a.detach().to("cpu").contiguous().numpy().tobytes()
    return [int.from_bytes(b[i:i + 32], "little") for i in range(0, len(b), 32)]


def encode(xs, f: FieldConst = FR_C, device="cpu") -> torch.Tensor:
    """Canonical int(s) -> Montgomery words: (8,) for a scalar, (n, 8) for
    a sequence."""
    p = f.params
    if isinstance(xs, int):
        return ints_to_words([p.mont(xs)])[0].to(device)
    return ints_to_words([p.mont(int(x)) for x in xs]).to(device)


def decode(a: torch.Tensor, f: FieldConst = FR_C):
    """Montgomery words -> canonical int for an (8,) tensor, else the
    flattened list of canonical ints."""
    p = f.params.p
    rinv = pow(R, -1, p)
    vals = [v * rinv % p for v in words_to_ints(a)]
    return vals[0] if a.dim() == 1 else vals


def from_jax_limbs(arr) -> torch.Tensor:
    """The JAX package's (..., 16) u16-in-u32 limb array -> (..., 8) int32
    words of the same residue (CPU)."""
    x = np.asarray(arr, dtype=np.uint32)
    w = (x[..., 0::2] & np.uint32(_MASK16)) | (x[..., 1::2] << np.uint32(16))
    return torch.from_numpy(np.ascontiguousarray(w).view(np.int32).copy())


def to_jax_limbs(a: torch.Tensor) -> np.ndarray:
    """(..., 8) int32 words -> the JAX package's (..., 16) uint32 limbs."""
    w = a.detach().to("cpu").contiguous().numpy().view(np.uint32)
    out = np.empty(w.shape[:-1] + (16,), dtype=np.uint32)
    out[..., 0::2] = w & np.uint32(_MASK16)
    out[..., 1::2] = w >> np.uint32(16)
    return out


def frvec_to_words(v) -> torch.Tensor:
    """An FrVec's Montgomery bytes as a zero-copy (n, 8) int32 CPU view
    (the FrVec keeps owning the buffer: copy before mutating either)."""
    if v.n == 0:
        return torch.zeros((0, 8), dtype=torch.int32)
    if v._mont is None:
        return encode(v._ints)
    return torch.frombuffer(v._mont, dtype=torch.int32,
                            count=8 * v.n).reshape(v.n, 8)


def words_to_frvec(a: torch.Tensor):
    """(n, 8) words (any device) -> FrVec owning a copy of the bytes."""
    from ..native.frvec import FrVec

    host = a.detach().to("cpu").contiguous()
    return FrVec(host.shape[0], mont=bytearray(host.numpy().tobytes()))
