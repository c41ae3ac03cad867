"""The port's field helpers of zolt_tpu/field/limb.py (mont_sqr, to_mont,
from_mont, one_mont, eq, const_vec, mont_pow_fixed, inverse,
batch_inverse) and kernel F's wrapper (field/inverse.py), on the CPU.

Each helper's words equal the JAX package's on the same inputs, over Fr
and Fp, zeros, 1 and p - 1 included; the tolerance is 0 (every value is a
canonical residue). JAX compiles its exponentiations for seconds a shape
(batch_inverse about 12 s at n = 8, 6 s at n = 3), so JAX's
mont_pow_fixed, inverse and batch_inverse are each called at one small
shape, and the other shapes
and the other field are held to Python's pow. The plain batch inversion
runs the kernel's chunked Montgomery trick, so its chunks are checked
here too: chunks of 1 to 5 entries and of 64 (n sets the chunk; a small
thread target makes small n take large chunks), n no multiple of the
chunk, all-zero chunks, n = 1 and (n, m, 8) batches. On a tensor that lies neither on
the CPU nor on a card the wrappers raise: they have no fallback. About
30 s on an 8-core CPU box, most of it XLA compiling JAX's functions.
"""

import numpy as np
import pytest
import torch

from zolt_tpu.field import limb as jlimb
from zolt_tpu_torch.field import inverse, limb

torch.set_num_threads(1)

FIELDS = {"fr": (limb.FR_C, jlimb.FR_C), "fp": (limb.FP_C, jlimb.FP_C)}


def _vals(f, n: int, seed: int) -> list[int]:
    """0, 1, p - 1, 2, then random residues, a tenth of them zero."""
    p = f.params.p
    rng = np.random.default_rng(seed)
    vals = [0, 1, p - 1, 2] + [int.from_bytes(rng.bytes(40), "little") % p
                               for _ in range(n - 4)]
    for i in range(7, n, 10):
        vals[i] = 0
    return vals[:n]


def _jax(f_jax, vals):
    return jlimb.encode(vals, f_jax)


def _words(arr) -> torch.Tensor:
    return limb.from_jax_limbs(np.asarray(arr))


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_field_constants_match_jax(name):
    f, fj = FIELDS[name]
    assert f.p_minus_2_bits == fj.p_minus_2_bits
    assert torch.equal(limb.const_vec(f.r_words),
                       _words(jlimb.const_vec(fj.r_limbs)))
    assert torch.equal(limb.const_vec(f.r2_words),
                       _words(jlimb.const_vec(fj.r2_limbs)))
    assert torch.equal(limb.one_mont((2, 3), f),
                       _words(jlimb.one_mont((2, 3), fj)))


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_mont_helpers_match_jax(name):
    """mont_sqr, to_mont, from_mont and eq against JAX's words."""
    f, fj = FIELDS[name]
    vals = _vals(f, 12, 1)
    a_j = _jax(fj, vals)
    a = _words(a_j)
    assert torch.equal(limb.mont_sqr(a, f), _words(jlimb.mont_sqr(a_j, fj)))
    assert torch.equal(limb.from_mont(a, f), _words(jlimb.from_mont(a_j, fj)))
    raw = limb.ints_to_words(vals)
    raw_j = limb.to_jax_limbs(raw)
    assert torch.equal(limb.to_mont(raw, f), _words(jlimb.to_mont(raw_j, fj)))
    assert limb.decode(limb.to_mont(raw, f), f) == vals
    b = a.flip(0)
    assert torch.equal(limb.eq(a, b),
                       torch.from_numpy(np.array(jlimb.eq(a_j, a_j[::-1]))))
    assert limb.eq(a, a).all()


def test_mont_pow_fixed_matches_jax():
    """JAX's mont_pow_fixed on Fr at one shape; Fp, the exponent of no
    bits and a long exponent against Python's pow."""
    f, fj = FIELDS["fr"]
    vals = _vals(f, 8, 2)
    a_j = _jax(fj, vals)
    bits = (1, 0, 1, 1, 0, 0, 1)
    assert torch.equal(limb.mont_pow_fixed(_words(a_j), bits, f),
                       _words(jlimb.mont_pow_fixed(a_j, bits, fj)))
    for f in (limb.FR_C, limb.FP_C):
        p = f.params.p
        vals = _vals(f, 9, 3)
        a = limb.encode(vals, f)
        for e in (0, 1, 2, 77, (1 << 70) + 5):
            e_bits = tuple((e >> i) & 1 for i in range(e.bit_length()))
            assert limb.decode(limb.mont_pow_fixed(a, e_bits, f), f) == \
                [pow(v, e, p) for v in vals], (f.name, e)


def test_inverse_matches_jax():
    """JAX's inverse on Fp at one shape, zeros mapping to zeros; Fr and a
    (2, 3) batch against Python's pow."""
    f, fj = FIELDS["fp"]
    vals = _vals(f, 8, 4)
    a_j = _jax(fj, vals)
    assert torch.equal(limb.inverse(_words(a_j), f),
                       _words(jlimb.inverse(a_j, fj)))
    for f in (limb.FR_C, limb.FP_C):
        p = f.params.p
        vals = _vals(f, 6, 5)
        got = limb.inverse(limb.encode(vals, f).reshape(2, 3, 8), f)
        assert got.shape == (2, 3, 8)
        assert limb.decode(got, f) == [pow(v, p - 2, p) for v in vals]


def test_batch_inverse_matches_jax():
    """JAX's batch_inverse on Fr at n = 3, the entries 0, 1 and p - 1 (it
    compiles for 6 s at n = 3, 12 s at n = 8); Fp against Python's pow."""
    f, fj = FIELDS["fr"]
    vals = _vals(f, 3, 6)
    a_j = _jax(fj, vals)
    assert torch.equal(limb.batch_inverse(_words(a_j), f),
                       _words(jlimb.batch_inverse(a_j, fj)))
    f = limb.FP_C
    p = f.params.p
    vals = _vals(f, 8, 7)
    assert limb.decode(limb.batch_inverse(limb.encode(vals, f), f), f) == \
        [pow(v, p - 2, p) for v in vals]


@pytest.mark.parametrize("name", sorted(FIELDS))
@pytest.mark.parametrize("shape,target,chunk", [
    ((1,), None, 1), ((29,), 29, 1), ((29,), 8, 4), ((5, 3), 8, 2),
    ((4, 3, 2), 5, 5), ((130,), 2, 64)])
def test_batch_inverse_chunks_and_shapes(name, shape, target, chunk,
                                         monkeypatch):
    """The plain Montgomery trick at chunks of 1 to 5 entries and of 64,
    n no multiple of the chunk, (n, m, 8) batches: Python's pow, zeros to
    zeros. n sets the chunk, as on the card; a smaller thread target than
    the card's makes small n take chunks of more than one entry. The first
    12 entries are zero, so small chunks meet chunks of zeros only."""
    if target is not None:
        monkeypatch.setattr(inverse, "TARGET_THREADS", target)
    f = FIELDS[name][0]
    p = f.params.p
    n = int(np.prod(shape))
    assert inverse.chunk_of(n) == chunk
    vals = [0] * min(12, n - 1) + _vals(f, n, 8)[: n - min(12, n - 1)]
    a = limb.encode(vals, f).reshape(*shape, 8)
    want = [pow(v, p - 2, p) for v in vals]
    got = inverse.batch_inverse_plain(a, f)
    assert got.shape == a.shape
    assert limb.decode(got, f) == want
    assert torch.equal(limb.batch_inverse(a, f), got)


def test_chunk_of_and_work():
    assert inverse.chunk_of(1) == 1
    assert inverse.chunk_of(inverse.TARGET_THREADS) == 1
    assert inverse.chunk_of(inverse.TARGET_THREADS + 1) == 2
    assert inverse.chunk_of(1 << 16) == 4
    assert inverse.chunk_of(1 << 30) == inverse.MAX_CHUNK
    # the top bit of p - 2 is bit 253 for both moduli (the kernel starts
    # its Fermat chain there)
    for f in (limb.FR_C, limb.FP_C):
        assert len(f.p_minus_2_bits) == 254 and f.p_minus_2_bits[-1] == 1
    assert inverse.fermat_products(limb.FR_C) == 253 + 126
    # one Fermat inverse for the whole batch, whatever the kernel's chunks
    assert inverse.inverse_work(10, 8, limb.FR_C) == \
        (640, (24 + 379) * limb.MONT_IMADS)
    assert inverse.pow_work(4, (1, 0, 1)) == (259, 4 * 5 * limb.MONT_IMADS)


def test_wrappers_refuse_what_the_kernel_does_not_take():
    a = limb.encode([1, 2, 3])
    with pytest.raises(ValueError, match="n >= 1"):
        limb.batch_inverse(a[:0])
    with pytest.raises(ValueError, match="n >= 1"):
        limb.batch_inverse(a[0])
    with pytest.raises(ValueError, match="int32"):
        limb.inverse(a.to(torch.int64))
    # no fallback: a tensor on neither the CPU nor a card has no kernel
    for fn in (limb.batch_inverse, limb.inverse,
               lambda x: limb.mont_pow_fixed(x, (1, 1))):
        with pytest.raises(ValueError, match="no kernel"):
            fn(a.to("meta"))


def test_kernel_library_raises_without_nvcc():
    """A CUDA tensor's launch loads the kernel library first
    (`_build.kernels()`), whose build raises where there is no nvcc:
    nothing falls back to the plain version."""
    import os
    import shutil

    from zolt_tpu_torch import _build

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present: the library builds")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.kernels()
