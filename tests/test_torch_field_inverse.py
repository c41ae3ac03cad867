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
the CPU nor on a card the wrappers raise: they have no fallback.

The kernel's divstep inverse (csrc/divstep.cuh, field_inv.cu
mont_inverse) runs only on a card; its word-exact model
(inverse.divstep_inverse_model: the same 30-divstep batches, the same
20 of them, the same final product by R^3 mod p) is held here to
pow(x, p − 2, p) over Fr and Fp on 0, 1, p − 1, powers of two, R mod p,
the values just under p, the inputs of a seeded sample whose divsteps run
longest, and hypothesis-drawn values; the constants the kernel's source
spells out (each modulus's 30-bit limbs, p^{-1} mod 2^30, R^3 mod p) are
held to their definitions. About 35 s on an 8-core CPU box, most of it
XLA compiling JAX's functions.
"""

import os
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

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
    assert inverse.chunk_of(1 << 16) == 2
    assert inverse.chunk_of(1 << 18) == 8
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


# -- the divstep inverse's model ---------------------------------------------

_R = 1 << 256


def _want(x: int, p: int) -> int:
    """The word of a^{-1}R for the word x = aR: pow(x, p − 2, p)·R^2."""
    return pow(x, p - 2, p) * _R * _R % p


def _hddivsteps(x: int, p: int) -> int:
    """Divsteps (half-delta form, delta = 1/2 at the start, as the kernel
    runs them) until g = 0, from f = p, g = x: one at a time on exact
    integers."""
    f, g, delta, n = p, x, 1, 0          # delta in halves: 1 is 1/2
    while g:
        if delta > 0 and g & 1:
            delta, f, g = 2 - delta, g, (g - f) >> 1
        elif g & 1:
            delta, g = delta + 2, (g + f) >> 1
        else:
            delta, g = delta + 2, g >> 1
        n += 1
    return n


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_divstep_model_on_edge_inputs(name):
    """0, 1, 2, p − 1 and the values just under p, every power of two
    below p, R mod p and R^2 mod p: the model's word equals
    pow(x, p − 2, p)·R^2 mod p, the Montgomery form of a^{-1} for x = aR;
    zero maps to zero."""
    f = FIELDS[name][0]
    p = f.params.p
    xs = ([0, 1, 2, _R % p, _R * _R % p] + [p - i for i in range(1, 9)]
          + [1 << i for i in range(p.bit_length() - 1)])
    for x in xs:
        assert inverse.divstep_inverse_model(x, f) == _want(x, p), hex(x)
    assert inverse.divstep_inverse_model(0, f) == 0
    # the word of one (R mod p) inverts to itself: an all-zero chunk's
    # running product
    assert inverse.divstep_inverse_model(_R % p, f) == _R % p


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_divstep_model_on_its_longest_inputs(name):
    """The inputs of a seeded sample of 3000 whose divsteps run longest
    (each counted one divstep at a time) take at most 590 of the kernel's
    600, and the model inverts them; so do x and p − x of each."""
    f = FIELDS[name][0]
    p = f.params.p
    rng = np.random.default_rng(13)
    xs = [int.from_bytes(rng.bytes(40), "little") % p for _ in range(3000)]
    counts = sorted(((_hddivsteps(x, p), x) for x in xs), reverse=True)
    steps = inverse.DIVSTEP_BATCH * inverse.DIVSTEP_BATCHES
    assert steps == 600
    assert counts[0][0] <= 590 < steps
    for _, x in counts[:8]:
        for y in (x, p - x):
            assert inverse.divstep_inverse_model(y, f) == _want(y, p)


@settings(max_examples=150, deadline=None)
@given(st.data())
def test_divstep_model_on_drawn_inputs(data):
    name = data.draw(st.sampled_from(sorted(FIELDS)))
    f = FIELDS[name][0]
    p = f.params.p
    x = data.draw(st.integers(min_value=0, max_value=p - 1))
    got = inverse.divstep_inverse_model(x, f)
    assert got == (_want(x, p) if x else 0)


def _switch_words(src: str, fn: str) -> list[int]:
    """The values of a `switch (i)` constant function in a kernel source,
    in case order, the default last."""
    body = src[src.index(fn):]
    body = body[: body.index("}\n    }")]
    return [int(v.rstrip("u"), 16) for v in
            re.findall(r"return (0x[0-9a-f]+u?);", body)]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_divstep_constants_match_their_definitions(name):
    """The final constant is R^3 mod p, and one Montgomery product by it
    takes x^{-1} to the Montgomery form of a^{-1}; csrc/field_inv.cu
    spells it out word by word, and csrc/divstep.cuh the modulus's 30-bit
    limbs and p^{-1} mod 2^30, each equal to its definition."""
    f = FIELDS[name][0]
    p = f.params.p
    c = inverse.divstep_constant(f)
    assert c == pow(2, 768, p)
    a = 0x1234_5678_9ABC_DEF0 % p
    x = a * _R % p
    r_inv = pow(_R, -1, p)
    assert pow(x, p - 2, p) * c * r_inv % p == pow(a, p - 2, p) * _R % p
    csrc = os.path.join(os.path.dirname(inverse.__file__), "..", "csrc")
    with open(os.path.join(csrc, "field_inv.cu")) as fh:
        inv_src = fh.read()
    with open(os.path.join(csrc, "divstep.cuh")) as fh:
        div_src = fh.read()
    mod = {"fr": "FrMod", "fp": "FpMod"}[name]
    r3 = _switch_words(inv_src[inv_src.index(f"struct Inv<zfr::{mod}>"):],
                       "r3(int i)")
    assert r3 == [(c >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
    div = {"fr": "FrDiv", "fp": "FpDiv"}[name]
    part = div_src[div_src.index(f"struct {div}"):]
    assert _switch_words(part, "p30(int i)") == \
        [(p >> (30 * i)) & ((1 << 30) - 1) for i in range(9)]
    inv30 = re.search(r"INV30 = (0x[0-9a-f]+)u;", part).group(1)
    assert int(inv30, 16) == pow(p, -1, 1 << 30)
    assert re.search(r"DIVSTEP_BATCH = (\d+);", div_src).group(1) == \
        str(inverse.DIVSTEP_BATCH)
    assert re.search(r"DIVSTEP_BATCHES = (\d+);", div_src).group(1) == \
        str(inverse.DIVSTEP_BATCHES)
