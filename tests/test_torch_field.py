"""The port's field layer (zolt_tpu_torch/field/limb.py) against the JAX
package's limb arithmetic and the Python bigint oracle.

Inputs are made from a seed with numpy and handed to both packages. Every
comparison is exact (byte-equal words): this is integer field arithmetic,
so the tolerance is 0.
"""

import numpy as np
import pytest
import torch

from zolt_tpu.field import limb as jlimb
from zolt_tpu.field.limb import FP_C as JFP_C
from zolt_tpu.field.limb import FR_C as JFR_C
from zolt_tpu.native.frvec import FrVec as JFrVec
from zolt_tpu_torch.field import limb
from zolt_tpu_torch.field.params import FR
from zolt_tpu_torch.native.frvec import FrVec
from zolt_tpu_torch.poly.dense import sum_mod

# The tensors here are tiny: torch's worker threads would only spin, and
# they doubled the CPU seconds of the port's tests.
torch.set_num_threads(1)

P = FR.p
R = 1 << 256


def _vals(seed: int, n: int) -> list[int]:
    rng = np.random.default_rng(seed)
    xs = [int.from_bytes(rng.bytes(40), "little") % P for _ in range(n - 4)]
    return xs + [0, 1, P - 1, P - 2]


ORACLE = {
    "add": lambda x, y, p: (x + y) % p,
    "sub": lambda x, y, p: (x - y) % p,
    "mont_mul": lambda x, y, p: x * y % p,
}
FIELDS = {"fr": (limb.FR_C, JFR_C), "fp": (limb.FP_C, JFP_C)}


@pytest.mark.parametrize("field", sorted(FIELDS))
@pytest.mark.parametrize("op", sorted(ORACLE))
def test_binary_ops_match_jax_and_oracle(op, field):
    fc, jfc = FIELDS[field]
    p = fc.params.p
    xs = [x % p for x in _vals(1, 64)]
    ys = [y % p for y in _vals(2, 64)[::-1]]
    got = getattr(limb, op)(limb.encode(xs, fc), limb.encode(ys, fc), fc)
    assert limb.decode(got, fc) == [ORACLE[op](x, y, p)
                                    for x, y in zip(xs, ys)]
    ref = getattr(jlimb, op)(jlimb.encode(xs, jfc), jlimb.encode(ys, jfc), jfc)
    assert torch.equal(got, limb.from_jax_limbs(np.asarray(ref)))


def test_neg_select_and_broadcast():
    xs, ys = _vals(3, 32), _vals(4, 32)
    a, b = limb.encode(xs), limb.encode(ys)
    assert limb.decode(limb.neg(a)) == [(-x) % P for x in xs]
    cond = torch.arange(32) % 3 == 0
    assert limb.decode(limb.select(cond, a, b)) == [
        x if i % 3 == 0 else y for i, (x, y) in enumerate(zip(xs, ys))]
    c = 0x1234567 % P
    assert limb.decode(limb.mont_mul(a, limb.encode(c))) == [
        x * c % P for x in xs]


def test_encode_decode_match_jax_limbs():
    xs = _vals(5, 40)
    words = limb.encode(xs)
    jax_limbs = np.asarray(jlimb.encode(xs, JFR_C))
    assert torch.equal(words, limb.from_jax_limbs(jax_limbs))
    assert np.array_equal(limb.to_jax_limbs(words), jax_limbs)
    assert limb.decode(words) == xs
    assert limb.decode(limb.encode(xs[0])) == xs[0]


def test_frvec_words_round_trip_zero_copy():
    xs = _vals(6, 48)
    v = FrVec.from_ints(xs)
    w = limb.frvec_to_words(v)
    assert w.shape == (48, 8) and w.dtype == torch.int32
    assert torch.equal(w, limb.encode(xs))
    # a view of the FrVec's own buffer, not a copy
    assert w.data_ptr() == torch.frombuffer(v._mont, dtype=torch.int32).data_ptr()
    back = limb.words_to_frvec(w)
    assert back.to_ints() == xs and bytes(back._mont) == bytes(v._mont)
    # the JAX package's FrVec holds the same bytes
    assert bytes(JFrVec.from_ints(xs)._mont) == bytes(v._mont)
    # a vector without native bytes packs first
    assert torch.equal(limb.frvec_to_words(FrVec(48, ints=list(xs))), w)
    # only the first n elements of a longer buffer (folded in place)
    half = FrVec(24, mont=v._mont)
    assert torch.equal(limb.frvec_to_words(half), w[:24])


def test_sum_mod_matches_oracle():
    for n in (1, 2, 7, 64):
        xs = _vals(7 + n, max(n, 4))[:n]
        assert limb.decode(sum_mod(limb.encode(xs))) == sum(xs) % P
    assert limb.decode(sum_mod(torch.zeros((0, 8), dtype=torch.int32))) == 0
