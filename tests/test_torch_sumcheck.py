"""The port's dense MLE helpers and generic product sumcheck against the JAX
package's (zolt_tpu.poly.dense, zolt_tpu.sumcheck.driver), on the CPU.

Inputs are canonical field elements from numpy seeds; each table is
encoded once by the JAX package and carried to the port through
`limb.from_jax_limbs` (the same residues). On CPU tensors the port's
bind_low and ProductSumcheck run the plain versions of the fold and the
product evals (kernels 1-3 and G) for every k; on a card k = 1 and 5 take
kernel G (tests/test_torch_cuda.py). Tolerance: exact (equal ints, equal
compressed polys, challenges and claims).

About 25 s in one process on an 8-core CPU box, nearly all of it XLA
compiling the JAX references' limb ops at each table shape.
"""

import numpy as np
import pytest
import torch

from zolt_tpu.field import limb as jlimb
from zolt_tpu.poly import dense as jdense
from zolt_tpu.sumcheck import driver as jdriver
from zolt_tpu.transcript import Blake2bTranscript as JBlake2b
from zolt_tpu_torch.field import limb
from zolt_tpu_torch.field.params import FR
from zolt_tpu_torch.poly import dense
from zolt_tpu_torch.sumcheck import (ProductSumcheck, initial_claim_product,
                                     run_sumcheck, verify_sumcheck)
from zolt_tpu_torch.transcript import Blake2bTranscript

torch.set_num_threads(1)
P = FR.p


def _ints(seed: int, n: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def _both(vals):
    """The JAX limb array of vals, and the port's words of the same."""
    j = jlimb.encode(vals)
    return j, limb.from_jax_limbs(np.asarray(j))


def _jints(arr) -> list[int]:
    return [int(v) for v in np.atleast_1d(jlimb.decode(np.asarray(arr)))]


def test_bind_low_bind_first_and_evaluate_equal_jax():
    vals = _ints(1, 8)
    r, point = _ints(2, 1)[0], _ints(3, 3)
    j, t = _both(vals)
    rl = jlimb.encode([r])[0]
    assert limb.decode(dense.bind_low(t, r)) == _jints(jdense.bind_low(j, rl))
    assert limb.decode(dense.bind_first(t, r)) == \
        _jints(jdense.bind_first(j, rl))
    assert dense.evaluate(t, point) == jdense.evaluate(j, point)


@pytest.mark.parametrize("scale", [1, 0x1234_5678_9ABC])
def test_eq_evals_equal_jax(scale):
    r = _ints(4, 3)
    got = dense.eq_evals(r, scale=scale, device="cpu")
    assert limb.decode(got) == _jints(jdense.eq_evals(r, scale=scale))
    assert limb.decode(dense.eq_evals([], scale=scale, device="cpu")) == \
        [scale]


def test_eq_mle_equals_jax():
    r, x = _ints(5, 4), [1, 0, 1, 1]
    assert dense.eq_mle(r, x, P) == jdense.eq_mle(r, x, P)
    assert dense.eq_mle(r, _ints(6, 4), P) == jdense.eq_mle(r, _ints(6, 4), P)


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_product_sumcheck_equals_jax(k):
    """run_sumcheck over k factors of 4 entries: the compressed round
    polys, challenges, final claim and final openings equal JAX's; the
    port's verifier accepts and ends at Π_j A_j(r)."""
    tabs = [_both(_ints(10 + j, 4)) for j in range(k)]
    claim = initial_claim_product([t for _, t in tabs])
    assert claim == jdriver.initial_claim_product([j for j, _ in tabs])
    ref_inst = jdriver.ProductSumcheck([j for j, _ in tabs])
    ref = jdriver.run_sumcheck(ref_inst, JBlake2b(b"sc"), claim)
    inst = ProductSumcheck([t for _, t in tabs])
    assert (inst.num_rounds, inst.degree) == (2, k)
    got = run_sumcheck(inst, Blake2bTranscript(b"sc"), claim)
    assert got.compressed_polys == ref.compressed_polys
    assert got.challenges == ref.challenges
    assert got.final_claim == ref.final_claim
    finals = inst.final_claims()
    assert finals == ref_inst.final_claims()
    final, rs = verify_sumcheck(got, Blake2bTranscript(b"sc"), claim, 2, k)
    assert rs == got.challenges
    prod = 1
    for v in finals:
        prod = prod * v % P
    assert final == prod == got.final_claim


def test_initial_claim_of_one_entry_is_the_product():
    a, b = _ints(20, 1), _ints(21, 1)
    got = initial_claim_product([limb.encode(a), limb.encode(b)])
    assert got == a[0] * b[0] % P
