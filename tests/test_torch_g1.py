"""Kernel A's fold entry on the CPU: `pt_sum_plain` (the left fold of
`pt_add_plain` that zg1_sum is held to on the card) against a Python loop
of the JAX package's `pt_add` over the same stacked arrays, `sum_work`
against the cases counted one by one, and the wrapper's checks.

Inputs: `chip_smoke.g1_fold_stack`, points of `curve.host.random_points`
each with a random Z, the columns' kinds drawn by numpy seeds; some
columns meet, mid-fold, an empty bucket (Z = 0), the running sum's
negative and the running sum itself. JAX's `pt_add` and its inner
`pt_double` run op by op (`__wrapped__`), so nothing compiles.
Tolerance: exact (equal Jacobian words).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import g1_fold_stack
from zolt_tpu.curve import device as jax_dev
from zolt_tpu_torch.curve import device as dev
from zolt_tpu_torch.curve import host
from zolt_tpu_torch.field import limb


def _stack(k: int, n: int, seed: int):
    """chip_smoke.g1_fold_stack's (k, n, 8) words and each column's host
    affine points (None: an empty bucket)."""
    words = g1_fold_stack(k, n, seed)
    arrays = [dev.to_affine_host(tuple(c[j] for c in words))
              for j in range(k)]
    return words, [list(col) for col in zip(*arrays)]


def _to_jax(pt):
    return tuple(jnp.asarray(limb.to_jax_limbs(c)) for c in pt)


def _from_jax(pt):
    return tuple(limb.from_jax_limbs(np.asarray(c)) for c in pt)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_pt_sum_plain_gives_the_words_of_jax_pt_add_folded(monkeypatch, k):
    """pt_sum_plain's words equal JAX's pt_add applied left to right over
    the stacked arrays (msm_mesh's fori_loop), on 37 columns with empty
    buckets, the running sum's negative and the running sum itself
    mid-fold; the sums' points are the host tier's."""
    words, cols = _stack(k, 37, 100 + k)
    monkeypatch.setattr(jax_dev, "pt_double", jax_dev.pt_double.__wrapped__)
    acc = _to_jax(tuple(c[0] for c in words))
    for j in range(1, k):
        acc = jax_dev.pt_add.__wrapped__(acc, _to_jax(tuple(c[j]
                                                            for c in words)))
    got = dev.pt_sum_plain(words)
    assert all(g.shape == (37, 8) for g in got)
    for g, w in zip(got, _from_jax(acc)):
        assert torch.equal(g, w)
    want = []
    for col in cols:
        s = None
        for p in col:
            s = host.add(s, p)
        want.append(s)
    assert dev.to_affine_host(got) == want
    # the CPU wrapper is the plain version
    assert all(torch.equal(a, b) for a, b in zip(dev.pt_sum(words), got))


@pytest.mark.parametrize("k", [2, 4])
def test_sum_work_counts_each_step_by_its_case(k):
    """sum_work charges each step what kernel A's add charges its case
    (add_work): none with an identity operand, 8 + 7 for P + P, 14 for
    P + (−P), 16 else, the cases told apart here on the host in affine
    form; each point read once and each sum written once."""
    words, cols = _stack(k, 37, 200 + k)
    prods, cases = 0, set()
    for col in cols:
        acc = col[0]
        for p in col[1:]:
            if acc is not None and p is not None:
                case = 15 if acc == p else 14 if acc == host.neg(p) else 16
                prods += case
                cases.add(case)
            acc = host.add(acc, p)
    assert cases == {14, 15, 16}
    assert dev.sum_work(words) == ((k + 1) * 37 * 96,
                                   prods * limb.MONT_IMADS)


def test_pt_sum_refuses_what_its_kernel_does_not_take():
    meta = tuple(torch.empty((2, 4, 8), dtype=torch.int32, device="meta")
                 for _ in range(3))
    with pytest.raises(ValueError, match="no kernel"):
        dev.pt_sum(meta)
    flat = tuple(c[0] for c in meta)
    with pytest.raises(ValueError, match=r"\(k, n, 8\)"):
        dev.pt_sum(flat)
    assert [dev.lanes_per_pair(n) for n in (1, 2048, 2049, 4096, 8192)] \
        == [8, 8, 4, 4, 4]
