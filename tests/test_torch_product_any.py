"""Product sumchecks of any number of factors k and any degree (the
functions of kernel G, csrc/product_evals_any.cu) against the JAX package,
on the CPU.

The port's DeviceProductTables at tail 0, on one "cpu" device and on a
mesh of two "cpu" shards, for (k, degree) in {(1, 1), (4, 4), (5, 7),
(2, 5), (3, 4)}: every round's evals, the compressed round polys, the
challenges, the final claim and the tables' finals of a sumcheck driven
through run_sumcheck, against zolt_tpu's DeviceProductTables on its host
FrVec tier driven through zolt_tpu's run_sumcheck. ProductSumcheck and
initial_claim_product at k = 4 and 8 the same way: the proof against
zolt_tpu's run_sumcheck over its host FrVec tier, the claim against
zolt_tpu's initial_claim_product. (Each of these raised before: the port
refused k outside {2, 3} and degrees above 3.) JAX's own XLA engine and
ProductSumcheck compile for 40-180 s a shape on this CPU, so its host
tier is the reference, as in tests/test_torch_legacy.py. On CPU tensors
the port runs the kernels' plain versions; kernel G itself runs only on a
card (tests/test_torch_cuda.py, chip_smoke.py). Tolerance: exact (equal
ints). About 15 s on an 8-core CPU box, most of it XLA compiling JAX's
initial_claim_product at one shape.
"""

import numpy as np
import pytest
import torch

from zolt_tpu.field import limb as jlimb
from zolt_tpu.native.frvec import FrVec as JFrVec
from zolt_tpu.parallel import stage_engine as jse
from zolt_tpu.sumcheck import driver as jdriver
from zolt_tpu.transcript import Blake2bTranscript as JBlake2b
from zolt_tpu_torch.field import evals, limb
from zolt_tpu_torch.field.params import FR
from zolt_tpu_torch.native.frvec import FrVec
from zolt_tpu_torch.parallel import make_mesh, stage_engine as se
from zolt_tpu_torch.sumcheck import (ProductSumcheck, initial_claim_product,
                                     run_sumcheck, verify_sumcheck)
from zolt_tpu_torch.transcript import Blake2bTranscript

torch.set_num_threads(1)
P = FR.p
N = 64


def _ints(seed: int, n: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % P for _ in range(n)]


class _Engine:
    """A sumcheck instance over an engine, recording its round evals."""

    def __init__(self, eng, rounds: int, degree: int):
        self.eng, self.num_rounds, self.degree = eng, rounds, degree
        self.evals: list[list[int]] = []

    def round_evals(self) -> list[int]:
        self.evals.append(self.eng.round_evals())
        return self.evals[-1]

    def bind(self, r: int) -> None:
        self.eng.bind(r)


class _JaxHost:
    """zolt_tpu's host FrVec tier as a sumcheck instance over k factors."""

    def __init__(self, vals, degree: int):
        self.vecs = [JFrVec.from_ints(v) for v in vals]
        self.num_rounds = len(vals[0]).bit_length() - 1
        self.degree = degree

    def round_evals(self) -> list[int]:
        return JFrVec.prod_evals_adj(self.vecs, self.degree)

    def bind(self, r: int) -> None:
        self.vecs = [v.fold_adj(r) for v in self.vecs]

    def final_claims(self) -> list[int]:
        return [v.first() for v in self.vecs]


def _claim(vals) -> int:
    ev = JFrVec.prod_evals_adj([JFrVec.from_ints(v) for v in vals], 1)
    return (ev[0] + ev[1]) % P


@pytest.mark.parametrize("n_dev", [1, 2], ids=["device", "mesh2"])
@pytest.mark.parametrize("k,degree", [(1, 1), (4, 4), (5, 7), (2, 5),
                                      (3, 4)])
def test_product_tables_of_any_k_and_degree_match_jax(monkeypatch, k,
                                                      degree, n_dev):
    """Every round on the port's engine (tail 0) against zolt_tpu's
    engine on its host tier: round evals, proof, final claim, finals. A
    factor arrives as a resident tensor, the rest as FrVecs; one
    passenger folds along. On the mesh the rounds run sharded until a
    shard holds fewer than 2 entries, and each round's evals are the
    shards' partial evals summed by _psum_field (for k = 1, sums of the
    factor itself, with no product)."""
    monkeypatch.setenv("ZOLT_TPU_DEVICE_TAIL", "0")
    monkeypatch.setattr(jse, "tail_n", lambda: 1 << 30)
    vals = [_ints(100 * k + degree + j, N) for j in range(k + 1)]
    port_in = [limb.encode(vals[0])] + [FrVec.from_ints(v) for v in vals[1:]]
    where = (dict(device="cpu") if n_dev == 1 else
             dict(mesh=make_mesh(["cpu"] * n_dev)))
    port = se.DeviceProductTables(port_in[:k], port_in[k:], degree=degree,
                                  **where)
    assert port.n_dev == n_dev
    ref = jse.DeviceProductTables([JFrVec.from_ints(v) for v in vals[:k]],
                                  [JFrVec.from_ints(v) for v in vals[k:]],
                                  degree=degree)
    rounds = N.bit_length() - 1
    got_i, ref_i = _Engine(port, rounds, degree), _Engine(ref, rounds, degree)
    claim = _claim(vals[:k])
    got = run_sumcheck(got_i, Blake2bTranscript(b"any"), claim)
    want = jdriver.run_sumcheck(ref_i, JBlake2b(b"any"), claim)
    assert got_i.evals == ref_i.evals
    assert all(len(e) == degree + 1 for e in got_i.evals)
    assert got.compressed_polys == want.compressed_polys
    assert got.challenges == want.challenges
    assert got.final_claim == want.final_claim
    assert port.finals() == ref.finals()
    # the claim evolves to the product of the factors' finals
    prod = 1
    for v in port.finals()[:k]:
        prod = prod * v % P
    assert got.final_claim == prod


def test_round_evals_many_of_mixed_k_on_a_mesh(monkeypatch):
    """Engines of k = 1, 2, 4 and degrees 1, 5, 4 (kernel G's groups and
    a kernel 2-3 one) in one round_evals_many a round on a 2-shard mesh,
    each equal to the host tier's evals."""
    monkeypatch.setenv("ZOLT_TPU_DEVICE_TAIL", "0")
    mesh = make_mesh(["cpu"] * 2)
    shapes = [(1, 1), (2, 5), (4, 4), (2, 2)]
    vals = {s: [_ints(7 * s[0] + s[1] + j, N) for j in range(s[0])]
            for s in shapes}
    engs = [se.DeviceProductTables([FrVec.from_ints(v) for v in vals[s]],
                                   degree=s[1], mesh=mesh) for s in shapes]
    hosts = {s: [JFrVec.from_ints(v) for v in vals[s]] for s in shapes}
    for r in _ints(3, N.bit_length() - 1):
        futs = se.round_evals_many(engs)
        got = [e.round_evals() if f is None else ev for e, f, ev in
               zip(engs, futs, se.drain_futures(futs))]
        assert got == [JFrVec.prod_evals_adj(hosts[s], s[1]) for s in shapes]
        for e in engs:
            e.bind(r)
        hosts = {s: [v.fold_adj(r) for v in hosts[s]] for s in shapes}
    assert [e.finals() for e in engs] == \
        [[v.first() for v in hosts[s]] for s in shapes]


@pytest.mark.parametrize("k", [4, 8])
def test_product_sumcheck_of_k_4_and_8_equals_jax(k):
    """ProductSumcheck and initial_claim_product of k factors of 2^6
    entries: the claim equals zolt_tpu's initial_claim_product (one XLA
    shape for both k), the proof zolt_tpu's run_sumcheck over its host
    tier; the port's verifier accepts and ends at Π_j A_j(r)."""
    vals = [_ints(40 + j, N) for j in range(k)]
    tabs = [limb.encode(v) for v in vals]
    claim = initial_claim_product(tabs)
    assert claim == jdriver.initial_claim_product(
        [jlimb.encode(v) for v in vals])
    inst = ProductSumcheck(tabs)
    assert (inst.num_rounds, inst.degree) == (6, k)
    ref_inst = _JaxHost(vals, k)
    got = run_sumcheck(inst, Blake2bTranscript(b"pk"), claim)
    want = jdriver.run_sumcheck(ref_inst, JBlake2b(b"pk"), claim)
    assert got.compressed_polys == want.compressed_polys
    assert got.challenges == want.challenges
    assert got.final_claim == want.final_claim
    finals = inst.final_claims()
    assert finals == ref_inst.final_claims()
    final, rs = verify_sumcheck(got, Blake2bTranscript(b"pk"), claim, 6, k)
    assert rs == got.challenges
    prod = 1
    for v in finals:
        prod = prod * v % P
    assert final == prod == got.final_claim


def test_kernel_g_plan_and_work():
    """Kernel G's descriptors (every point 0..degree, in runs of
    ANY_POINTS) and its work: k·64 bytes a live pair, the evals written
    once, (k − 2) Montgomery and one wide product a point a pair over
    min(degree, k) + 1 points."""
    assert evals.descriptors(0) == [(0, 1)]
    assert evals.descriptors(1) == [(0, 2)]
    assert evals.descriptors(3) == [(0, 4)]
    assert evals.descriptors(4) == [(0, 4), (4, 1)]
    assert evals.descriptors(5) == [(0, 4), (4, 2)]
    assert evals.descriptors(7) == [(0, 4), (4, 4)]
    assert evals.descriptors(11) == [(0, 4), (4, 4), (8, 4)]
    assert [evals.on_kernels_23(k, d) for k, d in
            ((2, 3), (3, 3), (2, 4), (1, 1), (4, 2))] == \
        [True, True, False, False, False]
    t4 = torch.zeros((4, 16, 8), dtype=torch.int32)
    t1 = torch.zeros((1, 16, 8), dtype=torch.int32)
    assert evals.work_any([(t4, 8, 4)]) == (
        4 * 8 * 64 + 5 * 32, 8 * 5 * (2 * limb.MONT_IMADS + limb.WIDE_IMADS))
    assert evals.work_any([(t1, 8, 3)]) == (8 * 64 + 4 * 32, 0)
    # the plain version takes any group on the CPU, in one call
    got = evals.product_evals([(t1, 0, 2), (t4, 3, 6)])
    assert [tuple(g.shape) for g in got] == [(3, 8), (7, 8)]
    assert not any(g.any() for g in got)
    with pytest.raises(ValueError, match="degree -1"):
        evals.product_evals([(t4, 8, -1)])
