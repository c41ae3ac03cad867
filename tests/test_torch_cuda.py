"""The port's CUDA kernels (zolt_tpu_torch/csrc) against their plain torch
versions, on the GPU.

These tests need a CUDA device and nvcc, and skip without them. The GPU
machine has no JAX, so run them there without the suite's conftest (which
imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

chip_smoke.py holds each kernel to its plain version at the main path's
shapes; these add the shapes the path does not produce: live prefixes that
are not powers of two, a single pair, degrees 0-3, and tables large enough
that every thread walks several grid strides; for the grouped fold, mixed
groups (each with its own k, live prefix and challenge) and more than 16
groups; for the grouped product evals, both schedules (a thread a pair,
four threads a pair) at every live count, mixed groups in one launch
(chip_smoke.MIXED_GROUPS), launches back to back (the kernel's scratch
must return to zero) and more than 16 groups; for the Gruen round, its
three modes (eval, fold then eval, fold), the eval-only pass in both
schedules (a thread a pair, two threads a pair) on each side of the
crossover, and each of its ways to weight by the eq factors; the fold and
the k = 2 product evals at the sound batch opening's shapes (groups of
2^20 and 2^16 entries, 16 a launch); the G1 kernels A-D against their
plain versions (A word for word, its fold at every lanes a pair, B-D in
affine form, B and the Pippenger
also against the native C tier) and HyperKZG on the Pippenger; the
sound prove at T = 2^10 on the GPU (its one-hot cubes through kernel B)
against the host tier's bytes; the legacy and internal proves at
T = 2^10 on the GPU against the host tiers' bytes; kernel G (the product
evals of any k and degree) alone, mixed with kernels 2-3 in one call and
in launches of more than 16 descriptors; the generic product sumcheck
(every k on the kernels against the plain versions); kernel F's divstep
batch inverse with chunks of zeros beside chunks of values. Every
wrapper's launch counter must
go up by exactly one per launch. Tolerance: exact (equal words), since every
value is a canonical field element.
"""

import numpy as np
import pytest
import torch

from chip_smoke import MIXED_GROUPS, field_words
from zolt_tpu_torch.field import evals, fold, gruen
from zolt_tpu_torch.msm import rows_device

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on a GPU")
    g = torch.Generator(device="cuda")
    g.manual_seed(20261016)
    return g


def _tables(gen, k: int, n: int, live: int) -> torch.Tensor:
    """(k, n, 8) canonical Montgomery words (top 3 bits clear: < 2^253 < p),
    zero behind the first `live` entries."""
    w = torch.randint(-2 ** 31, 2 ** 31, (k, n, 8), dtype=torch.int64,
                      device="cuda", generator=gen).to(torch.int32)
    w[..., 7] &= 0x1FFFFFFF
    w[:, live:] = 0
    return w.contiguous()


@pytest.mark.parametrize("k,n,live_pairs", [
    (1, 2, 1), (2, 7, 3), (2, 1000, 37), (3, 4096, 2048),
    (2, 1 << 21, 1 << 20)])
def test_fold_kernel_matches_plain(gen, k, n, live_pairs):
    tabs = _tables(gen, k, n, 2 * live_pairs)
    r = 0x2A5C_1234_5678_9ABC_DEF0_1122_3344_5566
    before = fold.fold_many.counts["launches"]
    got = fold.fold(tabs, r, live_pairs)
    torch.cuda.synchronize()
    assert fold.fold_many.counts["launches"] == before + 1
    assert got.shape == (k, live_pairs, 8)
    assert torch.equal(got, fold.fold_plain(tabs, r, live_pairs))


@pytest.mark.parametrize("ngroups", [7, 20])
def test_grouped_fold_matches_plain(gen, ngroups):
    """Mixed groups, each its own k, table, live prefix (0 included) and
    challenge; 16 groups a launch."""
    groups = [(_tables(gen, 1 + i % 5, 64 << (i % 7), 64 << (i % 7)),
               0x1234567 * (i + 1),
               0 if i == 4 else (32 << (i % 7)) - 3 * (i % 3))
              for i in range(ngroups)]
    before = dict(fold.fold_many.counts)
    got = fold.fold_many(groups)
    torch.cuda.synchronize()
    c = fold.fold_many.counts
    assert c["launches"] == before["launches"] + -(-ngroups // 16)
    assert c["groups"] == before["groups"] + sum(1 for g in groups if g[2])
    for out, want in zip(got, fold.fold_many_plain(groups)):
        assert torch.equal(out, want)


@pytest.mark.parametrize("split_max", [0, 1 << 62],
                         ids=["thread_a_pair", "four_threads_a_pair"])
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("live_pairs", [0, 1, 37, 1000, 8193, 1 << 18])
def test_product_evals_kernels_match_plain(gen, monkeypatch, split_max, k,
                                           live_pairs):
    """One group per launch, degrees 0-3, each schedule at every count."""
    monkeypatch.setattr(evals, "SPLIT_MAX_PAIRS", split_max)
    n = max(2048, 2 * live_pairs)
    tabs = _tables(gen, k, n, 2 * live_pairs)
    for degree in range(evals.MAX_DEGREE + 1):
        before = dict(evals.product_evals.counts)
        got, = evals.product_evals([(tabs, live_pairs, degree)])
        torch.cuda.synchronize()
        c = evals.product_evals.counts
        assert c["launches"] == before["launches"] + 1
        assert c[f"groups_k{k}"] == before[f"groups_k{k}"] + 1
        assert torch.equal(got,
                           evals.product_evals_plain(tabs, live_pairs, degree))


def test_grouped_launch_matches_plain_and_resets_its_tickets(gen):
    """One launch over mixed groups, three times back to back on the same
    inputs: the same words every time (each launch's last blocks found
    their tickets at zero), and equal to the plain version per group."""
    groups = [(_tables(gen, k, n, 2 * live), live, deg)
              for k, n, live, deg in MIXED_GROUPS]
    want = [evals.product_evals_plain(*g) for g in groups]
    before = evals.product_evals.counts["launches"]
    for _ in range(3):
        got = evals.product_evals(groups)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert evals.product_evals.counts["launches"] == before + 3
    assert not evals._scratch(groups[0][0].device).any()


def test_grouped_launch_of_more_than_sixteen_groups(gen):
    groups = [(_tables(gen, 2 + i % 2, 512, 2 * (i + 1)), i + 1, i % 4)
              for i in range(20)]
    before = evals.product_evals.counts["launches"]
    got = evals.product_evals(groups)
    torch.cuda.synchronize()
    assert evals.product_evals.counts["launches"] == before + 2
    for g, out in zip(groups, got):
        assert torch.equal(out, evals.product_evals_plain(*g))


# ---------------------------------------------------------------------------
# Kernel G (csrc/product_evals_any.cu): product evals of any k and degree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,degrees", [
    (1, (0, 1, 2, 5)), (2, (4, 5, 9)), (3, (4, 6)), (4, (0, 3, 4, 6)),
    (5, (5, 7)), (8, (2, 8, 11))])
@pytest.mark.parametrize("live_pairs", [0, 1, 37, 1000, 8193, 1 << 17])
def test_product_evals_any_kernel_matches_plain(gen, k, degrees, live_pairs):
    """Kernel G, one group per call: every point summed, in runs of four;
    words equal to the plain version's."""
    n = max(2048, 2 * live_pairs)
    tabs = _tables(gen, k, n, 2 * live_pairs)
    for degree in degrees:
        before = dict(evals.counts_g)
        g = (tabs, live_pairs, degree)
        got, = evals.product_evals([g])
        torch.cuda.synchronize()
        c = evals.counts_g
        assert c["launches"] == before["launches"] + 1
        assert c["descriptors"] == before["descriptors"] + \
            len(evals.descriptors(degree))
        assert torch.equal(got, evals.product_evals_plain(*g)), degree


def test_product_evals_any_mixed_with_kernels_2_3(gen):
    """Groups of every k in one call: the k = 2, 3 groups of degree <= 3
    take one launch of kernels 2-3, the others two launches of kernel G
    (21 descriptors, 16 a launch), three times back to back (the tickets
    reset); every group equal to the plain version."""
    shapes = [(1, 1), (2, 2), (4, 4), (3, 3), (2, 5), (5, 7), (3, 4),
              (1, 0), (8, 8), (2, 3), (6, 2), (8, 11), (7, 7), (4, 6)]
    groups = [(_tables(gen, k, 4096, 2 * live), live, deg)
              for (k, deg), live in zip(shapes, (2048, 1999, 1, 77, 0, 2048,
                                                 513, 9, 1000, 8, 2047, 64,
                                                 1500, 3))]
    want = [evals.product_evals_plain(*g) for g in groups]
    descs = sum(len(evals.descriptors(d)) for t, _, d in groups
                if not evals.on_kernels_23(t.shape[0], d))
    assert descs == 21
    for _ in range(3):
        b23 = evals.product_evals.counts["launches"]
        bg = evals.counts_g["launches"]
        got = evals.product_evals(groups)
        torch.cuda.synchronize()
        assert evals.product_evals.counts["launches"] == b23 + 1
        assert evals.counts_g["launches"] == bg + 2
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert not evals._scratch_g(groups[0][0].device).any()


@pytest.mark.parametrize("k", [1, 5])
def test_product_sumcheck_of_k_1_or_above_3_on_cuda(gen, k):
    """A product sumcheck of k = 1 or 5 factors on the card takes kernel
    G, whose evals equal product_evals_plain's every round."""
    from zolt_tpu_torch.field import fold
    from zolt_tpu_torch.sumcheck import ProductSumcheck

    inst = ProductSumcheck([_tables(gen, 1, 256, 256)[0] for _ in range(k)])
    for r in range(3, 3 + inst.num_rounds):
        before = evals.counts_g["launches"]
        g = (inst.tabs, inst.tabs.shape[1] // 2, k)
        got = evals.product_evals([g])[0]
        assert evals.counts_g["launches"] == before + 1
        assert torch.equal(got, evals.product_evals_plain(*g))
        assert inst.round_evals() == \
            evals.limb.decode(evals.product_evals_plain(*g))
        inst.tabs = fold.fold_plain(inst.tabs, r, inst.tabs.shape[1] // 2)


@pytest.mark.parametrize("k", [2, 3])
def test_grouped_launch_at_2_21_entries(gen, k):
    """Every thread walks several grid strides (1024 blocks a group)."""
    n = 1 << 21
    tabs = _tables(gen, k, n, n)
    got, = evals.product_evals([(tabs, n // 2, 3)])
    assert torch.equal(got, evals.product_evals_plain(tabs, n // 2, 3))


@pytest.mark.parametrize("live_pairs,h_in,off_out,off_in", [
    (1, 0, 0, 0), (5, 1, 3, 1), (300, 3, 5, 2), (1 << 17, 9, 1, 511)])
def test_gruen_kernel_matches_plain(gen, live_pairs, h_in, off_out, off_in):
    n = 2 * live_pairs
    ab = _tables(gen, 2, n, n)
    e_out = _tables(gen, 1, off_out + ((live_pairs - 1) >> h_in) + 1,
                    1 << 30)[0]
    e_in = _tables(gen, 1, off_in + (1 << h_in), 1 << 30)[0]
    args = (ab[0], ab[1], e_out, e_in, off_out, off_in, h_in, live_pairs)
    before = gruen.gruen_round.counts["launches"]
    got = gruen.gruen_eval(*args)
    torch.cuda.synchronize()
    assert gruen.gruen_round.counts["launches"] == before + 1
    assert torch.equal(got, gruen.gruen_eval_plain(*args))


@pytest.mark.parametrize("mode,split_max", [
    ("eval", 0), ("eval", 1 << 62), ("fused", 1 << 62), ("fold", 1 << 62)],
    ids=["eval-thread_a_pair", "eval-two_threads_a_pair",
         "fused-two_threads_a_pair", "fold-two_threads_a_pair"])
@pytest.mark.parametrize("live_pairs,h_in", [
    (1, 0), (2, 0), (3, 1), (96, 3), (1000, 0), (4096, 5), (1 << 13, 9),
    (1 << 14, 6), (1 << 15, 8), (1 << 17, 8)])
def test_gruen_round_modes_match_plain(gen, monkeypatch, split_max, mode,
                                       live_pairs, h_in):
    """Each mode in each of its schedules (the eval-only pass forced to
    each in turn, whatever side of gruen.SPLIT_MAX_PAIRS the count lies; a
    pass that folds always takes two threads a pair), at the live pair
    counts the kernel weights by E_out a block, by E_in a block (h_in = 0)
    and by E_in a thread; live_pairs counts the pairs folded in the fold
    modes."""
    monkeypatch.setattr(gruen, "SPLIT_MAX_PAIRS", split_max)
    ab = _tables(gen, 2, 2 * live_pairs, 2 * live_pairs)
    pairs = live_pairs // 2 if mode == "fused" else live_pairs
    e_out = _tables(gen, 1, 8 + max(0, (pairs - 1) >> h_in), 1 << 30)[0]
    e_in = _tables(gen, 1, 5 + (1 << h_in), 1 << 30)[0]
    r = None if mode == "eval" else 0x5EED_0123_4567_89AB
    args = (ab, r, e_out, e_in, 7, 5, h_in, live_pairs, mode != "fold")
    before = dict(gruen.gruen_round.counts)
    for _ in range(2):                     # the scratch returns to zero
        tabs, ev = gruen.gruen_round(*args)
        torch.cuda.synchronize()
        want_tabs, want_ev = gruen.gruen_round_plain(*args)
        assert torch.equal(tabs, want_tabs)
        assert (ev is None) == (want_ev is None)
        if ev is not None:
            assert torch.equal(ev, want_ev)
    c = gruen.gruen_round.counts
    assert c["launches"] == before["launches"] + 2
    assert c[mode] == before[mode] + 2
    assert not gruen._scratch(ab.device).any()


def test_gruen_kernel_refuses_a_fold_a_thread_a_pair(gen, monkeypatch):
    """A pass that folds has one schedule, two threads a pair: the kernel's
    entry refuses a descriptor that asks for one."""
    monkeypatch.setattr(gruen, "schedule", lambda quads, h_in, folds: (1, 1))
    ab = _tables(gen, 2, 64, 64)
    before = gruen.gruen_round.counts["launches"]
    with pytest.raises(RuntimeError, match="CUDA error"):
        gruen.gruen_round(ab, 3, None, None, 0, 0, 0, 32, eval=False)
    assert gruen.gruen_round.counts["launches"] == before


def test_wrappers_refuse_misaligned_tables(gen):
    base = _tables(gen, 1, 2 * 16 * 8 + 1, 0).reshape(-1)
    tabs = base[1: 1 + 2 * 16 * 8].view(2, 16, 8)     # 4-byte offset
    assert tabs.is_contiguous() and tabs.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        fold.fold(tabs, 3, 8)
    with pytest.raises(ValueError, match="aligned"):
        gruen.gruen_round(tabs, 3, None, None, 0, 0, 0, 8, eval=False)
    with pytest.raises(ValueError, match="aligned"):
        evals.product_evals([(tabs, 8, 2)])


@pytest.mark.parametrize("ngroups", [16, 19])
def test_batch_opening_shapes_match_plain(gen, ngroups):
    """The sound batch opening's rounds: k = 2, degree 2, groups of 2^20 and
    2^16 entries at mixed live counts (a group's first round, its later
    rounds, a group that wakes late), 16 groups a launch; the round's
    evals and its fold, each group its own r."""
    sizes = [(1 << 20, 1 << 19), (1 << 16, 1 << 15), (1 << 20, 1 << 10),
             (1 << 16, 1), (1 << 20, 3)]
    lives = [sizes[i % 5][1] for i in range(ngroups)]
    tabs = [_tables(gen, 2, sizes[i % 5][0], 2 * lives[i])
            for i in range(ngroups)]
    launches = -(-ngroups // 16)
    pc = evals.product_evals.counts
    before = (fold.fold_many.counts["launches"], pc["launches"])
    by_k = {k: pc[k] for k in ("bytes_k2", "bytes_k3", "imads_k3")}
    groups = [(t, 0x1234567 * (i + 1), live)
              for i, (t, live) in enumerate(zip(tabs, lives))]
    eg = [(t, live, 2) for t, live in zip(tabs, lives)]
    got = evals.product_evals(eg)
    folded = fold.fold_many(groups)
    torch.cuda.synchronize()
    assert (fold.fold_many.counts["launches"], pc["launches"]) == (
        before[0] + launches, before[1] + launches)
    # all k = 2: the per-k counters put all the work under k = 2
    assert {k: pc[k] - v for k, v in by_k.items()} == {
        "bytes_k2": evals.work(eg)[0], "bytes_k3": 0, "imads_k3": 0}
    for g, f, out in zip(groups, folded, got):
        assert torch.equal(f, fold.fold_plain(*g))
        assert torch.equal(out, evals.product_evals_plain(g[0], g[2], 2))


def test_sound_prove_on_cuda_equals_the_cpu_bytes(tmp_path, monkeypatch):
    """The sound prove of the sum-loop guest at T = 2^10 on the GPU (tail 0:
    every engine round and every batch-opening round in the kernels) gives
    the bytes of the port's host tier."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on a GPU")
    from chip_smoke import sum_loop_elf
    from zolt_tpu_torch.zkvm.pipeline import prove_jolt

    path = str(tmp_path / "sum_loop_t10.elf")
    with open(path, "wb") as f:
        f.write(sum_loop_elf(10))
    host = prove_jolt(path, sound=True, backend="host")
    monkeypatch.setenv("ZOLT_TPU_DEVICE_TAIL", "0")
    before = evals.product_evals.counts["groups_k2"]
    rows_before = rows_device.row_sums.counts["launches"]
    dev = prove_jolt(path, sound=True)
    assert evals.product_evals.counts["groups_k2"] > before
    # the one-hot cubes (2^14 entries) take kernel B
    assert rows_device.row_sums.counts["launches"] > rows_before
    assert (dev.conv.proof.serialize_with_dory()
            == host.conv.proof.serialize_with_dory())


# ---------------------------------------------------------------------------
# G1 kernels A-D (csrc/g1.cu, rows_msm.cu, pippenger.cu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("generic", [False, True])
@pytest.mark.parametrize("n", [1, 100, 4096, (1 << 16) + 5])
def test_g1_add_double_kernel_matches_plain(gen, n, generic):
    """Kernel A's words equal the plain versions' (the JAX formulas), on
    pairs half of them edge cases and on generic pairs only."""
    from chip_smoke import g1_edge_pairs
    from zolt_tpu_torch.curve import device as dev

    pa, pb = (tuple(c.cuda() for c in pt)
              for pt in g1_edge_pairs(n, n, generic=generic))
    for got, want, op in ((dev.pt_add(pa, pb), dev.pt_add_plain(pa, pb),
                           dev.pt_add),
                          (dev.pt_double(pa), dev.pt_double_plain(pa),
                           dev.pt_double)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        before = op.counts["launches"]
        op(pa, pb) if op is dev.pt_add else op(pa)
        assert op.counts["launches"] == before + 1
    # a batch shape beyond one axis
    sq = tuple(c[: n - n % 4].view(-1, 4, 8) for c in pa)
    if sq[0].numel():
        assert all(torch.equal(g, w) for g, w in
                   zip(dev.pt_double(sq), dev.pt_double_plain(sq)))


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("n", [1, 100, 2048, 4099])
def test_g1_sum_kernel_matches_plain(gen, monkeypatch, k, n):
    """Kernel A's fold (zg1_sum, one launch) at its wrapper's lanes a pair
    and at 4 and 8 gives pt_sum_plain's words on k arrays whose fold
    meets empty buckets, the running sum's negative and the running sum
    itself mid-fold; the kernel refuses 2 lanes a pair."""
    from chip_smoke import g1_fold_stack
    from zolt_tpu_torch.curve import device as dev

    stack = tuple(c.cuda() for c in g1_fold_stack(k, n, 1000 * k + n))
    want = dev.pt_sum_plain(stack)
    for lanes in (dev.lanes_per_pair(n), 4, 8):
        monkeypatch.setattr(dev, "lanes_per_pair", lambda _: lanes)
        before = dev.pt_sum.counts["launches"]
        got = dev.pt_sum(stack)
        torch.cuda.synchronize()
        assert dev.pt_sum.counts["launches"] == before + 1
        assert all(torch.equal(g, w) for g, w in zip(got, want)), lanes
    monkeypatch.setattr(dev, "lanes_per_pair", lambda _: 2)
    with pytest.raises(RuntimeError, match="zg1_sum"):
        dev.pt_sum(stack)


def _edge_basis(g1_vec, cols: int) -> list:
    """A row-MSM basis whose table points meet as P + P and P + (−P): P =
    g1_vec[0] also sits at column cols/2 (a later lane's share from 2
    lanes a row up) and at column 8 (the next group: the same lane's
    share at few lanes), −P at column 1 (group 0's subset {0, 1} sums to
    the identity) and at the last group's first column."""
    from zolt_tpu_torch.curve import host

    basis = list(g1_vec[:cols])
    p = basis[0]
    basis[1] = host.neg(p)
    if cols >= 16:
        basis[8] = p
        basis[cols // 2] = p
        basis[cols - 8] = host.neg(p)
    return basis


def _edge_rows(cols: int, nplanes: int, rng) -> list:
    """Rows of scalars for _edge_basis: none, one and every subset byte
    non-zero; P + (−P) and P + P on one lane and across lanes; a subset
    whose table entry is the identity."""
    top = (1 << nplanes) - 1
    rows = [np.zeros(cols, np.uint8), np.zeros(cols, np.uint8),
            np.full(cols, top, np.uint8),
            rng.integers(1, top + 1, cols).astype(np.uint8)]
    rows[1][3] = top
    for cs in ((0, 1), (0, 8), (0, cols // 2), (0, cols - 8),
               (0, 8, cols // 2, cols - 8)):
        r = np.zeros(cols, np.uint8)
        r[[c for c in cs if c < cols]] = 1
        rows.append(r)
    return rows


@pytest.mark.parametrize("fill", ["random", "edge"])
@pytest.mark.parametrize("cols,nplanes,rows", [(8, 1, 3), (64, 4, 5),
                                               (256, 4, 64), (1024, 1, 33)])
def test_row_msm_kernel_matches_plain_and_native(gen, cols, nplanes, rows,
                                                  fill):
    """Kernel B, affine, against its plain version and the native C row
    MSMs at every lanes-a-row it takes: partial matrices, an all-zero
    poly, random and one-hot scalars; and ("edge") a basis whose points
    meet as P + P and P + (−P) inside a lane and across the lanes' tree,
    with rows of no, one and every subset byte non-zero."""
    from chip_smoke import affine_of
    from zolt_tpu_torch.msm import rows_device
    from zolt_tpu_torch.native import g1_msm_rows_native
    from zolt_tpu_torch.pcs import dory

    srs = dory.setup(20)
    rng = np.random.default_rng(cols + nplanes)
    if fill == "edge":
        basis = _edge_basis(srs.g1_vec, cols)
        polys = [np.concatenate(_edge_rows(cols, nplanes, rng))]
        eng = rows_device.DeviceRowMSM(basis, cols, "cuda")
    else:
        basis = srs.g1_vec[:cols]
        polys = [rng.integers(0, 1 << nplanes, size=cols * rows,
                              dtype=np.uint8),
                 rng.integers(0, 1 << nplanes, size=cols * 2 + 3,
                              dtype=np.uint8),
                 np.zeros(cols * rows, np.uint8)]
        eng = rows_device.get_engine(srs, cols, "cuda")
    rows = max(len(p) for p in polys) // cols
    before = rows_device.row_sums.counts["launches"]
    got = eng.commit_rows(polys, nplanes)
    assert rows_device.row_sums.counts["launches"] == before + 1
    for v, g in zip(polys, got):
        n = -(-len(v) // cols)
        pad = np.zeros(n * cols, np.int64)
        pad[:len(v)] = v
        assert g == g1_msm_rows_native(
            basis, [[int(s) for s in pad[r * cols:(r + 1) * cols]]
                    for r in range(n)])
    vals = torch.from_numpy(np.stack([np.resize(p, cols * rows)
                                      for p in polys])).cuda().view(
        len(polys), rows, cols)
    want = affine_of(rows_device.row_sums_plain(vals, eng.table, eng.valid,
                                                nplanes))
    pick = rows_device.lanes_per_row
    try:
        for lanes in rows_device.LANES:
            rows_device.lanes_per_row = lambda *_, n=lanes: n
            assert affine_of(rows_device.row_sums(
                vals, eng.table, eng.valid, nplanes)) == want
    finally:
        rows_device.lanes_per_row = pick
    before = dict(rows_device.row_sums.counts)
    assert affine_of(rows_device.row_sums(vals, eng.table, eng.valid,
                                          nplanes)) == want
    # the launch counts the work its data needs
    nbytes, imads = rows_device.work(
        rows_device.count_nonzero(vals, eng.valid, nplanes),
        len(polys) * rows, cols, nplanes)
    c = rows_device.row_sums.counts
    assert (c["bytes"] - before["bytes"], c["imads"] - before["imads"]) == (
        nbytes, imads)


def _edge_windows(pts: list, seed: int, device="cuda"):
    """Eight windows of 256 Jacobian buckets (random Z) on the card:
    0 all empty; 1 only bucket 255; 2 only bucket 1; 3 identities whose X
    and Y are not zero (Z = 0); 4 P at buckets 1 and 65 (P + P among a
    lane's four buckets of bit 0), −P at bucket 3 (P + (−P) across the
    lanes' tree), 2P at 2; 5-7 a point at every bucket, bucket 0
    included (no window sum reads it)."""
    from zolt_tpu_torch.curve import host
    from zolt_tpu_torch.field import limb
    from zolt_tpu_torch.field.params import FP

    rng = np.random.default_rng(seed)
    p = FP.p
    x, y, z = [0] * 2048, [0] * 2048, [0] * 2048

    def put(i, pt):
        lam = int(rng.integers(1, 1 << 62)) * int(rng.integers(1, 1 << 62))
        x[i] = pt[0] * lam * lam % p
        y[i] = pt[1] * pow(lam, 3, p) % p
        z[i] = lam % p

    put(256 + 255, pts[0])
    put(512 + 1, pts[1])
    for i in range(768, 1024):
        x[i], y[i] = 5, 7
    P = pts[2]
    for b, pt in ((1, P), (65, P), (3, host.neg(P)), (2, host.double(P))):
        put(1024 + b, pt)
    for i in range(1280, 2048):
        put(i, pts[i % len(pts)])
    return tuple(limb.encode(v, limb.FP_C, device) for v in (x, y, z))


@pytest.mark.parametrize("n,windows", [(32, "msm"), (1000, "msm"),
                                       (1 << 14, "msm"), (256, "edge"),
                                       (1 << 14, "skewed")])
def test_pippenger_kernels_match_plain_and_native(gen, n, windows):
    """Kernels C and D, affine, against their plain versions, and the
    whole Pippenger against the native C MSM: duplicates, a negation, the
    identity, zero scalars. Kernel E's digits equal its plain version's
    and the host's. "edge": kernel D also on windows whose buckets are
    all empty, hold one point (at 255, at 1), identities, or points that
    meet as P + P and P + (−P) in its tree. "skewed": scalars spread as
    the RAM post-values are (chip_smoke.skewed_inputs: a bucket of some
    5600 entries, four passes of kernel C), over 16 points repeated with
    their negations. The wrapper counts one call and a launch a pass."""
    from chip_smoke import affine_of, msm_inputs, skewed_inputs
    from zolt_tpu_torch.field import limb
    from zolt_tpu_torch.msm import pippenger
    from zolt_tpu_torch.native import g1_msm_native
    from zolt_tpu_torch.pcs import srs as srs_mod

    if windows == "skewed":
        pts, sc = skewed_inputs(srs_mod.insecure_setup(16).powers_g1, n, n)
    else:
        pts, sc = msm_inputs(srs_mod.insecure_setup(n), n, n)
    ptab, valid = pippenger.affine_table(pts, "cuda")
    digits = pippenger.int_digits(sc, "cuda")
    ent, seg = pippenger.bucket_plan(digits)
    passes = len(pippenger.bucket_chunks(seg))
    assert windows != "skewed" or passes == 4
    c, d = pippenger.bucket_sums.counts, pippenger.window_sums.counts
    before = (c["launches"], c["kernels"], d["launches"])
    B = pippenger.bucket_sums(ent, seg, ptab, valid)
    W = pippenger.window_sums(*B)
    assert (c["launches"], c["kernels"], d["launches"]) == (
        before[0] + 1, before[1] + passes, before[2] + 1)
    assert affine_of(B) == affine_of(
        pippenger.bucket_sums_plain(ent, seg, ptab, valid))
    assert affine_of(W) == affine_of(pippenger.window_sums_plain(*B))
    words = limb.encode(sc, device="cuda")
    before = pippenger.scalar_digits.counts["launches"]
    assert torch.equal(pippenger.scalar_digits(words), digits)
    assert pippenger.scalar_digits.counts["launches"] == before + 1
    assert torch.equal(pippenger.scalar_digits_plain(words), digits)
    assert pippenger.pippenger(pts, sc, "cuda") == g1_msm_native(pts, sc)
    assert pippenger.msm(pts, sc, device="cuda") == g1_msm_native(pts, sc)
    if windows == "edge":
        from zolt_tpu_torch.curve import host

        live = [q for q in pts if q is not None]
        E = _edge_windows(live, n)
        got = affine_of(pippenger.window_sums(*E))
        assert got == affine_of(pippenger.window_sums_plain(*E))
        assert got[:5] == [None, host.scalar_mul(live[0], 255), live[1],
                           None, host.scalar_mul(live[2], 1 + 65 - 3 + 4)]


def test_hyperkzg_on_cuda_verifies(gen):
    """HyperKZG at 2^15: the commit (its digits by kernel E), the 14 fold
    commitments (2^14 points down to 2) and the three witnesses on the
    Pippenger; the commitment equals the native MSM, the opening
    verifies."""
    import numpy as np

    from zolt_tpu_torch.field import limb
    from zolt_tpu_torch.field.params import FR
    from zolt_tpu_torch.msm import pippenger
    from zolt_tpu_torch.native import g1_msm_native
    from zolt_tpu_torch.pcs import hyperkzg
    from zolt_tpu_torch.pcs import srs as srs_mod
    from zolt_tpu_torch.transcript import Blake2bTranscript

    n = 1 << 15
    kzg = srs_mod.insecure_setup(n)
    rng = np.random.default_rng(15)
    evals = [int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(n)]
    x = [int(v) for v in rng.integers(1, 1 << 62, 15)]
    before = (pippenger.bucket_sums.counts["launches"],
              pippenger.scalar_digits.counts["launches"])
    com = hyperkzg.commit(kzg, limb.encode(evals, device="cuda"))
    assert com == g1_msm_native(kzg.powers_g1, evals)
    proof = hyperkzg.open_at(kzg, evals, x, Blake2bTranscript(b"k"),
                             device="cuda")
    assert (pippenger.bucket_sums.counts["launches"],
            pippenger.scalar_digits.counts["launches"]) == (before[0] + 18,
                                                           before[1] + 1)
    assert hyperkzg.verify(kzg, com, x, hyperkzg._mle_eval(evals, x), proof,
                           Blake2bTranscript(b"k"))


# ---------------------------------------------------------------------------
# The internal and legacy provers, and the generic product sumcheck
# ---------------------------------------------------------------------------

def test_legacy_and_internal_proves_on_cuda_equal_the_host_tier(
        tmp_path, monkeypatch):
    """The sum-loop guest at T = 2^10 on the GPU (tail 0: every round of the
    legacy prover's six stages and of the internal prover's stage 4 in
    the kernels; the internal commitments on the Pippenger) gives the
    bytes of the kernels' plain torch versions (device="cpu")."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on a GPU")
    from chip_smoke import sum_loop_elf
    from zolt_tpu_torch import serialization
    from zolt_tpu_torch.msm import pippenger
    from zolt_tpu_torch.vm import elf as elf_mod
    from zolt_tpu_torch.vm import pad_with_noop, run_elf
    from zolt_tpu_torch.zkvm import internal, prove_program

    path = str(tmp_path / "sum_loop_t10.elf")
    with open(path, "wb") as f:
        f.write(sum_loop_elf(10))
    image = bytes(elf_mod.load_file(path).flat_image()[1])
    monkeypatch.setenv("ZOLT_TPU_DEVICE_TAIL", "0")
    blobs = {}
    for device in ("cpu", "cuda"):
        before = (evals.product_evals.counts["groups_k3"],
                  pippenger.scalar_digits.counts["launches"])
        proof, _ = prove_program(run_elf(path), log_k=10, device=device)
        emu = run_elf(path)
        ip = internal.prove_internal(emu, pad_with_noop(list(emu.trace)),
                                     image, device=device)
        blobs[device] = (serialization.serialize(proof), ip.serialize())
        ran = (evals.product_evals.counts["groups_k3"] > before[0],
               pippenger.scalar_digits.counts["launches"] == before[1] + 3)
        assert ran == ((True, True) if device == "cuda" else (False, False))
    assert blobs["cuda"] == blobs["cpu"]


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_product_sumcheck_on_cuda(gen, k):
    """Every k on the kernels (2, 3 on kernels 2-3, the others on kernel
    G): the claim and the rounds equal the plain versions' on the CPU."""
    from zolt_tpu_torch.sumcheck import (ProductSumcheck,
                                         initial_claim_product, run_sumcheck)
    from zolt_tpu_torch.transcript import Blake2bTranscript

    tabs = [_tables(gen, 1, 64, 64)[0] for _ in range(k)]
    claim = initial_claim_product(tabs)
    assert claim == initial_claim_product([t.cpu() for t in tabs])
    got = run_sumcheck(ProductSumcheck(tabs), Blake2bTranscript(b"s"), claim)
    ref = run_sumcheck(ProductSumcheck([t.cpu() for t in tabs]),
                       Blake2bTranscript(b"s"), claim)
    assert (got.compressed_polys, got.challenges, got.final_claim) == \
        (ref.compressed_polys, ref.challenges, ref.final_claim)


# ---------------------------------------------------------------------------
# The mesh: four shards on one card
# ---------------------------------------------------------------------------

def test_mesh_engines_on_four_shards_of_one_card(gen, monkeypatch):
    """DeviceProductTables(mesh=) and DeviceOuterRounds(mesh=) on make_mesh(
    ["cuda:0"] * 4) against the same engines on "cpu" (the plain
    versions), every round at tail 0, through the hand-off to the host;
    the fold, product-evals and Gruen kernels launch; four shards of one
    card take one grouped launch a round."""
    from zolt_tpu_torch.parallel import make_mesh, stage_engine as se
    from zolt_tpu_torch.poly.special import GruenSplitEq
    from zolt_tpu_torch.zkvm import device_outer as do

    monkeypatch.setenv("ZOLT_TPU_DEVICE_TAIL", "0")
    mesh = make_mesh(["cuda:0"] * 4)
    n = 1 << 12
    rs = [int(v) for v in np.random.default_rng(4).integers(1, 1 << 62, 12)]
    t = _tables(gen, 3, n, n)
    eng = se.DeviceProductTables([t[0], t[1]], [t[2]], degree=2, mesh=mesh)
    ref = se.DeviceProductTables([t[0].cpu(), t[1].cpu()], [t[2].cpu()],
                                 degree=2, device="cpu")
    before = (fold.fold_many.counts["launches"],
              evals.product_evals.counts["launches"])
    for r in rs:
        assert eng.round_evals() == ref.round_evals()
        eng.bind(r)
        ref.bind(r)
    assert eng.finals() == ref.finals()
    # 4 shards a launch: 10 rounds on the card (live 2^12 down to 2^3, a
    # shard's 2 entries), 9 folds there and the pending one flushed at
    # the hand-off
    assert (fold.fold_many.counts["launches"] - before[0],
            evals.product_evals.counts["launches"] - before[1]) == (10, 10)

    se_c, se_r = GruenSplitEq(rs, 5), GruenSplitEq(rs, 5)
    ab = _tables(gen, 2, n, n)
    g0 = gruen.gruen_round.counts["launches"]
    outer = do.DeviceOuterRounds(ab[0], ab[1], se=se_c, mesh=mesh)
    plain = do.DeviceOuterRounds(ab[0].cpu(), ab[1].cpu(), se=se_r,
                                 device="cpu")
    for r in rs:
        assert outer.round_evals() == plain.round_evals()
        outer.bind(r)
        plain.bind(r)
        se_c.bind(r)
        se_r.bind(r)
    assert outer.final_values() == plain.final_values()
    assert gruen.gruen_round.counts["launches"] > g0


def test_msm_mesh_on_four_shards_of_one_card(gen):
    """msm_mesh at 2^12 points on make_mesh(["cuda:0"] * 4) against the
    native C MSM (affine); kernel C launches once a shard a pass, kernel
    A's fold once a pass (its batch add never), kernel D once a pass."""
    from chip_smoke import msm_inputs
    from zolt_tpu_torch.curve import device as dev
    from zolt_tpu_torch.msm import pippenger
    from zolt_tpu_torch.native import g1_msm_native
    from zolt_tpu_torch.parallel import make_mesh
    from zolt_tpu_torch.pcs import srs as srs_mod

    n = 1 << 12
    pts, sc = msm_inputs(srs_mod.insecure_setup(n), n, n)
    c = (pippenger.bucket_sums.counts["launches"],
         dev.pt_sum.counts["launches"],
         pippenger.window_sums.counts["launches"],
         dev.pt_add.counts["launches"])
    got = pippenger.msm_mesh(make_mesh(["cuda:0"] * 4), pts, sc)
    assert got == g1_msm_native(pts, sc)
    assert (pippenger.bucket_sums.counts["launches"] - c[0],
            dev.pt_sum.counts["launches"] - c[1],
            pippenger.window_sums.counts["launches"] - c[2],
            dev.pt_add.counts["launches"] - c[3]) == (16, 4, 4, 0)


# ---------------------------------------------------------------------------
# Kernel F (csrc/field_inv.cu): pow_fixed and batch_inverse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", ["fr", "fp"])
@pytest.mark.parametrize("n", [1, 7, 1000, 16897, (1 << 16) + 3, 1 << 20])
def test_batch_inverse_kernel_matches_plain(gen, field, n):
    """Kernel F's batch inversion (the divstep inverse a chunk): words
    equal to the plain version's (the same chunks) and, on a sample, to
    Python's pow; one launch a call; chunks of 1 to 32 entries, n no
    multiple of the chunk, zeros to zeros."""
    from zolt_tpu_torch.field import inverse, limb

    f = limb.FR_C if field == "fr" else limb.FP_C
    p = f.params.p
    a = field_words(torch, gen, n)
    before = inverse.batch_inverse.counts["launches"]
    got = limb.batch_inverse(a, f)
    assert inverse.batch_inverse.counts["launches"] == before + 1
    assert torch.equal(got, inverse.batch_inverse_plain(a, f))
    k = min(n, 64)
    assert limb.words_to_ints(limb.from_mont(got[:k], f)) == [
        pow(v, p - 2, p) for v in limb.decode(a[:k], f)]


@pytest.mark.parametrize("field", ["fr", "fp"])
@pytest.mark.parametrize("n", [(1 << 16) - 1, (1 << 16) + 3])
def test_batch_inverse_kernel_at_max_chunk(gen, monkeypatch, field, n):
    """Chunks of MAX_CHUNK entries (n of 2.1M and more at the shipped
    TARGET_THREADS; here 1024 threads a launch): words equal to the plain
    version's and, on a sample, to Python's pow; a tenth of the entries
    zero."""
    from zolt_tpu_torch.field import inverse, limb

    monkeypatch.setattr(inverse, "TARGET_THREADS", 1024)
    assert inverse.chunk_of(n) == inverse.MAX_CHUNK
    f = limb.FR_C if field == "fr" else limb.FP_C
    p = f.params.p
    a = field_words(torch, gen, n)
    a[::10] = 0
    got = limb.batch_inverse(a, f)
    assert torch.equal(got, inverse.batch_inverse_plain(a, f))
    assert not got[::10].any()
    assert limb.words_to_ints(limb.from_mont(got[1:65], f)) == [
        pow(v, p - 2, p) for v in limb.decode(a[1:65], f)]


def test_batch_inverse_kernel_takes_batches_and_views(gen, monkeypatch):
    """(n, m, 8) batches, strided views, an all-zero batch, and chunks of
    zeros beside chunks of values (an all-zero chunk's running product is
    one, which the divstep inverse takes to one)."""
    from zolt_tpu_torch.field import inverse, limb

    a = field_words(torch, gen, 3 * 1000)
    want = inverse.batch_inverse_plain(a, limb.FR_C)
    got = limb.batch_inverse(a.view(1000, 3, 8))
    assert got.shape == (1000, 3, 8)
    assert torch.equal(got.reshape(-1, 8), want)
    assert torch.equal(limb.batch_inverse(a[::2]), want[::2])
    # an all-zero batch, and every chunk all zero
    z = torch.zeros((40000, 8), dtype=torch.int32, device="cuda")
    assert not limb.batch_inverse(z).any()
    # 4096 chunks of 16 strided entries: chunks 0-99 all zero
    monkeypatch.setattr(inverse, "TARGET_THREADS", 4096)
    w = field_words(torch, gen, 1 << 16)
    w.view(16, 4096, 8)[:, :100] = 0
    got = limb.batch_inverse(w)
    assert torch.equal(got, inverse.batch_inverse_plain(w, limb.FR_C))
    assert not got.view(16, 4096, 8)[:, :100].any()


@pytest.mark.parametrize("field", ["fr", "fp"])
@pytest.mark.parametrize("e", [0, 1, 2, 0b1011001, (1 << 100) + 12345, None])
def test_pow_fixed_kernel_matches_plain(gen, field, e):
    """Kernel F's pow_fixed: words equal to the plain version's and, on a
    sample, to Python's pow; e = 0 (no bits: the array is never read)
    gives one; None is p - 2, `inverse`."""
    from zolt_tpu_torch.field import inverse, limb

    f = limb.FR_C if field == "fr" else limb.FP_C
    p = f.params.p
    a = field_words(torch, gen, 4099)
    bits = (f.p_minus_2_bits if e is None else
            tuple((e >> i) & 1 for i in range(e.bit_length())))
    before = inverse.pow_fixed.counts["launches"]
    got = limb.mont_pow_fixed(a, bits, f)
    assert inverse.pow_fixed.counts["launches"] == before + 1
    assert torch.equal(got, inverse.pow_fixed_plain(a, bits, f))
    exp = p - 2 if e is None else e
    assert limb.decode(got[:64], f) == [pow(v, exp, p)
                                        for v in limb.decode(a[:64], f)]
    if e is None:
        assert torch.equal(limb.inverse(a, f), got)
