"""The port's kernel modules against the JAX package's TPU kernels.

Each of the four CUDA kernels (zolt_tpu_torch/csrc) has a plain torch
version beside its wrapper (field/fold.py, field/evals.py, field/gruen.py).
Here, on the CPU, the wrappers run those plain versions, and the same
numpy-seeded tables go through the JAX function the kernel replaces: the
Pallas kernels run in interpret mode (as tests/test_pallas_redc.py runs
them), and the host C tier (FrVec) besides. The XLA forms the engines run
(stage_engine._evals_fixed, device_outer._eval_fixed) are held to the plain
kernels in tests/test_torch_engine.py, beside the JAX engines that compile
the same programs. Tolerance: exact (byte-equal words); all of this is
integer field arithmetic. The kernels themselves are held to these plain
versions on the GPU by tests/test_torch_cuda.py and chip_smoke.py.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zolt_tpu.field import mxu
from zolt_tpu.field import pallas_redc as pr
from zolt_tpu.field.limb import FR_C as JFR_C
from zolt_tpu.parallel import stage_engine as jse
from zolt_tpu_torch.field import evals, fold, gruen, limb
from zolt_tpu_torch.field.params import FR
from zolt_tpu_torch.native.frvec import FrVec

# The tensors here are tiny: torch's worker threads would only spin, and
# they doubled the CPU seconds of the port's tests.
torch.set_num_threads(1)

P = FR.p


def _ints(seed: int, n: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % P for _ in range(n)]


def _tables(seed: int, k: int, n: int, live: int) -> torch.Tensor:
    """(k, n, 8) Montgomery words of seeded values, zero behind `live`."""
    rows = []
    for j in range(k):
        xs = _ints(seed + j, live) + [0] * (n - live)
        rows.append(limb.encode(xs))
    return torch.stack(rows)


def _jax(t: torch.Tensor):
    return jnp.asarray(limb.to_jax_limbs(t))


@pytest.fixture
def interpret(monkeypatch):
    """Run pallas_redc's kernels under the Pallas interpreter (CPU)."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interp_call(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    monkeypatch.setattr(pr.pl, "pallas_call", interp_call)


# -- kernel 1: fold ----------------------------------------------------------

def _pallas_fold(entry: str, tabs: torch.Tensor, r: int, live_pairs: int):
    """zolt_tpu's fold entry point on the same words, as (k, n, 8) words."""
    k, n = tabs.shape[0], tabs.shape[1]
    tp = jnp.asarray(pr.fold_toeplitz(FR.mont(r)).T.copy())
    if entry == "fold_tail":
        ref = [np.asarray(pr.fold_tail(_jax(tabs[j]), tp, live_pairs, JFR_C))
               for j in range(k)]
        return limb.from_jax_limbs(np.stack(ref))
    if entry == "fold_tail_stack":
        return limb.from_jax_limbs(np.asarray(
            pr.fold_tail_stack(_jax(tabs), tp, live_pairs, JFR_C)))
    # the packed-row engine fold: (k, n/8, 128) rows hold the same byte
    # stream as (k, n, 16) limbs, so a reshape compares the two
    rows = _jax(tabs).reshape(k, n // 8, 128)
    ref = np.asarray(pr.fold_rows_stack(rows, tp, live_pairs, JFR_C))
    return limb.from_jax_limbs(ref.reshape(k, n, 16))


@pytest.mark.parametrize("entry,k,seed,r", [
    ("fold_tail", 1, 11, 0xBEEF1234 % P),
    ("fold_tail_stack", 3, 12, 424242),
    ("fold_rows_stack", 2, 15, 55555),
])
def test_fold_matches_pallas_fold(interpret, entry, k, seed, r):
    """Kernel 1 against each Pallas fold that keeps the table's size: the
    port's output is the new live prefix, the TPU's the same prefix with
    a zero tail, round after round (the port folds its own output)."""
    n = 64
    tabs = _tables(seed, k, n, n)
    full = tabs
    for live_pairs in (32, 16):
        got = fold.fold(tabs, r, live_pairs)
        ref = _pallas_fold(entry, full, r, live_pairs)
        assert got.shape == (k, live_pairs, 8)
        assert torch.equal(got, ref[:, :live_pairs])
        assert not ref[:, live_pairs:].any()
        tabs, full = got, ref


def test_fold_matches_fold_shared_xla_form():
    """The superseded whole-table fold, pallas_redc.fold_shared, is kernel 1
    with every pair live. Its kernel's bf16 x bf16 -> f32 dot does not run
    on XLA:CPU even in interpret mode, so kernel 1 is held to the XLA form
    fold_shared is specified bit-identical to, mxu.fold_shared."""
    n, r = 64, 0xC0FFEE
    tab = _tables(16, 1, n, n)
    ref = mxu.fold_shared(_jax(tab[0]),
                          jnp.asarray(mxu.scalar_toeplitz(FR.mont(r))), JFR_C)
    got = fold.fold(tab, r, n // 2)
    assert torch.equal(got[0, : n // 2],
                       limb.from_jax_limbs(np.asarray(ref)))


def test_fold_matches_frvec_fold_adj_down_to_one_pair():
    n, r = 32, 987654321
    tabs = _tables(13, 2, n, n)
    host = [limb.words_to_frvec(tabs[j]) for j in range(2)]
    live = n
    while live > 1:
        tabs = fold.fold(tabs, r, live // 2)
        host = [v.fold_adj(r) for v in host]
        live //= 2
        assert tabs.shape == (2, live, 8)
        for j in range(2):
            assert torch.equal(tabs[j], limb.frvec_to_words(host[j]))


def test_fold_many_plain_matches_frvec_per_table():
    """Mixed groups, each with its own k, n, live prefix and challenge, in
    one grouped call (one launch on a GPU), table by table against
    FrVec.fold_adj."""
    specs = [(3, 16, 8), (2, 64, 5), (1, 8, 0), (5, 32, 16), (2, 2, 1)]
    groups = [(_tables(300 + i, k, n, n), 1000 + 77 * i, live)
              for i, (k, n, live) in enumerate(specs)]
    got = fold.fold_many(groups)
    assert [g.shape for g in got] == [(k, live, 8) for k, _, live in specs]
    for out, (tabs, r, live) in zip(got, groups):
        for j in range(tabs.shape[0]):
            host = limb.words_to_frvec(tabs[j, : 2 * live]).fold_adj(r)
            want = limb.frvec_to_words(host) if live else out[j]
            assert torch.equal(out[j], want)
    assert [torch.equal(a, b) for a, b in
            zip(got, fold.fold_many_plain(groups))] == [True] * len(specs)


def test_fold_many_hands_each_output_to_done_in_order():
    """fold_many's `done(i, out)` sees every group's output once, in group
    order, and they are the outputs it returns."""
    specs = [(2, 16, 8), (1, 8, 3), (3, 4, 0)]
    groups = [(_tables(400 + i, k, n, n), 5 + i, live)
              for i, (k, n, live) in enumerate(specs)]
    seen = []
    got = fold.fold_many(groups, lambda i, out: seen.append((i, out)))
    assert [i for i, _ in seen] == [0, 1, 2]
    assert all(out is g for (_, out), g in zip(seen, got))
    assert fold.fold_many([], lambda i, out: seen.append(i)) == []
    assert len(seen) == 3


def test_fold_checks_its_inputs():
    tabs = _tables(14, 2, 8, 8)
    with pytest.raises(ValueError):
        fold.fold(tabs, 5, 5)                       # live past n/2
    odd = tabs[:, :7].contiguous()                  # an odd n
    with pytest.raises(ValueError, match="out of range"):
        fold.fold(odd, 5, 4)                        # 2·live past n
    got = fold.fold(odd, 5, 3)                      # 2·live <= n: folds
    for j in range(2):
        host = limb.words_to_frvec(odd[j, :6]).fold_adj(5)
        assert torch.equal(got[j], limb.frvec_to_words(host))
    with pytest.raises(ValueError):
        fold.fold(tabs.transpose(0, 1), 5, 1)       # not (k, n, 8) contiguous
    with pytest.raises(ValueError, match="no kernel"):
        fold.fold(torch.empty((2, 8, 8), dtype=torch.int32, device="meta"),
                  5, 4)                              # no CPU fallback


# -- kernels 2-3: product evals ---------------------------------------------

@pytest.mark.parametrize("degree", [2, 3])
def test_evals_k2_matches_pallas_eval_rows_k2(interpret, degree):
    n, live = 2048, 1200                             # smallest legal rows: 256
    tabs = _tables(21, 2, n, live)
    got, = evals.product_evals([(tabs, n // 2, degree)])
    rows = [_jax(tabs[j]).reshape(n // 8, 128) for j in range(2)]
    flat = np.asarray(pr.eval_rows_k2(*rows)).reshape(-1)
    ref = pr.decode_eval_rows_k2(flat, degree, P, jse._R_INV2)
    assert limb.decode(got) == ref
    host = [limb.words_to_frvec(tabs[j, :live]) for j in range(2)]
    assert ref == FrVec.prod_evals_adj(host, degree)


@pytest.mark.parametrize("degree", [2, 3])
def test_evals_k3_matches_pallas_eval_rows_k3(interpret, degree):
    n, live = 64, 40                                 # smallest legal rows: 8
    tabs = _tables(31, 3, n, live)
    got, = evals.product_evals([(tabs, n // 2, degree)])
    rows = [_jax(tabs[j]).reshape(n // 8, 128) for j in range(3)]
    flat = np.asarray(pr.eval_rows_k3(*rows)).reshape(-1)
    ref = pr.decode_eval_rows_k3(flat, degree, P, jse._R_INV3)
    assert limb.decode(got) == ref


@pytest.mark.parametrize("k,degree", [(2, 2), (2, 3), (3, 3)])
def test_evals_match_frvec_down_to_one_pair(k, degree):
    n = 64
    live = n
    while live >= 2:
        tabs = _tables(41 + live, k, n, live)
        got, = evals.product_evals([(tabs, live // 2, degree)])
        host = [limb.words_to_frvec(tabs[j, :live]) for j in range(k)]
        assert limb.decode(got) == FrVec.prod_evals_adj(host, degree)
        live //= 2


MIXED_GROUPS = [        # (k, n, live_pairs, degree): one grouped call
    (2, 64, 32, 2), (3, 64, 32, 3), (2, 32, 5, 3), (3, 16, 1, 0),
    (2, 8, 0, 1), (3, 128, 37, 2), (2, 16, 1, 0), (3, 32, 7, 1)]


def test_grouped_evals_match_plain_and_frvec_per_group():
    groups = [(_tables(60 + i, k, n, 2 * live), live, deg)
              for i, (k, n, live, deg) in enumerate(MIXED_GROUPS)]
    got = evals.product_evals(groups)
    assert len(got) == len(groups)
    for out, (tabs, live, deg) in zip(got, groups):
        assert out.shape == (deg + 1, 8)
        assert torch.equal(out, evals.product_evals_plain(tabs, live, deg))
        host = [limb.words_to_frvec(tabs[j, : 2 * live])
                for j in range(tabs.shape[0])]
        want = (FrVec.prod_evals_adj(host, deg) if live
                else [0] * (deg + 1))
        assert limb.decode(out) == want


# -- the kernel's point schedule, modelled in Python integers ---------------

R = 1 << 256
P_INV_R = (-pow(P, -1, R)) % R


def _wide_to_fr(acc: int) -> int:
    """csrc/field_ptx.cuh wide_term, summed: a 17-word sum lo + mid·2^256 +
    hi·2^512 as three Montgomery products, lo·1, mid·(R mod p) and
    hi·(R^2 mod p), each exact for a first operand below 2^256."""
    assert 0 <= acc < 1 << (17 * 32)
    lo, mid, hi = acc % R, (acc >> 256) % R, acc >> 512

    def mont(a: int, b: int) -> int:           # CIOS: (a·b + M·p) / R < 2p
        t = a * b
        t = (t + (t * P_INV_R % R) * P) // R
        assert t < 2 * P
        return t - P if t >= P else t

    return (mont(lo, 1) + mont(mid, R % P) + mont(hi, R * R % P)) % P


def _schedule_model(tabs: torch.Tensor, live: int, degree: int) -> list[int]:
    """What each thread of csrc/product_evals.cu computes, on Montgomery
    residues: K = 2 sums points 0..min(degree, 2) and extrapolates p(3);
    K = 3 forms u_0..u_2 by reduced products and u_3 = u_0 + 3(u_2 − u_1),
    then sums u_t·z_t. The last product of each point is not reduced: the
    raw sum is reduced once (_wide_to_fr)."""
    k = tabs.shape[0]
    cols = [limb.words_to_ints(tabs[j, : 2 * live]) for j in range(k)]
    k2 = k == 2
    npts = min(degree, 2) + 1 if k2 else degree + 1
    acc = [0] * npts
    rinv = pow(R, -1, P)
    for i in range(live):
        pts = []
        for c in cols:
            a, b = c[2 * i], c[2 * i + 1]
            pts.append([(a + t * (b - a)) % P for t in range(4)])
        if k2:
            lazy, last = pts[0], pts[1]
        else:
            u = [pts[0][t] * pts[1][t] * rinv % P for t in range(3)]
            u.append((u[0] + 3 * (u[2] - u[1])) % P)
            lazy, last = u, pts[2]
        for t in range(npts):
            acc[t] += lazy[t] * last[t]               # raw, < p^2
    out = [_wide_to_fr(a) for a in acc]
    if k2 and degree == 3:
        out.append((out[0] + 3 * (out[2] - out[1])) % P)
    return out


@pytest.mark.parametrize("k,n,live,degree", MIXED_GROUPS[:4])
def test_kernel_point_schedule_matches_plain(k, n, live, degree):
    tabs = _tables(70 + k + degree, k, n, 2 * live)
    plain = evals.product_evals_plain(tabs, live, degree)
    assert _schedule_model(tabs, live, degree) == limb.words_to_ints(plain)


def test_wide_reduction_holds_at_its_word_bound():
    """The largest 17-word sum, and 2^36 − 1 products of p − 1 by p − 1."""
    for acc in ((1 << (17 * 32)) - 1, ((1 << 36) - 1) * (P - 1) ** 2):
        assert _wide_to_fr(acc) == acc * pow(R, -1, P) % P


@pytest.mark.parametrize("name,value", [("r_mod_p", R % P),
                                        ("r2_mod_p", R * R % P),
                                        ("rinv_mod_p", pow(R, -1, P))])
def test_field_ptx_constants(name, value):
    """field_ptx.cuh's R mod p and R^2 mod p words, read from the source."""
    import re
    from pathlib import Path

    src = (Path(evals.__file__).parents[1] / "csrc" /
           "field_ptx.cuh").read_text()
    body = src[src.index(f"Fr {name}()"):]
    body = body[: body.index("return r;")]
    words = [int(w, 16) for w in re.findall(r"= (0x[0-9a-f]+)u;", body)]
    assert len(words) == 8
    assert sum(w << (32 * i) for i, w in enumerate(words)) == value


def test_evals_wrapper_checks_k_and_degree():
    """Any k >= 1 and degree >= 0 is taken (kernels 2-3 or G on a card,
    the plain version here); k = 0, a negative degree, a live count out of
    range and a tensor with no kernel raise."""
    tabs = _tables(51, 3, 8, 8)
    groups = [(tabs, 4, 4), (_tables(52, 4, 8, 8), 4, 2), (tabs[:1], 4, 2)]
    got = evals.product_evals(groups)
    assert [tuple(g.shape) for g in got] == [(5, 8), (3, 8), (3, 8)]
    for g, out in zip(groups, got):
        assert torch.equal(out, evals.product_evals_plain(*g))
    with pytest.raises(ValueError, match="k >= 1"):
        evals.product_evals([(tabs[:0], 4, 2)])
    with pytest.raises(ValueError, match="degree -1"):
        evals.product_evals([(tabs, 4, -1)])
    with pytest.raises(ValueError, match="out of range"):
        evals.product_evals([(tabs, 5, 2)])
    with pytest.raises(ValueError, match="no kernel"):
        evals.product_evals([(tabs.to("meta"), 4, 2)])   # no CPU fallback
    assert limb.decode(evals.product_evals([(tabs, 0, 3)])[0]) == [0] * 4
    assert evals.product_evals([]) == []


# -- kernel 4: Gruen eq-weighted round ----------------------------------------

def _gruen_case(seed: int, n: int, live: int, levels_out: int = 4,
                levels_in: int = 3):
    """az/bz with `live` live pairs and flat E_out/E_in stacks of 4 and 3
    levels (by default the stacks of a 6-variable split eq); the round's
    level offsets put the low bits of the pair index on E_in."""
    ab = _tables(seed, 2, n, 2 * live)
    e_out = limb.encode(_ints(seed + 7, (1 << levels_out) - 1))
    e_in = limb.encode(_ints(seed + 8, (1 << levels_in) - 1))
    lg = live.bit_length() - 1
    h_in = min(levels_in - 1, lg)
    lvl_out = lg - h_in
    return ab, e_out, e_in, (1 << lvl_out) - 1, (1 << h_in) - 1, h_in, lvl_out


def test_gruen_matches_frvec_gruen_quad():
    """Kernel 4 against the host C tier's eq-weighted round. (Its JAX
    forms: device_outer._eval_fixed is held to it in
    tests/test_torch_engine.py; pallas_kernels.product_round does not finish
    under the Pallas interpreter on the CPU within 40 minutes, since it
    walks the unrolled kernel op by op, which is why tests/test_frvec.py
    gates its own product_round test. Its fold half is kernel 1, held to
    the fold kernels above.)"""
    n = 64
    for live in (32, 8, 1):
        ab, e_out, e_in, off_out, off_in, h_in, lvl_out = _gruen_case(
            61 + live, n, live)
        got = gruen.gruen_eval(ab[0], ab[1], e_out, e_in, off_out, off_in,
                               h_in, live)
        host = FrVec.gruen_quad(
            limb.words_to_frvec(e_out[off_out: off_out + (1 << lvl_out)]),
            limb.words_to_frvec(e_in[off_in: off_in + (1 << h_in)]), h_in,
            limb.words_to_frvec(ab[0, : 2 * live]),
            limb.words_to_frvec(ab[1, : 2 * live]), live)
        assert tuple(limb.decode(got)) == tuple(host)


def test_gruen_checks_its_inputs():
    ab, e_out, e_in, off_out, off_in, h_in, _ = _gruen_case(81, 16, 8)
    with pytest.raises(ValueError, match="offsets"):
        gruen.gruen_eval(ab[0], ab[1], e_out, e_in, e_out.shape[0],
                         off_in, h_in, 8)
    with pytest.raises(ValueError, match="offsets"):
        gruen.gruen_eval(ab[0], ab[1], e_out, e_in, off_out, e_in.shape[0],
                         h_in, 8)
    with pytest.raises(ValueError):
        gruen.gruen_eval(ab[0], ab[1][:8], e_out, e_in, off_out, off_in,
                         h_in, 4)
    with pytest.raises(ValueError, match="neither"):
        gruen.gruen_round(ab, None, e_out, e_in, off_out, off_in, h_in, 8,
                          eval=False)
    with pytest.raises(ValueError, match="out of range"):
        gruen.gruen_round(ab, 5, e_out, e_in, off_out, off_in, h_in, 9)
    with pytest.raises(ValueError, match="no kernel"):
        gruen.gruen_round(ab.to("meta"), 5, None, None, 0, 0, 0, 8,
                          eval=False)                 # no CPU fallback


def _mont(a: int, b: int) -> int:
    """CIOS a·b·R^{-1} for a first operand below 2^256 and b < p."""
    assert 0 <= a < R and 0 <= b < P
    t = a * b
    t = (t + (t * P_INV_R % R) * P) // R
    assert t < 2 * P
    return t - P if t >= P else t


def _gruen_kernel_model(ab, e_out, e_in, off_out: int, off_in: int,
                        h_in: int, pairs: int, lanes: int, steps: int):
    """What csrc/gruen_round.cu computes in an eval, on Python ints and
    Montgomery residues: block b, slot s takes the pairs b·chunk + s +
    PB·j. Each pair's two reduced products times its inner eq factor add
    into a 544-bit sum; the outer factor weights a thread's sum (E_in,
    0 < h_in and 2^h_in < chunk) or a block's (E_out when the block lies in
    one row, else E_in with h_in = 0) once, into 832-bit sums that the
    finishing block reduces by R^{-2} in four Montgomery products."""
    a = limb.words_to_ints(ab[0, : 2 * pairs])
    b = limb.words_to_ints(ab[1, : 2 * pairs])
    eo, ei = limb.words_to_ints(e_out), limb.words_to_ints(e_in)
    pb = 128 // lanes
    chunk = pb * steps
    mask = (1 << h_in) - 1
    by_row = chunk <= mask + 1
    per_thread = not by_row and h_in != 0
    assert by_row or mask + 1 <= pb              # the kernel refuses the rest
    total = [0, 0]
    for blk in range(max(1, -(-pairs // chunk))):
        block_sum = [0, 0]
        for slot in range(pb):
            acc = [0, 0]
            for j in range(steps):
                q = blk * chunk + slot + pb * j
                if q >= pairs:
                    continue
                inner = (ei[off_in + (q & mask)] if by_row
                         else eo[off_out + (q >> h_in)])
                a0, a1, b0, b1 = a[2 * q], a[2 * q + 1], b[2 * q], b[2 * q + 1]
                acc[0] += inner * _mont(a0, b0)
                acc[1] += inner * _mont((a1 - a0) % P, (b1 - b0) % P)
            assert max(acc) < 1 << 544
            if per_thread:
                outer = ei[off_in + (slot & mask)] if (slot & mask) < pairs \
                    else 0
                total = [t + x * outer for t, x in zip(total, acc)]
            else:
                block_sum = [t + x for t, x in zip(block_sum, acc)]
        if not per_thread:
            first = blk * chunk
            outer = 0 if first >= pairs else (
                eo[off_out + (first >> h_in)] if by_row else ei[off_in])
            assert max(block_sum) < 1 << 544
            total = [t + x * outer for t, x in zip(total, block_sum)]
    consts = (pow(R, -1, P), 1, R % P, R * R % P)
    out = []
    for x in total:
        assert x < 1 << (26 * 32)
        out.append(sum(_mont((x >> (256 * c)) % R, consts[c])
                       for c in range(4)) % P)
    return out


# (pairs, h_in, lanes, steps): each of the kernel's three ways to weight
# by the eq factors, both schedules, several pairs a thread, a partial row
GRUEN_SCHEDULES = [
    (256, 8, 1, 2),      # E_out outer, the block's pairs in one row
    (200, 7, 2, 2),      # the same, two threads a pair, a ragged end
    (300, 0, 1, 1),      # h_in = 0: E_in's one entry outer, once a block
    (130, 0, 2, 4),
    (96, 3, 1, 1),       # E_in outer, once a thread
    (512, 5, 2, 2),
    (5, 6, 1, 1),        # fewer pairs than a row
]


@pytest.mark.parametrize("pairs,h_in,lanes,steps", GRUEN_SCHEDULES)
def test_gruen_kernel_schedule_matches_plain(pairs, h_in, lanes, steps):
    n_out = -(-pairs // (1 << h_in))
    ab = _tables(400 + pairs, 2, 2 * pairs, 2 * pairs)
    e_out = limb.encode(_ints(401 + pairs, 3 + n_out))
    e_in = limb.encode(_ints(402 + pairs, 2 + (1 << h_in)))
    args = (ab, e_out, e_in, 3, 2, h_in, pairs)
    plain = gruen.gruen_eval_plain(ab[0], ab[1], *args[1:])
    assert _gruen_kernel_model(*args, lanes, steps) == \
        limb.words_to_ints(plain)


def test_gruen_schedule_stays_in_the_kernels_regimes():
    """Every (lanes, steps) the wrapper picks over the path's pair counts
    and levels is one the kernel takes: a block inside one E_out row, or
    2^h_in dividing a block step. The grid stays within 1024 blocks unless
    a block already spans a whole row."""
    for lg, h_in, folds in itertools.product(range(21), range(10),
                                             (False, True)):
        if h_in <= lg:
            lanes, steps = gruen.schedule(1 << lg, h_in, folds)
            chunk = 128 // lanes * steps
            assert lanes == (2 if folds or 1 << lg <= gruen.SPLIT_MAX_PAIRS
                             else 1)
            assert chunk <= 1 << h_in or 1 << h_in <= 128 // lanes
            assert -(-(1 << lg) // chunk) <= 1024 or chunk == 1 << h_in


@pytest.mark.parametrize("mode", ["eval", "fused", "fold"])
def test_gruen_round_plain_modes_match_fold_then_eval(mode):
    """gruen_round on CPU tensors is fold_plain, then gruen_eval_plain, in
    each mode, against FrVec.fold_adj and FrVec.gruen_quad."""
    n, live = 64, 32
    ab, e_out, e_in, off_out, off_in, h_in, lvl_out = _gruen_case(
        95, n, live // 2)
    r = None if mode == "eval" else 0xABCDEF
    pairs = live // 2 if mode == "fused" else live
    if mode == "eval":
        ab, e_out, e_in, off_out, off_in, h_in, lvl_out = _gruen_case(
            95, n, live)
    tabs, ev = gruen.gruen_round(ab, r, e_out, e_in, off_out, off_in, h_in,
                                 live, eval=mode != "fold")
    host = [limb.words_to_frvec(ab[j, : 2 * live]) for j in (0, 1)]
    if r is not None:
        host = [v.fold_adj(r) for v in host]
        assert tabs.shape == (2, live, 8)
        for j in (0, 1):
            assert torch.equal(tabs[j], limb.frvec_to_words(host[j]))
    else:
        assert tabs is ab
    if mode == "fold":
        assert ev is None
        return
    want = FrVec.gruen_quad(
        limb.words_to_frvec(e_out[off_out: off_out + (1 << lvl_out)]),
        limb.words_to_frvec(e_in[off_in: off_in + (1 << h_in)]), h_in,
        host[0], host[1], pairs)
    assert tuple(limb.decode(ev)) == tuple(want)


def test_cpu_calls_launch_no_kernel():
    counts = (dict(fold.fold_many.counts), dict(evals.product_evals.counts),
              dict(gruen.gruen_round.counts))
    tabs = _tables(91, 3, 8, 8)
    fold.fold(tabs, 3, 4)
    fold.fold_many([(tabs, 3, 4), (tabs[:1].contiguous(), 5, 2)])
    evals.product_evals([(tabs[:2].contiguous(), 4, 2), (tabs, 4, 3)])
    ab, e_out, e_in, off_out, off_in, h_in, _ = _gruen_case(92, 16, 8)
    gruen.gruen_eval(ab[0], ab[1], e_out, e_in, off_out, off_in, h_in, 8)
    gruen.gruen_round(ab, 7, e_out, e_in, 0, 0, 0, 8)
    gruen.gruen_round(ab, 7, None, None, 0, 0, 0, 8, eval=False)
    assert counts == (fold.fold_many.counts, evals.product_evals.counts,
                      gruen.gruen_round.counts)
