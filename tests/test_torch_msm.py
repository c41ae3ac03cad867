"""The port's G1 commitments slice on the CPU: the point formulas, the
row-MSM subset-sum tier, the Pippenger MSM and its router, the device row
tier of the commitment phase, and HyperKZG, against the JAX package.

Inputs come from numpy seeds and `curve.host.random_points`. Tolerances:
the point formulas must give JAX's Jacobian words (zolt_tpu.curve.device,
run op by op, so only its inner pt_double compiles); every sum of points
is held in affine form to zolt_tpu's host tiers (a sum's Jacobian words
depend on its order, its point does not); commitments, proofs and
transcript states must be byte-equal.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zolt_tpu_torch
from test_torch_slice import GUESTS
from zolt_tpu import native as jax_native
from zolt_tpu import vm as jax_vm
from zolt_tpu.curve import device as jax_dev
from zolt_tpu.msm import pippenger as jax_pippenger
from zolt_tpu.pcs import hyperkzg as jax_kzg
from zolt_tpu.pcs import mock as jax_mock
from zolt_tpu.pcs import srs as jax_srs
from zolt_tpu.transcript import Blake2bTranscript as JaxTranscript
from zolt_tpu.zkvm import bytecode_tables as jax_bct
from zolt_tpu.zkvm import commitments as jax_commitments
from zolt_tpu_torch import native, vm
from zolt_tpu_torch.curve import device as dev
from zolt_tpu_torch.curve import host
from zolt_tpu_torch.field import limb
from zolt_tpu_torch.field.params import FP, FR
from zolt_tpu_torch.msm import pippenger, rows_device
from zolt_tpu_torch.pcs import dory, hyperkzg, mock, srs
from zolt_tpu_torch.transcript import Blake2bTranscript
from zolt_tpu_torch.zkvm import bytecode_tables, commitments

torch.set_num_threads(1)

FP_C = limb.FP_C
PP = FP.p


def _jac(points, lams):
    """Host affine points (None = identity) as Jacobian Montgomery words
    with Z = λ: (x·λ², y·λ³, λ); the identity is (0, 1, 0)."""
    xs, ys, zs = [], [], []
    for pt, lam in zip(points, lams):
        if pt is None:
            xs.append(0), ys.append(1), zs.append(0)
        else:
            xs.append(pt[0] * lam * lam % PP)
            ys.append(pt[1] * pow(lam, 3, PP) % PP)
            zs.append(lam)
    return tuple(limb.encode(v, FP_C) for v in (xs, ys, zs))


def _edge_pairs(rng, n_generic: int = 40):
    """Point pairs covering identity+P, P+identity, identity+identity, P+P
    (same and different Z), P+(−P) (same and different Z) and generic pairs,
    each side with its own random Z."""
    pts = host.random_points(24, seed=int(rng.integers(1 << 30)))
    a, b = [], []
    for i in range(4):
        a += [None, pts[i], None, pts[i], pts[i], pts[i], host.neg(pts[i])]
        b += [pts[i], None, None, pts[i], pts[i], host.neg(pts[i]), pts[i]]
    for _ in range(n_generic):
        i, j = rng.integers(0, len(pts), 2)
        a.append(pts[i])
        b.append(pts[j])
    lam = lambda: int(rng.integers(1, 1 << 62)) * int(rng.integers(1, 1 << 62)) % PP
    la = [lam() for _ in a]
    lb = [la[k] if k % 7 == 4 else lam() for k in range(len(b))]
    return _jac(a, la), _jac(b, lb)


def _to_jax(pt):
    return tuple(jnp.asarray(limb.to_jax_limbs(c)) for c in pt)


def _from_jax(pt):
    return tuple(limb.from_jax_limbs(np.asarray(c)) for c in pt)


def test_kernel_moduli_match_the_field_params():
    """csrc/field.cuh's words, −p⁻¹ mod 2^32 and Fp's R mod p, against
    field/params.py."""
    src = open(os.path.join(os.path.dirname(zolt_tpu_torch.__file__), "csrc",
                            "field.cuh")).read()
    for name, fp in (("FrMod", FR), ("FpMod", FP)):
        body = src[src.index(f"struct {name}"):]
        body = body[:body.index("};")]
        words = [int(w, 16) for w in re.findall(r"return (0x[0-9a-f]+)u;", body)]
        inv = int(re.search(r"INV = (0x[0-9a-f]+)u", body).group(1), 16)
        assert sum(w << (32 * i) for i, w in enumerate(words[:8])) == fp.p
        assert inv == (-pow(fp.p, -1, 1 << 32)) % (1 << 32) == fp.inv64 % (1 << 32)
        assert inv * fp.p % (1 << 32) == (1 << 32) - 1
        if name == "FpMod":
            assert sum(w << (32 * i) for i, w in enumerate(words[8:16])) == fp.r
    assert FP.inv64 % (1 << 32) == 0xE4866389


def test_every_kernel_entry_point_has_a_ctypes_signature():
    """Each extern "C" entry point of csrc/*.cu gets argtypes of its own
    length and an int restype in _build.py (without them ctypes passes a
    pointer as a C int)."""
    from zolt_tpu_torch import _build

    bind = open(_build.__file__).read()
    for name in _build.KERNEL_SOURCES:
        src = open(os.path.join(_build.CSRC, name)).read()
        for fn, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
            types = re.search(rf"lib\.{fn}\.argtypes = (.+)", bind)
            assert types, fn
            n = len(eval(types.group(1), {"P": 0, "I": 0, "L": 0}))
            assert n == len(params.split(",")), fn
            assert f"lib.{fn}.restype = I" in bind, fn


def test_point_formulas_give_jax_words():
    """pt_add and pt_double (the plain versions kernel A is held to) give
    zolt_tpu.curve.device's Jacobian words on 68 pairs with every edge
    case."""
    pa, pb = _edge_pairs(np.random.default_rng(11))
    assert pa[0].shape[0] >= 64
    want_add = _from_jax(jax_dev.pt_add.__wrapped__(_to_jax(pa), _to_jax(pb)))
    want_dbl = _from_jax(jax_dev.pt_double.__wrapped__(_to_jax(pa)))
    got_add, got_dbl = dev.pt_add(pa, pb), dev.pt_double(pa)
    for g, w in zip(got_add + got_dbl, want_add + want_dbl):
        assert torch.equal(g, w)
    # the affine points are the host tier's
    a_aff, b_aff = dev.to_affine_host(pa), dev.to_affine_host(pb)
    assert dev.to_affine_host(got_add) == [host.add(x, y)
                                           for x, y in zip(a_aff, b_aff)]
    assert dev.to_affine_host(got_dbl) == [host.double(x) for x in a_aff]
    assert dev.pt_is_inf(got_add)[:3].tolist() == [False, False, True]


def test_kernel_a_work_counts_each_case():
    """add_work charges what g1.cuh's jac_add computes for each pair: none
    with an identity operand, 8 + 7 for P + P, 14 for P + (−P), 16 else
    (the cases classified here on the host, in affine form)."""
    pa, pb = _edge_pairs(np.random.default_rng(12))
    prods = 0
    for a, b in zip(dev.to_affine_host(pa), dev.to_affine_host(pb)):
        if a is not None and b is not None:
            prods += 15 if a == b else 14 if a == host.neg(b) else 16
    n = pa[0].shape[0]
    assert dev.add_work(pa, pb) == (n * 288, prods * limb.MONT_IMADS)
    assert prods < 16 * n
    assert dev.double_work(n) == (n * 192, n * 7 * limb.MONT_IMADS)


def test_point_host_boundary_and_limb_helpers():
    pts = host.random_points(5, seed=3) + [None]
    jac = dev.from_affine_host(pts)
    jx = jax_dev.from_affine_host(pts)
    for g, w in zip(jac, _from_jax(jx)):
        assert torch.equal(g, w)
    assert dev.to_affine_host(jac) == pts
    inf = dev.pt_infinity((3,))
    assert inf[0].shape == (3, 8) and dev.pt_is_inf(inf).all()
    assert limb.is_zero(limb.zeros((2,))).tolist() == [True, True]
    assert limb.decode(limb.encode([5, PP - 1], FP_C), FP_C) == [5, PP - 1]


def test_kernels_raise_on_a_device_without_one():
    meta = tuple(torch.empty((4, 8), dtype=torch.int32, device="meta")
                 for _ in range(3))
    with pytest.raises(ValueError, match="no kernel"):
        dev.pt_add(meta, meta)
    with pytest.raises(ValueError, match="no kernel"):
        dev.pt_double(meta)
    vals = torch.empty((1, 2, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        rows_device.row_sums(vals, torch.empty((256, 16), dtype=torch.int32,
                                               device="meta"),
                             torch.empty(256, dtype=torch.uint8, device="meta"),
                             1)
    with pytest.raises(ValueError, match="no kernel"):
        pippenger.scalar_digits(meta[0])


@pytest.fixture(scope="module")
def dory_srs():
    return dory.setup(14)          # 128 columns


def _native_rows(g1_vec, v: np.ndarray, cols: int):
    n = max(1, -(-len(v) // cols))
    pad = np.zeros(n * cols, np.int64)
    pad[:len(v)] = v
    rows = [[int(s) for s in pad[r * cols:(r + 1) * cols]] for r in range(n)]
    return jax_native.g1_msm_rows_native(list(g1_vec[:cols]), rows)


@pytest.mark.parametrize("cols,nplanes", [(8, 1), (16, 4), (64, 1),
                                          (128, 1), (32, 4), (128, 4)])
def test_row_msm_matches_native_row_msms(dory_srs, cols, nplanes):
    """DeviceRowMSM.commit_rows (the plain kernel B) equals zolt_tpu's
    native row MSMs in affine form: full and partial matrices, a short
    poly, an all-zero poly and a one-hot poly."""
    rng = np.random.default_rng(cols * 10 + nplanes)
    hi = 1 << nplanes
    polys = [rng.integers(0, hi, size=cols * 4, dtype=np.uint8),
             rng.integers(0, hi, size=cols * 2 + 5, dtype=np.uint8),
             rng.integers(0, hi, size=3, dtype=np.uint8),
             np.zeros(cols * 3, np.uint8)]
    oh = np.zeros(cols * 4, np.uint8)
    oh[rng.choice(cols * 4, cols, replace=False)] = 1
    polys.append(oh)
    eng = rows_device.DeviceRowMSM(dory_srs.g1_vec, cols, "cpu")
    got = eng.commit_rows(polys, nplanes)
    for v, g in zip(polys, got):
        assert g == _native_rows(dory_srs.g1_vec, v, cols)
    assert got[3] == [None] * 3
    # the work kernel B would need: the non-zero subset bytes
    vals = torch.from_numpy(np.stack([np.resize(p, cols * 4) for p in polys])
                            ).view(len(polys), 4, cols)
    nz = rows_device.count_nonzero(vals, eng.valid, nplanes)
    idx = rows_device._plane_indices(vals.reshape(-1, cols), nplanes)
    assert nz == int((idx % 256 != 0).sum())
    nbytes, imads = rows_device.work(nz, 4 * len(polys), cols, nplanes)
    assert imads == (nz * 11 + 4 * len(polys) * (nplanes - 1) * 7) * 272


def test_row_msm_subset_bytes_and_lanes_per_row():
    """Kernel B's host helpers: the subset-byte indices of the plain
    version (a weighted sum of bits) and of the wrapper's count (a group's
    8 scalars read as one int64 word, as the kernel reads them) both equal
    the JAX package's (np.packbits a plane); the count skips zero bytes
    and identity table entries; lanes_per_row gives 4 lanes to rows whose
    points fill a quarter of their slots or more, 8 to sparser ones."""
    from types import SimpleNamespace

    from zolt_tpu.msm import rows_device as jax_rows

    rng = np.random.default_rng(9)
    for cols, nplanes in ((8, 1), (64, 4), (256, 8)):
        vals = rng.integers(0, 1 << nplanes, (9, cols), dtype=np.uint8)
        want = jax_rows.DeviceRowMSM._plane_indices(
            SimpleNamespace(nch=cols // 8), vals, nplanes)
        got = rows_device._plane_indices(torch.from_numpy(vals), nplanes)
        assert np.array_equal(got.numpy(), want)
        got = rows_device._subset_bytes(torch.from_numpy(vals), nplanes)
        assert np.array_equal(got.numpy(), want % 256)
    valid = torch.ones(8 * 256, dtype=torch.uint8)
    valid[256 + 3] = 0                       # an identity table entry
    vals = torch.zeros((1, 2, 64), dtype=torch.uint8)
    vals[0, 0, 8:10] = 1                     # group 1, subset 3: skipped
    vals[0, 1, :8] = 1
    assert rows_device.count_nonzero(vals, valid, 1) == 1

    lanes = rows_device.lanes_per_row
    assert lanes(0, 64, 128) == 8
    # the smoke's one-hot cubes (some 46 of 128 slots) and compat matrices
    # (four planes of 32 nearly full groups): dense
    assert lanes(1894104, 40960, 128) == lanes(1011867, 8192, 128) == 4
    assert lanes(16, 1, 64) == 4 and lanes(15, 1, 64) == 8
    # the T = 2^16 proves' launches: 13.2, 17.2 and 6.4 points a row
    assert lanes(501374, 37888, 128) == lanes(141004, 8192, 128) == 8
    assert lanes(8168, 1280, 256) == 8
    assert set(rows_device.LANES) == {4, 8}


def test_row_msm_engine_needs_the_native_tables(dory_srs, monkeypatch):
    monkeypatch.setattr(native, "g1_subset_tables_mont", lambda pts: None)
    with pytest.raises(RuntimeError, match="native C tier"):
        rows_device.DeviceRowMSM(dory_srs.g1_vec, 8, "cpu")
    with pytest.raises(ValueError):
        rows_device.DeviceRowMSM(dory_srs.g1_vec, 12, "cpu")


def test_row_msm_engine_cache(dory_srs):
    a = rows_device.get_engine(dory_srs, 16, "cpu")
    assert rows_device.get_engine(dory_srs, 16, "cpu") is a
    assert rows_device.get_engine(dory_srs, 32, "cpu") is not a


def _msm_inputs(n: int, seed: int):
    """n points with duplicates, a negation, the identity, zero and
    small scalars, the rest random."""
    rng = np.random.default_rng(seed)
    pts = host.random_points(n - 6, seed=seed)
    pts += [pts[0], pts[1], host.neg(pts[2]), None, pts[3], pts[4]]
    sc = [int.from_bytes(rng.bytes(32), "little") % FR.p for _ in pts]
    sc[1] = sc[-5]                      # P + P in every window's buckets
    sc[-4] = sc[2]                      # P + (−P)
    sc[3], sc[4], sc[5] = 0, 1, 255
    sc[-2] = 0
    sc[-1] = FR.p - 1
    return pts, sc


def _skewed_inputs(n: int, seed: int):
    """chip_smoke.skewed_inputs over 16 random points: RAM-like scalars,
    points that repeat with their negations, identities."""
    import chip_smoke

    return chip_smoke.skewed_inputs(host.random_points(16, seed=seed), n,
                                    seed)


@pytest.mark.parametrize("n,kind", [pytest.param(64, "random", id="64"),
                                    pytest.param(512, "random", id="512"),
                                    pytest.param(512, "skewed", id="skewed")])
def test_pippenger_matches_jax_oracle(n, kind, monkeypatch):
    """"skewed": kernel C's plan at CHUNK = 4 on RAM-like scalars, so the
    largest bucket (some 180 entries) takes three reduction passes, and
    P + P, P + (−P) and identities meet inside chunks and across them."""
    if kind == "skewed":
        pts, sc = _skewed_inputs(n, seed=n)
        monkeypatch.setattr(pippenger, "CHUNK", 4)
        ent, seg = pippenger.bucket_plan(pippenger.int_digits(sc, "cpu"))
        assert len(pippenger.bucket_chunks(seg)) == 4
    else:
        pts, sc = _msm_inputs(n, seed=n)
    want = jax_pippenger.msm_oracle(pts, sc)
    assert pippenger.pippenger(pts, sc, "cpu") == want
    assert pippenger.msm_oracle(pts, sc) == want


@pytest.mark.parametrize("kind,L", [("random", 2), ("random", 16),
                                    ("skewed", 4), ("skewed", 16)])
def test_bucket_chunks_tile_each_bucket(kind, L, monkeypatch):
    """Kernel C's plan: pass 0's chunks tile the entries once, none
    crosses a bucket or holds more than L; each later pass does the same
    over the previous pass's chunk sums, grouped by bucket; the last has
    one chunk a bucket, and the pass count is the fewest that bring the
    largest bucket to one point: ceil(log_L m), within ceil(log_L n)."""
    n = 512
    sc = (_skewed_inputs(n, seed=3)[1] if kind == "skewed" else
          _msm_inputs(n, seed=3)[1])
    _, seg = pippenger.bucket_plan(pippenger.int_digits(sc, "cpu"))
    monkeypatch.setattr(pippenger, "CHUNK", L)
    plan = pippenger.bucket_chunks(seg)
    nb = seg.numel() - 1
    s = seg.long()
    for k, off in enumerate(plan):
        assert off.dtype == torch.int32
        off = off.long()
        size = off[1:] - off[:-1]
        assert int(off[0]) == 0
        assert int(off[-1]) == int(s[-1]) and bool((size <= L).all())
        if k == len(plan) - 1:
            assert torch.equal(off, s)
            break
        assert bool((size >= 1).all())          # each item in one chunk
        assert bool(torch.isin(s, off).all())   # no chunk crosses a bucket
        bucket = torch.searchsorted(s, off[:-1], right=True) - 1
        s = torch.zeros(nb + 1, dtype=torch.int64)
        s[1:] = torch.cumsum(torch.bincount(bucket, minlength=nb), 0)
    top = int((seg[1:] - seg[:-1]).max())
    passes = len(plan)
    assert top <= L ** passes and (passes == 1 or top > L ** (passes - 1))
    assert passes <= int(np.ceil(np.log(n) / np.log(L)))
    if kind == "skewed":
        assert top > n // 4 and passes >= 3 - (L == 16)


def test_scalar_digits_from_words_equal_jax_digits():
    """The digits from Fr Montgomery words (the plain kernel E) are JAX's
    digits of the decoded scalars, byte for byte."""
    _, sc = _msm_inputs(64, seed=6)
    words = limb.encode(sc)
    got = pippenger.scalar_digits(words)
    assert got.dtype == torch.uint8 and got.shape == (64, 32)
    assert np.array_equal(got.numpy(), jax_pippenger._digits(sc))
    assert torch.equal(got, pippenger.int_digits(sc, "cpu"))
    assert pippenger.digits_work(64) == (64 * 64, 64 * 272)
    with pytest.raises(ValueError, match="int32"):
        pippenger.scalar_digits(words.reshape(-1))


def test_pippenger_stages_against_jax_work_counts():
    """The bucket plan drops zero digits and orders the entries by bucket;
    the kernels' work counts follow from it."""
    pts, sc = _msm_inputs(64, seed=5)
    digits = pippenger.int_digits(sc, "cpu")
    assert np.array_equal(digits.numpy(), jax_pippenger._digits(sc))
    ent, seg = pippenger.bucket_plan(digits)
    assert int(seg[-1]) == ent.numel() == int((digits != 0).sum())
    d = digits.t().reshape(-1).long()
    keys = (ent.long() // 64) * 256 + d[ent.long()]
    assert bool((keys[1:] >= keys[:-1]).all())
    _, valid = pippenger.affine_table(pts)
    nbytes, imads = pippenger.bucket_work(ent, seg, valid, 64)
    assert imads % (11 * 272) == 0 and nbytes > ent.numel() * 4
    assert pippenger.window_work(32) == (32 * 256 * 96 + 32 * 96,
                                         32 * 510 * 16 * 272)


def test_msm_routes_by_size(monkeypatch):
    """With a device, the Pippenger on it at every size; with none, the
    host double-and-add below HOST_MAX points, else the native C MSM."""
    calls = []
    monkeypatch.setattr(pippenger.chost, "msm",
                        lambda p, s: calls.append("host") or "host")
    monkeypatch.setattr(native, "g1_msm_native",
                        lambda p, s: calls.append("native") or "native")
    monkeypatch.setattr(pippenger, "pippenger",
                        lambda p, s, d: calls.append(("device", d)) or "dev")
    g = host.G1_GEN
    h = pippenger.HOST_MAX
    for n, device in ((1, "cpu"), (h - 1, None), (h - 1, "cpu"), (h, None),
                      (h, "cpu"), (1 << 14, None), (1 << 14, "cpu")):
        pippenger.msm([g] * n, [3] * n, device=device)
    assert calls == [("device", "cpu"), "host", ("device", "cpu"), "native",
                     ("device", "cpu"), "native", ("device", "cpu")]
    with pytest.raises(ValueError):
        pippenger.msm([g], [1, 2])


def _commit_phase(pkg_vm, bct, mod, transcript, path, sound, **kw):
    """The commitment phase as prove_jolt runs it (zkvm/pipeline.py)."""
    emu = pkg_vm.run_elf(path, expand_virtual=sound)
    padded = pkg_vm.pad_with_noop(list(emu.trace))
    bc_index = bct.BytecodeIndex.from_elf(path) if sound else None
    phase = mod.commit_and_absorb(
        transcript, padded, len(pkg_vm.elf.load_file(path).flat_image()[1]),
        len(emu.ram.trace),
        sound=sound, log_ram_k=16,
        start_address=emu.device.layout.lowest_address(), bc_index=bc_index,
        **kw)
    return phase.commitments, (transcript.state, transcript.n_rounds)


@pytest.mark.parametrize("sound", [False, True])
def test_commit_and_absorb_on_the_row_tier_matches_jax(tmp_path, monkeypatch,
                                                       sound):
    """At T = 2^10 the sound cubes have 2^14 entries and take the row tier
    as they are; the compat chunk polys (2^10) take it once the size
    constant is lowered. Bytes and transcript state equal JAX's host tier."""
    path = str(tmp_path / "guest.elf")
    with open(path, "wb") as f:
        f.write(GUESTS["sum_loop_t10"]())
    monkeypatch.setattr(commitments, "DEVICE_COMMIT_MIN", 1 << 8)
    sizes, seen = [], []
    commit_rows = rows_device.DeviceRowMSM.commit_rows
    plain = rows_device.row_sums_plain

    def spy(self, polys, nplanes):
        sizes.extend(len(p) for p in polys)
        return commit_rows(self, polys, nplanes)

    monkeypatch.setattr(rows_device.DeviceRowMSM, "commit_rows", spy)
    monkeypatch.setattr(rows_device, "row_sums_plain",
                        lambda v, *a: seen.append(v.shape) or plain(v, *a))
    want = _commit_phase(jax_vm, jax_bct, jax_commitments,
                         JaxTranscript(b"Jolt"), path, sound)
    got = _commit_phase(vm, bytecode_tables, commitments,
                        Blake2bTranscript(b"Jolt"), path, sound, device="cpu")
    assert got == want
    # sound: every one-hot cube; compat: at least the 32 instruction chunks
    if sound:
        assert len(sizes) == len(want[0]) - 2
    assert len(sizes) >= 32 and min(sizes) >= 1 << 8
    assert sum(s[0] for s in seen) == len(sizes)
    host_tier = _commit_phase(vm, bytecode_tables, commitments,
                              Blake2bTranscript(b"Jolt"), path, sound)
    assert host_tier == want and sum(s[0] for s in seen) == len(sizes)


@pytest.fixture(scope="module")
def kzg_pair():
    n = 64
    port, ref = srs.insecure_setup(n), jax_srs.insecure_setup(n)
    assert port.powers_g1 == ref.powers_g1 and port.tau_g2 == ref.tau_g2
    return port, ref


def test_hyperkzg_matches_jax(kzg_pair):
    """commit, open_at and verify at 2^6, every MSM on the plain
    Pippenger (a CPU tensor, device "cpu"), with commitments, proofs and
    transcript states equal to JAX's (its native MSM tier); the SRS's
    table is built once."""
    port, ref = kzg_pair
    rng = np.random.default_rng(21)
    evals = [int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(64)]
    x = [int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(6)]
    words = limb.encode(evals)
    c = hyperkzg.commit(port, words)
    assert c == jax_kzg.commit(ref, limb.to_jax_limbs(words))
    assert c == hyperkzg.commit_ints(port, evals, device="cpu")
    assert c == hyperkzg.commit_ints(port, evals, device=None)
    assert pippenger.srs_table(port, "cpu") is pippenger.srs_table(port, "cpu")
    tp, tj = Blake2bTranscript(b"kzg"), JaxTranscript(b"kzg")
    proof = hyperkzg.open_at(port, evals, x, tp, device="cpu")
    jproof = jax_kzg.open_at(ref, evals, x, tj)
    assert (proof.com, proof.v, proof.w) == (jproof.com, jproof.v, jproof.w)
    assert tp.state == tj.state
    value = hyperkzg._mle_eval(evals, x)
    assert hyperkzg.verify(port, c, x, value, proof, Blake2bTranscript(b"kzg"))
    assert not hyperkzg.verify(port, c, x, value + 1, proof,
                               Blake2bTranscript(b"kzg"))
    with pytest.raises(ValueError, match="SRS of 64"):
        hyperkzg.commit(port, limb.encode(evals * 2))


def test_hyperkzg_batch_matches_jax(kzg_pair):
    port, ref = kzg_pair
    rng = np.random.default_rng(22)
    polys = [[int(v) for v in rng.integers(0, 1 << 60, 16)] for _ in range(3)]
    x = [int(v) for v in rng.integers(1, 1 << 60, 4)]
    coms = hyperkzg.batch_commit(port, polys, device=None)
    assert coms == jax_kzg.batch_commit(ref, polys)
    tp, tj = Blake2bTranscript(b"b"), JaxTranscript(b"b")
    bp = hyperkzg.batch_open(port, polys, x, tp, device=None)
    jp = jax_kzg.batch_open(ref, polys, x, tj)
    assert bp.evaluations == jp.evaluations
    assert (bp.proof.com, bp.proof.v, bp.proof.w) == (jp.proof.com, jp.proof.v,
                                                      jp.proof.w)
    assert tp.state == tj.state
    assert hyperkzg.verify_batch_opening(port, coms, x, bp,
                                         Blake2bTranscript(b"b"))
    assert jax_kzg.verify_batch_opening(ref, coms, x, bp, JaxTranscript(b"b"))


def test_mock_pcs_matches_jax():
    evals = list(range(3, 19))
    point = [5, 7, 11, 13]
    c = mock.commit(evals)
    assert c == jax_mock.commit(evals)
    value, proof = mock.open_at(evals, point)
    assert (value, proof) == jax_mock.open_at(evals, point)
    assert mock.verify(c, point, value, proof)
    assert not mock.verify(c, point, value + 1, proof)
