"""The port's mesh backend (zolt_tpu_torch/parallel/mesh.py and its users)
on meshes of "cpu" shards, in one process.

A mesh of "cpu" entries is the counterpart of the 8 virtual XLA devices
the JAX package's own mesh tests run on (tests/conftest.py): each shard is
a tensor of its own and runs the kernels' plain versions. References, named
by each test:
- JAX's `make_sharded_product_round` on its 8 virtual devices, once, at
  the smallest size (its jitted shard_map takes about 20 s to compile
  here);
- elsewhere JAX's host tier on the same inputs: `FrVec.prod_evals_adj` /
  `fold_adj` rounds with the same Blake2b transcript, the host stage 1,
  `msm_oracle`, the host-tier prove_jolt bytes (JAX's own tests hold its
  mesh byte-equal to those);
- JAX's `device_outer._eq_gather` for the shifted eq offsets of the
  sharded Gruen round.
Tolerance 0: every value is a canonical field element or an affine point.
Meshes of 1, 2 and 8 shards (3 where a count must not divide n). About
130 s in one process on an 8-core CPU box: the proves (their JAX
references 13 s), JAX's sharded round (20 s of compile), msm_mesh's plain
bucket sums (18 s over four meshes) and the batch opening (13 s).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_slice import GUESTS
from test_torch_sound import N, _claims, _prove
from zolt_tpu.curve import host as jax_chost
from zolt_tpu.field import limb as jax_limb
from zolt_tpu.msm import pippenger as jax_pippenger
from zolt_tpu.native.frvec import FrVec as JFrVec
from zolt_tpu.pcs import batch as jax_batch
from zolt_tpu.pcs import dory as jax_dory
from zolt_tpu.parallel import make_mesh as jax_make_mesh
from zolt_tpu.parallel import make_sharded_product_round as jax_round
from zolt_tpu.r1cs import inputs as jri
from zolt_tpu.transcript import Blake2bTranscript as JTranscript
from zolt_tpu.vm import pad_with_noop as jpad
from zolt_tpu.vm import run_elf as jrun_elf
from zolt_tpu.zkvm import device_outer as jdo
from zolt_tpu.zkvm.commitments import derive_tau as jderive_tau
from zolt_tpu.zkvm.lookups_raf import collect_entries as jcollect_entries
from zolt_tpu.zkvm.lookups_raf import \
    slow_phase_a_round_evals as jslow_phase_a
from zolt_tpu.zkvm.pipeline import prove_jolt as jax_prove_jolt
from zolt_tpu.zkvm.preamble import fiat_shamir_preamble as jpreamble
from zolt_tpu.zkvm.streaming_outer import prove_stage1_jolt as jstage1
from zolt_tpu_torch.field import limb
from zolt_tpu_torch.field.params import FR
from zolt_tpu_torch.msm import pippenger
from zolt_tpu_torch.native.frvec import FrVec
from zolt_tpu_torch.parallel import mesh as pm
from zolt_tpu_torch.parallel import stage_engine as se
from zolt_tpu_torch.pcs import batch, dory
from zolt_tpu_torch.poly.special import GruenSplitEq
from zolt_tpu_torch.r1cs import inputs as ri
from zolt_tpu_torch.transcript import Blake2bTranscript
from zolt_tpu_torch.vm import elf as elf_mod
from zolt_tpu_torch.vm import pad_with_noop, run_elf
from zolt_tpu_torch.vm.guest import Asm
from zolt_tpu_torch.vm.layout import MemoryConfig, MemoryLayout
from zolt_tpu_torch.zkvm import device_outer as do
from zolt_tpu_torch.zkvm.commitments import derive_tau
from zolt_tpu_torch.zkvm.lookups_raf import (collect_entries,
                                             slow_phase_a_round_evals)
from zolt_tpu_torch.zkvm.pipeline import prove_jolt
from zolt_tpu_torch.zkvm.preamble import fiat_shamir_preamble
from zolt_tpu_torch.zkvm.streaming_outer import prove_stage1_jolt

torch.set_num_threads(1)

P = FR.p
SHARDS = [1, 2, 8]


def _ints(seed: int, n: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % P for _ in range(n)]


def _mesh(n_dev: int):
    return pm.make_mesh(["cpu"] * n_dev)


# -- the mesh itself -----------------------------------------------------------

def test_make_mesh_needs_a_cuda_device_or_a_list(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device and there is none"):
        pm.make_mesh()
    m = pm.make_mesh(["cpu"] * 4)
    assert m.size == 4 and m.devices == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError, match="at least one"):
        pm.make_mesh([])


def test_shards_on_a_repeated_device_are_distinct_tensors():
    t = limb.encode(_ints(1, 64)).reshape(2, 32, 8).contiguous()
    shards = pm.shard_table(_mesh(4), t)
    assert len({s.data_ptr() for s in shards}) == 4
    assert all(s.data_ptr() != t.data_ptr() for s in shards)
    assert torch.equal(torch.cat(shards, dim=1), t)
    with pytest.raises(ValueError, match="do not split"):
        pm.shard_table(_mesh(3), t)


def test_psum_field_of_partials_near_p():
    """Reference: the sum of the ints mod p."""
    vals = [[P - 1 - i, P - 2 * i - 5, i] for i in range(8)]
    parts = [limb.encode(v) for v in vals]
    got = limb.decode(pm._psum_field(parts))
    assert got == [sum(v[j] for v in vals) % P for j in range(3)]


# -- the sharded rounds --------------------------------------------------------

def test_sharded_round_matches_jax_mesh():
    """Reference: JAX's make_sharded_product_round on its 8 virtual
    devices (n = 64, k = 2): the evals and the folded tables equal."""
    n = 64
    a, b = _ints(2, n), _ints(3, n)
    r = _ints(4, 1)[0]
    tabs = np.stack([np.asarray(jax_limb.encode(v)) for v in (a, b)])
    j_evals, j_bound = jax_round(jax_make_mesh(jax.devices()[:8]), 2)(
        jax.device_put(tabs), jax_limb.encode([r])[0])
    mesh = _mesh(8)
    evals, shards = pm.make_sharded_product_round(mesh, 2)(
        pm.shard_table(mesh, limb.from_jax_limbs(tabs)), r)
    assert torch.equal(evals, limb.from_jax_limbs(np.asarray(j_evals)))
    assert torch.equal(torch.cat(shards, dim=1),
                       limb.from_jax_limbs(np.asarray(j_bound)))


def _host_sumcheck(tables, transcript):
    """JAX's host FrVec rounds of Σ_x Π_k f_k(x) on the transcript."""
    vecs = [JFrVec.from_ints(t) for t in tables]
    evals_all, rs = [], []
    while vecs[0].n > 1:
        evals = JFrVec.prod_evals_adj(vecs, len(vecs))
        for e in evals:
            transcript.append_scalar(e)
        r = transcript.challenge_scalar()
        vecs = [v.fold_adj(r) for v in vecs]
        evals_all.append(evals)
        rs.append(r)
    return evals_all, rs, [v.first() for v in vecs]


@pytest.mark.parametrize("n_dev", SHARDS)
def test_sharded_sumcheck_matches_jax_host_rounds(monkeypatch, n_dev):
    """n = 128, k = 3: round evals, challenges, finals and the transcript
    against JAX's host FrVec rounds (the mesh engine's rounds while the
    table spans the mesh, at tail 0; its host tail after)."""
    monkeypatch.setenv("ZOLT_TPU_DEVICE_TAIL", "0")
    tables = [_ints(10 + j, 128) for j in range(3)]
    jt, pt = JTranscript(b"sharded"), Blake2bTranscript(b"sharded")
    ref = _host_sumcheck(tables, jt)
    assert pm.sharded_sumcheck_prove(_mesh(n_dev), tables, pt) == ref
    assert pt.state == jt.state


# -- the product engine --------------------------------------------------------

@pytest.mark.parametrize("k,degree,passengers,n,n_dev,tail", [
    (2, 2, 1, 64, 8, 0),       # the InstructionLookups CR shape, 8 shards
    (3, 3, 0, 64, 2, 0),       # ValEvaluation / InstructionInput
    (2, 3, 0, 32, 2, 4),       # the host tail at 4, after the handoff
    (2, 2, 0, 8, 8, 0),        # 8 entries cannot split over 8: unsharded
    (2, 2, 0, 1 << 14, 8, 8192),   # one sharded round, then the host
], ids=["k2d2-passenger", "k3d3", "tail4", "unsplit", "tail8192"])
def test_mesh_product_tables_match_jax_host_rounds(monkeypatch, k, degree,
                                                   passengers, n, n_dev,
                                                   tail):
    """Round by round against JAX's host FrVec.prod_evals_adj / fold_adj;
    the live entries in shard order equal the host tables while on the
    mesh."""
    monkeypatch.setenv("ZOLT_TPU_DEVICE_TAIL", str(tail))
    vals = [_ints(100 * k + degree + n_dev + j, n)
            for j in range(k + passengers)]
    port_in = [limb.encode(vals[0])] + [FrVec.from_ints(v) for v in vals[1:]]
    port = se.DeviceProductTables(port_in[:k], port_in[k:], degree=degree,
                                  mesh=_mesh(n_dev))
    assert port.n_dev == (1 if n < 2 * n_dev else n_dev)
    host = [JFrVec.from_ints(v) for v in vals]
    rounds = 0
    for r in _ints(7 + n, n.bit_length() - 1):
        on_mesh = port._host is None and not port._needs_tail()
        assert port.round_evals() == JFrVec.prod_evals_adj(host[:k], degree)
        if on_mesh:
            rounds += 1
            want = torch.stack([limb.encode(v.to_ints()) for v in host])
            assert torch.equal(port.tables, want)
        port.bind(r)
        host = [v.fold_adj(r) for v in host]
    assert port.live == 1
    assert port.finals() == [v.first() for v in host]
    assert rounds == {64: n.bit_length() - 1 - (3 if n_dev == 8 else 1),
                      32: 3, 8: 3, 1 << 14: 1}[n]


def test_round_evals_many_groups_shards_by_device(monkeypatch):
    """A mesh engine of 8 shards and a single-device engine evaluate in one
    grouped call on their one device (9 groups), each engine's evals
    equal to JAX's host rounds."""
    monkeypatch.setenv("ZOLT_TPU_DEVICE_TAIL", "0")
    calls = []
    evals = pm.product_evals

    def spy(groups):
        calls.append(len(groups))
        return evals(groups)

    monkeypatch.setattr(pm, "product_evals", spy)
    a, b = _ints(20, 64), _ints(21, 64)
    engs = [se.DeviceProductTables([FrVec.from_ints(a), FrVec.from_ints(b)],
                                   mesh=_mesh(8)),
            se.DeviceProductTables([FrVec.from_ints(b), FrVec.from_ints(a)],
                                   device="cpu")]
    got = se.drain_futures(se.round_evals_many(engs))
    ha, hb = JFrVec.from_ints(a), JFrVec.from_ints(b)
    assert got == [JFrVec.prod_evals_adj([ha, hb], 2),
                   JFrVec.prod_evals_adj([hb, ha], 2)]
    assert calls == [9]


@pytest.mark.parametrize("n_dev", [2, 8])
def test_batch_opening_on_a_mesh_matches_jax_host_version(monkeypatch,
                                                          n_dev):
    """The batch opening alone (tests/test_torch_sound.py's 27 claims over
    tables of 4 to 256 entries) with backend="mesh" at tail 0, against
    JAX's host version: proof bytes and transcript. Over 8 shards the
    groups of 8 entries cannot split and run unsharded."""
    monkeypatch.setenv("ZOLT_TPU_DEVICE_TAIL", "0")
    port_claims, ref_claims = _claims(20261018)
    ref = _prove(jax_batch, JTranscript, jax_dory.setup(N), ref_claims)
    assert _prove(batch, Blake2bTranscript, dory.setup(N), port_claims,
                  backend="mesh", mesh=_mesh(n_dev)) == ref


# -- the sharded Gruen round -----------------------------------------------------

def test_shifted_eq_offsets_match_jax_eq_gather():
    """Each shard's e_i at its shifted offsets (off_out + g >> h_in, off_in
    + g & mask, g its first global pair) against JAX's _eq_gather at the
    global pair indices, every round of a 2^6 split eq down to h_in = 0,
    shards of 2^h_in pairs and more and fewer."""
    nv = 6
    se_p = GruenSplitEq(_ints(11, nv), 5)
    e_out = do._flat_stack(se_p.E_out_vec, "cpu")
    e_in = do._flat_stack(se_p.E_in_vec, "cpu")
    j_out, j_in = (jnp.asarray(limb.to_jax_limbs(t)) for t in (e_out, e_in))
    pairs = 1 << (nv - 1)
    idx = jnp.arange(pairs, dtype=jnp.uint32)
    seen_h = set()
    for r in _ints(12, nv - 1):
        off_out, off_in, h_in, _ = do._gruen_level_args(se_p)
        seen_h.add(h_in)
        # one shape every round: JAX compiles each eager op once
        want = limb.from_jax_limbs(np.asarray(jdo._eq_gather(
            j_out, j_in, idx, idx < pairs, jnp.uint32(off_out),
            jnp.uint32(off_in), jnp.uint32(h_in))))
        mask = (1 << h_in) - 1
        for n_dev in (2, 8):
            q = pairs // n_dev
            if q == 0:
                continue
            for s in range(n_dev):
                g = s * q
                o_out, o_in = off_out + (g >> h_in), off_in + (g & mask)
                i = torch.arange(q)
                e = limb.mont_mul(e_out[o_out + (i >> h_in)],
                                  e_in[o_in + (i & mask)])
                assert torch.equal(e, want[g: g + q])
        se_p.bind(r)
        pairs //= 2
    assert 0 in seen_h and max(seen_h) >= 2


@pytest.mark.parametrize("n_dev,tail", [(2, 0), (8, 0), (8, 16)])
def test_mesh_outer_rounds_match_the_host_tier(monkeypatch, n_dev, tail):
    """DeviceOuterRounds(mesh=) over 2^6 entries against the host FrVec Gruen round
    (gruen_quad) and folds, round by round, into the host tail (a shard
    below one pair, or the live prefix at the tail)."""
    monkeypatch.setenv("ZOLT_TPU_DEVICE_TAIL", str(tail))
    nv = 6
    tau = _ints(11, nv)
    az, bz = _ints(12, 1 << nv), _ints(13, 1 << nv)
    se_p = GruenSplitEq(tau, 5)
    port = do.DeviceOuterRounds(FrVec.from_ints(az), limb.encode(bz),
                                se=se_p, mesh=_mesh(n_dev))
    ha, hb = FrVec.from_ints(az), FrVec.from_ints(bz)
    on_mesh = 0
    for r in _ints(14, nv):
        got = port.round_evals()
        on_mesh += port._fr is None
        assert got == do._gruen_tail_evals(se_p, ha, hb, port.live)
        port.bind(r)
        se_p.bind(r)
        ha, hb = ha.fold_adj(r), hb.fold_adj(r)
    assert port.final_values() == (ha.first(), hb.first())
    assert on_mesh == {(2, 0): 5, (8, 0): 3, (8, 16): 2}[(n_dev, tail)]


def _loop_trace(pkg_run, pkg_pad, asm_cls, lay_mods):
    mc, ml = lay_mods
    lay = ml.create(mc(program_size=1024))
    a = asm_cls()
    a.addi(1, 0, 20)
    a.label("loop")
    a.add(2, 2, 1)
    a.addi(1, 1, -1)
    a.bne(1, 0, "loop")
    a.halt(lay, provable=True)
    return pkg_pad(list(pkg_run(elf_mod.write_minimal_elf(a.bytes())).trace))


@pytest.mark.parametrize("n_dev", SHARDS)
def test_stage1_mesh_matches_jax_host_stage1(n_dev):
    """prove_stage1_jolt(backend="mesh") against JAX's host stage 1: round
    polys, challenges and the transcript state, as
    tests/test_device_outer.py holds JAX's mesh."""
    from zolt_tpu.vm.guest import Asm as JAsm
    from zolt_tpu.vm.layout import MemoryConfig as JMC, MemoryLayout as JML

    out = []
    for run, pad, asm, lay, tr, pre, tau_of, st1, rows in (
            (jrun_elf, jpad, JAsm, (JMC, JML), JTranscript, jpreamble,
             jderive_tau, jstage1, jri.witness_matrix),
            (run_elf, pad_with_noop, Asm, (MemoryConfig, MemoryLayout),
             Blake2bTranscript, fiat_shamir_preamble, derive_tau,
             prove_stage1_jolt, ri.witness_matrix)):
        padded = _loop_trace(run, pad, asm, lay)
        T = len(padded)
        tp = tr(b"Jolt")
        pre(tp, max_input_size=4096, max_output_size=4096,
            memory_size=32768, inputs=b"", outputs=b"", panic=False,
            ram_k=1 << 16, trace_length=T)
        tau = tau_of(tp, T.bit_length() - 1)
        kw = ({"backend": "mesh", "mesh": _mesh(n_dev)} if st1 is
              prove_stage1_jolt else {})
        p = st1(padded, tau, tp, witness_rows=rows(padded), **kw)
        out.append((p.uni_skip_coeffs, p.compressed_polys, p.challenges,
                    tp.state))
    assert out[1] == out[0]


# -- msm_mesh ------------------------------------------------------------------

@pytest.fixture(scope="module")
def msm_case():
    """64 points, one None, one zero scalar, and JAX's msm_oracle of
    them."""
    rng = np.random.default_rng(55)
    pts = [jax_chost.scalar_mul(jax_chost.G1_GEN,
                                int(rng.integers(1, 1 << 30)))
           for _ in range(64)]
    scalars = [int.from_bytes(rng.bytes(31), "little") % P for _ in range(64)]
    pts[5] = None
    scalars[9] = 0
    return pts, scalars, jax_pippenger.msm_oracle(pts, scalars)


@pytest.mark.parametrize("n_dev,wpp", [(1, 8), (2, 32), (3, 32), (8, 32)])
def test_msm_mesh_matches_jax_oracle(monkeypatch, msm_case, n_dev, wpp):
    """Against JAX's msm_oracle, affine (3 shards do not divide 64: two
    identities pad it); the shards' bucket arrays meet in one fold
    (`pt_sum`) a pass of `wpp` windows (8 by default), of n_dev stacked
    arrays of wpp·256 points (none on one shard)."""
    pts, scalars, want = msm_case
    adds = []
    fold = pippenger.dev.pt_sum

    def spy(stack):
        adds.append(tuple(stack[0].shape))
        return fold(stack)

    monkeypatch.setattr(pippenger.dev, "pt_sum", spy)
    kw = {} if wpp == 8 else {"windows_per_pass": wpp}
    assert pippenger.msm_mesh(_mesh(n_dev), pts, scalars, **kw) == want
    assert adds == [(n_dev, wpp * 256, 8)] * (32 // wpp if n_dev > 1 else 0)


# -- prove_jolt ------------------------------------------------------------------

def _parallel_guest() -> bytes:
    """The guest of the JAX package's mesh prove (tests/test_parallel.py)."""
    lay = MemoryLayout.create(MemoryConfig(program_size=1024))
    a = Asm()
    a.li_addr(5, 0x80002000)
    a.addi(1, 0, 0)
    a.addi(2, 0, 12)
    a.label("w")
    a.sd(5, 1, 0)
    a.addi(5, 5, 8)
    a.add(1, 1, 2)
    a.addi(2, 2, -1)
    a.bne(2, 0, "w")
    a.halt(lay, provable=True)
    return elf_mod.write_minimal_elf(a.bytes())


PROVE_GUESTS = {"sum_loop_t10": GUESTS["sum_loop_t10"],
                "parallel": _parallel_guest}


@pytest.fixture(scope="module")
def jax_bytes(tmp_path_factory):
    """{(guest, sound): (the ELF's path, JAX's host-tier proof bytes)}."""
    root = tmp_path_factory.mktemp("mesh")
    out = {}
    for name, make in PROVE_GUESTS.items():
        path = str(root / f"{name}.elf")
        with open(path, "wb") as f:
            f.write(make())
        for sound in (False, True):
            out[name, sound] = (path, jax_prove_jolt(
                path, sound=sound).conv.proof.serialize_with_dory())
    return out


# (guest, sound, backend, stage1_backend, shards, tail): the sound proves
# at tails where the batch opening's widest groups take a round or two on
# the mesh and then hand over (the plain versions of a tail-0 sound prove
# take a minute here; the compat proves run every round on the mesh)
PROVES = {
    "sum_loop-compat-mesh8": ("sum_loop_t10", False, "mesh", None, 8, 0),
    "sum_loop-compat-stage1": ("sum_loop_t10", False, "device", "mesh", 2,
                               0),
    "sum_loop-sound-stage1": ("sum_loop_t10", True, "host", "mesh", 8, 0),
    "parallel-compat-mesh2": ("parallel", False, "mesh", None, 2, 0),
    "parallel-sound-mesh8": ("parallel", True, "mesh", None, 8, 2048),
    "parallel-sound-stage1": ("parallel", True, "host", "mesh", 2, 0),
}


@pytest.mark.parametrize("case", list(PROVES))
def test_prove_jolt_on_a_mesh_gives_jax_bytes(jax_bytes, monkeypatch, case):
    guest, sound, backend, s1, n_dev, tail = PROVES[case]
    monkeypatch.setenv("ZOLT_TPU_DEVICE_TAIL", str(tail))
    path, ref = jax_bytes[guest, sound]
    got = prove_jolt(path, sound=sound, backend=backend, stage1_backend=s1,
                     mesh=_mesh(n_dev), device="cpu")
    assert got.conv.proof.serialize_with_dory() == ref


def test_mesh_prove_without_a_mesh_needs_cuda(jax_bytes, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    path = jax_bytes["parallel", False][0]
    for kw in ({"backend": "mesh"}, {"backend": "host",
                                     "stage1_backend": "mesh"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            prove_jolt(path, **kw)


# -- the slow phase-A oracle -----------------------------------------------------

def test_slow_phase_a_round_evals_matches_jax():
    """lookups_raf.slow_phase_a_round_evals on the first 24 lookup entries
    of the golden-array guest (sound trace), three rounds of bound address
    bits from the top, against JAX's."""
    blob = GUESTS["golden_array"]()
    ent_j = jcollect_entries(jpad(jrun_elf(blob, expand_virtual=True).trace))
    ent_p = collect_entries(pad_with_noop(run_elf(blob,
                                                  expand_virtual=True).trace))
    assert [(j, i) for j, i, _ in ent_j] == [(j, i) for j, i, _ in ent_p]
    ent_j, ent_p = ent_j[:24], ent_p[:24]
    g = _ints(30, 1)[0]
    gammas = [1, g, g * g % P, g * g % P * g % P]
    eqv = _ints(31, max(j for j, _, _ in ent_p) + 1)
    rs = _ints(32, 3)
    r_bound = {}
    for i in range(3):
        pos = 127 - i
        got = slow_phase_a_round_evals(ent_p, gammas, eqv, r_bound, pos, 0)
        assert got == jslow_phase_a(ent_j, gammas, eqv, r_bound, pos, 0)
        r_bound[pos] = rs[i]
