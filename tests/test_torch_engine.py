"""The port's single-device engines against the JAX package's.

- parallel/stage_engine.DeviceProductTables (kernels 1-3 round by round:
  deferred binds, grouped folds, evals, the host-tail handoff,
  passengers, finals), whose tables hold the live prefix of the JAX
  engine's zero-tailed tables;
- zkvm/device_outer.DeviceOuterRounds (kernel 4: the fold of the last
  challenge and the Gruen eq-weighted round at the split-eq level offsets
  in one pass);
- parallel/device_cols (the on-device Montgomery encodes, eq tables and
  challenge combos that feed them), as tests/test_device_cols.py checks the
  JAX one.

The same numpy-seeded values go to both packages and to the host C tier
(FrVec), over a full round schedule. On the CPU the port's engines run the
kernels' plain torch versions; the JAX engines run their XLA forms. The
plain kernels 2-4 are also held here to those XLA forms directly
(stage_engine._evals_fixed, device_outer._eval_fixed), at the shapes the
engine cases compile, so each XLA program compiles once. The tolerance is
exact (equal ints, equal bytes): integer field arithmetic.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zolt_tpu.native.frvec import FrVec as JFrVec
from zolt_tpu.parallel import device_cols as jdc
from zolt_tpu.parallel import stage_engine as jse
from zolt_tpu.poly.special import GruenSplitEq as JGruenSplitEq
from zolt_tpu.r1cs import inputs as jri
from zolt_tpu.vm import pad_with_noop as jpad
from zolt_tpu.vm.emulator import run_elf as jrun_elf
from zolt_tpu.zkvm import device_outer as jdo
from zolt_tpu_torch.field import evals, gruen, limb
from zolt_tpu_torch.field.params import FR
from zolt_tpu_torch.native.frvec import FrVec
from zolt_tpu_torch.parallel import device_cols as dc
from zolt_tpu_torch.parallel import stage_engine as se
from zolt_tpu_torch.poly.special import GruenSplitEq
from zolt_tpu_torch.r1cs import inputs as ri
from zolt_tpu_torch.vm import elf as elf_mod, pad_with_noop
from zolt_tpu_torch.vm.emulator import run_elf
from zolt_tpu_torch.vm.guest import Asm
from zolt_tpu_torch.vm.layout import MemoryConfig, MemoryLayout
from zolt_tpu_torch.zkvm import device_outer as do

# The tensors here are tiny: torch's worker threads would only spin, and
# they doubled the CPU seconds of the port's tests.
torch.set_num_threads(1)

P = FR.p
CPU = torch.device("cpu")


def _ints(seed: int, n: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % P for _ in range(n)]


def _words(jax_arr) -> torch.Tensor:
    return limb.from_jax_limbs(np.asarray(jax_arr))


# -- DeviceProductTables -----------------------------------------------------

# Every case folds three (16, 16) limb stacks and evaluates at (k, degree)
# of (2, 2) or (3, 3): three XLA programs in all. (k = 2 at degree 3, the
# ValFinal shape, is held to the Pallas eval_rows_k2 in
# tests/test_torch_kernels.py.)
@pytest.mark.parametrize("k,degree,passengers,tail", [
    (2, 2, 1, 0),      # InstructionLookups CR shape: eq·comb, with openings
    (2, 2, 1, 4),      # the same with the host tail at 4
    (3, 3, 0, 0),      # ValEvaluation / InstructionInput shape
], ids=["k2d2-passenger", "k2d2-tail4", "k3d3"])
def test_product_tables_match_jax_engine(monkeypatch, k, degree, passengers,
                                         tail):
    monkeypatch.setenv("ZOLT_TPU_DEVICE_TAIL", str(tail))
    n = 16
    vals = [_ints(100 * k + 10 * degree + tail + j, n)
            for j in range(k + passengers)]
    # one factor arrives as a resident tensor (as WitnessStore columns do)
    port_in = [limb.encode(vals[0])] + [FrVec.from_ints(v) for v in vals[1:]]
    port = se.DeviceProductTables(port_in[:k], port_in[k:], degree=degree,
                                  device="cpu")
    ref = jse.DeviceProductTables([JFrVec.from_ints(v) for v in vals[:k]],
                                  [JFrVec.from_ints(v) for v in vals[k:]],
                                  degree=degree)
    host = [FrVec.from_ints(v) for v in vals]
    for r in _ints(7 + k + degree, n.bit_length() - 1):
        got = port.round_evals()
        assert got == ref.round_evals()
        assert got == FrVec.prod_evals_adj(host[:k], degree)
        if port._host is None:
            # the port holds the live prefix the JAX engine holds before
            # its zero tail
            full = _words(ref.tables)
            assert torch.equal(port.tables, full[:, : port.live])
            assert not full[:, port.live:].any()
        port.bind(r)
        ref.bind(r)
        host = [v.fold_adj(r) for v in host]
        # the bind is deferred: r is pending, the tables not yet folded
        assert port.live == ref.live
        assert (port._pending is None) == (port._host is not None)
    assert port.live == ref.live == 1
    assert port.finals() == ref.finals() == [v.first() for v in host]
    assert port._pending is None


@pytest.mark.parametrize("k,degree", [(2, 2), (3, 3)])
def test_evals_match_xla_evals_fixed(k, degree):
    """Kernels 2-3's plain version against the XLA form the JAX engine runs
    below its packed-row size, down a live-prefix schedule."""
    n = 16
    live = n
    while live >= 2:
        tabs = torch.stack([limb.encode(_ints(41 + 10 * live + j, live)
                                        + [0] * (n - live))
                            for j in range(k)])
        got, = evals.product_evals([(tabs, live // 2, degree)])
        ref = jse._evals_fixed(jnp.asarray(limb.to_jax_limbs(tabs)), degree)
        assert torch.equal(got, _words(ref))
        live //= 2


def test_round_evals_many_matches_jax_engines(monkeypatch):
    """Stage 3's instance set, three k = 2 degree-2 and four k = 3 degree-3
    engines, evaluated per round by one round_evals_many call (one grouped
    launch on a GPU), against zolt_tpu's engines round by round. The host
    tail at 4 moves every engine to the host for the last two rounds, where
    round_evals_many hands back None. The k = 2 engines carry a passenger,
    so all folds share the k3d3 case's XLA program."""
    monkeypatch.setenv("ZOLT_TPU_DEVICE_TAIL", "4")
    n = 16
    specs = [(2, 2, 1)] * 3 + [(3, 3, 0)] * 4
    port, ref = [], []
    for i, (k, degree, passengers) in enumerate(specs):
        vals = [_ints(200 + 10 * i + j, n) for j in range(k + passengers)]
        port.append(se.DeviceProductTables(
            [FrVec.from_ints(v) for v in vals[:k]],
            [FrVec.from_ints(v) for v in vals[k:]], degree=degree,
            device="cpu"))
        ref.append(jse.DeviceProductTables(
            [JFrVec.from_ints(v) for v in vals[:k]],
            [JFrVec.from_ints(v) for v in vals[k:]], degree=degree))
    for rnd, r in enumerate(_ints(17, n.bit_length() - 1)):
        futs = se.round_evals_many(port)
        assert [f is None for f in futs] == [rnd >= 2] * len(port)
        assert all(e._pending is None for e in port)
        got = [e.round_evals() if v is None else v
               for e, v in zip(port, se.drain_futures(futs))]
        assert got == [e.round_evals() for e in ref]
        for e in port + ref:
            e.bind(r)
    assert [e.finals() for e in port] == [e.finals() for e in ref]


def test_drain_futures_batches_engines_in_one_download(monkeypatch):
    monkeypatch.setenv("ZOLT_TPU_DEVICE_TAIL", "0")
    a = se.DeviceProductTables([FrVec.from_ints(_ints(s, 8)) for s in (1, 2)],
                               device="cpu")
    b = se.DeviceProductTables([FrVec.from_ints(_ints(s, 8))
                                for s in (3, 4, 5)], degree=3, device="cpu")
    outer = torch.stack([limb.encode(_ints(6, 2)), limb.encode(_ints(7, 2))])
    got = se.drain_futures([a.round_evals_device(), outer, None,
                            b.round_evals_device()])
    assert got == [a.round_evals(), limb.decode(outer.reshape(-1, 8)), None,
                   b.round_evals()]
    absent, fut = se.round_evals_many([None, a])
    assert absent is None and se.drain_futures([fut]) == [a.round_evals()]
    assert se.drain_futures([]) == []
    assert se.drain_futures([None]) == [None]


def test_engine_device_is_explicit():
    v = FrVec.from_ints(_ints(9, 8))
    with pytest.raises(ValueError, match="explicit device"):
        se.DeviceProductTables([v, v])
    with pytest.raises(ValueError, match="explicit device"):
        do.DeviceOuterRounds(v, v)
    meta = torch.empty((8, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="engine on cpu"):
        se.DeviceProductTables([meta, v], device="cpu")


# -- DeviceOuterRounds ---------------------------------------------------------

@pytest.mark.parametrize("tail", [0, 8], ids=["device", "tail8"])
def test_outer_rounds_match_jax_engine(monkeypatch, tail):
    """The stage-1 remaining rounds: az/bz of 2^L entries under a split eq
    over L challenges (streaming_outer sizes it so), one Gruen eval and one
    fold per round."""
    monkeypatch.setenv("ZOLT_TPU_DEVICE_TAIL", str(tail))
    nv = 6
    n = 1 << nv
    tau = _ints(11, nv)
    az, bz = _ints(12, n), _ints(13, n)
    se_p, se_j = GruenSplitEq(tau, 5), JGruenSplitEq(tau, 5)
    port = do.DeviceOuterRounds(FrVec.from_ints(az), limb.encode(bz),
                                se=se_p, device="cpu")
    ref = jdo.DeviceOuterRounds(JFrVec.from_ints(az), JFrVec.from_ints(bz),
                                se=se_j)
    host_a, host_b = FrVec.from_ints(az), FrVec.from_ints(bz)
    for r in _ints(14, nv):
        got = port.round_evals()
        assert got == ref.round_evals()
        assert got == do._gruen_tail_evals(se_p, host_a, host_b, port.live)
        if port._fr is None:
            # the pass folded the previous r: the live prefix of the JAX
            # engine's az/bz, whose tail is zero
            full = torch.stack([_words(ref.az), _words(ref.bz)])
            assert port._pending is None
            assert torch.equal(port.tabs, full[:, : port.live])
            assert not full[:, port.live:].any()
        port.bind(r)
        ref.bind(r)
        se_p.bind(r)
        se_j.bind(r)
        host_a, host_b = host_a.fold_adj(r), host_b.fold_adj(r)
    assert port.final_values() == ref.final_values() == (
        host_a.first(), host_b.first())


def test_gruen_matches_xla_eval_fixed():
    """Kernel 4's plain version against product_round's production form,
    the XLA device_outer._eval_fixed with its eq gather, at every round's
    level offsets of the split eq above (az/bz of 2^6 entries)."""
    nv = 6
    n = 1 << nv
    se_p = GruenSplitEq(_ints(11, nv), 5)
    e_out = do._flat_stack(se_p.E_out_vec, "cpu")
    e_in = do._flat_stack(se_p.E_in_vec, "cpu")
    live = n
    for r in _ints(31, nv):
        off_out, off_in, h_in, _ = do._gruen_level_args(se_p)
        ab = torch.stack([limb.encode(_ints(32 + 2 * live + j, live)
                                      + [0] * (n - live)) for j in (0, 1)])
        got = gruen.gruen_eval(ab[0], ab[1], e_out, e_in, off_out, off_in,
                               h_in, live // 2)
        ref = jdo._eval_fixed(*(jnp.asarray(limb.to_jax_limbs(t))
                                for t in (ab[0], ab[1], e_out, e_in)),
                              jnp.uint32(off_out), jnp.uint32(off_in),
                              jnp.uint32(h_in), jnp.uint32(live // 2))
        assert torch.equal(got, _words(ref))
        se_p.bind(r)
        live //= 2


@pytest.mark.parametrize("mode", ["eval", "fused", "fold"])
def test_gruen_round_plain_matches_xla_fold_and_eval(mode):
    """Kernel 4's plain version in each mode against the XLA programs the
    JAX engine runs, device_outer._fold_fixed, then _eval_fixed, at the
    shapes the cases above compile (az/bz of 2^6 entries, the split eq of
    6 variables), over every round of the split eq."""
    from zolt_tpu.field import mxu

    nv = 6
    n = 1 << nv
    se_p = GruenSplitEq(_ints(11, nv), 5)
    e_out = do._flat_stack(se_p.E_out_vec, "cpu")
    e_in = do._flat_stack(se_p.E_in_vec, "cpu")
    jeq = [jnp.asarray(limb.to_jax_limbs(t)) for t in (e_out, e_in)]
    ab = torch.stack([limb.encode(_ints(33 + j, n)) for j in (0, 1)])
    ref = [jnp.asarray(limb.to_jax_limbs(ab[j])) for j in (0, 1)]
    live = n
    for rnd, r in enumerate(_ints(41, nv)):
        if mode != "eval" and rnd:
            # round rnd's pass folds by the previous challenge
            rt = jnp.asarray(mxu.scalar_toeplitz(FR.mont(r)))
            ref = list(jdo._fold_fixed(ref[0], ref[1], rt))
            ab, ev = gruen.gruen_round(ab, r, e_out, e_in,
                                       *do._gruen_level_args(se_p)[:3],
                                       live // 2, eval=mode == "fused")
            live //= 2
            assert ab.shape == (2, live, 8)
            full = torch.stack([_words(t) for t in ref])
            assert torch.equal(ab, full[:, :live])
        else:
            live = n >> rnd          # eval only: the same tables, fewer pairs
            ev = gruen.gruen_round(ab, None, e_out, e_in,
                                   *do._gruen_level_args(se_p)[:3],
                                   live // 2)[1]
        if ev is not None:
            off_out, off_in, h_in, _ = do._gruen_level_args(se_p)
            want = jdo._eval_fixed(*ref, *jeq, jnp.uint32(off_out),
                                   jnp.uint32(off_in), jnp.uint32(h_in),
                                   jnp.uint32(live // 2))
            assert torch.equal(ev, _words(want))
        se_p.bind(r)


# -- device_cols ---------------------------------------------------------------

RNG_SEED = 7


def test_column_encodes_match_jax_and_frvec():
    rng = np.random.default_rng(RNG_SEED)
    vals = rng.integers(0, 1 << 63, size=64, dtype=np.uint64)
    lo = rng.integers(1, 1 << 63, size=64, dtype=np.uint64)
    hi = np.where(rng.integers(0, 2, 64) > 0, np.int64(-1), np.int64(0))
    bits = rng.integers(0, 2, size=64).astype(np.uint8)
    port, ref = dc.DeviceColumnStore("cpu"), jdc.DeviceColumnStore()
    for st in (port, ref):
        st.put_u64("v", vals)
        st.put_i128("i", lo, hi)
        st.put_flags("f", bits)
    host = {"v": FrVec.from_u64_array(vals),
            "i": FrVec.from_i128_arrays(lo, hi),
            "f": FrVec.from_u64_array(bits.astype(np.uint64))}
    for key, hv in host.items():
        got = port.get(key)
        assert got.device == CPU
        assert torch.equal(got, _words(ref.get(key)))
        assert torch.equal(got, limb.frvec_to_words(hv))
    g = 123456789
    assert torch.equal(port.combo(["v", "i"], [1, g]),
                       _words(ref.combo(["v", "i"], [1, g])))


def test_eq_table_and_lincomb_match_jax():
    point = _ints(21, 3)
    got = dc.eq_table_dev(point, "cpu")
    assert torch.equal(got, _words(jdc.eq_table_dev(point)))
    assert torch.equal(got, limb.frvec_to_words(FrVec.eq_table_be(point)))
    assert torch.equal(dc.eq_slice(point, 6, "cpu"), got[:6])
    cols = [limb.encode(_ints(22 + j, 32)) for j in range(3)]
    coeffs = _ints(25, 3)
    want = jdc.lincomb_dev([limb.to_jax_limbs(c) for c in cols], coeffs)
    assert torch.equal(dc.lincomb_dev(cols, coeffs), _words(want))


def _witness_guest() -> bytes:
    lay = MemoryLayout.create(MemoryConfig(program_size=1024))
    a = Asm()
    a.li_addr(5, 0x80002000)
    a.addi(1, 0, 6)
    a.addi(2, 0, 3)
    a.label("w")
    a.sd(5, 1, 0)
    a.ld(3, 5, 0)
    a.mul(4, 1, 2)
    a.add(4, 4, 3)
    a.sub(4, 4, 2)
    a.addi(1, 1, -1)
    a.bne(1, 0, "w")
    a.jal(6, "end")
    a.label("end")
    a.halt(lay, provable=True)
    return elf_mod.write_minimal_elf(a.bytes())


def test_witness_store_matches_jax_for_every_column():
    """Every raw spec witness_columns emits (u64, i128, flags, Product, the
    MUL splice, zeros) plus the shifted and negated flags of the stage-3
    shift instance."""
    elf = _witness_guest()
    padded = pad_with_noop(list(run_elf(elf).trace))
    jpadded = jpad(list(jrun_elf(elf).trace))
    raw, jraw = {}, {}
    cols = ri.witness_columns(padded, raw_out=raw)
    jri.witness_columns(jpadded, raw_out=jraw)
    port = dc.WitnessStore(raw, len(padded), "cpu")
    ref = jdc.WitnessStore(jraw, len(jpadded))
    for idx in range(ri.NUM_INPUTS):
        got = port.get(idx)
        assert torch.equal(got, _words(ref.get(idx))), f"column {idx}"
        assert torch.equal(got, limb.frvec_to_words(cols[idx])), \
            f"column {idx} vs FrVec"
    flag = next(key for key, spec in raw.items() if spec[0] == "flag")
    for fill in (0, 1):
        assert torch.equal(port.shifted_flag(flag, fill),
                           _words(ref.shifted_flag(flag, fill)))
        assert torch.equal(port.shifted_flag_not(flag, fill),
                           _words(ref.shifted_flag_not(flag, fill)))
    assert torch.equal(port.flags_not(flag), _words(ref.flags_not(flag)))
