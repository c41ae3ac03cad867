"""The port's legacy multi-stage prover (zolt_tpu_torch.zkvm: stages.py,
lasso.py, prover.py), its containers (serialization.py) and lasso64.py
against the JAX package's, on the CPU.

`prove_program(emu, log_k=10, min_pad=16, device="cpu")` runs every round
of the six stages through DeviceMleSumcheck on the plain versions of the
fold and the product evals, with the host tail pinned to 0 (as
tests/conftest.py pins it) and at the engine's default tail of 8192
entries, where the tables pass to the host C tier (FrVec) once the live
prefix is that narrow. Both give the bytes of zolt_tpu's
prove_program: `serialize`, `to_json` and the gzip container, on two
golden guests and the sum-loop guest (T = 2^10).

The reference runs the JAX package's prover with its two jitted device
helpers, `stages._round_evals` and `_fold_all`, computed by the JAX
package's own host tier (zolt_tpu.native.frvec.FrVec.prod_evals_adj and
fold_adj) on the same limb arrays (`jax_legacy_on_host`): XLA compiles
those helpers once per round shape, 11-34 s a shape at 4-16 entries on an
8-core CPU box and 2-4 minutes and tens of GiB at 2^17-2^21, so a JAX
proof of even a 32-step guest took 3-5 minutes (with jit off, or op by
op). The helpers themselves are held to the port's DeviceMleSumcheck op
by op (`_round_evals.__wrapped__`) at small shapes; the slow test
recomputes chip_smoke.JAX_LEGACY_DIGEST_T16 the same way. Tolerance:
exact (equal bytes, ints and messages).

About 25 s in one process on an 8-core CPU box (the op-by-op helpers'
XLA compiles about 10 s, the three JAX proves on its host tier about 3 s,
the port's proves on device="cpu" about 6 s).
"""

import contextlib
import copy
import gzip
import hashlib
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from golden_programs import _golden_array, _golden_gcd

from zolt_tpu import serialization as jser
from zolt_tpu.field import limb as jlimb
from zolt_tpu.native.frvec import FrVec as JFrVec
from zolt_tpu.transcript import Blake2bTranscript as JBlake2b
from zolt_tpu.vm import run_elf as jax_run_elf
from zolt_tpu.zkvm import lasso64 as jlasso64
from zolt_tpu.zkvm import prove_program as jax_prove_program
from zolt_tpu.zkvm import stages as jstages
from zolt_tpu.zkvm import verify as jax_verify
from zolt_tpu_torch import serialization as ser
from zolt_tpu_torch.field import limb
from zolt_tpu_torch.field.params import FR
from zolt_tpu_torch.r1cs import constraints as rc
from zolt_tpu_torch.transcript import Blake2bTranscript
from zolt_tpu_torch.vm import Emulator, MemoryConfig, pad_with_noop, run_elf
from zolt_tpu_torch.vm import elf as elf_mod
from zolt_tpu_torch.vm import tables as tb
from zolt_tpu_torch.vm.guest import Asm
from zolt_tpu_torch.vm.layout import MemoryLayout
from zolt_tpu_torch.vm.lookups import LookupTraceCollector
from zolt_tpu_torch.zkvm import lasso64, prove_program, verify
from zolt_tpu_torch.zkvm.stages import DeviceMleSumcheck, _ceil_log2

torch.set_num_threads(1)
P = FR.p
LAY = MemoryLayout.create(MemoryConfig(program_size=1024))


def _elf(build) -> bytes:
    a = build(LAY) if build is _golden_array else build()
    a.halt(LAY, tmp=30, one=31, provable=True)
    return elf_mod.write_minimal_elf(a.bytes())


GUESTS = {
    "sum_loop_t10": lambda: chip_smoke.sum_loop_elf(10),
    "golden_array": lambda: _elf(_golden_array),
    "golden_gcd": lambda: _elf(_golden_gcd),
}


def _jints(arr) -> list[int]:
    return [int(v) for v in np.atleast_1d(jlimb.decode(np.asarray(arr)))]


def _frvec(arr) -> JFrVec:
    """A JAX (n, 16) Montgomery limb array as an FrVec of the same
    Montgomery bytes."""
    words = limb.from_jax_limbs(np.asarray(arr))
    return JFrVec(words.shape[0], mont=bytearray(words.numpy().tobytes()))


def _limbs(v: JFrVec):
    words = torch.frombuffer(v._mont, dtype=torch.int32).reshape(v.n, 8)
    return jnp.asarray(limb.to_jax_limbs(words))


def _host_round_evals(polys, degree):
    return jlimb.encode(JFrVec.prod_evals_adj([_frvec(p) for p in polys],
                                              degree))


def _host_fold_all(polys, r):
    r = _jints(r)[0]
    return tuple(_limbs(_frvec(p).fold_adj(r)) for p in polys)


@contextlib.contextmanager
def jax_legacy_on_host():
    """While open, zolt_tpu.zkvm.stages computes its two jitted device
    helpers on the JAX package's host tier (see the module docstring)."""
    saved = jstages._round_evals, jstages._fold_all
    jstages._round_evals, jstages._fold_all = _host_round_evals, _host_fold_all
    try:
        yield
    finally:
        jstages._round_evals, jstages._fold_all = saved


@pytest.fixture(scope="module")
def proofs(tmp_path_factory):
    """{guest: (JAX proof, JAX padded length, the ELF path)}, one JAX prove
    per guest at log_k=10, min_pad=16."""
    root = tmp_path_factory.mktemp("legacy")
    out = {}
    with jax_legacy_on_host():
        for name, build in GUESTS.items():
            path = str(root / f"{name}.elf")
            with open(path, "wb") as f:
                f.write(build())
            ref, padded = jax_prove_program(jax_run_elf(path), log_k=10,
                                            min_pad=16)
            out[name] = (ref, len(padded), path)
    return out


def _ncv(n_padded: int) -> int:
    return _ceil_log2(n_padded * rc.NUM_CONSTRAINTS)


@pytest.mark.parametrize("guest", sorted(GUESTS))
@pytest.mark.parametrize("tail", ["0", "8192"], ids=["tail0", "tail8192"])
def test_prove_program_gives_jax_bytes(proofs, guest, tail, monkeypatch):
    ref, n_padded, path = proofs[guest]
    monkeypatch.setenv("ZOLT_TPU_DEVICE_TAIL", tail)
    proof, padded = prove_program(run_elf(path), log_k=10, min_pad=16,
                                  device="cpu")
    assert len(padded) == n_padded
    blob = ser.serialize(proof)
    assert blob == jser.serialize(ref)
    assert ser.to_json(proof) == jser.to_json(ref)
    assert ser.serialize_gzip(proof) == jser.serialize_gzip(ref)
    for data in (blob, ser.serialize_gzip(proof), ser.to_json(proof).encode()):
        assert ser.serialize(ser.load_auto(data)) == blob
    assert [ser.detect_format(d) for d in (blob, gzip.compress(blob),
                                           ser.to_json(proof).encode(),
                                           b"\x00\x01")] == \
        ["native", "gzip", "json", "unknown"]
    assert verify(proof, _ncv(n_padded)) is True
    assert jax_verify(jser.deserialize(blob), _ncv(n_padded)) is True


def _verdict(fn, proof, ncv):
    try:
        return fn(proof, ncv)
    except AssertionError as e:
        return f"AssertionError: {e}"


TAMPER = {
    # tests/test_multistage.py:82-101, and one final claim a stage
    "stage1_round_poly": lambda p: p.stage_proofs[0].round_polys[3].__setitem__(
        0, (p.stage_proofs[0].round_polys[3][0] + 1) % (2 ** 200)),
    "lasso_claim": lambda p: p.stage_proofs[2].final_claims.__setitem__(
        0, p.stage_proofs[2].final_claims[0] + 1),
    "stage4_opening": lambda p: p.stage_proofs[3].final_claims.__setitem__(
        2, (p.stage_proofs[3].final_claims[2] + 1) % P),
    "stage6_final": lambda p: p.stage_proofs[5].final_claims.__setitem__(
        1, (p.stage_proofs[5].final_claims[1] + 1) % P),
}


@pytest.mark.parametrize("case", list(TAMPER))
def test_tampered_proofs_fail_with_jax_messages(proofs, case):
    ref, n_padded, _ = proofs["golden_array"]
    blob = jser.serialize(ref)
    mine, theirs = ser.deserialize(blob), jser.deserialize(blob)
    TAMPER[case](mine)
    TAMPER[case](theirs)
    got = _verdict(verify, mine, _ncv(n_padded))
    assert got == _verdict(jax_verify, theirs, _ncv(n_padded))
    assert got.startswith("AssertionError: "), got


@pytest.mark.parametrize("k", [2, 3])
def test_device_mle_sumcheck_equals_jax(monkeypatch, k):
    """Round evals (JAX's _round_evals run op by op), binds, finals and
    initial_claim of k tables of 4 entries, in the plain torch rounds
    (tail 0) and in the engine's host tail."""
    monkeypatch.setattr(jstages, "_round_evals", jstages._round_evals.__wrapped__)
    monkeypatch.setattr(jstages, "_fold_all", jstages._fold_all.__wrapped__)
    rng = np.random.default_rng(k)
    tables = [[int.from_bytes(rng.bytes(32), "little") for _ in range(4)]
              for _ in range(k)]
    ref = jstages.DeviceMleSumcheck(tables)
    for tail in ("0", "8192"):
        monkeypatch.setenv("ZOLT_TPU_DEVICE_TAIL", tail)
        got = DeviceMleSumcheck(tables, device="cpu")
        assert (got.num_rounds, got.degree) == (ref.num_rounds, ref.degree)
        assert got.initial_claim() == ref.initial_claim()
    for tail in ("0", "8192"):
        monkeypatch.setenv("ZOLT_TPU_DEVICE_TAIL", tail)
        ref = jstages.DeviceMleSumcheck(tables)
        got = DeviceMleSumcheck(tables, device="cpu")
        for r in (0x1234_5678_9ABC_DEF0_1357_9BDF, P - 5):
            assert got.round_evals() == ref.round_evals()
            got.bind(r)
            ref.bind(r)
        assert got.final_evals() == ref.final_evals()


def test_legacy_prove_needs_a_cuda_device_by_default(proofs, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prove_program(run_elf(proofs["golden_gcd"][2]), log_k=10, min_pad=16)


def test_the_device_is_never_guessed(proofs):
    """device=None raises: the legacy prover and its engine have no tier
    of their own beside "cuda" and the plain torch versions ("cpu")."""
    with pytest.raises(ValueError, match="explicit device"):
        prove_program(run_elf(proofs["golden_gcd"][2]), log_k=10, min_pad=16,
                      device=None)
    with pytest.raises(ValueError, match="explicit device"):
        DeviceMleSumcheck([[1, 2], [3, 4]], device=None)


@pytest.fixture(scope="module")
def lasso64_traces():
    """The trace of tests/test_lasso64.py's guest, emulated by each
    package."""
    from zolt_tpu.vm import Emulator as JEmulator
    from zolt_tpu.vm import MemoryConfig as JMemoryConfig
    from zolt_tpu.vm import pad_with_noop as jpad

    a = Asm()
    a.addi(1, 0, -37)
    a.addi(2, 0, 5)
    a.mul(3, 1, 2)
    a.div(4, 1, 2)
    a.rem(5, 1, 2)
    a.sub(8, 2, 1)
    a.xor(9, 1, 2)
    a.and_(10, 1, 2)
    a.or_(11, 1, 2)
    a.sll(12, 2, 2)
    a.srl(13, 1, 2)
    a.sra(14, 1, 2)
    a.sltu(15, 1, 2)
    a.slt(16, 1, 2)
    a.jal(0, 0)
    out = []
    for emu_cls, cfg, pad in ((Emulator, MemoryConfig, pad_with_noop),
                              (JEmulator, JMemoryConfig, jpad)):
        emu = emu_cls(cfg(program_size=1024))
        emu.load_program(a.bytes())
        emu.run()
        out.append(pad(list(emu.trace)))
    return out


def test_lasso64_round_trips_every_traced_table_as_jax(lasso64_traces):
    """tests/test_lasso64.py:52 in both packages: each traced table's proof
    (out claim, both phases' round polys, w claim) equals JAX's, both
    verifiers accept it, and a tampered address round fails both."""
    trace, jtrace = lasso64_traces
    n = len(trace).bit_length() - 1
    rng = random.Random(42)
    r_cycle = [rng.randrange(P) for _ in range(n)]
    tables = sorted(LookupTraceCollector().collect(trace).by_table().keys())
    assert len(tables) >= 6
    for table in tables:
        entries = lasso64.collect_table_entries(trace, table)
        assert entries == jlasso64.collect_table_entries(jtrace, table)
        got = lasso64.prove_lasso64(Blake2bTranscript(b"lasso64"), entries,
                                    table, r_cycle, n)
        ref = jlasso64.prove_lasso64(JBlake2b(b"lasso64"), entries, table,
                                     r_cycle, n)
        assert (got.table, got.addr_polys, got.cycle_polys, got.w_claim,
                got.out_claim) == (ref.table, ref.addr_polys, ref.cycle_polys,
                                   ref.w_claim, ref.out_claim), table.name
        assert lasso64.verify_lasso64(Blake2bTranscript(b"lasso64"), got,
                                      r_cycle, n, got.out_claim)
        assert jlasso64.verify_lasso64(JBlake2b(b"lasso64"), got, r_cycle, n,
                                       got.out_claim)
    bad = copy.deepcopy(got)
    bad.addr_polys[64][0] = (bad.addr_polys[64][0] + 1) % P
    assert not lasso64.verify_lasso64(Blake2bTranscript(b"lasso64"), bad,
                                      r_cycle, n)
    assert not jlasso64.verify_lasso64(JBlake2b(b"lasso64"), bad, r_cycle, n)


@pytest.mark.slow
def test_jax_legacy_digest_of_the_chip_smoke_guest(tmp_path):
    """Recompute the digest chip_smoke.py holds the GPU's legacy prove to:
    zolt_tpu's prove_program (its jitted helpers on its host tier) on the
    sum-loop guest at T = 2^16, log_k = chip_smoke.LEGACY_LOG_K."""
    path = str(tmp_path / "sum_loop_t16.elf")
    with open(path, "wb") as f:
        f.write(chip_smoke.sum_loop_elf(16))
    with jax_legacy_on_host():
        proof, _ = jax_prove_program(jax_run_elf(path),
                                     log_k=chip_smoke.LEGACY_LOG_K)
    digest = hashlib.sha256(jser.serialize(proof)).hexdigest()
    assert digest == chip_smoke.JAX_LEGACY_DIGEST_T16
