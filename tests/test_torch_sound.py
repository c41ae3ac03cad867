"""The port's sound prover: stages 1-12 and the PCS batch opening give the
JAX package's sound proof bytes.

`zolt_tpu_torch.zkvm.pipeline.prove_jolt(elf, sound=True)` on the device
path (`backend="device", device="cpu"`: every engine round on the kernels'
plain torch versions, the host tail pinned to 0) and on the host tier
(`backend="host"`) against `zolt_tpu`'s host-tier sound prove, which
compiles no XLA; the port's proof must pass the JAX package's
`verify_jolt`. A guest with the div family takes the virtual-sequence
path. The batch opening alone is held to the JAX package's host version
on random claims made from a numpy seed. Tolerance: byte-equal
proofs and equal transcript states.
"""

import numpy as np
import pytest
import torch

from test_torch_slice import GUESTS
from zolt_tpu.native.frvec import FrVec as JaxFrVec
from zolt_tpu.pcs import batch as jax_batch
from zolt_tpu.pcs import dory as jax_dory
from zolt_tpu.transcript import Blake2bTranscript as JaxTranscript
from zolt_tpu.zkvm.jolt_deserialize import deserialize_jolt_proof
from zolt_tpu.zkvm.jolt_verifier import verify_jolt
from zolt_tpu.zkvm.pipeline import prove_jolt as jax_prove_jolt
from zolt_tpu_torch.native.frvec import FrVec
from zolt_tpu_torch.parallel import stage_engine
from zolt_tpu_torch.pcs import batch, dory
from zolt_tpu_torch.transcript import Blake2bTranscript
from zolt_tpu_torch.zkvm.pipeline import prove_jolt

torch.set_num_threads(1)

P = batch.P


@pytest.fixture(scope="module", params=sorted(GUESTS))
def guest(request, tmp_path_factory):
    """The guest's ELF path, the JAX package's sound proof (canonical and
    with-Dory bytes) and the port's device-path sound proof at tail 0."""
    name = request.param
    path = str(tmp_path_factory.mktemp("sound") / f"{name}.elf")
    with open(path, "wb") as f:
        f.write(GUESTS[name]())
    ref = jax_prove_jolt(path, sound=True).conv.proof
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ZOLT_TPU_DEVICE_TAIL", "0")
        dev = prove_jolt(path, sound=True, backend="device",
                         device="cpu").conv.proof
    return {"path": path, "ref": ref, "dev": dev}


def test_sound_device_prove_matches_jax_bytes(guest):
    ref, dev = guest["ref"], guest["dev"]
    assert dev.batch_opening is not None and dev.lookups_ext is not None
    assert dev.lookups_ext == ref.lookups_ext
    assert dev.batch_opening == ref.batch_opening
    assert dev.serialize() == ref.serialize()
    assert dev.serialize_with_dory() == ref.serialize_with_dory()


def test_sound_host_prove_matches_jax_bytes(guest):
    host = prove_jolt(guest["path"], sound=True, backend="host").conv.proof
    assert host.serialize_with_dory() == guest["ref"].serialize_with_dory()


def test_port_sound_proof_passes_jax_verifier(guest):
    proof = deserialize_jolt_proof(guest["dev"].serialize())
    assert proof.batch_opening == guest["dev"].batch_opening
    assert verify_jolt(proof, guest["path"])


def _div_family_elf() -> bytes:
    """A guest with the div family, divides by zero included: sound mode
    traces them as virtual sequences (vm/virtual.py, the Python tier; the
    native stepper declines such programs), so the witness takes slot PCs
    and its scalar path, and stage 3 builds its device tables from the
    FrVec columns."""
    from zolt_tpu.vm import elf as elf_mod
    from zolt_tpu.vm.guest import Asm
    from zolt_tpu.vm.layout import MemoryConfig, MemoryLayout

    lay = MemoryLayout.create(MemoryConfig(program_size=4096))
    a = Asm()
    a.li_addr(5, 0x80002000)
    a.addi(1, 0, 100)
    a.addi(2, 0, 7)
    a.div(6, 1, 2)
    a.rem(7, 1, 2)
    a.add(3, 6, 7)
    a.divw(8, 1, 2)
    a.add(3, 3, 8)
    a._r(0x3B, 11, 5, 1, 2, 1)   # divuw
    a.add(3, 3, 11)
    a.addi(2, 0, 0)
    a.divu(9, 1, 2)              # unsigned divide by zero
    a.rem(10, 1, 2)              # signed rem by zero
    a.add(3, 3, 10)
    a.sd(5, 3, 0)
    a.halt(lay, provable=True)
    return elf_mod.write_minimal_elf(a.bytes())


def test_sound_prove_of_a_div_family_guest_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("ZOLT_TPU_DEVICE_TAIL", "0")
    path = str(tmp_path / "div_family.elf")
    with open(path, "wb") as f:
        f.write(_div_family_elf())
    res = jax_prove_jolt(path, sound=True)
    assert any(s.seq_pos for s in res.padded_steps)
    ref = res.conv.proof.serialize_with_dory()
    for kw in ({"backend": "device", "device": "cpu"}, {"backend": "host"}):
        got = prove_jolt(path, sound=True, **kw)
        assert any(s.seq_pos for s in got.padded_steps)
        assert got.conv.proof.serialize_with_dory() == ref


def test_both_packages_refuse_a_guest_without_a_termination_store(tmp_path):
    """Sound mode needs the guest to store the termination word itself."""
    from golden_programs import _golden_array
    from zolt_tpu.vm import elf as elf_mod
    from zolt_tpu.vm.layout import MemoryConfig, MemoryLayout

    lay = MemoryLayout.create(MemoryConfig(program_size=1024))
    a = _golden_array(lay)
    a.halt(None, provable=True)     # a self-loop with no termination store
    path = str(tmp_path / "unprovable.elf")
    with open(path, "wb") as f:
        f.write(elf_mod.write_minimal_elf(a.bytes()))
    msgs = []
    for prove, kw in ((jax_prove_jolt, {}),
                      (prove_jolt, {"backend": "device", "device": "cpu"}),
                      (prove_jolt, {"backend": "host"})):
        with pytest.raises(ValueError, match="termination") as e:
            prove(path, sound=True, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == msgs[2]


# ---------------------------------------------------------------------------
# The batch opening alone
# ---------------------------------------------------------------------------

N = 8
# (point length, table length, table index): 27 claims over 25 tables.
# Claims 1 and 2 share a table at one point length (one merged group);
# table 21 is opened at two point lengths (two groups, one joint
# coefficient). 18 groups awake from round 0, more than the 16 a launch
# takes; a group with n_i < N wakes at round N - n_i; a table of 4
# entries stays on the host; short tables are zero-padded.
SPECS = ([(8, 256, 0), (8, 256, 1), (8, 256, 1)]
         + [(8, 256, 2 + i) for i in range(15)]
         + [(8, 200, 17), (7, 128, 18), (6, 64, 19), (6, 40, 20),
            (6, 32, 21), (5, 32, 21), (4, 16, 22), (3, 8, 23), (2, 4, 24)])


def _claims(seed: int):
    """The same claims for both packages: (port claims, JAX claims)."""
    rng = np.random.default_rng(seed)

    def scalar():
        return int.from_bytes(rng.bytes(32), "little") % P

    tables = {}
    for _, m, ti in SPECS:
        tables.setdefault(ti, [scalar() for _ in range(m)])
    port_tabs = {ti: FrVec.from_ints(v) for ti, v in tables.items()}
    jax_tabs = {ti: JaxFrVec.from_ints(v) for ti, v in tables.items()}
    port, ref = [], []
    for n_i, m, ti in SPECS:
        q = [scalar() for _ in range(n_i)]
        v = batch.mle_eval_be(tables[ti][:m], q)
        port.append(batch.BatchClaim(b"", q, v, evals=port_tabs[ti]))
        ref.append(jax_batch.BatchClaim(b"", q, v, evals=jax_tabs[ti]))
    return port, ref


def _prove(mod, transcript_cls, srs, claims, **kw):
    t = transcript_cls(b"batch")
    t.append_scalar(12345)
    proof = mod.prove_batch_opening(t, claims, srs, N, **kw)
    return mod.serialize_batch_opening(proof), (t.state, t.n_rounds)


@pytest.mark.parametrize("tail", [0, 16])
def test_batch_opening_matches_jax_host_version(monkeypatch, tail):
    """Tail 0: every group above 4 entries runs every round in the engines;
    tail 16: the engines hand their last rounds to the host. Every round
    evaluates all device groups in one round_evals_many call."""
    monkeypatch.setenv("ZOLT_TPU_DEVICE_TAIL", str(tail))
    port_claims, ref_claims = _claims(20261017)
    ref = _prove(jax_batch, JaxTranscript, jax_dory.setup(N), ref_claims)
    srs = dory.setup(N)
    calls = []
    many = stage_engine.round_evals_many

    def spy(engines):
        calls.append(len(engines))
        return many(engines)

    monkeypatch.setattr(stage_engine, "round_evals_many", spy)
    assert _prove(batch, Blake2bTranscript, srs, port_claims,
                  backend="device", device="cpu") == ref
    # one call a round with every device group awake: 18 from round 0, the
    # dormant ones join at round N - n_i (those above the tail: n_i >= 3 at
    # tail 0, n_i >= 5 at tail 16). An engine whose tail has moved to the
    # host gets its evals through a call of its own.
    rounds = [c for c in calls if c > 1]
    assert len(rounds) == N and rounds[0] == 18
    assert rounds[-1] == (25 if tail == 0 else 23)
    monkeypatch.setattr(stage_engine, "round_evals_many", many)
    assert _prove(batch, Blake2bTranscript, srs, port_claims) == ref
