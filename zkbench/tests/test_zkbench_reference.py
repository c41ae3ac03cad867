"""The reference verifier takes the program's compat proof of a guest and its
claims about the execution, and each change to the proof, or to the public
I/O it is judged against, is caught by the check named for it. One proof at
T = 2^9, made by the program on the CPU."""

import os

import pytest

from zkbench import guest
from zkbench.harness import ZKBENCH, load_json
from zkbench.reference import rv64, verify

LOG_T = 9


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    from zolt_tpu_torch.zkvm.pipeline import prove_jolt

    cfg = load_json("configs", "jolt_compat.json")
    path = os.path.join(tmp_path_factory.mktemp("g"), "g.elf")
    with open(path, "wb") as f:
        f.write(guest.guest_elf(guest.load_mix("mem", ZKBENCH), LOG_T,
                                2 ** 31 + 77, 0))
    res = prove_jolt(path, sound=False, memory_size=cfg["memory_size"],
                     backend="device", device="cpu")
    with open(path, "rb") as f:
        run = rv64.run(f.read())
    return cfg, res.conv.proof, run


def _judge(cfg, blob, run, outputs=None, length=None):
    checked = verify.check(
        blob, outputs=run.outputs if outputs is None else outputs,
        panic=run.panic, memory_size=cfg["memory_size"],
        log_ram_k=cfg["log_ram_k"],
        trace_length=run.padded_length if length is None else length)
    return verify.execution_claims(checked, run, cfg["log_ram_k"])


def test_the_programs_proof_verifies_and_its_claims_are_the_executions(made):
    cfg, proof, run = made
    assert run.padded_length == 1 << LOG_T
    assert _judge(cfg, proof.serialize(), run) == []


def _claim(proof, name, sid):
    from zolt_tpu_torch.zkvm.jolt_types import OpeningId, VirtualPolynomial

    return OpeningId.virtual(VirtualPolynomial.named(name), sid)


def _alter(proof, what):
    """A copy of the proof's bytes with one thing changed."""
    import copy

    from zolt_tpu_torch.zkvm.jolt_types import SumcheckId

    p = copy.deepcopy(proof)
    if what == "commitment":
        c = bytearray(p.commitments[3])
        c[100] ^= 1
        p.commitments[3] = bytes(c)
    elif what == "stage1_round":
        p.stage1_sumcheck.compressed_polys[2][1] += 1
    elif what == "stage1_skip":
        p.stage1_uni_skip.uni_poly[0] += 1
    elif what == "stage2_round":
        p.stage2_sumcheck.compressed_polys[-1][0] += 1
    elif what == "stage2_skip":
        p.stage2_uni_skip.uni_poly[5] += 1
    elif what == "stage5_nonzero":
        p.stage5_sumcheck.compressed_polys[0][0] = 1
    elif what in ("RamValFinal", "RamValInit"):
        oid = _claim(p, what, SumcheckId.RamOutputCheck)
        p.opening_claims.insert(oid, p.opening_claims.get(oid) + 1)
    elif what == "UnexpandedPC":
        oid = _claim(p, what, SumcheckId.SpartanOuter)
        p.opening_claims.insert(oid, p.opening_claims.get(oid) + 4)
    blob = p.serialize()
    return blob + b"\0" if what == "trailing_byte" else blob


@pytest.mark.parametrize("what", [
    "commitment", "stage1_round", "stage1_skip", "stage2_skip",
    "stage5_nonzero", "UnexpandedPC", "trailing_byte"])
def test_a_changed_proof_is_rejected(made, what):
    cfg, proof, run = made
    with pytest.raises(verify.Reject):
        _judge(cfg, _alter(proof, what), run)


@pytest.mark.parametrize("what", ["stage2_round", "RamValFinal", "RamValInit"])
def test_a_changed_claim_after_stage_2_differs_from_the_execution(made, what):
    # the last stage-2 round moves the output point, so the RAM tables'
    # claims no longer hold there; the claims themselves, changed, likewise
    cfg, proof, run = made
    assert _judge(cfg, _alter(proof, what), run) != []


@pytest.mark.parametrize("io", ["outputs", "trace_length"])
def test_other_public_io_is_rejected(made, io):
    cfg, proof, run = made
    with pytest.raises(verify.Reject):
        if io == "outputs":
            _judge(cfg, proof.serialize(), run, outputs=run.outputs[:-1] + b"\1")
        else:
            _judge(cfg, proof.serialize(), run, length=2 << LOG_T)


def test_the_transcript_is_jolts():
    # upstream zolt's log of its fibonacci run (logs/zolt.log:1163-1188):
    # the state after the sizes, after the (empty) inputs, after the outputs
    tp = verify.Transcript(b"Jolt")
    for v in (4096, 4096, 32768):
        tp.u64(v)
    assert tp.state[:8].hex() == "ce55d444de489554"
    tp.raw(b"")
    assert tp.state[:8].hex() == "e724bd96416d4e39"
    tp.raw(b"")
    assert tp.state[:8].hex() == "cfcf19f2ffb0c721"


def test_the_constraints_hold_on_a_plain_add_cycle():
    w = {n: 0 for n in verify.INPUTS}
    w.update({f"flag.{n}": 0 for n in verify.FLAGS})
    w.update({"flag.AddOperands": 1, "flag.WriteLookupOutputToRD": 1,
              "LeftInstructionInput": 5, "RightInstructionInput": 7,
              "RightLookupOperand": 12, "LookupOutput": 12,
              "WriteLookupOutputToRD": 1, "RdWriteValue": 12,
              "UnexpandedPC": 100, "NextUnexpandedPC": 104, "PC": 100,
              "NextPC": 104, "Product": 35})
    assert [g * d for g, d in verify.constraints(w)] == [0] * 19
    w["RdWriteValue"] = 13
    assert [i for i, (g, d) in enumerate(verify.constraints(w))
            if g * d] == [12]
