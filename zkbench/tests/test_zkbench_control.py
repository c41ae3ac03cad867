"""The comparison that decides `correct` can fail: the control (the program
with the commitments left out of its transcript) and the timed path broken
underneath the harness (a byte of each proof altered where it is produced; a
prove that hands back its first proof every time) all read as not correct,
and the unbroken path as correct. Small sizes on the CPU; zkbench/control.py
runs the control at the cells' own sizes."""

import pytest

from zkbench import control, harness
from zkbench.reference import judge

CELLS = [w["name"] for w in harness.load_bench()["workloads"]]


def _small(cell):
    w = next(x for x in harness.load_bench()["workloads"] if x["name"] == cell)
    cfg = harness.load_json("configs", f"{w['config']}.json")
    cfg["log_t"] = 9
    return cfg


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_and_the_program_is(cell):
    cfg = _small(cell)
    bad = control.judge_control(cell, 11, 2, config=cfg, device="cpu")
    assert not judge.is_correct(bad)
    assert bad["rejected"]["value"] == 2
    good = control.judge_control(cell, 11, 2, config=cfg, broken=False,
                                 device="cpu")
    assert judge.is_correct(good), good


def _flip_a_byte(prove_jolt):
    def prove(*a, **k):
        res = prove_jolt(*a, **k)
        blob = bytearray(res.conv.proof.serialize())
        blob[len(blob) // 2] ^= 1
        res.conv.proof.serialize = lambda: bytes(blob)
        return res
    return prove


def _first_proof_again(prove_jolt):
    first = []

    def prove(*a, **k):
        res = prove_jolt(*a, **k)       # the work is done, its result dropped
        if not first:
            first.append(res)
        return first[0]
    return prove


@pytest.mark.parametrize("fault", [None, _flip_a_byte, _first_proof_again])
def test_a_broken_timed_path_reads_as_not_correct(fault):
    from zolt_tpu_torch.zkvm.pipeline import prove_jolt

    cell = "jolt_compat.mem_t14"
    res = harness.run_cell(cell, 2 ** 31 + 9, 8.0, False, device="cpu",
                           config=_small(cell),
                           prove_jolt=fault(prove_jolt) if fault else None)
    assert res["attempted"] >= 2
    assert res["correct"] is (fault is None), res["checks"]
    if fault is not None:           # the warm-up's proof comes back too
        assert res["failed"] == res["attempted"]
        assert res["metrics"]["prove_cycles_per_s"]["value"] == 0


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's runs need the card")
    import json
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "zkbench/run.py", "--workload",
                          "jolt_compat.mem_t14", "--seed", "2147483999",
                          "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=600,
                         cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
