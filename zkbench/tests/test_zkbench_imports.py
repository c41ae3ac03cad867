"""Nothing the runner or the reference loads is JAX or the JAX package, and
the reference loads nothing of the program. Top-level names are compared
whole: the program's name begins with the JAX package's."""

import json
import subprocess
import sys

from conftest import ROOT

RUN = """
import json, sys
sys.path.insert(0, {root!r})
from zkbench import harness
cfg = harness.load_json("configs", "jolt_compat.json"); cfg["log_t"] = 9
res = harness.run_cell("jolt_compat.mem_t14", 3, 0.01, False, device="cpu",
                       config=cfg)
import zkbench.run
print(json.dumps([res["correct"], sorted({{m.split(".")[0] for m in sys.modules}})]))
"""

REF = """
import json, sys
sys.path.insert(0, {root!r})
from zkbench import guest
from zkbench.reference import judge
elf = guest.guest_elf(guest.load_mix("mem", {zk!r}), 9, 4, 0)
with open({blob!r}, "rb") as f:
    rec = dict(index=0, blob=f.read(), outputs=None, panic=False, trace_length=512)
def path_of(i):
    with open({elf!r}, "wb") as f:
        f.write(elf)
    return {elf!r}
checks, notes, bad = judge.judge([rec], path_of, dict(memory_size=32768, log_ram_k=16), 4)
print(json.dumps([[c["value"] for c in checks.values()], sorted({{m.split(".")[0] for m in sys.modules}})]))
"""


def _top_names(code: str) -> tuple:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return tuple(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_runner_loads_no_jax_and_no_jax_package():
    correct, names = _top_names(RUN.format(root=ROOT))
    assert correct is True
    assert "zolt_tpu_torch" in names
    assert not {"jax", "jaxlib", "flax", "zolt_tpu"} & set(names)


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    from zkbench import guest
    from zolt_tpu_torch.zkvm.pipeline import prove_jolt

    elf, blob = str(tmp_path / "g.elf"), str(tmp_path / "g.proof")
    with open(elf, "wb") as f:
        f.write(guest.guest_elf(guest.load_mix("mem", ROOT + "/zkbench"), 9,
                                4, 0))
    res = prove_jolt(elf, memory_size=32768, backend="device", device="cpu")
    with open(blob, "wb") as f:
        f.write(res.conv.proof.serialize())
    values, names = _top_names(REF.format(root=ROOT, zk=ROOT + "/zkbench",
                                          blob=blob, elf=elf))
    # judged against the reference's own run: io differs only in the outputs
    # this record leaves out; the proof verifies and its claims hold
    assert values == [0, 1, 0, 0]
    assert not {"jax", "jaxlib", "flax", "zolt_tpu", "zolt_tpu_torch",
                "torch", "numpy"} & set(names)
    assert "zkbench" in names
