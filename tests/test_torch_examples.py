"""Run the port's examples (examples/torch_*.py) with --device cpu, as a
user would from the repository root, and check their verdicts: the
internal prover's example prints what the JAX package's
examples/simple_proof.py prints (the same proof size and stage rounds),
on the plain torch versions of the kernels; with no --device it runs on
the GPU, and raises where there is none. A few seconds in all on an
8-core CPU box.
"""

import contextlib
import io
import os
import runpy
import sys

import pytest
import torch

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")

torch.set_num_threads(1)


def _run(name: str, argv) -> str:
    out = io.StringIO()
    saved = sys.argv
    sys.argv = [name, *argv]
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(os.path.join(EXAMPLES, name), run_name="__main__")
    finally:
        sys.argv = saved
    return out.getvalue()


@pytest.mark.parametrize("device", ["cpu"])
def test_torch_simple_proof_verifies_as_the_jax_example(device):
    got = _run("torch_simple_proof.py", ["--device", device])
    assert got.endswith("verified ✔\n")
    assert got == _run("simple_proof.py", [])


def test_torch_simple_proof_runs_on_the_gpu_by_default():
    if torch.cuda.is_available():
        assert _run("torch_simple_proof.py", []) == \
            _run("simple_proof.py", [])
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _run("torch_simple_proof.py", [])


def test_torch_sumcheck_protocol_verifies():
    got = _run("torch_sumcheck_protocol.py", ["--device", "cpu"])
    claim = sum((i * 7 + 3) * (i * i + 1) for i in range(16))
    assert got == (f"claim: sum_i a_i * b_i = {claim:#x}\n"
                   f"rounds: 4, verified: True\n")


# The port's examples that print what their JAX namesakes print on the same
# input, run beside them here (JAX's on its host tiers: below 2^14 points
# its MSMs stay on the host).
SAME_OUTPUT = {"torch_hyperkzg_commitment.py": "hyperkzg_commitment.py",
               "torch_risc_v_emulation.py": "risc_v_emulation.py"}


@pytest.mark.parametrize("name", sorted(SAME_OUTPUT))
def test_torch_example_prints_what_the_jax_example_prints(name):
    assert _run(name, ["--device", "cpu"]) == _run(SAME_OUTPUT[name], [])


def test_torch_field_arithmetic_prints_the_jax_example_text():
    """examples/field_arithmetic.py prints products of its inputs (seed 42)
    that it asserts equal to Python's ints, and asserts its batch inverse
    the same way; its jitted batch_inverse compiles for about 12 s, so its
    text is rebuilt here from the same inputs."""
    import numpy as np

    from zolt_tpu.field.params import FR

    rng = np.random.default_rng(42)
    xs = [int.from_bytes(rng.bytes(40), "little") % FR.p for _ in range(8)]
    ys = [int.from_bytes(rng.bytes(40), "little") % FR.p for _ in range(8)]
    want = ["BN254 scalar field (Fr)", f"  p = {FR.p:#x}"]
    want += [f"  x[{i}]*y[{i}] mod p = {xs[i] * ys[i] % FR.p:#x}"
             for i in range(3)]
    want.append("device results match the host oracle ✔")
    assert _run("torch_field_arithmetic.py", ["--device", "cpu"]) == \
        "\n".join(want) + "\n"


def test_torch_device_prove_prints_the_jax_example_text():
    """examples/device_prove.py proves its sum 1..30 guest on JAX's host
    tier and its device tier (which it asserts byte-identical) and prints
    the host proof's size twice; its device tier compiles XLA for about
    35 s, so its text is rebuilt from its host-tier prove of the same
    guest. The port's example proves on the host tier and, with
    device="cpu", on the plain versions of the kernels."""
    import tempfile

    from zolt_tpu.vm import elf as elf_mod
    from zolt_tpu.vm.guest import Asm
    from zolt_tpu.vm.layout import MemoryConfig, MemoryLayout
    from zolt_tpu.zkvm.pipeline import prove_jolt as jax_prove_jolt

    lay = MemoryLayout.create(MemoryConfig(program_size=1024))
    a = Asm()
    a.addi(1, 0, 30)
    a.label("loop")
    a.add(2, 2, 1)
    a.addi(1, 1, -1)
    a.bne(1, 0, "loop")
    a.halt(lay, provable=True)
    with tempfile.NamedTemporaryFile(suffix=".elf") as f:
        f.write(elf_mod.write_minimal_elf(a.bytes()))
        f.flush()
        n = len(jax_prove_jolt(f.name).conv.proof.serialize_with_dory())
    assert _run("torch_device_prove.py", ["--device", "cpu"]) == (
        f"host proof:   {n} bytes\ndevice proof: {n} bytes\n"
        f"byte-identical: True\n")


@pytest.fixture
def sum_loop_elf(tmp_path):
    """The repository bench's sum-loop guest at T = 2^10 (bench.py's loop,
    chip_smoke.sum_loop_elf), in a temporary file."""
    import chip_smoke

    path = str(tmp_path / "sum_loop.elf")
    with open(path, "wb") as f:
        f.write(chip_smoke.sum_loop_elf(10))
    return path


def test_torch_full_pipeline_prints_what_the_jax_example_prints(
        sum_loop_elf):
    got = _run("torch_full_pipeline.py", [sum_loop_elf, "--device", "cpu"])
    assert got == _run("full_pipeline.py", [sum_loop_elf])
    assert got.startswith("trace: ") and "serialized proof: " in got


NEW_EXAMPLES = ["torch_device_prove.py", "torch_field_arithmetic.py",
                "torch_full_pipeline.py", "torch_hyperkzg_commitment.py",
                "torch_risc_v_emulation.py"]


@pytest.mark.parametrize("name", NEW_EXAMPLES)
def test_new_examples_run_on_the_gpu_by_default(name, sum_loop_elf):
    argv = [sum_loop_elf] if name == "torch_full_pipeline.py" else []
    if torch.cuda.is_available():
        assert _run(name, argv)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _run(name, argv)
