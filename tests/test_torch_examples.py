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
