"""The port's `bench` (zolt_tpu_torch/benchmarks.py and the CLI's `bench`)
on the CPU: `python -m zolt_tpu_torch bench --quick --only ... --device
cpu` prints each section's header and report lines as the JAX package's
bench does (its emulator section, run beside it, prints the same lines;
the prover section skips with JAX's line without a guest, and with
`--elf` proves and verifies an in-repo sum-loop guest on the internal
prover), the sections the card alone can measure say they skipped, and
with no --device the bench raises where there is no CUDA device. The
figures are the CPU's and are not checked. About 25 s on an 8-core CPU
box, most of it the plain batch inversion of 2^12 elements and the
internal prove.
"""

import contextlib
import io
import re

import pytest
import torch

from zolt_tpu_torch.__main__ import main
from zolt_tpu_torch.benchmarks import _sum_loop_elf

torch.set_num_threads(1)


def _bench(argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["bench", *argv]) == 0
    return out.getvalue()


def _jax_bench(sections) -> list[str]:
    from zolt_tpu.benchmarks import run_benchmarks

    lines = []
    run_benchmarks(sections=set(sections), quick=True, report=lines.append)
    return lines


def _shape(line: str) -> str:
    """A report line with its figures blanked and its runs of spaces (which
    pad the figures) cut to one."""
    return re.sub(r" +", " ", re.sub(r"[0-9]+(\.[0-9]+)?", "#", line))


def test_bench_prints_the_jax_sections_on_the_cpu():
    got = _bench(["--quick", "--only", "field,poly,emulator,prover",
                  "--device", "cpu"]).splitlines()
    assert got[:3] == ["zolt-tpu-torch benchmarks v0.1.0", "=" * 32,
                       "device: cpu"]
    assert got[-1] == "Benchmarks complete."
    want = ["Field Arithmetic (BN254 Fr, batch n=4096):",
            *[f"  {op:<14} # ns/elem   (    # M elem/s)"
              for op in ("add", "sub", "mont_mul", "mont_sqr",
                         "batch_inverse")],
            "", "Polynomial Operations:"]
    for log_n in (10, 12):
        want += [f"  bind_low (n=2^{log_n})  # us/op",
                 f"  mle_eval (n=2^{log_n})  # us/op"]
    assert [_shape(ln) for ln in got[4:4 + len(want)]] == \
        [_shape(ln) for ln in want]
    # the emulator section: JAX's lines; the prover section, with no
    # guest given: JAX's skip line
    jax = _jax_bench(["emulator"])
    i = got.index("Emulator Execution:")
    assert got[i] == jax[2]
    assert _shape(got[i + 1]) == _shape(jax[3])
    assert got[i + 3] == "zkVM Prover: fibonacci.elf not present, skipped"


def test_bench_prover_proves_the_guest_it_is_given(tmp_path):
    """`--elf` names the prover section's guest: it is proved on the
    internal prover, serialized and verified (verify_internal raises on a
    proof it rejects), with JAX's report lines."""
    elf = tmp_path / "sum_loop.elf"
    elf.write_bytes(_sum_loop_elf(10))
    got = _bench(["--quick", "--only", "prover", "--elf", str(elf),
                  "--device", "cpu"]).splitlines()
    assert [_shape(ln) for ln in got[4:8]] == [
        "zkVM Prover (sum_loop.elf, internal #-stage):",
        " prove # ms/op", " proof size # bytes", " verify # ms/op"]
    assert int(got[6].split()[2]) > 0
    assert got[-1] == "Benchmarks complete."


def test_bench_card_sections_skip_on_the_cpu():
    got = _bench(["--quick", "--only", "scaling,roofline,mesh,chipcheck",
                  "--device", "cpu"]).splitlines()
    assert "Sumcheck round scaling (2-factor product, eval + fold kernels):" \
        in got
    assert sum(ln.startswith("  round (T=2^") for ln in got) == 2
    assert "Roofline: skipped on the CPU (the bounds are the H100's)" in got
    assert "Mesh scaling (sharded sumcheck round, T=2^14, 1 device(s) " \
           "visible):" in got
    assert "  (>1 device required to measure cross-chip scaling)" in got
    assert "Chip exactness: SKIPPED (no CUDA device in use)" in got


def test_bench_runs_on_the_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: bench runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["bench", "--only", "emulator"])
    with pytest.raises(ValueError, match="unknown bench sections"):
        main(["bench", "--only", "emulator,nonsense", "--device", "cpu"])
