"""The slice end to end: the port's Jolt-format prove on its device path gives
the JAX package's proof bytes.

`zolt_tpu_torch.zkvm.pipeline.prove_jolt(elf, backend="device",
device="cpu")` runs every sumcheck round of stages 1-4 through the port's
engines (the tail handoff pinned to 0), here on the kernels' plain torch
versions; `backend="host"` runs the host C tier. (By default prove_jolt
runs on "cuda".) The reference is `zolt_tpu`'s host-tier prove, which
compiles no XLA and is what the JAX package holds its own device path to.
Tolerance: the serialized proofs are byte-equal.
"""

import hashlib
import os
import subprocess
import sys

import pytest
import torch

import chip_smoke
from golden_programs import _golden_array

from zolt_tpu.vm.layout import MemoryConfig, MemoryLayout
from zolt_tpu.zkvm.pipeline import prove_jolt as jax_prove_jolt
from zolt_tpu_torch.zkvm.pipeline import prove_jolt

# The tensors here are tiny: torch's worker threads would only spin, and
# they doubled the CPU seconds of the port's tests.
torch.set_num_threads(1)

LAY = MemoryLayout.create(MemoryConfig(program_size=1024))


def _golden_array_elf() -> bytes:
    from zolt_tpu.vm import elf as elf_mod

    a = _golden_array(LAY)
    a.halt(LAY, tmp=30, one=31, provable=True)
    return elf_mod.write_minimal_elf(a.bytes())


GUESTS = {
    "sum_loop_t10": lambda: chip_smoke.sum_loop_elf(10),
    "golden_array": _golden_array_elf,
}


@pytest.mark.parametrize("guest", sorted(GUESTS))
def test_device_prove_matches_jax_bytes(tmp_path, monkeypatch, guest):
    monkeypatch.setenv("ZOLT_TPU_DEVICE_TAIL", "0")
    path = str(tmp_path / f"{guest}.elf")
    with open(path, "wb") as f:
        f.write(GUESTS[guest]())
    ref = jax_prove_jolt(path).conv.proof.serialize_with_dory()
    dev = prove_jolt(path, backend="device", device="cpu")
    assert dev.conv.proof.serialize_with_dory() == ref
    host = prove_jolt(path, backend="host").conv.proof.serialize_with_dory()
    assert host == ref


def test_prove_jolt_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """Every option prove_jolt does not honour raises; stage1_backend is
    honoured on every backend (stage 1's remaining rounds on the tier it
    names, the JAX package's bytes), never ignored. The mesh, once refused
    here, proves on a mesh of two "cpu" shards (tests/test_torch_mesh.py
    holds it to JAX at more sizes)."""
    from zolt_tpu_torch.parallel import make_mesh
    from zolt_tpu_torch.zkvm import streaming_outer

    path = str(tmp_path / "g.elf")
    with open(path, "wb") as f:
        f.write(_golden_array_elf())
    for backend in ("device", "host", "mesh"):
        with pytest.raises(ValueError, match="stage1_backend"):
            prove_jolt(path, backend=backend, device="cpu",
                       stage1_backend="gpu")
    with pytest.raises(ValueError, match="explicit device"):
        prove_jolt(path, backend="device", device=None)
    with pytest.raises(ValueError, match="explicit device"):
        prove_jolt(path, backend="host", device=None, stage1_backend="device")
    for backend in ("gpu", None):
        with pytest.raises(ValueError, match="'device', 'host' or 'mesh'"):
            prove_jolt(path, backend=backend)
    # the tier each stage-1 prover was built for
    tiers = []
    init = streaming_outer.StreamingOuterProver.__init__

    def spy(self, *a, backend="host", **kw):
        tiers.append(backend)
        init(self, *a, backend=backend, **kw)

    monkeypatch.setattr(streaming_outer.StreamingOuterProver, "__init__", spy)
    monkeypatch.setenv("ZOLT_TPU_DEVICE_TAIL", "0")
    ref = jax_prove_jolt(path).conv.proof.serialize_with_dory()
    mesh = make_mesh(["cpu"] * 2)
    for backend, s1 in (("host", "device"), ("device", "host"),
                        ("mesh", None), ("device", "mesh"),
                        ("host", "mesh")):
        tiers.clear()
        got = prove_jolt(path, backend=backend, device="cpu",
                         stage1_backend=s1, mesh=mesh)
        assert got.conv.proof.serialize_with_dory() == ref
        # the first prover runs the UniSkip round, the second the rest
        assert tiers[-1] == (s1 or backend)
    # the default is the GPU, and without one it raises: no fallback, in
    # either mode
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    for sound in (False, True):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            prove_jolt(path, sound=sound)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, chip_smoke.py and the port's examples
    (examples/torch_*.py, loaded without running), imported in a fresh
    interpreter (this process has both loaded through tests/conftest.py)."""
    code = (
        "import glob, importlib, pkgutil, runpy, sys\n"
        "import zolt_tpu_torch\n"
        "for m in pkgutil.walk_packages(zolt_tpu_torch.__path__,\n"
        "                               'zolt_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import zolt_tpu_torch.zkvm.pipeline\n"
        "import chip_smoke\n"
        "ex = sorted(glob.glob('examples/torch_*.py'))\n"
        "assert len(ex) == 7, ex\n"
        "for path in ex:\n"
        "    runpy.run_path(path)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'zolt_tpu'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.slow
def test_jax_digest_of_the_chip_smoke_guest(tmp_path):
    """Recompute the digest chip_smoke.py holds the GPU prove to: the JAX
    package's prove of the sum-loop guest at T = 2^16."""
    path = str(tmp_path / "sum_loop_t16.elf")
    with open(path, "wb") as f:
        f.write(chip_smoke.sum_loop_elf(16))
    blob = jax_prove_jolt(path).conv.proof.serialize_with_dory()
    assert hashlib.sha256(blob).hexdigest() == chip_smoke.JAX_DIGEST_T16


@pytest.mark.slow
def test_jax_sound_digest_of_the_chip_smoke_guest(tmp_path):
    """Recompute the digest chip_smoke.py holds the GPU's sound prove to:
    the JAX package's sound prove of the sum-loop guest at T = 2^16."""
    path = str(tmp_path / "sum_loop_t16.elf")
    with open(path, "wb") as f:
        f.write(chip_smoke.sum_loop_elf(16))
    blob = jax_prove_jolt(path, sound=True).conv.proof.serialize_with_dory()
    assert hashlib.sha256(blob).hexdigest() == chip_smoke.JAX_SOUND_DIGEST_T16
