"""The port's CLI (`python -m zolt_tpu_torch`) against the JAX package's
(`python -m zolt_tpu`), on the CPU, through both `main(argv)`.

`prove --jolt-format --sound --backend host` of the sum-loop guest at
T = 2^10, with --gzip, --device-out, --export-preprocessing and --timings,
runs once a module in each package; the files must be byte-equal. Then
the port's `verify` (of the gzipped file, and with --device), a byte
flipped (exit 1, JAX's FAILED line), and the lines of `stats`, `run`,
`trace`, `decode` and `srs` against JAX's. The internal (ZOLT v1) and
legacy (ZOLT v2, JSON) containers: `prove` (default), `prove --legacy`
with --json, --gzip and --log-k, each with --backend host, byte-equal to
JAX's files (JAX's legacy prover with its jitted helpers on its host
tier, as tests/test_torch_legacy.py runs it), and `verify` (--strict
too) and `stats` of each, a flipped stage-1 byte of each, and a
Jolt-format file without --elf, with JAX's lines. `prove --backend mesh`
and `--stage1-backend mesh` (make_mesh() on "cpu" shards) write the JAX
CLI's host-tier file. --backend mesh for the internal and legacy
provers (no mesh path) must exit 2 with a message naming them (`bench`
is tests/test_torch_bench.py's), and the default backend must raise without a CUDA device.
Pins: the digests chip_smoke.py holds its CLI proves at T = 2^12 to
(JAX's CLI on the host tier), the golden-array guest with the joint Dory
proof on the device path (device="cpu"), and `stages=3` and `stages=5`
on the host tier, each byte-equal to JAX's.

About 90 s in one process on an 8-core CPU box (the T = 2^12 digests
about 8 s each, each T = 2^10 sound prove about 3 s, each sound verify
about 3 s; the mesh CLI proves 24 s and 6 s).
"""

import contextlib
import gzip
import hashlib
import io
import re

import pytest
import torch

import chip_smoke
from test_torch_legacy import jax_legacy_on_host
from test_torch_slice import GUESTS
from zolt_tpu.__main__ import main as jax_main
from zolt_tpu.zkvm.pipeline import prove_jolt as jax_prove_jolt
from zolt_tpu_torch.__main__ import main
from zolt_tpu_torch.pcs import srs
from zolt_tpu_torch.zkvm.pipeline import prove_jolt

torch.set_num_threads(1)


def _run(fn, argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def proved(tmp_path_factory):
    """Both CLIs' `prove` of the sum-loop guest with the same arguments:
    {"port"|"jax": {"out", "dev", "pp": file bytes, "lines": stdout}}."""
    root = tmp_path_factory.mktemp("cli")
    elf = str(root / "sum_loop_t10.elf")
    with open(elf, "wb") as f:
        f.write(GUESTS["sum_loop_t10"]())
    files = {"elf": elf}
    for name, fn in (("port", main), ("jax", jax_main)):
        d = root / name
        d.mkdir()
        paths = {k: str(d / k) for k in ("out", "dev", "pp")}
        rc, text = _run(fn, ["prove", elf, "--jolt-format", "--sound",
                             "--backend", "host", "-o", paths["out"],
                             "--gzip", "--device-out", paths["dev"],
                             "--export-preprocessing", paths["pp"],
                             "--timings"])
        assert rc == 0
        files[name] = {k: open(p, "rb").read() for k, p in paths.items()}
        files[name].update(paths=paths, lines=text.splitlines())
    return files


def test_prove_writes_jax_files(proved):
    port, ref = proved["port"], proved["jax"]
    for k in ("out", "dev", "pp"):
        assert port[k] == ref[k], k
    assert port["out"][:2] == b"\x1f\x8b"
    assert port["lines"][0] == ref["lines"][0] == \
        "trace: 779 cycles (padded 1024)"
    assert f"proof: {len(port['out'])} bytes -> " \
           f"{port['paths']['out']}" in port["lines"]
    assert "stage timings:" in port["lines"]


def test_gzip_round_trips(proved):
    from zolt_tpu_torch.zkvm.jolt_deserialize import deserialize_jolt_proof

    blob = gzip.decompress(proved["port"]["out"])
    proof = deserialize_jolt_proof(blob, variant="with_dory")
    assert gzip.compress(proof.serialize_with_dory(), mtime=0) == \
        proved["port"]["out"]


def test_verify_passes(proved, tmp_path, capsys):
    elf, out = proved["elf"], proved["port"]["paths"]["out"]
    assert main(["verify", out, "--elf", elf]) == 0
    assert capsys.readouterr().out.startswith("PASSED (")
    plain = str(tmp_path / "plain.bin")
    with open(plain, "wb") as f:
        f.write(gzip.decompress(proved["port"]["out"]))
    assert main(["verify", plain, "--elf", elf, "--device",
                 proved["port"]["paths"]["dev"]]) == 0
    assert capsys.readouterr().out.startswith("PASSED (")


def test_a_flipped_byte_fails_as_in_jax(proved, tmp_path):
    blob = bytearray(gzip.decompress(proved["port"]["out"]))
    blob[24] ^= 1                      # inside the first opening claim
    bad = str(tmp_path / "bad.bin")
    with open(bad, "wb") as f:
        f.write(blob)
    argv = ["verify", bad, "--elf", proved["elf"]]
    rc, text = _run(main, argv)
    assert (rc, text) == _run(jax_main, argv)
    assert rc == 1 and text.startswith("FAILED: ")


def test_stats_run_trace_decode_srs_print_jax_lines(proved, tmp_path):
    elf = proved["elf"]
    raw = str(tmp_path / "srs.bin")
    with open(raw, "wb") as f:
        f.write(srs.serialize_raw_binary(srs.insecure_setup(4)))
    for argv in (["stats", proved["port"]["paths"]["out"]],
                 ["run", elf, "--regs"], ["trace", elf],
                 ["decode", "0x02a00093"], ["decode", "4505"],
                 ["decode", "fe101ce3"], ["srs", raw]):
        rc, text = _run(main, argv)
        assert (rc, text) == _run(jax_main, argv), argv
        assert rc == 0 and text


def test_info_names_torch_and_the_devices():
    rc, text = _run(main, ["info"])
    assert rc == 0
    assert f"torch {torch.__version__}" in text
    assert "CUDA devices: 0 []" in text


def _fake(tmp_path, name: str, blob: bytes) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(blob)
    return path


REFUSALS = {
    "internal_mesh": (["prove", "{elf}", "--backend", "mesh"],
                      ("no mesh path", "internal")),
    "legacy_mesh": (["prove", "{elf}", "--legacy", "--backend", "mesh"],
                    ("no mesh path", "legacy")),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_what_is_not_ported_is_refused(proved, capsys, case):
    argv, words = REFUSALS[case]
    assert main([a.format(elf=proved["elf"]) for a in argv]) == 2
    err = capsys.readouterr().err
    assert all(w in err for w in words), err


MESH_PROVES = {
    "backend_mesh": ["--backend", "mesh"],
    "stage1_backend_mesh": ["--backend", "host", "--stage1-backend", "mesh"],
}


@pytest.mark.parametrize("case", list(MESH_PROVES))
def test_mesh_prove_writes_jax_files(proved, tmp_path, monkeypatch, case):
    """`prove --jolt-format --sound --gzip` on a mesh (make_mesh() on two
    "cpu" shards here, every CUDA device by default) writes the JAX CLI's
    host-tier file. At the port's default tail (8192) the batch opening's
    2^14-entry groups take their first round on the mesh; stage 1 runs
    every round there at tail 0."""
    from zolt_tpu_torch.parallel import mesh as pm

    make = pm.make_mesh
    monkeypatch.setattr(pm, "make_mesh", lambda: make(["cpu"] * 2))
    monkeypatch.setenv("ZOLT_TPU_DEVICE_TAIL",
                       "8192" if case == "backend_mesh" else "0")
    out = str(tmp_path / "p.bin")
    rc, text = _run(main, ["prove", proved["elf"], "--jolt-format",
                           "--sound", *MESH_PROVES[case], "-o", out,
                           "--gzip"])
    assert rc == 0, text
    with open(out, "rb") as f:
        assert f.read() == proved["jax"]["out"]


@pytest.mark.parametrize("flags", [["--jolt-format", "--sound"], [],
                                   ["--legacy"]],
                         ids=["jolt_format", "internal", "legacy"])
def test_default_prove_needs_a_cuda_device(proved, tmp_path, monkeypatch,
                                           flags):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["prove", proved["elf"], *flags, "-o", str(tmp_path / "p.bin")])


# The internal and legacy containers: each prove's flags, the same in both
# CLIs (JAX's ignores --backend for them)
CONTAINERS = {
    "internal": [],
    "internal_gzip": ["--gzip"],
    "legacy": ["--legacy"],
    "legacy_json": ["--legacy", "--json"],
    "legacy_gzip": ["--legacy", "--gzip"],
    "legacy_log_k": ["--legacy", "--log-k", "8"],
}


def _timeless(text: str) -> str:
    """A command's output without its seconds."""
    return re.sub(r"\d+\.\d+s", "_s", text)


@pytest.fixture(scope="module")
def containers(proved, tmp_path_factory):
    """Both CLIs' `prove <elf> <flags> --backend host -o <file>` of the
    sum-loop guest (T = 2^10) for each of CONTAINERS: {name: {"port" |
    "jax": (file bytes, stdout without seconds, path)}}."""
    root = tmp_path_factory.mktemp("containers")
    out = {}
    for name, flags in CONTAINERS.items():
        out[name] = {}
        for who, fn in (("port", main), ("jax", jax_main)):
            path = str(root / f"{who}_{name}.bin")
            with jax_legacy_on_host():
                rc, text = _run(fn, ["prove", proved["elf"], *flags,
                                     "--backend", "host", "-o", path])
            assert rc == 0, (name, who)
            with open(path, "rb") as f:
                out[name][who] = (f.read(), _timeless(text.replace(
                    f"{who}_{name}", name)), path)
    return out


@pytest.mark.parametrize("name", list(CONTAINERS))
def test_prove_writes_the_jax_container(containers, name):
    port, ref = containers[name]["port"], containers[name]["jax"]
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[1].startswith("trace: 779 cycles (padded 1024)\n")
    assert (port[0][:2] == b"\x1f\x8b") == ("gzip" in name)


def _flipped(tmp_path, containers, name: str) -> str:
    """A copy of the port's file of `name` with a byte of the first
    stage-1 round poly's first value flipped."""
    blob = containers[name]["port"][0]
    # ZOLT v1: magic, version, 11 commitment blocks and the R1CS
    # placeholder (1000 bytes), has-stages, log_t, log_k, then stage 1's
    # round count and the first poly's length; ZOLT v2: magic, version,
    # log_t, log_k, the stage count, stage 1's round count, the length
    at = chip_smoke.CLI_STAGE1_BYTE if name == "internal" else 48
    bad = bytearray(blob)
    bad[at] ^= 1
    return _fake(tmp_path, f"flipped_{name}.bin", bytes(bad))


# (argv, the exit code): verify and stats of each container in both CLIs
READS = {
    "verify_internal": (["verify", "{internal}"], 0),
    "verify_internal_gzip": (["verify", "{internal_gzip}"], 0),
    "verify_legacy": (["verify", "{legacy}"], 0),
    "verify_legacy_strict": (["verify", "{legacy}", "--strict"], 0),
    "verify_legacy_json": (["verify", "{legacy_json}"], 0),
    "verify_legacy_gzip": (["verify", "{legacy_gzip}"], 0),
    "verify_legacy_log_k": (["verify", "{legacy_log_k}"], 0),
    "verify_flipped_internal": (["verify", "{flipped_internal}"], 1),
    "verify_flipped_legacy": (["verify", "{flipped_legacy}"], 1),
    "verify_jolt_without_elf": (["verify", "{out}"], 1),
    "stats_internal": (["stats", "{internal_gzip}"], 0),
    "stats_legacy": (["stats", "{legacy}"], 0),
    "stats_legacy_json": (["stats", "{legacy_json}"], 0),
    "stats_legacy_gzip": (["stats", "{legacy_gzip}"], 0),
}


@pytest.mark.parametrize("case", list(READS))
def test_verify_and_stats_print_jax_lines(proved, containers, tmp_path,
                                          case):
    argv, want = READS[case]
    names = {k: v["port"][2] for k, v in containers.items()}
    names.update(out=proved["port"]["paths"]["out"],
                 flipped_internal=_flipped(tmp_path, containers, "internal"),
                 flipped_legacy=_flipped(tmp_path, containers, "legacy"))
    argv = [a.format(**names) for a in argv]
    rc, text = _run(main, argv)
    assert (rc, _timeless(text)) == \
        (lambda r: (r[0], _timeless(r[1])))(_run(jax_main, argv))
    assert rc == want, text
    if argv[0] == "verify":
        assert text.startswith("PASSED (" if want == 0 else "FAILED: "), text


def _cli_digest(tmp_path, fn, flags) -> str:
    elf = str(tmp_path / "sum_loop_t12.elf")
    with open(elf, "wb") as f:
        f.write(chip_smoke.sum_loop_elf(12))
    out = str(tmp_path / "p.bin")
    assert _run(fn, ["prove", elf, *flags, "-o", out])[0] == 0
    with open(out, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("which", ["internal", "legacy_json", "legacy_gzip"])
def test_jax_cli_container_digests_of_the_chip_smoke_guest(tmp_path, which):
    """Recompute the digests chip_smoke.py holds its CLI's internal and
    legacy proves (T = 2^12, the GPU) to: JAX's CLI, its legacy prover's
    jitted helpers on its host tier."""
    flags, want = chip_smoke.CLI_CONTAINERS[which]
    with jax_legacy_on_host():
        assert _cli_digest(tmp_path, jax_main, flags) == want




def test_jax_cli_sound_digest_of_the_chip_smoke_guest(tmp_path):
    """Recompute the digest chip_smoke.py holds its CLI prove (T = 2^12,
    the default backend on the GPU) to: JAX's CLI on the host tier."""
    elf = str(tmp_path / "sum_loop_t12.elf")
    with open(elf, "wb") as f:
        f.write(chip_smoke.sum_loop_elf(12))
    out = str(tmp_path / "p.bin")
    assert _run(jax_main, ["prove", elf, "--jolt-format", "--sound",
                           "--backend", "host", "-o", out])[0] == 0
    with open(out, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    assert digest == chip_smoke.JAX_CLI_SOUND_DIGEST_T12


@pytest.fixture(scope="module")
def golden_array(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pins") / "golden_array.elf")
    with open(path, "wb") as f:
        f.write(GUESTS["golden_array"]())
    return path


def test_joint_proof_on_the_device_path_equals_jax(golden_array):
    ref = jax_prove_jolt(golden_array, with_joint_proof=True)
    got = prove_jolt(golden_array, with_joint_proof=True, device="cpu")
    blob = got.conv.proof.serialize_with_dory()
    assert len(blob) == 41936
    assert blob == ref.conv.proof.serialize_with_dory()


@pytest.mark.parametrize("stages", [3, 5])
def test_fewer_stages_on_the_host_tier_equal_jax(golden_array, stages):
    ref = jax_prove_jolt(golden_array, stages=stages)
    got = prove_jolt(golden_array, stages=stages, backend="host")
    assert got.conv.proof.serialize() == ref.conv.proof.serialize()
