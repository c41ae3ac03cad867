"""The port's CLI (`python -m zolt_tpu_torch`) against the JAX package's
(`python -m zolt_tpu`), on the CPU, through both `main(argv)`.

`prove --jolt-format --sound --backend host` of the sum-loop guest at
T = 2^10, with --gzip, --device-out, --export-preprocessing and --timings,
runs once a module in each package; the files must be byte-equal. Then
the port's `verify` (of the gzipped file, and with --device), a byte
flipped (exit 1, JAX's FAILED line), and the lines of `stats`, `run`,
`trace`, `decode` and `srs` against JAX's. Every command that is not
ported must exit 2 with a message naming it, and the default backend must
raise without a CUDA device. Pins: the digest chip_smoke.py holds its CLI
prove at T = 2^12 to (JAX's CLI on the host tier), the golden-array guest
with the joint Dory proof on the device path (device="cpu"), and
`stages=3` and `stages=5` on the host tier, each byte-equal to JAX's.

About 45 s in one process on an 8-core CPU box (the T = 2^12 digest
about 8 s, each T = 2^10 sound prove about 3 s, each sound verify about
3 s).
"""

import contextlib
import gzip
import hashlib
import io

import pytest
import torch

import chip_smoke
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
    "prove_internal": (["prove", "{elf}"], "without --jolt-format"),
    "prove_legacy": (["prove", "{elf}", "--legacy"], "--legacy"),
    "backend_mesh": (["prove", "{elf}", "--jolt-format", "--backend",
                      "mesh"], "mesh"),
    "stage1_backend_mesh": (["prove", "{elf}", "--jolt-format", "--backend",
                             "host", "--stage1-backend", "mesh"], "mesh"),
    "bench": (["bench"], "bench"),
    "verify_internal": (["verify", "{internal}", "--elf", "{elf}"],
                        "ZOLT v1"),
    "verify_legacy": (["verify", "{legacy}"], "legacy containers"),
    "verify_without_elf": (["verify", "{out}"], "legacy containers"),
    "stats_internal": (["stats", "{internal}"], "ZOLT v1"),
    "stats_legacy": (["stats", "{legacy}"], "legacy containers"),
    "stats_json": (["stats", "{json}"], "legacy containers"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_what_is_not_ported_is_refused(proved, tmp_path, capsys, case):
    argv, what = REFUSALS[case]
    names = dict(
        elf=proved["elf"], out=proved["port"]["paths"]["out"],
        internal=_fake(tmp_path, "i.bin", b"ZOLT\x01\x00\x00\x00" + bytes(32)),
        legacy=_fake(tmp_path, "l.bin", b"ZOLT\x02\x00\x00\x00" + bytes(32)),
        json=_fake(tmp_path, "j.json", b'{"log_t": 10}'))
    assert main([a.format(**names) for a in argv]) == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and what in err, err


def test_default_prove_needs_a_cuda_device(proved, tmp_path, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["prove", proved["elf"], "--jolt-format", "--sound", "-o",
              str(tmp_path / "p.bin")])


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
