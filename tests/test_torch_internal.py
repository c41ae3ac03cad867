"""The port's internal (ZOLT v1) prover and verifier (zolt_tpu_torch.zkvm
.internal) against the JAX package's, on the CPU.

`prove_internal(..., device="cpu")` runs the port's device work on the
plain versions of its kernels: the three KZG commitments through the
Pippenger (kernels C, D, E), stage 1's Az/Bz openings through folds
(kernel 1) and stage 4's ValEvaluation engine (kernels 1-3), the engine
with the host tail pinned to 0 and at its default of 8192 entries (where
its tables pass to the host C tier). Both must give zolt_tpu's
`serialize()` bytes (which
computes all of it on the host) on the sum-loop guest (T = 2^10) and two
golden guests, at the default srs_degree of 1280 and at SRS sizes below
the longest poly (the reference's zip cuts it to the SRS). Also: the
identity (None) of an all-zero poly, the HyperKZG batch opening
(with_openings=True, small SRS) equal to JAX's field by field and
accepted by both verifiers, deserialize_internal round trips, and
tampered proofs failing both verifiers with the same text. Tolerance:
exact (equal bytes, points, ints and messages).

About 30 s in one process on an 8-core CPU box (most of it the plain
torch Pippenger of the device="cpu" commitments and openings).
"""

import copy
import hashlib

import pytest
import torch

import chip_smoke
from test_torch_legacy import GUESTS

from zolt_tpu.pcs.hyperkzg import HyperKZGBatchProof as JBatchProof
from zolt_tpu.vm import pad_with_noop as jax_pad
from zolt_tpu.vm import run_elf as jax_run_elf
from zolt_tpu.zkvm import internal as jinternal
from zolt_tpu_torch.field.params import FR
from zolt_tpu_torch.pcs import srs as srs_mod
from zolt_tpu_torch.pcs.hyperkzg import HyperKZGBatchProof
from zolt_tpu_torch.vm import elf as elf_mod
from zolt_tpu_torch.vm import pad_with_noop, run_elf
from zolt_tpu_torch.zkvm import internal

torch.set_num_threads(1)
P = FR.p


@pytest.fixture(scope="module")
def elves(tmp_path_factory):
    root = tmp_path_factory.mktemp("internal")
    out = {}
    for name, build in GUESTS.items():
        path = str(root / f"{name}.elf")
        with open(path, "wb") as f:
            f.write(build())
        out[name] = path
    return out


def _image(path: str) -> bytes:
    return bytes(elf_mod.load_file(path).flat_image()[1])


def _jax_prove(path: str, clear_ram: bool = False, **kw):
    emu = jax_run_elf(path)
    if clear_ram:
        emu.ram.trace.clear()
    return jinternal.prove_internal(emu, jax_pad(list(emu.trace)),
                                    _image(path), **kw)


def _prove(path: str, clear_ram: bool = False, **kw):
    emu = run_elf(path)
    if clear_ram:
        emu.ram.trace.clear()
    return internal.prove_internal(emu, pad_with_noop(list(emu.trace)),
                                   _image(path), **kw)


_BLOBS: dict = {}


def _blob(path: str) -> bytes:
    """The port's serialize() of `path`'s proof at the defaults on
    device="cpu", proved once a module."""
    if path not in _BLOBS:
        _BLOBS[path] = _prove(path, device="cpu").serialize()
    return _BLOBS[path]


# (guest, srs_degree, the engine's host tail): the CLI's default SRS, and
# SRSs below the longest poly (the sum loop's reg_poly has 2^10 entries,
# the golden guests' 256), on the plain versions of the kernels
CASES = [("sum_loop_t10", 1280, "0"), ("golden_array", 1280, "0"),
         ("golden_gcd", 128, "0"), ("golden_gcd", 1280, "0"),
         ("sum_loop_t10", 512, "0"), ("golden_array", 1280, "8192"),
         ("golden_gcd", 1280, "8192"), ("golden_gcd", 128, "8192")]


@pytest.mark.parametrize("guest,srs_degree,tail", CASES)
def test_prove_internal_gives_jax_bytes(elves, guest, srs_degree, tail,
                                        monkeypatch):
    ref = _jax_prove(elves[guest], srs_degree=srs_degree)
    monkeypatch.setenv("ZOLT_TPU_DEVICE_TAIL", tail)
    got = _prove(elves[guest], srs_degree=srs_degree, device="cpu")
    blob = got.serialize()
    assert blob == ref.serialize()
    assert (got.bc_commitment, got.mem_commitment, got.reg_commitment) == \
        (ref.bc_commitment, ref.mem_commitment, ref.reg_commitment)
    assert internal.verify_internal(got) is True
    assert jinternal.verify_internal(jinternal.deserialize_internal(blob))


def test_deserialize_internal_round_trips(elves):
    blob = _blob(elves["golden_array"])
    got = internal.deserialize_internal(blob)
    assert got.serialize() == blob
    assert jinternal.deserialize_internal(blob).serialize() == blob
    assert [len(sp.round_polys) for sp in got.stage_proofs] == \
        [len(sp.round_polys)
         for sp in jinternal.deserialize_internal(blob).stage_proofs]
    for bad in (b"ZOLX" + blob[4:], blob[:-1], blob + b"\x00"):
        with pytest.raises(AssertionError) as mine:
            internal.deserialize_internal(bad)
        with pytest.raises(AssertionError) as theirs:
            jinternal.deserialize_internal(bad)
        assert str(mine.value) == str(theirs.value)


def test_zero_polys_commit_to_none(elves):
    srs = internal._cached_setup(8)
    for poly in ([0] * 8, [0, 0], [0] * 8 + [5], [P, 2 * P]):
        assert internal._kzg_commit(srs, poly, "cpu") is None
        assert jinternal._kzg_commit(jinternal._cached_setup(8).powers_g1,
                                     poly) is None
    # with the RAM trace cleared, the memory poly is all zero
    ref = _jax_prove(elves["golden_gcd"], clear_ram=True)
    got = _prove(elves["golden_gcd"], clear_ram=True, device="cpu")
    assert ref.mem_commitment is None and got.mem_commitment is None
    assert got.serialize() == ref.serialize()


def _verdict(fn, proof) -> str:
    try:
        return repr(fn(proof))
    except AssertionError as e:
        return f"{type(e).__name__}: {e}"


# tests/test_multistage.py's loop: 5 + 4·5 steps, 16 bytes of bytecode
LOOP = (0x00500093, 0x00000113, 0x00110133, 0xFFF08093, 0xFE101CE3,
        0x0000006F)


def _loop_proof(pkg, **kw):
    """prove_internal of LOOP padded to 32 steps (so every poly fits an SRS
    of 32 points) in the package `pkg` (the port's or JAX's internal)."""
    import zolt_tpu.vm as jvm
    import zolt_tpu_torch.vm as vm

    v = jvm if pkg is jinternal else vm
    code = b"".join(w.to_bytes(4, "little") for w in LOOP)
    emu = v.Emulator(v.MemoryConfig(program_size=256))
    emu.load_program(code)
    emu.run()
    padded = v.pad_with_noop(list(emu.trace), min_pad=16)
    return pkg.prove_internal(emu, padded, code, srs_degree=32,
                              with_openings=True, **kw)


def test_batch_opening_equals_jax_and_verifies():
    ref = _loop_proof(jinternal)
    got = _loop_proof(internal, device="cpu")
    assert got.serialize() == ref.serialize()
    assert got.kzg_batch_point == ref.kzg_batch_point
    a, b = got.kzg_batch_opening, ref.kzg_batch_opening
    assert a.evaluations == b.evaluations
    assert (a.proof.com, a.proof.v, a.proof.w) == \
        (b.proof.com, b.proof.v, b.proof.w)
    assert internal.verify_internal(got) is True
    assert jinternal.verify_internal(got) is True
    bad, jbad = copy.copy(got), copy.copy(ref)
    bad.kzg_batch_opening = HyperKZGBatchProof(
        evaluations=[(a.evaluations[0] + 1) % P] + a.evaluations[1:],
        proof=a.proof)
    jbad.kzg_batch_opening = JBatchProof(
        evaluations=[(b.evaluations[0] + 1) % P] + b.evaluations[1:],
        proof=b.proof)
    said = _verdict(internal.verify_internal, bad)
    assert said == _verdict(jinternal.verify_internal, jbad)
    assert said == ("InternalVerificationError: kzg batch opening pairing "
                    "check failed")


TAMPER = {
    "stage1_round_poly": (0, 3, 0),
    "stage3_round_poly": (2, 5, 1),
    "stage4_round_poly": (3, 2, 0),
    "stage1_first_round": (0, 0, 1),
}


@pytest.mark.parametrize("case", list(TAMPER))
def test_tampered_round_poly_fails_as_in_jax(elves, case):
    stage, rnd, i = TAMPER[case]
    blob = _blob(elves["sum_loop_t10"])
    mine = internal.deserialize_internal(blob)
    theirs = jinternal.deserialize_internal(blob)
    for proof in (mine, theirs):
        poly = proof.stage_proofs[stage].round_polys[rnd]
        poly[i] = (poly[i] + 1) % P
    said = _verdict(internal.verify_internal, mine)
    assert said == _verdict(jinternal.verify_internal, theirs)
    assert said.startswith("InternalVerificationError: stage"), said


def test_internal_prove_needs_a_cuda_device_by_default(elves, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _prove(elves["golden_gcd"])


def test_the_device_is_never_guessed(elves):
    with pytest.raises(ValueError, match="explicit device"):
        _prove(elves["golden_gcd"], device=None)


def test_a_given_srs_gives_the_bytes_of_the_built_one(elves):
    """prove_internal(..., srs=) with the first 128 powers of a larger SRS
    at the same τ commits and proves as with insecure_setup(128); an SRS
    of another size than srs_degree raises."""
    big = internal._cached_setup(1280)
    cut = srs_mod.KZGSRS(powers_g1=big.powers_g1[:128], tau_g2=big.tau_g2,
                         g1=big.g1, g2=big.g2)
    got = _prove(elves["golden_gcd"], srs_degree=128, srs=cut, device="cpu")
    assert got.serialize() == _jax_prove(elves["golden_gcd"],
                                         srs_degree=128).serialize()
    with pytest.raises(ValueError, match="not srs_degree = 256"):
        _prove(elves["golden_gcd"], srs_degree=256, srs=cut, device="cpu")


@pytest.mark.slow
def test_jax_internal_digest_of_the_chip_smoke_guest(tmp_path):
    """Recompute the digest chip_smoke.py holds the GPU's internal prove
    to: zolt_tpu's prove_internal (the CLI's defaults) of the sum-loop
    guest at T = 2^16 (about 40 s)."""
    path = str(tmp_path / "sum_loop_t16.elf")
    with open(path, "wb") as f:
        f.write(chip_smoke.sum_loop_elf(16))
    blob = _jax_prove(path, log_k=16).serialize()
    assert hashlib.sha256(blob).hexdigest() == \
        chip_smoke.JAX_INTERNAL_DIGEST_T16
