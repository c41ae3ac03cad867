"""The port's Jolt verifier against the JAX package's, on the CPU.

The proofs come from host-tier proves (`backend="host"`, which compiles no
XLA in the JAX package) of the guests of tests/test_torch_slice.py, each
made once a module, with the joint Dory proof so both serialized layouts
exist. The port's verifier is fed only proofs parsed by the port's
deserializer (`zolt_tpu_torch.zkvm.jolt_deserialize`), JAX's only proofs
parsed by JAX's. Held to JAX: the deserializer's re-serialized bytes in
both layouts, the verdicts, the `report` residuals, the `VerifyError`
texts of a compat proof under the strict default and of every case of a
tamper matrix, and the bytes of `export_preprocessing` at the CLI's SRS
size. Tolerance: byte-equal bytes, equal verdicts, equal texts and equal
report dicts.

About 55 s in one process on an 8-core CPU box (most of it the eight
proves and the sound verifies, 3-4 s each).
"""

import pytest
import torch

from test_torch_slice import GUESTS
from zolt_tpu.vm import elf as jax_elf
from zolt_tpu.vm.layout import MemoryConfig as JaxMemoryConfig
from zolt_tpu.vm.layout import MemoryLayout as JaxMemoryLayout
from zolt_tpu.zkvm import jolt_deserialize as jax_deser
from zolt_tpu.zkvm import jolt_types as jax_types
from zolt_tpu.zkvm import jolt_verifier as jax_verifier
from zolt_tpu.zkvm import preprocessing as jax_prep
from zolt_tpu.zkvm import sound_lookups as jax_sl
from zolt_tpu.zkvm.pipeline import prove_jolt as jax_prove_jolt
from zolt_tpu_torch.vm import elf
from zolt_tpu_torch.vm.layout import MemoryConfig, MemoryLayout
from zolt_tpu_torch.zkvm import jolt_deserialize, jolt_types, jolt_verifier
from zolt_tpu_torch.zkvm import preprocessing, sound_lookups
from zolt_tpu_torch.zkvm.pipeline import prove_jolt

torch.set_num_threads(1)

# per package: the modules a check or a tamper reaches through
PORT = dict(deser=jolt_deserialize, types=jolt_types, verifier=jolt_verifier,
            sl=sound_lookups)
JAX = dict(deser=jax_deser, types=jax_types, verifier=jax_verifier,
           sl=jax_sl)


@pytest.fixture(scope="module")
def proved(tmp_path_factory):
    """proved(name): the guest's ELF path and, by (source, mode), the
    proof's canonical bytes (without the joint Dory proof) and with-Dory
    bytes (with it), from the port's and from JAX's host-tier prove; each
    guest proved once a module."""
    cache = {}

    def get(name: str) -> dict:
        if name in cache:
            return cache[name]
        path = str(tmp_path_factory.mktemp("verifier") / f"{name}.elf")
        with open(path, "wb") as f:
            f.write(GUESTS[name]())
        proofs = {}
        for mode in ("sound", "compat"):
            kw = dict(sound=mode == "sound", with_joint_proof=True)
            for src, prove in (("port", lambda: prove_jolt(
                                    path, backend="host", **kw)),
                               ("jax", lambda: jax_prove_jolt(path, **kw))):
                proof = prove().conv.proof
                with_dory = proof.serialize_with_dory()
                # the canonical layout has no joint proof (the
                # deserializer reads none), and the joint proof comes after
                # every other part of the transcript
                proof.joint_opening_proof = None
                proofs[src, mode] = (proof.serialize(), with_dory)
        cache[name] = {"name": name, "path": path, "proofs": proofs,
                       "jax_verdicts": {}}
        return cache[name]

    return get


@pytest.fixture(scope="module", params=sorted(GUESTS))
def guest(request, proved):
    return proved(request.param)


@pytest.fixture(scope="module")
def sum_loop(proved):
    """The tamper matrix's guest."""
    return proved("sum_loop_t10")


def _verdict(pkg, blob, path, tamper=None, **kw):
    """("ok", report) or (exception class name, text): pkg's deserializer
    on the bytes, the tamper on its proof, then pkg's verify_jolt."""
    proof = pkg["deser"].deserialize_jolt_proof(blob)
    if tamper is not None:
        kw.update(tamper(proof, pkg) or {})
    report = {}
    try:
        assert pkg["verifier"].verify_jolt(proof, path, report=report, **kw)
    except pkg["verifier"].VerifyError as e:
        return type(e).__name__, str(e)
    return "ok", report


def _jax_verdict(guest, blob, **kw):
    key = (blob, tuple(sorted(kw.items())))
    if key not in guest["jax_verdicts"]:
        guest["jax_verdicts"][key] = _verdict(JAX, blob, guest["path"], **kw)
    return guest["jax_verdicts"][key]


@pytest.mark.parametrize("mode", ["sound", "compat"])
@pytest.mark.parametrize("src", ["port", "jax"])
def test_deserializer_round_trips_both_layouts_as_jax_does(guest, src, mode):
    canonical, with_dory = guest["proofs"][src, mode]
    for variant, blob, ser in (("canonical", canonical, "serialize"),
                               ("with_dory", with_dory,
                                "serialize_with_dory")):
        mine = jolt_deserialize.deserialize_jolt_proof(blob, variant=variant)
        ref = jax_deser.deserialize_jolt_proof(blob, variant=variant)
        assert isinstance(mine, jolt_types.JoltProof)
        assert getattr(mine, ser)() == getattr(ref, ser)() == blob
    assert (guest["proofs"]["port", mode] == guest["proofs"]["jax", mode])


@pytest.mark.parametrize("mode", ["sound", "compat"])
@pytest.mark.parametrize("src", ["port", "jax"])
def test_verifier_accepts_as_jax_does(guest, src, mode):
    """Sound proofs under the strict default, compat proofs under
    allow_reference_compat; the report residuals equal JAX's."""
    kw = {"allow_reference_compat": mode == "compat"}
    blob = guest["proofs"][src, mode][0]
    got = _verdict(PORT, blob, guest["path"], **kw)
    assert got[0] == "ok", got
    assert got == _jax_verdict(guest, blob, **kw)


def test_verifier_rejects_a_compat_proof_as_jax_does(guest):
    blob = guest["proofs"]["port", "compat"][0]
    got = _verdict(PORT, blob, guest["path"])
    assert got[0] == "VerifyError"
    assert got == _jax_verdict(guest, blob)


def _round_poly(proof, pkg):
    proof.stage1_sumcheck.compressed_polys[3][0] += 1


def _ram_address(proof, pkg):
    t = pkg["types"]
    oid = t.OpeningId.virtual(t.VirtualPolynomial.named("RamAddress"),
                              t.SumcheckId.SpartanOuter)
    proof.opening_claims.insert(oid, proof.opening_claims.get(oid) + 1)


def _uniskip(proof, pkg):
    proof.stage1_uni_skip.uni_poly[5] += 1


def _outputs(proof, pkg):
    return {"outputs": b"\x01"}


def _committed_claim(proof, pkg):
    t = pkg["types"]
    cp = t.CommittedPolynomial
    oid = t.OpeningId.committed(cp(cp.RAM_INC),
                                t.SumcheckId.RamReadWriteChecking)
    proof.opening_claims.insert(oid, (proof.opening_claims.get(oid) + 1)
                                % (2 ** 251))


def _commitment(proof, pkg):
    proof.commitments[1] = proof.commitments[0]


def _batch_opening(proof, pkg):
    proof.batch_opening = None


def _lookups_ext(proof, pkg):
    proof.lookups_ext = None


def _stage9_round_poly(proof, pkg):
    slp = pkg["sl"].deserialize_sound_lookups(proof.lookups_ext)
    slp.s9.compressed_polys[2][1] += 1
    proof.lookups_ext = pkg["sl"].serialize_sound_lookups(slp)


TAMPERS = {
    "stage1_round_poly": (_round_poly, ""),
    "ram_address_claim": (_ram_address, ""),
    "uniskip_coefficient": (_uniskip, "vanish"),
    "outputs": (_outputs, ""),
    "committed_claim": (_committed_claim, ""),
    "commitment": (_commitment, ""),
    "stripped_batch_opening": (_batch_opening, "batch opening"),
    "stripped_lookups_ext": (_lookups_ext, "lookups"),
    "stage9_round_poly": (_stage9_round_poly, "stage 9"),
}


@pytest.mark.parametrize("case", list(TAMPERS))
def test_tamper_matrix(sum_loop, case):
    """Each tampered sound proof through both verifiers: the same class of
    outcome and the same text (all are rejected)."""
    tamper, match = TAMPERS[case]
    blob = sum_loop["proofs"]["port", "sound"][0]
    got = _verdict(PORT, blob, sum_loop["path"], tamper)
    ref = _verdict(JAX, blob, sum_loop["path"], tamper)
    assert got == ref
    assert got[0] == "VerifyError" and match in got[1], got


def test_export_preprocessing_equals_jax(guest):
    """The verifier preprocessing file at the CLI's SRS size (2^16)."""
    def export(elf_mod, config, layout_cls, prep):
        base, image = elf_mod.load_file(guest["path"]).flat_image()
        layout = layout_cls.create(config(program_size=len(image),
                                          memory_size=32768))
        return prep.export_preprocessing(bytes(image), base, layout, 1024,
                                         srs_log_size=16)

    mine = export(elf, MemoryConfig, MemoryLayout, preprocessing)
    assert mine == export(jax_elf, JaxMemoryConfig, JaxMemoryLayout, jax_prep)


@pytest.mark.parametrize("word,address,variant,text", [
    (0x00500093, 0x80000000, "ADDI",
     '"ADDI":{"address":2147483648,"operands":{"rd":1,"rs1":0,"imm":5}'),
    (0xFE101CE3, 0x8000000C, "BNE", '"imm":-8'),
])
def test_decode_jolt_instruction(word, address, variant, text):
    ins = preprocessing.decode_jolt_instruction(word, address, False)
    ref = jax_prep.decode_jolt_instruction(word, address, False)
    assert ins.variant == ref.variant == variant
    assert text in ins.to_json()
    assert ins.to_json() == ref.to_json()
