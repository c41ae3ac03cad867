"""Jolt proof type model: enums, opening-claim map, arkworks serialization.

Byte-compatible with the reference's Jolt proof model
(src/zkvm/jolt_types.zig:18-940, src/zkvm/jolt_serialization.zig:33-533),
which itself matches Rust Jolt:

- SumcheckId (22 variants), CommittedPolynomial / VirtualPolynomial tagged
  unions with compact (tag byte [+ payload byte]) serialization,
- OpeningId with the Rust-derived Ord (variant, then poly, then sumcheck_id)
  that fixes the BTreeMap iteration order,
- CompressedUniPoly ([c0, c2, ..., cn]), SumcheckInstanceProof,
  UniSkipFirstRoundProof,
- the arkworks container: no magic, u64 LE lengths, 32-byte LE canonical field
  elements, 384-byte GT elements, configs appended last.

Host field elements are canonical Python ints.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field as dfield
from enum import IntEnum

from ..field.params import FR

P = FR.p


class SumcheckId(IntEnum):
    SpartanOuter = 0
    SpartanProductVirtualization = 1
    SpartanShift = 2
    InstructionClaimReduction = 3
    InstructionInputVirtualization = 4
    InstructionReadRaf = 5
    InstructionRaVirtualization = 6
    RamReadWriteChecking = 7
    RamRafEvaluation = 8
    RamOutputCheck = 9
    RamValEvaluation = 10
    RamValFinalEvaluation = 11
    RamRaClaimReduction = 12
    RamHammingBooleanity = 13
    RamRaVirtualization = 14
    RegistersClaimReduction = 15
    RegistersReadWriteChecking = 16
    RegistersValEvaluation = 17
    BytecodeReadRaf = 18
    Booleanity = 19
    IncClaimReduction = 20
    HammingWeightClaimReduction = 21


SUMCHECK_ID_COUNT = 22


@dataclass(frozen=True, order=False)
class CommittedPolynomial:
    """tag: 0=RdInc 1=RamInc 2=InstructionRa(i) 3=BytecodeRa(i) 4=RamRa(i)
    5=TrustedAdvice 6=UntrustedAdvice."""

    tag: int
    index: int = 0

    RD_INC = 0
    RAM_INC = 1
    INSTRUCTION_RA = 2
    BYTECODE_RA = 3
    RAM_RA = 4
    TRUSTED_ADVICE = 5
    UNTRUSTED_ADVICE = 6

    def serialize(self) -> bytes:
        if self.tag in (2, 3, 4):
            return bytes([self.tag, self.index & 0xFF])
        return bytes([self.tag])

    def sort_key(self):
        return (self.tag, self.index)


@dataclass(frozen=True)
class VirtualPolynomial:
    """tags 0..40 per the reference serialize table (jolt_types.zig:256-325);
    payload used by InstructionRa(27), OpFlags(38), InstructionFlags(39),
    LookupTableFlag(40)."""

    tag: int
    index: int = 0

    _PAYLOAD_TAGS = (27, 38, 39, 40)

    # name -> tag (complete table)
    NAMES = {
        "PC": 0, "UnexpandedPC": 1, "NextPC": 2, "NextUnexpandedPC": 3,
        "NextIsNoop": 4, "NextIsVirtual": 5, "NextIsFirstInSequence": 6,
        "LeftLookupOperand": 7, "RightLookupOperand": 8,
        "LeftInstructionInput": 9, "RightInstructionInput": 10, "Product": 11,
        "ShouldJump": 12, "ShouldBranch": 13, "WritePCtoRD": 14,
        "WriteLookupOutputToRD": 15, "Rd": 16, "Imm": 17, "Rs1Value": 18,
        "Rs2Value": 19, "RdWriteValue": 20, "Rs1Ra": 21, "Rs2Ra": 22,
        "RdWa": 23, "LookupOutput": 24, "InstructionRaf": 25,
        "InstructionRafFlag": 26, "InstructionRa": 27, "RegistersVal": 28,
        "RamAddress": 29, "RamRa": 30, "RamReadValue": 31, "RamWriteValue": 32,
        "RamVal": 33, "RamValInit": 34, "RamValFinal": 35,
        "RamHammingWeight": 36, "UnivariateSkip": 37, "OpFlags": 38,
        "InstructionFlags": 39, "LookupTableFlag": 40,
    }

    @classmethod
    def named(cls, name: str, index: int = 0) -> "VirtualPolynomial":
        return cls(cls.NAMES[name], index)

    def serialize(self) -> bytes:
        if self.tag in self._PAYLOAD_TAGS:
            return bytes([self.tag, self.index & 0xFF])
        return bytes([self.tag])

    def sort_key(self):
        return (self.tag, self.index)


# OpeningId variant order for Ord: Committed=0, Virtual=1, UntrustedAdvice=2,
# TrustedAdvice=3 (jolt_types.zig:360-363)
_VAR_COMMITTED, _VAR_VIRTUAL, _VAR_UNTRUSTED, _VAR_TRUSTED = 0, 1, 2, 3

UNTRUSTED_ADVICE_BASE = 0
TRUSTED_ADVICE_BASE = SUMCHECK_ID_COUNT
COMMITTED_BASE = 2 * SUMCHECK_ID_COUNT
VIRTUAL_BASE = 3 * SUMCHECK_ID_COUNT


@dataclass(frozen=True)
class OpeningId:
    variant: int
    poly: object = None  # CommittedPolynomial | VirtualPolynomial | None
    sumcheck_id: SumcheckId = SumcheckId.SpartanOuter

    @classmethod
    def committed(cls, poly: CommittedPolynomial, sid: SumcheckId) -> "OpeningId":
        return cls(_VAR_COMMITTED, poly, sid)

    @classmethod
    def virtual(cls, poly: VirtualPolynomial, sid: SumcheckId) -> "OpeningId":
        return cls(_VAR_VIRTUAL, poly, sid)

    def serialize(self) -> bytes:
        if self.variant == _VAR_UNTRUSTED:
            return bytes([UNTRUSTED_ADVICE_BASE + int(self.sumcheck_id)])
        if self.variant == _VAR_TRUSTED:
            return bytes([TRUSTED_ADVICE_BASE + int(self.sumcheck_id)])
        if self.variant == _VAR_COMMITTED:
            return bytes([COMMITTED_BASE + int(self.sumcheck_id)]) + self.poly.serialize()
        return bytes([VIRTUAL_BASE + int(self.sumcheck_id)]) + self.poly.serialize()

    def sort_key(self):
        """Rust-derived Ord: variant, then (poly, sumcheck_id)."""
        pk = self.poly.sort_key() if self.poly is not None else (0, 0)
        return (self.variant, pk, int(self.sumcheck_id))


def _w_scalar(x: int) -> bytes:
    return (x % P).to_bytes(32, "little")


class OpeningClaims:
    """BTreeMap-ordered map OpeningId -> claim (canonical int)."""

    def __init__(self):
        self._map: dict[OpeningId, int] = {}

    def insert(self, oid: OpeningId, claim: int) -> None:
        self._map[oid] = claim % P

    def get(self, oid: OpeningId) -> int | None:
        return self._map.get(oid)

    def sorted_entries(self) -> list[tuple[OpeningId, int]]:
        return sorted(self._map.items(), key=lambda kv: kv[0].sort_key())

    def __len__(self):
        return len(self._map)

    def serialize(self) -> bytes:
        out = [struct.pack("<Q", len(self._map))]
        for oid, claim in self.sorted_entries():
            out.append(oid.serialize())
            out.append(_w_scalar(claim))
        return b"".join(out)


def serialize_compressed_unipoly(coeffs_except_linear: list[int]) -> bytes:
    return struct.pack("<Q", len(coeffs_except_linear)) + b"".join(
        _w_scalar(c) for c in coeffs_except_linear)


@dataclass
class SumcheckInstanceProof:
    compressed_polys: list[list[int]] = dfield(default_factory=list)

    def serialize(self) -> bytes:
        return struct.pack("<Q", len(self.compressed_polys)) + b"".join(
            serialize_compressed_unipoly(cp) for cp in self.compressed_polys)


@dataclass
class UniSkipFirstRoundProof:
    uni_poly: list[int] = dfield(default_factory=list)

    def serialize(self) -> bytes:
        return struct.pack("<Q", len(self.uni_poly)) + b"".join(
            _w_scalar(c) for c in self.uni_poly)


@dataclass
class ReadWriteConfig:
    ram_rw_phase1_num_rounds: int
    ram_rw_phase2_num_rounds: int
    registers_rw_phase1_num_rounds: int
    registers_rw_phase2_num_rounds: int

    LOG_REGISTER_COUNT = 7

    @classmethod
    def default(cls, log_t: int, log_k: int) -> "ReadWriteConfig":
        return cls(log_t // 2, log_k, log_t // 2, cls.LOG_REGISTER_COUNT)

    def serialize(self) -> bytes:
        return bytes([self.ram_rw_phase1_num_rounds, self.ram_rw_phase2_num_rounds,
                      self.registers_rw_phase1_num_rounds, self.registers_rw_phase2_num_rounds])


@dataclass
class OneHotConfig:
    log_k_chunk: int = 4
    lookups_ra_virtual_log_k_chunk: int = 16

    def serialize(self) -> bytes:
        return bytes([self.log_k_chunk, self.lookups_ra_virtual_log_k_chunk])


@dataclass
class JoltProof:
    """The 7-stage Jolt proof container (jolt_types.zig:679-788)."""

    opening_claims: OpeningClaims = dfield(default_factory=OpeningClaims)
    commitments: list[bytes] = dfield(default_factory=list)  # 384B GT each
    stage1_uni_skip: UniSkipFirstRoundProof | None = None
    stage1_sumcheck: SumcheckInstanceProof = dfield(default_factory=SumcheckInstanceProof)
    stage2_uni_skip: UniSkipFirstRoundProof | None = None
    stage2_sumcheck: SumcheckInstanceProof = dfield(default_factory=SumcheckInstanceProof)
    stage3_sumcheck: SumcheckInstanceProof = dfield(default_factory=SumcheckInstanceProof)
    stage4_sumcheck: SumcheckInstanceProof = dfield(default_factory=SumcheckInstanceProof)
    stage5_sumcheck: SumcheckInstanceProof = dfield(default_factory=SumcheckInstanceProof)
    stage6_sumcheck: SumcheckInstanceProof = dfield(default_factory=SumcheckInstanceProof)
    stage7_sumcheck: SumcheckInstanceProof = dfield(default_factory=SumcheckInstanceProof)
    joint_opening_proof: bytes | None = None
    untrusted_advice_commitment: bytes | None = None
    # Sound-mode PCS binding: serialized pcs/batch.BatchOpeningProof tying
    # the committed-poly opening claims to the GT commitments. Optional
    # trailing section in both container layouts (absent in
    # reference-compat proofs, preserving golden byte-exactness).
    batch_opening: bytes | None = None
    # Sound-mode lookups argument (stages 8-12, zkvm/sound_lookups.py):
    # optional trailing section after batch_opening in both layouts.
    lookups_ext: bytes | None = None
    trace_length: int = 0
    ram_k: int = 0
    bytecode_k: int = 0
    rw_config: ReadWriteConfig = dfield(default_factory=lambda: ReadWriteConfig.default(8, 16))
    one_hot_config: OneHotConfig = dfield(default_factory=OneHotConfig)
    dory_layout: int = 0  # Wide

    def serialize(self) -> bytes:
        """Arkworks container layout (jolt_serialization.zig:296-380)."""
        out = [self.opening_claims.serialize(),
               struct.pack("<Q", len(self.commitments))]
        out.extend(self.commitments)
        if self.stage1_uni_skip is not None:
            out.append(self.stage1_uni_skip.serialize())
        out.append(self.stage1_sumcheck.serialize())
        if self.stage2_uni_skip is not None:
            out.append(self.stage2_uni_skip.serialize())
        out.append(self.stage2_sumcheck.serialize())
        for sc in (self.stage3_sumcheck, self.stage4_sumcheck, self.stage5_sumcheck,
                   self.stage6_sumcheck, self.stage7_sumcheck):
            out.append(sc.serialize())
        if self.joint_opening_proof is not None:
            out.append(self.joint_opening_proof)
        if self.untrusted_advice_commitment is not None:
            out.append(b"\x01" + self.untrusted_advice_commitment)
        else:
            out.append(b"\x00")
        out.append(struct.pack("<QQQ", self.trace_length, self.ram_k, self.bytecode_k))
        out.append(self.rw_config.serialize())
        out.append(self.one_hot_config.serialize())
        out.append(bytes([self.dory_layout]))
        if self.batch_opening is not None or self.lookups_ext is not None:
            bo = self.batch_opening or b""
            out.append(b"\x01" + struct.pack("<Q", len(bo)) + bo)
        if self.lookups_ext is not None:
            out.append(b"\x01" + struct.pack("<Q", len(self.lookups_ext))
                       + self.lookups_ext)
        return b"".join(out)

    def serialize_with_dory(self) -> bytes:
        """The proof-file layout (reference src/zkvm/mod.zig:1400-1462,
        serializeJoltProofWithDory): joint Dory proof between stage 7 and the
        tail, five None flags, and a 5×u64 config tail."""
        out = [self.opening_claims.serialize(),
               struct.pack("<Q", len(self.commitments))]
        out.extend(self.commitments)
        out.append(self.stage1_uni_skip.serialize() if self.stage1_uni_skip
                   else struct.pack("<Q", 0))
        out.append(self.stage1_sumcheck.serialize())
        out.append(self.stage2_uni_skip.serialize() if self.stage2_uni_skip
                   else struct.pack("<Q", 0))
        out.append(self.stage2_sumcheck.serialize())
        for sc in (self.stage3_sumcheck, self.stage4_sumcheck, self.stage5_sumcheck,
                   self.stage6_sumcheck, self.stage7_sumcheck):
            out.append(sc.serialize())
        if self.joint_opening_proof:
            out.append(self.joint_opening_proof)
        else:
            out.append(struct.pack("<Q", 0))  # empty-proof marker
        out.append(b"\x00" * 5)
        out.append(struct.pack("<QQQQQ", self.trace_length, self.ram_k,
                               self.bytecode_k, self.one_hot_config.log_k_chunk,
                               self.one_hot_config.lookups_ra_virtual_log_k_chunk))
        if self.batch_opening is not None or self.lookups_ext is not None:
            bo = self.batch_opening or b""
            out.append(b"\x01" + struct.pack("<Q", len(bo)) + bo)
        if self.lookups_ext is not None:
            out.append(b"\x01" + struct.pack("<Q", len(self.lookups_ext))
                       + self.lookups_ext)
        return b"".join(out)
