"""Deserializer for the arkworks-style Jolt proof container.

Inverse of JoltProof.serialize (reference src/zkvm/jolt_serialization.zig:
ArkworksDeserializer + writeJoltProof layout): opening claims, GT commitments,
per-stage UniSkip/sumcheck proofs, configs.
"""

from __future__ import annotations

import struct

from .jolt_types import (
    CommittedPolynomial,
    JoltProof,
    OneHotConfig,
    OpeningId,
    ReadWriteConfig,
    SumcheckId,
    SumcheckInstanceProof,
    UniSkipFirstRoundProof,
    VirtualPolynomial,
    SUMCHECK_ID_COUNT,
    UNTRUSTED_ADVICE_BASE,
    TRUSTED_ADVICE_BASE,
    COMMITTED_BASE,
    VIRTUAL_BASE,
    _VAR_COMMITTED,
    _VAR_VIRTUAL,
    _VAR_UNTRUSTED,
    _VAR_TRUSTED,
)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def u64(self) -> int:
        v = struct.unpack_from("<Q", self.data, self.pos)[0]
        self.pos += 8
        return v

    def u8(self) -> int:
        v = self.data[self.pos]
        self.pos += 1
        return v

    def take(self, n: int) -> bytes:
        v = self.data[self.pos : self.pos + n]
        assert len(v) == n, "unexpected EOF"
        self.pos += n
        return v

    def scalar(self) -> int:
        return int.from_bytes(self.take(32), "little")


def _read_opening_id(r: _Reader) -> OpeningId:
    disc = r.u8()
    if disc < TRUSTED_ADVICE_BASE:
        return OpeningId(_VAR_UNTRUSTED, None, SumcheckId(disc - UNTRUSTED_ADVICE_BASE))
    if disc < COMMITTED_BASE:
        return OpeningId(_VAR_TRUSTED, None, SumcheckId(disc - TRUSTED_ADVICE_BASE))
    if disc < VIRTUAL_BASE:
        sid = SumcheckId(disc - COMMITTED_BASE)
        tag = r.u8()
        idx = r.u8() if tag in (2, 3, 4) else 0
        return OpeningId.committed(CommittedPolynomial(tag, idx), sid)
    sid = SumcheckId(disc - VIRTUAL_BASE)
    tag = r.u8()
    idx = r.u8() if tag in VirtualPolynomial._PAYLOAD_TAGS else 0
    return OpeningId.virtual(VirtualPolynomial(tag, idx), sid)


def _read_sumcheck(r: _Reader) -> SumcheckInstanceProof:
    n = r.u64()
    proof = SumcheckInstanceProof()
    for _ in range(n):
        m = r.u64()
        proof.compressed_polys.append([r.scalar() for _ in range(m)])
    return proof


def _read_uniskip(r: _Reader) -> UniSkipFirstRoundProof:
    n = r.u64()
    return UniSkipFirstRoundProof([r.scalar() for _ in range(n)])


def _read_dory_proof_blob(r: _Reader) -> bytes:
    """Consume a serialized DoryProof (jolt_serialization.zig:148-175) and
    return its raw bytes. Layout: GT c, GT d2, G1c e1, u32 n, n×(4·GT + G1c +
    G2c), n×(2·GT + 2·G1c + 2·G2c), G1c, G2c, u32 nu, u32 sigma."""
    start = r.pos
    r.take(384 * 2 + 32)
    n = struct.unpack_from("<I", r.data, r.pos)[0]
    r.pos += 4
    r.take(n * (4 * 384 + 32 + 64))
    r.take(n * (2 * 384 + 2 * 32 + 2 * 64))
    r.take(32 + 64 + 8)
    return r.data[start : r.pos]


def deserialize_jolt_proof(data: bytes, *, variant: str = "canonical") -> JoltProof:
    """Parse a serialized Jolt proof.

    variant="canonical": writeJoltProof layout (jolt_serialization.zig:296-380).
    variant="with_dory": serializeJoltProofWithDory file layout
      (src/zkvm/mod.zig:1400-1462) — joint Dory proof between stage 7 and the
      config tail, 5 None flags, and 5 u64s with no rw_config/dory_layout.
    """
    r = _Reader(data)
    proof = JoltProof()
    n_claims = r.u64()
    for _ in range(n_claims):
        oid = _read_opening_id(r)
        proof.opening_claims.insert(oid, r.scalar())
    n_comms = r.u64()
    proof.commitments = [bytes(r.take(384)) for _ in range(n_comms)]
    proof.stage1_uni_skip = _read_uniskip(r)
    proof.stage1_sumcheck = _read_sumcheck(r)
    proof.stage2_uni_skip = _read_uniskip(r)
    proof.stage2_sumcheck = _read_sumcheck(r)
    proof.stage3_sumcheck = _read_sumcheck(r)
    proof.stage4_sumcheck = _read_sumcheck(r)
    proof.stage5_sumcheck = _read_sumcheck(r)
    proof.stage6_sumcheck = _read_sumcheck(r)
    proof.stage7_sumcheck = _read_sumcheck(r)
    if variant == "with_dory":
        proof.joint_opening_proof = _read_dory_proof_blob(r)
        for _ in range(5):  # advice proof/commitment None flags
            assert r.u8() == 0
        proof.trace_length = r.u64()
        proof.ram_k = r.u64()
        proof.bytecode_k = r.u64()
        log_k_chunk = r.u64()
        lookups_chunk = r.u64()
        proof.one_hot_config = OneHotConfig(log_k_chunk, lookups_chunk)
    else:
        advice = r.u8()
        if advice:
            proof.untrusted_advice_commitment = bytes(r.take(384))
        proof.trace_length = r.u64()
        proof.ram_k = r.u64()
        proof.bytecode_k = r.u64()
        proof.rw_config = ReadWriteConfig(r.u8(), r.u8(), r.u8(), r.u8())
        proof.one_hot_config = OneHotConfig(r.u8(), r.u8())
        proof.dory_layout = r.u8()
    # optional sound-mode trailing sections (absent in reference proofs):
    # first the PCS batch opening, then the stage-8-12 lookups extension
    if r.pos < len(data) and r.u8() == 1:
        n = r.u64()
        proof.batch_opening = bytes(r.take(n)) or None
    if r.pos < len(data) and r.u8() == 1:
        n = r.u64()
        proof.lookups_ext = bytes(r.take(n))
    assert r.pos == len(data), f"trailing bytes: {len(data) - r.pos}"
    return proof
