"""Proof serialization: native binary format + JSON.

Native format mirrors the reference's container discipline
(src/zkvm/serialization.zig:15-35): magic "ZOLT", version u32, then the nested
proof layout. Field elements are 32-byte little-endian canonical values.
The Jolt/arkworks format is zkvm/jolt_types.py's. The port of
zolt_tpu/serialization.py, as written.
"""

from __future__ import annotations

import json
import struct

from .zkvm.prover import MultiStageProof
from .zkvm.stages import StageProof

MAGIC = b"ZOLT"
# v2: distinct from the internal reference-parity container (internal.py),
# which owns "ZOLT" v1 — the two formats share the magic and are routed by
# this version word.
VERSION = 2


def _w_scalar(x: int) -> bytes:
    return (x % (1 << 256)).to_bytes(32, "little")


def _w_vec(xs: list[int]) -> bytes:
    return struct.pack("<Q", len(xs)) + b"".join(_w_scalar(x) for x in xs)


def serialize(proof: MultiStageProof) -> bytes:
    out = [MAGIC, struct.pack("<IQQ", VERSION, proof.log_t, proof.log_k),
           struct.pack("<Q", len(proof.stage_proofs))]
    for sp in proof.stage_proofs:
        out.append(struct.pack("<Q", len(sp.round_polys)))
        for rp in sp.round_polys:
            out.append(_w_vec(rp))
        out.append(_w_vec(sp.challenges))
        out.append(_w_vec(sp.final_claims))
    return b"".join(out)


def _r_scalar(data: bytes, off: int) -> tuple[int, int]:
    return int.from_bytes(data[off : off + 32], "little"), off + 32


def _r_vec(data: bytes, off: int) -> tuple[list[int], int]:
    (n,) = struct.unpack_from("<Q", data, off)
    off += 8
    xs = []
    for _ in range(n):
        x, off = _r_scalar(data, off)
        xs.append(x)
    return xs, off


def deserialize(data: bytes) -> MultiStageProof:
    assert data[:4] == MAGIC, "bad magic"
    version, log_t, log_k = struct.unpack_from("<IQQ", data, 4)
    assert version == VERSION, f"unsupported version {version}"
    off = 4 + 4 + 16
    (n_stages,) = struct.unpack_from("<Q", data, off)
    off += 8
    proof = MultiStageProof(log_t=log_t, log_k=log_k)
    for _ in range(n_stages):
        sp = StageProof()
        (n_rp,) = struct.unpack_from("<Q", data, off)
        off += 8
        for _ in range(n_rp):
            rp, off = _r_vec(data, off)
            sp.round_polys.append(rp)
        sp.challenges, off = _r_vec(data, off)
        sp.final_claims, off = _r_vec(data, off)
        proof.stage_proofs.append(sp)
    return proof


def to_json(proof: MultiStageProof) -> str:
    return json.dumps({
        "version": VERSION,
        "log_t": proof.log_t,
        "log_k": proof.log_k,
        "stages": [
            {
                "round_polys": [[hex(x) for x in rp] for rp in sp.round_polys],
                "challenges": [hex(x) for x in sp.challenges],
                "final_claims": [hex(x) for x in sp.final_claims],
            }
            for sp in proof.stage_proofs
        ],
    })


def from_json(s: str) -> MultiStageProof:
    d = json.loads(s)
    proof = MultiStageProof(log_t=d["log_t"], log_k=d["log_k"])
    for st in d["stages"]:
        sp = StageProof(
            round_polys=[[int(x, 16) for x in rp] for rp in st["round_polys"]],
            challenges=[int(x, 16) for x in st["challenges"]],
            final_claims=[int(x, 16) for x in st["final_claims"]],
        )
        proof.stage_proofs.append(sp)
    return proof


def detect_format(data: bytes) -> str:
    if data[:4] == MAGIC:
        return "native"
    if data[:2] == b"\x1f\x8b":
        return "gzip"
    try:
        json.loads(data.decode())
        return "json"
    except Exception:
        return "unknown"


# ---------------------------------------------------------------------------
# gzip container (reference serialization.zig gzip compress path)
# ---------------------------------------------------------------------------

def serialize_gzip(proof: MultiStageProof) -> bytes:
    """Native ZOLT container wrapped in gzip (reference serialization.zig:15-35
    compress path). Autodetected by the 0x1f8b magic."""
    import gzip

    return gzip.compress(serialize(proof), mtime=0)


def load_auto(data: bytes) -> MultiStageProof:
    """Format-autodetecting reader: native / gzip-wrapped native / JSON
    (reference zkvm/mod.zig:61-93 readProofAutoDetectFull)."""
    fmt = detect_format(data)
    if fmt == "gzip":
        import gzip

        inner = gzip.decompress(data)
        return load_auto(inner)
    if fmt == "json":
        return from_json(data.decode())
    if fmt == "native":
        return deserialize(data)
    raise ValueError("unrecognized proof format")
