"""KZG structured reference strings.

Insecure deterministic setup for tests (known τ — matches the reference's test
path, src/poly/commitment/mod.zig:174-189, τ = 0x12345678); PTAU ceremony-file
loading mirrors reference srs.zig (see `load_ptau` below).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curve import g2 as G2
from ..curve import host as G1
from ..field.params import FP, FR

INSECURE_TAU = 0x12345678


@dataclass
class KZGSRS:
    powers_g1: list  # [G, τG, τ²G, ...] host affine points
    tau_g2: tuple    # [τ]₂
    g1: tuple
    g2: tuple

    @property
    def max_degree(self) -> int:
        return len(self.powers_g1)


def insecure_setup(n: int, tau: int = INSECURE_TAU) -> KZGSRS:
    """Powers-of-τ SRS with a known τ. INSECURE — test/dev only. The native
    tier computes the n scalar multiples as n one-point row MSMs (in
    parallel); without it, one scalar_mul at a time."""
    from ..native import g1_msm_rows_native

    exps = []
    t = 1
    for _ in range(n):
        exps.append(t)
        t = t * tau % FR.p
    powers = g1_msm_rows_native([G1.G1_GEN], [[e] for e in exps])
    if powers is None:
        powers = [G1.scalar_mul(G1.G1_GEN, e) for e in exps]
    return KZGSRS(
        powers_g1=powers,
        tau_g2=G2.scalar_mul(G2.G2_GEN, tau),
        g1=G1.G1_GEN,
        g2=G2.G2_GEN,
    )


# ---------------------------------------------------------------------------
# snarkjs PTAU ceremony files + zolt raw-binary SRS
# (reference src/poly/commitment/srs.zig:264-330, 521-910)
# ---------------------------------------------------------------------------

import struct as _struct
from dataclasses import dataclass as _dataclass, field as _dfield

PTAU_MAGIC = b"ptau"

_PTAU_HEADER = 1
_PTAU_TAU_G1 = 2
_PTAU_TAU_G2 = 3
_PTAU_ALPHA_TAU_G1 = 4
_PTAU_BETA_TAU_G1 = 5
_PTAU_BETA_G2 = 6


class SRSError(ValueError):
    pass


@_dataclass
class ExtendedSRS:
    powers_of_tau_g1: list = _dfield(default_factory=list)
    powers_of_tau_g2: list = _dfield(default_factory=list)
    alpha_tau_g1: list | None = None
    beta_tau_g1: list | None = None
    beta_g2: tuple | None = None
    power: int = 0
    ceremony_power: int = 0

    def to_basic(self) -> "KZGSRS":
        """toBasicSRS (srs.zig:593-612)."""
        tau_g2 = (self.powers_of_tau_g2[1] if len(self.powers_of_tau_g2) > 1
                  else G2.G2_GEN)
        g1 = self.powers_of_tau_g1[0] if self.powers_of_tau_g1 else G1.G1_GEN
        g2 = self.powers_of_tau_g2[0] if self.powers_of_tau_g2 else G2.G2_GEN
        return KZGSRS(powers_g1=list(self.powers_of_tau_g1), tau_g2=tau_g2,
                      g1=g1, g2=g2)


def _parse_g1_le(data: bytes):
    """64-byte x‖y little-endian canonical; all-zero = identity."""
    if len(data) < 64:
        raise SRSError("truncated G1 point")
    if not any(data[:64]):
        return None
    x = int.from_bytes(data[:32], "little")
    y = int.from_bytes(data[32:64], "little")
    if (y * y - x * x * x - 3) % FP.p != 0:
        raise SRSError("G1 point not on curve")
    return (x, y)


def _parse_g2_le(data: bytes):
    if len(data) < 128:
        raise SRSError("truncated G2 point")
    if not any(data[:128]):
        return None
    x0 = int.from_bytes(data[0:32], "little")
    x1 = int.from_bytes(data[32:64], "little")
    y0 = int.from_bytes(data[64:96], "little")
    y1 = int.from_bytes(data[96:128], "little")
    return ((x0, x1), (y0, y1))


def _parse_g1_be(data: bytes):
    if len(data) < 64:
        raise SRSError("truncated G1 point")
    if not any(data[:64]):
        return None
    x = int.from_bytes(data[:32], "big")
    y = int.from_bytes(data[32:64], "big")
    if (y * y - x * x * x - 3) % FP.p != 0:
        raise SRSError("G1 point not on curve")
    return (x, y)


def _parse_g2_be(data: bytes):
    if len(data) < 128:
        raise SRSError("truncated G2 point")
    x0 = int.from_bytes(data[0:32], "big")
    x1 = int.from_bytes(data[32:64], "big")
    y0 = int.from_bytes(data[64:96], "big")
    y1 = int.from_bytes(data[96:128], "big")
    return ((x0, x1), (y0, y1))


def load_ptau(data: bytes) -> ExtendedSRS:
    """Parse a snarkjs PTAU ceremony file (srs.zig loadFromPtau)."""
    if len(data) < 12:
        raise SRSError("truncated ptau file")
    if data[:4] != PTAU_MAGIC:
        raise SRSError("bad ptau magic")
    version = _struct.unpack_from("<I", data, 4)[0]
    if version != 1:
        raise SRSError(f"unsupported ptau version {version}")
    num_sections = _struct.unpack_from("<I", data, 8)[0]
    sections = {}
    off = 12
    for _ in range(num_sections):
        if off + 12 > len(data):
            raise SRSError("truncated section table")
        stype = _struct.unpack_from("<I", data, off)[0]
        ssize = _struct.unpack_from("<Q", data, off + 4)[0]
        off += 12
        sections[stype] = (off, ssize)
        off += ssize

    if _PTAU_HEADER not in sections:
        raise SRSError("missing ptau header section")
    hoff, hsize = sections[_PTAU_HEADER]
    header = data[hoff : hoff + hsize]
    if len(header) < 44:
        raise SRSError("truncated ptau header")
    field_size = _struct.unpack_from("<I", header, 0)[0]
    if field_size != 32:
        raise SRSError(f"unsupported field size {field_size}")
    power = _struct.unpack_from("<I", header, 36)[0]
    ceremony_power = _struct.unpack_from("<I", header, 40)[0]

    srs = ExtendedSRS(power=power, ceremony_power=ceremony_power)
    n_g1 = (1 << power) * 2 - 1
    n_g2 = (1 << power) + 1
    if _PTAU_TAU_G1 in sections:
        soff, ssize = sections[_PTAU_TAU_G1]
        n = min(n_g1, ssize // 64)
        srs.powers_of_tau_g1 = [
            _parse_g1_le(data[soff + i * 64 :]) for i in range(n)]
    if _PTAU_TAU_G2 in sections:
        soff, ssize = sections[_PTAU_TAU_G2]
        n = min(n_g2, ssize // 128)
        srs.powers_of_tau_g2 = [
            _parse_g2_le(data[soff + i * 128 :]) for i in range(n)]
    if _PTAU_ALPHA_TAU_G1 in sections:
        soff, ssize = sections[_PTAU_ALPHA_TAU_G1]
        n = min(1 << power, ssize // 64)
        srs.alpha_tau_g1 = [_parse_g1_le(data[soff + i * 64 :]) for i in range(n)]
    if _PTAU_BETA_TAU_G1 in sections:
        soff, ssize = sections[_PTAU_BETA_TAU_G1]
        n = min(1 << power, ssize // 64)
        srs.beta_tau_g1 = [_parse_g1_le(data[soff + i * 64 :]) for i in range(n)]
    if _PTAU_BETA_G2 in sections:
        soff, ssize = sections[_PTAU_BETA_G2]
        if ssize >= 128:
            srs.beta_g2 = _parse_g2_le(data[soff:])
    return srs


def load_raw_binary(data: bytes) -> KZGSRS:
    """zolt raw SRS: u32 count, count×64B G1 BE, 128B τG2, 64B g1, 128B g2
    (srs.zig loadFromRawBinary)."""
    if len(data) < 4:
        raise SRSError("truncated SRS")
    n = _struct.unpack_from("<I", data, 0)[0]
    need = 4 + n * 64 + 128 + 64 + 128
    if len(data) < need:
        raise SRSError("truncated SRS data")
    off = 4
    powers = []
    for _ in range(n):
        powers.append(_parse_g1_be(data[off : off + 64]))
        off += 64
    tau_g2 = _parse_g2_be(data[off : off + 128]); off += 128
    g1 = _parse_g1_be(data[off : off + 64]); off += 64
    g2 = _parse_g2_be(data[off : off + 128])
    return KZGSRS(powers_g1=powers, tau_g2=tau_g2, g1=g1, g2=g2)


def serialize_raw_binary(srs: KZGSRS) -> bytes:
    def g1b(pt):
        if pt is None:
            return b"\x00" * 64
        return pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")

    def g2b(pt):
        (x0, x1), (y0, y1) = pt
        return (x0.to_bytes(32, "big") + x1.to_bytes(32, "big")
                + y0.to_bytes(32, "big") + y1.to_bytes(32, "big"))

    out = [_struct.pack("<I", len(srs.powers_g1))]
    out += [g1b(p) for p in srs.powers_g1]
    out += [g2b(srs.tau_g2), g1b(srs.g1), g2b(srs.g2)]
    return b"".join(out)
