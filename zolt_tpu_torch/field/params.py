"""BN254 field parameters.

The primes and Montgomery constants are standard public parameters of the BN254
(alt_bn128) curve. The reference implementation stores them as 4x u64 limbs
(reference: src/field/mod.zig:16-75); here everything is derived from the prime
itself as Python ints, and the device-side limb tables are computed for the
TPU-native radix (2^16, 16 limbs in uint32 lanes).

Montgomery representation uses R = 2^256 for both radixes, so Montgomery-form
values are bit-identical to the reference's.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

# BN254 scalar field (Fr) prime — order of G1/G2.
P_FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617
# BN254 base field (Fp) prime — coordinate field of G1; q in the literature.
P_FP = 21888242871839275222246405745257275088696311157297823662689037894645226208583

R_BITS = 256
R = 1 << R_BITS  # Montgomery R = 2^256 (same as reference, 4x64 or 16x16 limbs)

# Device limb layout: LIMB_BITS-bit limbs held in uint32 lanes, least significant
# limb first. 16-bit limbs make every CIOS partial product + carry fit exactly in
# uint32 (max (2^16-1)^2 + 2*(2^16-1) = 2^32 - 1), so the whole Montgomery
# multiply runs in native 32-bit VPU arithmetic with no emulated wide types.
LIMB_BITS = 16
N_LIMBS = R_BITS // LIMB_BITS  # 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def to_limbs(x: int, n: int = N_LIMBS, bits: int = LIMB_BITS) -> list[int]:
    """Split a nonnegative int into n little-endian limbs of `bits` bits."""
    mask = (1 << bits) - 1
    return [(x >> (bits * i)) & mask for i in range(n)]


def from_limbs(limbs, bits: int = LIMB_BITS) -> int:
    return sum(int(l) << (bits * i) for i, l in enumerate(limbs))


@dataclass(frozen=True)
class FieldParams:
    """All constants needed for host + device arithmetic in one prime field."""

    name: str
    p: int

    @property
    def r(self) -> int:  # Montgomery R mod p
        return R % self.p

    @property
    def r2(self) -> int:  # R^2 mod p
        return (R * R) % self.p

    @property
    def r3(self) -> int:
        return (R * R * R) % self.p

    @property
    def inv(self) -> int:
        """-p^{-1} mod 2^LIMB_BITS (CIOS per-limb reduction factor)."""
        return (-pow(self.p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    @property
    def inv64(self) -> int:
        """-p^{-1} mod 2^64 (reference limb layout; used for serialization checks)."""
        return (-pow(self.p, -1, 1 << 64)) % (1 << 64)

    @property
    def p_limbs(self) -> list[int]:
        return to_limbs(self.p)

    @property
    def r_limbs(self) -> list[int]:
        return to_limbs(self.r)

    @property
    def r2_limbs(self) -> list[int]:
        return to_limbs(self.r2)

    def mont(self, x: int) -> int:
        """Canonical int -> Montgomery form int (x * R mod p)."""
        return (x * R) % self.p

    def unmont(self, x: int) -> int:
        """Montgomery form int -> canonical int (x * R^{-1} mod p)."""
        return (x * pow(R, -1, self.p)) % self.p


FR = FieldParams("fr", P_FR)
FP = FieldParams("fp", P_FP)


@functools.cache
def _check_reference_constants() -> bool:
    """Sanity: derived constants match the reference's published 4x64 tables
    (reference: src/field/mod.zig:16-75)."""
    assert to_limbs(FR.r, 4, 64) == [
        0xAC96341C4FFFFFFB, 0x36FC76959F60CD29, 0x666EA36F7879462E, 0x0E0A77C19A07DF2F]
    assert to_limbs(FR.r2, 4, 64) == [
        0x1BB8E645AE216DA7, 0x53FE3AB1E35C59E3, 0x8C49833D53BB8085, 0x0216D0B17F4E44A5]
    assert FR.inv64 == 0xC2E1F593EFFFFFFF
    assert to_limbs(FP.r, 4, 64) == [
        0xD35D438DC58F0D9D, 0x0A78EB28F5C70B3D, 0x666EA36F7879462C, 0x0E0A77C19A07DF2F]
    assert FP.inv64 == 0x87D20782E4866389
    return True
