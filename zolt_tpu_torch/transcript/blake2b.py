"""Jolt-compatible Blake2b Fiat-Shamir transcript (host-side, byte-exact).

Re-implements the transcript protocol of Jolt's Blake2bTranscript, as specified
by the reference (src/transcripts/blake2b.zig:25-560):

- 32-byte running state + u32 round counter.
- Every absorb/squeeze computes Blake2b-256(state || [0u8;28] || round_be)
  followed by the payload, then replaces the state and increments the round.
- Scalars are absorbed as canonical big-endian 32-byte values.
- Challenges come in two load-bearing flavors (reference: blake2b.zig:264-392,
  SURVEY §L4): `challenge_scalar` = 125-bit-masked value whose *Montgomery
  limbs* are [0,0,low,high] (so the field value is masked·2^-128 mod p), and
  `challenge_scalar_full` = full 128-bit value lifted normally.

Host field elements are canonical Python ints mod p throughout this codebase;
Montgomery conversions happen only at byte boundaries.
"""

from __future__ import annotations

import hashlib

from ..field.params import FR, R

_MASK_125 = (1 << 125) - 1
_INV_2_128 = pow(1 << 128, -1, FR.p)


def _blake2b256(*chunks: bytes) -> bytes:
    h = hashlib.blake2b(digest_size=32)
    for c in chunks:
        h.update(c)
    return h.digest()


class Blake2bTranscript:
    """Byte-exact Jolt transcript. All scalar args/returns are canonical ints."""

    def __init__(self, label: bytes):
        assert len(label) <= 32
        self.state = _blake2b256(label.ljust(32, b"\x00"))
        self.n_rounds = 0

    # -- internal ----------------------------------------------------------
    def _round_block(self) -> bytes:
        return b"\x00" * 28 + self.n_rounds.to_bytes(4, "big")

    def _absorb(self, payload: bytes) -> None:
        self.state = _blake2b256(self.state, self._round_block(), payload)
        self.n_rounds += 1

    # -- absorb ------------------------------------------------------------
    def append_message(self, msg: bytes) -> None:
        assert len(msg) <= 32
        self._absorb(msg.ljust(32, b"\x00"))

    def append_bytes(self, data: bytes) -> None:
        self._absorb(data)

    def append_u64(self, x: int) -> None:
        self._absorb(b"\x00" * 24 + (x & (2**64 - 1)).to_bytes(8, "big"))

    def append_scalar(self, x: int) -> None:
        """Canonical scalar -> 32-byte BE (LE limbs reversed, per reference)."""
        self._absorb((x % FR.p).to_bytes(32, "big"))

    def append_scalars(self, xs) -> None:
        self.append_message(b"begin_append_vector")
        for x in xs:
            self.append_scalar(x)
        self.append_message(b"end_append_vector")

    def append_point(self, x: int | None, y: int | None = None) -> None:
        """G1 affine point as x||y big-endian; identity = 64 zero bytes
        (reference: blake2b.zig:417-479)."""
        if x is None:  # point at infinity
            self._absorb(b"\x00" * 64)
        else:
            self._absorb(x.to_bytes(32, "big") + y.to_bytes(32, "big"))

    def append_points(self, pts) -> None:
        self.append_message(b"begin_append_vector")
        for p in pts:
            self.append_point(*((p) if p is not None else (None,)))
        self.append_message(b"end_append_vector")

    def append_serializable(self, data: bytes) -> None:
        """Arkworks-serialized bytes, reversed for EVM compat (blake2b.zig:496-524)."""
        self._absorb(bytes(reversed(data)))

    def append_gt(self, gt_bytes: bytes) -> None:
        assert len(gt_bytes) == 384
        self.append_serializable(gt_bytes)

    # -- squeeze -----------------------------------------------------------
    def _challenge_bytes32(self) -> bytes:
        out = _blake2b256(self.state, self._round_block())
        self.state = out
        self.n_rounds += 1
        return out

    def challenge_bytes(self, n: int) -> bytes:
        out = b""
        remaining = n
        while remaining > 32:
            out += self._challenge_bytes32()
            remaining -= 32
        out += self._challenge_bytes32()[:remaining]
        return out

    def challenge_u128(self) -> int:
        buf = self.challenge_bytes(16)
        return int.from_bytes(bytes(reversed(buf)), "big")

    def challenge_scalar(self) -> int:
        """Jolt's challenge_scalar_optimized: 125-bit masked, raw-Montgomery-limb
        semantics -> canonical value = masked * 2^-128 mod p."""
        masked = self.challenge_u128() & _MASK_125
        return (masked * _INV_2_128) % FR.p

    def challenge_scalar_full(self) -> int:
        """Jolt's proper-field challenge: full 128-bit value, no masking.

        Endianness subtlety (reference blake2b.zig:279-310): the reversed buf
        is read as LITTLE-endian limbs here — net effect: the raw challenge
        bytes are interpreted BIG-endian, the opposite of challenge_u128."""
        return int.from_bytes(self.challenge_bytes(16), "big") % FR.p

    def challenge_vector(self, n: int) -> list[int]:
        return [self.challenge_scalar() for _ in range(n)]

    def challenge_scalar_powers(self, n: int) -> list[int]:
        q = self.challenge_scalar()
        out = [1]
        for _ in range(1, n):
            out.append((out[-1] * q) % FR.p)
        return out


def mont_limbs_of_challenge(masked_125: int) -> int:
    """The 256-bit Montgomery representation Jolt stores for an optimized
    challenge: the masked value shifted into the upper limbs."""
    return masked_125 << 128
