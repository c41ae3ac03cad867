"""Keccak-f[1600] sponge Fiat-Shamir transcript (internal, non-Jolt path).

Byte-exact re-implementation of the reference's internal transcript semantics
(src/transcripts/mod.zig:49-221): a 200-byte sponge with rate 136 absorbed
byte-by-byte; challenges permute the state and read the first 32 bytes as a
little-endian integer reduced mod p. Two quirks are preserved deliberately:

- `append_scalar` absorbs the *Montgomery* limb bytes (not canonical).
- `challenge_*` permutes without resetting the absorb position.
"""

from __future__ import annotations

from ..field.params import FR, R

_RATE = 136
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_ROTC = [1, 3, 6, 10, 15, 21, 28, 36, 45, 55, 2, 14, 27, 41, 56, 8, 25, 43, 62, 18, 39, 61, 20, 44]
_PILN = [10, 7, 11, 17, 18, 3, 5, 16, 8, 21, 24, 4, 15, 23, 19, 13, 12, 2, 20, 14, 22, 9, 6, 1]
_M64 = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (64 - n))) & _M64


def keccak_f(state: bytearray) -> None:
    st = [int.from_bytes(state[i * 8 : i * 8 + 8], "little") for i in range(25)]
    for rnd in range(24):
        bc = [st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20] for i in range(5)]
        for i in range(5):
            t = bc[(i + 4) % 5] ^ _rotl(bc[(i + 1) % 5], 1)
            for j in range(i, 25, 5):
                st[j] ^= t
        t = st[1]
        for i in range(24):
            j = _PILN[i]
            st[j], t = _rotl(t, _ROTC[i]), st[j]
        for j in range(0, 25, 5):
            row = st[j : j + 5]
            for i in range(5):
                st[j + i] = row[i] ^ ((~row[(i + 1) % 5] & _M64) & row[(i + 2) % 5])
        st[0] ^= _RC[rnd]
    for i in range(25):
        state[i * 8 : i * 8 + 8] = st[i].to_bytes(8, "little")


class KeccakTranscript:
    """All scalar args/returns are canonical ints mod p (Fr)."""

    def __init__(self, domain: bytes):
        self.state = bytearray(200)
        self.position = 0
        self.append_bytes(domain)

    def append_bytes(self, data: bytes) -> None:
        for b in data:
            self.state[self.position] ^= b
            self.position += 1
            if self.position >= _RATE:
                keccak_f(self.state)
                self.position = 0

    def append_message(self, label: bytes, message: bytes) -> None:
        self.append_bytes(label)
        self.append_bytes(message)

    def append_scalar(self, label: bytes, x: int) -> None:
        self.append_bytes(label)
        mont = (x * R) % FR.p  # reference absorbs raw Montgomery limbs LE
        self.append_bytes(mont.to_bytes(32, "little"))

    def append_scalars(self, label: bytes, xs) -> None:
        self.append_bytes(label)
        for x in xs:
            self.append_scalar(b"", x)

    def challenge_scalar(self, label: bytes) -> int:
        self.append_bytes(label)
        keccak_f(self.state)
        return int.from_bytes(self.state[:32], "little") % FR.p

    def challenge_scalars(self, label: bytes, n: int) -> list[int]:
        self.append_bytes(label)
        return [self.challenge_scalar(b"") for _ in range(n)]

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.append_bytes(label)
        out = b""
        while len(out) < n:
            keccak_f(self.state)
            out += bytes(self.state[: min(n - len(out), _RATE)])
        return out
