"""Poseidon transcript over BN254 Fr (reference src/transcripts/mod.zig:233-375).

Same construction as the reference's PoseidonTranscript: t=3 state, x^5
S-box, 8 full + 56 partial rounds, circulant [2,1,1] MDS matrix, and the
reference's deterministic (splitmix-style) round-constant derivation. Like
the reference, this is a SNARK-friendly transcript for recursive-verifier
experiments — the production Fiat-Shamir paths are Blake2b (Jolt) and
Keccak (internal)."""

from __future__ import annotations

from ..field.params import FR

P = FR.p

FULL_ROUNDS = 8
PARTIAL_ROUNDS = 56
STATE_WIDTH = 3

_M64 = (1 << 64) - 1


def _derive_round_constant(rnd: int, index: int) -> int:
    seed = 0x9E3779B97F4A7C15
    seed ^= (rnd * 0xC4CEB9FE1A85EC53) & _M64
    seed ^= (index * 0xFF51AFD7ED558CCD) & _M64
    seed ^= seed >> 33
    seed = (seed * 0xFF51AFD7ED558CCD) & _M64
    seed ^= seed >> 33
    return seed % P


_ROUND_CONSTANTS = [
    [_derive_round_constant(r, i) for i in range(STATE_WIDTH)]
    for r in range(FULL_ROUNDS + PARTIAL_ROUNDS)
]


def _sbox(x: int) -> int:
    x2 = x * x % P
    x4 = x2 * x2 % P
    return x4 * x % P


class PoseidonTranscript:
    def __init__(self, domain: bytes = b""):
        self.state = [0, 0, 0]
        if domain:
            h = 0
            for byte in domain:
                h = (h * 31 + byte) & _M64
            self.state[0] = h % P
        self.round_counter = 0

    # -- permutation --------------------------------------------------------
    def _mds(self) -> None:
        s0, s1, s2 = self.state
        self.state = [(2 * s0 + s1 + s2) % P,
                      (s0 + 2 * s1 + s2) % P,
                      (s0 + s1 + 2 * s2) % P]

    def _full_round(self, rnd: int) -> None:
        rc = _ROUND_CONSTANTS[rnd]
        self.state = [_sbox((s + c) % P) for s, c in zip(self.state, rc)]
        self._mds()

    def _partial_round(self, rnd: int) -> None:
        rc = _ROUND_CONSTANTS[rnd]
        self.state = [(s + c) % P for s, c in zip(self.state, rc)]
        self.state[0] = _sbox(self.state[0])
        self._mds()

    def _permute(self) -> None:
        half = FULL_ROUNDS // 2
        for r in range(half):
            self._full_round(r)
        for r in range(PARTIAL_ROUNDS):
            self._partial_round(r + half)
        for r in range(half):
            self._full_round(r + half + PARTIAL_ROUNDS)
        self.round_counter += 1

    # -- sponge -------------------------------------------------------------
    def absorb(self, element: int) -> None:
        self.state[0] = (self.state[0] + element) % P
        self._permute()

    def squeeze(self) -> int:
        self._permute()
        return self.state[0]

    def absorb_many(self, elements) -> None:
        for e in elements:
            self.absorb(e)

    def challenge_vector(self, n: int) -> list[int]:
        return [self.squeeze() for _ in range(n)]
