"""Mock commitment scheme — hash-based PCS stand-in for protocol tests
(reference src/poly/commitment/mod.zig:64-96: XOR/hash of the evaluations;
binding for tests, no hiding, no succinctness).
"""

from __future__ import annotations

import hashlib

from ..field.params import FR

P = FR.p


def commit(evals: list[int]) -> bytes:
    h = hashlib.blake2b(digest_size=32)
    h.update(len(evals).to_bytes(8, "little"))
    for v in evals:
        h.update((v % P).to_bytes(32, "little"))
    return h.digest()


def open_at(evals: list[int], point: list[int]) -> tuple[int, list[int]]:
    """Returns (value, proof) where the 'proof' is the full evaluation list —
    the verifier recomputes everything (test-grade)."""
    x = [v % P for v in evals]
    for r in point:
        half = len(x) // 2
        x = [(x[2 * i] + r * (x[2 * i + 1] - x[2 * i])) % P for i in range(half)]
    return x[0], [v % P for v in evals]


def verify(commitment: bytes, point: list[int], value: int,
           proof: list[int]) -> bool:
    if commit(proof) != commitment:
        return False
    x = list(proof)
    for r in point:
        half = len(x) // 2
        x = [(x[2 * i] + r * (x[2 * i + 1] - x[2 * i])) % P for i in range(half)]
    return x[0] == value % P
