"""Generic sumcheck engine: device round-poly evaluation, host transcript.

The port of zolt_tpu/sumcheck/driver.py. The per-round work (the round
polynomial at t = 0..d, and the fold of the tables by the challenge) runs
on the tables' device; the Fiat-Shamir transcript lives on the host, one
host↔device sync a round.

An instance implements:
    num_rounds          — total rounds
    degree              — round-polynomial degree d
    round_evals()       — [p(0), p(1), ..., p(d)] as canonical ints
    bind(r: int)        — fold tables with the round challenge
    final_claims()      — whatever the protocol opens at the end

`run_sumcheck` drives prover+transcript in the Jolt style: append the
compressed round poly, squeeze the 125-bit challenge, bind
(reference: src/subprotocols/mod.zig:18-250, src/zkvm/batched_sumcheck.zig).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

import torch

from ..field import limb
from ..field.evals import product_evals
from ..field.fold import fold
from ..field.params import FR
from ..poly import unipoly

P = FR.p


@dataclass
class SumcheckProof:
    """One sumcheck instance's transcript artifacts (canonical ints)."""

    compressed_polys: list[list[int]] = dfield(default_factory=list)
    challenges: list[int] = dfield(default_factory=list)
    final_claim: int = 0


def run_sumcheck(instance, transcript, claim: int) -> SumcheckProof:
    """Prove one (non-batched) sumcheck instance, Jolt transcript discipline:
    per round append compressed coefficients as a scalar vector, then squeeze a
    125-bit optimized challenge."""
    proof = SumcheckProof()
    for _ in range(instance.num_rounds):
        evals = instance.round_evals()
        coeffs = unipoly.interpolate(evals)
        compressed = unipoly.compress(coeffs)
        transcript.append_scalars(compressed)
        r = transcript.challenge_scalar()
        proof.compressed_polys.append(compressed)
        proof.challenges.append(r)
        instance.bind(r)
        claim = unipoly.horner_eval(coeffs, r)
    proof.final_claim = claim
    return proof


def verify_sumcheck(proof: SumcheckProof, transcript, claim: int,
                    num_rounds: int, degree: int):
    """Mirror verifier: recover c1 from the hint, check claim evolution, and
    reproduce challenges from the transcript. Returns (final_claim, challenges)."""
    challenges = []
    for rnd in range(num_rounds):
        compressed = proof.compressed_polys[rnd]
        assert len(compressed) == degree, f"round {rnd}: wrong poly size"
        coeffs = unipoly.decompress(compressed, claim)
        transcript.append_scalars(compressed)
        r = transcript.challenge_scalar()
        assert r == proof.challenges[rnd], f"round {rnd}: challenge mismatch"
        challenges.append(r)
        claim = unipoly.horner_eval(coeffs, r)
    return claim, challenges


class ProductSumcheck:
    """Σ_x Π_k A_k(x) over the boolean cube — the basic multi-MLE instance.

    polys: k >= 1 (n, 8) Fr word tensors on one device; binds low-to-high
    (Jolt bound_poly_var_bot). Degree = number of factors. Each round is
    one product-evals launch (kernels 2-3 for k = 2, 3; kernel G for any
    other k) and one fold (kernel 1); on the CPU the plain versions."""

    def __init__(self, polys):
        self.tabs = torch.stack([p.contiguous() for p in polys])
        n = self.tabs.shape[1]
        self.num_rounds = n.bit_length() - 1
        self.degree = self.tabs.shape[0]

    def round_evals(self) -> list[int]:
        g = (self.tabs, self.tabs.shape[1] // 2, self.degree)
        return limb.decode(product_evals([g])[0])

    def bind(self, r: int) -> None:
        self.tabs = fold(self.tabs, r, self.tabs.shape[1] // 2)

    def final_claims(self) -> list[int]:
        return limb.decode(self.tabs[:, 0])


def initial_claim_product(polys) -> int:
    """Σ_x Π_k A_k(x) on the tables' device: p(0) + p(1) of the first
    round's product evals (kernels 2-3 or G on a card, the plain versions
    on the CPU, for any k >= 1). A table of one entry is padded with a
    zero one, whose pair adds 0 to p(1)."""
    tabs = torch.stack([p.contiguous() for p in polys])
    if tabs.shape[1] == 1:
        tabs = torch.cat([tabs, torch.zeros_like(tabs)], dim=1)
    ev = limb.decode(product_evals([(tabs, tabs.shape[1] // 2, 1)])[0])
    return (ev[0] + ev[1]) % P
