"""Sound-mode stage 5: RegistersValEvaluation — the REAL protocol behind the
reference's zero-proof placeholder (src/zkvm/proof_converter.zig:2629-2643,
src/zkvm/claim_reductions/mod.zig RegistersClaimReduction* placeholders).

Proves the stage-4 registers read/write-checking val opening from write
structure: with RdWa(k,j) the one-hot rd-write indicator and Inc(j) the rd
write delta (the committed RdInc polynomial),

    Val(k, j) = Σ_{j' < j} RdWa(k, j')·Inc(j')
  ⇒ Val(r_k, r_cycle) = Σ_j RdWa(r_k, j)·Inc(j)·LT(j, r_cycle)

so the sumcheck (n_cycle rounds, degree 3) reduces the prover-emitted val
claim to: a virtual RdWa opening, a COMMITTED RdInc opening (fed to the
PCS batch opening — pcs/batch.py), and a public LT evaluation the verifier
computes itself. Mirrors the RAM analog stage4.ValEvaluationProver.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

from ..field.params import FR
from ..poly import unipoly
from .stage2_batch import eval_from_hint
from .stage4 import LOG_K, _eq_le, _lt_table_fr

P = FR.p

_NO_RD = {0x23, 0x63}


def lt_eval(x_le: list[int], y_le: list[int]) -> int:
    """LT MLE at two field points (little-endian): Σ_i (1−x_i)·y_i·Π_{k>i}
    eq(x_k, y_k) — the x < y indicator's multilinear extension."""
    n = len(x_le)
    assert len(y_le) == n
    # suffix products of eq factors
    suffix = [1] * (n + 1)
    for k in range(n - 1, -1, -1):
        eq_k = (x_le[k] * y_le[k] + (1 - x_le[k]) * (1 - y_le[k])) % P
        suffix[k] = suffix[k + 1] * eq_k % P
    out = 0
    for i in range(n):
        out = (out + (1 - x_le[i]) * y_le[i] % P * suffix[i + 1]) % P
    return out


@dataclass
class Stage5Result:
    compressed_polys: list[list[int]] = dfield(default_factory=list)
    challenges: list[int] = dfield(default_factory=list)
    final_claim: int = 0
    wa_claim: int = 0
    inc_claim: int = 0
    lt_claim: int = 0


def regs_bind_points(s4_challenges: list[int], n_cycle_vars: int):
    """(r_k_le, r_cycle_le) of the stage-4 registers instance's final point
    (stage4.Stage4RegistersProver bind order: cycle phase 1, registers,
    cycle phase 3 — all low-bit-first)."""
    p1 = n_cycle_vars // 2
    r_k_le = list(s4_challenges[p1:p1 + LOG_K])
    r_cycle_le = list(s4_challenges[:p1]) + list(s4_challenges[p1 + LOG_K:])
    return r_k_le, r_cycle_le


def prove_stage5(transcript, padded_steps, s4_res,
                 n_cycle_vars: int) -> Stage5Result:
    """Registers val-evaluation sumcheck on the live transcript."""
    res = Stage5Result()
    T = 1 << n_cycle_vars
    r_k_le, r_cycle_le = regs_bind_points(s4_res.challenges, n_cycle_vars)

    wa = [0] * T
    inc = [0] * T
    regs = [0] * 128
    for j, step in enumerate(padded_steps):
        if getattr(step, "is_noop", False):
            continue
        instr = step.instruction
        opcode = instr & 0x7F
        # 7-bit rd: virtual rows (vm/virtual.py) write scratch x32..
        rd = ((instr >> 7) & 0x1F) | (((instr >> 32) & 0x3) << 5)
        if opcode not in _NO_RD and rd != 0:
            wa[j] = _eq_le(r_k_le, rd)
            inc[j] = (step.rd_value - regs[rd]) % P
            regs[rd] = step.rd_value
    from ..native.frvec import FrVec

    wa = FrVec.from_ints(wa)
    inc = FrVec.from_ints(inc)
    lt = _lt_table_fr(r_cycle_le, n_cycle_vars)

    claim = s4_res.regs_claims["val"] % P
    for rnd in range(n_cycle_vars):
        p = FrVec.prod_evals_adj([wa, inc, lt], 3)
        ev = [p[0], (claim - p[0]) % P, p[2], p[3]]

        compressed = unipoly.evals_to_compressed(ev)
        res.compressed_polys.append(compressed)
        transcript.append_message(b"UniPoly_begin")
        for c in compressed:
            transcript.append_scalar(c)
        transcript.append_message(b"UniPoly_end")
        r = transcript.challenge_scalar()
        res.challenges.append(r)
        claim = eval_from_hint(compressed, claim, r)
        wa = wa.fold_adj(r)
        inc = inc.fold_adj(r)
        lt = lt.fold_adj(r)

    res.final_claim = claim
    res.wa_claim, res.inc_claim = wa.first(), inc.first()
    res.lt_claim = lt.first()
    transcript.append_scalar(res.wa_claim)
    transcript.append_scalar(res.inc_claim)
    return res
