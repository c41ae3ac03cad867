"""Lasso read-checking over the FULL 2^128 lookup-index space at XLEN=64.

The reference's internal Lasso caps the address space at materialized
16-bit tables (K = 2^16); the full-width argument needs the prefix–suffix
evaluation strategy (reference src/zkvm/lasso/prefix_suffix.zig:1-18,
src/zkvm/lasso/prover.zig): the table MLE Val(k) is never materialized —
during the address-binding phase it is evaluated at mixed points
(bound-challenge PREFIX ‖ current variable ‖ binary SUFFIX from each
entry's real 128-bit index). vm/tables.evaluate_mle's closed forms
(O(xlen) on mixed points) are exactly the P·Q decomposition evaluator.

Protocol — per lookup table t, on a live Fiat-Shamir transcript:

  input claim:  out_claim = Σ_j eq(r_cycle, j)·Val_t(idx_j)
              = Σ_{k ∈ {0,1}^128} Σ_j eq(r_cycle, j)·[idx_j = k] · Val_t(k)

  Phase A (128 rounds, MSB first, degree 2): bind the address variables.
    The sparse one-hot side collapses per entry to a running prefix
    product Π χ_{r_b}(bit_b(idx_j)); the Val side is evaluated at the
    mixed point per entry.
  Phase B (n_cycle rounds, low bit first, degree 2): the claim is now
    Val_t(r_addr)·Σ_j eq(r_cycle, j)·w_j with w_j the entry's bound
    one-hot weight; bind the cycle variables of eq·w.

  Verifier: replays both phases (compressed degree-2 round polys, c1
  recovered from the running claim), computes Val_t(r_addr) itself from
  the closed form and eq(r_cycle, r_b) in closed form, and checks
      final_claim == Val_t(r_addr) · eq(r_cycle, r_b) · w_claim
  with w_claim the terminal (virtual ra) opening absorbed by the prover.

The port of zolt_tpu/zkvm/lasso64.py: host Python over ints, as written.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

from ..field.params import FR
from ..poly import unipoly
from ..vm import tables as tb

P = FR.p
ADDR_VARS = 128


def _eq_le_bits(r: list[int], idx: int) -> int:
    out = 1
    for i, ri in enumerate(r):
        out = out * (ri if (idx >> i) & 1 else (1 - ri)) % P
    return out


def eq_point_eval(a: list[int], b: list[int]) -> int:
    out = 1
    for x, y in zip(a, b):
        out = out * ((x * y + (1 - x) * (1 - y)) % P) % P
    return out


def _eval2_from_hint(compressed2: list[int], hint: int, x: int) -> int:
    c0, c2 = compressed2[0] % P, compressed2[1] % P
    c1 = (hint - 2 * c0 - c2) % P
    return (c0 + c1 * x + c2 * x * x) % P


def _absorb_round(transcript, compressed: list[int]) -> int:
    transcript.append_message(b"UniPoly_begin")
    for c in compressed:
        transcript.append_scalar(c % P)
    transcript.append_message(b"UniPoly_end")
    return transcript.challenge_scalar()


@dataclass
class Lasso64Proof:
    table: int = 0
    addr_polys: list[list[int]] = dfield(default_factory=list)   # [c0,c2] each
    cycle_polys: list[list[int]] = dfield(default_factory=list)  # [c0,c2] each
    w_claim: int = 0
    out_claim: int = 0


def collect_table_entries(steps, table: tb.Table, memory: bool = False):
    """(cycle, index) pairs of the trace steps consulting `table`
    (vm/lookups classification). `memory=True` also routes the 13
    load/store classes (LoadAddress/StoreAddress + the Lb..Sd value
    classes, vm/lookups.classify_memory_step) through the read check —
    a superset of the reference, which defines but never exercises them."""
    from ..vm.lookups import classify_memory_step, classify_step

    out = []
    for s in steps:
        e = classify_step(s)
        if e is not None and e.table == table:
            out.append((s.cycle, e.index))
        if memory:
            out.extend((s.cycle, me.index) for me in classify_memory_step(s)
                       if me.table == table)
    return out


def prove_lasso64(transcript, entries, table: tb.Table, r_cycle_le: list[int],
                  n_cycle_vars: int) -> Lasso64Proof:
    """entries: [(cycle, 128-bit index)]. r_cycle_le: the cycle point
    (little-endian) the out_claim was bound at."""
    T = 1 << n_cycle_vars
    proof = Lasso64Proof(table=int(table))

    eqv = [_eq_le_bits(r_cycle_le, j) for j in range(T)]
    # per-entry state: cycle weight, one-hot prefix product, index bits
    ents = [[eqv[j], 1, idx] for (j, idx) in entries if j < T]

    out_claim = 0
    for w, _, idx in ents:
        out_claim = (out_claim + w * (tb.materialize_entry(table, idx, 64) % P)) % P
    proof.out_claim = out_claim
    transcript.append_scalar(out_claim)

    # ---- Phase A: address rounds, MSB first --------------------------------
    r_addr: list[int] = []
    claim = out_claim
    for b in range(ADDR_VARS):
        shift = ADDR_VARS - 1 - b
        e0 = e2 = 0
        for w, pref, idx in ents:
            wp = w * pref % P
            if wp == 0:
                continue
            bit = (idx >> shift) & 1
            suffix = [(idx >> (shift - 1 - i)) & 1 for i in range(shift)]
            for c, acc_ix in ((0, 0), (2, 1)):
                chi = c if bit else (1 - c)
                if chi == 0:
                    continue
                val = tb.evaluate_mle(table, r_addr + [c] + suffix, 64)
                term = wp * chi % P * val % P
                if acc_ix == 0:
                    e0 = (e0 + term) % P
                else:
                    e2 = (e2 + term) % P
        e1 = (claim - e0) % P
        compressed = unipoly.compress(unipoly.interpolate([e0, e1, e2]))
        proof.addr_polys.append(compressed)
        r = _absorb_round(transcript, compressed)
        r_addr.append(r)
        claim = _eval2_from_hint(compressed, claim, r)
        for ent in ents:
            bit = (ent[2] >> shift) & 1
            ent[1] = ent[1] * ((r if bit else (1 - r)) % P) % P

    val_r = tb.evaluate_mle(table, r_addr, 64)

    # ---- Phase B: cycle rounds, low bit first ------------------------------
    wtab = [0] * T
    for (j, _), ent in zip([(j, i) for (j, i) in entries if j < T], ents):
        wtab[j] = (wtab[j] + ent[1]) % P
    etab = [_eq_le_bits(r_cycle_le, j) for j in range(T)]

    for _ in range(n_cycle_vars):
        half = len(wtab) // 2
        e0 = e2 = 0
        for i in range(half):
            w0, w1 = wtab[2 * i], wtab[2 * i + 1]
            q0, q1 = etab[2 * i], etab[2 * i + 1]
            e0 = (e0 + q0 * w0) % P
            e2 = (e2 + (2 * q1 - q0) * (2 * w1 - w0)) % P
        e0 = e0 * val_r % P
        e2 = e2 * val_r % P
        e1 = (claim - e0) % P
        compressed = unipoly.compress(unipoly.interpolate([e0, e1, e2]))
        proof.cycle_polys.append(compressed)
        r = _absorb_round(transcript, compressed)
        claim = _eval2_from_hint(compressed, claim, r)
        wtab = [(wtab[2 * i] + r * (wtab[2 * i + 1] - wtab[2 * i])) % P
                for i in range(half)]
        etab = [(etab[2 * i] + r * (etab[2 * i + 1] - etab[2 * i])) % P
                for i in range(half)]

    proof.w_claim = wtab[0]
    transcript.append_scalar(proof.w_claim)
    return proof


def verify_lasso64(transcript, proof: Lasso64Proof, r_cycle_le: list[int],
                   n_cycle_vars: int, expected_out_claim: int | None = None) -> bool:
    """Replay + check. `expected_out_claim` binds the proof to an external
    claim (e.g. the stage-2 lookup-output opening); None accepts the
    prover's own absorbed claim (standalone round-trip)."""
    table = tb.Table(proof.table)
    if len(proof.addr_polys) != ADDR_VARS:
        return False
    if len(proof.cycle_polys) != n_cycle_vars:
        return False
    if expected_out_claim is not None and \
            proof.out_claim % P != expected_out_claim % P:
        return False
    transcript.append_scalar(proof.out_claim)

    claim = proof.out_claim % P
    r_addr = []
    for cp in proof.addr_polys:
        if len(cp) != 2:
            return False
        r = _absorb_round(transcript, cp)
        r_addr.append(r)
        claim = _eval2_from_hint(cp, claim, r)
    r_b = []
    for cp in proof.cycle_polys:
        if len(cp) != 2:
            return False
        r = _absorb_round(transcript, cp)
        r_b.append(r)
        claim = _eval2_from_hint(cp, claim, r)
    transcript.append_scalar(proof.w_claim)

    val_r = tb.evaluate_mle(table, r_addr, 64)
    eq_b = eq_point_eval(r_cycle_le, r_b)
    return claim == val_r * eq_b % P * (proof.w_claim % P) % P
