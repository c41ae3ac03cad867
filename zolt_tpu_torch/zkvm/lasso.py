"""Stage 3: Lasso instruction-lookup sumcheck (internal path).

Proves that every cycle's lookup output is the table entry at its lookup index:

    Σ_j eq(r, j) · γ^{τ_j} · o_j  =  Σ_{τ,k} RA(τ,k) · VAL(τ,k)

where RA(τ,k) = γ^τ · Σ_{j: τ_j=τ, idx_j=k} eq(r, j) is the (γ-scaled) one-hot
read-address polynomial and VAL is the public stacked table over the joint
(τ, k) domain — a true degree-2 product sumcheck whose VAL opening the verifier
recomputes exactly from the public tables.

Round-1 scope: operands are w-bit slices (w = `slice_bits`, default 4 →
K = 2^8 per table, 2^13 joint domain with 32 table slots); the reference's
full 2^128-index prefix-suffix decomposition (src/zkvm/lasso/) lands later.
Table ids/order match the reference enum; entry indices use the reference's
bit-interleave convention (src/zkvm/lookup_table/mod.zig:24-73).
"""

from __future__ import annotations

from functools import lru_cache

from ..field.params import FR
from ..vm import tables as tb
from .stages import DeviceMleSumcheck, StageProof, _ceil_log2, eq_evals_le, run_stage_sumcheck, verify_stage_sumcheck

P = FR.p
N_TABLE_SLOTS = 32  # 24 tables padded to a power of two


def _operands(entry) -> tuple[int, int]:
    """(x, y) lookup operands for a decoded instruction entry."""
    d = entry.decoded
    opcode = d.raw & 0x7F
    x = entry.rs1_value
    if opcode in (0x33, 0x3B, 0x63):
        y = entry.rs2_value
    else:
        y = d.imm & ((1 << 64) - 1)
    return x, y


def build_lookup_rows(lookup_entries, slice_bits: int = 4):
    """[(table, idx, output)] per real cycle; None for non-lookup cycles."""
    w = slice_bits
    mask = (1 << w) - 1
    rows = []
    for e in lookup_entries:
        table = tb.instruction_table(e.instruction)
        if table is None:
            rows.append(None)
            continue
        x, y = _operands(e)
        if table in tb.PAIR_TABLES:
            idx = tb.interleave_bits(x & mask, y & mask, w)
        else:
            idx = x & ((1 << (2 * w)) - 1) if table != tb.Table.RangeCheck else 0
            if table == tb.Table.RangeCheck:
                idx = (x + y) & ((1 << (2 * w)) - 1)  # result slice
        out = tb.materialize_entry(table, idx, w)
        rows.append((int(table), idx, out))
    return rows


@lru_cache(maxsize=4)
def stacked_val_table(slice_bits: int = 4) -> tuple[int, ...]:
    """VAL over the joint (τ, k) domain: τ-major, K = 2^(2·slice_bits)."""
    k_size = 1 << (2 * slice_bits)
    out = []
    for t in range(N_TABLE_SLOTS):
        if t < len(tb.Table):
            out.extend(tb.materialize_entry(tb.Table(t), k, slice_bits)
                       for k in range(k_size))
        else:
            out.extend([0] * k_size)
    return tuple(out)


def _val_mle_at(r: list[int], slice_bits: int) -> int:
    """Public VAL MLE at the bound point (little-endian over the joint index)."""
    val = stacked_val_table(slice_bits)
    cur = [v % P for v in val]
    for ri in r:
        half = len(cur) // 2
        cur = [(cur[2 * i] + ri * (cur[2 * i + 1] - cur[2 * i])) % P for i in range(half)]
    return cur[0]


def prove_stage3(lookup_entries, transcript, log_t: int,
                 slice_bits: int = 4, device="cuda") -> StageProof:
    gamma = transcript.challenge_scalar(b"lasso_gamma")
    r_red = [transcript.challenge_scalar(b"r_reduction") for _ in range(log_t)]

    k_size = 1 << (2 * slice_bits)
    joint = N_TABLE_SLOTS * k_size
    rows = build_lookup_rows(lookup_entries, slice_bits)
    eq = eq_evals_le(r_red, 1 << log_t)

    ra = [0] * joint
    claim = 0
    gpow = [pow(gamma, t, P) for t in range(N_TABLE_SLOTS)]
    for j, row in enumerate(rows):
        if row is None or j >= len(eq):
            continue
        t, idx, out = row
        ra[t * k_size + idx] = (ra[t * k_size + idx] + gpow[t] * eq[j]) % P
        claim = (claim + eq[j] * gpow[t] % P * out) % P

    val = list(stacked_val_table(slice_bits))
    inst = DeviceMleSumcheck([ra, val], device=device)
    proof = run_stage_sumcheck(inst, transcript, b"lasso_round", claim)
    proof.final_claims.extend(inst.final_evals())
    return proof


def verify_stage3(proof: StageProof, transcript, log_t: int,
                  slice_bits: int = 4) -> list[int]:
    transcript.challenge_scalar(b"lasso_gamma")
    [transcript.challenge_scalar(b"r_reduction") for _ in range(log_t)]
    final_claim, r = verify_stage_sumcheck(proof, transcript, b"lasso_round", 2)
    ra_r, val_r = proof.final_claims[2], proof.final_claims[3]
    assert final_claim == ra_r * val_r % P, "stage3 opening mismatch"
    # VAL is public: recompute its MLE at the bound point exactly
    assert val_r == _val_mle_at(r, slice_bits), "stage3 VAL mismatch"
    return r
