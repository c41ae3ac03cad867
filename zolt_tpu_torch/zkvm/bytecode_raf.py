"""Sound-mode stages 10-12: one-hot booleanity for the instruction/bytecode
ra chunks, the BytecodeReadRaf multi-instance read-check, and the
BytecodeRa virtualization — the real protocols behind the reference's
zero-proof placeholders (SumcheckIds Booleanity / BytecodeReadRaf /
HammingWeightClaimReduction, src/zkvm/jolt_types.zig:70-101).

Stage 10 (booleanity + Hamming linkage, (16 x T) cube, beta-RLC):
  per chunk family d:   0      = sum_{k,j} eq(r_b,(k,j)) * OH_d * (1 - OH_d)
  instruction chunks:   hw_io  = sum_{k,j} eq(r_hw, j)   * IOH_d(k, j)
  bytecode chunks:      1      = sum_{k,j} eq(r_hw, j)   * BCOH_d(k, j)
  with hw_io = sum_j eq(r_hw,j)*HasLookup(slot_j) — a public bytecode table
  claim proven by stage 11 — and 1 = partition of unity (every cycle reads
  exactly one bytecode slot, noops read the sentinel).

Stage 11 (BytecodeReadRaf): one batched two-phase sumcheck over the
(slot, cycle) cube proving EVERY claim of the form
  claim_i = sum_j eq(pt_i, j) * F_i(slot_j)
for public slot tables F_i: the gamma-RLC of the 25 bytecode-determined
stage-1 claimed input columns, the stage-8 CONST and HasValidity claims,
the stage-8 C-table terminal, and the stage-10 HasLookup claim. The
one-hot side collapses to per-cycle chi prefix products; terminals are the
verifier-evaluated F_i(r_addr) and the shared w_bc claim.

Stage 12 (BytecodeRa virtualization): w_bc = sum_j eq * prod_d BCOH_d —
binds the stage-11 one-hot side to the committed BCOH chunk polynomials.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

from ..field.params import FR
from ..poly import unipoly
from .lookups_raf import _absorb_round, _eval2, eq_point_eval
from .stage67 import eval_from_hint_any

P = FR.p
LOG_K_CHUNK = 4


def bc_chunk_count(log_bc: int) -> int:
    return max(1, (log_bc + LOG_K_CHUNK - 1) // LOG_K_CHUNK)


def bc_addr_vars(log_bc: int) -> int:
    """Padded address-variable count (multiple of the chunk width so the
    chi prefix product factors exactly into the committed 4-bit chunks)."""
    return LOG_K_CHUNK * bc_chunk_count(log_bc)


def _eq_le_bits(r: list[int], v: int) -> int:
    out = 1
    for i, ri in enumerate(r):
        out = out * (ri if (v >> i) & 1 else (1 - ri)) % P
    return out


def bc_chunk_points(r_bc_le: list[int], bc_d: int) -> list[list[int]]:
    out = []
    for d in range(bc_d):
        sh = LOG_K_CHUNK * (bc_d - 1 - d)
        out.append(r_bc_le[sh:sh + LOG_K_CHUNK])
    return out


# ---------------------------------------------------------------------------
# Stage 10: booleanity + Hamming linkage over every IOH/BCOH chunk
# ---------------------------------------------------------------------------

@dataclass
class Stage10Result:
    compressed_polys: list[list[int]] = dfield(default_factory=list)
    challenges: list[int] = dfield(default_factory=list)
    r_b: list[int] = dfield(default_factory=list)
    r_hw: list[int] = dfield(default_factory=list)
    betas: list[int] = dfield(default_factory=list)
    hw_io: int = 0
    io_oh_claims: list[int] = dfield(default_factory=list)
    bc_oh_claims: list[int] = dfield(default_factory=list)
    final_claim: int = 0


def _onehot_cube(positions_iter, cube: int):
    from ..native.frvec import FrVec

    return FrVec.indicator(cube, positions_iter)


def io_oh_positions(padded_steps, n_cycle_vars: int) -> list[list[int]]:
    """One-hot positions per instruction chunk ((chunk << ncv) | cycle)."""
    from .lookups_raf import INSTRUCTION_D
    from .raf_gadgets import sound_lookup_index

    per_d: list[list[int]] = [[] for _ in range(INSTRUCTION_D)]
    for j, s in enumerate(padded_steps):
        if getattr(s, "is_noop", False):
            continue
        idx = sound_lookup_index(s)
        if idx is None:
            continue
        for d in range(INSTRUCTION_D):
            sh = LOG_K_CHUNK * (INSTRUCTION_D - 1 - d)
            per_d[d].append((((idx >> sh) & 15) << n_cycle_vars) | j)
    return per_d


def build_io_oh_cubes(padded_steps, n_cycle_vars: int):
    """One-hot (chunk-value x cycle) cubes for the 32 instruction chunks."""
    T = 1 << n_cycle_vars
    cube = (1 << LOG_K_CHUNK) * T
    return [_onehot_cube(p, cube)
            for p in io_oh_positions(padded_steps, n_cycle_vars)]


def bc_oh_positions(slots: list[int], n_cycle_vars: int,
                    log_bc: int) -> list[list[int]]:
    """One-hot positions per bytecode chunk (EVERY cycle has a slot)."""
    import numpy as np

    bc_d = bc_chunk_count(log_bc)
    sl = np.asarray(slots, dtype=np.int64)
    j = np.arange(len(slots), dtype=np.int64)
    out = []
    for d in range(bc_d):
        sh = LOG_K_CHUNK * (bc_d - 1 - d)
        out.append((((sl >> sh) & 15) << n_cycle_vars) | j)
    return out


def build_bc_oh_cubes(slots: list[int], n_cycle_vars: int, log_bc: int):
    """One-hot cubes for the bytecode chunks (EVERY cycle has a slot)."""
    T = 1 << n_cycle_vars
    cube = (1 << LOG_K_CHUNK) * T
    return [_onehot_cube(p, cube)
            for p in bc_oh_positions(slots, n_cycle_vars, log_bc)]


def prove_stage10(transcript, padded_steps, bc_index, slots: list[int],
                  n_cycle_vars: int) -> Stage10Result:
    from ..native.frvec import FrVec

    res = Stage10Result()
    T = 1 << n_cycle_vars
    cube = (1 << LOG_K_CHUNK) * T
    n_rounds = LOG_K_CHUNK + n_cycle_vars

    io_oh = build_io_oh_cubes(padded_steps, n_cycle_vars)
    bc_oh = build_bc_oh_cubes(slots, n_cycle_vars, bc_index.log_k)
    nio, nbc = len(io_oh), len(bc_oh)

    res.r_b = [transcript.challenge_scalar() for _ in range(n_rounds)]
    res.r_hw = [transcript.challenge_scalar() for _ in range(n_cycle_vars)]
    res.betas = [transcript.challenge_scalar_full()
                 for _ in range(2 * (nio + nbc))]

    has = bc_index.has_lookup_table()
    eq_hw_flat = FrVec.eq_table_be(list(reversed([c % P for c in res.r_hw])))
    eqv = eq_hw_flat.to_ints()
    hw_io = sum(eqv[j] for j in range(T) if has[slots[j]]) % P
    res.hw_io = hw_io
    transcript.append_scalar(hw_io)

    eq_b = FrVec.eq_table_be(list(reversed([c % P for c in res.r_b])))
    if eq_hw_flat._mont is not None:
        eq_hw = FrVec(cube, mont=bytearray(
            bytes(eq_hw_flat._mont[:32 * T]) * (cube // T)))
    else:
        eq_hw = FrVec(cube, ints=eq_hw_flat.to_ints() * (cube // T))

    bool_betas = res.betas[:nio + nbc]
    hw_betas = res.betas[nio + nbc:]
    claim = (sum(hw_betas[:nio]) % P * hw_io
             + sum(hw_betas[nio:]) % P) % P

    oh = io_oh + bc_oh
    for _ in range(n_rounds):
        evs = [0, 0, 0, 0]
        for d in range(nio + nbc):
            A, B = FrVec.bool_round(eq_b, eq_hw, oh[d])
            for t in range(4):
                evs[t] = (evs[t] + bool_betas[d] * A[t]
                          + hw_betas[d] * B[t]) % P
        compressed = unipoly.evals_to_compressed(evs)
        res.compressed_polys.append(compressed)
        r = _absorb_round(transcript, compressed)
        res.challenges.append(r)
        from .stage2_batch import eval_from_hint

        claim = eval_from_hint(compressed, claim, r)
        eq_b = eq_b.fold_adj(r)
        eq_hw = eq_hw.fold_adj(r)
        oh = [t.fold_adj(r) for t in oh]

    res.final_claim = claim
    res.io_oh_claims = [oh[d].first() for d in range(nio)]
    res.bc_oh_claims = [oh[nio + d].first() for d in range(nbc)]
    for v in res.io_oh_claims + res.bc_oh_claims:
        transcript.append_scalar(v)
    return res


def verify_stage10(transcript, compressed_polys, hw_io: int,
                   io_oh_claims: list[int], bc_oh_claims: list[int],
                   n_cycle_vars: int):
    from .stage2_batch import eval_from_hint

    nio, nbc = len(io_oh_claims), len(bc_oh_claims)
    n_rounds = LOG_K_CHUNK + n_cycle_vars
    r_b = [transcript.challenge_scalar() for _ in range(n_rounds)]
    r_hw = [transcript.challenge_scalar() for _ in range(n_cycle_vars)]
    betas = [transcript.challenge_scalar_full() for _ in range(2 * (nio + nbc))]
    transcript.append_scalar(hw_io % P)
    bool_betas, hw_betas = betas[:nio + nbc], betas[nio + nbc:]
    claim = (sum(hw_betas[:nio]) % P * (hw_io % P)
             + sum(hw_betas[nio:]) % P) % P
    if len(compressed_polys) != n_rounds:
        return False, {}
    challenges = []
    for cp in compressed_polys:
        if len(cp) != 3:
            return False, {}
        r = _absorb_round(transcript, cp)
        challenges.append(r)
        claim = eval_from_hint(cp, claim, r)
    for v in io_oh_claims + bc_oh_claims:
        transcript.append_scalar(v % P)
    # flat index (k << n) | j is bound low-bit-first: the first n
    # challenges bind the cycle bits (the tiled eq_hw's only dependence)
    eq_b_end = eq_point_eval(r_b, challenges)
    eq_hw_end = eq_point_eval(r_hw, challenges[:n_cycle_vars])
    expected = 0
    for d, v in enumerate(io_oh_claims + bc_oh_claims):
        v %= P
        expected = (expected + bool_betas[d] * (eq_b_end * ((v - v * v) % P))
                    + hw_betas[d] * (eq_hw_end * v)) % P
    ok = claim == expected % P
    return ok, {"challenges": challenges, "r_hw": r_hw, "r_b": r_b}


# ---------------------------------------------------------------------------
# Stage 11: BytecodeReadRaf — batched two-phase read-check over public tables
# ---------------------------------------------------------------------------

@dataclass
class Stage11Result:
    compressed_polys: list[list[int]] = dfield(default_factory=list)
    r_addr: list[int] = dfield(default_factory=list)    # LE by bit position
    r_cycle: list[int] = dfield(default_factory=list)
    alphas: list[int] = dfield(default_factory=list)
    wbc_claim: int = 0
    final_claim: int = 0


def prove_stage11(transcript, slots: list[int], log_bc: int,
                  instances: list[tuple[list[int], list[int], int]],
                  n_cycle_vars: int) -> Stage11Result:
    """instances: (eq_point_le_over_cycles, F_table, claim). The eq point is
    little-endian (fold_adj order); F tables are padded to 2^bc_addr_vars."""
    from ..native.frvec import FrVec

    res = Stage11Result()
    T = 1 << n_cycle_vars
    m = bc_addr_vars(log_bc)
    size = 1 << m

    res.alphas = [transcript.challenge_scalar_full()
                  for _ in range(len(instances))]
    claim = 0
    for a, (_, _, c) in zip(res.alphas, instances):
        claim = (claim + a * (c % P)) % P

    eqs = []
    ftabs = []
    for (pt_le, F, _) in instances:
        eqs.append(FrVec.eq_table_be(
            list(reversed([c % P for c in pt_le]))).to_ints())
        ft = [v % P for v in F] + [0] * (size - len(F))
        ftabs.append(ft)

    pref = [1] * T
    r_bound: dict[int, int] = {}
    for pos in range(m - 1, -1, -1):
        half = 1 << pos
        e0 = e2 = 0
        for i in range(len(instances)):
            eqi, F = eqs[i], ftabs[i]
            a = res.alphas[i]
            s0 = s2 = 0
            for j in range(T):
                k = slots[j]
                low = k & (half - 1)
                f0 = F[low]
                f1 = F[low | half]
                wt = eqi[j] * pref[j] % P
                if (k >> pos) & 1:
                    s2 += wt * 2 % P * ((2 * f1 - f0) % P)
                else:
                    s0 += wt * f0
                    s2 -= wt * ((2 * f1 - f0) % P)
            e0 = (e0 + a * (s0 % P)) % P
            e2 = (e2 + a * (s2 % P)) % P
        e1 = (claim - e0) % P
        compressed = unipoly.compress(unipoly.interpolate([e0, e1, e2]))
        res.compressed_polys.append(compressed)
        r = _absorb_round(transcript, compressed)
        r_bound[pos] = r
        claim = _eval2(compressed, claim, r)
        omr = (1 - r) % P
        for j in range(T):
            pref[j] = pref[j] * (r if (slots[j] >> pos) & 1 else omr) % P
        for i in range(len(instances)):
            F = ftabs[i]
            ftabs[i] = [(F[w] + r * (F[w | half] - F[w])) % P
                        for w in range(half)]
    res.r_addr = [r_bound[p] for p in range(m)]

    fscal = [ftabs[i][0] for i in range(len(instances))]
    wbc = FrVec.from_ints(pref)
    eqf = [FrVec.from_ints(eqs[i]) for i in range(len(instances))]
    for _ in range(n_cycle_vars):
        e0 = e2 = 0
        for i in range(len(instances)):
            s = FrVec.prod_evals_adj([eqf[i], wbc], 2)
            c = res.alphas[i] * fscal[i] % P
            e0 = (e0 + c * s[0]) % P
            e2 = (e2 + c * s[2]) % P
        e1 = (claim - e0) % P
        compressed = unipoly.compress(unipoly.interpolate([e0, e1, e2]))
        res.compressed_polys.append(compressed)
        r = _absorb_round(transcript, compressed)
        res.r_cycle.append(r)
        claim = _eval2(compressed, claim, r)
        wbc = wbc.fold_adj(r)
        eqf = [t.fold_adj(r) for t in eqf]

    res.final_claim = claim
    res.wbc_claim = wbc.first()
    transcript.append_scalar(res.wbc_claim)
    return res


def verify_stage11(transcript, compressed_polys, wbc_claim: int,
                   log_bc: int,
                   instances: list[tuple[list[int], list[int], int]],
                   n_cycle_vars: int):
    """instances as in prove_stage11; F tables are evaluated by the
    verifier itself (public bytecode)."""
    from .bytecode_tables import mle_eval_table

    m = bc_addr_vars(log_bc)
    size = 1 << m
    alphas = [transcript.challenge_scalar_full() for _ in range(len(instances))]
    claim = 0
    for a, (_, _, c) in zip(alphas, instances):
        claim = (claim + a * (c % P)) % P
    if len(compressed_polys) != m + n_cycle_vars:
        return False, {}
    r_addr_msb = []
    for cp in compressed_polys[:m]:
        if len(cp) != 2:
            return False, {}
        r = _absorb_round(transcript, cp)
        r_addr_msb.append(r)
        claim = _eval2(cp, claim, r)
    r_cycle = []
    for cp in compressed_polys[m:]:
        if len(cp) != 2:
            return False, {}
        r = _absorb_round(transcript, cp)
        r_cycle.append(r)
        claim = _eval2(cp, claim, r)
    transcript.append_scalar(wbc_claim % P)

    r_addr_le = [0] * m
    for i, rr in enumerate(r_addr_msb):
        r_addr_le[m - 1 - i] = rr
    expected = 0
    for a, (pt_le, F, _) in zip(alphas, instances):
        ft = [v % P for v in F] + [0] * (size - len(F))
        fv = mle_eval_table(ft, r_addr_le)
        eq_end = eq_point_eval([c % P for c in pt_le], r_cycle)
        expected = (expected + a * fv % P * eq_end) % P
    ok = claim == expected * (wbc_claim % P) % P
    return ok, {"r_addr": r_addr_le, "r_cycle": r_cycle}


# ---------------------------------------------------------------------------
# Stage 12: BytecodeRa virtualization
# ---------------------------------------------------------------------------

@dataclass
class Stage12Result:
    compressed_polys: list[list[int]] = dfield(default_factory=list)
    challenges: list[int] = dfield(default_factory=list)
    oh_claims: list[int] = dfield(default_factory=list)
    final_claim: int = 0


def prove_stage12(transcript, slots: list[int], log_bc: int,
                  r_addr_le: list[int], r_cycle11: list[int],
                  wbc_claim: int, n_cycle_vars: int) -> Stage12Result:
    from ..native.frvec import FrVec

    res = Stage12Result()
    T = 1 << n_cycle_vars
    bc_d = bc_chunk_count(log_bc)
    pts = bc_chunk_points(r_addr_le, bc_d)
    luts = [[_eq_le_bits(pts[d], v) for v in range(16)] for d in range(bc_d)]
    oh = []
    for d in range(bc_d):
        sh = LOG_K_CHUNK * (bc_d - 1 - d)
        oh.append(FrVec.from_ints(
            [luts[d][(slots[j] >> sh) & 15] for j in range(T)]))
    eqf = FrVec.eq_table_be(list(reversed([c % P for c in r_cycle11])))
    deg = bc_d + 1
    claim = wbc_claim % P
    for _ in range(n_cycle_vars):
        evs = FrVec.prod_evals_adj([eqf] + oh, deg)
        compressed = unipoly.compress(unipoly.interpolate(evs))
        res.compressed_polys.append(compressed)
        r = _absorb_round(transcript, compressed)
        res.challenges.append(r)
        claim = eval_from_hint_any(compressed, claim, r)
        eqf = eqf.fold_adj(r)
        oh = [t.fold_adj(r) for t in oh]
    res.final_claim = claim
    res.oh_claims = [t.first() for t in oh]
    for v in res.oh_claims:
        transcript.append_scalar(v)
    return res


def verify_stage12(transcript, compressed_polys, oh_claims, log_bc: int,
                   r_cycle11: list[int], wbc_claim: int, n_cycle_vars: int):
    bc_d = bc_chunk_count(log_bc)
    if len(compressed_polys) != n_cycle_vars:
        return False, []
    claim = wbc_claim % P
    challenges = []
    for cp in compressed_polys:
        if len(cp) != bc_d + 1:
            return False, []
        r = _absorb_round(transcript, cp)
        challenges.append(r)
        claim = eval_from_hint_any(cp, claim, r)
    for v in oh_claims:
        transcript.append_scalar(v % P)
    expected = eq_point_eval([c % P for c in r_cycle11], challenges)
    for v in oh_claims:
        expected = expected * (v % P) % P
    return claim == expected, challenges
