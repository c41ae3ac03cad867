"""Sound-mode stages 6-7: the REAL one-hot RamRa argument behind the
reference's zero-proof placeholders (src/zkvm/proof_converter.zig:2656-2683,
src/zkvm/claim_reductions/mod.zig — all empty structs).

In sound mode the committed RamRa_d polynomials are ONE-HOT chunk
indicators over the (chunk-value × cycle) cube:

    RamRaOH_d(k_d, j) = [chunk_d(slot_j) == k_d]   (zero row if cycle j
                                                    has no RAM access)

with slot_j = (address_j − start) / 8, the same word-slot index the sound
stage-2 RWC/RAF provers use. Three properties make the stage-2 virtual
RamRa claims commitment-bound and genuinely one-hot:

Stage 6 (n_cycle rounds, batched α-RLC):
  I0 RamRaVirtualization@RWC : rwc_ra_claim  = Σ_j eq(rc_rwc, j)·Π_d OH_d(pt_d^rwc, j)
  I1 RamRaVirtualization@RAF : raf_ra_claim  = Σ_j eq(rc_raf, j)·Π_d OH_d(pt_d^raf, j)
  I2 RamHammingBooleanity    : 0             = Σ_j eq(r_hb, j)·HW(j)·(1−HW(j))
  where HW(j) = Σ_k OH_0(k, j) (the RamHammingWeight virtual poly: the
  has-RAM-access indicator). Finals: per-chunk committed OH openings at
  (pt_d ‖ r6) — fed to the PCS batch opening — plus the HW(r6) claim.

Stage 7 (4 + n_cycle rounds over the (k,j) cube, batched β-RLC,
2·ram_d instances):
  B_d  Booleanity             : 0     = Σ_{k,j} eq(r_b,(k,j))·OH_d·(1−OH_d)
  HW_d HammingWeightClaimRed. : HW(r6)= Σ_{k,j} eq(r6, j)·OH_d(k, j)
  Finals: committed OH_d openings at r7 — batch opening again.

Booleanity(OH_d) + (Σ_k OH_d(k,j) = HW(j) for EVERY d) + HW·(1−HW)=0 ⇒
every cycle column of every chunk is one-hot or all-zero, all chunks
zero/live at the same cycles — so the RWC ra and RAF ra the verifier
consumed in stage 2 are bound to committed one-hot address indicators.
(Reference naming: jolt_types.zig:70-101 SumcheckIds.)
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

from ..field.params import FR
from ..poly import unipoly
from .stage2_batch import eval_from_hint

P = FR.p


def eval_from_hint_any(compressed: list[int], hint: int, x: int) -> int:
    """Degree-generic compressed-poly evaluation (stage 6 rounds are degree
    ram_d+1 > 3): recover c1 from hint = p(0)+p(1), then Horner."""
    return unipoly.horner_eval(unipoly.decompress(compressed, hint), x)

LOG_K_CHUNK = 4


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


def slot_per_cycle(padded_steps, start_address: int, log_ram_k: int) -> list:
    """Word-slot index per cycle (None when the cycle has no RAM access) —
    same mapping as the sound stage-2 provers."""
    k_size = 1 << log_ram_k
    out = []
    for s in padded_steps:
        addr = None if getattr(s, "is_noop", False) else s.memory_addr
        if addr is None or addr < start_address:
            out.append(None)
            continue
        k = (addr - start_address) // 8
        out.append(k if k < k_size else None)
    return out


def chunk_shifts(log_ram_k: int) -> list[int]:
    """Bit shift of chunk d (chunk 0 = high bits, commitments.build_ram_ra)."""
    ram_d = (log_ram_k + LOG_K_CHUNK - 1) // LOG_K_CHUNK
    return [LOG_K_CHUNK * (ram_d - 1 - d) for d in range(ram_d)]


# ---------------------------------------------------------------------------
# Stage 6
# ---------------------------------------------------------------------------

@dataclass
class Stage6Result:
    compressed_polys: list[list[int]] = dfield(default_factory=list)
    challenges: list[int] = dfield(default_factory=list)
    r_hb: list[int] = dfield(default_factory=list)
    alphas: list[int] = dfield(default_factory=list)
    final_claim: int = 0
    oh_rwc_claims: list[int] = dfield(default_factory=list)
    oh_raf_claims: list[int] = dfield(default_factory=list)
    hw_claim: int = 0


def stage6_points(s2_challenges: list[int], tau: list[int],
                  n_cycle_vars: int, log_ram_k: int):
    """(rc_rwc_le, rc_raf_le, chunk_pts_rwc, chunk_pts_raf) — the cycle and
    per-chunk address points of the two stage-2 RamRa claims.

    Sound RWC binds slot bits over s2[:log_k] then cycles over s2[log_k:];
    sound RAF pre-binds cycles at eq_BE(τ[:n]) then slot bits over s2[n:]
    (stage2_batch.SoundRamReadWriteCheckingProver / RafEvaluationProver)."""
    n, log_k = n_cycle_vars, log_ram_k
    rc_rwc_le = list(s2_challenges[log_k:log_k + n])
    rc_raf_le = list(reversed([t % P for t in tau[:n]]))
    shifts = chunk_shifts(log_k)
    chunk_rwc = [list(s2_challenges[sh:sh + LOG_K_CHUNK]) for sh in shifts]
    chunk_raf = [list(s2_challenges[n + sh:n + sh + LOG_K_CHUNK]) for sh in shifts]
    return rc_rwc_le, rc_raf_le, chunk_rwc, chunk_raf


def prove_stage6(transcript, padded_steps, s2_challenges, tau,
                 n_cycle_vars: int, log_ram_k: int, rwc_ra_claim: int,
                 raf_ra_claim: int, start_address: int) -> Stage6Result:
    res = Stage6Result()
    T = 1 << n_cycle_vars
    rc_rwc, rc_raf, chunk_rwc, chunk_raf = stage6_points(
        s2_challenges, tau, n_cycle_vars, log_ram_k)
    slots = slot_per_cycle(padded_steps, start_address, log_ram_k)
    shifts = chunk_shifts(log_ram_k)
    ram_d = len(shifts)

    res.r_hb = [transcript.challenge_scalar() for _ in range(n_cycle_vars)]
    res.alphas = [transcript.challenge_scalar_full() for _ in range(3)]
    a0, a1, a2 = res.alphas

    from ..native.frvec import FrVec

    # 4-bit chunk one-hots take only 2^LOG_K_CHUNK distinct eq values each
    lut_rwc = [[_eq_le_bits(chunk_rwc[d], v) for v in range(1 << LOG_K_CHUNK)]
               for d in range(ram_d)]
    lut_raf = [[_eq_le_bits(chunk_raf[d], v) for v in range(1 << LOG_K_CHUNK)]
               for d in range(ram_d)]
    oh_rwc_l = [[0] * T for _ in range(ram_d)]
    oh_raf_l = [[0] * T for _ in range(ram_d)]
    hw_pos = []
    mask = (1 << LOG_K_CHUNK) - 1
    for j, k in enumerate(slots):
        if k is None:
            continue
        hw_pos.append(j)
        for d, sh in enumerate(shifts):
            kd = (k >> sh) & mask
            oh_rwc_l[d][j] = lut_rwc[d][kd]
            oh_raf_l[d][j] = lut_raf[d][kd]

    eq_rwc = FrVec.eq_table_be(list(reversed([c % P for c in rc_rwc])))
    eq_raf = FrVec.eq_table_be(list(reversed([c % P for c in rc_raf])))
    eq_hb = FrVec.eq_table_be(list(reversed([c % P for c in res.r_hb])))
    oh_rwc = [FrVec.from_ints(t) for t in oh_rwc_l]
    oh_raf = [FrVec.from_ints(t) for t in oh_raf_l]
    hw = FrVec.indicator(T, hw_pos)

    deg = ram_d + 1          # eq · Π_d oh
    claim = (a0 * rwc_ra_claim + a1 * raf_ra_claim) % P

    for _ in range(n_cycle_vars):
        n = eq_rwc.n
        p_rwc = FrVec.prod_evals_adj([eq_rwc] + oh_rwc, deg)
        p_raf = FrVec.prod_evals_adj([eq_raf] + oh_raf, deg)
        omh = FrVec.filled(n, 1).sub(hw)
        p_hb = FrVec.prod_evals_adj([eq_hb, hw, omh], deg)
        evs = [(a0 * p_rwc[t] + a1 * p_raf[t] + a2 * p_hb[t]) % P
               for t in range(deg + 1)]

        compressed = unipoly.compress(unipoly.interpolate(evs))
        res.compressed_polys.append(compressed)
        transcript.append_message(b"UniPoly_begin")
        for c in compressed:
            transcript.append_scalar(c)
        transcript.append_message(b"UniPoly_end")
        r = transcript.challenge_scalar()
        res.challenges.append(r)
        claim = eval_from_hint_any(compressed, claim, r)
        eq_rwc = eq_rwc.fold_adj(r)
        eq_raf = eq_raf.fold_adj(r)
        eq_hb = eq_hb.fold_adj(r)
        hw = hw.fold_adj(r)
        oh_rwc = [t.fold_adj(r) for t in oh_rwc]
        oh_raf = [t.fold_adj(r) for t in oh_raf]

    res.final_claim = claim
    res.oh_rwc_claims = [oh_rwc[d].first() for d in range(ram_d)]
    res.oh_raf_claims = [oh_raf[d].first() for d in range(ram_d)]
    res.hw_claim = hw.first()
    for v in res.oh_rwc_claims + res.oh_raf_claims + [res.hw_claim]:
        transcript.append_scalar(v)
    return res


# ---------------------------------------------------------------------------
# Stage 7
# ---------------------------------------------------------------------------

@dataclass
class Stage7Result:
    compressed_polys: list[list[int]] = dfield(default_factory=list)
    challenges: list[int] = dfield(default_factory=list)
    r_b: list[int] = dfield(default_factory=list)
    betas: list[int] = dfield(default_factory=list)
    final_claim: int = 0
    oh_claims: list[int] = dfield(default_factory=list)


def prove_stage7(transcript, padded_steps, stage6_challenges,
                 n_cycle_vars: int, log_ram_k: int, hw_claim: int,
                 start_address: int) -> Stage7Result:
    """Booleanity of every OH_d + the HW linkage, over the (k_d, j) cube
    (flat index k_d·T + j, bound j-bits-first, all instances share it)."""
    res = Stage7Result()
    T = 1 << n_cycle_vars
    slots = slot_per_cycle(padded_steps, start_address, log_ram_k)
    shifts = chunk_shifts(log_ram_k)
    ram_d = len(shifts)
    cube = (1 << LOG_K_CHUNK) * T
    n_rounds = LOG_K_CHUNK + n_cycle_vars

    res.r_b = [transcript.challenge_scalar() for _ in range(n_rounds)]
    res.betas = [transcript.challenge_scalar_full() for _ in range(2 * ram_d)]

    from ..native.frvec import FrVec

    mask = (1 << LOG_K_CHUNK) - 1
    oh = []
    for d, sh in enumerate(shifts):
        oh.append(FrVec.indicator(
            cube, ((((k >> sh) & mask) << n_cycle_vars) | j
                   for j, k in enumerate(slots) if k is not None)))
    # flat index i = k_chunk·T + j is bound low-bit-first against r_b, so the
    # eq tables are little-endian — a big-endian table over the reversed point
    eq_b = FrVec.eq_table_be(list(reversed([c % P for c in res.r_b])))
    eq_hw_base = FrVec.eq_table_be(
        list(reversed([c % P for c in stage6_challenges])))
    assert eq_hw_base.n == T
    # eq_hw[i] = eq_le(stage6_challenges, i mod T): tile the size-T table
    if eq_hw_base._mont is not None:
        eq_hw = FrVec(cube, mont=bytearray(bytes(eq_hw_base._mont[:32 * T])
                                           * (cube // T)))
    else:
        eq_hw = FrVec(cube, ints=eq_hw_base.to_ints() * (cube // T))

    hw_betas = res.betas[ram_d:]
    claim = sum(hw_betas) % P * hw_claim % P

    for _ in range(n_rounds):
        evs = [0, 0, 0, 0]
        for d in range(ram_d):
            A, B = FrVec.bool_round(eq_b, eq_hw, oh[d])
            for t in range(4):
                evs[t] = (evs[t] + res.betas[d] * A[t] + hw_betas[d] * B[t]) % P

        compressed = unipoly.evals_to_compressed(evs)
        res.compressed_polys.append(compressed)
        transcript.append_message(b"UniPoly_begin")
        for c in compressed:
            transcript.append_scalar(c)
        transcript.append_message(b"UniPoly_end")
        r = transcript.challenge_scalar()
        res.challenges.append(r)
        claim = eval_from_hint(compressed, claim, r)
        eq_b = eq_b.fold_adj(r)
        eq_hw = eq_hw.fold_adj(r)
        oh = [t.fold_adj(r) for t in oh]

    res.final_claim = claim
    res.oh_claims = [oh[d].first() for d in range(ram_d)]
    for v in res.oh_claims:
        transcript.append_scalar(v)
    return res
