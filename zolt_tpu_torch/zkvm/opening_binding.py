"""Sound-mode PCS binding: shared bookkeeping between prover and verifier
for the committed-polynomial opening claims fed to the batch opening
(pcs/batch.py).

Each committed-poly evaluation consumed by the stage-2/3/4 output checks is
re-derived here as (commitment index, big-endian opening point); the points
come from each side's OWN challenge transcripts (never prover data). The
claim VALUES come from the serialized opening-claim map — the batch opening
is exactly what upgrades them from prover-asserted to commitment-bound.

Bind-order provenance (all low-bit-first folds, so the big-endian point is
the reversed challenge sequence):
  RamInc @ RamReadWriteChecking  — sound stage-2 RWC binds addresses over
    the first log_ram_k batch rounds, then cycles over the remaining
    n_cycle rounds (stage2_batch.SoundRamReadWriteCheckingProver.bind).
  RdInc  @ RegistersReadWriteChecking — stage-4 registers prover binds
    cycle bits in phase 1 (first log_t//2 rounds) and phase 3 (rounds after
    the 7 register rounds) (stage4.Stage4RegistersProver.bind).
  RamInc @ RamValEvaluation / RamValFinalEvaluation — both activate in the
    last n_cycle stage-4 rounds (stage4.ValEvaluationProver/ValFinalProver).
"""

from __future__ import annotations

LOG_K_REGISTERS = 7  # log2(128) register rounds in stage 4


def committed_claim_specs(s2_challenges: list[int], s4_challenges: list[int],
                          n_cycle_vars: int, log_ram_k: int):
    """Ordered (name, commitment_index, point_be) list — fixed protocol
    order; commitment_index indexes the absorbed commitment list
    (0 = RdInc, 1 = RamInc, see commitments.commit_and_absorb)."""
    n = n_cycle_vars
    rwc_inc_pt = list(reversed(s2_challenges[log_ram_k:log_ram_k + n]))
    p1 = n // 2
    regs_seq = list(s4_challenges[:p1]) + list(s4_challenges[p1 + LOG_K_REGISTERS:])
    regs_inc_pt = list(reversed(regs_seq))
    s4_inc_pt = list(reversed(s4_challenges[len(s4_challenges) - n:]))
    return [
        ("RdInc@RegistersReadWriteChecking", 0, regs_inc_pt),
        ("RamInc@RamReadWriteChecking", 1, rwc_inc_pt),
        ("RamInc@RamValEvaluation", 1, s4_inc_pt),
        ("RamInc@RamValFinalEvaluation", 1, s4_inc_pt),
    ]


def sound_claim_specs(s2_challenges: list[int], s4_challenges: list[int],
                      s5_challenges: list[int], s6_challenges: list[int],
                      s7_challenges: list[int], tau: list[int],
                      n_cycle_vars: int, log_ram_k: int,
                      instruction_d: int):
    """Full sound-mode spec list: the stage-2/4 committed claims plus the
    stage-5 RdInc opening and the stage-6/7 one-hot RamRa chunk openings.

    One-hot RamRa layout (commitments.build_ram_ra_onehot): flat index
    k_d·2^n_cycle + j, so the big-endian point is [chunk bits BE, cycle bits
    BE]. Stage-6 binds cycles only (chunk vars pre-evaluated at the stage-2
    points); stage-7 binds the whole cube low-bit-first."""
    from .stage67 import stage6_points

    specs = committed_claim_specs(s2_challenges, s4_challenges,
                                  n_cycle_vars, log_ram_k)
    specs.append(("RdInc@RegistersValEvaluation", 0,
                  list(reversed(s5_challenges))))
    _, _, chunk_rwc, chunk_raf = stage6_points(
        s2_challenges, tau, n_cycle_vars, log_ram_k)
    base = 2 + instruction_d
    r6_be = list(reversed(s6_challenges))
    for d, pt in enumerate(chunk_rwc):
        specs.append((f"RamRaOH{d}@RamReadWriteChecking", base + d,
                      list(reversed(pt)) + r6_be))
    for d, pt in enumerate(chunk_raf):
        specs.append((f"RamRaOH{d}@RamRafEvaluation", base + d,
                      list(reversed(pt)) + r6_be))
    r7_be = list(reversed(s7_challenges))
    for d in range(len(chunk_rwc)):
        specs.append((f"RamRaOH{d}@Booleanity", base + d, r7_be))
    return specs


def lookups_oh_specs(s9_chunk_pts, s9_challenges, s10_challenges,
                     s12_chunk_pts, s12_challenges,
                     instruction_d: int, ram_d: int):
    """Stage-8-12 one-hot opening specs (zkvm/sound_lookups.py).

    Commitment layout: [RdInc, RamInc, InstrRaOH x instruction_d,
    RamRaOH x ram_d, BytecodeRaOH x bc_d]. Every one-hot cube has flat
    index k_chunk·2^n_cycle + j and is folded low-bit-first, so:
      stage 9/12 (cycle-only folds, chunk vars pre-evaluated at the 4-bit
        LE chunk points) -> BE point = [reversed chunk pt, reversed cycles];
      stage 10 booleanity (whole-cube fold) -> BE point = reversed rounds.
    Value order matches: s9 oh, s10 io oh, s10 bc oh, s12 oh."""
    specs = []
    r9_be = list(reversed(s9_challenges))
    for d, pt in enumerate(s9_chunk_pts):
        specs.append((f"InstrRaOH{d}@InstructionRaVirtualization", 2 + d,
                      list(reversed(pt)) + r9_be))
    r10_be = list(reversed(s10_challenges))
    for d in range(instruction_d):
        specs.append((f"InstrRaOH{d}@Booleanity", 2 + d, r10_be))
    bc_base = 2 + instruction_d + ram_d
    for d in range(len(s12_chunk_pts)):
        specs.append((f"BytecodeRaOH{d}@Booleanity", bc_base + d, r10_be))
    r12_be = list(reversed(s12_challenges))
    for d, pt in enumerate(s12_chunk_pts):
        specs.append((f"BytecodeRaOH{d}@BytecodeReadRaf", bc_base + d,
                      list(reversed(pt)) + r12_be))
    return specs
