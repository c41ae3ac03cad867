"""Sound-mode lookups argument orchestration: stages 8-12 as one unit.

Drives the InstructionReadRaf / InstructionRaVirtualization provers
(zkvm/lookups_raf.py) and the Booleanity / BytecodeReadRaf / BytecodeRa
virtualization provers (zkvm/bytecode_raf.py) on the live Fiat-Shamir
transcript, assembles the public BytecodeReadRaf instance list shared by
prover and verifier, and serializes the whole block as the proof's
optional `lookups_ext` trailing section.

These are the real protocols behind the reference's zero-proof
LookupsRAF/BytecodeRAF placeholders (src/zkvm/proof_converter.zig:2629-2677,
SumcheckIds InstructionReadRaf / InstructionRaVirtualization / Booleanity /
BytecodeReadRaf in src/zkvm/jolt_types.zig:70-101).

BytecodeReadRaf instance list (fixed protocol order; every claim is an MLE
evaluation of a per-cycle column that is a public function of the fetched
bytecode slot, so one batched read-check proves them all):
  1. gamma_bc-RLC of the bytecode-static SpartanOuter claimed inputs at the
     stage-1 cycle point rc1 (columns RC1_STATIC_COLS, in order),
  2. the stage-8 CONST claim at rc1 (static additive operand constants),
  3. the stage-8 HasValidity right-hand side at rc1,
  4. the stage-8 C-table terminal at the stage-8 cycle point,
  5. the stage-10 HasLookup Hamming claim at r_hw.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from ..field.params import FR
from .bytecode_raf import (Stage10Result, Stage11Result, Stage12Result,
                           prove_stage10, prove_stage11, prove_stage12)
from .bytecode_tables import STATIC_COLS
from .lookups_raf import (Stage8Result, Stage9Result, const_table,
                          ctable_values, prove_stage8, prove_stage9)

P = FR.p

# Bytecode-static witness columns with SpartanOuter claims (the serialized
# Jolt 36: indexes 0..35 = 23 named + OpFlags 0..12). The remaining static
# flags (Inp >= 36) are claimed at stage-2/3 points and bound by the extra
# instances below.
RC1_STATIC_COLS = tuple(c for c in STATIC_COLS if int(c) < 36)


@dataclass
class SoundLookupsProof:
    s8: Stage8Result
    s9: Stage9Result
    s10: Stage10Result
    s11: Stage11Result
    s12: Stage12Result


# ---------------------------------------------------------------------------
# Shared instance assembly
# ---------------------------------------------------------------------------

def _rlc(gamma_bc: int, vals: list[int]) -> int:
    out, g = 0, 1
    for v in vals:
        out = (out + g * (v % P)) % P
        g = g * gamma_bc % P
    return out


def build_instances(bc_index, gamma_bc: int, gammas8: list[int],
                    rc1_le: list[int], r_addr8: list[int],
                    r_cycle8: list[int], const_claim: int, valid_rhs: int,
                    cs_claim: int, r_hw: list[int], hw_io: int,
                    rlc_claim: int):
    """The shared (point_le, F_table, claim) list for stage 11. Points and
    claims are each side's own transcript-checked values (the verifier
    passes its replay-derived r_addr8/r_cycle8/r_hw, never proof fields)."""
    return [
        (rc1_le, bc_index.gamma_rlc_table(gamma_bc, cols_subset=RC1_STATIC_COLS),
         rlc_claim),
        (rc1_le, const_table(bc_index, gammas8, bc_index.size),
         const_claim % P),
        (rc1_le, bc_index.has_validity_table(), valid_rhs % P),
        (r_cycle8, ctable_values(bc_index, gammas8, r_addr8, bc_index.size),
         cs_claim % P),
        (r_hw, bc_index.has_lookup_table(), hw_io % P),
    ]


# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------

def prove_sound_lookups(transcript, padded_steps, bc_index,
                        input_evals: list[int], rc1_le: list[int],
                        n_cycle_vars: int) -> SoundLookupsProof:
    """Run stages 8-12 on the live transcript. `input_evals` are the
    stage-1 claimed input evaluations (at rc1, eq_le weights), already
    absorbed by add_spartan_outer_claims."""
    from ..r1cs.inputs import Inp

    lo = input_evals[Inp.LookupOutput] % P
    lf = input_evals[Inp.LeftLookupOperand] % P
    rt = input_evals[Inp.RightLookupOperand] % P
    rc1_be = list(reversed(rc1_le))

    s8 = prove_stage8(transcript, padded_steps, bc_index, lo, lf, rt,
                      rc1_be, n_cycle_vars)
    s9 = prove_stage9(transcript, padded_steps, s8.r_addr, s8.r_cycle,
                      s8.w_claim, n_cycle_vars)
    slots = bc_index.slots_per_cycle(padded_steps)
    s10 = prove_stage10(transcript, padded_steps, bc_index, slots,
                        n_cycle_vars)

    gamma_bc = transcript.challenge_scalar_full()
    g8 = s8.gamma % P
    gammas8 = [1, g8, g8 * g8 % P, g8 * g8 % P * g8 % P]
    rlc = _rlc(gamma_bc, [input_evals[c] for c in RC1_STATIC_COLS])
    insts = build_instances(bc_index, gamma_bc, gammas8, rc1_le, s8.r_addr,
                            s8.r_cycle, s8.const_claim, s8.valid_rhs,
                            s8.cs_claim, s10.r_hw, s10.hw_io, rlc)
    s11 = prove_stage11(transcript, slots, bc_index.log_k, insts,
                        n_cycle_vars)
    s12 = prove_stage12(transcript, slots, bc_index.log_k, s11.r_addr,
                        s11.r_cycle, s11.wbc_claim, n_cycle_vars)
    return SoundLookupsProof(s8, s9, s10, s11, s12)


# ---------------------------------------------------------------------------
# Serialization (the proof's optional `lookups_ext` section)
# ---------------------------------------------------------------------------

def _w_scalar(out: list, x: int) -> None:
    out.append((x % P).to_bytes(32, "little"))


def _w_polys(out: list, polys: list[list[int]]) -> None:
    out.append(struct.pack("<II", len(polys),
                           len(polys[0]) if polys else 0))
    for cp in polys:
        for c in cp:
            _w_scalar(out, c)


def _w_vec(out: list, xs: list[int]) -> None:
    out.append(struct.pack("<I", len(xs)))
    for x in xs:
        _w_scalar(out, x)


def serialize_sound_lookups(slp: SoundLookupsProof) -> bytes:
    out: list[bytes] = []
    s8 = slp.s8
    for v in (s8.gamma, s8.const_claim, s8.valid_rhs, s8.w_claim,
              s8.cs_claim):
        _w_scalar(out, v)
    _w_polys(out, s8.compressed_addr)
    _w_polys(out, s8.compressed_cycle)
    _w_polys(out, slp.s9.compressed_polys)
    _w_vec(out, slp.s9.oh_claims)
    _w_scalar(out, slp.s10.hw_io)
    _w_polys(out, slp.s10.compressed_polys)
    _w_vec(out, slp.s10.io_oh_claims)
    _w_vec(out, slp.s10.bc_oh_claims)
    _w_scalar(out, slp.s11.wbc_claim)
    _w_polys(out, slp.s11.compressed_polys)
    _w_polys(out, slp.s12.compressed_polys)
    _w_vec(out, slp.s12.oh_claims)
    return b"".join(out)
