"""Sound-mode lookups argument orchestration: stages 8-12 as one unit.

Drives the InstructionReadRaf / InstructionRaVirtualization provers
(zkvm/lookups_raf.py) and the Booleanity / BytecodeReadRaf / BytecodeRa
virtualization provers (zkvm/bytecode_raf.py) on the live Fiat-Shamir
transcript, assembles the public BytecodeReadRaf instance list shared by
prover and verifier, and (de)serializes the whole block as the proof's
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
                           bc_chunk_count, prove_stage10, prove_stage11,
                           prove_stage12, verify_stage10, verify_stage11,
                           verify_stage12)
from .bytecode_tables import STATIC_COLS
from .lookups_raf import (ADDR_VARS, Stage8Result, Stage9Result,
                          const_table, ctable_values, prove_stage8,
                          prove_stage9, verify_stage8, verify_stage9)

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
# Verifier
# ---------------------------------------------------------------------------

def verify_sound_lookups(transcript, slp: SoundLookupsProof, bc_index,
                         input_eval, rc1_le: list[int], n_cycle_vars: int):
    """Replay stages 8-12. `input_eval(inp)` returns the verified
    SpartanOuter claimed evaluation for a witness column (from the proof's
    opening-claim map — bound by the stage-1 output check). Returns
    (ok, info) where info carries the PCS-binding points and claims:
      info["s9_oh"]   = (chunk_points_le, r_cycle9, oh_claims)   InstructionRaOH
      info["s10"]     = (challenges, io_oh_claims, bc_oh_claims) Booleanity
      info["s12_oh"]  = (bc_chunk_points_le, r_cycle12, oh_claims) BytecodeRaOH
    """
    from ..r1cs.inputs import Inp
    from .lookups_raf import chunk_points
    from .bytecode_raf import bc_chunk_points

    lo = input_eval(Inp.LookupOutput) % P
    lf = input_eval(Inp.LeftLookupOperand) % P
    rt = input_eval(Inp.RightLookupOperand) % P
    rc1_be = list(reversed(rc1_le))

    ok8, i8 = verify_stage8(transcript, slp.s8, lo, lf, rt, rc1_be,
                            n_cycle_vars)
    if not ok8:
        return False, {"stage": 8}
    ok9, ch9 = verify_stage9(transcript, slp.s9.compressed_polys,
                             slp.s9.oh_claims, i8["r_cycle"],
                             i8["w_claim"], n_cycle_vars)
    if not ok9:
        return False, {"stage": 9}
    ok10, i10 = verify_stage10(transcript, slp.s10.compressed_polys,
                               slp.s10.hw_io, slp.s10.io_oh_claims,
                               slp.s10.bc_oh_claims, n_cycle_vars)
    if not ok10:
        return False, {"stage": 10}
    if len(slp.s10.bc_oh_claims) != bc_chunk_count(bc_index.log_k):
        return False, {"stage": 10}

    gamma_bc = transcript.challenge_scalar_full()
    gammas8 = i8["gammas"]
    rlc = _rlc(gamma_bc, [input_eval(c) for c in RC1_STATIC_COLS])
    insts = build_instances(bc_index, gamma_bc, gammas8, rc1_le,
                            i8["r_addr"], i8["r_cycle"], i8["const_claim"],
                            i8["valid_rhs"], i8["cs_claim"],
                            i10["r_hw"], slp.s10.hw_io, rlc)
    # instance claims 2-5 must match the stage-8/10 transcript-checked values
    ok11, i11 = verify_stage11(transcript, slp.s11.compressed_polys,
                               slp.s11.wbc_claim, bc_index.log_k, insts,
                               n_cycle_vars)
    if not ok11:
        return False, {"stage": 11}
    ok12, ch12 = verify_stage12(transcript, slp.s12.compressed_polys,
                                slp.s12.oh_claims, bc_index.log_k,
                                i11["r_cycle"], slp.s11.wbc_claim,
                                n_cycle_vars)
    if not ok12:
        return False, {"stage": 12}

    info = {
        "s9_oh": (chunk_points(i8["r_addr"]), ch9, slp.s9.oh_claims),
        "s10": (i10["challenges"], slp.s10.io_oh_claims,
                slp.s10.bc_oh_claims),
        "s12_oh": (bc_chunk_points(i11["r_addr"],
                                   bc_chunk_count(bc_index.log_k)),
                   ch12, slp.s12.oh_claims),
    }
    return True, info


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


class _R:
    def __init__(self, data: bytes):
        self.d, self.o = data, 0

    def scalar(self) -> int:
        v = int.from_bytes(self.d[self.o:self.o + 32], "little")
        self.o += 32
        return v

    def u32(self) -> int:
        v = struct.unpack_from("<I", self.d, self.o)[0]
        self.o += 4
        return v

    def polys(self) -> list[list[int]]:
        n, w = struct.unpack_from("<II", self.d, self.o)
        self.o += 8
        return [[self.scalar() for _ in range(w)] for _ in range(n)]

    def vec(self) -> list[int]:
        n = self.u32()
        return [self.scalar() for _ in range(n)]


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


def deserialize_sound_lookups(data: bytes) -> SoundLookupsProof:
    r = _R(data)
    s8 = Stage8Result()
    s8.gamma = r.scalar()
    s8.const_claim = r.scalar()
    s8.valid_rhs = r.scalar()
    s8.w_claim = r.scalar()
    s8.cs_claim = r.scalar()
    s8.compressed_addr = r.polys()
    s8.compressed_cycle = r.polys()
    s9 = Stage9Result()
    s9.compressed_polys = r.polys()
    s9.oh_claims = r.vec()
    s10 = Stage10Result()
    s10.hw_io = r.scalar()
    s10.compressed_polys = r.polys()
    s10.io_oh_claims = r.vec()
    s10.bc_oh_claims = r.vec()
    s11 = Stage11Result()
    s11.wbc_claim = r.scalar()
    s11.compressed_polys = r.polys()
    s12 = Stage12Result()
    s12.compressed_polys = r.polys()
    s12.oh_claims = r.vec()
    if r.o != len(data):
        raise ValueError(f"lookups_ext trailing bytes: {len(data) - r.o}")
    return SoundLookupsProof(s8, s9, s10, s11, s12)
