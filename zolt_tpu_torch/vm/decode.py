"""RV64IMC instruction decoding and RVC (compressed) expansion.

Written from the RISC-V ISA specification; produces the same decoded fields as
the reference decoder (src/zkvm/instruction/mod.zig:419-700): opcode class, rd,
rs1, rs2, funct3, funct7 and a sign-extended immediate per format. Compressed
16-bit instructions expand to their canonical 32-bit forms (RV64C).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum


class Opcode(Enum):
    LUI = 0x37
    AUIPC = 0x17
    JAL = 0x6F
    JALR = 0x67
    BRANCH = 0x63
    LOAD = 0x03
    STORE = 0x23
    OP_IMM = 0x13
    OP = 0x33
    OP_IMM_32 = 0x1B
    OP_32 = 0x3B
    SYSTEM = 0x73
    MISC_MEM = 0x0F
    VIRTUAL = 0x0B   # custom-0: virtual-sequence rows (vm/virtual.py)
    UNKNOWN = -1

    @classmethod
    def from_instruction(cls, instr: int) -> "Opcode":
        try:
            return cls(instr & 0x7F)
        except ValueError:
            return cls.UNKNOWN


def _sext(value: int, bits: int) -> int:
    m = 1 << (bits - 1)
    return (value ^ m) - m


@dataclass
class DecodedInstruction:
    raw: int
    opcode: Opcode
    rd: int
    rs1: int
    rs2: int
    funct3: int
    funct7: int
    imm: int  # sign-extended
    format: str  # R I S B U J


import functools


@functools.lru_cache(maxsize=1 << 16)
def decode(instr: int) -> DecodedInstruction:
    """Memoized: traces revisit the same few instruction words millions of
    times; the decoded record is immutable shared state."""
    return _decode_uncached(instr)


def _decode_uncached(instr: int) -> DecodedInstruction:
    opcode = Opcode.from_instruction(instr)
    if opcode is Opcode.VIRTUAL:
        from . import virtual as vi

        kind, rd, rs1, rs2, _, _ = vi.fields(instr)
        return DecodedInstruction(instr, opcode, rd, rs1, rs2,
                                  (instr >> 12) & 0x7, (instr >> 25) & 0x7F,
                                  vi.VIRT_IMM.get(kind, 0), "V")
    rd = (instr >> 7) & 0x1F
    funct3 = (instr >> 12) & 0x7
    rs1 = (instr >> 15) & 0x1F
    rs2 = (instr >> 20) & 0x1F
    funct7 = (instr >> 25) & 0x7F

    fmt, imm = "R", 0
    if opcode in (Opcode.LUI, Opcode.AUIPC):
        fmt = "U"
        imm = _sext(instr & 0xFFFFF000, 32)
    elif opcode is Opcode.JAL:
        fmt = "J"
        imm = _sext(
            (((instr >> 31) & 1) << 20)
            | (((instr >> 21) & 0x3FF) << 1)
            | (((instr >> 20) & 1) << 11)
            | (((instr >> 12) & 0xFF) << 12),
            21,
        )
    elif opcode in (Opcode.JALR, Opcode.LOAD, Opcode.OP_IMM, Opcode.OP_IMM_32,
                    Opcode.SYSTEM, Opcode.MISC_MEM):
        fmt = "I"
        imm = _sext((instr >> 20) & 0xFFF, 12)
    elif opcode is Opcode.STORE:
        fmt = "S"
        imm = _sext((((instr >> 25) & 0x7F) << 5) | ((instr >> 7) & 0x1F), 12)
    elif opcode is Opcode.BRANCH:
        fmt = "B"
        imm = _sext(
            (((instr >> 31) & 1) << 12)
            | (((instr >> 7) & 1) << 11)
            | (((instr >> 25) & 0x3F) << 5)
            | (((instr >> 8) & 0xF) << 1),
            13,
        )
    return DecodedInstruction(instr, opcode, rd, rs1, rs2, funct3, funct7, imm, fmt)


def is_compressed(halfword: int) -> bool:
    return (halfword & 0x3) != 0x3


# ---------------------------------------------------------------------------
# RVC expansion (RV64C). Returns the canonical 32-bit instruction.
# ---------------------------------------------------------------------------

def _enc_i(imm, rs1, f3, rd, op):
    return ((imm & 0xFFF) << 20) | (rs1 << 15) | (f3 << 12) | (rd << 7) | op


def _enc_r(f7, rs2, rs1, f3, rd, op):
    return (f7 << 25) | (rs2 << 20) | (rs1 << 15) | (f3 << 12) | (rd << 7) | op


def _enc_s(imm, rs2, rs1, f3, op):
    return (((imm >> 5) & 0x7F) << 25) | (rs2 << 20) | (rs1 << 15) | (f3 << 12) | ((imm & 0x1F) << 7) | op


def _enc_b(imm, rs2, rs1, f3, op):
    return (
        (((imm >> 12) & 1) << 31)
        | (((imm >> 5) & 0x3F) << 25)
        | (rs2 << 20)
        | (rs1 << 15)
        | (f3 << 12)
        | (((imm >> 1) & 0xF) << 8)
        | (((imm >> 11) & 1) << 7)
        | op
    )


def _enc_j(imm, rd, op):
    return (
        (((imm >> 20) & 1) << 31)
        | (((imm >> 1) & 0x3FF) << 21)
        | (((imm >> 11) & 1) << 20)
        | (((imm >> 12) & 0xFF) << 12)
        | (rd << 7)
        | op
    )


def _enc_u(imm20, rd, op):
    return ((imm20 & 0xFFFFF) << 12) | (rd << 7) | op


def expand_compressed(hw: int) -> int:
    """Expand a 16-bit RVC instruction to 32 bits (RV64C decoding)."""
    hw &= 0xFFFF
    quadrant = hw & 0x3
    funct3 = (hw >> 13) & 0x7

    if quadrant == 0:
        rdp = ((hw >> 2) & 0x7) + 8
        rs1p = ((hw >> 7) & 0x7) + 8
        if funct3 == 0b000:  # C.ADDI4SPN -> addi rd', x2, nzuimm
            imm = (((hw >> 5) & 1) << 3) | (((hw >> 6) & 1) << 2) | (((hw >> 7) & 0xF) << 6) | (((hw >> 11) & 0x3) << 4)
            if imm == 0:
                return 0  # illegal
            return _enc_i(imm, 2, 0, rdp, 0x13)
        if funct3 == 0b010:  # C.LW -> lw rd', off(rs1')
            imm = (((hw >> 5) & 1) << 6) | (((hw >> 6) & 1) << 2) | (((hw >> 10) & 0x7) << 3)
            return _enc_i(imm, rs1p, 0b010, rdp, 0x03)
        if funct3 == 0b011:  # C.LD -> ld rd', off(rs1')
            imm = (((hw >> 5) & 0x3) << 6) | (((hw >> 10) & 0x7) << 3)
            return _enc_i(imm, rs1p, 0b011, rdp, 0x03)
        if funct3 == 0b110:  # C.SW
            imm = (((hw >> 5) & 1) << 6) | (((hw >> 6) & 1) << 2) | (((hw >> 10) & 0x7) << 3)
            return _enc_s(imm, rdp, rs1p, 0b010, 0x23)
        if funct3 == 0b111:  # C.SD
            imm = (((hw >> 5) & 0x3) << 6) | (((hw >> 10) & 0x7) << 3)
            return _enc_s(imm, rdp, rs1p, 0b011, 0x23)
        return 0

    if quadrant == 1:
        rd = (hw >> 7) & 0x1F
        rdp = ((hw >> 7) & 0x7) + 8
        rs2p = ((hw >> 2) & 0x7) + 8
        imm6 = _sext((((hw >> 12) & 1) << 5) | ((hw >> 2) & 0x1F), 6)
        if funct3 == 0b000:  # C.ADDI (C.NOP when rd=0)
            return _enc_i(imm6 & 0xFFF, rd, 0, rd, 0x13)
        if funct3 == 0b001:  # C.ADDIW (RV64)
            return _enc_i(imm6 & 0xFFF, rd, 0, rd, 0x1B)
        if funct3 == 0b010:  # C.LI -> addi rd, x0, imm
            return _enc_i(imm6 & 0xFFF, 0, 0, rd, 0x13)
        if funct3 == 0b011:
            if rd == 2:  # C.ADDI16SP
                imm = _sext(
                    (((hw >> 12) & 1) << 9) | (((hw >> 6) & 1) << 4) | (((hw >> 5) & 1) << 6)
                    | (((hw >> 3) & 0x3) << 7) | (((hw >> 2) & 1) << 5), 10)
                return _enc_i(imm & 0xFFF, 2, 0, 2, 0x13)
            # C.LUI
            return _enc_u(imm6 & 0xFFFFF, rd, 0x37)
        if funct3 == 0b100:
            f2 = (hw >> 10) & 0x3
            if f2 == 0b00:  # C.SRLI
                shamt = (((hw >> 12) & 1) << 5) | ((hw >> 2) & 0x1F)
                return _enc_i(shamt, rdp, 0b101, rdp, 0x13)
            if f2 == 0b01:  # C.SRAI
                shamt = (((hw >> 12) & 1) << 5) | ((hw >> 2) & 0x1F)
                return _enc_i(0x400 | shamt, rdp, 0b101, rdp, 0x13)
            if f2 == 0b10:  # C.ANDI
                return _enc_i(imm6 & 0xFFF, rdp, 0b111, rdp, 0x13)
            # register-register group
            bit12 = (hw >> 12) & 1
            f2b = (hw >> 5) & 0x3
            if bit12 == 0:
                if f2b == 0b00:  # C.SUB
                    return _enc_r(0x20, rs2p, rdp, 0b000, rdp, 0x33)
                if f2b == 0b01:  # C.XOR
                    return _enc_r(0, rs2p, rdp, 0b100, rdp, 0x33)
                if f2b == 0b10:  # C.OR
                    return _enc_r(0, rs2p, rdp, 0b110, rdp, 0x33)
                return _enc_r(0, rs2p, rdp, 0b111, rdp, 0x33)  # C.AND
            else:
                if f2b == 0b00:  # C.SUBW
                    return _enc_r(0x20, rs2p, rdp, 0b000, rdp, 0x3B)
                if f2b == 0b01:  # C.ADDW
                    return _enc_r(0, rs2p, rdp, 0b000, rdp, 0x3B)
                return 0
        if funct3 == 0b101:  # C.J
            imm = _sext(
                (((hw >> 12) & 1) << 11) | (((hw >> 11) & 1) << 4) | (((hw >> 9) & 0x3) << 8)
                | (((hw >> 8) & 1) << 10) | (((hw >> 7) & 1) << 6) | (((hw >> 6) & 1) << 7)
                | (((hw >> 3) & 0x7) << 1) | (((hw >> 2) & 1) << 5), 12)
            return _enc_j(imm & 0x1FFFFF, 0, 0x6F)
        if funct3 in (0b110, 0b111):  # C.BEQZ / C.BNEZ
            imm = _sext(
                (((hw >> 12) & 1) << 8) | (((hw >> 10) & 0x3) << 3) | (((hw >> 5) & 0x3) << 6)
                | (((hw >> 3) & 0x3) << 1) | (((hw >> 2) & 1) << 5), 9)
            f3 = 0b000 if funct3 == 0b110 else 0b001
            return _enc_b(imm & 0x1FFF, 0, rdp, f3, 0x63)
        return 0

    if quadrant == 2:
        rd = (hw >> 7) & 0x1F
        rs2 = (hw >> 2) & 0x1F
        bit12 = (hw >> 12) & 1
        if funct3 == 0b000:  # C.SLLI
            shamt = (bit12 << 5) | ((hw >> 2) & 0x1F)
            return _enc_i(shamt, rd, 0b001, rd, 0x13)
        if funct3 == 0b010:  # C.LWSP
            imm = (bit12 << 5) | (((hw >> 4) & 0x7) << 2) | (((hw >> 2) & 0x3) << 6)
            return _enc_i(imm, 2, 0b010, rd, 0x03)
        if funct3 == 0b011:  # C.LDSP
            imm = (bit12 << 5) | (((hw >> 5) & 0x3) << 3) | (((hw >> 2) & 0x7) << 6)
            return _enc_i(imm, 2, 0b011, rd, 0x03)
        if funct3 == 0b100:
            if bit12 == 0:
                if rs2 == 0:  # C.JR -> jalr x0, rs1, 0
                    return _enc_i(0, rd, 0, 0, 0x67)
                # C.MV -> add rd, x0, rs2
                return _enc_r(0, rs2, 0, 0b000, rd, 0x33)
            else:
                if rs2 == 0:
                    if rd == 0:  # C.EBREAK
                        return 0x00100073
                    # C.JALR -> jalr x1, rs1, 0
                    return _enc_i(0, rd, 0, 1, 0x67)
                # C.ADD -> add rd, rd, rs2
                return _enc_r(0, rs2, rd, 0b000, rd, 0x33)
        if funct3 == 0b110:  # C.SWSP
            imm = (((hw >> 9) & 0xF) << 2) | (((hw >> 7) & 0x3) << 6)
            return _enc_s(imm, rs2, 2, 0b010, 0x23)
        if funct3 == 0b111:  # C.SDSP
            imm = (((hw >> 10) & 0x7) << 3) | (((hw >> 7) & 0x7) << 6)
            return _enc_s(imm, rs2, 2, 0b011, 0x23)
        return 0

    return 0
