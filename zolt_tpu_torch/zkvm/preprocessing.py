"""Jolt verifier-preprocessing export (reference src/zkvm/preprocessing.zig).

Structures:
  JoltInstruction           — Jolt's decoded-instruction model with the exact
                              JSON encoding Jolt's verifier consumes (:23-214)
  BytecodePreprocessing     — decoded bytecode padded to a power of two (:251)
  RAMPreprocessing          — word-packed initial memory image (:365)
  memory-layout serializer  — 20 u64 fields (:480-520)
  DoryVerifierSetup         — delta/chi GT ladders from the Dory SRS (:854)

The export file (CLI --export-preprocessing) is DoryVerifierSetup followed by
JoltSharedPreprocessing (main.zig:381-473).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field as dfield

from ..field import tower as tw
from ..pcs import dory
from ..vm.decode import expand_compressed

M64 = (1 << 64) - 1

# opcode/funct3 -> Jolt variant tables (preprocessing.zig:487-673)
_BRANCH = {0: "BEQ", 1: "BNE", 4: "BLT", 5: "BGE", 6: "BLTU", 7: "BGEU"}
_LOAD = {0: "LB", 1: "LH", 2: "LW", 3: "LD", 4: "LBU", 5: "LHU", 6: "LWU"}
_STORE = {0: "SB", 1: "SH", 2: "SW", 3: "SD"}
_OP_IMM = {0: "ADDI", 2: "SLTI", 3: "SLTIU", 4: "XORI", 6: "ORI", 7: "ANDI"}
_OP_M = {0: "MUL", 1: "MULH", 2: "MULHSU", 3: "MULHU",
         4: "DIV", 5: "DIVU", 6: "REM", 7: "REMU"}
_OP = {0: ("ADD", "SUB"), 1: ("SLL", None), 2: ("SLT", None), 3: ("SLTU", None),
       4: ("XOR", None), 5: ("SRL", "SRA"), 6: ("OR", None), 7: ("AND", None)}
_OP32_M = {0: "MULW", 4: "DIVW", 5: "DIVUW", 6: "REMW", 7: "REMUW"}
_OP32 = {0: ("ADDW", "SUBW"), 1: ("SLLW", None), 5: ("SRLW", "SRAW")}


def _sext(v: int, bits: int) -> int:
    if v & (1 << (bits - 1)):
        v -= 1 << bits
    return v


@dataclass
class JoltInstruction:
    variant: str
    address: int = 0
    fmt: str = "None"           # FormatR/I/S/B/U/J/None
    operands: dict = dfield(default_factory=dict)
    virtual_sequence_remaining: int | None = None
    is_first_in_sequence: bool = False
    is_compressed: bool = False

    def to_json(self) -> str:
        if self.variant in ("NoOp", "UNIMPL"):
            return f'"{self.variant}"'
        o = self.operands
        if self.fmt == "FormatR":
            ops = f'{{"rd":{o["rd"]},"rs1":{o["rs1"]},"rs2":{o["rs2"]}}}'
        elif self.fmt == "FormatI":
            ops = f'{{"rd":{o["rd"]},"rs1":{o["rs1"]},"imm":{o["imm"]}}}'
        elif self.fmt == "FormatS":
            ops = f'{{"rs1":{o["rs1"]},"rs2":{o["rs2"]},"imm":{o["imm"]}}}'
        elif self.fmt == "FormatB":
            ops = f'{{"rs1":{o["rs1"]},"rs2":{o["rs2"]},"imm":{o["imm"]}}}'
        elif self.fmt in ("FormatU", "FormatJ"):
            ops = f'{{"rd":{o["rd"]},"imm":{o["imm"]}}}'
        else:
            ops = "{}"
        vsr = ("null" if self.virtual_sequence_remaining is None
               else str(self.virtual_sequence_remaining))
        return (f'{{"{self.variant}":{{"address":{self.address},"operands":{ops}'
                f',"virtual_sequence_remaining":{vsr}'
                f',"is_first_in_sequence":{"true" if self.is_first_in_sequence else "false"}'
                f',"is_compressed":{"true" if self.is_compressed else "false"}}}}}')


def decode_jolt_instruction(instr: int, address: int,
                            is_compressed: bool) -> JoltInstruction:
    """decodeToJoltInstruction (preprocessing.zig:487-673)."""
    opcode = instr & 0x7F
    rd = (instr >> 7) & 0x1F
    funct3 = (instr >> 12) & 0x7
    rs1 = (instr >> 15) & 0x1F
    rs2 = (instr >> 20) & 0x1F
    funct7 = (instr >> 25) & 0x7F
    i_imm = _sext(instr >> 20, 12) & M64
    u_imm = _sext(instr & 0xFFFFF000, 32) & M64
    s_imm = _sext((((instr >> 25) & 0x7F) << 5) | ((instr >> 7) & 0x1F), 12)
    b_raw = ((((instr >> 31) & 1) << 12) | (((instr >> 7) & 1) << 11)
             | (((instr >> 25) & 0x3F) << 5) | (((instr >> 8) & 0xF) << 1))
    b_imm = _sext(b_raw, 13)
    j_raw = ((((instr >> 31) & 1) << 20) | (((instr >> 12) & 0xFF) << 12)
             | (((instr >> 20) & 1) << 11) | (((instr >> 21) & 0x3FF) << 1))
    j_imm = _sext(j_raw, 21) & M64

    ins = JoltInstruction("UNIMPL", address, is_compressed=is_compressed)
    if opcode == 0x37:
        ins.variant, ins.fmt = "LUI", "FormatU"
        ins.operands = {"rd": rd, "imm": u_imm}
    elif opcode == 0x17:
        ins.variant, ins.fmt = "AUIPC", "FormatU"
        ins.operands = {"rd": rd, "imm": u_imm}
    elif opcode == 0x6F:
        ins.variant, ins.fmt = "JAL", "FormatJ"
        ins.operands = {"rd": rd, "imm": j_imm}
    elif opcode == 0x67:
        ins.variant, ins.fmt = "JALR", "FormatI"
        ins.operands = {"rd": rd, "rs1": rs1, "imm": i_imm}
    elif opcode == 0x63:
        ins.variant = _BRANCH.get(funct3, "UNIMPL")
        ins.fmt = "FormatB"
        ins.operands = {"rs1": rs1, "rs2": rs2, "imm": b_imm}
    elif opcode == 0x03:
        ins.variant = _LOAD.get(funct3, "UNIMPL")
        ins.fmt = "FormatI"
        ins.operands = {"rd": rd, "rs1": rs1, "imm": i_imm}
    elif opcode == 0x23:
        ins.variant = _STORE.get(funct3, "UNIMPL")
        ins.fmt = "FormatS"
        ins.operands = {"rs1": rs1, "rs2": rs2, "imm": s_imm}
    elif opcode == 0x13:
        ins.fmt = "FormatI"
        if funct3 == 1:
            ins.variant = "SLLI"
            ins.operands = {"rd": rd, "rs1": rs1, "imm": rs2}
        elif funct3 == 5:
            ins.variant = "SRAI" if funct7 & 0x20 else "SRLI"
            ins.operands = {"rd": rd, "rs1": rs1, "imm": rs2}
        else:
            ins.variant = _OP_IMM.get(funct3, "UNIMPL")
            ins.operands = {"rd": rd, "rs1": rs1, "imm": i_imm}
    elif opcode == 0x33:
        ins.fmt = "FormatR"
        ins.operands = {"rd": rd, "rs1": rs1, "rs2": rs2}
        if funct7 == 1:
            ins.variant = _OP_M[funct3]
        else:
            base, alt = _OP[funct3]
            ins.variant = alt if (funct7 == 0x20 and alt) else base
    elif opcode == 0x1B:
        ins.fmt = "FormatI"
        if funct3 == 0:
            ins.variant = "ADDIW"
            ins.operands = {"rd": rd, "rs1": rs1, "imm": i_imm}
        elif funct3 == 1:
            ins.variant = "SLLIW"
            ins.operands = {"rd": rd, "rs1": rs1, "imm": rs2 & 0x1F}
        elif funct3 == 5:
            ins.variant = "SRAIW" if funct7 & 0x20 else "SRLIW"
            ins.operands = {"rd": rd, "rs1": rs1, "imm": rs2 & 0x1F}
    elif opcode == 0x3B:
        ins.fmt = "FormatR"
        ins.operands = {"rd": rd, "rs1": rs1, "rs2": rs2}
        if funct7 == 1:
            ins.variant = _OP32_M.get(funct3, "UNIMPL")
        elif funct3 in _OP32:
            base, alt = _OP32[funct3]
            ins.variant = alt if (funct7 == 0x20 and alt) else base
    elif opcode == 0x0F:
        ins.variant, ins.fmt = "FENCE", "FormatI"
        ins.operands = {"rd": rd, "rs1": rs1, "imm": i_imm}
    elif opcode == 0x73:
        ins.variant, ins.fmt = "ECALL", "FormatI"
        ins.operands = {"rd": rd, "rs1": rs1, "imm": i_imm}
    if ins.variant == "UNIMPL":
        ins.fmt, ins.operands = "None", {}
    return ins


_NOOP = JoltInstruction("NoOp")


def preprocess_bytecode(code: bytes, base_address: int):
    """BytecodePreprocessing.preprocess: NoOp sentinel + decoded stream padded
    to a power of two (preprocessing.zig:251-340)."""
    instrs = [JoltInstruction("NoOp")]
    off = 0
    while off < len(code):
        addr = base_address + off
        hw = int.from_bytes(code[off : off + 2], "little")
        if (hw & 3) != 3:
            instrs.append(decode_jolt_instruction(expand_compressed(hw), addr, True))
            off += 2
        else:
            if off + 4 > len(code):
                break
            word = int.from_bytes(code[off : off + 4], "little")
            instrs.append(decode_jolt_instruction(word, addr, False))
            off += 4
    size = max(2, len(instrs))
    size = 1 << (size - 1).bit_length()
    while len(instrs) < size:
        instrs.append(JoltInstruction("NoOp"))
    return size, instrs


def serialize_bytecode_preprocessing(code_size: int, instrs) -> bytes:
    out = [struct.pack("<QQ", code_size, len(instrs))]
    for ins in instrs:
        j = ins.to_json().encode()
        out.append(struct.pack("<Q", len(j)) + j)
    out.append(struct.pack("<Q", 0))  # empty PC map
    return b"".join(out)


def preprocess_ram(memory_init: list[tuple[int, int]]) -> tuple[int, list[int]]:
    """RAMPreprocessing.preprocess: pack (addr, byte) pairs into u64 words
    (preprocessing.zig:365-430)."""
    if not memory_init:
        return 0, []
    min_addr = min(a for a, _ in memory_init)
    max_addr = max(a for a, _ in memory_init) + 3
    min_word = min_addr // 8
    max_word = (max_addr + 7) // 8
    words = [0] * (max_word - min_word + 1)
    for addr, byte in memory_init:
        words[(addr // 8) - min_word] |= byte << ((addr % 8) * 8)
    return min_word * 8, words


def serialize_ram_preprocessing(min_addr: int, words: list[int]) -> bytes:
    return struct.pack("<QQ", min_addr, len(words)) + b"".join(
        struct.pack("<Q", w) for w in words)


def serialize_memory_layout(layout) -> bytes:
    fields = (layout.program_size, layout.max_trusted_advice_size,
              layout.trusted_advice_start, layout.trusted_advice_end,
              layout.max_untrusted_advice_size, layout.untrusted_advice_start,
              layout.untrusted_advice_end, layout.max_input_size,
              layout.max_output_size, layout.input_start, layout.input_end,
              layout.output_start, layout.output_end, layout.stack_size,
              layout.stack_end, layout.memory_size, layout.memory_end,
              layout.panic_addr, layout.termination, layout.io_end)
    return b"".join(struct.pack("<Q", f & M64) for f in fields)


def serialize_shared_preprocessing(code: bytes, base_address: int, layout,
                                   max_padded_trace_length: int) -> bytes:
    code_size, instrs = preprocess_bytecode(code, base_address)
    mem_init = [(base_address + i, b) for i, b in enumerate(code)]
    min_addr, words = preprocess_ram(mem_init)
    return (serialize_bytecode_preprocessing(code_size, instrs)
            + serialize_ram_preprocessing(min_addr, words)
            + serialize_memory_layout(layout)
            + struct.pack("<Q", max_padded_trace_length))


# ---------------------------------------------------------------------------
# Dory verifier setup (GT ladders)
# ---------------------------------------------------------------------------

def dory_verifier_setup(srs: dory.DorySRS) -> dict:
    """fromSRS (preprocessing.zig:875-975): delta/chi per folding level."""
    from ..curve.pairing import multi_pairing

    max_rounds = (len(srs.g1_vec)).bit_length() - 1
    delta_1l, delta_1r, delta_2r, chi = [], [], [], []
    for k in range(max_rounds + 1):
        if k == 0:
            one = tw.FP12_ONE
            delta_1l.append(one)
            delta_1r.append(one)
            delta_2r.append(one)
            chi.append(multi_pairing([(srs.g1_vec[0], srs.g2_vec[0])]))
        else:
            half, full = 1 << (k - 1), 1 << k
            g1_lo, g1_hi = srs.g1_vec[:half], srs.g1_vec[half:full]
            g2_lo, g2_hi = srs.g2_vec[:half], srs.g2_vec[half:full]
            delta_1l.append(chi[k - 1])
            delta_1r.append(multi_pairing(list(zip(g1_hi, g2_lo))))
            delta_2r.append(multi_pairing(list(zip(g1_lo, g2_hi))))
            chi.append(tw.fp12_mul(chi[k - 1],
                                   multi_pairing(list(zip(g1_hi, g2_hi)))))
    return {
        "delta_1l": delta_1l, "delta_1r": delta_1r,
        "delta_2l": list(delta_1l), "delta_2r": delta_2r, "chi": chi,
        "g1_0": srs.g1_vec[0], "g2_0": srs.g2_vec[0],
        "h1": srs.g1_vec[0], "h2": srs.g2_vec[0],
        "ht": multi_pairing([(srs.g1_vec[0], srs.g2_vec[0])]),
        "max_log_n": max_rounds,
    }


def serialize_dory_verifier_setup(vs: dict) -> bytes:
    out = []
    for key in ("delta_1l", "delta_1r", "delta_2l", "delta_2r", "chi"):
        out.append(struct.pack("<Q", len(vs[key])))
        out += [tw.fp12_to_bytes(gt) for gt in vs[key]]
    out.append(dory.compress_g1(vs["g1_0"]))
    out.append(dory.compress_g2(vs["g2_0"]))
    out.append(dory.compress_g1(vs["h1"]))
    out.append(dory.compress_g2(vs["h2"]))
    out.append(tw.fp12_to_bytes(vs["ht"]))
    out.append(struct.pack("<Q", vs["max_log_n"]))
    return b"".join(out)


def export_preprocessing(code: bytes, base_address: int, layout,
                         max_padded_trace_length: int,
                         srs: dory.DorySRS | None = None,
                         srs_log_size: int = 20) -> bytes:
    """The --export-preprocessing file: verifier setup ‖ shared preprocessing
    (main.zig:381-473)."""
    if srs is None:
        srs = dory.setup(srs_log_size)
    vs = dory_verifier_setup(srs)
    return (serialize_dory_verifier_setup(vs)
            + serialize_shared_preprocessing(code, base_address, layout,
                                             max_padded_trace_length))
