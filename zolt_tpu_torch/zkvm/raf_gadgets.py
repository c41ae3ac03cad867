"""Sound-mode lookup RAF gadgets: the static per-instruction specification
binding LookupOutput / LeftLookupOperand / RightLookupOperand to the
committed 128-bit lookup index.

The reference's 58 instruction-lookup classes (src/zkvm/instruction/
lookups.zig:27-4025) each pair a lookup table with an index derivation; the
Jolt protocol's LookupsRafEvaluation (src/zkvm/jolt_types.zig SumcheckId)
is the sumcheck that re-derives the claimed operand/output MLE evaluations
from the committed one-hot ra polynomials. The reference stubs that stage
(zero proofs); this module is this package's real implementation substrate:

  * `entry_spec(instr)` — a STATIC function of the instruction word giving,
    per lookup slot (out, left, right), a closed-form multilinear *gadget*
    G over the 128 index bits plus a static additive constant c, such that
    the honest witness satisfies   column(j) = G(idx_j) + c   (mod p).
  * `sound_lookup_index(step)` — the sound-mode index derivation. It
    differs from the reference-compat `commitments.jolt_lookup_index` where
    the compat index is lossy (reduced sums, missing load/store entries):
    sum-class indices are stored UNREDUCED (<= 2^65 fits the 128-bit
    space), MUL stores the full 128-bit product, loads/stores get an entry
    with index = rs1 so the RAM-address operand is bound.
  * The gadget evaluator at arbitrary field points (the C-table values).

Classes whose operands are NOT derivable from their index without virtual
sequence expansion (MULH/MULHU/MULHSU, the OP-32/OP-IMM-32 W family, and
the dividend of DIV/REM) are *advice-bound*: sound mode zeroes the
corresponding operand-source flags (`flag_adjust`), so the R1CS operand
columns are provably zero there and the lookup output remains bound to the
committed index. This matches the reference's actual capability (it traces
these directly with no virtual sequences either); the gap is documented in
README and rejected nowhere — proofs stay sound for what they claim.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

from ..field.params import FR
from ..vm import tables as tb
from ..vm.tables import Table

P = FR.p
M64 = (1 << 64) - 1
M32 = (1 << 32) - 1
TWO64 = 1 << 64


class G(IntEnum):
    """Gadget kinds: closed-form multilinear functions of the 128 index
    bits (bit 2i = y_i, bit 2i+1 = x_i for interleaved pairs)."""

    ZERO = 0
    IDENT128 = 1       # sum 2^i k_i over all 128 bits
    IDENT_LOW64 = 2    # sum over low 64 bits
    IDENT_LOW64_NO0 = 3  # low 64 bits with bit 0 dropped (JALR ~1 mask)
    IDENT_HIGH64 = 9   # sum 2^i k_{64+i} (high word of a 128-bit product)
    ODDS = 4           # x-half: sum 2^i k_{2i+1}
    EVENS = 5          # y-half: sum 2^i k_{2i}
    EVENS_PLUS_ODDS = 6
    SUB_COMBO = 7      # 2^64 + odds - evens  (x - y + 2^64)
    TABLE = 8          # tables.evaluate_mle(table, point)


@dataclass(frozen=True)
class Slot:
    g: G
    const: int = 0           # static additive constant (mod p)
    table: Table | None = None


ZERO_SLOT = Slot(G.ZERO)


@dataclass(frozen=True)
class RafSpec:
    """Static lookup spec for one instruction word."""

    name: str
    out: Slot
    left: Slot
    right: Slot
    valid_table: Table | None = None   # div/rem validity table (value == 1)
    # operand-source flags to zero in the sound witness (advice-bound ops)
    zero_left_flag: bool = False
    zero_right_flag: bool = False
    zero_output: bool = False          # LookupOutput column zeroed


def gadget_eval_bits(slot: Slot, idx: int) -> int:
    """Gadget value at a binary index (integer semantics, mod p)."""
    g = slot.g
    if g == G.ZERO:
        v = 0
    elif g == G.IDENT128:
        v = idx % P
    elif g == G.IDENT_LOW64:
        v = idx & M64
    elif g == G.IDENT_LOW64_NO0:
        v = idx & M64 & ~1
    elif g == G.IDENT_HIGH64:
        v = (idx >> 64) & M64
    elif g == G.ODDS:
        v = tb.uninterleave_bits(idx, 64)[0]
    elif g == G.EVENS:
        v = tb.uninterleave_bits(idx, 64)[1]
    elif g == G.EVENS_PLUS_ODDS:
        x, y = tb.uninterleave_bits(idx, 64)
        v = x + y
    elif g == G.SUB_COMBO:
        x, y = tb.uninterleave_bits(idx, 64)
        v = TWO64 + x - y
    else:
        v = tb.materialize_entry(slot.table, idx, 64)
    return (v + slot.const) % P


def gadget_eval_point(slot: Slot, r: list[int]) -> int:
    """Gadget multilinear extension at an arbitrary 128-coordinate point
    (little-endian: r[i] is index bit i). Verifier-side closed form."""
    g = slot.g
    assert len(r) == 128
    if g == G.ZERO:
        v = 0
    elif g == G.IDENT128:
        v = sum((1 << i) * r[i] for i in range(128)) % P
    elif g == G.IDENT_LOW64:
        v = sum((1 << i) * r[i] for i in range(64)) % P
    elif g == G.IDENT_LOW64_NO0:
        v = sum((1 << i) * r[i] for i in range(1, 64)) % P
    elif g == G.IDENT_HIGH64:
        v = sum((1 << i) * r[64 + i] for i in range(64)) % P
    elif g == G.ODDS:
        v = sum((1 << i) * r[2 * i + 1] for i in range(64)) % P
    elif g == G.EVENS:
        v = sum((1 << i) * r[2 * i] for i in range(64)) % P
    elif g == G.EVENS_PLUS_ODDS:
        v = sum((1 << i) * (r[2 * i] + r[2 * i + 1]) for i in range(64)) % P
    elif g == G.SUB_COMBO:
        v = (TWO64 + sum((1 << i) * (r[2 * i + 1] - r[2 * i])
                         for i in range(64))) % P
    else:
        # vm/tables closed forms consume big-endian points
        v = tb.evaluate_mle(slot.table, list(reversed(r)), 64)
    return (v + slot.const) % P


# ---------------------------------------------------------------------------
# Static classification
# ---------------------------------------------------------------------------

def _i_imm_signed(instr: int) -> int:
    imm = instr >> 20
    return imm - (1 << 12) if imm & 0x800 else imm


def _j_imm_signed(instr: int) -> int:
    imm = ((((instr >> 31) & 1) << 20) | (((instr >> 12) & 0xFF) << 12)
           | (((instr >> 20) & 1) << 11) | (((instr >> 21) & 0x3FF) << 1))
    return imm - (1 << 21) if imm & (1 << 20) else imm


def _s_imm_signed(instr: int) -> int:
    imm = (((instr >> 25) & 0x7F) << 5) | ((instr >> 7) & 0x1F)
    return imm - (1 << 12) if imm & 0x800 else imm


def _imm_field(v: int) -> int:
    """Signed python int -> field element."""
    return v % P


_ALU_TABLES = {1: Table.LeftShift, 2: Table.SignedLessThan,
               3: Table.UnsignedLessThan, 4: Table.Xor, 5: Table.RightShift,
               6: Table.Or, 7: Table.And}
_BR_TABLES = {0: Table.Equal, 1: Table.NotEqual, 4: Table.SignedLessThan,
              5: Table.SignedGreaterThanEqual, 6: Table.UnsignedLessThan,
              7: Table.UnsignedGreaterThanEqual}


def entry_spec(instr: int) -> RafSpec | None:
    """The static RAF spec of an instruction word (None = no lookup entry in
    sound mode). Must stay in lockstep with `sound_lookup_index` and the
    sound witness adjustments in r1cs/inputs.cycle_witness."""
    opcode = instr & 0x7F
    f3 = (instr >> 12) & 0x7
    f7 = (instr >> 25) & 0x7F

    if opcode == 0x0B:  # virtual-sequence rows (vm/virtual.py)
        return _virtual_spec(instr)

    if opcode == 0x33:  # OP
        if f7 == 0x01:  # M extension
            if f3 == 0:   # MUL: index = full 128-bit product
                return RafSpec("Mul", Slot(G.IDENT_LOW64), ZERO_SLOT,
                               Slot(G.IDENT128))
            if f3 in (1, 2, 3):  # MULH/MULHSU/MULHU: index = high word
                return RafSpec("Mulh", Slot(G.IDENT_LOW64), ZERO_SLOT,
                               ZERO_SLOT, zero_left_flag=True,
                               zero_right_flag=True)
            if f3 in (4, 5):  # DIV/DIVU: interleave(rs2, q)
                return RafSpec("Div", Slot(G.EVENS), ZERO_SLOT, Slot(G.ODDS),
                               valid_table=Table.ValidDiv0,
                               zero_left_flag=True)
            # REM/REMU: interleave(rem, rs2). Signed REM carries no validity
            # instance: ValidSignedRemainder encodes Jolt's virtual-sequence
            # convention sign(rem)==sign(divisor), but direct traces follow
            # the RISC-V rule sign(rem)==sign(dividend) — the dividend is
            # not in the index, so the check is inapplicable here.
            return RafSpec(
                "Rem", Slot(G.ODDS), ZERO_SLOT, Slot(G.EVENS),
                valid_table=(None if f3 == 6
                             else Table.ValidUnsignedRemainder),
                zero_left_flag=True)
        if f3 == 0:
            if f7 & 0x20:  # SUB: interleave(rs1, rs2)
                return RafSpec("Sub", Slot(G.TABLE, 0, Table.Sub), ZERO_SLOT,
                               Slot(G.SUB_COMBO))
            # ADD: index = rs1 + rs2 unreduced
            return RafSpec("Add", Slot(G.IDENT_LOW64), ZERO_SLOT,
                           Slot(G.IDENT128))
        t = Table.RightShiftArithmetic if (f3 == 5 and (f7 & 0x20)) \
            else _ALU_TABLES[f3]
        # interleave(rs1, rs2); witness Right = rs1 + rs2 (add-operands path)
        return RafSpec("Alu", Slot(G.TABLE, 0, t), ZERO_SLOT,
                       Slot(G.EVENS_PLUS_ODDS))

    if opcode == 0x13:  # OP-IMM
        imm = _i_imm_signed(instr)
        if f3 == 0:  # ADDI: index = rs1 + imm_u64 unreduced
            return RafSpec("Addi", Slot(G.IDENT_LOW64), ZERO_SLOT,
                           Slot(G.IDENT128, (-TWO64) % P if imm < 0 else 0))
        if f3 in (1, 5):  # shifts: interleave(rs1, shamt); Right = rs1 + imm
            t = Table.RightShiftArithmetic if (f3 == 5 and (f7 & 0x20)) \
                else _ALU_TABLES[f3]
            return RafSpec("ShiftImm", Slot(G.TABLE, 0, t), ZERO_SLOT,
                           Slot(G.ODDS, _imm_field(imm)))
        # ANDI/ORI/XORI/SLTI/SLTIU: interleave(rs1, imm_u64)
        return RafSpec("AluImm", Slot(G.TABLE, 0, _ALU_TABLES[f3]), ZERO_SLOT,
                       Slot(G.ODDS, _imm_field(imm)))

    if opcode == 0x63:  # branches: interleave(rs1, rs2)
        t = _BR_TABLES.get(f3)
        if t is None:
            return None
        return RafSpec("Branch", Slot(G.TABLE, 0, t), Slot(G.ODDS),
                       Slot(G.EVENS))

    if opcode in (0x03, 0x23):  # loads/stores: index = rs1
        imm = _i_imm_signed(instr) if opcode == 0x03 else _s_imm_signed(instr)
        return RafSpec("MemAddress", ZERO_SLOT, Slot(G.IDENT_LOW64),
                       Slot(G.ZERO, _imm_field(imm)), zero_output=True)

    if opcode in (0x37, 0x17):
        # LUI/AUIPC: rd uses the RV64 sign-extended U-immediate, but the
        # witness Right operand uses the UNSIGNED immediate
        # (inputs.derive_immediate); the index stores the sign-extended
        # integer, so Right needs a static -(2^64 - 2^32) offset when
        # imm bit 31 is set.
        neg = (instr >> 31) & 1
        off = (-(TWO64 - (1 << 32))) % P if neg else 0
        name = "Lui" if opcode == 0x37 else "Auipc"
        return RafSpec(name, Slot(G.IDENT_LOW64), ZERO_SLOT,
                       Slot(G.IDENT128, off))
    if opcode == 0x6F:  # JAL: index = pc + jimm_u64
        imm = _j_imm_signed(instr)
        return RafSpec("Jal", Slot(G.IDENT_LOW64), ZERO_SLOT,
                       Slot(G.IDENT128, (-TWO64) % P if imm < 0 else 0))
    if opcode == 0x67:  # JALR: index = rs1 + iimm_u64; output masks bit 0
        imm = _i_imm_signed(instr)
        return RafSpec("Jalr", Slot(G.IDENT_LOW64_NO0), ZERO_SLOT,
                       Slot(G.IDENT128, (-TWO64) % P if imm < 0 else 0))

    if opcode in (0x1B, 0x3B):
        # W-family: operands/outputs not index-derivable without virtual
        # sequences; advice-bound (flags + output zeroed, no lookup entry)
        return None
    return None  # SYSTEM / FENCE / anything else: no lookup


def _virtual_spec(instr: int) -> RafSpec:
    """RAF specs for the virtual-sequence kinds (vm/virtual.py). Every kind
    is fully index-bound: operand columns are linear gadgets of the
    committed 128-bit index (interleaved pairs for table kinds, unreduced
    sums for the add-class kinds, the full product for MUL/MULHU — whose
    mul-operand fusion, constraint #9, pins idx = rs1*rs2 exactly since
    both fit far below p)."""
    from ..vm import virtual as vi

    kind = vi.fields(instr)[0]
    VK = vi.VK
    if kind == VK.ADVICE:
        return RafSpec("VAdvice", Slot(G.IDENT_LOW64), ZERO_SLOT,
                       Slot(G.IDENT_LOW64))
    if kind == VK.MUL:
        return RafSpec("VMul", Slot(G.IDENT_LOW64), ZERO_SLOT,
                       Slot(G.IDENT128))
    if kind == VK.MULHU:
        return RafSpec("VMulhu", Slot(G.IDENT_HIGH64), ZERO_SLOT,
                       Slot(G.IDENT128))
    if kind == VK.ADD:
        return RafSpec("VAdd", Slot(G.IDENT_LOW64), ZERO_SLOT,
                       Slot(G.IDENT128))
    if kind == VK.MOVE:
        return RafSpec("VMove", Slot(G.IDENT_LOW64), ZERO_SLOT,
                       Slot(G.IDENT128))
    if kind == VK.SUB:
        return RafSpec("VSub", Slot(G.TABLE, 0, Table.Sub), ZERO_SLOT,
                       Slot(G.SUB_COMBO))
    if kind == VK.SEXT32:
        # SignExtend32 reads the RAW index (low 32 bits), so idx = rs1
        # un-interleaved; the left operand is the identity of the index
        return RafSpec("VSext32", Slot(G.TABLE, 0, Table.SignExtend32),
                       Slot(G.IDENT_LOW64), ZERO_SLOT)
    # plain two-operand table kinds: idx = interleave(rs1, y)
    table = vi.VIRT_TABLE[kind]
    return RafSpec("VTable", Slot(G.TABLE, 0, table), Slot(G.ODDS),
                   Slot(G.EVENS))


def needs_witness_adjust(instr: int) -> tuple[bool, bool, bool]:
    """(zero_left_flag, zero_right_flag, zero_output) for the sound witness.
    W-family and system opcodes (spec None) zero everything unbindable."""
    spec = entry_spec(instr)
    if spec is None:
        opcode = instr & 0x7F
        if opcode in (0x1B, 0x3B):
            return True, True, True
        return False, False, True   # system/fence: output only
    return spec.zero_left_flag, spec.zero_right_flag, spec.zero_output


def sound_lookup_index(step) -> int | None:
    """Sound-mode 128-bit lookup index (unreduced sums / full products /
    load-store entries). None = no entry (W-family, system)."""
    instr = step.instruction
    opcode = instr & 0x7F
    f3 = (instr >> 12) & 0x7
    f7 = (instr >> 25) & 0x7F
    rs1 = step.rs1_value & M64
    rs2 = step.rs2_value & M64

    if opcode == 0x0B:  # virtual-sequence rows (vm/virtual.py)
        from ..vm import virtual as vi

        kind = vi.fields(instr)[0]
        VK = vi.VK
        if kind == VK.ADVICE:
            return step.rd_value & M64
        if kind in (VK.MUL, VK.MULHU):
            return rs1 * rs2                          # full 128-bit product
        if kind == VK.ADD:
            return rs1 + rs2                          # unreduced
        if kind in (VK.MOVE, VK.SEXT32):
            return rs1                                # raw-index tables
        if kind == VK.SUB:
            return tb.interleave_bits(rs1, rs2)
        y = vi.VIRT_IMM[kind] if kind in vi.IMM_KINDS else rs2
        return tb.interleave_bits(rs1, y & M64)

    if opcode == 0x33:
        if f7 == 0x01:
            if f3 == 0:
                return rs1 * rs2                      # full product
            # MULH*/DIV*/REM*: same as the compat catalog
            from .commitments import jolt_lookup_index
            return jolt_lookup_index(step)
        if f3 == 0:
            if f7 & 0x20:
                return tb.interleave_bits(rs1, rs2)
            return rs1 + rs2                          # unreduced
        return tb.interleave_bits(rs1, rs2)

    if opcode == 0x13:
        imm = _i_imm_signed(instr)
        if f3 == 0:
            return rs1 + (imm % TWO64)                # unreduced
        if f3 in (1, 5):
            return tb.interleave_bits(rs1, (imm & M32) & 0x3F)
        return tb.interleave_bits(rs1, imm % TWO64)

    if opcode == 0x63:
        return tb.interleave_bits(rs1, rs2)

    if opcode in (0x03, 0x23):
        return rs1

    if opcode in (0x37, 0x17):
        imm = instr & 0xFFFFF000
        if imm >> 31:
            imm += TWO64 - (1 << 32)                  # RV64 sext32 as u64
        return imm if opcode == 0x37 else step.pc + imm
    if opcode == 0x6F:
        return step.pc + (_j_imm_signed(instr) % TWO64)
    if opcode == 0x67:
        return rs1 + (_i_imm_signed(instr) % TWO64)
    return None
