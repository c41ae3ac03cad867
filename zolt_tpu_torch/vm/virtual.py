"""Virtual instruction sequences: DIV/REM expansion (beyond the reference).

The reference reserves 96 virtual registers but never emits virtual
sequences (src/tracer/mod.zig:304 "For now without virtual sequences";
src/common/constants.zig:7-19), and in sound mode this repo consequently
had to advice-bind the div/rem dividend (zkvm/raf_gadgets.py module doc).
This module implements the expansion for the eight RV64M divide/remainder
instructions (DIV, DIVU, REM, REMU, DIVW, DIVUW, REMW, REMUW): the tracer
replaces each with a straight-line sequence of simple *virtual rows* over
the reserved registers x32..x127, every one of which is a single existing
lookup-table operation — so every row's operands and output are fully
index-bound in the sound lookups argument, closing the divide gap.

Encoding. Virtual rows use the RISC-V custom-0 opcode (0x0B) in a 64-bit
synthetic word (real instructions keep bits 32+ zero, so uniform u64 field
extraction works for both):

    bits [6:0]   0x0B          bits [14:12] kind[2:0]
    bits [11:7]  rd[4:0]       bits [28:27] kind[4:3]
    bits [19:15] rs1[4:0]      bit  25      first-in-sequence
    bits [24:20] rs2[4:0]      bit  26      last-in-sequence
    bits [33:32] rd[6:5]   [35:34] rs1[6:5]   [37:36] rs2[6:5]

Constraint semantics (r1cs/constraints.py, all pre-wired in the 19 uniform
constraints): every sequence row sets FlagVirtualInstruction, so #17 forces
NextPC = PC + 1 along the sequence AND into the following real row — hence
PC is the *bytecode slot index* whenever a trace contains virtual rows
(sound mode; the expanded bytecode lists sequence rows consecutively).
All rows but the last set FlagDoNotUpdateUnexpandedPC (forced by #18), so
UnexpandedPC stays at the parent's address until the last row advances it.

Soundness of the sequences (prover-supplied ADVICE rows are pinned by
asserts; see the per-sequence comments):

  unsigned core (x, y; advice q, r):
      MULHU(q, y) == 0        q·y has no 64-bit overflow -> MUL row exact
      MUL  l = q·y
      LTE(l, x)               blocks the mod-2^64 wrap of l + r
      ADD  s = l + r;  EQ(s, x)
      VALID_UREM(r, y)        y == 0 or r < y
      VALID_DIV0(y, q)        y == 0 -> q = 2^64-1
    => (q, r) is the unique Euclidean pair (q = 2^64-1, r = x when y = 0).

  signed core: magnitudes via SRA-63 masks (m = x >>a 63; |x| = (x^m) - m),
  then the unsigned core on (|x|, |y|) with the advice mapped through the
  *expected* sign masks: aq = (q ^ (mx^my)) - (mx^my), ar = (r ^ mx) - mx.
  A wrong-signed advice maps to a huge magnitude and fails the unsigned
  checks; the map is bijective, so q, r inherit truncated-division signs
  (q: sign(x)⊕sign(y), r: sign(x)). The RISC-V overflow case
  (-2^63 / -1 = -2^63) falls out of the wrap for free, and VALID_DIV0 on
  the original y pins the divide-by-zero results.

  W variants: operands pre-extended (SEXT32 / zero-extend via AND with
  0xFFFFFFFF), 64-bit core, result moved through SEXT32 (RISC-V W-results
  are sign-extended 32-bit values; q < 2^32 when the divisor is nonzero,
  and the y = 0 all-ones quotient sign-extends to the required -1).
"""

from __future__ import annotations

from enum import IntEnum

from .tables import Table

M64 = (1 << 64) - 1
M32 = (1 << 32) - 1

OPCODE_VIRTUAL = 0x0B

# reserved scratch registers (constants.zig reserves 7+; we use x32..x43)
VQ, VR, V2, V3, V4, V5, V6, V7, V8, V9 = range(32, 42)
VX, VY = 42, 43          # W-variant extended operands (outside core scratch)
X0 = 0


class VK(IntEnum):
    """Virtual row kinds. Each maps to one lookup table operation."""

    ADVICE = 0        # rd := advice           (RangeCheck on the value)
    MUL = 1           # rd := low64(rs1 * rs2)
    MULHU = 2         # rd := high64(rs1 * rs2) unsigned
    ADD = 3           # rd := rs1 + rs2 mod 2^64
    SUB = 4           # rd := rs1 - rs2 mod 2^64
    XOR = 5           # rd := rs1 ^ rs2
    ANDI32 = 6        # rd := rs1 & 0xFFFFFFFF (And, imm)
    SRAI63 = 7        # rd := rs1 >>arith 63   (RightShiftArithmetic, imm)
    SEXT32 = 8        # rd := sext32(rs1)      (SignExtend32)
    MOVE = 9          # rd := rs1              (RangeCheck on rs1)
    ASSERT_EQ = 10    # assert Equal(rs1, rs2) == 1
    ASSERT_LTE = 11   # assert UnsignedLessThanEqual(rs1, rs2) == 1
    ASSERT_VUREM = 12  # assert ValidUnsignedRemainder(rs1, rs2) == 1
    ASSERT_VDIV0 = 13  # assert ValidDiv0(rs1, rs2) == 1


ASSERT_KINDS = frozenset((VK.ASSERT_EQ, VK.ASSERT_LTE,
                          VK.ASSERT_VUREM, VK.ASSERT_VDIV0))

# kinds whose right operand is an immediate (value in VIRT_IMM)
IMM_KINDS = frozenset((VK.ANDI32, VK.SRAI63, VK.SEXT32, VK.MOVE))

VIRT_IMM = {VK.ANDI32: M32, VK.SRAI63: 63, VK.SEXT32: 0, VK.MOVE: 0}

# lookup table per kind (None = the M-ext/Add/Sub native class semantics
# resolved elsewhere; listed here for the table-backed kinds)
VIRT_TABLE = {
    VK.ADVICE: Table.RangeCheck,
    VK.XOR: Table.Xor,
    VK.ANDI32: Table.And,
    VK.SRAI63: Table.RightShiftArithmetic,
    VK.SEXT32: Table.SignExtend32,
    VK.MOVE: Table.RangeCheck,
    VK.ASSERT_EQ: Table.Equal,
    VK.ASSERT_LTE: Table.UnsignedLessThanEqual,
    VK.ASSERT_VUREM: Table.ValidUnsignedRemainder,
    VK.ASSERT_VDIV0: Table.ValidDiv0,
    VK.SUB: Table.Sub,
}


def encode(kind: VK, rd: int, rs1: int, rs2: int,
           first: bool = False, last: bool = False) -> int:
    """Synthetic u64 virtual-row word."""
    k = int(kind)
    w = (OPCODE_VIRTUAL
         | (rd & 0x1F) << 7
         | (k & 0x7) << 12
         | (rs1 & 0x1F) << 15
         | (rs2 & 0x1F) << 20
         | (1 << 25 if first else 0)
         | (1 << 26 if last else 0)
         | ((k >> 3) & 0x3) << 27
         | (rd >> 5) << 32
         | (rs1 >> 5) << 34
         | (rs2 >> 5) << 36)
    return w


def is_virtual_word(w: int) -> bool:
    return (w & 0x7F) == OPCODE_VIRTUAL


def fields(w: int):
    """(kind, rd, rs1, rs2, first, last) of a virtual word."""
    kind = VK(((w >> 12) & 0x7) | (((w >> 27) & 0x3) << 3))
    rd = ((w >> 7) & 0x1F) | (((w >> 32) & 0x3) << 5)
    rs1 = ((w >> 15) & 0x1F) | (((w >> 34) & 0x3) << 5)
    rs2 = ((w >> 20) & 0x1F) | (((w >> 36) & 0x3) << 5)
    return kind, rd, rs1, rs2, bool(w & (1 << 25)), bool(w & (1 << 26))


# ---------------------------------------------------------------------------
# Sequence construction
# ---------------------------------------------------------------------------

def is_div_family(word: int) -> bool:
    """True for the eight RV64M divide/remainder instructions."""
    op = word & 0x7F
    if op not in (0x33, 0x3B):
        return False
    if (word >> 25) & 0x7F != 0x01:
        return False
    return ((word >> 12) & 0x7) >= 4          # DIV/DIVU/REM/REMU (+W)


def _useq(x_reg: int, y_reg: int) -> list[tuple]:
    """Unsigned 64-bit core: advice VQ=q, VR=r pinned to x_reg / y_reg.
    Rows as (kind, rd, rs1, rs2) tuples."""
    return [
        (VK.ADVICE, VQ, X0, X0),
        (VK.ADVICE, VR, X0, X0),
        (VK.MULHU, V2, VQ, y_reg),
        (VK.ASSERT_EQ, X0, V2, X0),
        (VK.MUL, V2, VQ, y_reg),
        (VK.ASSERT_LTE, X0, V2, x_reg),
        (VK.ADD, V3, V2, VR),
        (VK.ASSERT_EQ, X0, V3, x_reg),
        (VK.ASSERT_VUREM, X0, VR, y_reg),
        (VK.ASSERT_VDIV0, X0, y_reg, VQ),
    ]


def _sseq(x_reg: int, y_reg: int) -> list[tuple]:
    """Signed 64-bit core: magnitude decomposition + unsigned checks.
    V4=mask(x) V5=|x| V6=mask(y) V7=|y| V8=mask(q) V9=|q|, then V8=|r|."""
    return [
        (VK.ADVICE, VQ, X0, X0),
        (VK.ADVICE, VR, X0, X0),
        (VK.SRAI63, V4, x_reg, X0),
        (VK.XOR, V5, x_reg, V4),
        (VK.SUB, V5, V5, V4),          # |x|
        (VK.SRAI63, V6, y_reg, X0),
        (VK.XOR, V7, y_reg, V6),
        (VK.SUB, V7, V7, V6),          # |y|
        (VK.XOR, V8, V4, V6),          # expected q sign mask
        (VK.XOR, V9, VQ, V8),
        (VK.SUB, V9, V9, V8),          # |q| (iff q has the expected sign)
        (VK.XOR, V8, VR, V4),
        (VK.SUB, V8, V8, V4),          # |r| (iff r has the dividend's sign)
        (VK.MULHU, V2, V9, V7),
        (VK.ASSERT_EQ, X0, V2, X0),
        (VK.MUL, V2, V9, V7),
        (VK.ASSERT_LTE, X0, V2, V5),
        (VK.ADD, V3, V2, V8),
        (VK.ASSERT_EQ, X0, V3, V5),
        (VK.ASSERT_VUREM, X0, V8, V7),
        (VK.ASSERT_VDIV0, X0, y_reg, VQ),
    ]


def expand(word: int) -> list[int]:
    """Expanded virtual sequence (list of synthetic u64 words) for a
    div-family instruction word. Pure static function of the word — the
    tracer and the bytecode index derive identical sequences."""
    assert is_div_family(word)
    rd = (word >> 7) & 0x1F
    rs1 = (word >> 15) & 0x1F
    rs2 = (word >> 20) & 0x1F
    f3 = (word >> 12) & 0x7
    is_w = (word & 0x7F) == 0x3B
    signed = f3 in (4, 6)              # DIV / REM
    take_rem = f3 in (6, 7)            # REM / REMU

    rows: list[tuple] = []
    if is_w:
        ext = VK.SEXT32 if signed else VK.ANDI32
        rows.append((ext, VX, rs1, X0))
        rows.append((ext, VY, rs2, X0))
        x_reg, y_reg = VX, VY
    else:
        x_reg, y_reg = rs1, rs2
    rows.extend(_sseq(x_reg, y_reg) if signed else _useq(x_reg, y_reg))
    src = VR if take_rem else VQ
    rows.append(((VK.SEXT32 if is_w else VK.MOVE), rd, src, X0))

    out = []
    for i, (k, d, s1, s2) in enumerate(rows):
        out.append(encode(k, d, s1, s2, first=(i == 0),
                          last=(i == len(rows) - 1)))
    return out


# ---------------------------------------------------------------------------
# Row semantics (tracer + witness oracle)
# ---------------------------------------------------------------------------

def _sign64(v: int) -> int:
    return v - (1 << 64) if v >> 63 else v


def advice_values(word: int, rs1_val: int, rs2_val: int) -> tuple[int, int]:
    """(q, r) the honest tracer feeds the two ADVICE rows, per RISC-V."""
    f3 = (word >> 12) & 0x7
    is_w = (word & 0x7F) == 0x3B
    signed = f3 in (4, 6)
    if is_w:
        x = rs1_val & M32
        y = rs2_val & M32
        if signed:
            x = x - (1 << 32) if x >> 31 else x
            y = y - (1 << 32) if y >> 31 else y
    else:
        x, y = rs1_val & M64, rs2_val & M64
        if signed:
            x, y = _sign64(x), _sign64(y)
    if y == 0:
        return M64, x & M64
    if signed:
        q = abs(x) // abs(y)
        if (x < 0) != (y < 0):
            q = -q
        r = x - q * y
        return q & M64, r & M64
    return (x // y) & M64, (x % y) & M64


def row_result(kind: VK, rs1_val: int, rs2_val: int, advice: int = 0) -> int:
    """rd_value (= lookup output) of one virtual row."""
    if kind == VK.ADVICE:
        return advice & M64
    if kind == VK.MUL:
        return (rs1_val * rs2_val) & M64
    if kind == VK.MULHU:
        return ((rs1_val * rs2_val) >> 64) & M64
    if kind == VK.ADD:
        return (rs1_val + rs2_val) & M64
    if kind == VK.SUB:
        return (rs1_val - rs2_val) & M64
    if kind == VK.XOR:
        return rs1_val ^ rs2_val
    if kind == VK.ANDI32:
        return rs1_val & M32
    if kind == VK.SRAI63:
        return (_sign64(rs1_val) >> 63) & M64
    if kind == VK.SEXT32:
        v = rs1_val & M32
        return (v - (1 << 32)) & M64 if v >> 31 else v
    if kind == VK.MOVE:
        return rs1_val & M64
    if kind == VK.ASSERT_EQ:
        return 1 if rs1_val == rs2_val else 0
    if kind == VK.ASSERT_LTE:
        return 1 if rs1_val <= rs2_val else 0
    if kind == VK.ASSERT_VUREM:
        return 1 if (rs2_val == 0 or rs1_val < rs2_val) else 0
    if kind == VK.ASSERT_VDIV0:
        if rs1_val == 0:
            return 1 if rs2_val == M64 else 0
        return 1
    raise ValueError(kind)
