"""R1CS input indices and per-cycle witness construction.

The 43 per-cycle inputs (36 core + product-virtual + operand flags) and their
exact construction from a trace step, matching the reference byte-for-byte
(src/zkvm/r1cs/constraints.zig:40-96, 898-1430). Order is Jolt's
ALL_R1CS_INPUTS order — load-bearing for claim matching.

Witness values are canonical Fr ints; negative quantities wrap mod p.
"""

from __future__ import annotations

from enum import IntEnum

from ..field.params import FR

P = FR.p
TWO64 = 1 << 64


class Inp(IntEnum):
    LeftInstructionInput = 0
    RightInstructionInput = 1
    Product = 2
    WriteLookupOutputToRD = 3
    WritePCtoRD = 4
    ShouldBranch = 5
    PC = 6
    UnexpandedPC = 7
    Imm = 8
    RamAddress = 9
    Rs1Value = 10
    Rs2Value = 11
    RdWriteValue = 12
    RamReadValue = 13
    RamWriteValue = 14
    LeftLookupOperand = 15
    RightLookupOperand = 16
    NextUnexpandedPC = 17
    NextPC = 18
    NextIsVirtual = 19
    NextIsFirstInSequence = 20
    LookupOutput = 21
    ShouldJump = 22
    FlagAddOperands = 23
    FlagSubtractOperands = 24
    FlagMultiplyOperands = 25
    FlagLoad = 26
    FlagStore = 27
    FlagJump = 28
    FlagWriteLookupOutputToRD = 29
    FlagVirtualInstruction = 30
    FlagAssert = 31
    FlagDoNotUpdateUnexpandedPC = 32
    FlagAdvice = 33
    FlagIsCompressed = 34
    FlagIsFirstInSequence = 35
    FlagIsRdNotZero = 36
    FlagBranch = 37
    FlagIsNoop = 38
    FlagLeftOperandIsRs1 = 39
    FlagLeftOperandIsPC = 40
    FlagRightOperandIsRs2 = 41
    FlagRightOperandIsImm = 42


NUM_INPUTS = 43


def _s64(x: int) -> int:
    return x - TWO64 if x >> 63 else x


def _sext_field(v: int, bits: int) -> int:
    """Sign-extended immediate as a field element (negatives wrap mod p)."""
    if v & (1 << (bits - 1)):
        return (-((~v + 1) & ((1 << bits) - 1))) % P
    return v % P


def derive_immediate(instr: int) -> int:
    """Field-valued immediate, reference deriveImmediate semantics — note
    LUI/AUIPC are UNSIGNED here (constraints.zig:1267-1270)."""
    opcode = instr & 0x7F
    if opcode in (0x13, 0x03, 0x67):
        return _sext_field(instr >> 20, 12)
    if opcode == 0x23:
        imm = (((instr >> 25) & 0x7F) << 5) | ((instr >> 7) & 0x1F)
        return _sext_field(imm, 12)
    if opcode == 0x63:
        imm = ((((instr >> 31) & 1) << 12) | (((instr >> 7) & 1) << 11)
               | (((instr >> 25) & 0x3F) << 5) | (((instr >> 8) & 0xF) << 1))
        return _sext_field(imm, 13)
    if opcode == 0x6F:
        imm = ((((instr >> 31) & 1) << 20) | (((instr >> 12) & 0xFF) << 12)
               | (((instr >> 20) & 1) << 11) | (((instr >> 21) & 0x3FF) << 1))
        return _sext_field(imm, 21)
    if opcode in (0x37, 0x17):
        return instr & 0xFFFFF000  # unsigned
    return 0


def _jtype_imm(instr: int) -> int:
    imm = ((((instr >> 31) & 1) << 20) | (((instr >> 12) & 0xFF) << 12)
           | (((instr >> 20) & 1) << 11) | (((instr >> 21) & 0x3FF) << 1))
    if imm & (1 << 20):
        imm -= 1 << 21
    return imm


def _itype_imm(instr: int) -> int:
    imm = instr >> 20
    if imm & 0x800:
        imm -= 1 << 12
    return imm


def compute_lookup_output(step) -> int:
    """reference computeLookupOutput (constraints.zig:600-640)."""
    opcode = step.instruction & 0x7F
    if opcode == 0x6F:  # JAL: PC + imm
        return (step.pc + _jtype_imm(step.instruction)) % TWO64
    if opcode == 0x67:  # JALR: (rs1 + imm) & ~1
        return ((step.rs1_value + _itype_imm(step.instruction)) % TWO64) & ~1
    if opcode == 0x63:  # branch condition
        f3 = (step.instruction >> 12) & 0x7
        rs1, rs2 = step.rs1_value, step.rs2_value
        taken = {
            0x0: rs1 == rs2, 0x1: rs1 != rs2,
            0x4: _s64(rs1) < _s64(rs2), 0x5: _s64(rs1) >= _s64(rs2),
            0x6: rs1 < rs2, 0x7: rs1 >= rs2,
        }.get(f3, False)
        return 1 if taken else 0
    return step.rd_value


def noop_witness() -> list[int]:
    """NoOp padding cycle witness: all zero except DoNotUpdateUnexpandedPC and
    IsNoop (constraints.zig:1398-1424)."""
    w = [0] * NUM_INPUTS
    w[Inp.FlagDoNotUpdateUnexpandedPC] = 1
    w[Inp.FlagIsNoop] = 1
    return w


def _virtual_cycle_witness(step, next_step) -> list[int]:
    """Witness row for one virtual-sequence row (vm/virtual.py). Every kind
    is one lookup-table operation; flags follow the same uniform-constraint
    conventions as the real opcodes below (MUL/ADD/SUB rows reuse the
    native operand-fusion flags; asserts set FlagAssert so constraint #11
    pins LookupOutput == 1; ADVICE rows are excluded from the
    RightLookupOperand binding by constraint #10 and range-check their
    value instead)."""
    from ..vm import virtual as vi

    kind, rd, rs1, rs2, first, last = vi.fields(step.instruction)
    w = [0] * NUM_INPUTS
    w[Inp.FlagVirtualInstruction] = 1
    w[Inp.FlagIsFirstInSequence] = 1 if first else 0
    w[Inp.FlagDoNotUpdateUnexpandedPC] = 0 if last else 1
    imm = vi.VIRT_IMM.get(kind, 0)
    w[Inp.Imm] = imm % P

    left_is_rs1 = 0 if kind == vi.VK.ADVICE else 1
    right_is_rs2 = 1 if (kind in (vi.VK.MUL, vi.VK.MULHU, vi.VK.ADD,
                                  vi.VK.SUB, vi.VK.XOR)
                         or kind in vi.ASSERT_KINDS) else 0
    right_is_imm = 1 if kind in (vi.VK.ANDI32, vi.VK.SRAI63) else 0
    w[Inp.FlagLeftOperandIsRs1] = left_is_rs1
    w[Inp.FlagRightOperandIsRs2] = right_is_rs2
    w[Inp.FlagRightOperandIsImm] = right_is_imm
    if left_is_rs1:
        w[Inp.Rs1Value] = step.rs1_value % P
    if right_is_rs2:
        w[Inp.Rs2Value] = step.rs2_value % P
    left = w[Inp.Rs1Value] if left_is_rs1 else 0
    right = (w[Inp.Rs2Value] if right_is_rs2 else 0) + right_is_imm * w[Inp.Imm]
    right %= P
    w[Inp.LeftInstructionInput] = left
    w[Inp.RightInstructionInput] = right
    w[Inp.Product] = left * right % P

    adv = step.rd_value if kind == vi.VK.ADVICE else 0
    out = vi.row_result(kind, step.rs1_value,
                        0 if kind in vi.IMM_KINDS else step.rs2_value, adv)
    w[Inp.LookupOutput] = out % P

    if kind in (vi.VK.MUL, vi.VK.MULHU):
        # mul-operand fusion (constraint #9 pins RightLookupOperand to the
        # R1CS Product, which in turn pins the committed full-product index
        # exactly — the MULHU output gadget reads its high word)
        w[Inp.FlagMultiplyOperands] = 1
        w[Inp.RightLookupOperand] = w[Inp.Product]
        w[Inp.FlagWriteLookupOutputToRD] = 1
    elif kind in (vi.VK.ADD, vi.VK.MOVE):
        # MOVE is an add-class row with right = 0: index = value,
        # RangeCheck output = value
        w[Inp.FlagAddOperands] = 1
        w[Inp.RightLookupOperand] = (left + right) % P
        w[Inp.FlagWriteLookupOutputToRD] = 1
    elif kind == vi.VK.SUB:
        w[Inp.FlagSubtractOperands] = 1
        w[Inp.RightLookupOperand] = (left - right + TWO64) % P
        w[Inp.FlagWriteLookupOutputToRD] = 1
    elif kind == vi.VK.ADVICE:
        w[Inp.FlagAdvice] = 1
        w[Inp.RightLookupOperand] = out % P
        w[Inp.FlagWriteLookupOutputToRD] = 1
    elif kind in vi.ASSERT_KINDS:
        w[Inp.FlagAssert] = 1
        w[Inp.LeftLookupOperand] = left
        w[Inp.RightLookupOperand] = right
    else:  # XOR, ANDI32, SRAI63, SEXT32: plain two-operand lookups
        w[Inp.LeftLookupOperand] = left
        w[Inp.RightLookupOperand] = right
        w[Inp.FlagWriteLookupOutputToRD] = 1

    w[Inp.PC] = step.pc % P
    w[Inp.UnexpandedPC] = step.unexpanded_pc % P
    if next_step is not None and not next_step.is_noop:
        w[Inp.NextPC] = next_step.pc % P
        w[Inp.NextUnexpandedPC] = next_step.unexpanded_pc % P
        if (next_step.instruction & 0x7F) == 0x0B:
            w[Inp.NextIsVirtual] = 1
            w[Inp.NextIsFirstInSequence] = \
                1 if (next_step.instruction >> 25) & 1 else 0

    is_rd_not_zero = 1 if rd != 0 else 0
    w[Inp.WriteLookupOutputToRD] = is_rd_not_zero * w[Inp.FlagWriteLookupOutputToRD]
    w[Inp.FlagIsRdNotZero] = is_rd_not_zero
    w[Inp.RdWriteValue] = step.rd_value % P if is_rd_not_zero else 0
    return w


def cycle_witness(step, next_step, sound: bool = False) -> list[int]:
    """Build the 43 witness values for one real trace step (canonical ints)."""
    if step.is_noop:
        return noop_witness()
    if (step.instruction & 0x7F) == 0x0B:
        return _virtual_cycle_witness(step, next_step)

    w = [0] * NUM_INPUTS
    instr = step.instruction
    opcode = instr & 0x7F
    funct3 = (instr >> 12) & 0x7
    funct7 = (instr >> 25) & 0x7F
    rd = (instr >> 7) & 0x1F

    is_load = opcode == 0x03
    is_store = opcode == 0x23
    is_branch = opcode == 0x63

    if is_load:
        w[Inp.FlagLoad] = 1
    if is_store:
        w[Inp.FlagStore] = 1
    if step.is_compressed:
        w[Inp.FlagIsCompressed] = 1

    imm = derive_immediate(instr)
    w[Inp.Imm] = imm

    reads_rs1 = opcode in (0x13, 0x03, 0x67, 0x1B, 0x33, 0x3B, 0x23, 0x63)
    reads_rs2 = opcode in (0x33, 0x3B, 0x23, 0x63)
    if reads_rs1:
        w[Inp.Rs1Value] = step.rs1_value % P
    if reads_rs2:
        w[Inp.Rs2Value] = step.rs2_value % P

    if is_load or is_store:
        w[Inp.RamAddress] = (step.rs1_value + imm) % P
    mem_val = step.memory_value if step.memory_value is not None else 0

    writes_to_rd = (not is_store) and (not is_branch) and rd != 0
    if is_load:
        w[Inp.RamReadValue] = mem_val % P
        w[Inp.RamWriteValue] = mem_val % P
        w[Inp.RdWriteValue] = mem_val % P
    elif is_store:
        if sound and step.memory_pre_value is not None:
            # sound mode: the true Jolt semantic rv(store) = pre-value, so
            # the RWC input claim rv + gamma*wv equals the instance's true
            # sum (no R1CS constraint pins rv for stores, so this stays
            # satisfying; reference-compat mode reproduces the reference's
            # rv(store) = stored-value convention)
            w[Inp.RamReadValue] = step.memory_pre_value % P
        else:
            w[Inp.RamReadValue] = mem_val % P
        w[Inp.RamWriteValue] = step.rs2_value % P
    else:
        w[Inp.RdWriteValue] = step.rd_value % P if writes_to_rd else 0

    # operand-source flags
    left_is_rs1 = 1 if opcode in (0x33, 0x13, 0x03, 0x67, 0x23, 0x63, 0x1B, 0x3B) else 0
    left_is_pc = 1 if opcode in (0x17, 0x6F) else 0
    right_is_rs2 = 1 if opcode in (0x33, 0x63, 0x3B) else 0
    right_is_imm = 1 if opcode in (0x13, 0x03, 0x67, 0x23, 0x37, 0x17, 0x6F, 0x1B) else 0
    zero_output = False
    if sound:
        # Sound-mode RAF binding (zkvm/raf_gadgets.py): operands that are
        # not derivable from the committed lookup index (MULH*, the W
        # family, the div/rem dividend) have their source flags zeroed, so
        # the operand columns are provably zero and every remaining lookup
        # claim is index-bound. LookupOutput is zeroed where the class has
        # no output gadget (loads/stores/system/W) — unconstrained slots.
        from ..zkvm.raf_gadgets import needs_witness_adjust

        zl, zr, zero_output = needs_witness_adjust(instr)
        if zl:
            left_is_rs1 = left_is_pc = 0
        if zr:
            right_is_rs2 = right_is_imm = 0
    w[Inp.FlagLeftOperandIsRs1] = left_is_rs1
    w[Inp.FlagLeftOperandIsPC] = left_is_pc
    w[Inp.FlagRightOperandIsRs2] = right_is_rs2
    w[Inp.FlagRightOperandIsImm] = right_is_imm

    pc_val = step.unexpanded_pc % P
    left = (left_is_rs1 * w[Inp.Rs1Value] + left_is_pc * pc_val) % P
    right = (right_is_rs2 * w[Inp.Rs2Value] + right_is_imm * imm) % P
    w[Inp.LeftInstructionInput] = left
    w[Inp.RightInstructionInput] = right
    w[Inp.Product] = left * right % P

    w[Inp.LookupOutput] = 0 if zero_output else compute_lookup_output(step) % P
    w[Inp.PC] = step.pc % P
    w[Inp.UnexpandedPC] = step.unexpanded_pc % P

    if next_step is not None and not next_step.is_noop:
        w[Inp.NextPC] = next_step.pc % P
        w[Inp.NextUnexpandedPC] = next_step.unexpanded_pc % P
        if (next_step.instruction & 0x7F) == 0x0B:
            # next row opens a virtual sequence (vm/virtual.py)
            w[Inp.NextIsVirtual] = 1
            w[Inp.NextIsFirstInSequence] = \
                1 if (next_step.instruction >> 25) & 1 else 0

    # flags + lookup operands per opcode (constraints.zig setFlagsFromInstruction)
    if opcode in (0x03, 0x23, 0x63):
        w[Inp.LeftLookupOperand] = left
        w[Inp.RightLookupOperand] = right
    elif opcode == 0x33:
        if funct7 == 0x01:
            if funct3 == 0x0:  # MUL
                w[Inp.FlagMultiplyOperands] = 1
                w[Inp.LeftLookupOperand] = 0
                w[Inp.RightLookupOperand] = w[Inp.Product]
            else:
                w[Inp.LeftLookupOperand] = left
                w[Inp.RightLookupOperand] = right
        elif funct7 == 0x20 and funct3 == 0x0:  # SUB
            w[Inp.FlagSubtractOperands] = 1
            w[Inp.LeftLookupOperand] = 0
            w[Inp.RightLookupOperand] = (left - right + TWO64) % P
        else:
            w[Inp.FlagAddOperands] = 1
            w[Inp.LeftLookupOperand] = 0
            w[Inp.RightLookupOperand] = (right + left) % P
        w[Inp.FlagWriteLookupOutputToRD] = 1
    elif opcode == 0x13:
        w[Inp.FlagAddOperands] = 1
        w[Inp.LeftLookupOperand] = 0
        w[Inp.RightLookupOperand] = (right + left) % P
        w[Inp.FlagWriteLookupOutputToRD] = 1
    elif opcode == 0x6F:
        w[Inp.FlagJump] = 1
        w[Inp.FlagAddOperands] = 1
        w[Inp.LeftLookupOperand] = 0
        w[Inp.RightLookupOperand] = (left + right) % P
    elif opcode == 0x67:
        w[Inp.FlagJump] = 1
        w[Inp.FlagAddOperands] = 1
        w[Inp.LeftLookupOperand] = 0
        w[Inp.RightLookupOperand] = (left + right) % P
    elif opcode == 0x37:
        w[Inp.FlagAddOperands] = 1
        w[Inp.FlagWriteLookupOutputToRD] = 1
        w[Inp.LeftLookupOperand] = 0
        w[Inp.RightLookupOperand] = (left + right) % P
    elif opcode == 0x17:
        w[Inp.FlagAddOperands] = 1
        w[Inp.FlagWriteLookupOutputToRD] = 1
        w[Inp.LeftLookupOperand] = 0
        w[Inp.RightLookupOperand] = (left + right) % P
    else:
        w[Inp.LeftLookupOperand] = left
        w[Inp.RightLookupOperand] = right

    # derived products (after flags)
    next_is_noop = 1 if (next_step is None or next_step.is_noop) else 0
    w[Inp.ShouldJump] = w[Inp.FlagJump] * (1 - next_is_noop)
    is_rd_not_zero = 1 if rd != 0 else 0
    w[Inp.WriteLookupOutputToRD] = is_rd_not_zero * w[Inp.FlagWriteLookupOutputToRD]
    w[Inp.WritePCtoRD] = is_rd_not_zero * w[Inp.FlagJump]
    w[Inp.ShouldBranch] = w[Inp.LookupOutput] * (1 if is_branch else 0) % P
    w[Inp.FlagIsRdNotZero] = is_rd_not_zero
    w[Inp.FlagBranch] = 1 if is_branch else 0
    w[Inp.FlagIsNoop] = 0
    return w


def witness_matrix(padded_steps, sound: bool = False,
                   slots: list[int] | None = None) -> list[list[int]]:
    """Per-cycle witness rows for the whole (padded) trace.

    slots: when the trace contains virtual-sequence rows, the PC column
    must be the bytecode SLOT index (constraint #17 chains PC by +1 through
    a sequence and into the following real row — only slot indexing makes
    that contiguous). The pipeline passes bc_index.slots_per_cycle(...)
    here; address-PC traces (reference-compat, no sequences) pass None."""
    out = []
    n = len(padded_steps)
    for i, step in enumerate(padded_steps):
        nxt = padded_steps[i + 1] if i + 1 < n else None
        w = cycle_witness(step, nxt, sound=sound)
        if slots is not None and not step.is_noop:
            w[Inp.PC] = slots[i] % P
            if nxt is not None and not nxt.is_noop:
                w[Inp.NextPC] = slots[i + 1] % P
        out.append(w)
    return out


# ---------------------------------------------------------------------------
# Columnar witness generation (vectorized)
# ---------------------------------------------------------------------------

_ARR_MEMO: list = []   # single-entry memo: [(first_step, n, result)]


def _steps_to_arrays(steps):
    """Numpy step arrays from TraceStep objects. Memoized on the identity of
    the first step + length — witness gen, the stage-4 registers prover, and
    the commitment index builder all scan the same real-trace prefix (the
    memo holds the first step alive, so the id key cannot be recycled)."""
    import numpy as np

    n = len(steps)
    for first, m, out in _ARR_MEMO:
        if m == n and steps and first is steps[0]:
            return out
    cols = {k: np.zeros(n, dtype=np.uint64)
            for k in ("instruction", "pc", "unexpanded_pc", "rs1_value",
                      "rs2_value", "rd_value", "rd_pre_value",
                      "memory_value", "memory_pre_value", "memory_addr")}
    comp = np.zeros(n, dtype=np.uint8)
    has_pre = np.zeros(n, dtype=np.uint8)
    has_addr = np.zeros(n, dtype=np.uint8)
    is_write = np.zeros(n, dtype=np.uint8)
    for i, s in enumerate(steps):
        cols["instruction"][i] = s.instruction
        cols["pc"][i] = s.pc
        cols["unexpanded_pc"][i] = s.unexpanded_pc
        cols["rs1_value"][i] = s.rs1_value
        cols["rs2_value"][i] = s.rs2_value
        cols["rd_value"][i] = s.rd_value
        cols["rd_pre_value"][i] = s.rd_pre_value
        cols["memory_value"][i] = s.memory_value or 0
        if s.memory_pre_value is not None:
            cols["memory_pre_value"][i] = s.memory_pre_value
            has_pre[i] = 1
        if s.memory_addr is not None:
            cols["memory_addr"][i] = s.memory_addr
            has_addr[i] = 1
        if s.is_memory_write:
            is_write[i] = 1
        comp[i] = 1 if s.is_compressed else 0
    cols["_has_addr"] = has_addr
    cols["_is_write"] = is_write
    # The memoized arrays are shared by several consumers (witness gen,
    # stage-4 registers prover, commitment builders); freeze them so an
    # accidental in-place edit raises instead of corrupting another
    # consumer's view of the trace.
    for a in list(cols.values()) + [comp, has_pre]:
        a.setflags(write=False)
    out = (cols, comp, has_pre)
    if steps:
        _ARR_MEMO[:] = [(steps[0], n, out)]
    return out


def witness_columns(padded_steps, sound: bool = False,
                    slots: list[int] | None = None,
                    raw_out: dict | None = None):
    """The 43 witness COLUMNS as FrVec, built vectorized (numpy masks + the
    native from_u64/from_i128 ingest) — same values as `witness_matrix`
    transposed (differential-tested in tests/test_witness_columns.py), but
    O(T) numpy work instead of 43·T Python int ops and no 43xT Python-int
    matrix in memory (SURVEY §5.7 long-trace requirement).

    Traces containing virtual-sequence rows (vm/virtual.py) take the scalar
    witness_matrix path (the virtual kinds are a tiny fraction of real
    workloads; vectorizing them is deferred until a profile demands it)."""
    import numpy as np

    from ..native.frvec import FrVec

    T = len(padded_steps)
    n = next((i for i, s in enumerate(padded_steps) if s.is_noop), T)
    real = padded_steps[:n]
    if any(s.seq_pos for s in real):
        rows = witness_matrix(padded_steps, sound=sound, slots=slots)
        return [FrVec.from_ints([rows[j][i] for j in range(T)])
                for i in range(NUM_INPUTS)]
    cols_np, comp, has_pre = _steps_to_arrays(real)

    instr = cols_np["instruction"]
    pc = cols_np["pc"]
    upc = cols_np["unexpanded_pc"]
    rs1v = cols_np["rs1_value"]
    rs2v = cols_np["rs2_value"]
    rdv = cols_np["rd_value"]
    mem_val = cols_np["memory_value"]
    mem_pre = cols_np["memory_pre_value"]

    u1 = np.uint64(1)
    opcode = (instr & np.uint64(0x7F)).astype(np.uint32)
    f3 = ((instr >> np.uint64(12)) & np.uint64(7)).astype(np.uint32)
    f7 = ((instr >> np.uint64(25)) & np.uint64(0x7F)).astype(np.uint32)
    rd = ((instr >> np.uint64(7)) & np.uint64(0x1F)).astype(np.uint32)

    is_load = opcode == 0x03
    is_store = opcode == 0x23
    is_branch = opcode == 0x63

    # -- immediate (derive_immediate): signed i64 + field representation ----
    def _sx(v, bits):
        v = v.astype(np.int64)
        m = np.int64(1 << (bits - 1))
        return (v ^ m) - m

    i_imm = _sx((instr >> np.uint64(20)) & np.uint64(0xFFF), 12)
    s_imm = _sx((((instr >> np.uint64(25)) & np.uint64(0x7F)) << np.uint64(5))
                | ((instr >> np.uint64(7)) & np.uint64(0x1F)), 12)
    b_imm = _sx((((instr >> np.uint64(31)) & u1) << np.uint64(12))
                | (((instr >> np.uint64(7)) & u1) << np.uint64(11))
                | (((instr >> np.uint64(25)) & np.uint64(0x3F)) << np.uint64(5))
                | (((instr >> np.uint64(8)) & np.uint64(0xF)) << np.uint64(1)), 13)
    j_imm = _sx((((instr >> np.uint64(31)) & u1) << np.uint64(20))
                | (((instr >> np.uint64(12)) & np.uint64(0xFF)) << np.uint64(12))
                | (((instr >> np.uint64(20)) & u1) << np.uint64(11))
                | (((instr >> np.uint64(21)) & np.uint64(0x3FF)) << np.uint64(1)), 21)
    u_imm = (instr & np.uint64(0xFFFFF000)).astype(np.int64)  # unsigned by ref

    imm = np.zeros(n, dtype=np.int64)
    imm = np.where(np.isin(opcode, (0x13, 0x03, 0x67)), i_imm, imm)
    imm = np.where(opcode == 0x23, s_imm, imm)
    imm = np.where(opcode == 0x63, b_imm, imm)
    imm = np.where(opcode == 0x6F, j_imm, imm)
    imm = np.where(np.isin(opcode, (0x37, 0x17)), u_imm, imm)
    imm_lo = imm.astype(np.uint64)
    imm_hi = np.where(imm < 0, np.int64(-1), np.int64(0))

    # -- operand reads ------------------------------------------------------
    reads_rs1 = np.isin(opcode, (0x13, 0x03, 0x67, 0x1B, 0x33, 0x3B, 0x23, 0x63))
    reads_rs2 = np.isin(opcode, (0x33, 0x3B, 0x23, 0x63))
    rs1c = np.where(reads_rs1, rs1v, np.uint64(0))
    rs2c = np.where(reads_rs2, rs2v, np.uint64(0))

    # -- operand-source flags (+ sound RAF-gadget adjustments) --------------
    left_is_rs1 = np.isin(opcode, (0x33, 0x13, 0x03, 0x67, 0x23, 0x63, 0x1B, 0x3B))
    left_is_pc = np.isin(opcode, (0x17, 0x6F))
    right_is_rs2 = np.isin(opcode, (0x33, 0x63, 0x3B))
    right_is_imm = np.isin(opcode, (0x13, 0x03, 0x67, 0x23, 0x37, 0x17, 0x6F, 0x1B))
    zero_output = np.zeros(n, dtype=bool)
    if sound and n:
        from ..zkvm.raf_gadgets import needs_witness_adjust

        uniq, inv = np.unique(instr, return_inverse=True)
        adj = [needs_witness_adjust(int(u)) for u in uniq.tolist()]
        zl = np.array([a[0] for a in adj], dtype=bool)[inv]
        zr = np.array([a[1] for a in adj], dtype=bool)[inv]
        zero_output = np.array([a[2] for a in adj], dtype=bool)[inv]
        left_is_rs1 &= ~zl
        left_is_pc &= ~zl
        right_is_rs2 &= ~zr
        right_is_imm &= ~zr

    # -- left / right / product --------------------------------------------
    # left_is_rs1 and left_is_pc are disjoint opcode sets, as are the right
    # flags, so the sums below never overflow u64
    left = np.where(left_is_rs1, rs1c, np.uint64(0)) \
        + np.where(left_is_pc, upc, np.uint64(0))
    right_lo = np.where(right_is_rs2, rs2c, np.uint64(0)) \
        + np.where(right_is_imm, imm_lo, np.uint64(0))
    right_hi = np.where(right_is_imm, imm_hi, np.int64(0))

    def pad_u64(a):
        if n == T:
            return FrVec.from_u64_array(a)
        return FrVec.from_u64_array(np.concatenate(
            [a, np.zeros(T - n, dtype=np.uint64)]))

    def pad_i128(lo, hi):
        if n == T:
            return FrVec.from_i128_arrays(lo, hi)
        z64 = np.zeros(T - n, dtype=np.uint64)
        return FrVec.from_i128_arrays(np.concatenate([lo, z64]),
                                      np.concatenate([hi, np.zeros(T - n, np.int64)]))

    c_left = pad_u64(left)
    c_right = pad_i128(right_lo, right_hi)
    c_product = c_left.mul(c_right)

    # -- lookup output ------------------------------------------------------
    s1 = rs1v.view(np.int64)
    s2 = rs2v.view(np.int64)
    taken = np.zeros(n, dtype=bool)
    taken = np.where(f3 == 0, rs1v == rs2v, taken)
    taken = np.where(f3 == 1, rs1v != rs2v, taken)
    taken = np.where(f3 == 4, s1 < s2, taken)
    taken = np.where(f3 == 5, s1 >= s2, taken)
    taken = np.where(f3 == 6, rs1v < rs2v, taken)
    taken = np.where(f3 == 7, rs1v >= rs2v, taken)

    lookup_out = rdv.copy()
    lookup_out = np.where(opcode == 0x6F, pc + j_imm.astype(np.uint64), lookup_out)
    lookup_out = np.where(opcode == 0x67,
                          (rs1v + i_imm.astype(np.uint64)) & ~u1, lookup_out)
    lookup_out = np.where(is_branch, taken.astype(np.uint64), lookup_out)
    if sound:
        lookup_out = np.where(zero_output, np.uint64(0), lookup_out)

    # -- per-opcode flag groups --------------------------------------------
    is_op = opcode == 0x33
    m_ext = is_op & (f7 == 1)
    mul_mask = m_ext & (f3 == 0)
    mulother = m_ext & (f3 != 0)
    sub_mask = is_op & ~m_ext & (f7 == 0x20) & (f3 == 0)
    op_add = is_op & ~m_ext & ~sub_mask

    flag_add = op_add | np.isin(opcode, (0x13, 0x6F, 0x67, 0x37, 0x17))
    flag_sub = sub_mask
    flag_mul = mul_mask
    flag_jump = np.isin(opcode, (0x6F, 0x67))
    flag_wl = is_op | np.isin(opcode, (0x13, 0x37, 0x17))
    mem_or_branch = is_load | is_store | is_branch

    # LeftLookupOperand: `left` for loads/stores/branches and non-MUL M ops
    # and the default group (0x1B/0x3B/system/...); 0 for the add/sub/mul
    # fused groups
    llo_left = mem_or_branch | mulother | ~(
        mem_or_branch | is_op | np.isin(opcode, (0x13, 0x6F, 0x67, 0x37, 0x17)))
    c_llo = pad_u64(np.where(llo_left, left, np.uint64(0)))

    # RightLookupOperand by group (i128 lanes; MUL's Product spliced after)
    rlo_lo = np.where(right_is_rs2 | right_is_imm, right_lo, np.uint64(0))
    rlo_hi = np.where(right_is_imm, right_hi, np.int64(0))
    # default/mem/branch/mulother: plain `right`
    # add family: left + right
    add_lo = left + right_lo
    add_carry = (add_lo < left).astype(np.int64)
    af = flag_add
    rlo_lo = np.where(af, add_lo, rlo_lo)
    rlo_hi = np.where(af, add_carry + right_hi, rlo_hi)
    # sub: left − right + 2^64 (right = rs2)
    sub_lo = left - rs2c
    sub_hi = (left >= rs2c).astype(np.int64)
    rlo_lo = np.where(sub_mask, sub_lo, rlo_lo)
    rlo_hi = np.where(sub_mask, sub_hi, rlo_hi)
    # mul: 0 here, Product spliced below
    rlo_lo = np.where(mul_mask, np.uint64(0), rlo_lo)
    rlo_hi = np.where(mul_mask, np.int64(0), rlo_hi)
    c_rlo = pad_i128(rlo_lo, rlo_hi)
    if bool(mul_mask.any()):
        mvec = pad_u64(mul_mask.astype(np.uint64))
        c_rlo = c_rlo.add(c_product.copy().sub(c_rlo).mul(mvec))

    # -- remaining u64 columns ---------------------------------------------
    writes_to_rd = (~is_store) & (~is_branch) & (rd != 0)
    rd_write = np.where(is_load, mem_val,
                        np.where(is_store, np.uint64(0),
                                 np.where(writes_to_rd, rdv, np.uint64(0))))
    ram_read = np.where(is_load, mem_val, np.uint64(0))
    if sound:
        store_pre = np.where(has_pre.astype(bool), mem_pre, mem_val)
        ram_read = np.where(is_store, store_pre, ram_read)
    else:
        ram_read = np.where(is_store, mem_val, ram_read)
    ram_write = np.where(is_load, mem_val,
                         np.where(is_store, rs2v, np.uint64(0)))

    # RamAddress = rs1 + imm (mod p) for loads/stores
    mem_mask = is_load | is_store
    addr_lo = rs1v + imm_lo
    addr_carry = ((addr_lo < rs1v) & (imm_lo != 0)).astype(np.int64)
    addr_hi = addr_carry + imm_hi
    c_ram_addr = pad_i128(np.where(mem_mask, addr_lo, np.uint64(0)),
                          np.where(mem_mask, addr_hi, np.int64(0)))

    next_pc = np.zeros(n, dtype=np.uint64)
    next_upc = np.zeros(n, dtype=np.uint64)
    if n > 1:
        next_pc[:-1] = pc[1:]
        next_upc[:-1] = upc[1:]
    next_is_noop = np.zeros(n, dtype=np.uint64)
    if n:
        next_is_noop[-1] = 1  # the cycle after the last real step is a noop

    is_rd_nz = (rd != 0).astype(np.uint64)
    fj = flag_jump.astype(np.uint64)
    should_jump = fj * (1 - next_is_noop)
    wl = flag_wl.astype(np.uint64)

    out: list = [None] * NUM_INPUTS
    out[Inp.LeftInstructionInput] = c_left
    out[Inp.RightInstructionInput] = c_right
    out[Inp.Product] = c_product
    out[Inp.WriteLookupOutputToRD] = pad_u64(is_rd_nz * wl)
    out[Inp.WritePCtoRD] = pad_u64(is_rd_nz * fj)
    out[Inp.ShouldBranch] = pad_u64(lookup_out * is_branch.astype(np.uint64))
    out[Inp.PC] = pad_u64(pc)
    out[Inp.UnexpandedPC] = pad_u64(upc)
    out[Inp.Imm] = pad_i128(imm_lo, imm_hi)
    out[Inp.RamAddress] = c_ram_addr
    out[Inp.Rs1Value] = pad_u64(rs1c)
    out[Inp.Rs2Value] = pad_u64(rs2c)
    out[Inp.RdWriteValue] = pad_u64(rd_write)
    out[Inp.RamReadValue] = pad_u64(ram_read)
    out[Inp.RamWriteValue] = pad_u64(ram_write)
    out[Inp.LeftLookupOperand] = c_llo
    out[Inp.RightLookupOperand] = c_rlo
    out[Inp.NextUnexpandedPC] = pad_u64(next_upc)
    out[Inp.NextPC] = pad_u64(next_pc)
    out[Inp.NextIsVirtual] = FrVec.zeros(T)
    out[Inp.NextIsFirstInSequence] = FrVec.zeros(T)
    out[Inp.LookupOutput] = pad_u64(lookup_out)
    out[Inp.ShouldJump] = pad_u64(should_jump)
    out[Inp.FlagAddOperands] = pad_u64(flag_add.astype(np.uint64))
    out[Inp.FlagSubtractOperands] = pad_u64(flag_sub.astype(np.uint64))
    out[Inp.FlagMultiplyOperands] = pad_u64(flag_mul.astype(np.uint64))
    out[Inp.FlagLoad] = pad_u64(is_load.astype(np.uint64))
    out[Inp.FlagStore] = pad_u64(is_store.astype(np.uint64))
    out[Inp.FlagJump] = pad_u64(fj)
    out[Inp.FlagWriteLookupOutputToRD] = pad_u64(wl)
    out[Inp.FlagVirtualInstruction] = FrVec.zeros(T)
    out[Inp.FlagAssert] = FrVec.zeros(T)
    out[Inp.FlagAdvice] = FrVec.zeros(T)
    out[Inp.FlagIsCompressed] = pad_u64(comp.astype(np.uint64))
    out[Inp.FlagIsFirstInSequence] = FrVec.zeros(T)
    out[Inp.FlagIsRdNotZero] = pad_u64(is_rd_nz)
    out[Inp.FlagBranch] = pad_u64(is_branch.astype(np.uint64))
    out[Inp.FlagLeftOperandIsRs1] = pad_u64(left_is_rs1.astype(np.uint64))
    out[Inp.FlagLeftOperandIsPC] = pad_u64(left_is_pc.astype(np.uint64))
    out[Inp.FlagRightOperandIsRs2] = pad_u64(right_is_rs2.astype(np.uint64))
    out[Inp.FlagRightOperandIsImm] = pad_u64(right_is_imm.astype(np.uint64))

    # noop tail: DoNotUpdateUnexpandedPC = IsNoop = 1 on [n, T)
    tail = np.concatenate([np.zeros(n, dtype=np.uint64),
                           np.ones(T - n, dtype=np.uint64)])
    out[Inp.FlagDoNotUpdateUnexpandedPC] = FrVec.from_u64_array(tail)
    out[Inp.FlagIsNoop] = FrVec.from_u64_array(tail.copy())

    if slots is not None:
        # slot-PC indexing (expanded bytecode, no virtual rows executed):
        # replace the address-based PC/NextPC columns with slot indices
        sl = np.asarray(slots[:n], dtype=np.uint64)
        out[Inp.PC] = pad_u64(sl)
        nxt = np.zeros(n, dtype=np.uint64)
        if n > 1:
            nxt[:-1] = sl[1:]
        if n < T:
            nxt[-1] = 0          # successor is the noop tail
        elif n == T and n > 0:
            nxt[-1] = 0
        out[Inp.NextPC] = pad_u64(nxt)

    if raw_out is not None:
        # Raw (pre-Montgomery) column forms for the device column store
        # (parallel/device_cols): u64 value lanes, i128 (lo, hi ∈ {0,−1})
        # lanes, single-bit flags, and two device-derived specs (the field
        # product and the MUL splice). Differentially tested against the
        # FrVec columns in tests/test_device_cols.py.
        z64 = np.zeros(T - n, dtype=np.uint64)
        zi64 = np.zeros(T - n, dtype=np.int64)

        def ru(a):
            return ("u64", a if n == T else np.concatenate([a, z64]))

        def ri(lo, hi):
            if n != T:
                lo = np.concatenate([lo, z64])
                hi = np.concatenate([hi, zi64])
            return ("i128", lo, hi)

        def rf(bits):
            b = np.asarray(bits, dtype=np.uint8)
            return ("flag", b if n == T
                    else np.concatenate([b, np.zeros(T - n, np.uint8)]))

        r = raw_out
        r[Inp.LeftInstructionInput] = ru(left)
        r[Inp.RightInstructionInput] = ri(right_lo, right_hi)
        r[Inp.Product] = ("prod", Inp.LeftInstructionInput,
                          Inp.RightInstructionInput)
        r[Inp.WriteLookupOutputToRD] = rf(is_rd_nz * wl)
        r[Inp.WritePCtoRD] = rf(is_rd_nz * fj)
        r[Inp.ShouldBranch] = rf(lookup_out * is_branch.astype(np.uint64))
        r[Inp.PC] = ru(pc)
        r[Inp.UnexpandedPC] = ru(upc)
        r[Inp.Imm] = ri(imm_lo, imm_hi)
        r[Inp.RamAddress] = ri(np.where(mem_mask, addr_lo, np.uint64(0)),
                               np.where(mem_mask, addr_hi, np.int64(0)))
        r[Inp.Rs1Value] = ru(rs1c)
        r[Inp.Rs2Value] = ru(rs2c)
        r[Inp.RdWriteValue] = ru(rd_write)
        r[Inp.RamReadValue] = ru(ram_read)
        r[Inp.RamWriteValue] = ru(ram_write)
        r[Inp.LeftLookupOperand] = ru(np.where(llo_left, left, np.uint64(0)))
        r[Inp.RightLookupOperand] = (
            ("splice", ri(rlo_lo, rlo_hi), Inp.Product, rf(mul_mask))
            if bool(mul_mask.any()) else ri(rlo_lo, rlo_hi))
        r[Inp.NextUnexpandedPC] = ru(next_upc)
        r[Inp.NextPC] = ru(next_pc)
        r[Inp.NextIsVirtual] = ("zeros",)
        r[Inp.NextIsFirstInSequence] = ("zeros",)
        r[Inp.LookupOutput] = ru(lookup_out)
        r[Inp.ShouldJump] = rf(should_jump)
        r[Inp.FlagAddOperands] = rf(flag_add)
        r[Inp.FlagSubtractOperands] = rf(flag_sub)
        r[Inp.FlagMultiplyOperands] = rf(flag_mul)
        r[Inp.FlagLoad] = rf(is_load)
        r[Inp.FlagStore] = rf(is_store)
        r[Inp.FlagJump] = rf(fj)
        r[Inp.FlagWriteLookupOutputToRD] = rf(wl)
        r[Inp.FlagVirtualInstruction] = ("zeros",)
        r[Inp.FlagAssert] = ("zeros",)
        r[Inp.FlagAdvice] = ("zeros",)
        r[Inp.FlagIsCompressed] = rf(comp)
        r[Inp.FlagIsFirstInSequence] = ("zeros",)
        r[Inp.FlagIsRdNotZero] = rf(is_rd_nz)
        r[Inp.FlagBranch] = rf(is_branch)
        r[Inp.FlagLeftOperandIsRs1] = rf(left_is_rs1)
        r[Inp.FlagLeftOperandIsPC] = rf(left_is_pc)
        r[Inp.FlagRightOperandIsRs2] = rf(right_is_rs2)
        r[Inp.FlagRightOperandIsImm] = rf(right_is_imm)
        tail_f = np.concatenate([np.zeros(n, np.uint8),
                                 np.ones(T - n, np.uint8)])
        r[Inp.FlagDoNotUpdateUnexpandedPC] = ("flag", tail_f)
        r[Inp.FlagIsNoop] = ("flag", tail_f.copy())
        if slots is not None:
            r[Inp.PC] = ru(sl)
            r[Inp.NextPC] = ru(nxt)
    return out
