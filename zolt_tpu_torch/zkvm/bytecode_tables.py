"""Bytecode slot index + static witness-column tables for the sound-mode
BytecodeReadRaf stage.

The bytecode is PUBLIC (both sides hold the program), so every R1CS witness
column that is a pure function of the fetched instruction — PC,
UnexpandedPC, Imm, all static flags, the rd/flag products — is a *table
over bytecode slots*, and the claimed stage-1 input evaluations of those
columns are provable by one read-check through the committed one-hot
BytecodeRa chunk polynomials (reference structure:
src/zkvm/jolt_types.zig SumcheckId BytecodeReadRaf,
src/zkvm/preprocessing.zig:251-340 for the NoOp-sentinel slot layout).

Slot layout: slot 0 is the NoOp sentinel (padded cycles read it; its column
values are exactly `noop_witness()`), slots 1.. are the linear decode of the
program text (RVC expanded), padded with NoOp entries to a power of two —
the same walk as preprocessing.preprocess_bytecode.

The static column values are extracted by running the REAL witness builder
(r1cs.inputs.cycle_witness) on a synthetic zero-runtime step, so this table
can never drift from the prover's witness semantics.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..field.params import FR
from ..r1cs.inputs import Inp, cycle_witness, noop_witness
from ..vm.decode import expand_compressed, is_compressed
from ..vm.emulator import TraceStep

P = FR.p

# Witness columns that are pure functions of the bytecode entry. Order is
# load-bearing: the gamma-RLC in the BytecodeReadRaf stage batches claims in
# this order on both sides.
STATIC_COLS: tuple[Inp, ...] = (
    Inp.PC, Inp.UnexpandedPC, Inp.Imm,
    Inp.WriteLookupOutputToRD, Inp.WritePCtoRD,
    Inp.FlagAddOperands, Inp.FlagSubtractOperands, Inp.FlagMultiplyOperands,
    Inp.FlagLoad, Inp.FlagStore, Inp.FlagJump,
    Inp.FlagWriteLookupOutputToRD, Inp.FlagVirtualInstruction,
    Inp.FlagAssert, Inp.FlagDoNotUpdateUnexpandedPC, Inp.FlagAdvice,
    Inp.FlagIsCompressed, Inp.FlagIsFirstInSequence, Inp.FlagIsRdNotZero,
    Inp.FlagBranch, Inp.FlagIsNoop,
    Inp.FlagLeftOperandIsRs1, Inp.FlagLeftOperandIsPC,
    Inp.FlagRightOperandIsRs2, Inp.FlagRightOperandIsImm,
)


@dataclass
class BytecodeEntry:
    pc: int
    instruction: int        # expanded (4-byte) encoding; 0 = NoOp sentinel
    is_compressed: bool


def _fake_step(e: BytecodeEntry) -> TraceStep:
    return TraceStep(0, e.pc, e.pc, e.instruction, 0, 0, 0, 0,
                     None, None, None, False, 0, e.is_compressed)


class BytecodeIndex:
    """Slot-indexed view of the program text (slot 0 = NoOp sentinel)."""

    def __init__(self, entries: list[BytecodeEntry]):
        self.entries = entries
        size = max(2, len(entries))
        size = 1 << (size - 1).bit_length()
        while len(self.entries) < size:
            self.entries.append(BytecodeEntry(0, 0, False))
        self.size = size
        self.log_k = size.bit_length() - 1
        # first slot at each address (virtual-sequence entries share their
        # parent's address; slot_of_step adds the step's seq_pos)
        self.pc_to_slot: dict[int, int] = {}
        self.expanded = False
        for i, e in enumerate(self.entries):
            if e.instruction != 0:
                self.pc_to_slot.setdefault(e.pc, i)
                if (e.instruction & 0x7F) == 0x0B:
                    self.expanded = True
        self._cols: dict[Inp, list[int]] | None = None

    @classmethod
    def from_code(cls, code: bytes, base_address: int) -> "BytecodeIndex":
        from ..vm import virtual as vi

        entries = [BytecodeEntry(0, 0, False)]          # NoOp sentinel
        off = 0
        while off < len(code):
            addr = base_address + off
            hw = int.from_bytes(code[off:off + 2], "little")
            if is_compressed(hw):
                entries.append(BytecodeEntry(addr, expand_compressed(hw), True))
                off += 2
            else:
                if off + 4 > len(code):
                    break
                word = int.from_bytes(code[off:off + 4], "little")
                if vi.is_div_family(word):
                    # div-family expands to its virtual sequence: the
                    # expanded rows ARE the bytecode (the tracer derives the
                    # identical sequence, vm/virtual.py)
                    for vw in vi.expand(word):
                        entries.append(BytecodeEntry(addr, vw, False))
                else:
                    entries.append(BytecodeEntry(addr, word, False))
                off += 4
        return cls(entries)

    @classmethod
    def from_elf(cls, path_or_bytes) -> "BytecodeIndex":
        from ..vm import elf as elfmod

        if isinstance(path_or_bytes, (bytes, bytearray)):
            parsed = elfmod.parse(bytes(path_or_bytes))
        else:
            parsed = elfmod.load_file(path_or_bytes)
        base, image = parsed.flat_image()
        return cls.from_code(bytes(image), base)

    # -- per-cycle mapping ---------------------------------------------------

    def slot_of_step(self, step) -> int:
        if getattr(step, "is_noop", False):
            return 0
        slot = self.pc_to_slot.get(step.pc)
        if slot is None:
            raise ValueError(f"pc 0x{step.pc:x} not in the bytecode index")
        return slot + getattr(step, "seq_pos", 0)

    def slots_per_cycle(self, padded_steps) -> list[int]:
        return [self.slot_of_step(s) for s in padded_steps]

    # -- public tables --------------------------------------------------------

    def static_cols(self) -> dict[Inp, list[int]]:
        """col -> per-slot value table (length self.size)."""
        if self._cols is not None:
            return self._cols
        cols = {c: [0] * self.size for c in STATIC_COLS}
        noop = noop_witness()
        for i, e in enumerate(self.entries):
            w = noop if e.instruction == 0 else \
                cycle_witness(_fake_step(e), None, sound=True)
            for c in STATIC_COLS:
                cols[c][i] = w[c] % P
            if self.expanded and e.instruction != 0:
                # slot-PC indexing: with virtual sequences in the bytecode
                # the PC witness column is the slot index (constraint #17
                # chains PC by +1 through sequences), so the static PC
                # table is the identity over slots
                cols[Inp.PC][i] = i
        self._cols = cols
        return cols

    def gamma_rlc_table(self, gamma: int, cols_subset=None) -> list[int]:
        """sum_i gamma^i * col_i[slot] over STATIC_COLS (or `cols_subset`,
        in its order) — the public table the batched claimed-input
        read-check consumes."""
        cols = self.static_cols()
        out = [0] * self.size
        g = 1
        for c in (cols_subset if cols_subset is not None else STATIC_COLS):
            col = cols[c]
            for k in range(self.size):
                if col[k]:
                    out[k] = (out[k] + g * col[k]) % P
            g = g * gamma % P
        return out

    def raf_spec(self, slot: int):
        from .raf_gadgets import entry_spec

        e = self.entries[slot]
        return None if e.instruction == 0 else entry_spec(e.instruction)

    def has_lookup_table(self) -> list[int]:
        return [0 if self.raf_spec(k) is None else 1 for k in range(self.size)]

    def has_validity_table(self) -> list[int]:
        out = []
        for k in range(self.size):
            s = self.raf_spec(k)
            out.append(1 if (s is not None and s.valid_table is not None) else 0)
        return out


def mle_eval_table(table: list[int], point_le: list[int]) -> int:
    """Dense MLE eval of a public slot table at a little-endian point."""
    vals = [v % P for v in table]
    for r in point_le:
        half = len(vals) // 2
        vals = [(vals[2 * i] + r * (vals[2 * i + 1] - vals[2 * i])) % P
                for i in range(half)]
    return vals[0]
