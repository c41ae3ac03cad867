"""Instruction lookup classes + LookupTraceCollector for Lasso.

The reference implements 58 per-instruction lookup types, each bundling a
lookup table, a 128-bit index derivation, and a computed result
(src/zkvm/instruction/lookups.zig:27-4025), collected during emulation by
LookupTraceCollector (src/zkvm/instruction/lookup_trace.zig:31-471). The
TPU build replaces the comptime class-per-instruction pattern with one
declarative classifier: `classify_step` maps a trace step to its
(name, table, index, output) — data the Lasso argument and the committed
InstructionRa chunk polynomials both consume.

Invariant (the property Lasso proves): for every recorded entry,
`output == tables.materialize_entry(table, index)`; equivalently the
table's closed-form MLE at the index's bit-point equals the output —
tested in tests/test_lookup_trace.py.

Index derivation lives in zkvm/commitments.jolt_lookup_index (it is also
what builds the committed InstructionRa polys, byte-exact vs the reference
golden proof); this module adds the table assignment and result semantics.
"""

from __future__ import annotations

from dataclasses import dataclass

from .decode import DecodedInstruction
from .tables import Table, instruction_table, materialize_entry

M64 = (1 << 64) - 1

# Reference lookup-class names by (opcode, funct3, funct7-discriminator) —
# parity with instruction/lookups.zig's 58 types. Naming follows the
# reference exactly: non-shift OP-IMM shares the register class (the
# reference collector maps ADDI -> AddLookup etc., lookup_trace.zig:905-938)
# while the shifts and the W immediates get their own classes
# (Slli/Srli/Srai, Addiw/Slliw/Srliw/Sraiw).
_OP_NAMES = {0: ("AddLookup", "SubLookup"), 1: ("SllLookup", None),
             2: ("SltLookup", None), 3: ("SltuLookup", None),
             4: ("XorLookup", None), 5: ("SrlLookup", "SraLookup"),
             6: ("OrLookup", None), 7: ("AndLookup", None)}
_OPIMM_NAMES = {0: "AddLookup", 1: "SlliLookup", 2: "SltLookup",
                3: "SltuLookup", 4: "XorLookup",
                5: ("SrliLookup", "SraiLookup"), 6: "OrLookup",
                7: "AndLookup"}
_M_NAMES = {0: "MulLookup", 1: "MulhLookup", 2: "MulhsuLookup",
            3: "MulhuLookup", 4: "DivLookup", 5: "DivuLookup",
            6: "RemLookup", 7: "RemuLookup"}
_BRANCH_NAMES = {0: "BeqLookup", 1: "BneLookup", 4: "BltLookup",
                 5: "BgeLookup", 6: "BltuLookup", 7: "BgeuLookup"}
_OP32_NAMES = {0: ("AddwLookup", "SubwLookup"), 1: ("SllwLookup", None),
               5: ("SrlwLookup", "SrawLookup")}
_OPIMM32_NAMES = {0: "AddiwLookup", 1: "SlliwLookup",
                  5: ("SrliwLookup", "SraiwLookup")}
_M32_NAMES = {0: "MulwLookup", 4: "DivwLookup", 5: "DivuwLookup",
              6: "RemwLookup", 7: "RemuwLookup"}
_LOAD_NAMES = {0: "LbLookup", 1: "LhLookup", 2: "LwLookup", 3: "LdLookup",
               4: "LbuLookup", 5: "LhuLookup", 6: "LwuLookup"}
_STORE_NAMES = {0: "SbLookup", 1: "ShLookup", 2: "SwLookup", 3: "SdLookup"}

#: the complete reference class catalogue (instruction/lookups.zig's 58
#: `pub fn *Lookup` types), enumerated for the parity test
ALL_LOOKUP_CLASSES = (
    "AddLookup", "SubLookup", "AndLookup", "OrLookup", "XorLookup",
    "SltLookup", "SltuLookup", "BeqLookup", "BneLookup", "BltLookup",
    "BgeLookup", "BltuLookup", "BgeuLookup", "LuiLookup", "AuipcLookup",
    "JalLookup", "JalrLookup", "SllLookup", "SrlLookup", "SraLookup",
    "SlliLookup", "SrliLookup", "SraiLookup", "MulLookup", "MulhLookup",
    "MulhuLookup", "MulhsuLookup", "DivLookup", "DivuLookup", "RemLookup",
    "RemuLookup", "AddwLookup", "SubwLookup", "SllwLookup", "SrlwLookup",
    "SrawLookup", "AddiwLookup", "SlliwLookup", "SrliwLookup", "SraiwLookup",
    "MulwLookup", "DivwLookup", "DivuwLookup", "RemwLookup", "RemuwLookup",
    "LoadAddressLookup", "StoreAddressLookup", "LbLookup", "LbuLookup",
    "LhLookup", "LhuLookup", "LwLookup", "LwuLookup", "LdLookup",
    "SbLookup", "ShLookup", "SwLookup", "SdLookup",
)


@dataclass
class LookupEntry:
    """One recorded instruction lookup (reference LookupEntry,
    lookup_trace.zig:31).

    `table_value` = table[index] is what the Lasso read-check proves;
    `output` is the class's computeResult (the rd/branch semantics). They
    coincide for the direct classes; for div/rem the table proves VALIDITY
    (table_value == 1) while the result is carried in the index halves, and
    for the W classes the result is the sign-extended low word."""

    cycle: int
    pc: int
    instruction: int
    name: str
    table: Table
    index: int        # 128-bit (pair tables) or 64-bit (range-check class)
    table_value: int  # materialize_entry(table, index)
    output: int       # the class computeResult


def lookup_name(instr: int) -> str | None:
    """Reference lookup-class name for an instruction, or None if the
    collector records no entry for this opcode class."""
    opcode = instr & 0x7F
    f3 = (instr >> 12) & 0x7
    f7 = (instr >> 25) & 0x7F
    if opcode == 0x33:
        if f7 == 1:
            return _M_NAMES[f3]
        base, alt = _OP_NAMES[f3]
        return alt if (f7 & 0x20) and alt else base
    if opcode == 0x13:
        ent = _OPIMM_NAMES[f3]
        if isinstance(ent, tuple):
            return ent[1] if (f7 & 0x20) else ent[0]
        return ent
    if opcode == 0x63:
        return _BRANCH_NAMES.get(f3)
    if opcode == 0x3B:
        if f7 == 1:
            return _M32_NAMES.get(f3)
        pair = _OP32_NAMES.get(f3)
        if pair is None:
            return None
        base, alt = pair
        return alt if (f7 & 0x20) and alt else base
    if opcode == 0x1B:
        ent = _OPIMM32_NAMES.get(f3)
        if ent is None:
            return None
        if isinstance(ent, tuple):
            return ent[1] if (f7 & 0x20) else ent[0]
        return ent
    if opcode == 0x03:
        return _LOAD_NAMES.get(f3)
    if opcode == 0x23:
        return _STORE_NAMES.get(f3)
    return {0x37: "LuiLookup", 0x17: "AuipcLookup",
            0x6F: "JalLookup", 0x67: "JalrLookup"}.get(opcode)


def _sext32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v | (~0xFFFFFFFF & M64) if v >> 31 else v


def _uninterleave(index: int) -> tuple[int, int]:
    from .tables import uninterleave_bits

    return uninterleave_bits(index, 64)


def _compute_result(name: str, table: Table, index: int,
                    table_value: int) -> int:
    """Class computeResult (reference per-class computeResult,
    instruction/lookups.zig): rd/branch semantics from the lookup."""
    if name in ("DivLookup", "DivuLookup"):
        return _uninterleave(index)[1]           # quotient in the y half
    if name in ("RemLookup", "RemuLookup"):
        return _uninterleave(index)[0]           # remainder in the x half
    if name in ("DivwLookup", "DivuwLookup"):
        return _sext32(_uninterleave(index)[1])
    if name in ("RemwLookup", "RemuwLookup"):
        return _sext32(_uninterleave(index)[0])
    if name == "SrawLookup":
        x, y = _uninterleave(index)
        sh = y & 0x3F
        sx = x - (1 << 32) if (x >> 31) & 1 else x
        return _sext32((sx >> sh) & 0xFFFFFFFF)
    if name in ("SubwLookup", "SllwLookup", "SrlwLookup"):
        return _sext32(table_value & 0xFFFFFFFF)
    return table_value


def classify_step(step) -> LookupEntry | None:
    """Build the lookup entry for a trace step (index catalog:
    zkvm/commitments.jolt_lookup_index; table assignment:
    vm/tables.instruction_table)."""
    from ..zkvm.commitments import jolt_lookup_index

    if getattr(step, "is_noop", False):
        return None
    index = jolt_lookup_index(step)
    if index is None:
        return None
    instr = step.instruction
    table = instruction_table(instr)
    if table is None:
        table = Table.RangeCheck
    name = lookup_name(instr) or "RangeCheckLookup"
    tv = materialize_entry(table, index, 64)
    return LookupEntry(
        cycle=step.cycle, pc=step.pc, instruction=instr, name=name,
        table=table, index=index, table_value=tv,
        output=_compute_result(name, table, index, tv))


_LOAD_BITS = {0: (8, True), 1: (16, True), 2: (32, True), 3: (64, False),
              4: (8, False), 5: (16, False), 6: (32, False)}
_STORE_BITS = {0: 8, 1: 16, 2: 32, 3: 64}
_SEXT_TABLE = {8: Table.SignExtend8, 16: Table.SignExtend16,
               32: Table.SignExtend32}


def classify_memory_step(step) -> list[LookupEntry]:
    """Lookup entries for a load/store step — the 13 memory classes the
    reference defines but never wires into its collector
    (instruction/lookups.zig:3056-3836, lookup_trace.zig:1016 "handled
    separately"): a LoadAddress/StoreAddress range-check on the effective
    address plus the value class (SignExtend8/16/32 for LB/LH/LW, range
    checks for the unsigned/full-width variants). Goes beyond the reference
    by actually exercising these classes in the internal Lasso path."""
    instr = step.instruction
    opcode = instr & 0x7F
    f3 = (instr >> 12) & 0x7
    if getattr(step, "is_noop", False) or step.memory_addr is None:
        return []
    out: list[LookupEntry] = []
    addr = step.memory_addr & M64

    def entry(name, table, index):
        tv = materialize_entry(table, index, 64)
        return LookupEntry(cycle=step.cycle, pc=step.pc, instruction=instr,
                           name=name, table=table, index=index,
                           table_value=tv,
                           output=_compute_result(name, table, index, tv))

    if opcode == 0x03 and f3 in _LOAD_BITS:
        out.append(entry("LoadAddressLookup", Table.RangeCheck, addr))
        bits, signed = _LOAD_BITS[f3]
        raw = (step.memory_value or 0) & ((1 << bits) - 1)
        name = _LOAD_NAMES[f3]
        table = _SEXT_TABLE[bits] if signed and bits < 64 else Table.RangeCheck
        out.append(entry(name, table, raw))
    elif opcode == 0x23 and f3 in _STORE_BITS:
        out.append(entry("StoreAddressLookup", Table.RangeCheck, addr))
        bits = _STORE_BITS[f3]
        raw = (step.rs2_value & M64) & ((1 << bits) - 1)
        out.append(entry(_STORE_NAMES[f3], Table.RangeCheck, raw))
    return out


class LookupTraceCollector:
    """Gathers lookup entries over a trace (reference
    lookup_trace.zig LookupTraceCollector; getStats/getEntries parity).

    `memory=True` additionally records the 13 load/store classes
    (classify_memory_step) — a superset of the reference, whose collector
    leaves memory operations unrecorded."""

    def __init__(self) -> None:
        self.entries: list[LookupEntry] = []

    def collect(self, steps, memory: bool = False) -> "LookupTraceCollector":
        for s in steps:
            e = classify_step(s)
            if e is not None:
                self.entries.append(e)
            if memory:
                self.entries.extend(classify_memory_step(s))
        return self

    def get_entries(self) -> list[LookupEntry]:
        return self.entries

    def get_stats(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self.entries:
            out[e.name] = out.get(e.name, 0) + 1
        return out

    def by_table(self) -> dict[Table, list[LookupEntry]]:
        out: dict[Table, list[LookupEntry]] = {}
        for e in self.entries:
            out.setdefault(e.table, []).append(e)
        return out


# -- emulator hook (kept lightweight: full classification happens post-run
# on the finished trace, where operand values are final) -------------------

@dataclass
class RawLookupRecord:
    cycle: int
    pc: int
    instruction: int
    decoded: DecodedInstruction
    rs1_value: int
    rs2_value: int


def record_lookup_entry(cycle: int, pc: int, d: DecodedInstruction,
                        rs1: int, rs2: int) -> RawLookupRecord:
    return RawLookupRecord(cycle, pc, d.raw, d, rs1, rs2)
