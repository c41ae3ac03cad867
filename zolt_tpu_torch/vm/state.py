"""Emulator state containers: RAM (sparse word map + access trace) and the
register file (x0-x31 + timestamped trace).

Semantics match the reference exactly (src/zkvm/ram/mod.zig:110-215,
src/zkvm/registers/mod.zig:31-135): RAM is word-addressed (8-byte aligned),
byte ops read-modify-write the containing word, loads/stores record to the
trace while instruction fetches and program loading do not.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

M64 = (1 << 64) - 1


class MemoryAccess(NamedTuple):
    """One RAM access record (NamedTuple for cheap bulk materialization in
    the native emulator bridge)."""

    op: str  # "read" | "write"
    address: int
    pre_value: int
    post_value: int
    timestamp: int


@dataclass
class RAMState:
    memory: dict[int, int] = field(default_factory=dict)
    trace: list[MemoryAccess] = field(default_factory=list)

    def read(self, address: int, ts: int) -> int:
        v = self.memory.get(address, 0)
        self.trace.append(MemoryAccess("read", address, v, v, ts))
        return v

    def write(self, address: int, value: int, ts: int) -> None:
        pre = self.memory.get(address, 0)
        self.memory[address] = value & M64
        self.trace.append(MemoryAccess("write", address, pre, value & M64, ts))

    def read_byte(self, address: int, ts: int) -> int:
        word_addr = address & ~7
        off = address & 7
        return (self.read(word_addr, ts) >> (off * 8)) & 0xFF

    def write_byte(self, address: int, value: int, ts: int) -> None:
        word_addr = address & ~7
        off = address & 7
        pre = self.memory.get(word_addr, 0)
        mask = 0xFF << (off * 8)
        post = (pre & ~mask) | ((value & 0xFF) << (off * 8))
        self.memory[word_addr] = post
        self.trace.append(MemoryAccess("write", word_addr, pre, post, ts))

    # untraced variants (program loading, instruction fetch)
    def write_byte_untraced(self, address: int, value: int) -> None:
        word_addr = address & ~7
        off = address & 7
        w = self.memory.get(word_addr, 0)
        mask = 0xFF << (off * 8)
        self.memory[word_addr] = (w & ~mask) | ((value & 0xFF) << (off * 8))

    def read_byte_untraced(self, address: int) -> int:
        word_addr = address & ~7
        return (self.memory.get(word_addr, 0) >> ((address & 7) * 8)) & 0xFF

    def record_write(self, address: int, pre: int, post: int, ts: int) -> None:
        self.trace.append(MemoryAccess("write", address, pre, post, ts))


@dataclass
class RegisterAccess:
    register: int
    value: int
    op: str  # "read" | "write"
    timestamp: int


@dataclass
class RegisterFile:
    # 32 architectural + 96 virtual registers (reference
    # common/constants.zig:7-19; the virtual half is scratch for the
    # virtual instruction sequences, vm/virtual.py)
    registers: list[int] = field(default_factory=lambda: [0] * 128)
    trace: list[RegisterAccess] = field(default_factory=list)
    timestamp: int = 0

    # Per-access RegisterAccess recording was dropped from the hot path: the
    # proof pipeline derives register reads/writes from the TraceSteps
    # themselves (stage-4/5 builders decode rd/rs1/rs2 per cycle) and nothing
    # consumes this trace; `trace` stays for API compatibility (empty).

    def read(self, reg: int) -> int:
        return 0 if reg == 0 else self.registers[reg]

    def write(self, reg: int, value: int) -> None:
        if reg == 0:
            return
        self.registers[reg] = value & M64

    def tick(self) -> None:
        self.timestamp += 1
