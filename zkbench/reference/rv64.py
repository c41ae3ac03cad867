"""A plain RV64IM interpreter: the reference's own run of a guest ELF.

It shares no code with the program. It runs the subset of RV64IM that the
benchmark's guests are made of (loads and stores of aligned doublewords, the
integer ALU, multiplication, branches and jumps) and stops as Jolt's tracer
does: at the first jump to itself, which is recorded as the last cycle.

Each cycle keeps what the proof's execution columns are made of: the address
of the instruction, the value written to a non-zero rd, and the RAM access
(address, the doubleword before and after).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

RAM_START = 0x80000000
MASK = (1 << 64) - 1
IO_SIZES = (4096, 4096, 4096, 4096)  # trusted and untrusted advice, input, output


def _pow2_at_least(v: int) -> int:
    n = 1
    while n < v:
        n *= 2
    return n


def io_layout() -> dict:
    """Jolt's I/O region below RAM_START (common/src/jolt_device.rs): both
    advice buffers, the input and the output, padded to a power of two of
    doublewords, then the panic and termination words."""
    mta, mua, mi, mo = IO_SIZES
    lowest = RAM_START - _pow2_at_least((mta + mua + mi + mo + 16) // 8) * 8
    inp = lowest + mta + mua
    out = inp + mi
    return {"lowest": lowest, "input": inp, "output": out,
            "output_end": out + mo, "panic": out + mo,
            "termination": out + mo + 8}


@dataclass
class Cycle:
    pc: int
    rd_write: int = 0          # the value written to rd, 0 where rd is x0
    ram_addr: int = 0          # 0 where the instruction touches no RAM
    ram_read: int = 0
    ram_write: int = 0


@dataclass
class Run:
    cycles: list[Cycle] = field(default_factory=list)
    initial: dict = field(default_factory=dict)   # doubleword address -> value
    final: dict = field(default_factory=dict)
    outputs: bytes = b""
    panic: bool = False

    @property
    def padded_length(self) -> int:
        """Jolt pads the trace with at least one no-op to a power of two,
        and to no fewer than 256 cycles."""
        return max(256, _pow2_at_least(len(self.cycles) + 1))


def load_elf(blob: bytes) -> tuple[int, dict]:
    """(entry, {doubleword address: value}) of the ELF64's PT_LOAD segments."""
    if blob[:4] != b"\x7fELF" or blob[4] != 2 or blob[5] != 1:
        raise ValueError("not a little-endian ELF64")
    entry, phoff = struct.unpack_from("<QQ", blob, 24)
    phentsize, phnum = struct.unpack_from("<HH", blob, 54)
    image = {}
    for i in range(phnum):
        p_type, _, off, vaddr, _, filesz, _, _ = struct.unpack_from(
            "<IIQQQQQQ", blob, phoff + i * phentsize)
        if p_type != 1:
            continue
        for j, b in enumerate(blob[off:off + filesz]):
            a = vaddr + j
            image[a & ~7] = image.get(a & ~7, 0) | b << (8 * (a & 7))
    return entry, image


def _sx(v: int, bits: int) -> int:
    return v - (1 << bits) if v >> (bits - 1) & 1 else v


def run(blob: bytes, max_cycles: int = 1 << 24) -> Run:
    """Run the guest to its halt."""
    entry, image = load_elf(blob)
    mem = dict(image)
    out = Run(initial=dict(image))
    x = [0] * 32
    pc = entry
    while True:
        if len(out.cycles) >= max_cycles:
            raise RuntimeError("the guest did not halt")
        if pc & 3:
            raise ValueError(f"misaligned pc {pc:#x}")
        w = mem.get(pc & ~7, 0) >> (8 * (pc & 4)) & 0xFFFFFFFF
        op, rd, f3 = w & 0x7F, w >> 7 & 31, w >> 12 & 7
        rs1, rs2, f7 = w >> 15 & 31, w >> 20 & 31, w >> 25
        a, b = x[rs1], x[rs2]
        i_imm = _sx(w >> 20, 12)
        cyc = Cycle(pc)
        nxt, val = pc + 4, None
        if op == 0x37:                                   # lui
            val = _sx(w & 0xFFFFF000, 32)
        elif op == 0x17:                                 # auipc
            val = pc + _sx(w & 0xFFFFF000, 32)
        elif op == 0x6F:                                 # jal
            imm = _sx((w >> 31 & 1) << 20 | (w >> 12 & 0xFF) << 12
                      | (w >> 20 & 1) << 11 | (w >> 21 & 0x3FF) << 1, 21)
            val, nxt = pc + 4, (pc + imm) & MASK
        elif op == 0x67 and f3 == 0:                     # jalr
            val, nxt = pc + 4, (a + i_imm) & MASK & ~1
        elif op == 0x63:                                 # branches
            imm = _sx((w >> 31 & 1) << 12 | (w >> 7 & 1) << 11
                      | (w >> 25 & 0x3F) << 5 | (w >> 8 & 0xF) << 1, 13)
            sa, sb = _sx(a, 64), _sx(b, 64)
            take = {0: a == b, 1: a != b, 4: sa < sb, 5: sa >= sb,
                    6: a < b, 7: a >= b}.get(f3)
            if take is None:
                raise ValueError(f"branch funct3 {f3} at {pc:#x}")
            if take:
                nxt = (pc + imm) & MASK
        elif op == 0x03 and f3 == 3:                     # ld
            addr = (a + i_imm) & MASK
            if addr & 7:
                raise ValueError(f"misaligned ld at {pc:#x}")
            val = mem.get(addr, 0)
            cyc.ram_addr, cyc.ram_read, cyc.ram_write = addr, val, val
        elif op == 0x23 and f3 == 3:                     # sd
            addr = (a + _sx(f7 << 5 | rd, 12)) & MASK
            if addr & 7:
                raise ValueError(f"misaligned sd at {pc:#x}")
            cyc.ram_addr, cyc.ram_read, cyc.ram_write = addr, mem.get(addr, 0), b
            mem[addr] = b
            rd = 0
        elif op == 0x13:                                 # OP-IMM
            sh = w >> 20 & 63
            if f3 == 0:
                val = a + i_imm
            elif f3 == 4:
                val = a ^ (i_imm & MASK)
            elif f3 == 6:
                val = a | (i_imm & MASK)
            elif f3 == 7:
                val = a & (i_imm & MASK)
            elif f3 == 1 and w >> 26 == 0:
                val = a << sh
            elif f3 == 5 and w >> 26 == 0:
                val = a >> sh
            elif f3 == 5 and w >> 26 == 0x10:
                val = _sx(a, 64) >> sh
            else:
                raise ValueError(f"OP-IMM {w:#010x} at {pc:#x}")
        elif op == 0x33:                                 # OP
            ops = {(0, 0): lambda: a + b, (0, 0x20): lambda: a - b,
                   (0, 1): lambda: a * b, (7, 0): lambda: a & b,
                   (6, 0): lambda: a | b, (4, 0): lambda: a ^ b,
                   (1, 0): lambda: a << (b & 63), (5, 0): lambda: a >> (b & 63),
                   (3, 0): lambda: int(a < b),
                   (2, 0): lambda: int(_sx(a, 64) < _sx(b, 64))}
            if (f3, f7) not in ops:
                raise ValueError(f"OP {w:#010x} at {pc:#x}")
            val = ops[(f3, f7)]()
        else:
            raise ValueError(f"instruction {w:#010x} at {pc:#x} is outside "
                             "the reference's subset")
        if val is not None and rd:
            x[rd] = val & MASK
            cyc.rd_write = x[rd]
        out.cycles.append(cyc)
        if nxt == pc:
            break
        pc = nxt
    io = io_layout()
    # the tracer records the termination word once the guest halts
    mem[io["termination"]] = 1
    out.final = mem
    out.panic = bool(mem.get(io["panic"], 0))
    # the output is every byte up to the last doubleword stored there
    ends = [c.ram_addr + 8 for c in out.cycles
            if io["output"] <= c.ram_addr < io["output_end"]]
    out.outputs = b"".join(mem.get(a, 0).to_bytes(8, "little")
                           for a in range(io["output"], max(ends, default=0), 8))
    return out
