"""The one traffic generator: RV64 guest ELFs from a mix's parameters.

A mix (zkbench/traffic/<mix>.json) describes a guest as assembly text with
named immediates: `setup` runs once, `body` runs in a counted loop, `finish`
runs once before the halt. Every immediate named in braces is drawn from the
run's seed and the guest's index, within the range the mix gives it. The loop
count is fixed by the mix and the configuration's trace length alone, so every
guest of a cell executes the same number of cycles; only data differ.

The encoder and the ELF writer are the benchmark's own (a frozen subset of
RV64IM and a one-segment ELF64), so that a change to the program's assembler
cannot change the inputs. The subset is wider than today's mixes use: a later
mix is a data file, and may not need a change here. The halt follows the Jolt guest convention: store
1 to the termination word, then `jal x0, 0`.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import struct

RAM_START = 0x80000000
STACK_SIZE = 4096          # the emulator's default stack (vm/layout.py)
MIN_PROGRAM_SIZE = 1024    # run_elf's floor on the program size
IO_SIZES = (4096, 4096, 4096, 4096)  # advice (trusted, untrusted), input, output

# -- the memory map a guest writes to, worked out as the Jolt layout does ----


def _ceil_pow2(v: int) -> int:
    return 1 if v <= 1 else 1 << (v - 1).bit_length()


def io_addresses() -> dict:
    """Output, panic and termination addresses below RAM_START: the I/O
    region holds both advice buffers, the input and the output, padded to a
    power of two of doublewords, then the panic and termination words."""
    mta, mua, mi, mo = IO_SIZES
    io_bytes = _ceil_pow2((mi + mta + mua + mo + 16) // 8) * 8
    input_start = RAM_START - io_bytes + mta + mua
    output_start = input_start + mi
    panic = output_start + mo
    return {"output": output_start, "panic": panic, "termination": panic + 8}


# -- RV64IM encoder -----------------------------------------------------------

REG = re.compile(r"^x([0-9]|[12][0-9]|3[01])$")
R_OPS = {"add": (0x33, 0, 0), "sub": (0x33, 0, 0x20), "mul": (0x33, 0, 1),
         "and": (0x33, 7, 0), "or": (0x33, 6, 0), "xor": (0x33, 4, 0),
         "sll": (0x33, 1, 0), "srl": (0x33, 5, 0), "sltu": (0x33, 3, 0)}
I_OPS = {"addi": (0x13, 0), "andi": (0x13, 7), "ori": (0x13, 6),
         "xori": (0x13, 4), "slli": (0x13, 1), "srli": (0x13, 5),
         "ld": (0x03, 3)}
S_OPS = {"sd": (0x23, 3)}
B_OPS = {"beq": 0, "bne": 1, "blt": 4, "bge": 5}


def _reg(tok: str) -> int:
    m = REG.match(tok)
    if not m:
        raise ValueError(f"not a register: {tok!r}")
    return int(m.group(1))


def _field(v: int, bits: int, what: str) -> int:
    if not -(1 << (bits - 1)) <= v < (1 << (bits - 1)):
        raise ValueError(f"{what} immediate {v} out of {bits}-bit range")
    return v & ((1 << bits) - 1)


def _b_word(f3: int, rs1: int, rs2: int, off: int) -> int:
    imm = _field(off, 13, "branch") & ~1
    return (0x63 | ((imm >> 11) & 1) << 7 | ((imm >> 1) & 0xF) << 8 | f3 << 12
            | rs1 << 15 | rs2 << 20 | ((imm >> 5) & 0x3F) << 25
            | ((imm >> 12) & 1) << 31)


def _li(rd: int, value: int, *, unsigned32: bool = False) -> list[int]:
    """lui + addi, always both, so the length never depends on the value:
    a signed 32-bit value, or with unsigned32 a zero-extended address
    (slli/srli 32 clear the sign that lui extends)."""
    lo = value & 0xFFF
    if lo >= 0x800:
        lo -= 0x1000
    hi = ((value - lo) >> 12) & 0xFFFFF
    words = [0x37 | rd << 7 | hi << 12,
             0x13 | rd << 7 | rd << 15 | _field(lo, 12, "li") << 20]
    if unsigned32:
        words += [0x13 | rd << 7 | 1 << 12 | rd << 15 | 32 << 20,
                  0x13 | rd << 7 | 5 << 12 | rd << 15 | 32 << 20]
    return words


def assemble(lines: list[str]) -> bytes:
    """Two passes over `op a, b, c` lines: labels (`name:`), then words.
    `li rd, v` (signed 32 bits) and `la rd, addr` (a 32-bit address) take a
    fixed number of words."""
    parsed, labels, pc = [], {}, 0
    for line in lines:
        line = line.split("#")[0].strip()
        if not line:
            continue
        if line.endswith(":"):
            labels[line[:-1]] = pc
            continue
        op, _, rest = line.partition(" ")
        args = [a.strip() for a in rest.replace("(", ",").replace(")", "")
                .split(",") if a.strip()]
        parsed.append((pc, op, args))
        pc += 4 * (2 if op == "li" else 4 if op == "la" else 1)
    words = []
    for pc, op, a in parsed:
        if op == "li":
            words += _li(_reg(a[0]), int(a[1], 0))
        elif op == "la":
            words += _li(_reg(a[0]), int(a[1], 0), unsigned32=True)
        elif op in R_OPS:
            opc, f3, f7 = R_OPS[op]
            words.append(opc | _reg(a[0]) << 7 | f3 << 12 | _reg(a[1]) << 15
                         | _reg(a[2]) << 20 | f7 << 25)
        elif op in I_OPS:
            opc, f3 = I_OPS[op]
            if op == "ld":          # ld rd, off(rs1)
                rd, imm, rs1 = _reg(a[0]), int(a[1], 0), _reg(a[2])
            else:
                rd, rs1, imm = _reg(a[0]), _reg(a[1]), int(a[2], 0)
            if op in ("slli", "srli") and not 0 <= imm < 64:
                raise ValueError(f"shift {imm} out of range")
            words.append(opc | rd << 7 | f3 << 12 | rs1 << 15
                         | _field(imm, 12, op) << 20)
        elif op in S_OPS:           # sd rs2, off(rs1)
            opc, f3 = S_OPS[op]
            rs2, imm, rs1 = _reg(a[0]), _field(int(a[1], 0), 12, op), _reg(a[2])
            words.append(opc | (imm & 0x1F) << 7 | f3 << 12 | rs1 << 15
                         | rs2 << 20 | (imm >> 5) << 25)
        elif op in B_OPS:
            words.append(_b_word(B_OPS[op], _reg(a[0]), _reg(a[1]),
                                 labels[a[2]] - pc))
        elif op == "jal":           # jal rd, label
            imm = _field(labels[a[1]] - pc, 21, "jal") & ~1
            words.append(0x6F | _reg(a[0]) << 7 | ((imm >> 12) & 0xFF) << 12
                         | ((imm >> 11) & 1) << 20 | ((imm >> 1) & 0x3FF) << 21
                         | ((imm >> 20) & 1) << 31)
        else:
            raise ValueError(f"unknown instruction {op!r}")
    return b"".join(w.to_bytes(4, "little") for w in words)


def write_elf(code: bytes, base: int = RAM_START) -> bytes:
    """ELF64, little-endian, RISC-V, one PT_LOAD segment (R+X) at `base`,
    entry at its start."""
    ehsize, phentsize = 64, 56
    ehdr = struct.pack("<4sBBBBB7xHHIQQQIHHHHHH", b"\x7fELF", 2, 1, 1, 0, 0,
                       2, 243, 1, base, ehsize, 0, 0, ehsize, phentsize, 1,
                       0, 0, 0)
    phdr = struct.pack("<IIQQQQQQ", 1, 5, ehsize + phentsize, base, base,
                       len(code), len(code), 0x1000)
    return ehdr + phdr + code


# -- the generator ------------------------------------------------------------

LOOP_COUNTER, LOOP_LIMIT, TMP, ONE = 30, 31, 28, 29


def load_mix(name: str, root: str) -> dict:
    with open(os.path.join(root, "traffic", f"{name}.json")) as f:
        return json.load(f)


def draw(seed: int, index: int, name: str, lo: int, hi: int) -> int:
    """A value in [lo, hi] from (seed, index, name): SHA-256, so any seed,
    however large, gives the same guest on every machine."""
    h = hashlib.sha256(f"{seed}/{index}/{name}".encode()).digest()
    return lo + int.from_bytes(h[:8], "little") % (hi - lo + 1)


def _static_cycles(lines: list[str]) -> int:
    """Cycles of straight-line code: one a word."""
    return len(assemble(lines)) // 4


def program(mix: dict, log_t: int, values: dict) -> list[str]:
    """The guest's assembly: setup, `iters` passes of the body, finish, then
    the outputs and the halt. `iters` fills `fill` of 2^log_t cycles."""
    io = io_addresses()
    env = dict(values, array_base=array_base())
    setup = [s.format(**env) for s in mix["setup"]]
    body = [s.format(**env) for s in mix["body"]]
    finish = [s.format(**env) for s in mix.get("finish", [])]
    outs = mix["outputs"]
    tail = []
    for i, reg in enumerate(outs):
        tail += [f"la x{TMP}, {io['output'] + 8 * i}", f"sd {reg}, 0(x{TMP})"]
    tail += [f"la x{TMP}, {io['termination']}", f"addi x{ONE}, x0, 1",
             f"sd x{ONE}, 0(x{TMP})", "halt:", "jal x0, halt"]
    per_iter = _static_cycles(body) + 2      # the counter and the branch
    fixed = (_static_cycles(setup) + 4 + _static_cycles(finish)
             + _static_cycles(tail[:-2]) + 1)
    iters = (int(mix["fill"] * (1 << log_t)) - fixed) // per_iter
    if iters < 1:
        raise ValueError(f"mix leaves no room for its loop at 2^{log_t}")
    return (setup
            + [f"addi x{LOOP_COUNTER}, x0, 0", f"li x{LOOP_LIMIT}, {iters}",
               "loop:"] + body
            + [f"addi x{LOOP_COUNTER}, x{LOOP_COUNTER}, 1",
               f"blt x{LOOP_COUNTER}, x{LOOP_LIMIT}, loop"]
            + finish + tail)


def array_base() -> int:
    """The first doubleword above the stack: run_elf gives a program of
    under MIN_PROGRAM_SIZE bytes that many, and the stack sits above it."""
    return RAM_START + MIN_PROGRAM_SIZE + STACK_SIZE


def elf_writer(mix: dict, log_t: int, seed: int, directory: str):
    """path_of(index): the path of the index-th guest, written into
    `directory` the first time it is asked for."""
    def path_of(index: int) -> str:
        path = os.path.join(directory, f"guest{index}.elf")
        if not os.path.exists(path):
            with open(path, "wb") as f:
                f.write(guest_elf(mix, log_t, seed, index))
        return path
    return path_of


def guest_elf(mix: dict, log_t: int, seed: int, index: int) -> bytes:
    """The index-th guest of a run with this seed."""
    values = {k: draw(seed, index, k, lo, hi)
              for k, (lo, hi) in sorted(mix["draws"].items())}
    code = assemble(program(mix, log_t, values))
    if len(code) > MIN_PROGRAM_SIZE:
        raise ValueError("guest longer than the program size array_base assumes")
    return write_elf(code)
