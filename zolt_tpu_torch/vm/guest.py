"""Guest-side interface: the ecall ABI, memory-mapped I/O addresses, and a
small RISC-V assembler for authoring guest programs from Python.

Mirrors the reference's guest surface (src/guest/mod.zig:10-75 readInput /
writeOutput / panic / halt / cycleCount / debugPrint / advice readers /
commit / assert, and the little-endian Hint reader at :75-110) as *code
emitters*: instead of linking a Zig library into the guest, a Python host
builds the instruction stream that performs the same memory-mapped I/O the
emulator's JoltDevice understands (src/common/jolt_device.zig:180-360).

The assembler covers the RV64IM subset the examples and tests use; programs
it produces load directly via `Emulator.load_program`.
"""

from __future__ import annotations

from .layout import MemoryLayout

# ecall numbers recognized by the emulator (reference tracer/mod.zig ECALL
# handling): placed in a0 (or a7); anything else halts the VM.
JOLT_CYCLE_TRACK_ECALL_NUM = 0xC7C1E
JOLT_PRINT_ECALL_NUM = 0x5072696E


class Hint:
    """Little-endian advice reader (reference guest/mod.zig:75-110)."""

    def __init__(self, data: bytes):
        self.data = bytes(data)
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("HintExhausted")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def read_u64(self) -> int:
        return int.from_bytes(self._take(8), "little")

    def read_u32(self) -> int:
        return int.from_bytes(self._take(4), "little")

    def read_bytes(self, n: int) -> bytes:
        return self._take(n)


def _sx(v: int, bits: int) -> int:
    m = 1 << (bits - 1)
    return (v & (m - 1)) - (v & m)


def _check_range(v: int, bits: int, what: str) -> int:
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    if not lo <= v <= hi:
        raise ValueError(f"{what} immediate {v} out of {bits}-bit range")
    return v & ((1 << bits) - 1)


class Asm:
    """Tiny RV64IM assembler with labels; enough for guest I/O programs.

    >>> a = Asm()
    >>> a.addi(10, 0, 42); a.halt()
    >>> emu.load_program(a.bytes())
    """

    def __init__(self):
        self.words: list[int] = []
        self.labels: dict[str, int] = {}
        self.fixups: list[tuple[int, str, str]] = []  # (index, label, kind)

    # -- label handling -----------------------------------------------------
    def li_addr(self, rd: int, addr: int) -> None:
        """Materialize a 32-bit ABSOLUTE address zero-extended to 64 bits.

        `lui` sign-extends on RV64, so addresses with bit 31 set (the RAM
        region at 0x80000000+) come out as 0xFFFFFFFF8xxxxxxx and fault the
        provable-window check; real guests use PC-relative auipc. For
        assembler-authored guests: lui+addi then slli/srli 32 to clear the
        sign extension."""
        hi = (addr + 0x800) >> 12
        lo = addr & 0xFFF
        if lo >= 0x800:
            lo -= 0x1000
        self.lui(rd, hi & 0xFFFFF)
        if lo:
            self.addi(rd, rd, lo)
        self.slli(rd, rd, 32)
        self.srli(rd, rd, 32)

    def label(self, name: str) -> None:
        self.labels[name] = len(self.words) * 4

    def _branch_off(self, target, kind: str) -> int:
        if isinstance(target, str):
            self.fixups.append((len(self.words), target, kind))
            return 0
        return target

    # -- encoders -----------------------------------------------------------
    def _r(self, opcode, rd, f3, rs1, rs2, f7):
        self.words.append(opcode | rd << 7 | f3 << 12 | rs1 << 15 | rs2 << 20 | f7 << 25)

    def _i(self, opcode, rd, f3, rs1, imm):
        imm = _check_range(imm, 12, "I")
        self.words.append(opcode | rd << 7 | f3 << 12 | rs1 << 15 | imm << 20)

    def _s(self, opcode, f3, rs1, rs2, imm):
        imm = _check_range(imm, 12, "S")
        self.words.append(opcode | (imm & 0x1F) << 7 | f3 << 12 | rs1 << 15
                          | rs2 << 20 | (imm >> 5) << 25)

    def _b(self, f3, rs1, rs2, imm):
        imm = _check_range(imm, 13, "B") & ~1
        w = (0x63 | ((imm >> 11) & 1) << 7 | ((imm >> 1) & 0xF) << 8 | f3 << 12
             | rs1 << 15 | rs2 << 20 | ((imm >> 5) & 0x3F) << 25 | ((imm >> 12) & 1) << 31)
        self.words.append(w)

    # -- instructions -------------------------------------------------------
    def addi(self, rd, rs1, imm):  self._i(0x13, rd, 0, rs1, imm)
    def slti(self, rd, rs1, imm):  self._i(0x13, rd, 2, rs1, imm)
    def andi(self, rd, rs1, imm):  self._i(0x13, rd, 7, rs1, imm)
    def ori(self, rd, rs1, imm):   self._i(0x13, rd, 6, rs1, imm)
    def xori(self, rd, rs1, imm):  self._i(0x13, rd, 4, rs1, imm)
    def slli(self, rd, rs1, sh):   self._i(0x13, rd, 1, rs1, sh)
    def srli(self, rd, rs1, sh):   self._i(0x13, rd, 5, rs1, sh)

    def add(self, rd, rs1, rs2):   self._r(0x33, rd, 0, rs1, rs2, 0)
    def sub(self, rd, rs1, rs2):   self._r(0x33, rd, 0, rs1, rs2, 0x20)
    def addw(self, rd, rs1, rs2):  self._r(0x3B, rd, 0, rs1, rs2, 0)
    def subw(self, rd, rs1, rs2):  self._r(0x3B, rd, 0, rs1, rs2, 0x20)
    def sllw(self, rd, rs1, rs2):  self._r(0x3B, rd, 1, rs1, rs2, 0)
    def srlw(self, rd, rs1, rs2):  self._r(0x3B, rd, 5, rs1, rs2, 0)
    def sraw(self, rd, rs1, rs2):  self._r(0x3B, rd, 5, rs1, rs2, 0x20)
    def mulw(self, rd, rs1, rs2):  self._r(0x3B, rd, 0, rs1, rs2, 1)
    def divw(self, rd, rs1, rs2):  self._r(0x3B, rd, 4, rs1, rs2, 1)
    def remw(self, rd, rs1, rs2):  self._r(0x3B, rd, 6, rs1, rs2, 1)
    def and_(self, rd, rs1, rs2):  self._r(0x33, rd, 7, rs1, rs2, 0)
    def or_(self, rd, rs1, rs2):   self._r(0x33, rd, 6, rs1, rs2, 0)
    def xor(self, rd, rs1, rs2):   self._r(0x33, rd, 4, rs1, rs2, 0)
    def slt(self, rd, rs1, rs2):   self._r(0x33, rd, 2, rs1, rs2, 0)
    def sltu(self, rd, rs1, rs2):  self._r(0x33, rd, 3, rs1, rs2, 0)
    def sll(self, rd, rs1, rs2):   self._r(0x33, rd, 1, rs1, rs2, 0)
    def srl(self, rd, rs1, rs2):   self._r(0x33, rd, 5, rs1, rs2, 0)
    def sra(self, rd, rs1, rs2):   self._r(0x33, rd, 5, rs1, rs2, 0x20)
    def srai(self, rd, rs1, sh):   self._i(0x13, rd, 5, rs1, sh | (0x10 << 6))
    def mul(self, rd, rs1, rs2):   self._r(0x33, rd, 0, rs1, rs2, 1)
    def mulh(self, rd, rs1, rs2):  self._r(0x33, rd, 1, rs1, rs2, 1)
    def mulhsu(self, rd, rs1, rs2): self._r(0x33, rd, 2, rs1, rs2, 1)
    def mulhu(self, rd, rs1, rs2): self._r(0x33, rd, 3, rs1, rs2, 1)
    def div(self, rd, rs1, rs2):   self._r(0x33, rd, 4, rs1, rs2, 1)
    def divu(self, rd, rs1, rs2):  self._r(0x33, rd, 5, rs1, rs2, 1)
    def rem(self, rd, rs1, rs2):   self._r(0x33, rd, 6, rs1, rs2, 1)
    def remu(self, rd, rs1, rs2):  self._r(0x33, rd, 7, rs1, rs2, 1)

    def lui(self, rd, imm20):      self.words.append(0x37 | rd << 7 | (imm20 & 0xFFFFF) << 12)
    def auipc(self, rd, imm20):    self.words.append(0x17 | rd << 7 | (imm20 & 0xFFFFF) << 12)
    def sltiu(self, rd, rs1, imm): self._i(0x13, rd, 3, rs1, imm)
    def jalr(self, rd, rs1, imm):  self._i(0x67, rd, 0, rs1, imm)

    def lb(self, rd, rs1, imm):    self._i(0x03, rd, 0, rs1, imm)
    def lw(self, rd, rs1, imm):    self._i(0x03, rd, 2, rs1, imm)
    def ld(self, rd, rs1, imm):    self._i(0x03, rd, 3, rs1, imm)
    def lbu(self, rd, rs1, imm):   self._i(0x03, rd, 4, rs1, imm)
    def sb(self, rs1, rs2, imm):   self._s(0x23, 0, rs1, rs2, imm)
    def sw(self, rs1, rs2, imm):   self._s(0x23, 2, rs1, rs2, imm)
    def sd(self, rs1, rs2, imm):   self._s(0x23, 3, rs1, rs2, imm)

    def beq(self, rs1, rs2, t):    self._b(0, rs1, rs2, self._branch_off(t, "b"))
    def bne(self, rs1, rs2, t):    self._b(1, rs1, rs2, self._branch_off(t, "b"))
    def blt(self, rs1, rs2, t):    self._b(4, rs1, rs2, self._branch_off(t, "b"))
    def bge(self, rs1, rs2, t):    self._b(5, rs1, rs2, self._branch_off(t, "b"))

    def jal(self, rd, t):
        off = self._branch_off(t, "j")
        imm = _check_range(off, 21, "J") & ~1
        self.words.append(0x6F | rd << 7 | ((imm >> 12) & 0xFF) << 12
                          | ((imm >> 11) & 1) << 20 | ((imm >> 1) & 0x3FF) << 21
                          | ((imm >> 20) & 1) << 31)

    def ecall(self):               self.words.append(0x00000073)

    # -- guest-API emitters (reference guest/mod.zig semantics) --------------
    def li_addr(self, rd: int, addr: int) -> None:
        """Load a 32-bit-representable address into rd (lui+addi).

        On RV64, lui/addi sign-extend: for addresses with bit 31 set
        (e.g. RAM proper at 0x8000_0000+) the pair alone would yield
        0xFFFF_FFFF_8xxx_xxxx. Zero-extend with slli/srli so rd holds the
        canonical unsigned address the memory layout (and the RAM
        read/write-checking address window) expects."""
        hi = (addr + 0x800) >> 12
        lo = _sx(addr & 0xFFF, 12)
        self.lui(rd, hi)
        if lo:
            self.addi(rd, rd, lo)
        if addr & 0x80000000:
            self.slli(rd, rd, 32)
            self.srli(rd, rd, 32)

    def read_input_byte(self, rd: int, layout: MemoryLayout, offset: int = 0,
                        tmp: int = 5) -> None:
        """readInput: load one input byte from the memory-mapped input region."""
        self.li_addr(tmp, layout.input_start + offset)
        self.lbu(rd, tmp, 0)

    def write_output_byte(self, rs: int, layout: MemoryLayout, offset: int = 0,
                          tmp: int = 5) -> None:
        """writeOutput: store one byte into the memory-mapped output region."""
        self.li_addr(tmp, layout.output_start + offset)
        self.sb(tmp, rs, 0)

    def commit_u64(self, rs: int, layout: MemoryLayout, offset: int = 0,
                   tmp: int = 5) -> None:
        """commit: publish a u64 into the output region."""
        self.li_addr(tmp, layout.output_start + offset)
        self.sd(tmp, rs, 0)

    def panic(self, layout: MemoryLayout, tmp: int = 5, one: int = 6) -> None:
        """panic: set the panic word, then halt."""
        self.li_addr(tmp, layout.panic_addr)
        self.addi(one, 0, 1)
        self.sd(tmp, one, 0)
        self.halt(layout, tmp=tmp, one=one)

    def halt(self, layout: MemoryLayout | None = None, tmp: int = 5, one: int = 6,
             *, provable: bool = False) -> None:
        """halt: write the termination bit (when a layout is given), then stop.

        provable=False ends with ECALL (direct, but the final fall-through row
        violates R1CS constraint 16 — emulator-only use). provable=True ends
        with the Jolt guest convention the reference's examples use: a
        `jal x0, 0` self-loop, detected by the tracer's pc==prev_pc heuristic;
        the traced jump row disables the PC-update constraints at the noop
        boundary (constraints.zig:1140-1158 commentary), so the trace is
        R1CS-satisfying and provable."""
        if layout is not None:
            self.li_addr(tmp, layout.termination)
            self.addi(one, 0, 1)
            self.sd(tmp, one, 0)
        if provable:
            self.jal(0, 0)
        else:
            self.ecall()

    def cycle_track(self, marker_reg: int = 10) -> None:
        """cycleCount/debug marker ecall (non-halting, tracked by emulator)."""
        self.addi(marker_reg, 0, 0)
        self.lui(marker_reg, JOLT_CYCLE_TRACK_ECALL_NUM >> 12)
        self.addi(marker_reg, marker_reg, _sx(JOLT_CYCLE_TRACK_ECALL_NUM & 0xFFF, 12))
        self.ecall()

    # -- output -------------------------------------------------------------
    def bytes(self) -> bytes:
        words = list(self.words)
        for idx, name, kind in self.fixups:
            if name not in self.labels:
                raise ValueError(f"undefined label {name!r}")
            off = self.labels[name] - idx * 4
            w = words[idx]
            if kind == "b":
                imm = _check_range(off, 13, "B") & ~1
                w &= ~((1 << 7) | (0xF << 8) | (0x3F << 25) | (1 << 31))
                w |= (((imm >> 11) & 1) << 7 | ((imm >> 1) & 0xF) << 8
                      | ((imm >> 5) & 0x3F) << 25 | ((imm >> 12) & 1) << 31)
            else:  # jal
                imm = _check_range(off, 21, "J") & ~1
                w &= 0xFFF
                w |= (((imm >> 12) & 0xFF) << 12 | ((imm >> 11) & 1) << 20
                      | ((imm >> 1) & 0x3FF) << 21 | ((imm >> 20) & 1) << 31)
            words[idx] = w
        return b"".join(w.to_bytes(4, "little") for w in words)
