"""RV64IMC tracing emulator.

Byte-exact semantics vs the reference tracer (src/tracer/mod.zig:125-900):
same TraceStep fields, same padWithNoop policy (min 256, next_pow2(len+1)),
same termination (ECALL or PC-unchanged infinite-loop heuristic followed by a
synthetic termination write), same I/O-region dispatch, untraced instruction
fetches, RVC expansion with pc+2 stepping.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

from . import decode as dec
from .layout import RAM_START_ADDRESS, JoltDevice, MemoryConfig, MemoryLayout
from .state import M64, RAMState, RegisterFile

JOLT_CYCLE_TRACK_ECALL_NUM = 0xC7C1E
JOLT_PRINT_ECALL_NUM = 0x5072696E


def _s64(x: int) -> int:
    """u64 -> signed."""
    return x - (1 << 64) if x >> 63 else x


def _u64(x: int) -> int:
    return x & M64


def _s32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >> 31 else x


def _sext32(x: int) -> int:
    return _u64(_s32(x))


class TraceStep(NamedTuple):
    """One trace row. A NamedTuple (not a dataclass) deliberately: the native
    emulator bridge materializes millions of these per prove and tuple
    construction is ~4x cheaper than a dataclass __init__."""

    cycle: int
    pc: int
    unexpanded_pc: int
    instruction: int
    rs1_value: int
    rs2_value: int
    rd_pre_value: int
    rd_value: int
    memory_addr: int | None
    memory_pre_value: int | None
    memory_value: int | None
    is_memory_write: bool
    next_pc: int
    is_compressed: bool
    is_noop: bool = False
    # position within a virtual sequence (vm/virtual.py): 0 for real rows,
    # 0..L-1 for the L expanded rows of a div-family instruction. The
    # bytecode slot of a row is slot_of(address) + seq_pos.
    seq_pos: int = 0


NOOP_STEP = TraceStep(0, 0, 0, 0, 0, 0, 0, 0, None, None, None, False, 0, False, True, 0)


def pad_with_noop(steps: list[TraceStep], min_pad: int = 256) -> list[TraceStep]:
    """Min 256, else next_pow2(len+1) (reference tracer/mod.zig:82-121).
    min_pad below 256 deviates from the reference and exists for tests that
    exercise the device kernels at small compile-friendly shapes."""
    n = len(steps)
    if n and steps[-1].is_noop:
        return steps
    padded = min_pad if n < min_pad else 1 << (n + 1 - 1).bit_length()
    if padded < n + 1:
        padded <<= 1
    return steps + [NOOP_STEP] * (padded - n)


class MemoryFault(Exception):
    """Guest data access outside the provable RAM window."""


class Ecall(Exception):
    pass


@dataclass
class Emulator:
    config: MemoryConfig
    pc: int = RAM_START_ADDRESS
    cycle: int = 0
    ram: RAMState = field(default_factory=RAMState)
    registers: RegisterFile = field(default_factory=RegisterFile)
    trace: list[TraceStep] = field(default_factory=list)
    is_compressed: bool = False
    prev_pc: int = 0
    # expand div-family instructions into virtual sequences (vm/virtual.py).
    # Sound-mode proves turn this on; reference-compat traces keep the
    # reference's direct div/rem rows (no sequences, like the reference).
    expand_virtual: bool = False

    def __post_init__(self):
        self.device = JoltDevice(MemoryLayout.create(self.config))
        self.lookup_entries: list = []  # filled by the lookup-trace collector
        self._fetch_cache: dict = {}
        # provable RAM window in words (pipeline LOG_RAM_K; reference
        # common/constants RAM defaults) — accesses beyond it fault
        self.ram_k_words = 1 << 16

    # -- setup ------------------------------------------------------------
    def load_program_at(self, bytecode: bytes, base: int) -> None:
        for i, b in enumerate(bytecode):
            self.ram.write_byte_untraced(base + i, b)

    def load_program(self, bytecode: bytes) -> None:
        self.load_program_at(bytecode, RAM_START_ADDRESS)

    def set_inputs(self, inputs: bytes) -> None:
        self.device.inputs.extend(inputs)

    # -- memory with I/O dispatch -----------------------------------------
    def _check_ram_bounds(self, a: int) -> None:
        # The provable RAM window is the ram_k_words word slots from the
        # layout's lowest address (reference jolt_device.zig remapAddress +
        # the RAM K bound). Accesses outside it would silently diverge from
        # the committed RamInc/RamRa polynomials (the reference pipeline has
        # the same latent inconsistency and never checks); fault instead so
        # invalid guests — e.g. sign-extended lui-materialized pointers —
        # surface as a clear error at trace time.
        lowest = self.device.layout.lowest_address()
        if not (lowest <= a < lowest + 8 * self.ram_k_words):
            raise MemoryFault(
                f"guest memory access at {a:#x} is outside the provable RAM "
                f"window [{lowest:#x}, {lowest + 8 * self.ram_k_words:#x}) "
                f"(sign-extended address? materialize RAM pointers "
                f"PC-relatively or with Asm.li_addr)")

    def _read_byte_io(self, a: int) -> int:
        if self.device.is_io(a):
            return self.device.load(a)
        self._check_ram_bounds(a)
        return self.ram.read_byte(a, self.cycle)

    def _write_byte_io(self, a: int, v: int) -> None:
        if self.device.is_io(a):
            self.device.store(a, v)
        else:
            self._check_ram_bounds(a)
            self.ram.write_byte(a, v, self.cycle)

    # -- fetch/decode ------------------------------------------------------
    def _fetch(self) -> int:
        # program memory is static during execution (no self-modifying code
        # in the RV64IMC guest model), so fetches memoize per PC
        cached = self._fetch_cache.get(self.pc)
        if cached is not None:
            self.is_compressed = cached[1]
            return cached[0]
        hw = self.ram.read_byte_untraced(self.pc) | (self.ram.read_byte_untraced(self.pc + 1) << 8)
        if dec.is_compressed(hw):
            self.is_compressed = True
            instr = dec.expand_compressed(hw)
        else:
            self.is_compressed = False
            instr = (hw | (self.ram.read_byte_untraced(self.pc + 2) << 16)
                     | (self.ram.read_byte_untraced(self.pc + 3) << 24))
        self._fetch_cache[self.pc] = (instr, self.is_compressed)
        return instr

    # -- single step -------------------------------------------------------
    def step(self) -> bool:
        if self.prev_pc != 0 and self.prev_pc == self.pc:
            return False  # infinite-loop termination heuristic

        instruction = self._fetch()
        d = dec.decode(instruction)

        if self.expand_virtual:
            from . import virtual as vi

            if vi.is_div_family(instruction):
                self._step_virtual_sequence(instruction)
                return True

        rs1_value = self.registers.read(d.rs1)
        rs2_value = self.registers.read(d.rs2)
        rd_pre_value = self.registers.read(d.rd)

        self._record_lookup(d, rs1_value, rs2_value)

        try:
            result = self._execute(d, rs1_value, rs2_value)
        except Ecall:
            self.cycle += 1
            raise

        memory_pre_value = result.get("memory_pre_value")
        if memory_pre_value is None and result["is_memory_write"] and self.ram.trace:
            last = self.ram.trace[-1]
            if last.op == "write" and last.timestamp == self.cycle:
                memory_pre_value = last.pre_value

        self.trace.append(TraceStep(
            cycle=self.cycle,
            pc=self.pc,
            unexpanded_pc=self.pc,
            instruction=instruction,
            rs1_value=rs1_value,
            rs2_value=rs2_value,
            rd_pre_value=rd_pre_value,
            rd_value=result["rd_value"],
            memory_addr=result["memory_addr"],
            memory_pre_value=memory_pre_value,
            memory_value=result["memory_value"],
            is_memory_write=result["is_memory_write"],
            next_pc=result["next_pc"],
            is_compressed=self.is_compressed,
        ))

        self.prev_pc = self.pc
        self.pc = result["next_pc"]
        self.cycle += 1
        self.registers.tick()
        return True

    def _step_virtual_sequence(self, instruction: int) -> None:
        """Execute a div-family instruction as its virtual sequence: one
        trace row per virtual word, scratch in x32.., untrusted advice
        pinned by the in-sequence asserts (vm/virtual.py module doc)."""
        from . import virtual as vi

        d = dec.decode(instruction)
        q, r = vi.advice_values(instruction, self.registers.read(d.rs1),
                                self.registers.read(d.rs2))
        words = vi.expand(instruction)
        advice_iter = iter((q, r))
        for pos, w in enumerate(words):
            kind, rd, rs1, rs2, _, last = vi.fields(w)
            rs1_value = self.registers.read(rs1)
            rs2_value = self.registers.read(rs2)
            rd_pre_value = self.registers.read(rd)
            adv = next(advice_iter) if kind == vi.VK.ADVICE else 0
            if kind in vi.IMM_KINDS:
                rs2_value = 0          # operand comes from the static imm
            rd_value = vi.row_result(kind, rs1_value, rs2_value, adv)
            if kind in vi.ASSERT_KINDS:
                if rd_value != 1:
                    raise RuntimeError(
                        f"virtual assert {kind.name} failed at pc="
                        f"{self.pc:#x} ({rs1_value:#x}, {rs2_value:#x})")
                out = 0
            else:
                self.registers.write(rd, rd_value)
                out = rd_value if rd != 0 else 0
            self.trace.append(TraceStep(
                cycle=self.cycle, pc=self.pc, unexpanded_pc=self.pc,
                instruction=w, rs1_value=rs1_value, rs2_value=rs2_value,
                rd_pre_value=rd_pre_value, rd_value=out,
                memory_addr=None, memory_pre_value=None, memory_value=None,
                is_memory_write=False,
                next_pc=self.pc + 4 if last else self.pc,
                is_compressed=False, seq_pos=pos))
            self.cycle += 1
            self.registers.tick()
        self.prev_pc = self.pc
        self.pc += 4

    def run(self, max_cycles: int = 1 << 24) -> None:
        from .native_emu import run_native

        if run_native(self, max_cycles):
            return
        while self.cycle < max_cycles:
            try:
                if not self.step():
                    self._record_termination_write()
                    return
            except Ecall:
                self._record_termination_write()
                return
        raise RuntimeError("max cycle budget exceeded")

    def run_python(self, max_cycles: int = 1 << 24) -> None:
        """Force the Python stepper (differential-test oracle)."""
        while self.cycle < max_cycles:
            try:
                if not self.step():
                    self._record_termination_write()
                    return
            except Ecall:
                self._record_termination_write()
                return
        raise RuntimeError("max cycle budget exceeded")

    def _record_termination_write(self) -> None:
        self.ram.record_write(self.device.layout.termination, 0, 1, self.cycle)

    def get_outputs(self) -> bytes:
        return bytes(self.device.outputs)

    # -- lookup trace hook (overridden/extended by the lasso collector) ----
    def _record_lookup(self, d, rs1, rs2) -> None:
        from .lookups import record_lookup_entry

        entry = record_lookup_entry(self.cycle, self.pc, d, rs1, rs2)
        if entry is not None:
            self.lookup_entries.append(entry)

    # -- execute -----------------------------------------------------------
    def _execute(self, d: dec.DecodedInstruction, rs1: int, rs2: int) -> dict:
        pc_inc = 2 if self.is_compressed else 4
        res = {
            "rd_value": 0,
            "memory_addr": None,
            "memory_value": None,
            "is_memory_write": False,
            "next_pc": _u64(self.pc + pc_inc),
        }
        op = d.opcode
        O = dec.Opcode

        if op is O.LUI:
            res["rd_value"] = _u64(d.imm)
            self.registers.write(d.rd, res["rd_value"])
        elif op is O.AUIPC:
            res["rd_value"] = _u64(_s64(self.pc) + d.imm)
            self.registers.write(d.rd, res["rd_value"])
        elif op is O.JAL:
            res["rd_value"] = _u64(self.pc + pc_inc)
            res["next_pc"] = _u64(_s64(self.pc) + d.imm)
            self.registers.write(d.rd, res["rd_value"])
        elif op is O.JALR:
            res["rd_value"] = _u64(self.pc + pc_inc)
            res["next_pc"] = _u64((_s64(rs1) + d.imm) & ~1)
            self.registers.write(d.rd, res["rd_value"])
        elif op is O.BRANCH:
            f3 = d.funct3
            taken = {
                0b000: rs1 == rs2,
                0b001: rs1 != rs2,
                0b100: _s64(rs1) < _s64(rs2),
                0b101: _s64(rs1) >= _s64(rs2),
                0b110: rs1 < rs2,
                0b111: rs1 >= rs2,
            }.get(f3, False)
            if taken:
                res["next_pc"] = _u64(_s64(self.pc) + d.imm)
        elif op is O.LOAD:
            addr = _u64(_s64(rs1) + d.imm)
            res["memory_addr"] = addr
            f3 = d.funct3
            if f3 == 0b000:  # LB
                v = self._read_byte_io(addr)
                value = _u64(_sext(v, 8))
            elif f3 == 0b100:  # LBU
                value = self._read_byte_io(addr)
            elif f3 == 0b001:  # LH
                v = self._read_byte_io(addr) | (self._read_byte_io(addr + 1) << 8)
                value = _u64(_sext(v, 16))
            elif f3 == 0b101:  # LHU
                value = self._read_byte_io(addr) | (self._read_byte_io(addr + 1) << 8)
            elif f3 == 0b010:  # LW
                v = sum(self._read_byte_io(addr + i) << (8 * i) for i in range(4))
                value = _u64(_sext(v, 32))
            elif f3 == 0b110:  # LWU
                value = sum(self._read_byte_io(addr + i) << (8 * i) for i in range(4))
            elif f3 == 0b011:  # LD
                value = sum(self._read_byte_io(addr + i) << (8 * i) for i in range(8))
            else:
                value = 0
            res["rd_value"] = value
            res["memory_value"] = value
            self.registers.write(d.rd, value)
        elif op is O.STORE:
            addr = _u64(_s64(rs1) + d.imm)
            res["memory_addr"] = addr
            res["is_memory_write"] = True
            f3 = d.funct3
            nbytes = {0b000: 1, 0b001: 2, 0b010: 4, 0b011: 8}.get(f3, 0)
            # capture the pre-value without recording a read access (trace-
            # neutral; the sound-mode witness uses rv(store) = pre-value)
            pre = 0
            for i in range(nbytes):
                a_i = addr + i
                b = self.device.load(a_i) if self.device.is_io(a_i) \
                    else self.ram.read_byte_untraced(a_i)
                pre |= b << (8 * i)
            res["memory_pre_value"] = pre if nbytes else None
            for i in range(nbytes):
                self._write_byte_io(addr + i, (rs2 >> (8 * i)) & 0xFF)
            res["memory_value"] = rs2 & ((1 << (8 * nbytes)) - 1) if nbytes else None
        elif op is O.OP_IMM:
            imm = _u64(d.imm)
            f3 = d.funct3
            if f3 == 0b000:
                v = _u64(rs1 + imm)
            elif f3 == 0b010:
                v = 1 if _s64(rs1) < d.imm else 0
            elif f3 == 0b011:
                v = 1 if rs1 < imm else 0
            elif f3 == 0b100:
                v = rs1 ^ imm
            elif f3 == 0b110:
                v = rs1 | imm
            elif f3 == 0b111:
                v = rs1 & imm
            elif f3 == 0b001:
                v = _u64(rs1 << ((d.imm & 0x3F)))
            elif f3 == 0b101:
                sh = d.imm & 0x3F
                v = _u64(_s64(rs1) >> sh) if (d.funct7 & 0x20) else rs1 >> sh
            res["rd_value"] = v
            self.registers.write(d.rd, v)
        elif op is O.OP:
            f3 = d.funct3
            if d.funct7 == 1:  # M extension
                v = self._mext(f3, rs1, rs2)
            else:
                if f3 == 0b000:
                    v = _u64(rs1 - rs2) if (d.funct7 & 0x20) else _u64(rs1 + rs2)
                elif f3 == 0b001:
                    v = _u64(rs1 << (rs2 & 0x3F))
                elif f3 == 0b010:
                    v = 1 if _s64(rs1) < _s64(rs2) else 0
                elif f3 == 0b011:
                    v = 1 if rs1 < rs2 else 0
                elif f3 == 0b100:
                    v = rs1 ^ rs2
                elif f3 == 0b101:
                    sh = rs2 & 0x3F
                    v = _u64(_s64(rs1) >> sh) if (d.funct7 & 0x20) else rs1 >> sh
                elif f3 == 0b110:
                    v = rs1 | rs2
                else:
                    v = rs1 & rs2
            res["rd_value"] = v
            self.registers.write(d.rd, v)
        elif op is O.OP_IMM_32:
            f3 = d.funct3
            r32 = rs1 & 0xFFFFFFFF
            if f3 == 0b000:  # ADDIW
                v = _sext32(r32 + (d.imm & 0xFFFFFFFF))
            elif f3 == 0b001:  # SLLIW
                v = _sext32(r32 << (d.imm & 0x1F))
            elif f3 == 0b101:
                sh = d.imm & 0x1F
                v = _sext32(_s32(r32) >> sh) if (d.funct7 & 0x20) else _sext32(r32 >> sh)
            else:
                v = 0
            res["rd_value"] = v
            self.registers.write(d.rd, v)
        elif op is O.OP_32:
            v = self._op32(d, rs1 & 0xFFFFFFFF, rs2 & 0xFFFFFFFF)
            res["rd_value"] = v
            self.registers.write(d.rd, v)
        elif op is O.SYSTEM:
            funct12 = (d.imm & 0xFFF)
            if funct12 == 0:  # ECALL
                a0 = self.registers.read(10)
                a7 = self.registers.read(17)
                if a0 == JOLT_CYCLE_TRACK_ECALL_NUM or a7 == JOLT_CYCLE_TRACK_ECALL_NUM:
                    pass
                elif a0 == JOLT_PRINT_ECALL_NUM or a7 == JOLT_PRINT_ECALL_NUM:
                    pass
                else:
                    raise Ecall()
            # EBREAK: NOP
        # MISC_MEM / unknown: NOP
        return res

    def _mext(self, f3: int, rs1: int, rs2: int) -> int:
        s1, s2 = _s64(rs1), _s64(rs2)
        if f3 == 0b000:  # MUL
            return _u64(rs1 * rs2)
        if f3 == 0b001:  # MULH
            return _u64((s1 * s2) >> 64)
        if f3 == 0b010:  # MULHSU
            return _u64((s1 * rs2) >> 64)
        if f3 == 0b011:  # MULHU
            return (rs1 * rs2) >> 64
        if f3 == 0b100:  # DIV
            if rs2 == 0:
                return M64
            if s1 == -(1 << 63) and s2 == -1:
                return rs1
            q = abs(s1) // abs(s2)
            return _u64(q if (s1 < 0) == (s2 < 0) else -q)
        if f3 == 0b101:  # DIVU
            return M64 if rs2 == 0 else rs1 // rs2
        if f3 == 0b110:  # REM
            if rs2 == 0:
                return rs1
            if s1 == -(1 << 63) and s2 == -1:
                return 0
            r = abs(s1) % abs(s2)
            return _u64(r if s1 >= 0 else -r)
        # REMU
        return rs1 if rs2 == 0 else rs1 % rs2

    def _op32(self, d, r1: int, r2: int) -> int:
        f3 = d.funct3
        s1, s2 = _s32(r1), _s32(r2)
        if d.funct7 == 1:  # RV64M word ops
            if f3 == 0b000:  # MULW
                return _sext32(s1 * s2)
            if f3 == 0b100:  # DIVW
                if s2 == 0:
                    return _sext32(-1)
                if s1 == -(1 << 31) and s2 == -1:
                    return _sext32(s1)
                q = abs(s1) // abs(s2)
                return _sext32(q if (s1 < 0) == (s2 < 0) else -q)
            if f3 == 0b101:  # DIVUW
                return _sext32(0xFFFFFFFF) if r2 == 0 else _sext32(r1 // r2)
            if f3 == 0b110:  # REMW
                if s2 == 0:
                    return _sext32(s1)
                if s1 == -(1 << 31) and s2 == -1:
                    return 0
                r = abs(s1) % abs(s2)
                return _sext32(r if s1 >= 0 else -r)
            if f3 == 0b111:  # REMUW
                return _sext32(r1) if r2 == 0 else _sext32(r1 % r2)
            return 0
        if f3 == 0b000:
            return _sext32(s1 - s2) if (d.funct7 & 0x20) else _sext32(s1 + s2)
        if f3 == 0b001:
            return _sext32(r1 << (r2 & 0x1F))
        if f3 == 0b101:
            sh = r2 & 0x1F
            return _sext32(s1 >> sh) if (d.funct7 & 0x20) else _sext32(r1 >> sh)
        return 0


def _sext(v: int, bits: int) -> int:
    m = 1 << (bits - 1)
    return (v ^ m) - m


def run_elf(path_or_bytes, inputs: bytes = b"", config: MemoryConfig | None = None,
            max_cycles: int = 1 << 24, expand_virtual: bool = False) -> Emulator:
    """Load an ELF, run to termination, return the emulator with full traces."""
    from . import elf as elfmod

    if isinstance(path_or_bytes, (bytes, bytearray)):
        parsed = elfmod.parse(bytes(path_or_bytes))
    else:
        parsed = elfmod.load_file(path_or_bytes)
    base, image = parsed.flat_image()
    config = config or MemoryConfig(program_size=max(1024, len(image)))
    if config.program_size is None:
        config.program_size = max(1024, len(image))
    emu = Emulator(config, expand_virtual=expand_virtual)
    emu.load_program_at(image, base)
    emu.pc = parsed.entry
    if inputs:
        emu.set_inputs(inputs)
    # snapshot the initial RAM word map (program image + inputs) — the Jolt
    # prover's initial_ram for RWC/OutputCheck (reference zkvm/mod.zig:95-146)
    emu.initial_memory = dict(emu.ram.memory)
    emu.run(max_cycles)
    return emu
