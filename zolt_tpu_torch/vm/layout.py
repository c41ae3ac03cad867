"""Jolt VM memory layout + I/O device (host-side, byte-exact address math).

Re-implements the reference's layout algebra exactly (src/common/constants.zig,
src/common/jolt_device.zig:13-360): the I/O region (advice, inputs, outputs,
panic and termination words) sits immediately below RAM_START_ADDRESS, padded
so that witness indices align; the stack grows down from program end; the heap
up from the stack top.
"""

from __future__ import annotations

from dataclasses import dataclass, field

XLEN = 64
RISCV_REGISTER_COUNT = 32
VIRTUAL_REGISTER_COUNT = 96
REGISTER_COUNT = 128
RAM_START_ADDRESS = 0x80000000
EMULATOR_MEMORY_CAPACITY = 128 * 1024 * 1024
DEFAULT_STACK_SIZE = 4096
STACK_CANARY_SIZE = 128
DEFAULT_MAX_INPUT_SIZE = 4096
DEFAULT_MAX_OUTPUT_SIZE = 4096
DEFAULT_MAX_TRUSTED_ADVICE_SIZE = 4096
DEFAULT_MAX_UNTRUSTED_ADVICE_SIZE = 4096
DEFAULT_MEMORY_SIZE = EMULATOR_MEMORY_CAPACITY
DEFAULT_MAX_TRACE_LENGTH = 1 << 24


def _align_up(v: int, a: int) -> int:
    return v if a == 0 or v % a == 0 else v + (a - v % a)


def _ceil_pow2(v: int) -> int:
    return 1 if v <= 1 else 1 << (v - 1).bit_length()


@dataclass
class MemoryConfig:
    max_input_size: int = DEFAULT_MAX_INPUT_SIZE
    max_trusted_advice_size: int = DEFAULT_MAX_TRUSTED_ADVICE_SIZE
    max_untrusted_advice_size: int = DEFAULT_MAX_UNTRUSTED_ADVICE_SIZE
    max_output_size: int = DEFAULT_MAX_OUTPUT_SIZE
    stack_size: int = DEFAULT_STACK_SIZE
    memory_size: int = DEFAULT_MEMORY_SIZE
    program_size: int | None = None


@dataclass
class MemoryLayout:
    program_size: int
    max_trusted_advice_size: int
    trusted_advice_start: int
    trusted_advice_end: int
    max_untrusted_advice_size: int
    untrusted_advice_start: int
    untrusted_advice_end: int
    max_input_size: int
    max_output_size: int
    input_start: int
    input_end: int
    output_start: int
    output_end: int
    stack_size: int
    stack_end: int
    memory_size: int
    memory_end: int
    panic_addr: int
    termination: int
    io_end: int

    @classmethod
    def create(cls, config: MemoryConfig) -> "MemoryLayout":
        assert config.program_size is not None, "program_size must be set"
        program_size = config.program_size
        mta = _align_up(config.max_trusted_advice_size, 8)
        mua = _align_up(config.max_untrusted_advice_size, 8)
        mi = _align_up(config.max_input_size, 8)
        mo = _align_up(config.max_output_size, 8)
        stack_size = _align_up(config.stack_size, 8)
        memory_size = _align_up(config.memory_size, 8)
        assert mta == 0 or mta & (mta - 1) == 0
        assert mua == 0 or mua & (mua - 1) == 0

        io_region_bytes = mi + mta + mua + mo + 16
        io_bytes = _ceil_pow2(io_region_bytes // 8) * 8

        if mta >= mua:
            trusted_advice_start = RAM_START_ADDRESS - io_bytes
            trusted_advice_end = trusted_advice_start + mta
            untrusted_advice_start = trusted_advice_end
            untrusted_advice_end = untrusted_advice_start + mua
        else:
            untrusted_advice_start = RAM_START_ADDRESS - io_bytes
            untrusted_advice_end = untrusted_advice_start + mua
            trusted_advice_start = untrusted_advice_end
            trusted_advice_end = trusted_advice_start + mta

        input_start = max(untrusted_advice_end, trusted_advice_end)
        input_end = input_start + mi
        output_start = input_end
        output_end = output_start + mo
        panic_addr = output_end
        termination = panic_addr + 8
        io_end = termination + 8
        stack_end = RAM_START_ADDRESS + program_size
        stack_start = stack_end + stack_size
        memory_end = stack_start + memory_size

        return cls(
            program_size=program_size,
            max_trusted_advice_size=mta,
            trusted_advice_start=trusted_advice_start,
            trusted_advice_end=trusted_advice_end,
            max_untrusted_advice_size=mua,
            untrusted_advice_start=untrusted_advice_start,
            untrusted_advice_end=untrusted_advice_end,
            max_input_size=mi,
            max_output_size=mo,
            input_start=input_start,
            input_end=input_end,
            output_start=output_start,
            output_end=output_end,
            stack_size=stack_size,
            stack_end=stack_end,
            memory_size=memory_size,
            memory_end=memory_end,
            panic_addr=panic_addr,
            termination=termination,
            io_end=io_end,
        )

    def lowest_address(self) -> int:
        return min(self.trusted_advice_start, self.untrusted_advice_start)

    def remap_address(self, address: int) -> int | None:
        """(address - lowest)/8 witness index; None for address 0."""
        if address == 0:
            return None
        low = self.lowest_address()
        assert address >= low, f"unexpected address {address:#x}"
        return (address - low) // 8


@dataclass
class JoltDevice:
    """Captures guest I/O: reads from the input region, writes to the output
    region, the panic and termination bits."""

    layout: MemoryLayout
    inputs: bytearray = field(default_factory=bytearray)
    trusted_advice: bytearray = field(default_factory=bytearray)
    untrusted_advice: bytearray = field(default_factory=bytearray)
    outputs: bytearray = field(default_factory=bytearray)
    panic: bool = False

    def is_input(self, a: int) -> bool:
        return self.layout.input_start <= a < self.layout.input_end

    def is_trusted_advice(self, a: int) -> bool:
        return self.layout.trusted_advice_start <= a < self.layout.trusted_advice_end

    def is_untrusted_advice(self, a: int) -> bool:
        return self.layout.untrusted_advice_start <= a < self.layout.untrusted_advice_end

    def is_output(self, a: int) -> bool:
        return self.layout.output_start <= a < self.layout.termination

    def is_panic(self, a: int) -> bool:
        return self.layout.panic_addr <= a < self.layout.termination

    def is_termination(self, a: int) -> bool:
        return self.layout.termination <= a < self.layout.io_end

    def is_io(self, a: int) -> bool:
        return (self.is_input(a) or self.is_output(a) or self.is_trusted_advice(a)
                or self.is_untrusted_advice(a) or self.is_panic(a) or self.is_termination(a))

    def load(self, a: int) -> int:
        if self.is_panic(a):
            return 1 if self.panic else 0
        if self.is_termination(a):
            return 0
        for pred, buf, start in (
            (self.is_input, self.inputs, self.layout.input_start),
            (self.is_trusted_advice, self.trusted_advice, self.layout.trusted_advice_start),
            (self.is_untrusted_advice, self.untrusted_advice, self.layout.untrusted_advice_start),
            (self.is_output, self.outputs, self.layout.output_start),
        ):
            if pred(a):
                idx = a - start
                return buf[idx] if idx < len(buf) else 0
        assert a <= RAM_START_ADDRESS - 8
        return 0

    def store(self, a: int, value: int) -> None:
        if a == self.layout.panic_addr:
            self.panic = True
            return
        if self.is_panic(a) or self.is_termination(a):
            return
        idx = a - self.layout.output_start
        if len(self.outputs) <= idx:
            self.outputs.extend(b"\x00" * (idx + 1 - len(self.outputs)))
        self.outputs[idx] = value & 0xFF

    # -- file persistence (reference zkvm/mod.zig:1029 device-from-file:
    #    pins the Fiat-Shamir preamble to an externally-produced I/O claim) --

    _MAGIC = b"ZTPD"

    def serialize(self, preamble_memory_size: int | None = None) -> bytes:
        """Device file: layout-defining config + I/O buffers + panic flag.
        Loading it reproduces the exact fiatShamirPreamble inputs.

        preamble_memory_size is the Jolt-config memory size the prover's
        Fiat-Shamir preamble used (NOT the emulator layout's RAM capacity);
        it defaults to the layout value for emulator-only round trips."""
        import struct

        lay = self.layout
        pm = preamble_memory_size if preamble_memory_size is not None else lay.memory_size
        out = [self._MAGIC, struct.pack(
            "<IQQQQQQQQB", 1, lay.program_size, lay.max_input_size,
            lay.max_output_size, lay.memory_size, lay.stack_size,
            lay.max_trusted_advice_size, lay.max_untrusted_advice_size,
            pm, 1 if self.panic else 0)]
        for buf in (self.inputs, self.trusted_advice, self.untrusted_advice,
                    self.outputs):
            out.append(struct.pack("<Q", len(buf)))
            out.append(bytes(buf))
        return b"".join(out)

    @classmethod
    def deserialize(cls, data: bytes) -> "JoltDevice":
        import struct

        assert data[:4] == cls._MAGIC, "bad device-file magic"
        (ver, program_size, mi, mo, mem, stack, mta, mua, preamble_mem,
         panic) = struct.unpack_from("<IQQQQQQQQB", data, 4)
        assert ver == 1, f"unsupported device-file version {ver}"
        off = 4 + struct.calcsize("<IQQQQQQQQB")
        bufs = []
        for _ in range(4):
            (n,) = struct.unpack_from("<Q", data, off)
            off += 8
            bufs.append(bytearray(data[off:off + n]))
            off += n
        layout = MemoryLayout.create(MemoryConfig(
            program_size=program_size, max_input_size=mi, max_output_size=mo,
            memory_size=mem, stack_size=stack, max_trusted_advice_size=mta,
            max_untrusted_advice_size=mua))
        dev = cls(layout=layout, inputs=bufs[0], trusted_advice=bufs[1],
                  untrusted_advice=bufs[2], outputs=bufs[3], panic=panic != 0)
        dev.preamble_memory_size = preamble_mem
        return dev
