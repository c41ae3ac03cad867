"""Native emulator bridge: run the C RV64IMC stepper (native/rv64.c) and
materialize the results into the same Emulator state the Python stepper
produces — trace, RAM access trace, final memory/registers/device — so every
downstream consumer is agnostic to which tier ran.

The Python emulator (vm/emulator.py) stays the semantic oracle; the
differential test (tests/test_native_emu.py) compares both steppers field by
field on the golden guests and randomized programs. Set ZOLT_TPU_NO_NATIVE=1
to force the Python tier.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .state import M64, MemoryAccess

_TRACE_DTYPE = np.dtype([
    ("cycle", "<u8"), ("pc", "<u8"), ("rs1_value", "<u8"), ("rs2_value", "<u8"),
    ("rd_pre_value", "<u8"), ("rd_value", "<u8"), ("memory_addr", "<u8"),
    ("memory_pre_value", "<u8"), ("memory_value", "<u8"), ("next_pc", "<u8"),
    ("instruction", "<u4"), ("has_memory", "u1"), ("has_mem_pre", "u1"),
    ("has_mem_val", "u1"), ("is_memory_write", "u1"), ("is_compressed", "u1"),
    ("_pad", "u1", (7,)),
])
assert _TRACE_DTYPE.itemsize == 96

_MEM_DTYPE = np.dtype([
    ("address", "<u8"), ("pre_value", "<u8"), ("post_value", "<u8"),
    ("timestamp", "<u8"), ("is_write", "u1"), ("_pad", "u1", (7,)),
])
assert _MEM_DTYPE.itemsize == 40


class _RvLayout(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint64) for n in (
        "lowest", "window_end", "input_start", "input_end", "ta_start",
        "ta_end", "ua_start", "ua_end", "output_start", "panic_addr",
        "termination", "io_end", "ram_base", "ram_nwords", "max_cycles")]


class _RvState(ctypes.Structure):
    _fields_ = [
        ("regs", ctypes.c_uint64 * 32),
        ("pc", ctypes.c_uint64), ("prev_pc", ctypes.c_uint64),
        ("cycle", ctypes.c_uint64), ("outputs_len", ctypes.c_uint64),
        ("n_steps", ctypes.c_uint64), ("n_mem", ctypes.c_uint64),
        ("fault_addr", ctypes.c_uint64),
        ("ecall_pc", ctypes.c_uint64), ("ecall_rs1", ctypes.c_uint64),
        ("ecall_rs2", ctypes.c_uint64), ("ecall_cycle", ctypes.c_uint64),
        ("ecall_instr", ctypes.c_uint32),
        ("panic", ctypes.c_uint8), ("term_kind", ctypes.c_uint8),
        ("_pad", ctypes.c_uint8 * 2),
    ]


RV_DONE, RV_AGAIN_TRACE, RV_AGAIN_MEM = 0, 1, 2
RV_MAX_CYCLES, RV_FAULT, RV_BAD_PC, RV_BAD_STORE = 3, 4, 5, 6


def _lib():
    if os.environ.get("ZOLT_TPU_NO_NATIVE"):
        return None
    from ..native import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "rv64_run"):
        return None
    if not getattr(lib, "_rv64_configured", False):
        lib.rv64_run.argtypes = [
            ctypes.POINTER(_RvLayout), ctypes.c_void_p,
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_void_p, ctypes.POINTER(_RvState),
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
            ctypes.c_uint64]
        lib.rv64_run.restype = ctypes.c_int
        lib._rv64_configured = True
    return lib


class LazyList(list):
    """List whose contents build on first *content* access. `known_len` lets
    len()/bool() answer without building (the pipeline asks len(ram.trace)
    before any iteration)."""

    def __init__(self, build, known_len: int):
        super().__init__()
        self._build = build
        self._known_len = known_len

    def _ensure(self):
        if self._build is not None:
            b, self._build = self._build, None
            self.extend(b())

    def __len__(self):
        if self._build is not None:
            return self._known_len
        return super().__len__()

    def __bool__(self):
        return len(self) > 0

    def __iter__(self):
        self._ensure()
        return super().__iter__()

    def __getitem__(self, i):
        self._ensure()
        return super().__getitem__(i)

    def __reversed__(self):
        self._ensure()
        return super().__reversed__()

    def __eq__(self, other):
        self._ensure()
        return list(self) == other

    def __hash__(self):
        return id(self)

    def clear(self):
        self._build = None          # cancel the pending build too
        self._known_len = 0
        super().clear()

    def append(self, x):
        self._ensure()
        super().append(x)

    def extend(self, xs):
        self._ensure()
        super().extend(xs)

    def insert(self, i, x):
        self._ensure()
        super().insert(i, x)

    def pop(self, *a):
        self._ensure()
        return super().pop(*a)

    def remove(self, x):
        self._ensure()
        super().remove(x)

    def __setitem__(self, i, v):
        self._ensure()
        super().__setitem__(i, v)

    def __delitem__(self, i):
        self._ensure()
        super().__delitem__(i)

    def __contains__(self, x):
        self._ensure()
        return super().__contains__(x)

    def index(self, *a):
        self._ensure()
        return super().index(*a)

    def count(self, x):
        self._ensure()
        return super().count(x)

    def __add__(self, other):
        self._ensure()
        return list(self) + other

    def copy(self):
        self._ensure()
        return list(self)

    def sort(self, **kw):
        self._ensure()
        super().sort(**kw)

    def reverse(self):
        self._ensure()
        super().reverse()


def _program_has_div(emu) -> bool:
    """Static scan of the loaded image for div-family words (RV64M divide /
    remainder, incl. the C-extension — RVC has no div encodings, so only
    4-byte words can match). Conservative: a data word that happens to look
    like a div also routes to the Python tier, which is merely slower."""
    mem = emu.ram.memory
    for a, w in mem.items():
        for half in (w & 0xFFFFFFFF, w >> 32):
            if (half & 0x7F) in (0x33, 0x3B) and ((half >> 25) & 0x7F) == 1 \
                    and ((half >> 12) & 0x7) >= 4:
                return True
        # 4-byte instructions can straddle word boundaries after a 2-byte
        # compressed one; check the middle alignment too
        nxt = mem.get(a + 8, 0)
        mid = ((w >> 16) | (nxt << 48)) & 0xFFFFFFFF
        if (mid & 0x7F) in (0x33, 0x3B) and ((mid >> 25) & 0x7F) == 1 \
                and ((mid >> 12) & 0x7) >= 4:
            return True
    return False


def run_native(emu, max_cycles: int) -> bool:
    """Run `emu` to termination with the C stepper. Returns False when the
    native tier is unavailable or the program needs the Python fallback
    (fetch outside the RAM array). Raises the same exceptions as
    Emulator.run on faults/budget."""
    lib = _lib()
    if lib is None:
        return False
    if emu.trace or emu.cycle:
        return False  # mid-run resume not supported; Python path handles it
    if emu.expand_virtual and _program_has_div(emu):
        # virtual-sequence expansion (vm/virtual.py) is Python-tier only;
        # div-free programs still take the native stepper
        return False

    lay = emu.device.layout
    lowest = lay.lowest_address()
    window_end = lowest + 8 * emu.ram_k_words

    # RAM word array covering the provable window plus the loaded image
    img_words = emu.ram.memory
    top = max([window_end] + [a + 8 for a in img_words]) if img_words else window_end
    base = lowest & ~7
    nwords = (top - base + 7) // 8
    if nwords > (1 << 26):  # 512 MB guard: fall back rather than overallocate
        return False
    ram = np.zeros(nwords, dtype=np.uint64)
    if img_words:
        idx = np.fromiter(((a - base) >> 3 for a in img_words), dtype=np.int64,
                          count=len(img_words))
        vals = np.fromiter((v for v in img_words.values()), dtype=np.uint64,
                           count=len(img_words))
        ram[idx] = vals

    clay = _RvLayout(
        lowest=lowest, window_end=window_end,
        input_start=lay.input_start, input_end=lay.input_end,
        ta_start=lay.trusted_advice_start, ta_end=lay.trusted_advice_end,
        ua_start=lay.untrusted_advice_start, ua_end=lay.untrusted_advice_end,
        output_start=lay.output_start, panic_addr=lay.panic_addr,
        termination=lay.termination, io_end=lay.io_end,
        ram_base=base, ram_nwords=nwords, max_cycles=max_cycles)

    st = _RvState()
    for i, v in enumerate(emu.registers.registers[:32]):
        st.regs[i] = v
    st.pc = emu.pc
    st.prev_pc = emu.prev_pc

    outputs_cap = max(1, lay.termination - lay.output_start)
    outputs = np.zeros(outputs_cap, dtype=np.uint8)
    dev = emu.device
    outputs[:len(dev.outputs)] = np.frombuffer(bytes(dev.outputs), np.uint8)
    st.outputs_len = len(dev.outputs)
    st.panic = 1 if dev.panic else 0

    inputs = bytes(dev.inputs)
    tadv = bytes(dev.trusted_advice)
    uadv = bytes(dev.untrusted_advice)

    trace_cap = 1 << 16
    mem_cap = 1 << 17
    trace_buf = np.zeros(trace_cap, dtype=_TRACE_DTYPE)
    mem_buf = np.zeros(mem_cap, dtype=_MEM_DTYPE)

    while True:
        rc = lib.rv64_run(
            ctypes.byref(clay), ram.ctypes.data_as(ctypes.c_void_p),
            inputs, len(inputs), tadv, len(tadv), uadv, len(uadv),
            outputs.ctypes.data_as(ctypes.c_void_p), ctypes.byref(st),
            trace_buf.ctypes.data_as(ctypes.c_void_p), trace_cap,
            mem_buf.ctypes.data_as(ctypes.c_void_p), mem_cap)
        if rc == RV_AGAIN_TRACE:
            # grow via raw-byte copy: structured-dtype slice assignment is
            # per-field (slow); uint8 views memcpy
            trace_cap *= 4
            nt = np.zeros(trace_cap, dtype=_TRACE_DTYPE)
            nbytes = int(st.n_steps) * _TRACE_DTYPE.itemsize
            nt.view(np.uint8)[:nbytes] = trace_buf.view(np.uint8)[:nbytes]
            trace_buf = nt
        elif rc == RV_AGAIN_MEM:
            mem_cap *= 4
            nm = np.zeros(mem_cap, dtype=_MEM_DTYPE)
            nbytes = int(st.n_mem) * _MEM_DTYPE.itemsize
            nm.view(np.uint8)[:nbytes] = mem_buf.view(np.uint8)[:nbytes]
            mem_buf = nm
        elif rc in (RV_BAD_PC, RV_BAD_STORE):
            return False  # Python fallback reproduces exact behavior
        elif rc == RV_FAULT:
            from .emulator import MemoryFault

            a = st.fault_addr
            raise MemoryFault(
                f"guest memory access at {a:#x} is outside the provable RAM "
                f"window [{lowest:#x}, {window_end:#x}) "
                f"(sign-extended address? materialize RAM pointers "
                f"PC-relatively or with Asm.li_addr)")
        elif rc == RV_MAX_CYCLES:
            raise RuntimeError("max cycle budget exceeded")
        else:
            break

    # ---- materialize results back into the Emulator ----------------------
    from .emulator import TraceStep

    from ..native import get_trace_lib

    n = int(st.n_steps)
    t = trace_buf[:n]
    tmat = get_trace_lib()
    if tmat is not None:
        emu.trace = tmat.trace_materialize(
            TraceStep, trace_buf.ctypes.data_as(ctypes.c_void_p), n)
    else:
        cols = [t["cycle"].tolist(), t["pc"].tolist(), t["instruction"].tolist(),
                t["rs1_value"].tolist(), t["rs2_value"].tolist(),
                t["rd_pre_value"].tolist(), t["rd_value"].tolist(),
                t["memory_addr"].tolist(), t["memory_pre_value"].tolist(),
                t["memory_value"].tolist(), t["has_memory"].tolist(),
                t["has_mem_pre"].tolist(), t["has_mem_val"].tolist(),
                t["is_memory_write"].tolist(), t["next_pc"].tolist(),
                t["is_compressed"].tolist()]
        emu.trace = [
            TraceStep(cy, pc, pc, ins, r1, r2, rp, rv,
                      ma if hm else None, mp if hp else None, mv if hv else None,
                      bool(w), npc, bool(ic))
            for cy, pc, ins, r1, r2, rp, rv, ma, mp, mv, hm, hp, hv, w, npc, ic
            in zip(*cols)]

    if n and emu.trace:
        # Seed the witness-column memo straight from the structured trace
        # buffer: witness gen / stage-4 / the commitment builders all call
        # r1cs.inputs._steps_to_arrays on this exact real-trace prefix, and
        # the Python fallback there re-extracts every field through 4M-step
        # attribute loops (~10 s/Mcycle). The native emulator already holds
        # the columns as one contiguous structured array — copy each field
        # out (stride-96 view -> contiguous) and register it. Values are
        # differentially tested against the Python path in
        # tests/test_witness_columns.py::test_native_trace_seeds_arrays.
        from ..r1cs import inputs as _ri

        _u64 = np.uint64
        _cols = {
            "instruction": t["instruction"].astype(_u64),
            "pc": np.ascontiguousarray(t["pc"]),
            "unexpanded_pc": np.ascontiguousarray(t["pc"]),  # no virtual seqs
            "rs1_value": np.ascontiguousarray(t["rs1_value"]),
            "rs2_value": np.ascontiguousarray(t["rs2_value"]),
            "rd_value": np.ascontiguousarray(t["rd_value"]),
            "rd_pre_value": np.ascontiguousarray(t["rd_pre_value"]),
            "memory_value": np.where(t["has_mem_val"] != 0,
                                     t["memory_value"], _u64(0)),
            "memory_pre_value": np.where(t["has_mem_pre"] != 0,
                                         t["memory_pre_value"], _u64(0)),
            "memory_addr": np.where(t["has_memory"] != 0,
                                    t["memory_addr"], _u64(0)),
            "_has_addr": np.ascontiguousarray(t["has_memory"]),
            "_is_write": np.ascontiguousarray(t["is_memory_write"]),
        }
        _comp = np.ascontiguousarray(t["is_compressed"])
        _has_pre = np.ascontiguousarray(t["has_mem_pre"])
        for _a in list(_cols.values()) + [_comp, _has_pre]:
            _a.setflags(write=False)
        _ri._ARR_MEMO[:] = [(emu.trace[0], n, (_cols, _comp, _has_pre))]

    nm = int(st.n_mem)
    m = mem_buf[:nm]  # view; mem_buf stays alive via the closure below

    def _build_mem_trace():
        lib2 = get_trace_lib()
        if lib2 is not None:
            return lib2.mem_materialize(
                MemoryAccess, mem_buf.ctypes.data_as(ctypes.c_void_p), nm)
        ops = ["read", "write"]
        return [MemoryAccess(ops[w], a, pre, post, ts)
                for w, a, pre, post, ts in zip(
                    m["is_write"].tolist(), m["address"].tolist(),
                    m["pre_value"].tolist(), m["post_value"].tolist(),
                    m["timestamp"].tolist())]

    emu.ram.trace = LazyList(_build_mem_trace, nm)

    # final memory dict: initial entries + every written word's final value.
    # The synthetic termination record is the only I/O-region write record
    # and must NOT enter the dict (Python record_write never touches memory).
    wmask = (m["is_write"] != 0) & (m["address"] < window_end) \
        & (m["address"] >= lowest) & (m["address"] != lay.termination)
    waddrs = np.unique(m["address"][wmask])
    final_words = ram[((waddrs - base) >> np.uint64(3)).astype(np.int64)]
    emu.ram.memory.update(zip(waddrs.tolist(), final_words.tolist()))

    emu.registers.registers = [int(st.regs[i]) for i in range(32)] + [0] * 96
    emu.registers.timestamp = int(st.cycle)
    emu.pc = int(st.pc)
    emu.prev_pc = int(st.prev_pc)
    emu.cycle = int(st.cycle)
    dev.outputs = bytearray(outputs[: int(st.outputs_len)].tobytes())
    dev.panic = bool(st.panic)

    term_kind = int(st.term_kind)

    def _build_lookups():
        from . import decode as dec_mod
        from .lookups import record_lookup_entry

        out = []
        for s in emu.trace:
            e = record_lookup_entry(s.cycle, s.pc, dec_mod.decode(s.instruction),
                                    s.rs1_value, s.rs2_value)
            if e is not None:
                out.append(e)
        if term_kind == 1:  # terminating ECALL records a lookup, not a step
            e = record_lookup_entry(int(st.ecall_cycle), int(st.ecall_pc),
                                    dec_mod.decode(int(st.ecall_instr)),
                                    int(st.ecall_rs1), int(st.ecall_rs2))
            if e is not None:
                out.append(e)
        return out

    n_lookups = n + (1 if term_kind == 1 else 0)
    emu.lookup_entries = LazyList(_build_lookups, n_lookups)
    return True
