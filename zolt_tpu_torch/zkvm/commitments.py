"""Dory commitment phase of the Jolt-format proof.

Builds the 2 + instruction_d + ram_d + bytecode_d committed polynomials from
the execution trace, commits each with Dory (GT elements), absorbs them into
the transcript, and derives τ — mirroring the reference prove pipeline
(src/zkvm/mod.zig:780-1010).

Committed polys (reference src/zkvm/mod.zig:1627-1790):
  RdInc[i]          = rd post - pre at cycle i (0 when rd==x0)
  RamInc[i]         = memory post - pre at cycle i (0 when not a write)
  InstructionRa_d[i]= 4-bit chunk d of the 128-bit lookup index of entry i
  RamRa_d[i]        = 4-bit chunk d of the raw memory address at cycle i
  BytecodeRa_d[i]   = 4-bit chunk d of the pc at cycle i

The per-instruction 128-bit lookup indices follow the reference's
LookupTraceCollector dispatch (src/zkvm/instruction/lookup_trace.zig:801-1020)
and per-class toLookupIndex rules (src/zkvm/instruction/lookups.zig).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

import numpy as np

from ..field.params import FR
from ..pcs import dory
from ..vm.tables import interleave_bits

P = FR.p
M64 = (1 << 64) - 1
M32 = 0xFFFFFFFF

LOG_K_INSTRUCTION = 128
LOG_K_CHUNK = 4


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _sext32(v: int) -> int:
    v &= M32
    return v | (0xFFFFFFFF00000000 if v & 0x80000000 else 0)


def _s64(v: int) -> int:
    v &= M64
    return v - (1 << 64) if v >> 63 else v


# ---------------------------------------------------------------------------
# Lookup index catalog (reference lookups.zig toLookupIndex per class)
# ---------------------------------------------------------------------------

def jolt_lookup_index(step) -> int | None:
    """128-bit lookup index for a trace step, or None if the reference
    collector records no entry for this opcode class."""
    instr = step.instruction
    opcode = instr & 0x7F
    funct3 = (instr >> 12) & 0x7
    funct7 = (instr >> 25) & 0x7F
    rs1 = step.rs1_value & M64
    rs2 = step.rs2_value & M64

    if opcode == 0x33:  # OP
        if funct7 == 1:  # M extension
            if funct3 == 0:    # MUL
                return (rs1 * rs2) & M64
            if funct3 == 1:    # MULH
                return ((_s64(rs1) * _s64(rs2)) >> 64) & M64
            if funct3 == 2:    # MULHSU
                return ((_s64(rs1) * rs2) >> 64) & M64
            if funct3 == 3:    # MULHU
                return (rs1 * rs2) >> 64
            if funct3 == 4:    # DIV
                return interleave_bits(rs2, _div_signed(rs1, rs2))
            if funct3 == 5:    # DIVU
                return interleave_bits(rs2, (M64 if rs2 == 0 else rs1 // rs2))
            if funct3 == 6:    # REM
                return interleave_bits(_rem_signed(rs1, rs2), rs2)
            if funct3 == 7:    # REMU
                return interleave_bits((rs1 if rs2 == 0 else rs1 % rs2), rs2)
        if funct3 == 0:
            if funct7 & 0x20:  # SUB
                return interleave_bits(rs1, rs2)
            return (rs1 + rs2) & M64  # ADD -> index = result
        # AND/OR/XOR/SLT/SLTU/SLL/SRL/SRA all interleave the raw operands
        return interleave_bits(rs1, rs2)

    if opcode == 0x13:  # OP_IMM
        imm = _i_imm(instr)
        if funct3 == 0:  # ADDI
            return (rs1 + imm) & M64
        if funct3 in (1, 5):  # SLLI / SRLI / SRAI: shamt = imm_u32 & 0x3F
            shamt = (imm & M32) & 0x3F
            return interleave_bits(rs1, shamt)
        # ANDI/ORI/XORI/SLTI/SLTIU
        return interleave_bits(rs1, imm)

    if opcode == 0x63:  # BRANCH
        return interleave_bits(rs1, rs2)

    if opcode == 0x3B:  # OP_32
        if funct7 == 1:
            if funct3 == 0:   # MULW
                return _sext32(rs1 * rs2)
            if funct3 == 4:   # DIVW
                return interleave_bits(rs2 & M32, _divw_signed(rs1, rs2) & M32)
            if funct3 == 5:   # DIVUW
                a, b = rs1 & M32, rs2 & M32
                q = M32 if b == 0 else a // b
                return interleave_bits(rs2 & M32, q & M32)
            if funct3 == 6:   # REMW
                return interleave_bits(_remw_signed(rs1, rs2) & M32, rs2 & M32)
            if funct3 == 7:   # REMUW
                a, b = rs1 & M32, rs2 & M32
                r = a if b == 0 else a % b
                return interleave_bits(r & M32, rs2 & M32)
            return _sext32(rs1 + rs2)  # fallback -> Addw
        if funct3 == 0:
            if funct7 & 0x20:  # SUBW
                return interleave_bits(rs1 & M32, rs2 & M32)
            return _sext32(rs1 + rs2)  # ADDW -> index = sign-extended result
        if funct3 in (1, 5):  # SLLW/SRLW/SRAW
            return interleave_bits(rs1 & M32, rs2 & 0x1F)
        return _sext32(rs1 + rs2)  # fallback

    if opcode == 0x37:  # LUI -> index = sign-extended imm
        return _u_imm(instr) & M64
    if opcode == 0x17:  # AUIPC -> index = pc + imm
        return (step.pc + _u_imm(instr)) & M64
    if opcode == 0x6F:  # JAL -> index = return address pc+4
        return (step.pc + 4) & M64
    if opcode == 0x67:  # JALR -> index = return address pc+4
        return (step.pc + 4) & M64
    return None  # LOAD/STORE/OP_IMM_32/SYSTEM: no lookup entry


def _i_imm(instr: int) -> int:
    imm = instr >> 20
    if imm & 0x800:
        imm -= 1 << 12
    return imm & M64


def _u_imm(instr: int) -> int:
    imm = instr & 0xFFFFF000
    if imm & 0x80000000:
        imm |= ~M32 & M64  # sign-extend bit 31
    return imm & M64


def _div_signed(rs1: int, rs2: int) -> int:
    a, b = _s64(rs1), _s64(rs2)
    if b == 0:
        return M64  # -1
    if a == -(1 << 63) and b == -1:
        return rs1
    q = abs(a) // abs(b)
    if (a < 0) != (b < 0):
        q = -q
    return q & M64


def _rem_signed(rs1: int, rs2: int) -> int:
    a, b = _s64(rs1), _s64(rs2)
    if b == 0:
        return rs1
    if a == -(1 << 63) and b == -1:
        return 0
    r = abs(a) % abs(b)
    if a < 0:
        r = -r
    return r & M64


def _divw_signed(rs1: int, rs2: int) -> int:
    a = _sext32(rs1)
    b = _sext32(rs2)
    sa = a - (1 << 64) if a >> 63 else a
    sb = b - (1 << 64) if b >> 63 else b
    sa, sb = (sa & M32) - (1 << 32) if (sa & M32) >> 31 else sa & M32, \
             (sb & M32) - (1 << 32) if (sb & M32) >> 31 else sb & M32
    if sb == 0:
        return M32
    if sa == -(1 << 31) and sb == -1:
        return sa & M32
    q = abs(sa) // abs(sb)
    if (sa < 0) != (sb < 0):
        q = -q
    return q & M32


def _remw_signed(rs1: int, rs2: int) -> int:
    sa = (rs1 & M32) - (1 << 32) if (rs1 & M32) >> 31 else rs1 & M32
    sb = (rs2 & M32) - (1 << 32) if (rs2 & M32) >> 31 else rs2 & M32
    if sb == 0:
        return rs1 & M32
    if sa == -(1 << 31) and sb == -1:
        return 0
    r = abs(sa) % abs(sb)
    if sa < 0:
        r = -r
    return r & M32


# ---------------------------------------------------------------------------
# Committed polynomial builders
# ---------------------------------------------------------------------------

def _real_arrays(steps, size: int):
    """(arrays, n) over the real-trace prefix clipped to `size` — the
    memoized numpy scan shared with witness gen (r1cs.inputs)."""
    from ..r1cs.inputs import _steps_to_arrays

    n_real = next((i for i, s in enumerate(steps)
                   if getattr(s, "is_noop", False)), len(steps))
    arrs, _c, _hp = _steps_to_arrays(steps[:n_real])
    return arrs, min(n_real, size)


def build_rd_inc(steps, size: int):
    """RdInc as an FrVec (wrap-signed u64 deltas ingest as i128 lanes)."""
    from ..native.frvec import FrVec

    arrs, n = _real_arrays(steps, size)
    u = np.uint64
    instr = arrs["instruction"][:n]
    opcode = instr & u(0x7F)
    # 7-bit rd: virtual rows (vm/virtual.py) write scratch registers x32..
    rd = ((instr >> u(7)) & u(0x1F)) | (((instr >> u(32)) & u(3)) << u(5))
    keep = (opcode != u(0x23)) & (opcode != u(0x63)) & (rd != u(0))
    post = np.where(keep, arrs["rd_value"][:n], u(0))
    pre = np.where(keep, arrs["rd_pre_value"][:n], u(0))
    lo = np.zeros(size, u)
    hi = np.zeros(size, np.int64)
    lo[:n] = post - pre                      # u64 wrap; sign via hi
    hi[:n] = np.where(post < pre, np.int64(-1), np.int64(0))
    return FrVec.from_i128_arrays(lo, hi)


def build_ram_inc(steps, size: int):
    from ..native.frvec import FrVec

    arrs, n = _real_arrays(steps, size)
    u = np.uint64
    w = arrs["_is_write"][:n] != 0
    post = np.where(w, arrs["memory_value"][:n], u(0))
    pre = np.where(w, arrs["memory_pre_value"][:n], u(0))
    lo = np.zeros(size, u)
    hi = np.zeros(size, np.int64)
    lo[:n] = post - pre
    hi[:n] = np.where(post < pre, np.int64(-1), np.int64(0))
    return FrVec.from_i128_arrays(lo, hi)


def jolt_lookup_indices(steps) -> list[int]:
    """Recorded lookup indices in trace order (collector parity) — the
    per-step oracle; production uses the vectorized jolt_lookup_lo_hi
    (differentially tested in tests/test_witness_columns.py)."""
    out = []
    for s in steps:
        if getattr(s, "is_noop", False):
            continue
        idx = jolt_lookup_index(s)
        if idx is not None:
            out.append(idx)
    return out


def _spread32_np(x):
    """Spread each u64 lane's low 32 bits to even positions (Morton)."""
    u = np.uint64
    x = (x | (x << u(16))) & u(0x0000FFFF0000FFFF)
    x = (x | (x << u(8))) & u(0x00FF00FF00FF00FF)
    x = (x | (x << u(4))) & u(0x0F0F0F0F0F0F0F0F)
    x = (x | (x << u(2))) & u(0x3333333333333333)
    x = (x | (x << u(1))) & u(0x5555555555555555)
    return x


def _interleave_np(x, y):
    """Vectorized interleave_bits: x to odd bit positions, y to even;
    returns (lo64, hi64) of the 128-bit Morton index."""
    u = np.uint64
    lo = (_spread32_np(x & u(M32)) << u(1)) | _spread32_np(y & u(M32))
    hi = (_spread32_np(x >> u(32)) << u(1)) | _spread32_np(y >> u(32))
    return lo, hi


def jolt_lookup_lo_hi(steps):
    """Vectorized jolt_lookup_indices: (lo, hi) uint64 arrays of the
    recorded 128-bit lookup indices in trace order. The common opcode
    classes compute in numpy; the M-extension rows (wide products,
    signed division edge cases) fall back to the per-step oracle."""
    from ..r1cs.inputs import _steps_to_arrays

    n_real = next((i for i, s in enumerate(steps)
                   if getattr(s, "is_noop", False)), len(steps))
    real = steps[:n_real]
    if n_real == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    arrs, _comp, _hp = _steps_to_arrays(real)
    u = np.uint64
    instr = arrs["instruction"]
    pc = arrs["pc"]
    rs1 = arrs["rs1_value"]
    rs2 = arrs["rs2_value"]
    opcode = instr & u(0x7F)
    f3 = (instr >> u(12)) & u(7)
    f7 = (instr >> u(25)) & u(0x7F)
    # I-imm / U-imm, sign-extended into u64 two's complement
    i_imm = instr >> u(20)
    i_imm = np.where(i_imm & u(0x800), i_imm | u(0xFFFFFFFFFFFFF000), i_imm)
    u_imm = instr & u(0xFFFFF000)
    u_imm = np.where(u_imm & u(0x80000000),
                     u_imm | u(0xFFFFFFFF00000000), u_imm)

    lo = np.zeros(n_real, u)
    hi = np.zeros(n_real, u)
    keep = np.zeros(n_real, bool)
    fallback = np.zeros(n_real, bool)

    def put(mask, vlo, vhi=None):
        lo[mask] = vlo[mask] if isinstance(vlo, np.ndarray) else vlo
        if vhi is not None:
            hi[mask] = vhi[mask]
        keep[mask] = True

    il_lo, il_hi = _interleave_np(rs1, rs2)
    m_op = opcode == u(0x33)
    fallback |= m_op & (f7 == u(1))                      # M extension
    m = m_op & (f7 != u(1)) & (f3 == u(0)) & ((f7 & u(0x20)) == u(0))
    put(m, rs1 + rs2)                                    # ADD
    m = m_op & (f7 != u(1)) & ~((f3 == u(0)) & ((f7 & u(0x20)) == u(0)))
    put(m, il_lo, il_hi)                                 # SUB/logic/cmp/shift

    m_imm = opcode == u(0x13)
    m = m_imm & (f3 == u(0))
    put(m, rs1 + i_imm)                                  # ADDI
    sh_lo, sh_hi = _interleave_np(rs1, i_imm & u(0x3F))
    m = m_imm & ((f3 == u(1)) | (f3 == u(5)))
    put(m, sh_lo, sh_hi)                                 # SLLI/SRLI/SRAI
    ii_lo, ii_hi = _interleave_np(rs1, i_imm)
    m = m_imm & ~((f3 == u(0)) | (f3 == u(1)) | (f3 == u(5)))
    put(m, ii_lo, ii_hi)                                 # ANDI/ORI/XORI/SLTI(U)

    put(opcode == u(0x63), il_lo, il_hi)                 # branches

    m32 = opcode == u(0x3B)
    fallback |= m32 & (f7 == u(1))                       # M-ext word ops
    sext = rs1 + rs2
    sext = np.where(sext & u(0x80000000),
                    (sext & u(M32)) | u(0xFFFFFFFF00000000), sext & u(M32))
    sw_lo, sw_hi = _interleave_np(rs1 & u(M32), rs2 & u(M32))
    m = m32 & (f7 != u(1)) & (f3 == u(0)) & ((f7 & u(0x20)) != u(0))
    put(m, sw_lo, sw_hi)                                 # SUBW
    m = m32 & (f7 != u(1)) & (f3 == u(0)) & ((f7 & u(0x20)) == u(0))
    put(m, sext)                                         # ADDW
    shw_lo, shw_hi = _interleave_np(rs1 & u(M32), rs2 & u(0x1F))
    m = m32 & (f7 != u(1)) & ((f3 == u(1)) | (f3 == u(5)))
    put(m, shw_lo, shw_hi)                               # SLLW/SRLW/SRAW
    m = m32 & (f7 != u(1)) & ~((f3 == u(0)) | (f3 == u(1)) | (f3 == u(5)))
    put(m, sext)                                         # fallback -> Addw

    put(opcode == u(0x37), u_imm)                        # LUI
    put(opcode == u(0x17), pc + u_imm)                   # AUIPC
    put(opcode == u(0x6F), pc + u(4))                    # JAL
    put(opcode == u(0x67), pc + u(4))                    # JALR

    for i in np.flatnonzero(fallback):
        idx = jolt_lookup_index(real[int(i)])
        if idx is not None:
            lo[i] = idx & M64
            hi[i] = idx >> 64
            keep[i] = True
    return lo[keep], hi[keep]


def build_instruction_ra(indices: list[int], size: int, shift: int) -> list[int]:
    mask = (1 << LOG_K_CHUNK) - 1
    poly = [0] * size
    for i, idx in enumerate(indices):
        if i >= size:
            break
        poly[i] = (idx >> shift) & mask
    return poly


def build_instruction_ra_all(indices: list[int], size: int, d: int) -> list[list[int]]:
    """All d chunk polys in one pass: split each 128-bit index into two u64
    numpy lanes once, then every chunk extraction is a vector shift+mask.
    Chunk shifts are multiples of LOG_K_CHUNK and 64 % LOG_K_CHUNK == 0, so
    no chunk straddles the u64 boundary. Matches build_instruction_ra."""
    n = min(len(indices), size)
    m64 = (1 << 64) - 1
    lo = np.fromiter((idx & m64 for idx in indices[:n]), dtype=np.uint64, count=n)
    hi = np.fromiter((idx >> 64 for idx in indices[:n]), dtype=np.uint64, count=n)
    return build_instruction_ra_lohi(lo, hi, size, d)


def build_instruction_ra_lohi(lo, hi, size: int, d: int) -> list[list[int]]:
    """build_instruction_ra_all from the vectorized (lo, hi) index lanes."""
    n = min(len(lo), size)
    lo, hi = lo[:n], hi[:n]
    mask = np.uint64((1 << LOG_K_CHUNK) - 1)
    pad = [0] * (size - n)
    out = []
    for j in range(d):
        shift = LOG_K_CHUNK * (d - 1 - j)
        src = hi if shift >= 64 else lo
        s = np.uint64(shift - 64 if shift >= 64 else shift)
        out.append(((src >> s) & mask).tolist() + pad)
    return out


def build_instruction_ra_u8(lo, hi, size: int, d: int) -> list[np.ndarray]:
    """build_instruction_ra_lohi as compact uint8 arrays — the wire form of
    the device row-MSM tier (msm/rows_device.py); values < 16."""
    n = min(len(lo), size)
    mask = np.uint64((1 << LOG_K_CHUNK) - 1)
    out = []
    for j in range(d):
        shift = LOG_K_CHUNK * (d - 1 - j)
        src = hi if shift >= 64 else lo
        s = np.uint64(shift - 64 if shift >= 64 else shift)
        a = np.zeros(size, np.uint8)
        a[:n] = ((src[:n] >> s) & mask).astype(np.uint8)
        out.append(a)
    return out


def build_ram_ra_u8(steps, size: int, shift: int) -> np.ndarray:
    arrs, n = _real_arrays(steps, size)
    u = np.uint64
    out = np.zeros(size, np.uint8)
    ha = arrs["_has_addr"][:n] != 0
    out[:n] = np.where(
        ha, (arrs["memory_addr"][:n] >> u(shift)) & u((1 << LOG_K_CHUNK) - 1),
        u(0)).astype(np.uint8)
    return out


def build_ram_ra(steps, size: int, shift: int):
    from ..native.frvec import FrVec

    return FrVec.from_u64_array(
        build_ram_ra_u8(steps, size, shift).astype(np.uint64))


def ram_ra_onehot_positions(steps, size: int, shift: int, start_address: int,
                            log_ram_k: int) -> np.ndarray:
    """Sound mode: one-hot positions of RamRa chunk `shift` over the
    (chunk-value × cycle) cube, flat index k_d·size + j. Chunks the
    word-SLOT index (addr − start)/8 — the stage-2 RWC/RAF address space —
    with zero rows on cycles without a RAM access (see stage67.py)."""
    arrs, n = _real_arrays(steps, size)
    u = np.uint64
    mask = u((1 << LOG_K_CHUNK) - 1)
    n_vars = size.bit_length() - 1
    ha = arrs["_has_addr"][:n] != 0
    addr = arrs["memory_addr"][:n]
    valid = ha & (addr >= u(start_address))
    k = np.where(valid, (addr - u(start_address)) >> u(3), u(0))
    valid &= k < u(1 << log_ram_k)
    j = np.flatnonzero(valid)
    kv = ((k[j] >> u(shift)) & mask).astype(np.int64)
    return (kv << np.int64(n_vars)) | j


def build_ram_ra_onehot(steps, size: int, shift: int, start_address: int,
                        log_ram_k: int):
    """Sound mode: the one-hot chunk indicator over the (chunk-value ×
    cycle) cube at ram_ra_onehot_positions, as an FrVec."""
    from ..native.frvec import FrVec

    pos = ram_ra_onehot_positions(steps, size, shift, start_address,
                                  log_ram_k)
    return FrVec.indicator((1 << LOG_K_CHUNK) * size, pos)


def build_bytecode_ra_u8(steps, size: int, shift: int) -> np.ndarray:
    """Bytecode chunk poly values. NOTE: unlike the other builders, noop
    padding rows carry the halt pc, so this one spans the PADDED trace."""
    mask = (1 << LOG_K_CHUNK) - 1
    n = min(len(steps), size)
    pcs = np.fromiter(((s.pc >> shift) & mask for s in steps[:n]),
                      np.uint64, n)
    out = np.zeros(size, np.uint8)
    out[:n] = pcs.astype(np.uint8)
    return out


def build_bytecode_ra(steps, size: int, shift: int):
    from ..native.frvec import FrVec

    return FrVec.from_u64_array(
        build_bytecode_ra_u8(steps, size, shift).astype(np.uint64))


# ---------------------------------------------------------------------------
# Commitment phase driver
# ---------------------------------------------------------------------------

@dataclass
class CommitmentPhase:
    commitments: list[bytes] = dfield(default_factory=list)  # 384B GT each
    instruction_d: int = 0
    ram_d: int = 0
    bytecode_d: int = 0
    bytecode_poly_size: int = 0
    memory_poly_size: int = 0
    reg_poly_size: int = 0
    # sound mode: PCS-binding layout (see pcs/batch.py)
    srs: object = None
    global_num_vars: int = 0
    polys: list | None = None


def sound_layout_num_vars(trace_length: int, bytecode_len: int) -> int:
    """Global (even) num_vars of the sound-mode commitment layout: every
    committed poly is laid out as a 2^{N/2} × 2^{N/2} Dory matrix so GT
    commitments are γ-RLC-homomorphic for the batch opening. Must cover the
    one-hot RamRa chunk cubes (2^LOG_K_CHUNK × trace)."""
    reg_size = _next_pow2(max(trace_length, 2))
    bc_size = _next_pow2(max(bytecode_len, 2))
    n = max(reg_size, bc_size).bit_length() - 1
    n = max(n, (reg_size.bit_length() - 1) + LOG_K_CHUNK)
    return n + (n & 1)


# The smallest small-scalar poly the device row tier commits (the JAX
# package's ZOLT_TPU_DEVICE_COMMIT_MIN default): below it the host C tier's
# row MSMs take microseconds.
DEVICE_COMMIT_MIN = 1 << 14


def _device_rows(srs, small: list, device, num_vars: int | None = None,
                 nplanes: int = 4) -> dict:
    """Row commitments of the uint8 chunk polys of at least
    DEVICE_COMMIT_MIN entries, by the subset-sum tier on `device`
    (msm/rows_device.py), one call a matrix width: {poly index: rows}.
    The matrix dims are row_commitments': per poly (compat) or the global
    cube's (sound, num_vars given). Nothing falls back: a failure raises."""
    from ..msm import rows_device

    groups: dict[int, list[int]] = {}
    for i, sm in enumerate(small):
        if sm is None or len(sm) < DEVICE_COMMIT_MIN:
            continue
        sigma = (dory._matrix_dims(len(sm))[0] if num_vars is None
                 else (num_vars + 1) // 2)
        if (1 << sigma) >= rows_device.GROUP:
            groups.setdefault(1 << sigma, []).append(i)
    out: dict = {}
    for cols, idxs in groups.items():
        eng = rows_device.get_engine(srs, cols, device)
        rows = eng.commit_rows([small[i] for i in idxs], nplanes=nplanes)
        out.update(zip(idxs, rows))
    return out


def _oh_u8(positions, cube: int) -> np.ndarray:
    a = np.zeros(cube, np.uint8)
    pos = np.asarray(positions, dtype=np.int64)
    if pos.size:
        a[pos] = 1
    return a


def commit_and_absorb(transcript, steps, bytecode_len: int,
                      memory_trace_len: int, srs=None,
                      sound: bool = False, log_ram_k: int = 0,
                      start_address: int = 0, bc_index=None,
                      device=None) -> CommitmentPhase:
    """Build + commit + absorb all committed polys; mirrors
    src/zkvm/mod.zig:817-1010. `steps` is the (padded) execution trace.

    With a `device`, the small-scalar chunk polys of at least
    DEVICE_COMMIT_MIN entries get their row MSMs from the device row-MSM
    tier (kernel B on CUDA, its plain torch version on the CPU); the Inc
    polys, the chunk polys below that size and every pairing stay on the
    host C tier. The commitments are the same bytes either way. `metrics` times the row
    MSMs ("commit_rows") and the pairings ("commit_pairings") apart.

    sound=True switches to the PCS-binding layout: the cycle-indexed RAM
    polys (RamInc, RamRa) span the padded trace cube (so their MLEs equal
    the claims the stage provers emit), every poly is committed under one
    global square Dory layout (column width 2^{N/2}, N even) so the batch
    opening's γ-RLC of GT commitments matches the RLC'd polynomial, and the
    tables are retained for the joint opening prover."""
    from ..native.frvec import FrVec
    from ..utils.log import metrics

    res = CommitmentPhase()
    res.bytecode_poly_size = _next_pow2(max(bytecode_len, 2))
    res.memory_poly_size = (_next_pow2(max(len(steps), 2)) if sound
                            else _next_pow2(max(memory_trace_len, 2)))
    res.reg_poly_size = _next_pow2(max(len(steps), 2))

    log_bytecode_k = res.bytecode_poly_size.bit_length() - 1
    if not sound:
        # compat: RamRa chunks the raw address over the memory-trace cube
        log_ram_k = res.memory_poly_size.bit_length() - 1
    res.instruction_d = (LOG_K_INSTRUCTION + LOG_K_CHUNK - 1) // LOG_K_CHUNK
    if sound:
        # sound: BytecodeRa chunks the bytecode SLOT index (stage 10-12
        # layout, zkvm/bytecode_raf.py); requires the public slot index
        if bc_index is None:
            raise ValueError("sound commitments need bc_index "
                             "(zkvm.bytecode_tables.BytecodeIndex)")
        from .bytecode_raf import bc_chunk_count

        res.bytecode_d = bc_chunk_count(bc_index.log_k)
    else:
        res.bytecode_d = max(1, (log_bytecode_k + LOG_K_CHUNK - 1) // LOG_K_CHUNK)
    res.ram_d = max(1, (log_ram_k + LOG_K_CHUNK - 1) // LOG_K_CHUNK)

    if sound:
        res.global_num_vars = sound_layout_num_vars(len(steps), bytecode_len)
        if srs is None:
            srs = dory.setup(res.global_num_vars)
        res.srs = srs
    elif srs is None:
        max_size = max(res.bytecode_poly_size, res.memory_poly_size,
                       res.reg_poly_size)
        log_size = max(1, (max_size.bit_length() - 1) + 1)
        srs = dory.setup(log_size)

    polys = [build_rd_inc(steps, res.reg_poly_size),
             build_ram_inc(steps, res.memory_poly_size)]
    small: list = [None, None]  # uint8 value arrays for the device tier
    if sound:
        # one-hot (chunk-value × cycle) cubes over the SOUND lookup index
        # (the stage-8/9/10 lookups argument, zkvm/lookups_raf.py), the
        # RamRa chunks over the word-slot index (stages 6-7, stage67.py)
        # and the bytecode-slot chunks (stages 10-12)
        from .bytecode_raf import bc_oh_positions, io_oh_positions

        n_cycle_vars = res.reg_poly_size.bit_length() - 1
        cube = (1 << LOG_K_CHUNK) * res.reg_poly_size
        positions = list(io_oh_positions(steps, n_cycle_vars))
        for d in range(res.ram_d):
            shift = LOG_K_CHUNK * (res.ram_d - 1 - d)
            positions.append(ram_ra_onehot_positions(
                steps, res.reg_poly_size, shift, start_address, log_ram_k))
        positions += bc_oh_positions(bc_index.slots_per_cycle(steps),
                                     n_cycle_vars, bc_index.log_k)
        polys += [FrVec.indicator(cube, pos) for pos in positions]
        if device is not None:
            small += [_oh_u8(pos, cube) for pos in positions]
        res.polys = polys
        num_vars, nplanes = res.global_num_vars, 1
    else:
        idx_lo, idx_hi = jolt_lookup_lo_hi(steps)
        small += build_instruction_ra_u8(idx_lo, idx_hi, res.reg_poly_size,
                                         res.instruction_d)
        for d in range(res.ram_d):
            shift = LOG_K_CHUNK * (res.ram_d - 1 - d)
            small.append(build_ram_ra_u8(steps, res.memory_poly_size, shift))
        for d in range(res.bytecode_d):
            shift = LOG_K_CHUNK * (res.bytecode_d - 1 - d)
            small.append(build_bytecode_ra_u8(steps, res.bytecode_poly_size,
                                              shift))
        polys += small[2:]
        num_vars, nplanes = None, 4

    # sound: commit in the GLOBAL cube's matrix layout without materializing
    # the zero padding (missing rows are identity pairing factors; FrVec
    # cubes stream canonical bytes straight into the row MSMs)
    with metrics.stage("commit_rows"):
        rows = ({} if device is None else
                _device_rows(srs, small, device, num_vars, nplanes))
        for i, poly in enumerate(polys):
            if i not in rows:
                if isinstance(poly, np.ndarray):
                    # u8 values, ingested one poly at a time
                    poly = FrVec.from_u64_array(poly.astype(np.uint64))
                rows[i] = dory.row_commitments(srs, poly, num_vars)
    with metrics.stage("commit_pairings"):
        for i in range(len(polys)):
            gt = dory.pair_rows(srs, rows[i])
            res.commitments.append(dory.commitment_bytes(gt))
    for c in res.commitments:
        transcript.append_gt(c)
    return res


def derive_tau(transcript, n_cycle_vars: int) -> list[int]:
    """τ = num_cycle_vars + 2 UniSkip challenges (src/zkvm/mod.zig:970-982)."""
    return [transcript.challenge_scalar() for _ in range(n_cycle_vars + 2)]
