"""Stage 4 of the Jolt-format proof: 3-instance batched sumcheck.

Instances (reference src/zkvm/proof_converter.zig:1605-2628):
  0. RegistersReadWriteChecking — 3-phase Gruen prover over the K=128
     register file × T cycles (reference src/zkvm/spartan/stage4_gruen_prover.zig).
     Proves rd_write_value + γ·rs1_value + γ²·rs2_value =
     Σ_{k,j} eq(r_cycle, j)·(ra(k,j)·Val(k,j) + wa(k,j)·(Val(k,j)+Inc(j))).
  1. RamValEvaluation — Σ_j Inc(j)·wa(j)·LT(j, r_cycle) over RAM writes
     (reference src/zkvm/ram/val_evaluation.zig).
  2. RamValFinalEvaluation — Σ_j Inc(j)·wa(j) (reference src/zkvm/ram/val_final.zig).

Batching mirrors stage 2: max_rounds = 7 + n_cycle_vars; registers always
active, the two RAM instances activate when remaining_rounds ≤ their rounds;
inactive instances contribute claim·2^(remaining-rounds-1)·α per round.

All arithmetic is host-int modular: these are narrow sequential transcript
chains (the wide data-parallel work lives in the device stage provers).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

from ..field.params import FR
from ..poly import unipoly
from ..poly.special import GruenSplitEq
from .stage2_batch import _lagrange_eval_0123, eval_from_hint

P = FR.p

LOG_K = 7          # log2(128): 32 RISC-V + 96 virtual registers
K = 1 << LOG_K


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _eq_le(r: list[int], idx: int) -> int:
    """eq(r, idx) with r little-endian: bit i of idx ↔ r[i]
    (reference src/zkvm/ram/val_evaluation.zig:790-802)."""
    out = 1
    for i, ri in enumerate(r):
        out = out * (ri if (idx >> i) & 1 else (1 - ri)) % P
    return out


def _eq_be(r: list[int], idx: int) -> int:
    """eq(r, idx) with r big-endian: r[0] ↔ MSB
    (reference src/zkvm/proof_converter.zig:4083-4095)."""
    n = len(r)
    out = 1
    for i, ri in enumerate(r):
        out = out * (ri if (idx >> (n - 1 - i)) & 1 else (1 - ri)) % P
    return out


def _lt_table_le(r: list[int], n_vars: int) -> list[int]:
    """LT(j, r) for all j < 2^n_vars via the MSB-first comparison doubling
    (each step adds bit i as the new top bit; r is little-endian so bit i
    owns r[i]): LT_new(j_i‖j) = eq(j_i, r_i)·LT(j) + (1−j_i)·r_i —
    O(2^n) instead of the pointwise O(2^n·n²)."""
    L = [0]
    for i in range(n_vars):
        ri = (r[i] if i < len(r) else 0) % P
        size = len(L)
        nL = [0] * (2 * size)
        for j in range(size):
            nL[j] = ((1 - ri) * L[j] + ri) % P
            nL[j + size] = ri * L[j] % P
        L = nL
    return L


def _lt_le(r: list[int], j: int) -> int:
    """LT(j, r) = Σ_{i: j_i=0} r_i · Π_{k>i} eq(j_k, r_k), little-endian
    (reference src/zkvm/ram/val_evaluation.zig:314-343)."""
    out = 0
    n = len(r)
    for i in range(n):
        if (j >> i) & 1:
            continue
        contrib = r[i]
        for k in range(i + 1, n):
            jk = (j >> k) & 1
            contrib = contrib * (r[k] if jk else (1 - r[k])) % P
        out = (out + contrib) % P
    return out


def compute_initial_ram_eval(initial_ram: dict[int, int], start_address: int,
                             r_address_be: list[int], log_ram_k: int) -> int:
    """MLE of the initial RAM image at a big-endian address point
    (reference src/zkvm/proof_converter.zig:4113-4160)."""
    max_idx = 1 << log_ram_k
    out = 0
    for addr, val in initial_ram.items():
        if addr < start_address:
            continue
        idx = (addr - start_address) // 8
        if idx >= max_idx:
            continue
        out = (out + _eq_be(r_address_be, idx) * (val % P)) % P
    return out


# ---------------------------------------------------------------------------
# Instance 0: registers read/write checking (3-phase Gruen)
# ---------------------------------------------------------------------------

# Expanded-opcode sets (reference stage4_gruen_prover.zig:130-160)
_READS_RS1 = {0x13, 0x03, 0x67, 0x1B, 0x33, 0x3B, 0x23, 0x63}
_READS_RS2 = {0x33, 0x3B, 0x23, 0x63}
_NO_RD = {0x23, 0x63}
NO_READ = K          # per-cycle "reads no register" sentinel (> any reg)


class Stage4RegistersProver:
    """Gruen 3-phase registers RWC prover.

    Phase 1 (log_T/2 rounds): bind cycle vars low-to-high with split-eq.
    Phase 2 (LOG_K rounds): bind register vars with the merged eq table.
    Phase 3 (remaining cycle vars): bind with the dense merged eq table.
    Mirrors reference src/zkvm/spartan/stage4_gruen_prover.zig exactly.
    """

    def __init__(self, steps, gamma: int, r_cycle_le: list[int],
                 stage3_claims: dict[str, int]):
        T = _next_pow2(len(steps))
        assert T == len(steps), "steps must be pre-padded to a power of two"
        log_T = T.bit_length() - 1
        assert len(r_cycle_le) == log_T
        self.T = T
        self.log_T = log_T
        self.num_rounds = LOG_K + log_T
        self.gamma = gamma % P
        self.gamma_sq = gamma * gamma % P
        self.claims = stage3_claims
        self.phase1_rounds = log_T // 2
        self.phase2_rounds = LOG_K

        # Per-register rows [K][T]; val holds the register value BEFORE the
        # cycle executes (piecewise-constant between rd writes); inc the rd
        # write delta; ra accumulates γ·rs1 + γ²·rs2 from the read one-hots.
        import numpy as np

        from ..native.frvec import FrVec

        # vectorized trace scan (the per-cycle Python loop was ~half of the
        # stage-4 wall time at T=2^20)
        from ..r1cs.inputs import _steps_to_arrays

        n_real = next((i for i, s in enumerate(steps) if s.is_noop), T)
        arrs, _comp, _hp = _steps_to_arrays(steps[:n_real])
        instr = arrs["instruction"]
        rdv = arrs["rd_value"]
        opcode = (instr & np.uint64(0x7F)).astype(np.uint32)
        u = np.uint64
        # 7-bit register fields: virtual-sequence rows (vm/virtual.py) carry
        # the two high bits in the synthetic word's extension byte; real
        # instructions have zero there, so the OR is uniform
        rd_f = (((instr >> u(7)) & u(0x1F))
                | (((instr >> u(32)) & u(3)) << u(5))).astype(np.int64)
        rs1_f = (((instr >> u(15)) & u(0x1F))
                 | (((instr >> u(34)) & u(3)) << u(5))).astype(np.int64)
        rs2_f = (((instr >> u(20)) & u(0x1F))
                 | (((instr >> u(36)) & u(3)) << u(5))).astype(np.int64)

        def pad_to_T(a, fill):
            if n_real == T:
                return a
            return np.concatenate([a, np.full(T - n_real, fill, a.dtype)])

        # per-cycle read registers (sentinel 128 = "no read")
        is_virt = opcode == np.uint32(0x0B)
        vkind = (((instr >> u(12)) & u(7))
                 | (((instr >> u(27)) & u(3)) << u(3))).astype(np.int64)
        v_reads_rs1 = is_virt & (vkind != 0)             # all but ADVICE
        v_reads_rs2 = is_virt & np.isin(vkind, (1, 2, 3, 4, 5, 10, 11, 12, 13))
        reads1 = np.isin(opcode, tuple(_READS_RS1)) | v_reads_rs1
        reads2 = np.isin(opcode, tuple(_READS_RS2)) | v_reads_rs2
        rs1_reg = pad_to_T(np.where(reads1, rs1_f, np.int64(NO_READ)), NO_READ)
        rs2_reg = pad_to_T(np.where(reads2, rs2_f, np.int64(NO_READ)), NO_READ)
        self._rs1_reg = rs1_reg
        self._rs2_reg = rs2_reg
        # challenge log for the deferred rs1/rs2 final-claim evals
        self._r_cycle_bound: list[int] = []
        self._r_k_bound: list[int] = []

        writes = (~np.isin(opcode, tuple(_NO_RD))) & (rd_f != 0)
        rd_w = pad_to_T(np.where(writes, rd_f, np.int64(-1)), -1)  # -1 = no write
        rdv_T = pad_to_T(rdv, 0)

        # ra_k(c) = γ·[rs1(c)==k] + γ²·[rs2(c)==k]: byte-gather from the 4
        # Montgomery constants {0, γ, γ², γ+γ²} by selector — one numpy pass
        # per register instead of two indicator builds + two axpys
        from ..native.frvec import _mont_scalars

        consts = bytes(_mont_scalars([0, self.gamma, self.gamma_sq,
                                      (self.gamma + self.gamma_sq) % P]))
        cmat = np.frombuffer(consts, dtype=np.uint8).reshape(4, 32)

        inc_lo = np.zeros(T, dtype=np.uint64)
        inc_hi = np.zeros(T, dtype=np.int64)
        self.val = []
        self.rd_wa = []
        self.ra = []
        self._zero_row = FrVec.zeros(T)
        # registers the guest never touches have all-zero rows: share ONE
        # zero vector instead of building 3 T-sized buffers per register
        # (the row build dominated stage-4 init at T=2^20); fold passes
        # dedupe by object identity so the shared row folds once
        used = set(np.unique(rd_w[rd_w >= 0]).tolist())
        used |= set(np.unique(rs1_reg[rs1_reg < NO_READ]).tolist())
        used |= set(np.unique(rs2_reg[rs2_reg < NO_READ]).tolist())
        # traces without virtual sequences only ever touch x0..x31; with
        # them, the scratch registers x32.. come live (vm/virtual.py)
        self.reg_span = 32 if (not used or max(used) < 32) else K
        for k in range(self.reg_span):
            if k not in used:
                self.val.append(self._zero_row)
                self.rd_wa.append(self._zero_row)
                self.ra.append(self._zero_row)
                continue
            wc = np.flatnonzero(rd_w == k)          # write cycles of reg k
            vals = rdv_T[wc]
            prev = np.concatenate([np.zeros(1, np.uint64), vals[:-1]])
            inc_lo[wc] = vals - prev                # u64 wrap; sign via hi
            inc_hi[wc] = np.where(vals < prev, np.int64(-1), np.int64(0))
            # val row: value BEFORE the cycle — a write at cycle c takes
            # effect from cycle c+1 onward
            bounds = np.concatenate([wc + 1, [np.int64(T)]])
            counts = np.diff(np.concatenate([[np.int64(0)], bounds]))
            v = np.repeat(np.concatenate([np.zeros(1, np.uint64), vals]), counts)
            self.val.append(FrVec.from_u64_array(v))
            self.rd_wa.append(FrVec.indicator(T, wc))
            sel = (rs1_reg == k).astype(np.int8) + 2 * (rs2_reg == k).astype(np.int8)
            self.ra.append(FrVec(T, mont=bytearray(cmat[sel].tobytes())))
        self.inc = FrVec.from_i128_arrays(inc_lo, inc_hi)

        r_cycle_be = list(reversed([c % P for c in r_cycle_le]))
        self.gruen = GruenSplitEq(r_cycle_be)
        self.merged_eq: object | None = None
        self.current_T = T
        self.current_K = K
        # registers beyond reg_span are all-zero; the bound shrinks in phase 2
        self.active_K = self.reg_span

    def _row(self, rows, k):
        return rows[k] if k < len(rows) else self._zero_row

    def input_claim(self) -> int:
        c = self.claims
        return (c["rd_write_value"]
                + self.gamma * (c["rs1_value"] + self.gamma * c["rs2_value"])) % P

    # -- round messages ----------------------------------------------------

    def _phase1_coeffs(self, prev_claim: int) -> list[int]:
        from ..native.frvec import FrVec

        g = self.gruen
        E_in = g.E_in_vec[-1]
        E_out = g.E_out_vec[-1]
        nbits = (len(E_in).bit_length() - 1) if len(E_in) > 1 else 0
        aK = self.active_K
        q0, qX2 = FrVec.s4_phase1(
            FrVec.from_ints(E_out), FrVec.from_ints(E_in), nbits,
            [self._row(self.ra, k) for k in range(aK)],
            [self._row(self.rd_wa, k) for k in range(aK)],
            [self._row(self.val, k) for k in range(aK)],
            self.inc, self.current_T)
        return self._gruen_coeffs(q0, qX2, prev_claim)

    def _gruen_coeffs(self, q0: int, qX2: int, claim: int) -> list[int]:
        """gruenPolyDeg3 → cubic coefficients (reference gruen_eq.zig)."""
        g = self.gruen
        w = g.tau[g.current_index - 1]
        eq1 = g.current_scalar * w % P
        eq0 = (g.current_scalar - eq1) % P
        m = (eq1 - eq0) % P
        eq2 = (eq1 + m) % P
        eq3 = (eq2 + m) % P
        c = q0 % P
        e = qX2 % P
        s1 = (claim - eq0 * c) % P
        quad1 = s1 * pow(eq1, -1, P) % P if eq1 else 0
        quad2 = (2 * quad1 - c + 2 * e) % P
        quad3 = (quad2 + quad1 - c + 4 * e) % P
        evals = [eq0 * c % P, s1 % P, eq2 * quad2 % P, eq3 * quad3 % P]
        return unipoly.interpolate_degree3(evals)

    def _phase2_coeffs(self, prev_claim: int) -> list[int]:
        from ..native.frvec import FrVec

        half_K = self.current_K // 2
        active_pairs = min(half_K, (self.active_K + 1) // 2)
        e0, e2 = FrVec.s4_phase2(
            self.merged_eq, self.inc,
            [self._row(self.ra, k) for k in range(2 * active_pairs)],
            [self._row(self.rd_wa, k) for k in range(2 * active_pairs)],
            [self._row(self.val, k) for k in range(2 * active_pairs)],
            active_pairs, self.current_T)
        e1 = (prev_claim - e0) % P
        c2_ = (e0 - 2 * e1 + e2) * pow(2, -1, P) % P
        c1_ = (e1 - e0 - c2_) % P
        return [e0 % P, c1_, c2_, 0]

    def _phase3_coeffs(self, prev_claim: int) -> list[int]:
        from ..native.frvec import FrVec

        Kp = self.current_K
        aK = min(Kp, self.active_K)
        if self.current_T > 1:
            e0, e2, e3 = FrVec.s4_phase3(
                self.merged_eq, self.inc,
                [self._row(self.ra, k) for k in range(aK)],
                [self._row(self.rd_wa, k) for k in range(aK)],
                [self._row(self.val, k) for k in range(aK)],
                self.current_T)
            e1 = (prev_claim - e0) % P
            return unipoly.interpolate_degree3([e0, e1, e2, e3])
        # cycles exhausted: quadratic in the remaining register variable
        inc_e, eq_e = self.inc.first(), self.merged_eq.first()
        e0 = e2 = 0
        for i in range(Kp // 2):
            ra_e = self._row(self.ra, 2 * i).first()
            ra_o = self._row(self.ra, 2 * i + 1).first()
            wa_e = self._row(self.rd_wa, 2 * i).first()
            wa_o = self._row(self.rd_wa, 2 * i + 1).first()
            v_e = self._row(self.val, 2 * i).first()
            v_o = self._row(self.val, 2 * i + 1).first()
            e0 += ra_e * v_e + wa_e * (v_e + inc_e)
            ra2, wa2, v2 = 2 * ra_o - ra_e, 2 * wa_o - wa_e, 2 * v_o - v_e
            e2 += ra2 * v2 + wa2 * (v2 + inc_e)
        e0 = eq_e * e0 % P
        e2 = eq_e * e2 % P
        e1 = (prev_claim - e0) % P
        c2_ = (e0 - 2 * e1 + e2) * pow(2, -1, P) % P
        c1_ = (e1 - e0 - c2_) % P
        return [e0, c1_, c2_, 0]

    def round_coeffs(self, rnd: int, current_claim: int) -> list[int]:
        if rnd < self.phase1_rounds:
            return self._phase1_coeffs(current_claim)
        if rnd < self.phase1_rounds + self.phase2_rounds:
            return self._phase2_coeffs(current_claim)
        return self._phase3_coeffs(current_claim)

    def round_evals(self, rnd: int, current_claim: int) -> list[int]:
        c = self.round_coeffs(rnd, current_claim)
        return [c[0],
                (c[0] + c[1] + c[2] + c[3]) % P,
                (c[0] + 2 * c[1] + 4 * c[2] + 8 * c[3]) % P,
                (c[0] + 3 * c[1] + 9 * c[2] + 27 * c[3]) % P]

    # -- binding -----------------------------------------------------------

    def bind(self, rnd: int, r: int) -> None:
        from ..native.frvec import FrVec

        omr = (1 - r) % P
        p1, p2 = self.phase1_rounds, self.phase1_rounds + self.phase2_rounds
        # rs1_ra/rs2_ra rows are NOT kept/folded: they only feed two final
        # scalars, computed in closed form from the challenge log (below)
        all_rows = (self.val, self.rd_wa, self.ra)
        if rnd < p1:
            half_T = self.current_T // 2
            seen: set[int] = set()
            live = []
            for rows in all_rows:
                for k in range(min(self.active_K, len(rows))):
                    v = rows[k]
                    if id(v) in seen:
                        continue   # shared zero row: fold once
                    seen.add(id(v))
                    live.append(v)
            live.append(self.inc)
            # one native call, in place across all ~100 rows: fresh-buffer
            # per-row folds hit allocator churn at T=2^20 (13x slowdown)
            FrVec.fold_adj_rows_(live, self.current_T, r)
            self.current_T = half_T
            self.gruen.bind(r)
            self._r_cycle_bound.append(r % P)
            if rnd == p1 - 1:
                # phase 2 works at the shrunken T: drop the stale tails
                # (identity-cached so shared zero rows stay shared)
                tcache: dict[int, FrVec] = {}

                def trunc(v):
                    got = tcache.get(id(v))
                    if got is not None:
                        return got
                    if v._mont is not None:
                        out = FrVec(half_T,
                                    mont=bytearray(memoryview(v._mont)[:32 * half_T]))
                    else:
                        out = FrVec(half_T, ints=v._ints[:half_T])
                    tcache[id(v)] = out
                    return out
                for rows in all_rows:
                    for k in range(len(rows)):
                        rows[k] = trunc(rows[k])
                self.inc = trunc(self.inc)
                self._zero_row = FrVec.zeros(half_T)
                self.merged_eq = FrVec.from_ints(self.gruen.full_eq_table())
        elif rnd < p2:
            half_K = self.current_K // 2
            n_active = min(half_K, (self.active_K + 1) // 2)
            for rows in all_rows:
                for i in range(n_active):
                    lo = self._row(rows, 2 * i)
                    hi = self._row(rows, 2 * i + 1)
                    merged = lo.scale(omr)
                    merged.axpy_(hi, r)
                    rows[i] = merged
                del rows[n_active:]
            self.current_K = half_K
            self.active_K = n_active
            self._r_k_bound.append(r % P)
        else:
            half_T = self.current_T // 2
            seen = set()
            live = []
            for rows in all_rows:
                for k in range(min(self.current_K, self.active_K, len(rows))):
                    v = rows[k]
                    if id(v) in seen:
                        continue   # shared zero row: fold once
                    seen.add(id(v))
                    live.append(v)
            live += [self.inc, self.merged_eq]
            FrVec.fold_adj_rows_(live, self.current_T, r)
            self.current_T = half_T
            self._r_cycle_bound.append(r % P)

    def _read_ra_final(self, reg_per_cycle) -> int:
        """Closed-form final scalar of a one-hot read row family:
        Σ_k eq_LE(r_k, k) · Σ_c eq_LE(r_cycle, c) · [reg(c) == k]. Every
        cycle reads at most one register, so this is one byte-gather of the
        k-weights by the per-cycle register index + one native inner
        product — no per-round folding of 64 rows."""
        import numpy as np

        from ..native.frvec import FrVec, _mont_scalars

        # fold_adj binds the LSB each round: both challenge logs are
        # little-endian points; eq_LE(r, x) = eq_BE(reversed(r), x)
        eq_cycle = FrVec.eq_table_be(list(reversed(self._r_cycle_bound)))
        span = self.reg_span
        w = [1] * span
        for i, rk in enumerate(self._r_k_bound):
            for k in range(span):
                w[k] = w[k] * (rk if (k >> i) & 1 else (1 - rk)) % P
        wmat = np.frombuffer(bytes(_mont_scalars(w + [0])),
                             dtype=np.uint8).reshape(span + 1, 32)
        idx = np.minimum(reg_per_cycle, span)   # NO_READ -> the zero row
        v = FrVec(self.T, mont=bytearray(wmat[idx].tobytes()))
        return v.inner(eq_cycle)

    def final_claims(self) -> dict[str, int]:
        return {"val": self.val[0].first(),
                "rs1_ra": self._read_ra_final(self._rs1_reg),
                "rs2_ra": self._read_ra_final(self._rs2_reg),
                "rd_wa": self.rd_wa[0].first(),
                "inc": self.inc.first()}


# ---------------------------------------------------------------------------
# Instances 1-2: RAM Val evaluation / Val final
# ---------------------------------------------------------------------------

def _lt_table_fr(r: list[int], n_vars: int):
    """_lt_table_le as an FrVec doubling build: each level is two shared-
    scalar vector ops + a buffer concat instead of 2^i Python modmuls."""
    import numpy as np

    from ..native.frvec import FrVec

    L = FrVec.from_ints([0])
    for i in range(n_vars):
        ri = (r[i] if i < len(r) else 0) % P
        lo = L.scale((1 - ri) % P)
        lo.add_by_cat_(np.zeros(L.n, np.uint16), [ri])
        hi = L.scale(ri)
        if lo._mont is not None and hi._mont is not None:
            L = FrVec(2 * L.n, mont=lo._mont + hi._mont)
        else:
            L = FrVec(2 * L.n, ints=lo.to_ints() + hi.to_ints())
    return L


def _build_inc_wa(accesses, initial_ram, trace_len: int, start_address: int,
                  k: int, r_address: list[int]):
    """Inc (write deltas) and wa (eq at write address) per cycle, as FrVecs
    built SPARSELY — only write cycles are nonzero, so the vectors scatter
    a handful of values into zero buffers instead of building and
    converting T-sized Python lists
    (reference src/zkvm/ram/val_evaluation.zig:87-285)."""
    import numpy as np

    from ..native.frvec import FrVec, _mont_scalars

    padded = _next_pow2(max(trace_len, 1))
    last = {}
    for addr, val in initial_ram.items():
        if addr < start_address:
            continue
        if (addr - start_address) // 8 >= k:
            continue
        last[addr] = val
    w_ts: list[int] = []
    w_inc: list[int] = []
    w_idx: list[int] = []
    for a in accesses:
        if a.op != "write":
            continue
        if a.address < start_address:
            continue
        idx = (a.address - start_address) // 8
        if idx >= k:
            continue
        ts = a.timestamp
        if ts >= trace_len:
            continue
        old = last.get(a.address, 0)
        w_ts.append(ts)
        w_inc.append((a.post_value - old) % P)
        w_idx.append(idx)
        last[a.address] = a.post_value
    inc = FrVec.zeros(padded)
    wa = FrVec.zeros(padded)
    if not w_ts:
        return inc, wa
    n_writes = len(w_ts)
    if n_writes * len(r_address) > (1 << len(r_address)):
        # dense writes: one LE eq table beats per-write pointwise products
        # (eq_LE(r, x) = eq_BE(reversed(r), x))
        from ..native.frvec import FrVec as _FV

        tab = _FV.eq_table_be(list(reversed([c % P for c in r_address])))
        wa_vals = None
        if tab._mont is not None:
            rows = np.frombuffer(memoryview(tab._mont), np.uint8,
                                 count=32 * tab.n).reshape(tab.n, 32)
            wa_bytes = rows[np.asarray(w_idx, np.int64)]
        else:
            ti = tab._ints
            wa_vals = [ti[i] for i in w_idx]
    else:
        wa_vals = [_eq_le(r_address, i) for i in w_idx]
        wa_bytes = None
    if wa_vals is not None:
        wa_bytes = np.frombuffer(bytes(_mont_scalars(wa_vals)),
                                 np.uint8).reshape(n_writes, 32) \
            if wa._mont is not None else None
    ts_np = np.asarray(w_ts, np.int64)
    if inc._mont is not None:
        inc_bytes = np.frombuffer(bytes(_mont_scalars(w_inc)),
                                  np.uint8).reshape(n_writes, 32)
        np.frombuffer(inc._mont, np.uint8).reshape(padded, 32)[ts_np] = inc_bytes
        np.frombuffer(wa._mont, np.uint8).reshape(padded, 32)[ts_np] = wa_bytes
    else:
        for j, ts in enumerate(w_ts):
            inc._ints[ts] = w_inc[j]
            wa._ints[ts] = wa_vals[j]
    return inc, wa


class ValEvaluationProver:
    """Σ_j Inc(j)·wa(j)·LT(j, r_cycle), degree-3 rounds with lerp
    extrapolation (reference src/zkvm/ram/val_evaluation.zig:403-712)."""

    def __init__(self, accesses, initial_ram, trace_len: int, k: int,
                 r_address_le: list[int], r_cycle_le: list[int],
                 start_address: int, backend: str | None = None,
                 device=None, mesh=None):
        from ..native.frvec import FrVec

        inc, wa = _build_inc_wa(accesses, initial_ram, trace_len,
                                start_address, k, r_address_le)
        n = inc.n
        self.num_vars = n.bit_length() - 1 if n > 1 else 0
        lt = _lt_table_fr(r_cycle_le, self.num_vars)
        self.round = 0
        self.current_claim = FrVec.triple_inner(inc, wa, lt)
        self.inc = inc
        self.wa = wa
        self.lt = lt
        self._eng = None
        if backend in ("device", "mesh") and n >= 2:
            from ..parallel.stage_engine import DeviceProductTables

            self._eng = DeviceProductTables(
                [self.inc, self.wa, self.lt], degree=3, device=device,
                mesh=mesh)
            self.inc = self.wa = self.lt = None

    def num_rounds(self) -> int:
        return self.num_vars

    def _len(self) -> int:
        return self._eng.live if self._eng is not None else self.inc.n

    def device_engine(self):
        """The device engine of this round, or None when on host (the stage
        loop evaluates every engine of the round in one grouped launch)."""
        if self._eng is None or self._len() // 2 == 0:
            return None
        return self._eng

    def round_evals(self, pre: list[int] | None = None) -> list[int]:
        from ..native.frvec import FrVec

        if pre is not None:
            return pre
        n = self._len()
        if n // 2 == 0:
            ev = [0, 0, 0, 0]
            if n > 0:
                f = self.final_openings()
                ev[0] = f["inc"] * f["wa"] % P * f["lt"] % P
            return ev
        if self._eng is not None:
            return self._eng.round_evals()
        return FrVec.prod_evals_adj([self.inc, self.wa, self.lt], 3)

    def bind_with_poly(self, r: int, evals4: list[int]) -> None:
        if self._len() // 2 == 0:
            self.round += 1
            return
        if self._eng is not None:
            self._eng.bind(r)
        else:
            self.inc = self.inc.fold_adj(r)
            self.wa = self.wa.fold_adj(r)
            self.lt = self.lt.fold_adj(r)
        self.current_claim = _lagrange_eval_0123(evals4, r)
        self.round += 1

    def final_openings(self) -> dict[str, int]:
        if self._eng is not None:
            f = self._eng.finals()
            return {"inc": f[0], "wa": f[1], "lt": f[2]}
        return {"inc": self.inc.first(), "wa": self.wa.first(),
                "lt": self.lt.first()}


class ValFinalProver:
    """Σ_j Inc(j)·wa(j) (reference src/zkvm/ram/val_final.zig:58-260)."""

    def __init__(self, accesses, initial_ram, trace_len: int,
                 r_address: list[int], start_address: int,
                 backend: str | None = None, device=None, mesh=None):
        from ..native.frvec import FrVec

        k = 1 << len(r_address)
        inc, wa = _build_inc_wa(accesses, initial_ram, trace_len,
                                start_address, k, r_address)
        n = inc.n
        self.num_vars = n.bit_length() - 1 if n > 1 else 0
        self.round = 0
        self.current_claim = inc.inner(wa)
        self.inc = inc
        self.wa = wa
        self._eng = None
        if backend in ("device", "mesh") and n >= 2:
            from ..parallel.stage_engine import DeviceProductTables

            self._eng = DeviceProductTables(
                [self.inc, self.wa], degree=3, device=device, mesh=mesh)
            self.inc = self.wa = None

    def num_rounds(self) -> int:
        return self.num_vars

    def _len(self) -> int:
        return self._eng.live if self._eng is not None else self.inc.n

    def device_engine(self):
        if self._eng is None or self._len() // 2 == 0:
            return None
        return self._eng

    def round_evals(self, pre: list[int] | None = None) -> list[int]:
        from ..native.frvec import FrVec

        if pre is not None:
            return pre
        n = self._len()
        if n // 2 == 0:
            ev = [0, 0, 0, 0]
            if n > 0:
                f = self.final_openings()
                ev[0] = f["inc"] * f["wa"] % P
            return ev
        if self._eng is not None:
            return self._eng.round_evals()
        return FrVec.prod_evals_adj([self.inc, self.wa], 3)

    def bind_with_poly(self, r: int, evals4: list[int]) -> None:
        if self._len() // 2 == 0:
            self.round += 1
            return
        if self._eng is not None:
            self._eng.bind(r)
        else:
            self.inc = self.inc.fold_adj(r)
            self.wa = self.wa.fold_adj(r)
        self.current_claim = _lagrange_eval_0123(evals4, r)
        self.round += 1

    def final_openings(self) -> dict[str, int]:
        if self._eng is not None:
            f = self._eng.finals()
            return {"inc": f[0], "wa": f[1]}
        return {"inc": self.inc.first(), "wa": self.wa.first()}


# ---------------------------------------------------------------------------
# Batch driver
# ---------------------------------------------------------------------------

@dataclass
class Stage4Result:
    compressed_polys: list[list[int]] = dfield(default_factory=list)
    challenges: list[int] = dfield(default_factory=list)
    gamma: int = 0
    batching_coeffs: list[int] = dfield(default_factory=list)
    input_claims: list[int] = dfield(default_factory=list)
    regs_claims: dict = dfield(default_factory=dict)
    val_eval_openings: dict = dfield(default_factory=dict)
    val_final_openings: dict = dfield(default_factory=dict)
    final_claim: int = 0


def prove_stage4(transcript, padded_steps, accesses, initial_ram,
                 start_address: int, stage2_res, stage3_res,
                 n_cycle_vars: int, log_ram_k: int,
                 sound: bool = False, backend: str | None = None,
                 device=None, mesh=None) -> Stage4Result:
    """Stage-4 batched sumcheck, bit-exact transcript flow
    (reference src/zkvm/proof_converter.zig:1605-2628).

    sound=True follows the sound stage-2 schedule: the RAM RWC bound its
    address bits over the FIRST log_ram_k batch challenges (phase1 == 0,
    recorded in the proof's ReadWriteConfig), so val_eval's wa/LT points and
    val_final's wa point (the OutputSumcheck's bound point — the LAST
    log_ram_k challenges) line up with the emitted stage-2 claims and the
    batch input claims equal the instances' true sums."""
    res = Stage4Result()
    max_rounds = LOG_K + n_cycle_vars
    gamma = transcript.challenge_scalar_full()
    res.gamma = gamma

    # -- challenge-point bookkeeping from stage 2 (RWC phase structure) ----
    phase1 = 0 if sound else n_cycle_vars // 2
    phase2 = log_ram_k
    phase3_cycle_len = n_cycle_vars - phase1
    phase3_addr_len = log_ram_k - phase2
    ch2 = stage2_res.challenges
    r_address_be = [0] * log_ram_k
    for i in range(phase2):
        src = phase1 + i
        if src < len(ch2):
            dest = phase3_addr_len + (phase2 - 1 - i)
            if dest < log_ram_k:
                r_address_be[dest] = ch2[src]
    p3a_start = phase1 + phase2 + phase3_cycle_len
    for i in range(phase3_addr_len):
        src = p3a_start + i
        if src < len(ch2):
            r_address_be[phase3_addr_len - 1 - i] = ch2[src]
    r_cycle_be = [0] * n_cycle_vars
    for i in range(phase1):
        if i < len(ch2):
            dest = phase3_cycle_len + (phase1 - 1 - i)
            if dest < n_cycle_vars:
                r_cycle_be[dest] = ch2[i]
    p3c_start = phase1 + phase2
    for i in range(phase3_cycle_len):
        src = p3c_start + i
        if src < len(ch2):
            r_cycle_be[phase3_cycle_len - 1 - i] = ch2[src]
    r_cycle_le = list(reversed(r_cycle_be))
    r_address_le = list(reversed(r_address_be))

    init_eval_val_eval = compute_initial_ram_eval(
        initial_ram, start_address, r_address_be, log_ram_k)
    # OutputCheck binds addresses over the LAST log_ram_k stage-2 challenges
    out_start = max(0, len(ch2) - log_ram_k)
    r_address_output = [0] * log_ram_k
    for i in range(log_ram_k):
        src = out_start + i
        if src < len(ch2):
            r_address_output[log_ram_k - 1 - i] = ch2[src]
    init_eval_val_final = compute_initial_ram_eval(
        initial_ram, start_address, r_address_output, log_ram_k)

    input_claim_regs = (stage3_res.reg_claims["rd_write_value"]
                        + gamma * (stage3_res.reg_claims["rs1_value"]
                                   + gamma * stage3_res.reg_claims["rs2_value"])) % P
    input_claim_val_eval = (stage2_res.rwc_val_claim - init_eval_val_eval) % P
    input_claim_val_final = (stage2_res.output_val_final_claim
                             - init_eval_val_final) % P
    res.input_claims = [input_claim_regs, input_claim_val_eval,
                        input_claim_val_final]

    transcript.append_scalar(input_claim_regs)
    transcript.append_scalar(input_claim_val_eval)
    transcript.append_scalar(input_claim_val_final)
    alphas = [transcript.challenge_scalar_full() for _ in range(3)]
    res.batching_coeffs = alphas

    trace_len = len(padded_steps)
    regs = Stage4RegistersProver(padded_steps, gamma,
                                 list(stage3_res.challenges),
                                 stage3_res.reg_claims)
    val_eval = ValEvaluationProver(accesses, initial_ram, trace_len,
                                   1 << log_ram_k, r_address_le, r_cycle_le,
                                   start_address, backend=backend,
                                   device=device, mesh=mesh)
    # compat mode reproduces the reference's (rigged) first-log_k point;
    # sound mode uses the OutputSumcheck's actual bound point so the input
    # claim val_final_claim − init_eval equals the instance's true sum
    r_addr_vf = ch2[out_start:] if sound else [ch2[i] for i in range(log_ram_k)]
    val_final = ValFinalProver(accesses, initial_ram, trace_len,
                               r_addr_vf, start_address,
                               backend=backend, device=device, mesh=mesh)

    rounds = [max_rounds, val_eval.num_rounds(), val_final.num_rounds()]
    batched_claim = 0
    for i in range(3):
        batched_claim = (batched_claim
                         + (res.input_claims[i] << (max_rounds - rounds[i]))
                         * alphas[i]) % P

    regs_claim = input_claim_regs
    for rnd in range(max_rounds):
        remaining = max_rounds - rnd
        combined = [0, 0, 0, 0]
        # the device-backed instances' evals: one grouped launch, one
        # download
        pre_ve = pre_vf = None
        if backend in ("device", "mesh"):
            from ..parallel.stage_engine import drain_futures, round_evals_many

            engs = [p.device_engine() if remaining <= nr else None
                    for p, nr in ((val_eval, rounds[1]),
                                  (val_final, rounds[2]))]
            pre_ve, pre_vf = drain_futures(round_evals_many(engs))
        regs_evals = regs.round_evals(rnd, regs_claim)
        for j in range(4):
            combined[j] = (combined[j] + regs_evals[j] * alphas[0]) % P
        ve_evals = vf_evals = None
        if remaining > rounds[1]:
            w = (input_claim_val_eval << (remaining - rounds[1] - 1)) * alphas[1] % P
            combined = [(c + w) % P for c in combined]
        else:
            ve_evals = val_eval.round_evals(pre_ve)
            for j in range(4):
                combined[j] = (combined[j] + ve_evals[j] * alphas[1]) % P
        if remaining > rounds[2]:
            w = (input_claim_val_final << (remaining - rounds[2] - 1)) * alphas[2] % P
            combined = [(c + w) % P for c in combined]
        else:
            vf_evals = val_final.round_evals(pre_vf)
            for j in range(4):
                combined[j] = (combined[j] + vf_evals[j] * alphas[2]) % P

        compressed = unipoly.evals_to_compressed(combined)
        res.compressed_polys.append(compressed)
        transcript.append_message(b"UniPoly_begin")
        for c in compressed:
            transcript.append_scalar(c)
        transcript.append_message(b"UniPoly_end")
        r = transcript.challenge_scalar()
        res.challenges.append(r)
        batched_claim = eval_from_hint(compressed, batched_claim, r)
        regs_claim = _lagrange_eval_0123(regs_evals, r)
        regs.bind(rnd, r)
        if ve_evals is not None:
            val_eval.bind_with_poly(r, ve_evals)
        if vf_evals is not None:
            val_final.bind_with_poly(r, vf_evals)

    res.final_claim = batched_claim
    res.instance_final_claims = [regs_claim, val_eval.current_claim,
                                 val_final.current_claim]
    res.regs_claims = regs.final_claims()
    res.val_eval_openings = val_eval.final_openings()
    res.val_final_openings = val_final.final_openings()

    rc = res.regs_claims
    for v in (rc["val"], rc["rs1_ra"], rc["rs2_ra"], rc["rd_wa"], rc["inc"],
              res.val_eval_openings["wa"], res.val_eval_openings["inc"],
              res.val_final_openings["inc"], res.val_final_openings["wa"]):
        transcript.append_scalar(v)
    return res
