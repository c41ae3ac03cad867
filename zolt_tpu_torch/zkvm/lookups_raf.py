"""Sound-mode stage 8: the InstructionReadRaf sumcheck — the real protocol
behind the reference's zero-proof LookupsRAF placeholder
(src/zkvm/proof_converter.zig:2629-2677, SumcheckId InstructionReadRaf /
InstructionRaVirtualization in src/zkvm/jolt_types.zig:70-101).

Statement (over the (k, j) cube, k in {0,1}^128 address bits, j cycles):

  lo + gamma*left + gamma^2*right - const_claim + gamma^3*valid_rhs
    = sum_{k,j}  eq(rc1, j) * OH(k, j) * Gm(k, slot_j)

where lo/left/right are the stage-1 SpartanOuter claimed evaluations of
LookupOutput / LeftLookupOperand / RightLookupOperand at the cycle point
rc1, OH(k,j) = prod_d IOH_d(k_d, j) is the committed one-hot chunk
decomposition of the sound lookup index (zkvm/raf_gadgets.sound_lookup_index),
and Gm(k, s) combines the class-static closed-form gadgets:

  Gm(k, s) = outG_s(k) + g*leftG_s(k) + g^2*rightG_s(k) + g^3*ValidTable_s(k)

The static additive constants of the left/right gadgets are pulled out into
const_claim = sum_j eq*CONST(slot_j), and the validity right-hand side is
valid_rhs = sum_j eq*HasValidity(slot_j) — both are public tables over
bytecode slots, proven later by the BytecodeReadRaf stage (bytecode_raf.py).

Phase A binds the 128 address variables MSB-first with per-entry O(1)
incremental evaluation by gadget family (linear forms, eq/lt chains,
bitwise pair sums, shifts with concrete shamt, generic fallback for the
rare validity tables), VECTORIZED over entries: the per-round sums reduce
to a few per-category native weighted sums (frv_cat_wsum) keyed on small
integers from the concrete index bits, and per-entry state updates are
per-category scale/add kernels — no per-entry Python in the hot rounds.
The final 12 variables switch to a dense 4096-point endgame. Phase B binds
the cycle variables over eq * w * C(slot) dense tables. Terminal claims
(w, cs) are virtualized by stage 9 (InstructionRaVirtualization) and the
bytecode read-check respectively.

Degrees: phase A rounds are degree 2 (chi * Gm), phase B degree 3.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

from ..field.params import FR
from ..poly import unipoly
from ..vm import tables as tb
from ..vm.tables import Table
from .raf_gadgets import (G, RafSpec, entry_spec, gadget_eval_point,
                          sound_lookup_index)

P = FR.p
ADDR_VARS = 128
ENDGAME_VARS = 12
LOG_K_CHUNK = 4
INSTRUCTION_D = ADDR_VARS // LOG_K_CHUNK   # 32 committed chunks
TWO64 = 1 << 64


def _absorb_round(transcript, compressed: list[int]) -> int:
    transcript.append_message(b"UniPoly_begin")
    for c in compressed:
        transcript.append_scalar(c % P)
    transcript.append_message(b"UniPoly_end")
    return transcript.challenge_scalar()


def eq_point_eval(a: list[int], b: list[int]) -> int:
    out = 1
    for x, y in zip(a, b):
        out = out * ((x * y + (1 - x) * (1 - y)) % P) % P
    return out


def _eval2(compressed2: list[int], hint: int, x: int) -> int:
    c0, c2 = compressed2[0] % P, compressed2[1] % P
    c1 = (hint - 2 * c0 - c2) % P
    return (c0 + c1 * x + c2 * x * x) % P


# ---------------------------------------------------------------------------
# Combined per-class gadget machinery
# ---------------------------------------------------------------------------

_BITWISE = {Table.And: 0, Table.Or: 1, Table.Xor: 2}
_SHIFTS = {Table.LeftShift: 0, Table.RightShift: 1,
           Table.RightShiftArithmetic: 2}
# (b_lt, b_eq, const, signed)
_CHAINS = {Table.UnsignedLessThan: (1, 0, 0, False),
           Table.SignedLessThan: (1, 0, 0, True),
           Table.UnsignedGreaterThanEqual: (-1, 0, 1, False),
           Table.SignedGreaterThanEqual: (-1, 0, 1, True),
           Table.UnsignedLessThanEqual: (1, 1, 0, False),
           Table.Equal: (0, 1, 0, False),
           Table.NotEqual: (0, -1, 1, False)}


def _bit_op(kind: int, a: int, b: int) -> int:
    """Multilinear extension of the bit pair op (valid off-cube)."""
    if kind == 0:
        return a * b % P
    if kind == 1:
        return (a + b - a * b) % P
    return (a + b - 2 * a * b) % P


def _shift_w(kind: int, s: int, i: int) -> int:
    """Field weight of x_i in the shift-by-s linear form."""
    if kind == 0:
        return (1 << (i + s)) if i + s < 64 else 0
    w = (1 << (i - s)) if i >= s else 0
    if kind == 2 and i == 63 and s > 0:
        w += TWO64 - (1 << (64 - s))       # arithmetic fill bits
    return w % P


class ClassGroup:
    """All entries of one gadget class, with the class's combined Gm
    components and the per-entry incremental phase-A state.

    The per-entry state is VECTORIZED: Fr vectors (wt = eq·χ weights, the
    χ-only pref, the linear-form suffix lin_s, the shift partial sh_cur)
    live as FrVec buffers updated by per-category native kernels
    (frv_scale_by_cat / frv_add_by_cat), and the round sums reduce to a few
    per-category weighted sums (frv_cat_wsum) keyed on small integers
    computed from the concrete index bits (current bit, suffix bit, lt/eq
    chain state, shift amount) with numpy. The category tables themselves
    are O(1)-sized host math per round."""

    def __init__(self, spec: RafSpec, gammas: list[int]):
        self.spec = spec
        self.lin_w = [0] * ADDR_VARS
        self.cc = 0
        self.chain = None       # (b_lt, b_eq, signed) coeff-scaled
        self.bitop = None       # (coeff, kind)
        self.shift = None       # (coeff, kind)
        self.valids = []        # [(coeff, table)] generic per-entry tables
        for slot, g in ((spec.out, gammas[0]), (spec.left, gammas[1]),
                        (spec.right, gammas[2])):
            self._add_slot(slot, g)
        if spec.valid_table is not None:
            self.valids.append((gammas[3], spec.valid_table))
        # entry collection (vectorized into numpy/FrVec state by finalize())
        self.cyc: list[int] = []
        self.idx: list[int] = []
        # shared accumulators
        self.lin_b = 0
        self.LTb, self.EQb = 0, 1

    # -- class composition ---------------------------------------------------

    def _add_lin(self, positions, g):
        for pos, w in positions:
            self.lin_w[pos] = (self.lin_w[pos] + g * w) % P

    def _add_slot(self, slot, g: int):
        k = slot.g
        if k == G.ZERO:
            return
        if k == G.IDENT128:
            self._add_lin(((i, 1 << i) for i in range(128)), g)
        elif k == G.IDENT_LOW64:
            self._add_lin(((i, 1 << i) for i in range(64)), g)
        elif k == G.IDENT_LOW64_NO0:
            self._add_lin(((i, 1 << i) for i in range(1, 64)), g)
        elif k == G.IDENT_HIGH64:
            self._add_lin(((64 + i, 1 << i) for i in range(64)), g)
        elif k == G.ODDS:
            self._add_lin(((2 * i + 1, 1 << i) for i in range(64)), g)
        elif k == G.EVENS:
            self._add_lin(((2 * i, 1 << i) for i in range(64)), g)
        elif k == G.EVENS_PLUS_ODDS:
            self._add_lin(((i, 1 << (i // 2)) for i in range(128)), g)
        elif k == G.SUB_COMBO:
            self._add_lin(((2 * i + 1, 1 << i) for i in range(64)), g)
            self._add_lin(((2 * i, -(1 << i)) for i in range(64)), g)
            self.cc = (self.cc + g * TWO64) % P
        elif k == G.TABLE:
            t = slot.table
            if t == Table.Sub:
                self._add_lin(((2 * i + 1, 1 << i) for i in range(64)), g)
                self._add_lin(((2 * i, -(1 << i)) for i in range(64)), g)
                assert self.chain is None
                self.chain = (g * TWO64 % P, 0, False)
            elif t in _BITWISE:
                assert self.bitop is None
                self.bitop = (g % P, _BITWISE[t])
            elif t in _SHIFTS:
                assert self.shift is None
                self.shift = (g % P, _SHIFTS[t])
            elif t in _CHAINS:
                bl, be, c, signed = _CHAINS[t]
                assert self.chain is None
                self.chain = (g * bl % P, g * be % P, signed)
                self.cc = (self.cc + g * c) % P
            elif t == Table.SignExtend32:
                # linear over the RAW index bits: low 31 as-is, bit 31
                # replicated into bits 31..63 (virtual SEXT32 rows)
                self._add_lin(((i, 1 << i) for i in range(31)), g)
                self._add_lin(((31, TWO64 - (1 << 31)),), g)
            elif t in (Table.ValidUnsignedRemainder, Table.ValidDiv0):
                # rare: generic per-entry MLE evaluation (same path as the
                # compat div/rem validity side tables)
                self.valids.append((g % P, t))
            else:
                raise ValueError(f"no phase-A machinery for table {t}")
        else:
            raise ValueError(k)

    # -- entries ---------------------------------------------------------------

    def add_entry(self, cycle: int, idx: int):
        self.cyc.append(cycle)
        self.idx.append(idx)

    def bit(self, p: int):
        """(n,) uint16 bit-p of every entry's index."""
        import numpy as np

        if p < 64:
            return ((self._lo >> np.uint64(p)) & np.uint64(1)).astype(np.uint16)
        return ((self._hi >> np.uint64(p - 64)) & np.uint64(1)).astype(np.uint16)

    def finalize(self, eq_src) -> None:
        """Build the vectorized per-entry state (after all add_entry calls).
        `eq_src` is the cycle-indexed eq FrVec; entry weights gather from it."""
        import numpy as np

        from ..native.frvec import FrVec

        M64 = (1 << 64) - 1
        n = self.n = len(self.idx)
        self._lo = np.fromiter((i & M64 for i in self.idx), np.uint64, n)
        self._hi = np.fromiter((i >> 64 for i in self.idx), np.uint64, n)
        self.wt = _gather_frvec(eq_src, np.asarray(self.cyc, np.int64))
        self.pref = FrVec.filled(n, 1)
        self.lin_s = FrVec.zeros(n)
        for p in range(ADDR_VARS):
            w = self.lin_w[p]
            if w:
                self.lin_s.add_by_cat_(self.bit(p), [0, w])
        needs_xy = (self.chain is not None or self.bitop is not None
                    or self.shift is not None)
        if needs_xy:
            x = np.zeros(n, np.uint64)
            y = np.zeros(n, np.uint64)
            for i in range(64):
                x |= self.bit(2 * i + 1).astype(np.uint64) << np.uint64(i)
                y |= self.bit(2 * i).astype(np.uint64) << np.uint64(i)
        if self.chain is not None:
            lt = np.empty((n, 64), np.uint16)
            eq = np.empty((n, 64), np.uint16)
            ltv = np.zeros(n, np.uint16)
            eqvv = np.ones(n, np.uint16)
            for i in range(64):
                lt[:, i] = ltv
                eq[:, i] = eqvv
                xb = ((x >> np.uint64(i)) & np.uint64(1)).astype(np.uint16)
                yb = ((y >> np.uint64(i)) & np.uint64(1)).astype(np.uint16)
                ltv = ((xb < yb) | ((xb == yb) & (ltv == 1))).astype(np.uint16)
                eqvv = (eqvv & (xb == yb)).astype(np.uint16)
            self.lt_b, self.eq_b = lt, eq
        if self.bitop is not None:
            kind = self.bitop[1]
            self.bw = (x & y) if kind == 0 else (x | y) if kind == 1 else (x ^ y)
        if self.shift is not None:
            kind = self.shift[1]
            self.sh_s = (y & np.uint64(63)).astype(np.uint16)
            self.sh_cur = FrVec.zeros(n)
            for i in range(64):
                xb = ((x >> np.uint64(i)) & np.uint64(1)).astype(np.uint16)
                cats = xb + 2 * self.sh_s
                consts = [0] * 128
                for s in range(64):
                    consts[2 * s + 1] = _shift_w(kind, s, i)
                self.sh_cur.add_by_cat_(cats, consts)


def _gather_frvec(src, idxs):
    """FrVec gather: out[i] = src[idxs[i]] (byte-row fancy indexing on the
    Montgomery buffer; int-list fallback for the no-native tier)."""
    import numpy as np

    from ..native.frvec import FrVec

    if src._mont is not None:
        rows = np.frombuffer(memoryview(src._mont), np.uint8,
                             count=32 * src.n).reshape(src.n, 32)
        return FrVec(len(idxs), mont=bytearray(rows[idxs].tobytes()))
    ints = src._ints
    return FrVec(len(idxs), ints=[ints[int(i)] for i in idxs])


def _scatter_frvec(size: int, idxs, src):
    """FrVec scatter into a zero vector: out[idxs[i]] = src[i]."""
    import numpy as np

    from ..native.frvec import FrVec

    if src._mont is not None:
        buf = bytearray(32 * size)
        out = np.frombuffer(buf, np.uint8).reshape(size, 32)
        rows = np.frombuffer(memoryview(src._mont), np.uint8,
                             count=32 * src.n).reshape(src.n, 32)
        out[np.asarray(idxs, np.int64)] = rows
        return FrVec(size, mont=buf)
    vals = [0] * size
    ints = src._ints
    for i, j in enumerate(idxs):
        vals[int(j)] = ints[i]
    return FrVec(size, ints=vals)


def _mixed_point(r_bound: dict[int, int], idx: int, pos: int, c: int) -> list[int]:
    pt = [0] * ADDR_VARS
    for p in range(ADDR_VARS):
        if p in r_bound:
            pt[p] = r_bound[p]
        elif p == pos:
            pt[p] = c
        else:
            pt[p] = (idx >> p) & 1
    return pt


def gm_eval_point(spec: RafSpec, gammas: list[int], point_le128: list[int]) -> int:
    """Gm(point, class) — the combined gadget value WITHOUT the static
    left/right constants (those live in the CONST bytecode table)."""
    v = 0
    for slot, g in ((spec.out, gammas[0]), (spec.left, gammas[1]),
                    (spec.right, gammas[2])):
        if slot.g != G.ZERO:
            v = (v + g * ((gadget_eval_point(slot, point_le128) - slot.const) % P)) % P
    if spec.valid_table is not None:
        v = (v + gammas[3] * tb.evaluate_mle(
            spec.valid_table, list(reversed(point_le128)), 64)) % P
    return v


# ---------------------------------------------------------------------------
# Stage-8 prover
# ---------------------------------------------------------------------------

@dataclass
class Stage8Result:
    compressed_addr: list[list[int]] = dfield(default_factory=list)  # [c0,c2]
    compressed_cycle: list[list[int]] = dfield(default_factory=list)  # [c0,c2,c3]
    r_addr: list[int] = dfield(default_factory=list)   # r_addr[pos] per bit
    r_cycle: list[int] = dfield(default_factory=list)  # phase-B challenges
    gamma: int = 0
    const_claim: int = 0
    valid_rhs: int = 0
    w_claim: int = 0
    cs_claim: int = 0
    final_claim: int = 0
    input_claim: int = 0


def collect_entries(padded_steps):
    """(cycle, index, spec) for every sound-lookup cycle."""
    out = []
    for j, s in enumerate(padded_steps):
        if getattr(s, "is_noop", False):
            continue
        idx = sound_lookup_index(s)
        if idx is None:
            continue
        out.append((j, idx, entry_spec(s.instruction)))
    return out


def _class_key(spec: RafSpec):
    return (spec.out.g, spec.out.table, spec.left.g, spec.right.g,
            spec.valid_table)


def ctable_values(bc_index, gammas: list[int], r_addr_le: list[int],
                  size: int) -> list[int]:
    """Public C(k) table over (padded) bytecode slots: Gm at r_addr per
    slot's class (0 for slots with no lookup)."""
    out = [0] * size
    cache: dict = {}
    for k in range(min(size, bc_index.size)):
        spec = bc_index.raf_spec(k)
        if spec is None:
            continue
        key = _class_key(spec)
        if key not in cache:
            cache[key] = gm_eval_point(spec, gammas, r_addr_le)
        out[k] = cache[key]
    return out


def const_table(bc_index, gammas: list[int], size: int) -> list[int]:
    """Public CONST(k) table: the static additive operand constants."""
    out = [0] * size
    for k in range(min(size, bc_index.size)):
        spec = bc_index.raf_spec(k)
        if spec is None:
            continue
        out[k] = (gammas[0] * spec.out.const + gammas[1] * spec.left.const
                  + gammas[2] * spec.right.const) % P
    return out


def prove_stage8(transcript, padded_steps, bc_index, lo_claim: int,
                 left_claim: int, right_claim: int, r_cycle_be: list[int],
                 n_cycle_vars: int) -> Stage8Result:
    from ..native.frvec import FrVec

    import numpy as np

    res = Stage8Result()
    T = 1 << n_cycle_vars
    g = transcript.challenge_scalar_full()
    res.gamma = g
    gammas = [1, g, g * g % P, g * g % P * g % P]

    eq_fr = FrVec.eq_table_be([c % P for c in r_cycle_be])
    entries = collect_entries(padded_steps)
    slots = bc_index.slots_per_cycle(padded_steps)
    slots_np = np.asarray(slots, np.int64)

    # public-claim components (proven by the BytecodeReadRaf stage):
    # const_c = Σ_j eq[j]·CONST(slot_j) as an FrVec inner product over a
    # per-slot gather; valid_c = Σ_j eq[j]·HasValidity(slot_j) as a
    # 2-category weighted sum
    n_slots = bc_index.size
    const_per_slot = [0] * n_slots
    hv_per_slot = np.zeros(n_slots, np.uint16)
    for k in range(n_slots):
        spec = bc_index.raf_spec(k)
        if spec is None:
            continue
        const_per_slot[k] = (gammas[0] * spec.out.const
                             + gammas[1] * spec.left.const
                             + gammas[2] * spec.right.const) % P
        if spec.valid_table is not None:
            hv_per_slot[k] = 1
    const_c = eq_fr.inner(_gather_frvec(FrVec.from_ints(const_per_slot),
                                        slots_np))
    valid_c = FrVec.cat_wsum(eq_fr, None, hv_per_slot[slots_np], 2)[1]
    res.const_claim, res.valid_rhs = const_c, valid_c
    transcript.append_scalar(const_c)
    transcript.append_scalar(valid_c)

    claim = (lo_claim + g * left_claim + gammas[2] * right_claim
             - const_c + gammas[3] * valid_c) % P
    res.input_claim = claim

    # ---- group entries by class -------------------------------------------
    groups: dict = {}
    for (j, idx, spec) in entries:
        key = _class_key(spec)
        grp = groups.get(key)
        if grp is None:
            grp = groups[key] = ClassGroup(spec, gammas)
        grp.add_entry(j, idx)
    grouplist = list(groups.values())
    for grp in grouplist:
        grp.finalize(eq_fr)

    r_bound: dict[int, int] = {}
    last_x_challenge = 0

    # ---- Phase A: address rounds, MSB first --------------------------------
    # Vectorized: per group per round, 2-4 native category-sum passes over
    # the entry vectors (frv_cat_wsum) + O(1) host combination of the shared
    # gadget tables; state updates are per-category native kernels.
    for pos in range(ADDR_VARS - 1, ENDGAME_VARS - 1, -1):
        is_x = (pos & 1) == 1
        pair = pos >> 1
        e0 = e2 = 0
        round_bits = []    # per-group bit arrays, reused by the fold pass
        for grp in grouplist:
            wp = grp.lin_w[pos]
            ch, bo, sh, va = grp.chain, grp.bitop, grp.shift, grp.valids
            bit = grp.bit(pos)
            round_bits.append(bit)
            # remove this position from the per-entry linear suffix state
            if wp:
                grp.lin_s.add_by_cat_(bit, [0, (-wp) % P])
            L = FrVec.cat_wsum(grp.wt, grp.lin_s, bit, 2)
            Wb = None
            S0 = S2m = S2p = 0
            if ch is not None:
                bl, be, signed = ch
                ltb, eqb = grp.LTb, grp.EQb
                lt_i = grp.lt_b[:, pair]
                eq_i = grp.eq_b[:, pair]

                def chain_add(c, ob_or_rx, lt_v, eq_v):
                    if is_x:
                        ob = ob_or_rx
                        if signed and pair == 63:
                            ltt = c * (1 - ob)
                        else:
                            ltt = (1 - c) * ob
                        eqt = c * ob + (1 - c) * (1 - ob)
                    else:
                        rx = ob_or_rx
                        if signed and pair == 63:
                            ltt = rx * (1 - c) % P
                        else:
                            ltt = (1 - rx) * c % P
                        eqt = (rx * c + (1 - rx) * (1 - c)) % P
                    return (bl * (ltb + eqb * ((ltt + eqt * lt_v) % P))
                            + be * (eqb * eqt % P * eq_v)) % P

                if is_x:
                    ob = grp.bit(pos - 1)
                    cat = bit + 2 * ob + 4 * lt_i + 8 * eq_i
                    W = FrVec.cat_wsum(grp.wt, None, cat, 16)
                    Wb = [sum(W[c4] for c4 in range(0, 16, 2)) % P,
                          sum(W[c4] for c4 in range(1, 16, 2)) % P]
                    for o in (0, 1):
                        for lv in (0, 1):
                            for ev in (0, 1):
                                bc = 2 * o + 4 * lv + 8 * ev
                                a0 = chain_add(0, o, lv, ev)
                                a2 = chain_add(2, o, lv, ev)
                                S0 += a0 * W[bc]
                                S2m += a2 * W[bc]
                                S2p += a2 * W[bc + 1]
                else:
                    rx = last_x_challenge
                    cat = bit + 2 * lt_i + 4 * eq_i
                    W = FrVec.cat_wsum(grp.wt, None, cat, 8)
                    Wb = [sum(W[c4] for c4 in range(0, 8, 2)) % P,
                          sum(W[c4] for c4 in range(1, 8, 2)) % P]
                    for lv in (0, 1):
                        for ev in (0, 1):
                            bc = 2 * lv + 4 * ev
                            a0 = chain_add(0, rx, lv, ev)
                            a2 = chain_add(2, rx, lv, ev)
                            S0 += a0 * W[bc]
                            S2m += a2 * W[bc]
                            S2p += a2 * W[bc + 1]
            elif bo is not None:
                coeff, kind = bo
                pw = (1 << pair) % P
                if is_x:
                    # strip the pair bit from the suffix sum (x round only)
                    grp.bw = grp.bw & ~np.uint64(1 << pair)
                    ob = grp.bit(pos - 1)
                    cat = bit + 2 * ob
                    W = FrVec.cat_wsum(grp.wt, None, cat, 4)
                    Wb = [(W[0] + W[2]) % P, (W[1] + W[3]) % P]
                    R = FrVec.cat_wsum(grp.wt, grp.bw, bit, 2)
                    for o in (0, 1):
                        t0v = coeff * pw % P * _bit_op(kind, 0, o) % P
                        t2v = coeff * pw % P * _bit_op(kind, 2, o) % P
                        S0 += t0v * W[2 * o]
                        S2m += t2v * W[2 * o]
                        S2p += t2v * W[2 * o + 1]
                else:
                    rx = last_x_challenge
                    W = FrVec.cat_wsum(grp.wt, None, bit, 2)
                    Wb = list(W)
                    R = FrVec.cat_wsum(grp.wt, grp.bw, bit, 2)
                    t0v = coeff * pw % P * _bit_op(kind, rx, 0) % P
                    t2v = coeff * pw % P * _bit_op(kind, rx, 2) % P
                    S0 += t0v * Wb[0]
                    S2m += t2v * Wb[0]
                    S2p += t2v * Wb[1]
                S0 += coeff * R[0]
                S2m += coeff * R[0]
                S2p += coeff * R[1]
            elif sh is not None:
                coeff, kind = sh
                if is_x:
                    w_s = [_shift_w(kind, s, pair) for s in range(64)]
                    # strip for bit=1 entries before use
                    strip = [0] * 128
                    for s in range(64):
                        strip[2 * s + 1] = (-w_s[s]) % P
                    grp.sh_cur.add_by_cat_(bit + 2 * grp.sh_s, strip)
                    W = FrVec.cat_wsum(grp.wt, None, bit + 2 * grp.sh_s, 128)
                    Wb = [sum(W[2 * s] for s in range(64)) % P,
                          sum(W[2 * s + 1] for s in range(64)) % P]
                    Ssh = FrVec.cat_wsum(grp.wt, grp.sh_cur, bit, 2)
                    S0 += coeff * Ssh[0]
                    tw0 = sum(2 * w_s[s] * W[2 * s] for s in range(64)) % P
                    tw1 = sum(2 * w_s[s] * W[2 * s + 1] for s in range(64)) % P
                    S2m += coeff * ((Ssh[0] + tw0) % P)
                    S2p += coeff * ((Ssh[1] + tw1) % P)
                else:
                    W = FrVec.cat_wsum(grp.wt, None, bit, 2)
                    Wb = list(W)
                    Ssh = FrVec.cat_wsum(grp.wt, grp.sh_cur, bit, 2)
                    S0 += coeff * Ssh[0]
                    S2m += coeff * Ssh[0]
                    S2p += coeff * Ssh[1]
            if Wb is None:
                W = FrVec.cat_wsum(grp.wt, None, bit, 2)
                Wb = list(W)
            A0 = (grp.cc + grp.lin_b) % P
            S0 += A0 * Wb[0] + L[0]
            S2m += (A0 + 2 * wp) * Wb[0] + L[0]
            S2p += (A0 + 2 * wp) * Wb[1] + L[1]
            if va:
                # rare validity tables: generic per-entry evaluation
                wt_ints = grp.wt.to_ints()
                for coeff, vt in va:
                    for t in range(grp.n):
                        idx = grp.idx[t]
                        b = (idx >> pos) & 1
                        pt = _mixed_point(r_bound, idx, pos, 0)
                        val0 = tb.evaluate_mle(vt, list(reversed(pt)), 64)
                        pt[pos] = 2
                        val2 = tb.evaluate_mle(vt, list(reversed(pt)), 64)
                        if b:
                            S2p += wt_ints[t] * (coeff * val2 % P)
                        else:
                            S0 += wt_ints[t] * (coeff * val0 % P)
                            S2m += wt_ints[t] * (coeff * val2 % P)
            e0 += S0
            e2 += 2 * S2p - S2m
        e0 %= P
        e2 %= P
        e1 = (claim - e0) % P
        compressed = unipoly.compress(unipoly.interpolate([e0, e1, e2]))
        res.compressed_addr.append(compressed)
        r = _absorb_round(transcript, compressed)
        r_bound[pos] = r
        claim = _eval2(compressed, claim, r)
        if is_x:
            last_x_challenge = r
        # fold per-entry / shared state
        omr = (1 - r) % P
        for grp, bit in zip(grouplist, round_bits):
            wp = grp.lin_w[pos]
            grp.lin_b = (grp.lin_b + wp * r) % P
            grp.wt.scale_by_cat_(bit, [omr, r])
            grp.pref.scale_by_cat_(bit, [omr, r])
            if grp.shift is not None and is_x:
                kind = grp.shift[1]
                upd = [_shift_w(kind, s, pair) * r % P for s in range(64)]
                grp.sh_cur.add_by_cat_(grp.sh_s, upd)
            if grp.chain is not None and not is_x:
                bl_, be_, signed = grp.chain
                rx = last_x_challenge
                if signed and pair == 63:
                    ltt = rx * (1 - r) % P
                else:
                    ltt = (1 - rx) * r % P
                eqt = (rx * r + (1 - rx) * (1 - r)) % P
                grp.LTb = (grp.LTb + grp.EQb * ltt) % P
                grp.EQb = grp.EQb * eqt % P
            if grp.bitop is not None and not is_x:
                # pair fully bound: fold into the shared bound sum via cc?
                # bound pairs contribute a SHARED value: add to lin_b-like cc
                coeff, kind = grp.bitop
                grp.cc = (grp.cc + coeff * (1 << pair) % P
                          * _bit_op(kind, last_x_challenge, r)) % P

    # ---- Endgame: dense 2^12 tables ----------------------------------------
    size = 1 << ENDGAME_VARS
    dense: list[tuple[list[int], list[int]]] = []
    endgame_valid: list[tuple] = []
    for grp in grouplist:
        V = [0] * size
        bsum = None
        if grp.shift is not None:
            coeff_s, kind = grp.shift
            bsum = [0] * 64
            for s in range(64):
                acc = 0
                for i in range(6, 64):
                    xpos = 2 * i + 1
                    if xpos in r_bound:
                        w = _shift_w(kind, s, i)
                        if w:
                            acc += w * r_bound[xpos]
                bsum[s] = acc % P
        for w in range(size):
            base = grp.cc + grp.lin_b
            for posn in range(ENDGAME_VARS):
                if (w >> posn) & 1:
                    base += grp.lin_w[posn]
            if grp.chain is not None:
                bl, be, signed = grp.chain
                xr = sum(((w >> (2 * i + 1)) & 1) << i for i in range(6))
                yr = sum(((w >> (2 * i)) & 1) << i for i in range(6))
                ltr = 1 if xr < yr else 0
                eqr = 1 if xr == yr else 0
                base += bl * ((grp.LTb + grp.EQb * ltr) % P) \
                    + be * (grp.EQb * eqr % P)
            if grp.bitop is not None:
                coeff, kind = grp.bitop
                xr = sum(((w >> (2 * i + 1)) & 1) << i for i in range(6))
                yr = sum(((w >> (2 * i)) & 1) << i for i in range(6))
                v = (xr & yr) if kind == 0 else (xr | yr) if kind == 1 \
                    else (xr ^ yr)
                base += coeff * v
            if grp.shift is not None:
                coeff_s, kind = grp.shift
                s = sum(((w >> (2 * i)) & 1) << i for i in range(6))
                acc = bsum[s]
                for i in range(6):
                    if (w >> (2 * i + 1)) & 1:
                        acc += _shift_w(kind, s, i)
                base += coeff_s * (acc % P)
            V[w] = base % P
        low_cat = (grp._lo & np.uint64(size - 1)).astype(np.uint16)
        A = FrVec.cat_wsum(grp.wt, None, low_cat, size)
        dense.append((A, V))
        if grp.valids:
            wt_ints = grp.wt.to_ints()
            for coeff, vt in grp.valids:
                for t in range(grp.n):
                    endgame_valid.append((coeff, vt, grp.idx[t], wt_ints[t]))

    eg_challenges: list[int] = []
    for pos in range(ENDGAME_VARS - 1, -1, -1):
        half = 1 << pos
        e0 = e2 = 0
        for (A, V) in dense:
            for w in range(half):
                a0, a1 = A[w], A[w | half]
                v0, v1 = V[w], V[w | half]
                e0 += a0 * v0
                e2 += (2 * a1 - a0) * (2 * v1 - v0)
        for (coeff, vt, idx, wt) in endgame_valid:
            # weight: chi over already-bound endgame bits
            pw = wt
            for p2, rr in zip(range(ENDGAME_VARS - 1, pos, -1), eg_challenges):
                b = (idx >> p2) & 1
                pw = pw * (rr if b else (1 - rr)) % P
            bit = (idx >> pos) & 1
            pt = _mixed_point(r_bound, idx, pos, 0)
            val0 = tb.evaluate_mle(vt, list(reversed(pt)), 64)
            pt[pos] = 2
            val2 = tb.evaluate_mle(vt, list(reversed(pt)), 64)
            if bit:
                e2 += pw * 2 % P * (coeff * val2 % P)
            else:
                e0 += pw * (coeff * val0 % P)
                e2 -= pw * (coeff * val2 % P)
        e0 %= P
        e2 %= P
        e1 = (claim - e0) % P
        compressed = unipoly.compress(unipoly.interpolate([e0, e1, e2]))
        res.compressed_addr.append(compressed)
        r = _absorb_round(transcript, compressed)
        r_bound[pos] = r
        eg_challenges.append(r)
        claim = _eval2(compressed, claim, r)
        nxt = []
        for (A, V) in dense:
            A = [(A[w] + r * (A[w | half] - A[w])) % P for w in range(half)]
            V = [(V[w] + r * (V[w | half] - V[w])) % P for w in range(half)]
            nxt.append((A, V))
        dense = nxt

    res.r_addr = [r_bound[p] for p in range(ADDR_VARS)]   # LE by bit position

    # ---- Phase B: cycle rounds over eq * w * C(slot) ------------------------
    wf = FrVec.zeros(T)
    for grp in grouplist:
        for posn in range(ENDGAME_VARS):
            rr = r_bound[posn] % P
            grp.pref.scale_by_cat_(grp.bit(posn), [(1 - rr) % P, rr])
        wf = wf.add(_scatter_frvec(T, grp.cyc, grp.pref))
    ctab = ctable_values(bc_index, gammas, res.r_addr, bc_index.size)

    eqf = eq_fr
    cf = _gather_frvec(FrVec.from_ints(ctab), slots_np)
    for _ in range(n_cycle_vars):
        evs = FrVec.prod_evals_adj([eqf, wf, cf], 3)
        e1 = (claim - evs[0]) % P
        compressed = unipoly.evals_to_compressed([evs[0], e1, evs[2], evs[3]])
        res.compressed_cycle.append(compressed)
        r = _absorb_round(transcript, compressed)
        res.r_cycle.append(r)
        claim = _eval3(compressed, claim, r)
        eqf = eqf.fold_adj(r)
        wf = wf.fold_adj(r)
        cf = cf.fold_adj(r)

    res.final_claim = claim
    res.w_claim = wf.first()
    res.cs_claim = cf.first()
    transcript.append_scalar(res.w_claim)
    transcript.append_scalar(res.cs_claim)
    return res


def _eval3(compressed3: list[int], hint: int, x: int) -> int:
    from .stage2_batch import eval_from_hint

    return eval_from_hint(compressed3, hint, x)


# ---------------------------------------------------------------------------
# Slow differential oracle (tests): per-round generic closed-form evaluation
# ---------------------------------------------------------------------------

def slow_phase_a_round_evals(entries, gammas, eqv, r_bound, pos, claim):
    """Phase A's round evals (e0, e2) at address bit `pos`, summed entry by
    entry from the closed form: each entry's eq weight times the χ of its
    index bits bound so far (`r_bound`: bit -> challenge), times its
    lookup polynomial at the mixed point (bound bits at their challenges,
    bit `pos` at c = 0 or 2, the rest at the index's bits). `claim` is
    unused, as in the JAX package's oracle."""
    e0 = e2 = 0
    for (j, idx, spec) in entries:
        pref = 1
        for p, rr in r_bound.items():
            b = (idx >> p) & 1
            pref = pref * (rr if b else (1 - rr)) % P
        wt = eqv[j] * pref % P
        bit = (idx >> pos) & 1
        for c in (0, 2):
            pt = _mixed_point(r_bound, idx, pos, c)
            val = gm_eval_point(spec, gammas, pt)
            chi = (1 - bit) if c == 0 else (2 if bit else -1)
            if c == 0:
                e0 += wt * chi % P * val
            else:
                e2 += wt * chi % P * val
    return e0 % P, e2 % P


# ---------------------------------------------------------------------------
# Stage-8 verifier
# ---------------------------------------------------------------------------

def verify_stage8(transcript, proof: Stage8Result, lo_claim: int,
                  left_claim: int, right_claim: int, r_cycle_be: list[int],
                  n_cycle_vars: int):
    """Replay the stage-8 transcript; returns (ok, info) where info carries
    the points/claims consumed by stages 9 and the bytecode read-check."""
    g = transcript.challenge_scalar_full()
    if g != proof.gamma % P:
        return False, {}
    gammas = [1, g, g * g % P, g * g % P * g % P]
    transcript.append_scalar(proof.const_claim % P)
    transcript.append_scalar(proof.valid_rhs % P)
    claim = (lo_claim + g * left_claim + gammas[2] * right_claim
             - proof.const_claim + gammas[3] * proof.valid_rhs) % P
    if len(proof.compressed_addr) != ADDR_VARS:
        return False, {}
    if len(proof.compressed_cycle) != n_cycle_vars:
        return False, {}
    r_addr_msb_first = []
    for cp in proof.compressed_addr:
        if len(cp) != 2:
            return False, {}
        r = _absorb_round(transcript, cp)
        r_addr_msb_first.append(r)
        claim = _eval2(cp, claim, r)
    r_cycle = []
    for cp in proof.compressed_cycle:
        if len(cp) != 3:
            return False, {}
        r = _absorb_round(transcript, cp)
        r_cycle.append(r)
        claim = _eval3(cp, claim, r)
    transcript.append_scalar(proof.w_claim % P)
    transcript.append_scalar(proof.cs_claim % P)
    # final identity: claim == eq(rc1, r_cycle) * w * cs
    eq_end = eq_point_eval(list(reversed([c % P for c in r_cycle_be])), r_cycle)
    ok = claim == eq_end * (proof.w_claim % P) % P * (proof.cs_claim % P) % P
    r_addr_le = [0] * ADDR_VARS
    for i, rr in enumerate(r_addr_msb_first):
        r_addr_le[ADDR_VARS - 1 - i] = rr
    info = {"gammas": gammas, "r_addr": r_addr_le, "r_cycle": r_cycle,
            "w_claim": proof.w_claim % P, "cs_claim": proof.cs_claim % P,
            "const_claim": proof.const_claim % P,
            "valid_rhs": proof.valid_rhs % P}
    return ok, info


# ---------------------------------------------------------------------------
# Stage 9: InstructionRaVirtualization — bind w_claim to the committed
# one-hot InstructionRa chunks (degree 33 sumcheck over the cycle cube)
# ---------------------------------------------------------------------------

@dataclass
class Stage9Result:
    compressed_polys: list[list[int]] = dfield(default_factory=list)
    challenges: list[int] = dfield(default_factory=list)
    oh_claims: list[int] = dfield(default_factory=list)
    final_claim: int = 0


def chunk_points(r_addr_le: list[int]) -> list[list[int]]:
    """4-bit LE point slice per committed chunk d (chunk 0 = high bits,
    commitments.build_instruction_ra layout: shift = 4*(D-1-d))."""
    out = []
    for d in range(INSTRUCTION_D):
        sh = LOG_K_CHUNK * (INSTRUCTION_D - 1 - d)
        out.append(r_addr_le[sh:sh + LOG_K_CHUNK])
    return out


def _eq_le_bits(r: list[int], v: int) -> int:
    out = 1
    for i, ri in enumerate(r):
        out = out * (ri if (v >> i) & 1 else (1 - ri)) % P
    return out


def prove_stage9(transcript, padded_steps, r_addr_le: list[int],
                 r_cycle8: list[int], w_claim: int,
                 n_cycle_vars: int) -> Stage9Result:
    from ..native.frvec import FrVec
    from .stage67 import eval_from_hint_any

    res = Stage9Result()
    T = 1 << n_cycle_vars
    pts = chunk_points(r_addr_le)
    luts = [[_eq_le_bits(pts[d], v) for v in range(16)]
            for d in range(INSTRUCTION_D)]

    oh_l = [[0] * T for _ in range(INSTRUCTION_D)]
    for j, s in enumerate(padded_steps):
        if getattr(s, "is_noop", False):
            continue
        idx = sound_lookup_index(s)
        if idx is None:
            continue
        for d in range(INSTRUCTION_D):
            sh = LOG_K_CHUNK * (INSTRUCTION_D - 1 - d)
            oh_l[d][j] = luts[d][(idx >> sh) & 15]

    eqf = FrVec.eq_table_be(list(reversed([c % P for c in r_cycle8])))
    oh = [FrVec.from_ints(t) for t in oh_l]
    deg = INSTRUCTION_D + 1
    claim = w_claim % P
    for _ in range(n_cycle_vars):
        evs = FrVec.prod_evals_adj([eqf] + oh, deg)
        compressed = unipoly.compress(unipoly.interpolate(evs))
        res.compressed_polys.append(compressed)
        r = _absorb_round(transcript, compressed)
        res.challenges.append(r)
        claim = eval_from_hint_any(compressed, claim, r)
        eqf = eqf.fold_adj(r)
        oh = [t.fold_adj(r) for t in oh]
    res.final_claim = claim
    res.oh_claims = [t.first() for t in oh]
    for v in res.oh_claims:
        transcript.append_scalar(v)
    return res


def verify_stage9(transcript, compressed_polys, oh_claims, r_cycle8,
                  w_claim: int, n_cycle_vars: int):
    from .stage67 import eval_from_hint_any

    if len(compressed_polys) != n_cycle_vars:
        return False, []
    claim = w_claim % P
    challenges = []
    for cp in compressed_polys:
        if len(cp) != INSTRUCTION_D + 1:
            return False, []
        r = _absorb_round(transcript, cp)
        challenges.append(r)
        claim = eval_from_hint_any(cp, claim, r)
    for v in oh_claims:
        transcript.append_scalar(v % P)
    eq_end = eq_point_eval(r_cycle8, challenges)
    expected = eq_end
    for v in oh_claims:
        expected = expected * (v % P) % P
    return claim == expected, challenges
