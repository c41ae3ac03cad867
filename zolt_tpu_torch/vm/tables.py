"""The 24 Jolt lookup tables: materialization + MLE evaluation.

Semantics match the reference exactly (src/zkvm/lookup_table/mod.zig:84-1160):
two-operand tables take a bit-interleaved index (x in odd/high positions, y in
even/low), single-operand tables use the raw index. `xlen` parameterizes the
operand width — 64 for full instruction semantics, 8 for the 2^16-entry
materialized tables used by the Lasso address phase.

Each table provides:
  materialize_entry(index, xlen) -> int      the table value at an index
  evaluate_mle(r, xlen) -> int               closed-form MLE at a 2·xlen point
                                             (big-endian bit order: r[0] is the
                                             MSB pair, matching the reference)
"""

from __future__ import annotations

from enum import IntEnum

from ..field.params import FR

P = FR.p


def _spread64(x: int) -> int:
    """Spread a 64-bit value's bits to the even positions of a 128-bit value
    (Morton encoding; 6 shift-mask steps instead of a 64-iteration loop)."""
    x = (x | (x << 32)) & 0x00000000FFFFFFFF00000000FFFFFFFF
    x = (x | (x << 16)) & 0x0000FFFF0000FFFF0000FFFF0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF00FF00FF00FF00FF00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F0F0F0F0F0F0F0F0F0F0F0F0F
    x = (x | (x << 2)) & 0x33333333333333333333333333333333
    x = (x | (x << 1)) & 0x55555555555555555555555555555555
    return x


def interleave_bits(x: int, y: int, xlen: int = 64) -> int:
    """x bits to odd positions (higher), y to even: index bit 2i = y_i, 2i+1 = x_i."""
    if xlen == 64:
        return (_spread64(x) << 1) | _spread64(y)
    out = 0
    for i in range(xlen):
        out |= ((y >> i) & 1) << (2 * i)
        out |= ((x >> i) & 1) << (2 * i + 1)
    return out


def uninterleave_bits(index: int, xlen: int = 64) -> tuple[int, int]:
    x = y = 0
    for i in range(xlen):
        y |= ((index >> (2 * i)) & 1) << i
        x |= ((index >> (2 * i + 1)) & 1) << i
    return x, y


def _mask(xlen: int) -> int:
    return (1 << xlen) - 1


def _sign(v: int, xlen: int) -> int:
    return v - (1 << xlen) if v >> (xlen - 1) else v


class Table(IntEnum):
    """Order matches the reference LookupTables enum (instruction/mod.zig:165-192)."""

    RangeCheck = 0
    And = 1
    Or = 2
    Xor = 3
    Equal = 4
    NotEqual = 5
    UnsignedLessThan = 6
    SignedLessThan = 7
    UnsignedGreaterThanEqual = 8
    UnsignedLessThanEqual = 9
    SignedGreaterThanEqual = 10
    Movsign = 11
    Sub = 12
    Andn = 13
    LeftShift = 14
    RightShift = 15
    RightShiftArithmetic = 16
    Pow2 = 17
    SignExtend8 = 18
    SignExtend16 = 19
    SignExtend32 = 20
    ValidDiv0 = 21
    ValidUnsignedRemainder = 22
    ValidSignedRemainder = 23


def materialize_entry(table: Table, index: int, xlen: int = 64) -> int:
    m = _mask(xlen)
    if table == Table.RangeCheck:
        return index & m if xlen == 64 else index % (1 << xlen)
    if table == Table.Pow2:
        y = index & (xlen - 1)
        return (1 << y) & m
    if table == Table.SignExtend8:
        return _sign(index & 0xFF, 8) & m
    if table == Table.SignExtend16:
        return _sign(index & 0xFFFF, 16) & m
    if table == Table.SignExtend32:
        return _sign(index & 0xFFFFFFFF, 32) & m

    x, y = uninterleave_bits(index, xlen)
    if table == Table.And:
        return x & y
    if table == Table.Or:
        return x | y
    if table == Table.Xor:
        return x ^ y
    if table == Table.Equal:
        return 1 if x == y else 0
    if table == Table.NotEqual:
        return 1 if x != y else 0
    if table == Table.UnsignedLessThan:
        return 1 if x < y else 0
    if table == Table.SignedLessThan:
        return 1 if _sign(x, xlen) < _sign(y, xlen) else 0
    if table == Table.UnsignedGreaterThanEqual:
        return 1 if x >= y else 0
    if table == Table.UnsignedLessThanEqual:
        return 1 if x <= y else 0
    if table == Table.SignedGreaterThanEqual:
        return 1 if _sign(x, xlen) >= _sign(y, xlen) else 0
    if table == Table.Movsign:
        return (x >> (xlen - 1)) & 1
    if table == Table.Sub:
        return (x - y) & m
    if table == Table.Andn:
        return x & (~y & m)
    if table == Table.LeftShift:
        sh = y & (xlen - 1)
        return ((x & m) << sh) & m
    if table == Table.RightShift:
        sh = y & (xlen - 1)
        return (x & m) >> sh
    if table == Table.RightShiftArithmetic:
        sh = y & (xlen - 1)
        return (_sign(x & m, xlen) >> sh) & m
    if table == Table.ValidDiv0:
        divisor, quotient = x, y
        if divisor == 0:
            return 1 if quotient == m else 0
        return 1
    if table == Table.ValidUnsignedRemainder:
        remainder, divisor = x, y
        return 1 if (divisor == 0 or remainder < divisor) else 0
    if table == Table.ValidSignedRemainder:
        rem, div = _sign(x, xlen), _sign(y, xlen)
        if rem == 0 or div == 0:
            return 1
        return 1 if (abs(rem) < abs(div) and (rem < 0) == (div < 0)) else 0
    raise ValueError(table)


def materialize(table: Table, xlen: int = 8) -> list[int]:
    """Full 2^(2·xlen)-entry table (2^16 at xlen=8)."""
    size = 1 << (2 * xlen)
    return [materialize_entry(table, i, xlen) for i in range(size)]


# ---------------------------------------------------------------------------
# Closed-form MLEs. r has 2*xlen entries, big-endian: r[2i]/r[2i+1] are the
# x/y bits of significance xlen-1-i (matching reference evaluateMLE).
# ---------------------------------------------------------------------------

def _bitpair(r, i):
    return r[2 * i], r[2 * i + 1]


def evaluate_mle(table: Table, r: list[int], xlen: int = 64) -> int:
    assert len(r) == 2 * xlen
    one = 1

    def eq_bits(a, b):
        return (a * b + (1 - a) * (1 - b)) % P

    if table == Table.RangeCheck:
        # value bits are the LOW xlen bits of the index: r[xlen + i]
        return sum((1 << (xlen - 1 - i)) * r[xlen + i] for i in range(xlen)) % P
    if table == Table.And:
        return sum((1 << (xlen - 1 - i)) * (r[2 * i] * r[2 * i + 1] % P)
                   for i in range(xlen)) % P
    if table == Table.Or:
        acc = 0
        for i in range(xlen):
            x, y = _bitpair(r, i)
            acc += (1 << (xlen - 1 - i)) * ((x + y - x * y) % P)
        return acc % P
    if table == Table.Xor:
        acc = 0
        for i in range(xlen):
            x, y = _bitpair(r, i)
            acc += (1 << (xlen - 1 - i)) * ((x + y - 2 * x * y) % P)
        return acc % P
    if table == Table.Equal:
        acc = one
        for i in range(xlen):
            x, y = _bitpair(r, i)
            acc = acc * eq_bits(x, y) % P
        return acc
    if table == Table.NotEqual:
        return (1 - evaluate_mle(Table.Equal, r, xlen)) % P
    if table == Table.UnsignedLessThan:
        # LT(x,y) = Σ_i (1-x_i)·y_i · Π_{j<i} eq(x_j,y_j)  (big-endian prefix)
        acc = 0
        prefix = one
        for i in range(xlen):
            x, y = _bitpair(r, i)
            acc = (acc + prefix * ((1 - x) * y % P)) % P
            prefix = prefix * eq_bits(x, y) % P
        return acc
    if table == Table.UnsignedGreaterThanEqual:
        return (1 - evaluate_mle(Table.UnsignedLessThan, r, xlen)) % P
    if table == Table.UnsignedLessThanEqual:
        lt = evaluate_mle(Table.UnsignedLessThan, r, xlen)
        eq = evaluate_mle(Table.Equal, r, xlen)
        return (lt + eq) % P
    if table == Table.SignedLessThan:
        # split on sign bits: x<y signed = x_s(1-y_s) + eq(x_s,y_s)·LT(rest)
        xs, ys = _bitpair(r, 0)
        lt_rest = evaluate_mle(Table.UnsignedLessThan, r[2:], xlen - 1) if xlen > 1 else 0
        return (xs * (1 - ys) + eq_bits(xs, ys) * lt_rest) % P
    if table == Table.SignedGreaterThanEqual:
        return (1 - evaluate_mle(Table.SignedLessThan, r, xlen)) % P
    if table == Table.Movsign:
        return r[0] % P  # MSB of x

    # -- closed forms for the remaining tables (reference has per-table
    # evaluateMLE in lookup_table/mod.zig:84-1160; these are independent
    # derivations of the same multilinear extensions) ---------------------

    if table == Table.Sub:
        # (x − y) mod 2^W = x − y + 2^W·[x < y]; all three summands are
        # multilinear, and the sum agrees with the table on the cube, so it
        # IS the MLE.
        X = sum((1 << (xlen - 1 - i)) * r[2 * i] for i in range(xlen)) % P
        Y = sum((1 << (xlen - 1 - i)) * r[2 * i + 1] for i in range(xlen)) % P
        lt = evaluate_mle(Table.UnsignedLessThan, r, xlen)
        return (X - Y + (1 << xlen) * lt) % P
    if table == Table.Andn:
        acc = 0
        for i in range(xlen):
            x, y = _bitpair(r, i)
            acc += (1 << (xlen - 1 - i)) * (x * (1 - y) % P)
        return acc % P

    if table in (Table.LeftShift, Table.RightShift, Table.RightShiftArithmetic):
        # value = Σ_s [y mod W == s]·shift_s(x): the shift-amount indicator
        # is an eq over y's low log2(W) bits, shift_s(x) is linear in the x
        # bits — O(W·(W+log W)) field ops at any xlen.
        nsh = (xlen - 1).bit_length()
        # significance-b bit of y / x (big-endian pairs: pair i ↔ bit xlen-1-i)
        ybit = [r[2 * (xlen - 1 - b) + 1] for b in range(nsh)]
        xbit = [r[2 * (xlen - 1 - b)] for b in range(xlen)]
        acc = 0
        for s in range(xlen):
            eq_s = one
            for b in range(nsh):
                t = ybit[b] if (s >> b) & 1 else (1 - ybit[b])
                eq_s = eq_s * t % P
                if eq_s == 0:
                    break  # binary shift bits: only one s survives —
                    # keeps mixed-point evaluation (Lasso prefix–suffix
                    # style, field prefix + binary suffix) at O(xlen)
            if eq_s == 0:
                continue
            if table == Table.LeftShift:
                val = sum((1 << (i + s)) * xbit[i] for i in range(xlen - s))
            else:
                val = sum((1 << (i - s)) * xbit[i] for i in range(s, xlen))
                if table == Table.RightShiftArithmetic and s > 0:
                    val += ((1 << xlen) - (1 << (xlen - s))) * xbit[xlen - 1]
            acc = (acc + eq_s * (val % P)) % P
        return acc
    if table == Table.Pow2:
        nsh = (xlen - 1).bit_length()
        ybit = [r[2 * xlen - 1 - b] for b in range(nsh)]  # raw index bit b
        acc = 0
        for s in range(xlen):
            eq_s = one
            for b in range(nsh):
                t = ybit[b] if (s >> b) & 1 else (1 - ybit[b])
                eq_s = eq_s * t % P
                if eq_s == 0:
                    break
            acc = (acc + eq_s * (1 << s)) % P
        return acc
    if table in (Table.SignExtend8, Table.SignExtend16, Table.SignExtend32):
        k = {Table.SignExtend8: 8, Table.SignExtend16: 16,
             Table.SignExtend32: 32}[table]
        if k >= xlen:
            # the & mask(xlen) kills the sign fill (2^k ≡ 0 mod 2^xlen):
            # plain low-xlen-bits identity
            return sum((1 << j) * r[2 * xlen - 1 - j] for j in range(xlen)) % P
        bits = [r[2 * xlen - 1 - j] for j in range(k)]  # raw index bit j
        acc = sum((1 << j) * bits[j] for j in range(k - 1))
        acc += ((1 << xlen) - (1 << (k - 1))) * bits[k - 1]
        return acc % P

    if table == Table.ValidDiv0:
        # (divisor, quotient) = (x, y): 1 − [div == 0]·(1 − [quot all-ones]);
        # the two indicators use disjoint variables, so the product is
        # multilinear.
        z_d = one
        all_q = one
        for i in range(xlen):
            x, y = _bitpair(r, i)
            z_d = z_d * ((1 - x) % P) % P
            all_q = all_q * y % P
        return (1 - z_d * ((1 - all_q) % P)) % P
    if table == Table.ValidUnsignedRemainder:
        # (rem, div) = (x, y): [div == 0] + [rem < div] — disjoint on the
        # cube (LT(·,0) ≡ 0), each multilinear.
        z_d = one
        for i in range(xlen):
            z_d = z_d * ((1 - r[2 * i + 1]) % P) % P
        return (z_d + evaluate_mle(Table.UnsignedLessThan, r, xlen)) % P
    if table == Table.ValidSignedRemainder:
        # (rem, div) = (x, y). Disjoint-variable multilinear cover:
        #   (1−rs)(1−ds)·LT(rr, dr)   both non-negative, |rem|<|div|
        #                             (also rem==0 with div>0: LT(0,dr)=1)
        #   + rs·ds·LT(dr, rr)        both negative, |rem|<|div|
        #   + Z_div                   div == 0 (always valid)
        #   + Z_rem·ds                rem == 0 with div < 0
        rs, ds = r[0], r[1]
        rest = r[2:]
        swapped = []
        for i in range(xlen - 1):
            swapped += [rest[2 * i + 1], rest[2 * i]]
        lt_rd = evaluate_mle(Table.UnsignedLessThan, rest, xlen - 1)
        lt_dr = evaluate_mle(Table.UnsignedLessThan, swapped, xlen - 1)
        z_d = (1 - ds) % P
        z_r = (1 - rs) % P
        for i in range(xlen - 1):
            z_r = z_r * ((1 - rest[2 * i]) % P) % P
            z_d = z_d * ((1 - rest[2 * i + 1]) % P) % P
        return ((1 - rs) * (1 - ds) % P * lt_rd
                + rs * ds % P * lt_dr + z_d + z_r * ds) % P
    raise ValueError(table)


def _dense_mle(table: Table, r: list[int], xlen: int) -> int:
    """Exact MLE by summing over the hypercube — only viable for small xlen
    (the materialized 2^16 domain); big-endian index convention."""
    n = len(r)
    assert n <= 20, "dense MLE fallback only for materialized table widths"
    size = 1 << n
    acc = 0
    for idx in range(size):
        term = materialize_entry(table, idx, xlen) % P
        if term == 0:
            continue
        basis = 1
        for b in range(n):
            bit = (idx >> (n - 1 - b)) & 1
            basis = basis * (r[b] if bit else (1 - r[b])) % P
        acc = (acc + term * basis) % P
    return acc


# ---------------------------------------------------------------------------
# Instruction -> (table, index, output) mapping for the Lasso lookup trace.
# Table assignment matches the reference's 58 instruction-lookup types
# (src/zkvm/instruction/lookups.zig; mapping extracted per type).
# ---------------------------------------------------------------------------

def instruction_table(instr: int) -> Table | None:
    """Which lookup table an instruction uses (None = no lookup)."""
    opcode = instr & 0x7F
    f3 = (instr >> 12) & 0x7
    f7 = (instr >> 25) & 0x7F
    if opcode == 0x33:  # OP
        if f7 == 0x01:
            return {0: Table.RangeCheck, 1: Table.RangeCheck, 2: Table.RangeCheck,
                    3: Table.RangeCheck, 4: Table.ValidDiv0, 5: Table.ValidDiv0,
                    6: Table.ValidSignedRemainder, 7: Table.ValidUnsignedRemainder}[f3]
        if f3 == 0x0:
            return Table.Sub if (f7 & 0x20) else Table.RangeCheck
        return {1: Table.LeftShift, 2: Table.SignedLessThan, 3: Table.UnsignedLessThan,
                4: Table.Xor, 5: Table.RightShiftArithmetic if (f7 & 0x20) else Table.RightShift,
                6: Table.Or, 7: Table.And}[f3]
    if opcode == 0x13:  # OP-IMM
        return {0: Table.RangeCheck, 1: Table.LeftShift, 2: Table.SignedLessThan,
                3: Table.UnsignedLessThan, 4: Table.Xor,
                5: Table.RightShiftArithmetic if (f7 & 0x20) else Table.RightShift,
                6: Table.Or, 7: Table.And}[f3]
    if opcode == 0x63:  # branches
        return {0: Table.Equal, 1: Table.NotEqual, 4: Table.SignedLessThan,
                5: Table.SignedGreaterThanEqual, 6: Table.UnsignedLessThan,
                7: Table.UnsignedGreaterThanEqual}.get(f3)
    if opcode == 0x3B:  # OP-32
        if f7 == 0x01:
            return {0: Table.RangeCheck, 4: Table.ValidDiv0, 5: Table.ValidDiv0,
                    6: Table.ValidSignedRemainder, 7: Table.ValidUnsignedRemainder}.get(f3)
        if f3 == 0x0:
            return Table.Sub if (f7 & 0x20) else Table.RangeCheck
        return {1: Table.LeftShift,
                5: Table.RightShiftArithmetic if (f7 & 0x20) else Table.RightShift}.get(f3)
    if opcode == 0x1B:  # OP-IMM-32
        return {0: Table.RangeCheck, 1: Table.LeftShift,
                5: Table.RightShiftArithmetic if (f7 & 0x20) else Table.RightShift}.get(f3)
    if opcode == 0x03:  # loads
        return {0: Table.SignExtend8, 1: Table.SignExtend16, 2: Table.SignExtend32,
                3: Table.RangeCheck, 4: Table.RangeCheck, 5: Table.RangeCheck,
                6: Table.RangeCheck}.get(f3)
    if opcode == 0x23:  # stores
        return Table.RangeCheck
    if opcode in (0x37, 0x17, 0x6F, 0x67):  # LUI/AUIPC/JAL/JALR
        return Table.RangeCheck
    return None


PAIR_TABLES = {
    Table.And, Table.Or, Table.Xor, Table.Equal, Table.NotEqual,
    Table.UnsignedLessThan, Table.SignedLessThan, Table.UnsignedGreaterThanEqual,
    Table.UnsignedLessThanEqual, Table.SignedGreaterThanEqual, Table.Movsign,
    Table.Sub, Table.Andn, Table.LeftShift, Table.RightShift,
    Table.RightShiftArithmetic, Table.ValidDiv0, Table.ValidUnsignedRemainder,
    Table.ValidSignedRemainder,
}
