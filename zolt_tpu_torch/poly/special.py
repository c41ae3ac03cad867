"""Specialized eq-polynomial machinery for the Jolt-path stage provers.

- GruenSplitEq: Dao–Thaler/Gruen factored eq(τ,·) with prefix tables E_out/E_in
  and a bound-variable scalar (reference src/poly/split_eq.zig:21-466).
  Big-endian tables (τ[0] ↔ MSB), low-to-high binding popping in→out.
- EqPlusOne: successor MLE eq+1(x, y) = 1 iff y = x+1, big-endian
  (reference src/poly/mod.zig:332-448); used by the ShiftSumcheck.

Host-int implementation: these tables are per-round control structures; the
wide per-cycle work stays on device in the stage provers.
"""

from __future__ import annotations

from ..field.params import FR

P = FR.p


def _eq_scalar(a: int, b: int) -> int:
    return (a * b + (1 - a) * (1 - b)) % P


class GruenSplitEq:
    """Split-eq with prefix tables; mirrors reference structure exactly."""

    def __init__(self, tau: list[int], scaling_factor: int = 1):
        self.tau = list(tau)
        self.current_index = len(tau)
        self.current_scalar = scaling_factor % P
        m = len(tau) // 2
        self.m = m
        self.num_x_out = m
        self.num_x_in = max(0, len(tau) - 1 - m) if len(tau) > 1 else 0

        def build(taus: list[int]) -> list[list[int]]:
            tables = [[1]]
            for t in taus:
                prev = tables[-1]
                nxt = []
                for v in prev:
                    nxt.append(v * (1 - t) % P)
                    nxt.append(v * t % P)
                # interleaved append: entry 2i gets bit 0, 2i+1 gets bit 1 —
                # reference builds next[2i], next[2i+1] the same way
                tables.append(nxt)
            return tables

        self.E_out_vec = build(self.tau[:m])
        self.E_in_vec = build(self.tau[m : len(tau) - 1] if len(tau) > 1 else [])

    def bind(self, r: int) -> None:
        if self.current_index == 0:
            return
        t = self.tau[self.current_index - 1]
        self.current_scalar = self.current_scalar * _eq_scalar(t, r) % P
        self.current_index -= 1
        if self.m < self.current_index:
            if len(self.E_in_vec) > 1:
                self.E_in_vec.pop()
        elif self.current_index > 0:
            if len(self.E_out_vec) > 1:
                self.E_out_vec.pop()

    def tau_high(self) -> int:
        return self.tau[-1]

    def full_eq_table(self) -> list[int]:
        """eq(τ_unbound, ·)·scalar over the remaining variables, big-endian."""
        out = [self.current_scalar]
        for j in range(self.current_index - 1, -1, -1):
            t = self.tau[j]
            nxt = [0] * (2 * len(out))
            for i, v in enumerate(out):
                y = v * t % P
                nxt[i + len(out)] = y
                nxt[i] = (v - y) % P
            out = nxt
        return out

    def current_eq_factors(self) -> tuple[int, int]:
        """(eq(τ_cur, 0), eq(τ_cur, 1))·scalar for the next unbound variable."""
        t = self.tau[self.current_index - 1]
        return (self.current_scalar * (1 - t) % P, self.current_scalar * t % P)


def eq_plus_one_mle(x: list[int], y: list[int]) -> int:
    """eq+1(x, y), big-endian (x[0] = MSB). Zero when x = 11…1."""
    l = len(x)
    assert len(y) == l
    result = 0
    for k in range(l):
        lower = 1
        for i in range(k):
            idx = l - 1 - i
            lower = lower * (x[idx] * (1 - y[idx]) % P) % P
        kth = l - 1 - k
        kbit = (1 - x[kth]) * y[kth] % P
        higher = 1
        for i in range(k + 1, l):
            idx = l - 1 - i
            higher = higher * _eq_scalar(x[idx], y[idx]) % P
        result = (result + lower * kbit % P * higher) % P
    return result


def eq_be_evals(x: list[int]) -> list[int]:
    """eq(x, j) for all j in {0,1}^l, big-endian index (x[0] = MSB), via the
    doubling algorithm (reference src/poly/mod.zig:252-290): O(2^l) mults."""
    out = [1]
    for t in reversed(x):
        nxt = [0] * (2 * len(out))
        for i, v in enumerate(out):
            hi = v * t % P
            nxt[i + len(out)] = hi
            nxt[i] = (v - hi) % P
        out = nxt
    return out


def eq_plus_one_evals(x: list[int]) -> list[int]:
    """eq+1(x, j) for all j in {0,1}^l (big-endian index).

    For binary j, eq+1(x, j) is the MLE in x of [x = j-1], i.e. eq(x, j-1);
    with no wraparound the table is the big-endian eq table shifted one slot
    right (index 0 gets 0). O(2^l) instead of the pointwise O(2^l·l^2)."""
    if not x:
        return [0]
    eq = eq_be_evals(x)
    return [0] + eq[:-1]


class EqPlusOnePrefixSuffix:
    """Prefix–suffix decomposition of eq+1 over a big-endian split point
    r = (r_hi ‖ r_lo) (reference src/poly/mod.zig:464-581):

        eq+1(r, (y_hi ‖ y_lo)) = prefix_0[y_lo]·suffix_0[y_hi]
                               + prefix_1[y_lo]·suffix_1[y_hi]

    with prefix_0 = eq+1(r_lo, ·), suffix_0 = eq(r_hi, ·),
    prefix_1 = is_max(r_lo)·δ(y_lo = 0) (the low half wraps exactly when the
    successor carries out of it), suffix_1 = eq+1(r_hi, ·). Storage is
    O(2^{n/2}) per table instead of the O(2^n) dense eq+1 table — the shift
    sumcheck's phase-1 structure (reference src/zkvm/spartan/prefix_suffix.zig).
    """

    def __init__(self, r: list[int]):
        assert len(r) >= 2
        mid = len(r) // 2
        r_hi = [c % P for c in r[:mid]]
        r_lo = [c % P for c in r[mid:]]
        self.n_hi, self.n_lo = len(r_hi), len(r_lo)
        self.prefix_0 = eq_plus_one_evals(r_lo)
        self.suffix_0 = eq_be_evals(r_hi)
        is_max = 1
        for c in r_lo:
            is_max = is_max * c % P
        self.prefix_1 = [0] * (1 << self.n_lo)
        self.prefix_1[0] = is_max
        self.suffix_1 = eq_plus_one_evals(r_hi)

    def prefix_size(self) -> int:
        return 1 << self.n_lo

    def suffix_size(self) -> int:
        return 1 << self.n_hi

    def evaluate(self, y: int) -> int:
        """eq+1(r, y) recombined from the four tables."""
        y_lo = y & ((1 << self.n_lo) - 1)
        y_hi = y >> self.n_lo
        return (self.prefix_0[y_lo] * self.suffix_0[y_hi]
                + self.prefix_1[y_lo] * self.suffix_1[y_hi]) % P

    def dense_table(self, size: int | None = None) -> list[int]:
        """Materialize eq+1(r, ·) from the decomposition (suffix-major block
        structure: block y_hi is prefix_0 scaled by suffix_0[y_hi], plus the
        sparse carry term at each block's index 0)."""
        n = 1 << (self.n_hi + self.n_lo)
        if size is None:
            size = n
        out = [0] * size
        p0, p1 = self.prefix_0, self.prefix_1
        block = 1 << self.n_lo
        for y_hi in range(min(1 << self.n_hi, (size + block - 1) // block)):
            s0, s1 = self.suffix_0[y_hi], self.suffix_1[y_hi]
            base = y_hi << self.n_lo
            for y_lo in range(min(block, size - base)):
                out[base + y_lo] = (p0[y_lo] * s0 + p1[y_lo] * s1) % P
        return out
