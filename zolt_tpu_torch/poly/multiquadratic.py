"""Multiquadratic polynomials over the ternary grid {0, 1, ∞}^d.

A multilinear polynomial restricted to a window of d variables is stored on
the base-3 grid (z_0 fastest-varying), with the ∞ lane holding the per-axis
slope f(∞) = f(1) − f(0). Binding z_0 := r interpolates the unique quadratic
through (f(0), f(1), f(∞)·r(r−1) term); projection sums the z_0 ∈ {0, ∞}
lanes against boolean eq weights — exactly the two values (t'(0), t'(∞)) the
Gruen cubic round formula consumes.

Semantics mirror the reference's src/poly/multiquadratic.zig:27-301
(fromLinear :57, bind :137, projectToFirstVariable :182, expandGrid :301);
the layout (base-3, LSB-first) matches so window algebra is interchangeable.
"""

from __future__ import annotations

from ..field.params import FR

P = FR.p

ZERO, ONE, INF = 0, 1, 2  # GridValue encoding


def pow3(n: int) -> int:
    return 3 ** n


def ternary_index(point: list[int]) -> int:
    """Base-3 index of a grid point, point[0] fastest-varying."""
    idx = 0
    factor = 1
    for v in point:
        idx += v * factor
        factor *= 3
    return idx


def _is_boolean_ternary(idx: int, num_vars: int) -> bool:
    for _ in range(num_vars):
        if idx % 3 == 2:
            return False
        idx //= 3
    return True


def _ternary_to_binary(idx: int, num_vars: int) -> int:
    out = 0
    for bit in range(num_vars):
        if idx % 3 == 1:
            out |= 1 << bit
        idx //= 3
    return out


def expand_grid(num_vars: int, grid: list[int]) -> None:
    """In-place expansion: boolean-point values (zeros elsewhere) → full
    multiquadratic grid, one dimension at a time with f(∞) = f(1) − f(0)
    (reference expandLinearToTernaryGeneric)."""
    for dim in range(num_vars):
        stride = pow3(dim)
        after = pow3(num_vars - dim - 1)
        for a in range(after):
            for b in range(stride):
                base = a * stride * 3 + b
                grid[base + 2 * stride] = (grid[base + stride] - grid[base]) % P


class MultiquadraticPolynomial:
    """Evaluations on {0, 1, ∞}^num_vars, base-3 indexed (z_0 fastest)."""

    def __init__(self, num_vars: int, evaluations: list[int]):
        assert len(evaluations) == pow3(num_vars)
        self.num_vars = num_vars
        self.evaluations = [v % P for v in evaluations]

    @classmethod
    def from_linear(cls, num_vars: int, linear_evals: list[int]) -> "MultiquadraticPolynomial":
        """Expand {0,1}^n evaluations to the ternary grid."""
        assert len(linear_evals) == 1 << num_vars
        grid = [0] * pow3(num_vars)
        for lin in range(1 << num_vars):
            t_idx = 0
            f = 1
            idx = lin
            for _ in range(num_vars):
                t_idx += (idx & 1) * f
                f *= 3
                idx >>= 1
            grid[t_idx] = linear_evals[lin] % P
        expand_grid(num_vars, grid)
        return cls(num_vars, grid)

    def get(self, point: list[int]) -> int:
        return self.evaluations[ternary_index(point)]

    def get_zero(self) -> int:
        return self.evaluations[0]

    def get_infinity(self) -> int:
        """f at (∞, 0, …, 0) — the first variable's slope lane."""
        if self.num_vars == 0:
            return 0
        return self.evaluations[2]

    def bind(self, r: int) -> None:
        """z_0 := r. f(r, rest) = f0·(1−r) + f1·r + f∞·r(r−1)."""
        if self.num_vars == 0:
            return
        r %= P
        r_term = r * (r - 1) % P
        new_size = pow3(self.num_vars - 1)
        ev = self.evaluations
        for i in range(new_size):
            b = 3 * i
            ev[i] = (ev[b] * (1 - r) + ev[b + 1] * r + ev[b + 2] * r_term) % P
        del ev[new_size:]
        self.num_vars -= 1

    @property
    def is_bound(self) -> bool:
        return self.num_vars == 0

    def final_sumcheck_claim(self) -> int:
        assert self.is_bound
        return self.evaluations[0]

    def project_to_first_variable(self, eq_weights: list[int]) -> tuple[int, int]:
        """(t'(0), t'(∞)) = Σ over BOOLEAN assignments of the remaining vars
        of eq_weights[binary index]·f(z_0, rest), z_0 ∈ {0, ∞}."""
        if self.num_vars == 0:
            return self.evaluations[0], 0
        rem = self.num_vars - 1
        t0 = tinf = 0
        for rest in range(pow3(rem)):
            if not _is_boolean_ternary(rest, rem):
                continue
            lin = _ternary_to_binary(rest, rem)
            if lin >= len(eq_weights):
                continue
            w = eq_weights[lin]
            t0 = (t0 + w * self.evaluations[rest * 3]) % P
            tinf = (tinf + w * self.evaluations[rest * 3 + 2]) % P
        return t0, tinf
