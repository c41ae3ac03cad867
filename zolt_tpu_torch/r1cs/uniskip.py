"""Univariate-skip machinery for Jolt stages 1 and 2.

Math and constants match the reference exactly
(src/zkvm/r1cs/univariate_skip.zig): symmetric base windows, interleaved
extension targets, generalized-binomial Lagrange shift coefficients, and the
first-round polynomial s1(Y) = L(τ_high, Y)·t1(Y).

Outer (stage 1): 19 constraints → degree 9, base window {-4..5}, extended
domain {-9..9}, 28 coefficients. Product-virtual (stage 2): 5 products →
degree 4, base {-2..2}, extended {-4..4}, 13 coefficients.
"""

from __future__ import annotations

from functools import lru_cache

from ..field.params import FR

P = FR.p

NUM_R1CS_CONSTRAINTS = 19
OUTER_DEGREE = (NUM_R1CS_CONSTRAINTS - 1) // 2  # 9
OUTER_DOMAIN = OUTER_DEGREE + 1                 # 10
OUTER_EXTENDED = 2 * OUTER_DEGREE + 1           # 19
OUTER_NUM_COEFFS = 3 * OUTER_DEGREE + 1         # 28

PV_DOMAIN = 5
PV_DEGREE = PV_DOMAIN - 1                       # 4
PV_EXTENDED = 2 * PV_DEGREE + 1                 # 9
PV_NUM_COEFFS = 3 * PV_DEGREE + 1               # 13


def uniskip_targets(domain_size: int, degree: int) -> list[int]:
    """Interleaved extension targets outside the base window
    (univariate_skip.zig:188-235): -5, 6, -6, 7, ... for the outer domain."""
    base_left = -((domain_size - 1) // 2)
    base_right = base_left + domain_size - 1
    ext_left, ext_right = -degree, degree
    targets = []
    n, p = base_left - 1, base_right + 1
    while n >= ext_left and p <= ext_right and len(targets) < degree:
        targets.append(n)
        if len(targets) >= degree:
            break
        targets.append(p)
        n -= 1
        p += 1
    while len(targets) < degree and n >= ext_left:
        targets.append(n)
        n -= 1
    while len(targets) < degree and p <= ext_right:
        targets.append(p)
        p += 1
    return targets


def generalized_binomial(t: int, k: int) -> int:
    if k == 0:
        return 1
    if t >= 0:
        if k > t:
            return 0
        num = den = 1
        for j in range(k):
            num *= t - j
            den *= j + 1
        return num // den
    sign = -1 if k & 1 else 1
    tt = -t + k - 1
    num = den = 1
    for j in range(k):
        num *= tt - j
        den *= j + 1
    return sign * (num // den)


def shift_coeffs(n: int, shift: int) -> list[int]:
    """Lagrange weights: p(shift) = Σ alpha[i]·p(i) for a window {0..n-1}."""
    out = []
    for i in range(n):
        s1 = generalized_binomial(shift, i)
        s2 = generalized_binomial(shift - i - 1, (n - 1) - i)
        sign = -1 if ((n - 1 - i) & 1) else 1
        out.append(sign * s1 * s2)
    return out


OUTER_TARGETS = uniskip_targets(OUTER_DOMAIN, OUTER_DEGREE)
OUTER_BASE_LEFT = -((OUTER_DOMAIN - 1) // 2)
OUTER_COEFFS_PER_J = [shift_coeffs(OUTER_DOMAIN, t - OUTER_BASE_LEFT) for t in OUTER_TARGETS]

PV_TARGETS = uniskip_targets(PV_DOMAIN, PV_DEGREE)
PV_BASE_LEFT = -((PV_DOMAIN - 1) // 2)
PV_COEFFS_PER_J = [shift_coeffs(PV_DOMAIN, t - PV_BASE_LEFT) for t in PV_TARGETS]


def power_sums(window_n: int, out_len: int) -> list[int]:
    """Σ_t t^k over the symmetric window (univariate_skip.zig:237-255)."""
    d = window_n - 1
    start = -(d // 2)
    sums = [0] * out_len
    for j in range(window_n):
        t = start + j
        sums[0] += 1
        pw = t
        for k in range(1, out_len):
            sums[k] += pw
            pw *= t
    return sums


def lagrange_evals(domain_size: int, x: int) -> list[int]:
    """L_i(x) over the symmetric domain {-(n-1)//2, ...}."""
    base_left = -((domain_size - 1) // 2)
    out = []
    for i in range(domain_size):
        num = den = 1
        for j in range(domain_size):
            if i == j:
                continue
            num = num * ((x - (base_left + j)) % P) % P
            den = den * ((i - j) % P) % P
        out.append(num * pow(den, -1, P) % P)
    return out


def lagrange_kernel(domain_size: int, x: int, y: int) -> int:
    """K(x, y) = Σ_i L_i(x)·L_i(y)."""
    lx = lagrange_evals(domain_size, x)
    ly = lagrange_evals(domain_size, y)
    return sum(a * b % P for a, b in zip(lx, ly)) % P


def interpolate_symmetric(vals: list[int]) -> list[int]:
    """Evaluations on the symmetric integer domain of size n -> monomial
    coefficients (exact Lagrange)."""
    n = len(vals)
    base_left = -((n - 1) // 2)
    coeffs = [0] * n
    for i, yi in enumerate(vals):
        if yi == 0:
            continue
        num = [1]
        den = 1
        xi = base_left + i
        for j in range(n):
            if j == i:
                continue
            xj = base_left + j
            new = [0] * (len(num) + 1)
            for k, c in enumerate(num):
                new[k] = (new[k] - xj * c) % P
                new[k + 1] = (new[k + 1] + c) % P
            num = new
            den = den * (xi - xj) % P
        scale = yi * pow(den, -1, P) % P
        for k in range(len(num)):
            coeffs[k] = (coeffs[k] + num[k] * scale) % P
    return coeffs


def build_uniskip_first_round_poly(domain_size: int, degree: int,
                                   extended_evals: list[int], tau_high: int,
                                   base_evals: list[int] | None = None) -> list[int]:
    """s1(Y) = L(τ_high, Y)·t1(Y); t1 interpolated over {-degree..degree}."""
    extended_size = 2 * degree + 1
    num_coeffs = 3 * degree + 1
    targets = uniskip_targets(domain_size, degree)
    t1_vals = [0] * extended_size
    if base_evals:
        base_left = -((domain_size - 1) // 2)
        for i, v in enumerate(base_evals):
            t1_vals[base_left + i + degree] = v % P
    for v, z in zip(extended_evals, targets):
        t1_vals[z + degree] = v % P

    t1_coeffs = interpolate_symmetric(t1_vals)
    l_coeffs = interpolate_symmetric(lagrange_evals(domain_size, tau_high))

    s1 = [0] * num_coeffs
    for i, a in enumerate(l_coeffs):
        if a == 0:
            continue
        for j, b in enumerate(t1_coeffs):
            if i + j < num_coeffs:
                s1[i + j] = (s1[i + j] + a * b) % P
    return s1
