"""Host-side univariate round polynomials (tiny, per-sumcheck-round objects).

Canonical-int coefficients mod p. Matches the reference's UniPoly
(src/poly/mod.zig:584-690) and Jolt's CompressedUniPoly
(src/zkvm/jolt_types.zig:400-485): compressed form stores all coefficients
except the linear term, which the verifier recovers from the round claim
(hint = p(0) + p(1)).
"""

from __future__ import annotations

from ..field.params import FR

P = FR.p


def horner_eval(coeffs: list[int], x: int, p: int = P) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


def interpolate(evals: list[int], p: int = P) -> list[int]:
    """Lagrange interpolation from evaluations at 0..d to monomial coefficients."""
    d = len(evals) - 1
    coeffs = [0] * (d + 1)
    for i, yi in enumerate(evals):
        # L_i(x) = prod_{j != i} (x - j) / (i - j)
        num = [1]
        denom = 1
        for j in range(d + 1):
            if j == i:
                continue
            new = [0] * (len(num) + 1)
            for k, c in enumerate(num):
                new[k] = (new[k] - j * c) % p
                new[k + 1] = (new[k + 1] + c) % p
            num = new
            denom = denom * (i - j) % p
        scale = yi * pow(denom, -1, p) % p
        for k in range(len(num)):
            coeffs[k] = (coeffs[k] + num[k] * scale) % p
    return coeffs


def interpolate_degree3(evals: list[int], p: int = P) -> list[int]:
    """Explicit Vandermonde-inverse interpolation at points 0,1,2,3
    (reference poly/mod.zig:632-677)."""
    p0, p1, p2, p3 = evals
    inv6 = pow(6, -1, p)
    inv2 = pow(2, -1, p)
    c0 = p0 % p
    c1 = (-11 * p0 + 18 * p1 - 9 * p2 + 2 * p3) * inv6 % p
    c2 = (2 * p0 - 5 * p1 + 4 * p2 - p3) * inv2 % p
    c3 = (-p0 + 3 * p1 - 3 * p2 + p3) * inv6 % p
    return [c0, c1, c2, c3]


def compress(coeffs: list[int]) -> list[int]:
    """[c0, c1, c2, ..., cn] -> [c0, c2, ..., cn] (drop linear term)."""
    if len(coeffs) <= 1:
        return list(coeffs)
    return [coeffs[0]] + coeffs[2:]


def decompress(compressed: list[int], hint: int, p: int = P) -> list[int]:
    """Recover the full coefficient list from compressed form + claim hint.

    hint = p(0) + p(1) = 2*c0 + c1 + c2 + ... + cn.
    """
    if not compressed:
        return []
    c0 = compressed[0]
    rest = compressed[1:]
    c1 = (hint - 2 * c0 - sum(rest)) % p
    return [c0, c1] + list(rest)


def evals_to_compressed(evals: list[int], p: int = P) -> list[int]:
    return compress(interpolate_degree3(evals, p))
