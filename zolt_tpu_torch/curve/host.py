"""Host-side BN254 G1 arithmetic over Python ints (oracle + small-scale ops).

Standard Weierstrass curve y^2 = x^3 + 3 over Fp, prime group order = Fr
modulus. Used for SRS generation/validation, final MSM window combining, and as
the test oracle for the device kernels (reference point ops:
src/msm/mod.zig:15-329; formulas re-derived from the EFD, not translated).

Points are (x, y) int tuples in canonical form; None is the identity.
"""

from __future__ import annotations

from ..field.params import FP, FR

P = FP.p
CURVE_B = 3
G1_GEN = (1, 2)

Point = tuple[int, int] | None


def is_on_curve(pt: Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - CURVE_B) % P == 0


def neg(pt: Point) -> Point:
    if pt is None:
        return None
    return (pt[0], (-pt[1]) % P)


def add(a: Point, b: Point) -> Point:
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        # doubling
        lam = (3 * x1 * x1) * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def double(a: Point) -> Point:
    return add(a, a)


def _jac_dbl(X, Y, Z):
    if Z == 0 or Y == 0:
        return (0, 1, 0)
    A = X * X % P
    B = Y * Y % P
    C = B * B % P
    D = 2 * ((X + B) * (X + B) - A - C) % P
    E = 3 * A % P
    F = E * E % P
    X3 = (F - 2 * D) % P
    Y3 = (E * (D - X3) - 8 * C) % P
    Z3 = 2 * Y * Z % P
    return (X3, Y3, Z3)


def _jac_add_affine(X1, Y1, Z1, x2, y2):
    if Z1 == 0:
        return (x2, y2, 1)
    Z1Z1 = Z1 * Z1 % P
    U2 = x2 * Z1Z1 % P
    S2 = y2 * Z1Z1 * Z1 % P
    if U2 == X1:
        if S2 == Y1:
            return _jac_dbl(X1, Y1, Z1)
        return (0, 1, 0)
    H = (U2 - X1) % P
    HH = H * H % P
    I = 4 * HH % P
    J = H * I % P
    rr = 2 * (S2 - Y1) % P
    V = X1 * I % P
    X3 = (rr * rr - J - 2 * V) % P
    Y3 = (rr * (V - X3) - 2 * Y1 * J) % P
    Z3 = ((Z1 + H) * (Z1 + H) - Z1Z1 - HH) % P
    return (X3, Y3, Z3)


def scalar_mul(pt: Point, k: int) -> Point:
    """Jacobian double-and-add; one inversion at the end. Routed through
    the native BN254 runtime when available."""
    k %= FR.p
    if pt is None or k == 0:
        return None
    from ..native import g1_msm_native

    out = g1_msm_native([pt], [k])
    if out is not None:
        return out
    x, y = pt
    X, Y, Z = 0, 1, 0
    for bit in bin(k)[2:]:
        X, Y, Z = _jac_dbl(X, Y, Z)
        if bit == "1":
            X, Y, Z = _jac_add_affine(X, Y, Z, x, y)
    return jacobian_to_affine(X, Y, Z)


def msm(points: list[Point], scalars: list[int]) -> Point:
    from ..native import g1_msm_native

    if any(s % FR.p for s in scalars):
        out = g1_msm_native(points, scalars)
        if out is not None:
            return out
    acc: Point = None
    for pt, s in zip(points, scalars):
        acc = add(acc, scalar_mul(pt, s))
    return acc


def jacobian_to_affine(x: int, y: int, z: int) -> Point:
    if z == 0:
        return None
    zinv = pow(z, -1, P)
    z2 = zinv * zinv % P
    return (x * z2 % P, y * z2 * zinv % P)


def random_points(n: int, seed: int = 0) -> list[Point]:
    """n distinct multiples of the generator (deterministic)."""
    out = []
    acc = G1_GEN
    k = seed + 1
    for _ in range(n):
        out.append(scalar_mul(G1_GEN, k))
        k = (k * 6364136223846793005 + 1442695040888963407) % FR.p or 1
    return out
