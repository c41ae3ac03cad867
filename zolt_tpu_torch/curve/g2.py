"""BN254 G2 (over Fp2) host arithmetic.

Curve: y^2 = x^3 + 3/ξ with ξ = 9+u (the D-twist of G1). Points are
((x0,x1),(y0,y1)) Fp2 coordinate pairs; None is the identity.
Reference: src/field/pairing.zig:749-944.
"""

from __future__ import annotations

from ..field import tower as tw
from ..field.params import FR

# b2 = 3 / (9 + u)
B2 = tw.fp2_mul(tw.fp2_inv(tw.XI), (3, 0))

# Standard BN254 G2 generator
G2_GEN = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)

Point = tuple | None


def is_on_curve(pt: Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    return tw.fp2_sub(tw.fp2_sqr(y), tw.fp2_add(tw.fp2_mul(tw.fp2_sqr(x), x), B2)) == (0, 0)


def neg(pt: Point) -> Point:
    if pt is None:
        return None
    return (pt[0], tw.fp2_neg(pt[1]))


def add(a: Point, b: Point) -> Point:
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if tw.fp2_add(y1, y2) == (0, 0):
            return None
        lam = tw.fp2_mul(tw.fp2_scalar(tw.fp2_sqr(x1), 3), tw.fp2_inv(tw.fp2_scalar(y1, 2)))
    else:
        lam = tw.fp2_mul(tw.fp2_sub(y2, y1), tw.fp2_inv(tw.fp2_sub(x2, x1)))
    x3 = tw.fp2_sub(tw.fp2_sub(tw.fp2_sqr(lam), x1), x2)
    y3 = tw.fp2_sub(tw.fp2_mul(lam, tw.fp2_sub(x1, x3)), y1)
    return (x3, y3)


def double(a: Point) -> Point:
    return add(a, a)


_F2_ZERO = (0, 0)
_F2_ONE = (1, 0)


def _jac_dbl2(X, Y, Z):
    if Z == _F2_ZERO or Y == _F2_ZERO:
        return (_F2_ZERO, _F2_ONE, _F2_ZERO)
    A = tw.fp2_sqr(X)
    B = tw.fp2_sqr(Y)
    C = tw.fp2_sqr(B)
    t = tw.fp2_sqr(tw.fp2_add(X, B))
    D = tw.fp2_scalar(tw.fp2_sub(tw.fp2_sub(t, A), C), 2)
    E = tw.fp2_scalar(A, 3)
    F = tw.fp2_sqr(E)
    X3 = tw.fp2_sub(F, tw.fp2_scalar(D, 2))
    Y3 = tw.fp2_sub(tw.fp2_mul(E, tw.fp2_sub(D, X3)), tw.fp2_scalar(C, 8))
    Z3 = tw.fp2_scalar(tw.fp2_mul(Y, Z), 2)
    return (X3, Y3, Z3)


def _jac_add_affine2(X1, Y1, Z1, x2, y2):
    if Z1 == _F2_ZERO:
        return (x2, y2, _F2_ONE)
    Z1Z1 = tw.fp2_sqr(Z1)
    U2 = tw.fp2_mul(x2, Z1Z1)
    S2 = tw.fp2_mul(tw.fp2_mul(y2, Z1Z1), Z1)
    if U2 == X1:
        if S2 == Y1:
            return _jac_dbl2(X1, Y1, Z1)
        return (_F2_ZERO, _F2_ONE, _F2_ZERO)
    H = tw.fp2_sub(U2, X1)
    HH = tw.fp2_sqr(H)
    I = tw.fp2_scalar(HH, 4)
    J = tw.fp2_mul(H, I)
    rr = tw.fp2_scalar(tw.fp2_sub(S2, Y1), 2)
    V = tw.fp2_mul(X1, I)
    X3 = tw.fp2_sub(tw.fp2_sub(tw.fp2_sqr(rr), J), tw.fp2_scalar(V, 2))
    Y3 = tw.fp2_sub(tw.fp2_mul(rr, tw.fp2_sub(V, X3)),
                    tw.fp2_scalar(tw.fp2_mul(Y1, J), 2))
    Z3 = tw.fp2_sub(tw.fp2_sub(tw.fp2_sqr(tw.fp2_add(Z1, H)), Z1Z1), HH)
    return (X3, Y3, Z3)


def scalar_mul(pt: Point, k: int) -> Point:
    """Jacobian double-and-add; one Fp2 inversion at the end. Routed
    through the native BN254 runtime when available."""
    k %= FR.p
    if pt is None or k == 0:
        return None
    from ..native import g2_msm_native

    out = g2_msm_native([pt], [k])
    if out is not None:
        return out
    x, y = pt
    X, Y, Z = _F2_ZERO, _F2_ONE, _F2_ZERO
    for bit in bin(k)[2:]:
        X, Y, Z = _jac_dbl2(X, Y, Z)
        if bit == "1":
            X, Y, Z = _jac_add_affine2(X, Y, Z, x, y)
    if Z == _F2_ZERO:
        return None
    zinv = tw.fp2_inv(Z)
    z2 = tw.fp2_sqr(zinv)
    return (tw.fp2_mul(X, z2), tw.fp2_mul(tw.fp2_mul(Y, z2), zinv))
