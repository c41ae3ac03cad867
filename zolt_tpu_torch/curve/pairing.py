"""BN254 optimal ate pairing (host-side).

Generic Miller loop over the curve embedded in Fp12 via the twist map
ψ(x,y) = (x·w², y·w³) — in the tower basis Fp2 embeds directly, so no basis
change is needed. Structure follows the standard optimal-ate recipe (loop over
6x+2, two Frobenius correction lines, easy+hard final exponentiation); the
reference's equivalent is src/field/pairing.zig:1258-1955.

multi_pairing shares one final exponentiation across all pairs — the Dory
commit path depends on this (one final exp per commitment row batch, not per
pairing).
"""

from __future__ import annotations

from ..field import tower as tw
from ..field.params import FP, FR

P = FP.p

BN_X = 4965661367192848881          # BN254 curve parameter x
ATE_LOOP_COUNT = 6 * BN_X + 2       # 29793968203157093288

# w^2 = v and w^3 = v·w as Fp12 elements (tower basis)
_W2 = ((tw.FP2_ZERO, tw.FP2_ONE, tw.FP2_ZERO), tw.FP6_ZERO)
_W3 = (tw.FP6_ZERO, (tw.FP2_ZERO, tw.FP2_ONE, tw.FP2_ZERO))

FINAL_EXP = (P**12 - 1) // FR.p


def _emb_fp(a: int):
    """Fp -> Fp12."""
    return (((a % P, 0), tw.FP2_ZERO, tw.FP2_ZERO), tw.FP6_ZERO)


def _emb_fp2(a):
    """Fp2 -> Fp12 (tower-basis inclusion)."""
    return ((a, tw.FP2_ZERO, tw.FP2_ZERO), tw.FP6_ZERO)


def twist_g2(q):
    """G2 affine (Fp2 coords) -> E(Fp12) affine."""
    if q is None:
        return None
    x, y = q
    return (tw.fp12_mul(_emb_fp2(x), _W2), tw.fp12_mul(_emb_fp2(y), _W3))


def embed_g1(p):
    """G1 affine (Fp coords) -> E(Fp12) affine."""
    if p is None:
        return None
    return (_emb_fp(p[0]), _emb_fp(p[1]))


def _line(p1, p2, t):
    """Evaluate the line through p1,p2 (or tangent at p1) at point t. All
    affine Fp12 points."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = tw.fp12_mul(tw.fp12_sub(y2, y1), tw.fp12_inv(tw.fp12_sub(x2, x1)))
    elif y1 == y2:
        num = tw.fp12_mul(tw.fp12_sqr(x1), _emb_fp(3))
        m = tw.fp12_mul(num, tw.fp12_inv(tw.fp12_mul(y1, _emb_fp(2))))
    else:
        return tw.fp12_sub(xt, x1)
    return tw.fp12_sub(tw.fp12_mul(m, tw.fp12_sub(xt, x1)), tw.fp12_sub(yt, y1))


def _pt_add12(a, b):
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if tw.fp12_add(y1, y2) == tw.FP12_ZERO:
            return None
        m = tw.fp12_mul(tw.fp12_mul(tw.fp12_sqr(x1), _emb_fp(3)),
                        tw.fp12_inv(tw.fp12_mul(y1, _emb_fp(2))))
    else:
        m = tw.fp12_mul(tw.fp12_sub(y2, y1), tw.fp12_inv(tw.fp12_sub(x2, x1)))
    x3 = tw.fp12_sub(tw.fp12_sub(tw.fp12_sqr(m), x1), x2)
    y3 = tw.fp12_sub(tw.fp12_mul(m, tw.fp12_sub(x1, x3)), y1)
    return (x3, y3)


def _frob_pt(pt, n: int = 1):
    return (tw.fp12_frob(pt[0], n), tw.fp12_frob(pt[1], n))


def miller_loop(q_emb, p_emb):
    """Miller loop f_{6x+2,Q}(P) with the two optimal-ate correction lines.
    Inputs are embedded E(Fp12) affine points; returns un-exponentiated f."""
    if q_emb is None or p_emb is None:
        return tw.FP12_ONE
    R = q_emb
    f = tw.FP12_ONE
    for bit in bin(ATE_LOOP_COUNT)[3:]:
        f = tw.fp12_mul(tw.fp12_sqr(f), _line(R, R, p_emb))
        R = _pt_add12(R, R)
        if bit == "1":
            f = tw.fp12_mul(f, _line(R, q_emb, p_emb))
            R = _pt_add12(R, q_emb)
    q1 = _frob_pt(q_emb, 1)
    nq2 = _frob_pt(q_emb, 2)
    nq2 = (nq2[0], tw.fp12_sub(tw.FP12_ZERO, nq2[1]))
    f = tw.fp12_mul(f, _line(R, q1, p_emb))
    R = _pt_add12(R, q1)
    f = tw.fp12_mul(f, _line(R, nq2, p_emb))
    return f


def final_exponentiation(f):
    """Arkworks-compatible final exponentiation: easy part, then the
    Fuentes-Castañeda hard part — which computes the MULTIPLE
    f^(2x(6x²+3x+1)·(p⁴-p²+1)/r), not the exact hard exponent. GT byte
    compatibility with Jolt requires this (reference
    src/field/pairing.zig:1653-1812 hardPartExponentiationArkworks;
    validated against Jolt's e(g1,g2) = 950e879d... test vector)."""
    # easy: f^((p^6-1)(p^2+1))
    f1 = tw.fp12_mul(tw.fp12_conj(f), tw.fp12_inv(f))
    r = tw.fp12_mul(tw.fp12_frob(f1, 2), f1)
    # hard: the x-chain (63-bit exponents ×3 + ~20 muls — far cheaper than a
    # direct ~950-bit pow), reference pairing.zig:1812-1872
    m = tw.fp12_mul

    def exp_neg_x(g):
        # g is in the cyclotomic subgroup after the easy part: use
        # Granger-Scott squaring in the square-and-multiply ladder.
        acc = tw.FP12_ONE
        base = g
        e = BN_X
        while e:
            if e & 1:
                acc = m(acc, base)
            e >>= 1
            if e:
                base = tw.fp12_cyclotomic_sqr(base)
        return tw.fp12_conj(acc)

    y0 = exp_neg_x(r)
    y1 = tw.fp12_cyclotomic_sqr(y0)
    y2 = tw.fp12_cyclotomic_sqr(y1)
    y3 = m(y2, y1)
    y4 = exp_neg_x(y3)
    y5 = tw.fp12_cyclotomic_sqr(y4)
    y6 = exp_neg_x(y5)
    y3 = tw.fp12_conj(y3)
    y6 = tw.fp12_conj(y6)
    y7 = m(y6, y4)
    y8 = m(y7, y3)
    y9 = m(y8, y1)
    y10 = m(y8, y4)
    y11 = m(y10, r)
    y12 = tw.fp12_frob(y9, 1)
    y13 = m(y12, y11)
    y8 = tw.fp12_frob(y8, 2)
    y14 = m(y8, y13)
    y15 = m(tw.fp12_conj(r), y9)
    y15 = tw.fp12_frob(y15, 3)
    return m(y15, y14)




# ---------------------------------------------------------------------------
# Arkworks-compatible Miller loop (reference src/field/pairing.zig:933-1610).
# The generic embedded-curve loop above computes a bilinear pairing but not
# the arkworks VALUE; Jolt GT byte-compatibility needs this exact chain:
# signed ATE digits, homogeneous-projective line coefficients, mulBy034.
# ---------------------------------------------------------------------------

# 6x+2 in the signed-digit order arkworks uses (pairing.zig ATE_LOOP_COUNT)
_ATE_DIGITS = [
    0, 0, 0, 1, 0, 1, 0, -1, 0, 0, -1, 0, 0, 0, 1, 0,
    0, -1, 0, -1, 0, 0, 0, 1, 0, -1, 0, 0, 0, 0, -1, 0,
    0, 1, 0, -1, 0, 0, 1, 0, 0, 0, 0, 0, -1, 0, 0, -1,
    0, 1, 0, -1, 0, 0, 0, -1, 0, -1, 0, 0, 0, 1, 0, 1,
    1,
]

_TWIST_B = tw.fp2_mul((3, 0), tw.fp2_inv(tw.XI))          # b'' = 3/xi
_GAMMA12 = tw.fp2_pow(tw.XI, (P - 1) // 3)                # xi^((p-1)/3)
_GAMMA13 = tw.fp2_pow(tw.XI, (P - 1) // 2)                # xi^((p-1)/2)
_TWO_INV = pow(2, -1, P)


def _fp6_mul_by_01(f, c0, c1):
    """Fp6 * (c0 + c1 v) sparse mul (pairing.zig fp6MulBy01)."""
    f0, f1, f2 = f
    a_a = tw.fp2_mul(f0, c0)
    b_b = tw.fp2_mul(f1, c1)
    t1 = tw.fp2_mul(c1, tw.fp2_add(f1, f2))
    t1 = tw.fp2_add(tw.fp2_mul_by_xi(tw.fp2_sub(t1, b_b)), a_a)
    t3 = tw.fp2_mul(c0, tw.fp2_add(f0, f2))
    t3 = tw.fp2_add(tw.fp2_sub(t3, a_a), b_b)
    t2 = tw.fp2_mul(tw.fp2_add(c0, c1), tw.fp2_add(f0, f1))
    t2 = tw.fp2_sub(tw.fp2_sub(t2, a_a), b_b)
    return (t1, t2, t3)


def _fp12_mul_by_034(f, c0, c3, c4):
    fc0, fc1 = f
    a = tuple(tw.fp2_mul(x, c0) for x in fc0)
    b = _fp6_mul_by_01(fc1, c3, c4)
    f_sum = tuple(tw.fp2_add(x, y) for x, y in zip(fc0, fc1))
    e = _fp6_mul_by_01(f_sum, tw.fp2_add(c0, c3), c4)
    c1_new = tuple(tw.fp2_sub(tw.fp2_sub(ei, ai), bi) for ei, ai, bi in zip(e, a, b))
    bv = tw.fp6_mul_by_v(b)
    c0_new = tuple(tw.fp2_add(ai, bi) for ai, bi in zip(a, bv))
    return (c0_new, c1_new)


def _dbl_step(r):
    """Homogeneous-projective doubling; returns (new_r, (c0, c1, c2))."""
    x, y, z = r
    a = tw.fp2_scalar(tw.fp2_mul(x, y), _TWO_INV)
    b = tw.fp2_sqr(y)
    c = tw.fp2_sqr(z)
    three_c = tw.fp2_add(tw.fp2_add(c, c), c)
    e = tw.fp2_mul(three_c, _TWIST_B)
    f = tw.fp2_add(tw.fp2_add(e, e), e)
    g = tw.fp2_scalar(tw.fp2_add(b, f), _TWO_INV)
    h = tw.fp2_sub(tw.fp2_sqr(tw.fp2_add(y, z)), tw.fp2_add(b, c))
    i = tw.fp2_sub(e, b)
    j = tw.fp2_sqr(x)
    e_sq = tw.fp2_sqr(e)
    nx = tw.fp2_mul(a, tw.fp2_sub(b, f))
    ny = tw.fp2_sub(tw.fp2_sqr(g), tw.fp2_add(tw.fp2_add(e_sq, e_sq), e_sq))
    nz = tw.fp2_mul(b, h)
    return (nx, ny, nz), (tw.fp2_neg(h), tw.fp2_add(tw.fp2_add(j, j), j), i)


def _add_step(r, q):
    x, y, z = r
    qx, qy = q
    theta = tw.fp2_sub(y, tw.fp2_mul(qy, z))
    lam = tw.fp2_sub(x, tw.fp2_mul(qx, z))
    c = tw.fp2_sqr(theta)
    d = tw.fp2_sqr(lam)
    e = tw.fp2_mul(lam, d)
    f = tw.fp2_mul(z, c)
    g = tw.fp2_mul(x, d)
    h = tw.fp2_sub(tw.fp2_add(e, f), tw.fp2_add(g, g))
    nx = tw.fp2_mul(lam, h)
    ny = tw.fp2_sub(tw.fp2_mul(theta, tw.fp2_sub(g, h)), tw.fp2_mul(e, y))
    nz = tw.fp2_mul(z, e)
    jay = tw.fp2_sub(tw.fp2_mul(theta, qx), tw.fp2_mul(lam, qy))
    return (nx, ny, nz), (lam, tw.fp2_neg(theta), jay)


def _mul_by_char(q):
    """Frobenius endomorphism on G2 (pairing.zig mulByChar)."""
    qx, qy = q
    return (tw.fp2_mul(tw.fp2_conj(qx), _GAMMA12),
            tw.fp2_mul(tw.fp2_conj(qy), _GAMMA13))


def miller_loop_ark(p_g1, q_g2):
    """f_{6x+2,Q}(P) exactly as arkworks/the reference compute it."""
    if p_g1 is None or q_g2 is None:
        return tw.FP12_ONE
    px, py = p_g1[0] % P, p_g1[1] % P
    r = (q_g2[0], q_g2[1], tw.FP2_ONE)
    neg_q = (q_g2[0], tw.fp2_neg(q_g2[1]))
    f = tw.FP12_ONE
    n = len(_ATE_DIGITS)
    for idx in range(n - 1, 0, -1):
        if idx != n - 1:
            f = tw.fp12_sqr(f)
        r, (c0, c1, c2) = _dbl_step(r)
        f = _fp12_mul_by_034(f, tw.fp2_scalar(c0, py), tw.fp2_scalar(c1, px), c2)
        bit = _ATE_DIGITS[idx - 1]
        if bit == 1:
            r, (c0, c1, c2) = _add_step(r, q_g2)
            f = _fp12_mul_by_034(f, tw.fp2_scalar(c0, py), tw.fp2_scalar(c1, px), c2)
        elif bit == -1:
            r, (c0, c1, c2) = _add_step(r, neg_q)
            f = _fp12_mul_by_034(f, tw.fp2_scalar(c0, py), tw.fp2_scalar(c1, px), c2)
    q1 = _mul_by_char(q_g2)
    r, (c0, c1, c2) = _add_step(r, q1)
    f = _fp12_mul_by_034(f, tw.fp2_scalar(c0, py), tw.fp2_scalar(c1, px), c2)
    q2 = _mul_by_char(q1)
    q2 = (q2[0], tw.fp2_neg(q2[1]))
    r, (c0, c1, c2) = _add_step(r, q2)
    f = _fp12_mul_by_034(f, tw.fp2_scalar(c0, py), tw.fp2_scalar(c1, px), c2)
    return f


def pairing(p_g1, q_g2):
    """e(P, Q) for host G1 affine P and G2 affine Q. Returns GT (Fp12)."""
    if p_g1 is None or q_g2 is None:
        return tw.FP12_ONE
    f = miller_loop_ark(p_g1, q_g2)
    return final_exponentiation(f)


def multi_pairing(pairs):
    """Π e(P_i, Q_i) with a single shared final exponentiation. Routed
    through the native BN254 runtime when available (zolt_tpu/native,
    differentially tested against this Python path)."""
    pairs = list(pairs)
    from ..native import multi_pairing_native

    out = multi_pairing_native(pairs)
    if out is not None:
        return out
    f = tw.FP12_ONE
    for p_g1, q_g2 in pairs:
        if p_g1 is None or q_g2 is None:
            continue
        f = tw.fp12_mul(f, miller_loop_ark(p_g1, q_g2))
    return final_exponentiation(f)


def pairing_check(pairs) -> bool:
    """Π e(P_i, Q_i) == 1."""
    return multi_pairing(pairs) == tw.FP12_ONE
