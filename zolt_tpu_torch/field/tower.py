"""BN254 extension tower Fp2/Fp6/Fp12 over Python ints (host-side).

Verifier-scale arithmetic (reference: src/field/pairing.zig:182-742). Elements
are nested tuples of canonical ints:

    Fp2  = Fp[u]/(u^2+1)            -> (a, b) = a + b·u
    Fp6  = Fp2[v]/(v^3 - ξ), ξ=9+u  -> (c0, c1, c2)
    Fp12 = Fp6[w]/(w^2 - v)         -> (d0, d1)

The pairing target group GT sits in Fp12. Montgomery form is not used on host;
serialization converts at the byte boundary. Performance note: host tower ops
are plain schoolbook/Karatsuba — enough for verifier work; the Dory commit's
many pairings share one final exponentiation via multi_pairing.
"""

from __future__ import annotations

from .params import FP

P = FP.p

# ---------------------------------------------------------------------------
# Fp2
# ---------------------------------------------------------------------------

FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)
XI = (9, 1)  # ξ = 9 + u, the Fp6/Fp12 non-residue


def fp2_add(x, y):
    return ((x[0] + y[0]) % P, (x[1] + y[1]) % P)


def fp2_sub(x, y):
    return ((x[0] - y[0]) % P, (x[1] - y[1]) % P)


def fp2_neg(x):
    return ((-x[0]) % P, (-x[1]) % P)


def fp2_mul(x, y):
    a, b = x
    c, d = y
    ac = a * c % P
    bd = b * d % P
    return ((ac - bd) % P, ((a + b) * (c + d) - ac - bd) % P)


def fp2_sqr(x):
    a, b = x
    return ((a + b) * (a - b) % P, 2 * a * b % P)


def fp2_scalar(x, k: int):
    return (x[0] * k % P, x[1] * k % P)


def fp2_conj(x):
    return (x[0], (-x[1]) % P)


def fp2_inv(x):
    a, b = x
    t = pow(a * a + b * b, -1, P)
    return (a * t % P, (-b * t) % P)


def fp2_pow(x, e: int):
    acc = FP2_ONE
    base = x
    while e:
        if e & 1:
            acc = fp2_mul(acc, base)
        base = fp2_sqr(base)
        e >>= 1
    return acc


def fp2_mul_by_xi(x):
    """x · (9+u): (9a - b, a + 9b)."""
    a, b = x
    return ((9 * a - b) % P, (a + 9 * b) % P)


# ---------------------------------------------------------------------------
# Fp6
# ---------------------------------------------------------------------------

FP6_ZERO = (FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE = (FP2_ONE, FP2_ZERO, FP2_ZERO)


def fp6_add(x, y):
    return tuple(fp2_add(a, b) for a, b in zip(x, y))


def fp6_sub(x, y):
    return tuple(fp2_sub(a, b) for a, b in zip(x, y))


def fp6_neg(x):
    return tuple(fp2_neg(a) for a in x)


def fp6_mul(x, y):
    """Toom-style Fp6 mul with the Fp2 layer inlined (hot path: every
    fp12_mul makes three of these; avoiding tuple/call churn matters)."""
    (a0r, a0i), (a1r, a1i), (a2r, a2i) = x
    (b0r, b0i), (b1r, b1i), (b2r, b2i) = y
    # t_k = a_k * b_k in Fp2 (Karatsuba: 3 int muls each)
    v = a0r * b0r
    w = a0i * b0i
    t0r, t0i = (v - w) % P, ((a0r + a0i) * (b0r + b0i) - v - w) % P
    v = a1r * b1r
    w = a1i * b1i
    t1r, t1i = (v - w) % P, ((a1r + a1i) * (b1r + b1i) - v - w) % P
    v = a2r * b2r
    w = a2i * b2i
    t2r, t2i = (v - w) % P, ((a2r + a2i) * (b2r + b2i) - v - w) % P
    # c0 = t0 + ξ·((a1+a2)(b1+b2) − t1 − t2)
    sr, si = a1r + a2r, a1i + a2i
    ur, ui = b1r + b2r, b1i + b2i
    v = sr * ur
    w = si * ui
    mr, mi = (v - w - t1r - t2r) % P, ((sr + si) * (ur + ui) - v - w - t1i - t2i) % P
    c0 = ((t0r + 9 * mr - mi) % P, (t0i + mr + 9 * mi) % P)
    # c1 = (a0+a1)(b0+b1) − t0 − t1 + ξ·t2
    sr, si = a0r + a1r, a0i + a1i
    ur, ui = b0r + b1r, b0i + b1i
    v = sr * ur
    w = si * ui
    c1 = ((v - w - t0r - t1r + 9 * t2r - t2i) % P,
          ((sr + si) * (ur + ui) - v - w - t0i - t1i + t2r + 9 * t2i) % P)
    # c2 = (a0+a2)(b0+b2) − t0 − t2 + t1
    sr, si = a0r + a2r, a0i + a2i
    ur, ui = b0r + b2r, b0i + b2i
    v = sr * ur
    w = si * ui
    c2 = ((v - w - t0r - t2r + t1r) % P,
          ((sr + si) * (ur + ui) - v - w - t0i - t2i + t1i) % P)
    return (c0, c1, c2)


def fp6_sqr(x):
    """CH-SQR2: 2 Fp2 muls + 3 Fp2 squarings, Fp2 layer inlined."""
    (a0r, a0i), (a1r, a1i), (a2r, a2i) = x
    # s0 = a0², s1 = 2·a0·a1, s2 = (a0 − a1 + a2)², s3 = 2·a1·a2, s4 = a2²
    s0r, s0i = (a0r + a0i) * (a0r - a0i) % P, 2 * a0r * a0i % P
    v = a0r * a1r
    w = a0i * a1i
    s1r, s1i = 2 * (v - w) % P, 2 * ((a0r + a0i) * (a1r + a1i) - v - w) % P
    dr, di = a0r - a1r + a2r, a0i - a1i + a2i
    s2r, s2i = (dr + di) * (dr - di) % P, 2 * dr * di % P
    v = a1r * a2r
    w = a1i * a2i
    s3r, s3i = 2 * (v - w) % P, 2 * ((a1r + a1i) * (a2r + a2i) - v - w) % P
    s4r, s4i = (a2r + a2i) * (a2r - a2i) % P, 2 * a2r * a2i % P
    # c0 = s0 + ξ·s3 ; c1 = s1 + ξ·s4 ; c2 = s1 + s2 + s3 − s0 − s4
    c0 = ((s0r + 9 * s3r - s3i) % P, (s0i + s3r + 9 * s3i) % P)
    c1 = ((s1r + 9 * s4r - s4i) % P, (s1i + s4r + 9 * s4i) % P)
    c2 = ((s1r + s2r + s3r - s0r - s4r) % P, (s1i + s2i + s3i - s0i - s4i) % P)
    return (c0, c1, c2)


def fp6_mul_by_v(x):
    """x · v: (ξ·c2, c0, c1)."""
    return (fp2_mul_by_xi(x[2]), x[0], x[1])


def fp6_scalar_fp2(x, s):
    return tuple(fp2_mul(c, s) for c in x)


def fp6_inv(x):
    a0, a1, a2 = x
    c0 = fp2_sub(fp2_sqr(a0), fp2_mul_by_xi(fp2_mul(a1, a2)))
    c1 = fp2_sub(fp2_mul_by_xi(fp2_sqr(a2)), fp2_mul(a0, a1))
    c2 = fp2_sub(fp2_sqr(a1), fp2_mul(a0, a2))
    t = fp2_add(fp2_mul(a0, c0), fp2_mul_by_xi(fp2_add(fp2_mul(a2, c1), fp2_mul(a1, c2))))
    tinv = fp2_inv(t)
    return (fp2_mul(c0, tinv), fp2_mul(c1, tinv), fp2_mul(c2, tinv))


# ---------------------------------------------------------------------------
# Fp12
# ---------------------------------------------------------------------------

FP12_ZERO = (FP6_ZERO, FP6_ZERO)
FP12_ONE = (FP6_ONE, FP6_ZERO)


def fp12_add(x, y):
    return (fp6_add(x[0], y[0]), fp6_add(x[1], y[1]))


def fp12_sub(x, y):
    return (fp6_sub(x[0], y[0]), fp6_sub(x[1], y[1]))


def fp12_mul(x, y):
    a0, a1 = x
    b0, b1 = y
    t0 = fp6_mul(a0, b0)
    t1 = fp6_mul(a1, b1)
    c0 = fp6_add(t0, fp6_mul_by_v(t1))
    c1 = fp6_sub(fp6_mul(fp6_add(a0, a1), fp6_add(b0, b1)), fp6_add(t0, t1))
    return (c0, c1)


def fp12_sqr(x):
    """Complex squaring: c0 = (a0+a1)(a0+v·a1) − t − v·t, c1 = 2t with
    t = a0·a1 — 2 Fp6 muls instead of fp12_mul's 3."""
    a0, a1 = x
    t = fp6_mul(a0, a1)
    u = fp6_mul(fp6_add(a0, a1), fp6_add(a0, fp6_mul_by_v(a1)))
    c0 = fp6_sub(fp6_sub(u, t), fp6_mul_by_v(t))
    c1 = fp6_add(t, t)
    return (c0, c1)


def fp12_cyclotomic_sqr(x):
    """Granger–Scott squaring for elements of the cyclotomic subgroup
    (unit-norm results of the easy part of final exponentiation): 3 Fp4
    squarings ≈ 9 Fp2 muls, ~2× faster than generic fp12_sqr. Valid only
    when x^(p^4 − p^2 + 1) == 1."""
    ((x00, x01, x02), (x10, x11, x12)) = x
    # Fp4 squaring: (a,b) -> (a² + ξ·b², 2ab)
    def fp4_sqr(a, b):
        a2 = fp2_sqr(a)
        b2 = fp2_sqr(b)
        return (fp2_add(a2, fp2_mul_by_xi(b2)),
                fp2_sub(fp2_sub(fp2_sqr(fp2_add(a, b)), a2), b2))
    t0, t1 = fp4_sqr(x00, x11)
    t2, t3 = fp4_sqr(x10, x02)
    t4, t5 = fp4_sqr(x01, x12)
    t5 = fp2_mul_by_xi(t5)

    def _c(t, xv, plus):
        if plus:
            return fp2_add(fp2_scalar(fp2_sub(t, xv), 2), t)
        return fp2_add(fp2_scalar(fp2_add(t, xv), 2), t)

    c00 = _c(t0, x00, True)
    c01 = _c(t2, x01, True)
    c02 = _c(t4, x02, True)
    c10 = _c(t5, x10, False)
    c11 = _c(t1, x11, False)
    c12 = _c(t3, x12, False)
    return ((c00, c01, c02), (c10, c11, c12))


def fp12_conj(x):
    return (x[0], fp6_neg(x[1]))


def fp12_inv(x):
    a0, a1 = x
    t = fp6_inv(fp6_sub(fp6_sqr(a0), fp6_mul_by_v(fp6_sqr(a1))))
    return (fp6_mul(a0, t), fp6_neg(fp6_mul(a1, t)))


def fp12_pow(x, e: int):
    if e < 0:
        return fp12_pow(fp12_inv(x), -e)
    acc = FP12_ONE
    base = x
    while e:
        if e & 1:
            acc = fp12_mul(acc, base)
        base = fp12_sqr(base)
        e >>= 1
    return acc


# ---------------------------------------------------------------------------
# Frobenius
# ---------------------------------------------------------------------------

# γ6,k = ξ^(k(p−1)/3), γw = ξ^((p−1)/6) — computed once at import.
_G6_1 = fp2_pow(XI, (P - 1) // 3)
_G6_2 = fp2_pow(XI, 2 * (P - 1) // 3)
_GW = fp2_pow(XI, (P - 1) // 6)


def fp6_frob(x):
    a0, a1, a2 = x
    return (fp2_conj(a0), fp2_mul(fp2_conj(a1), _G6_1), fp2_mul(fp2_conj(a2), _G6_2))


def fp12_frob(x, n: int = 1):
    """x^(p^n) via repeated p-power Frobenius."""
    for _ in range(n):
        a0, a1 = x
        x = (fp6_frob(a0), fp6_scalar_fp2(fp6_frob(a1), _GW))
    return x


# ---------------------------------------------------------------------------
# Serialization (arkworks layout: 12 Fp elements, c0.c0.c0 first, 32B LE each)
# ---------------------------------------------------------------------------

def fp12_to_coeffs(x) -> list[int]:
    (c0, c1) = x
    out = []
    for fp6c in (c0, c1):
        for fp2c in fp6c:
            out.extend(fp2c)
    return out


def fp12_from_coeffs(cs: list[int]):
    assert len(cs) == 12
    g = [tuple(cs[i : i + 2]) for i in range(0, 12, 2)]
    return ((g[0], g[1], g[2]), (g[3], g[4], g[5]))


def fp12_to_bytes(x) -> bytes:
    """384-byte arkworks GT serialization (reference pairing.zig:635-681)."""
    return b"".join(c.to_bytes(32, "little") for c in fp12_to_coeffs(x))


def fp12_from_bytes(data: bytes):
    assert len(data) == 384
    return fp12_from_coeffs(
        [int.from_bytes(data[i * 32 : (i + 1) * 32], "little") for i in range(12)]
    )
