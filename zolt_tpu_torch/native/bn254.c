/* BN254 native runtime: Montgomery Fp, Fp2/6/12 tower, arkworks-exact
 * optimal-ate Miller loop + Fuentes-Castañeda final exponentiation, G1/G2
 * Jacobian MSM.
 *
 * This is the native tier of the framework's host runtime (the prover's
 * pairing/commitment path; device compute stays in JAX/XLA). It is an exact
 * port of the Python implementation in zolt_tpu/field/tower.py and
 * zolt_tpu/curve/pairing.py (which mirrors the reference's
 * src/field/pairing.zig:933-1872) and is differentially tested against it —
 * the Python code remains the oracle.
 *
 * ABI: all field elements cross the boundary as canonical (non-Montgomery)
 * 32-byte little-endian values. Constants that depend on the tower (frobenius
 * gammas, twist b, 1/2) are injected from Python at init so the two
 * implementations cannot drift.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#ifdef _OPENMP
#include <omp.h>
#endif

typedef uint64_t u64;
typedef unsigned __int128 u128;

typedef struct { u64 l[4]; } fp;        /* Montgomery form */
typedef struct { fp c0, c1; } fp2;
typedef struct { fp2 c0, c1, c2; } fp6;
typedef struct { fp6 c0, c1; } fp12;
typedef struct { fp x, y; int inf; } g1aff;
typedef struct { fp2 x, y; int inf; } g2aff;

static fp PMOD, R2;
static u64 NINV;
static fp FP_ZERO_, FP_ONE_;            /* 0, to_mont(1) */
static fp TWO_INV_;
static fp2 G6_1_, G6_2_, GW_, GAMMA12_, GAMMA13_, TWIST_B_;

/* ---------------- Fp ---------------- */

static inline int fp_is_zero(const fp *a) {
    return (a->l[0] | a->l[1] | a->l[2] | a->l[3]) == 0;
}

static inline int fp_eq(const fp *a, const fp *b) {
    return a->l[0] == b->l[0] && a->l[1] == b->l[1]
        && a->l[2] == b->l[2] && a->l[3] == b->l[3];
}

static inline int fp_geq_p(const fp *a) {
    for (int i = 3; i >= 0; i--) {
        if (a->l[i] > PMOD.l[i]) return 1;
        if (a->l[i] < PMOD.l[i]) return 0;
    }
    return 1;
}

static inline void fp_sub_p(fp *a) {
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a->l[i] - PMOD.l[i] - (u64)borrow;
        a->l[i] = (u64)d;
        borrow = (d >> 64) & 1;
    }
}

static inline void fp_add(fp *r, const fp *a, const fp *b) {
    u128 carry = 0;
    for (int i = 0; i < 4; i++) {
        u128 s = (u128)a->l[i] + b->l[i] + (u64)carry;
        r->l[i] = (u64)s;
        carry = s >> 64;
    }
    if (carry || fp_geq_p(r)) fp_sub_p(r);
}

static inline void fp_sub(fp *r, const fp *a, const fp *b) {
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a->l[i] - b->l[i] - (u64)borrow;
        r->l[i] = (u64)d;
        borrow = (d >> 64) & 1;
    }
    if (borrow) {
        u128 carry = 0;
        for (int i = 0; i < 4; i++) {
            u128 s = (u128)r->l[i] + PMOD.l[i] + (u64)carry;
            r->l[i] = (u64)s;
            carry = s >> 64;
        }
    }
}

static inline void fp_neg(fp *r, const fp *a) {
    if (fp_is_zero(a)) { *r = *a; return; }
    fp z = {{0, 0, 0, 0}};
    fp_sub(r, &z, a);
}

static inline void fp_dbl(fp *r, const fp *a) { fp_add(r, a, a); }

/* CIOS Montgomery multiplication */
static void fp_mul(fp *r, const fp *a, const fp *b) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u128 carry = 0;
        u64 ai = a->l[i];
        for (int j = 0; j < 4; j++) {
            u128 s = (u128)t[j] + (u128)ai * b->l[j] + (u64)carry;
            t[j] = (u64)s;
            carry = s >> 64;
        }
        u128 s = (u128)t[4] + (u64)carry;
        t[4] = (u64)s;
        t[5] = (u64)(s >> 64);

        u64 m = t[0] * NINV;
        carry = 0;
        u128 s2 = (u128)t[0] + (u128)m * PMOD.l[0];
        carry = s2 >> 64;
        for (int j = 1; j < 4; j++) {
            u128 s3 = (u128)t[j] + (u128)m * PMOD.l[j] + (u64)carry;
            t[j - 1] = (u64)s3;
            carry = s3 >> 64;
        }
        u128 s4 = (u128)t[4] + (u64)carry;
        t[3] = (u64)s4;
        t[4] = t[5] + (u64)(s4 >> 64);
        t[5] = 0;
    }
    r->l[0] = t[0]; r->l[1] = t[1]; r->l[2] = t[2]; r->l[3] = t[3];
    if (t[4] || fp_geq_p(r)) fp_sub_p(r);
}

static inline void fp_sqr(fp *r, const fp *a) { fp_mul(r, a, a); }

/* a^e with e given as 4 little-endian limbs */
static void fp_pow_limbs(fp *r, const fp *a, const u64 e[4]) {
    fp acc = FP_ONE_, base = *a;
    for (int limb = 0; limb < 4; limb++) {
        u64 ev = e[limb];
        for (int bit = 0; bit < 64; bit++) {
            if (ev & 1) { fp t; fp_mul(&t, &acc, &base); acc = t; }
            ev >>= 1;
            if (ev == 0 && limb == 3) break;
            fp t; fp_sqr(&t, &base); base = t;
        }
    }
    *r = acc;
}

static void fp_inv(fp *r, const fp *a) {
    /* Fermat: a^(p-2) */
    u64 e[4];
    fp pm2 = PMOD;
    u128 borrow = 2;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)pm2.l[i] - (u64)borrow;
        e[i] = (u64)d;
        borrow = (d >> 64) & 1;
    }
    fp_pow_limbs(r, a, e);
}

static void fp_from_bytes(fp *r, const uint8_t *b) {
    /* canonical LE bytes -> Montgomery */
    fp t;
    for (int i = 0; i < 4; i++) {
        u64 v = 0;
        for (int j = 7; j >= 0; j--) v = (v << 8) | b[i * 8 + j];
        t.l[i] = v;
    }
    fp_mul(r, &t, &R2);
}

static void fp_to_bytes(const fp *a, uint8_t *b) {
    fp one = {{1, 0, 0, 0}}, t;
    fp_mul(&t, a, &one);            /* from Montgomery */
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 8; j++) b[i * 8 + j] = (uint8_t)(t.l[i] >> (8 * j));
}

/* ---------------- Fp2 ---------------- */

static const fp2 *FP2_ZERO_(void) { static fp2 z; return &z; }

static inline void fp2_add(fp2 *r, const fp2 *a, const fp2 *b) {
    fp_add(&r->c0, &a->c0, &b->c0);
    fp_add(&r->c1, &a->c1, &b->c1);
}

static inline void fp2_sub(fp2 *r, const fp2 *a, const fp2 *b) {
    fp_sub(&r->c0, &a->c0, &b->c0);
    fp_sub(&r->c1, &a->c1, &b->c1);
}

static inline void fp2_neg(fp2 *r, const fp2 *a) {
    fp_neg(&r->c0, &a->c0);
    fp_neg(&r->c1, &a->c1);
}

static inline void fp2_conj(fp2 *r, const fp2 *a) {
    r->c0 = a->c0;
    fp_neg(&r->c1, &a->c1);
}

static void fp2_mul(fp2 *r, const fp2 *a, const fp2 *b) {
    fp ac, bd, s1, s2, m;
    fp_mul(&ac, &a->c0, &b->c0);
    fp_mul(&bd, &a->c1, &b->c1);
    fp_add(&s1, &a->c0, &a->c1);
    fp_add(&s2, &b->c0, &b->c1);
    fp_mul(&m, &s1, &s2);
    fp2 out;
    fp_sub(&out.c0, &ac, &bd);
    fp_sub(&m, &m, &ac);
    fp_sub(&out.c1, &m, &bd);
    *r = out;
}

static void fp2_sqr(fp2 *r, const fp2 *a) {
    fp s, d, m;
    fp_add(&s, &a->c0, &a->c1);
    fp_sub(&d, &a->c0, &a->c1);
    fp_mul(&m, &a->c0, &a->c1);
    fp2 out;
    fp_mul(&out.c0, &s, &d);
    fp_dbl(&out.c1, &m);
    *r = out;
}

static inline void fp_mul9(fp *r, const fp *a) {
    fp d2, d4, d8;
    fp_dbl(&d2, a); fp_dbl(&d4, &d2); fp_dbl(&d8, &d4);
    fp_add(r, &d8, a);
}

/* xi = 9 + u:  (9a0 - a1, a0 + 9a1) */
static void fp2_mul_by_xi(fp2 *r, const fp2 *a) {
    fp n0, n1;
    fp_mul9(&n0, &a->c0);
    fp_mul9(&n1, &a->c1);
    fp2 out;
    fp_sub(&out.c0, &n0, &a->c1);
    fp_add(&out.c1, &a->c0, &n1);
    *r = out;
}

static void fp2_inv(fp2 *r, const fp2 *a) {
    fp t0, t1, t;
    fp_sqr(&t0, &a->c0);
    fp_sqr(&t1, &a->c1);
    fp_add(&t, &t0, &t1);
    fp tinv;
    fp_inv(&tinv, &t);
    fp2 out;
    fp_mul(&out.c0, &a->c0, &tinv);
    fp nc1;
    fp_neg(&nc1, &a->c1);
    fp_mul(&out.c1, &nc1, &tinv);
    *r = out;
}

static inline void fp2_scalar_fp(fp2 *r, const fp2 *a, const fp *s) {
    fp_mul(&r->c0, &a->c0, s);
    fp_mul(&r->c1, &a->c1, s);
}

static inline int fp2_is_zero(const fp2 *a) {
    return fp_is_zero(&a->c0) && fp_is_zero(&a->c1);
}

static inline void fp2_dbl(fp2 *r, const fp2 *a) { fp2_add(r, a, a); }

/* ---------------- Fp6 ---------------- */

static void fp6_add(fp6 *r, const fp6 *a, const fp6 *b) {
    fp2_add(&r->c0, &a->c0, &b->c0);
    fp2_add(&r->c1, &a->c1, &b->c1);
    fp2_add(&r->c2, &a->c2, &b->c2);
}

static void fp6_sub(fp6 *r, const fp6 *a, const fp6 *b) {
    fp2_sub(&r->c0, &a->c0, &b->c0);
    fp2_sub(&r->c1, &a->c1, &b->c1);
    fp2_sub(&r->c2, &a->c2, &b->c2);
}

static void fp6_neg(fp6 *r, const fp6 *a) {
    fp2_neg(&r->c0, &a->c0);
    fp2_neg(&r->c1, &a->c1);
    fp2_neg(&r->c2, &a->c2);
}

static void fp6_mul(fp6 *r, const fp6 *a, const fp6 *b) {
    fp2 t0, t1, t2, s, u, m, tmp;
    fp2_mul(&t0, &a->c0, &b->c0);
    fp2_mul(&t1, &a->c1, &b->c1);
    fp2_mul(&t2, &a->c2, &b->c2);
    fp6 out;
    /* c0 = t0 + xi*((a1+a2)(b1+b2) - t1 - t2) */
    fp2_add(&s, &a->c1, &a->c2);
    fp2_add(&u, &b->c1, &b->c2);
    fp2_mul(&m, &s, &u);
    fp2_sub(&m, &m, &t1);
    fp2_sub(&m, &m, &t2);
    fp2_mul_by_xi(&tmp, &m);
    fp2_add(&out.c0, &t0, &tmp);
    /* c1 = (a0+a1)(b0+b1) - t0 - t1 + xi*t2 */
    fp2_add(&s, &a->c0, &a->c1);
    fp2_add(&u, &b->c0, &b->c1);
    fp2_mul(&m, &s, &u);
    fp2_sub(&m, &m, &t0);
    fp2_sub(&m, &m, &t1);
    fp2_mul_by_xi(&tmp, &t2);
    fp2_add(&out.c1, &m, &tmp);
    /* c2 = (a0+a2)(b0+b2) - t0 - t2 + t1 */
    fp2_add(&s, &a->c0, &a->c2);
    fp2_add(&u, &b->c0, &b->c2);
    fp2_mul(&m, &s, &u);
    fp2_sub(&m, &m, &t0);
    fp2_sub(&m, &m, &t2);
    fp2_add(&out.c2, &m, &t1);
    *r = out;
}

static void fp6_sqr(fp6 *r, const fp6 *a) { fp6_mul(r, a, a); }

static void fp6_mul_by_v(fp6 *r, const fp6 *a) {
    fp6 out;
    fp2_mul_by_xi(&out.c0, &a->c2);
    out.c1 = a->c0;
    out.c2 = a->c1;
    *r = out;
}

static void fp6_inv(fp6 *r, const fp6 *a) {
    fp2 c0, c1, c2, t, tmp, tmp2;
    fp2_sqr(&c0, &a->c0);
    fp2_mul(&tmp, &a->c1, &a->c2);
    fp2_mul_by_xi(&tmp2, &tmp);
    fp2_sub(&c0, &c0, &tmp2);
    fp2_sqr(&tmp, &a->c2);
    fp2_mul_by_xi(&tmp2, &tmp);
    fp2_mul(&tmp, &a->c0, &a->c1);
    fp2_sub(&c1, &tmp2, &tmp);
    fp2_sqr(&tmp, &a->c1);
    fp2_mul(&tmp2, &a->c0, &a->c2);
    fp2_sub(&c2, &tmp, &tmp2);
    fp2_mul(&t, &a->c0, &c0);
    fp2_mul(&tmp, &a->c2, &c1);
    fp2_mul(&tmp2, &a->c1, &c2);
    fp2_add(&tmp, &tmp, &tmp2);
    fp2_mul_by_xi(&tmp2, &tmp);
    fp2_add(&t, &t, &tmp2);
    fp2 tinv;
    fp2_inv(&tinv, &t);
    fp2_mul(&r->c0, &c0, &tinv);
    fp2_mul(&r->c1, &c1, &tinv);
    fp2_mul(&r->c2, &c2, &tinv);
}

static void fp6_frob(fp6 *r, const fp6 *a) {
    fp2 t;
    fp2_conj(&r->c0, &a->c0);
    fp2_conj(&t, &a->c1);
    fp2_mul(&r->c1, &t, &G6_1_);
    fp2_conj(&t, &a->c2);
    fp2_mul(&r->c2, &t, &G6_2_);
}

/* ---------------- Fp12 ---------------- */

static void fp12_mul(fp12 *r, const fp12 *a, const fp12 *b) {
    fp6 t0, t1, s, u, m, tmp;
    fp6_mul(&t0, &a->c0, &b->c0);
    fp6_mul(&t1, &a->c1, &b->c1);
    fp12 out;
    fp6_mul_by_v(&tmp, &t1);
    fp6_add(&out.c0, &t0, &tmp);
    fp6_add(&s, &a->c0, &a->c1);
    fp6_add(&u, &b->c0, &b->c1);
    fp6_mul(&m, &s, &u);
    fp6_sub(&m, &m, &t0);
    fp6_sub(&out.c1, &m, &t1);
    *r = out;
}

static void fp12_sqr(fp12 *r, const fp12 *a) {
    fp6 t, u, s, tmp;
    fp6_mul(&t, &a->c0, &a->c1);
    fp6_mul_by_v(&tmp, &a->c1);
    fp6_add(&tmp, &a->c0, &tmp);
    fp6_add(&s, &a->c0, &a->c1);
    fp6_mul(&u, &s, &tmp);
    fp12 out;
    fp6_sub(&u, &u, &t);
    fp6_mul_by_v(&tmp, &t);
    fp6_sub(&out.c0, &u, &tmp);
    fp6_add(&out.c1, &t, &t);
    *r = out;
}

static void fp12_conj(fp12 *r, const fp12 *a) {
    r->c0 = a->c0;
    fp6_neg(&r->c1, &a->c1);
}

static void fp12_inv(fp12 *r, const fp12 *a) {
    fp6 t0, t1, t;
    fp6_sqr(&t0, &a->c0);
    fp6_sqr(&t1, &a->c1);
    fp6_mul_by_v(&t1, &t1);
    fp6_sub(&t, &t0, &t1);
    fp6 tinv;
    fp6_inv(&tinv, &t);
    fp6_mul(&r->c0, &a->c0, &tinv);
    fp6_mul(&t, &a->c1, &tinv);
    fp6_neg(&r->c1, &t);
}

static void fp12_frob(fp12 *r, const fp12 *a, int n) {
    fp12 x = *a;
    for (int k = 0; k < n; k++) {
        fp12 out;
        fp6_frob(&out.c0, &x.c0);
        fp6 f1;
        fp6_frob(&f1, &x.c1);
        fp2_mul(&out.c1.c0, &f1.c0, &GW_);
        fp2_mul(&out.c1.c1, &f1.c1, &GW_);
        fp2_mul(&out.c1.c2, &f1.c2, &GW_);
        x = out;
    }
    *r = x;
}

static void fp12_one(fp12 *r) {
    memset(r, 0, sizeof *r);
    r->c0.c0.c0 = FP_ONE_;
}

/* Granger-Scott cyclotomic squaring (valid in the cyclotomic subgroup) */
static void fp4_sqr(fp2 *out_a, fp2 *out_b, const fp2 *a, const fp2 *b) {
    fp2 a2, b2, s, t;
    fp2_sqr(&a2, a);
    fp2_sqr(&b2, b);
    fp2_mul_by_xi(&t, &b2);
    fp2_add(out_a, &a2, &t);
    fp2_add(&s, a, b);
    fp2_sqr(&s, &s);
    fp2_sub(&s, &s, &a2);
    fp2_sub(out_b, &s, &b2);
}

static void fp12_cyc_sqr(fp12 *r, const fp12 *x) {
    fp2 t0, t1, t2, t3, t4, t5, tmp;
    fp4_sqr(&t0, &t1, &x->c0.c0, &x->c1.c1);
    fp4_sqr(&t2, &t3, &x->c1.c0, &x->c0.c2);
    fp4_sqr(&t4, &t5, &x->c0.c1, &x->c1.c2);
    fp2_mul_by_xi(&tmp, &t5);
    t5 = tmp;
    fp12 out;
    /* plus: c = 2(t - x) + t ; minus: c = 2(t + x) + t */
#define CPLUS(dst, t, xv) do { fp2 d; fp2_sub(&d, &(t), &(xv)); fp2_dbl(&d, &d); fp2_add(&(dst), &d, &(t)); } while (0)
#define CMINUS(dst, t, xv) do { fp2 d; fp2_add(&d, &(t), &(xv)); fp2_dbl(&d, &d); fp2_add(&(dst), &d, &(t)); } while (0)
    CPLUS(out.c0.c0, t0, x->c0.c0);
    CPLUS(out.c0.c1, t2, x->c0.c1);
    CPLUS(out.c0.c2, t4, x->c0.c2);
    CMINUS(out.c1.c0, t5, x->c1.c0);
    CMINUS(out.c1.c1, t1, x->c1.c1);
    CMINUS(out.c1.c2, t3, x->c1.c2);
#undef CPLUS
#undef CMINUS
    *r = out;
}

/* ---------------- sparse Fp12 muls for the Miller loop ---------------- */

static void fp6_mul_by_01(fp6 *r, const fp6 *f, const fp2 *c0, const fp2 *c1) {
    fp2 a_a, b_b, t1, t2, t3, s;
    fp2_mul(&a_a, &f->c0, c0);
    fp2_mul(&b_b, &f->c1, c1);
    fp2_add(&s, &f->c1, &f->c2);
    fp2_mul(&t1, c1, &s);
    fp2_sub(&t1, &t1, &b_b);
    fp2_mul_by_xi(&t1, &t1);
    fp2_add(&t1, &t1, &a_a);
    fp2_add(&s, &f->c0, &f->c2);
    fp2_mul(&t3, c0, &s);
    fp2_sub(&t3, &t3, &a_a);
    fp2_add(&t3, &t3, &b_b);
    fp2 c0c1, f0f1;
    fp2_add(&c0c1, c0, c1);
    fp2_add(&f0f1, &f->c0, &f->c1);
    fp2_mul(&t2, &c0c1, &f0f1);
    fp2_sub(&t2, &t2, &a_a);
    fp2_sub(&t2, &t2, &b_b);
    r->c0 = t1; r->c1 = t2; r->c2 = t3;
}

static void fp12_mul_by_034(fp12 *f, const fp2 *c0, const fp2 *c3, const fp2 *c4) {
    fp6 a, b, e, fsum;
    fp2_mul(&a.c0, &f->c0.c0, c0);
    fp2_mul(&a.c1, &f->c0.c1, c0);
    fp2_mul(&a.c2, &f->c0.c2, c0);
    fp6_mul_by_01(&b, &f->c1, c3, c4);
    fp2_add(&fsum.c0, &f->c0.c0, &f->c1.c0);
    fp2_add(&fsum.c1, &f->c0.c1, &f->c1.c1);
    fp2_add(&fsum.c2, &f->c0.c2, &f->c1.c2);
    fp2 c0c3;
    fp2_add(&c0c3, c0, c3);
    fp6_mul_by_01(&e, &fsum, &c0c3, c4);
    fp6 c1n, bv;
    fp6_sub(&c1n, &e, &a);
    fp6_sub(&c1n, &c1n, &b);
    fp6_mul_by_v(&bv, &b);
    fp6_add(&f->c0, &a, &bv);
    f->c1 = c1n;
}

/* ---------------- Miller loop (arkworks digits) ---------------- */

static const int8_t ATE_DIGITS[65] = {
    0, 0, 0, 1, 0, 1, 0, -1, 0, 0, -1, 0, 0, 0, 1, 0,
    0, -1, 0, -1, 0, 0, 0, 1, 0, -1, 0, 0, 0, 0, -1, 0,
    0, 1, 0, -1, 0, 0, 1, 0, 0, 0, 0, 0, -1, 0, 0, -1,
    0, 1, 0, -1, 0, 0, 0, -1, 0, -1, 0, 0, 0, 1, 0, 1,
    1,
};

typedef struct { fp2 x, y, z; } g2proj;

static void dbl_step(g2proj *r, fp2 *l0, fp2 *l1, fp2 *l2) {
    fp2 a, b, c, e, f, g, h, i, j, e_sq, t, three_c;
    fp2_mul(&a, &r->x, &r->y);
    fp2_scalar_fp(&a, &a, &TWO_INV_);
    fp2_sqr(&b, &r->y);
    fp2_sqr(&c, &r->z);
    fp2_dbl(&three_c, &c);
    fp2_add(&three_c, &three_c, &c);
    fp2_mul(&e, &three_c, &TWIST_B_);
    fp2_dbl(&f, &e);
    fp2_add(&f, &f, &e);
    fp2_add(&g, &b, &f);
    fp2_scalar_fp(&g, &g, &TWO_INV_);
    fp2_add(&h, &r->y, &r->z);
    fp2_sqr(&h, &h);
    fp2_add(&t, &b, &c);
    fp2_sub(&h, &h, &t);
    fp2_sub(&i, &e, &b);
    fp2_sqr(&j, &r->x);
    fp2_sqr(&e_sq, &e);
    /* new point */
    fp2 nx, ny, nz;
    fp2_sub(&t, &b, &f);
    fp2_mul(&nx, &a, &t);
    fp2_sqr(&ny, &g);
    fp2_dbl(&t, &e_sq);
    fp2_add(&t, &t, &e_sq);
    fp2_sub(&ny, &ny, &t);
    fp2_mul(&nz, &b, &h);
    r->x = nx; r->y = ny; r->z = nz;
    fp2_neg(l0, &h);
    fp2_dbl(l1, &j);
    fp2_add(l1, l1, &j);
    *l2 = i;
}

static void add_step(g2proj *r, const g2aff *q, fp2 *l0, fp2 *l1, fp2 *l2) {
    fp2 theta, lam, c, d, e, f, g, h, t;
    fp2_mul(&t, &q->y, &r->z);
    fp2_sub(&theta, &r->y, &t);
    fp2_mul(&t, &q->x, &r->z);
    fp2_sub(&lam, &r->x, &t);
    fp2_sqr(&c, &theta);
    fp2_sqr(&d, &lam);
    fp2_mul(&e, &lam, &d);
    fp2_mul(&f, &r->z, &c);
    fp2_mul(&g, &r->x, &d);
    fp2_dbl(&t, &g);
    fp2_add(&h, &e, &f);
    fp2_sub(&h, &h, &t);
    fp2 nx, ny, nz;
    fp2_mul(&nx, &lam, &h);
    fp2_sub(&t, &g, &h);
    fp2_mul(&ny, &theta, &t);
    fp2 ey;
    fp2_mul(&ey, &e, &r->y);
    fp2_sub(&ny, &ny, &ey);
    fp2_mul(&nz, &r->z, &e);
    r->x = nx; r->y = ny; r->z = nz;
    *l0 = lam;
    fp2_neg(l1, &theta);
    fp2 tqx, lqy;
    fp2_mul(&tqx, &theta, &q->x);
    fp2_mul(&lqy, &lam, &q->y);
    fp2_sub(l2, &tqx, &lqy);
}

static void mul_by_char(g2aff *r, const g2aff *q) {
    fp2 t;
    fp2_conj(&t, &q->x);
    fp2_mul(&r->x, &t, &GAMMA12_);
    fp2_conj(&t, &q->y);
    fp2_mul(&r->y, &t, &GAMMA13_);
    r->inf = q->inf;
}

/* accumulate one miller loop into f (f *= miller(p, q)) */
static void miller_accum(fp12 *f, const g1aff *p, const g2aff *q) {
    if (p->inf || q->inf) return;
    fp12 acc;
    fp12_one(&acc);
    g2proj r = { q->x, q->y, {FP_ONE_, {{0,0,0,0}}} };
    g2aff neg_q = *q;
    fp2_neg(&neg_q.y, &q->y);
    fp2 l0, l1, l2, s0, s1;
    for (int idx = 64; idx >= 1; idx--) {
        if (idx != 64) fp12_sqr(&acc, &acc);
        dbl_step(&r, &l0, &l1, &l2);
        fp2_scalar_fp(&s0, &l0, &p->y);
        fp2_scalar_fp(&s1, &l1, &p->x);
        fp12_mul_by_034(&acc, &s0, &s1, &l2);
        int8_t bit = ATE_DIGITS[idx - 1];
        if (bit == 1) {
            add_step(&r, q, &l0, &l1, &l2);
            fp2_scalar_fp(&s0, &l0, &p->y);
            fp2_scalar_fp(&s1, &l1, &p->x);
            fp12_mul_by_034(&acc, &s0, &s1, &l2);
        } else if (bit == -1) {
            add_step(&r, &neg_q, &l0, &l1, &l2);
            fp2_scalar_fp(&s0, &l0, &p->y);
            fp2_scalar_fp(&s1, &l1, &p->x);
            fp12_mul_by_034(&acc, &s0, &s1, &l2);
        }
    }
    g2aff q1, q2;
    mul_by_char(&q1, q);
    add_step(&r, &q1, &l0, &l1, &l2);
    fp2_scalar_fp(&s0, &l0, &p->y);
    fp2_scalar_fp(&s1, &l1, &p->x);
    fp12_mul_by_034(&acc, &s0, &s1, &l2);
    mul_by_char(&q2, &q1);
    fp2_neg(&q2.y, &q2.y);
    add_step(&r, &q2, &l0, &l1, &l2);
    fp2_scalar_fp(&s0, &l0, &p->y);
    fp2_scalar_fp(&s1, &l1, &p->x);
    fp12_mul_by_034(&acc, &s0, &s1, &l2);
    fp12 t;
    fp12_mul(&t, f, &acc);
    *f = t;
}

static void final_exp(fp12 *r, const fp12 *f);
static void fp12_to_bytes_(const fp12 *a, uint8_t *b);
static void fp2_from_bytes(fp2 *r, const uint8_t *b);

/* ---- precomputed-line multi-Miller (fixed G2 vectors) ----
 * The ate schedule is point-independent, so each Q's line coefficients
 * (l0, l1, l2 per dbl/add step) can be computed once and reused across
 * every pairing with that Q; a multi-pairing then shares ONE accumulator,
 * replacing n·64 fp12 squarings with 64. */

static int ate_line_count(void) {
    int n = 64 + 2;
    for (int idx = 64; idx >= 1; idx--)
        if (ATE_DIGITS[idx - 1] != 0) n++;
    return n;
}

/* emit Q's line triples (Montgomery-form fp2 raw limbs) into out */
static void g2_precompute_lines(const g2aff *q, fp2 *out) {
    g2proj r = { q->x, q->y, {FP_ONE_, {{0,0,0,0}}} };
    g2aff neg_q = *q;
    fp2_neg(&neg_q.y, &q->y);
    int w = 0;
    fp2 l0, l1, l2;
    for (int idx = 64; idx >= 1; idx--) {
        dbl_step(&r, &l0, &l1, &l2);
        out[w] = l0; out[w + 1] = l1; out[w + 2] = l2; w += 3;
        int8_t bit = ATE_DIGITS[idx - 1];
        if (bit == 1) {
            add_step(&r, q, &l0, &l1, &l2);
            out[w] = l0; out[w + 1] = l1; out[w + 2] = l2; w += 3;
        } else if (bit == -1) {
            add_step(&r, &neg_q, &l0, &l1, &l2);
            out[w] = l0; out[w + 1] = l1; out[w + 2] = l2; w += 3;
        }
    }
    g2aff q1, q2;
    mul_by_char(&q1, q);
    add_step(&r, &q1, &l0, &l1, &l2);
    out[w] = l0; out[w + 1] = l1; out[w + 2] = l2; w += 3;
    mul_by_char(&q2, &q1);
    fp2_neg(&q2.y, &q2.y);
    add_step(&r, &q2, &l0, &l1, &l2);
    out[w] = l0; out[w + 1] = l1; out[w + 2] = l2;
}

/* Exported: precompute lines for n G2 points (canonical affine bytes in).
 * out receives n * ate_line_count() * 3 fp2 = n*lines*128 bytes of raw
 * Montgomery limb data (opaque to the caller; device/arch-local cache). */
int bn254_g2_precompute(const uint8_t *g2s, int n, uint8_t *out) {
    int lines = ate_line_count();
    for (int i = 0; i < n; i++) {
        const uint8_t *qb = g2s + (long)i * 128;
        int allz = 1;
        for (int k = 0; k < 128; k++) if (qb[k]) { allz = 0; break; }
        fp2 *dst = (fp2 *)(out + (long)i * lines * 3 * sizeof(fp2));
        if (allz) {
            memset(dst, 0, (size_t)lines * 3 * sizeof(fp2));
            continue;
        }
        g2aff q;
        fp2_from_bytes(&q.x, qb);
        fp2_from_bytes(&q.y, qb + 64);
        q.inf = 0;
        g2_precompute_lines(&q, dst);
    }
    return lines;
}

/* Multi-pairing with precomputed lines + shared accumulator.
 * g1s: n*64 canonical affine; pre: from bn254_g2_precompute; mask: n bytes
 * (0 = skip pair). out: 384-byte GT (canonical), final exp applied. */
void bn254_multi_pairing_pre(const uint8_t *g1s, const uint8_t *pre,
                             const uint8_t *mask, int n, uint8_t *out) {
    int lines = ate_line_count();
    g1aff *ps = malloc((size_t)n * sizeof(g1aff));
    int any = 0;
    for (int i = 0; i < n; i++) {
        const uint8_t *pb = g1s + (long)i * 64;
        int allz = 1;
        for (int k = 0; k < 64; k++) if (pb[k]) { allz = 0; break; }
        ps[i].inf = allz || !mask[i];
        if (!ps[i].inf) {
            fp_from_bytes(&ps[i].x, pb);
            fp_from_bytes(&ps[i].y, pb + 32);
            any = 1;
        }
    }
    fp12 acc;
    fp12_one(&acc);
    if (any) {
        int nchunks = 1;
#ifdef _OPENMP
        nchunks = omp_get_max_threads();
        if (nchunks > n) nchunks = n;
        if (nchunks < 1) nchunks = 1;
#endif
        fp12 *partial = malloc((size_t)nchunks * sizeof(fp12));
#ifdef _OPENMP
#pragma omp parallel for num_threads(nchunks) schedule(static)
#endif
        for (int c = 0; c < nchunks; c++) {
            int lo = (int)((long)n * c / nchunks);
            int hi = (int)((long)n * (c + 1) / nchunks);
            fp12 a;
            fp12_one(&a);
            long w = 0; /* line index within each point's stream */
            fp2 s0, s1;
            for (int idx = 64; idx >= 1; idx--) {
                if (idx != 64) { fp12 t; fp12_sqr(&t, &a); a = t; }
                for (int i = lo; i < hi; i++) {
                    if (ps[i].inf) continue;
                    const fp2 *l = (const fp2 *)(pre + ((long)i * lines + w) * 3 * sizeof(fp2));
                    fp2_scalar_fp(&s0, &l[0], &ps[i].y);
                    fp2_scalar_fp(&s1, &l[1], &ps[i].x);
                    fp12_mul_by_034(&a, &s0, &s1, &l[2]);
                }
                w++;
                if (ATE_DIGITS[idx - 1] != 0) {
                    for (int i = lo; i < hi; i++) {
                        if (ps[i].inf) continue;
                        const fp2 *l = (const fp2 *)(pre + ((long)i * lines + w) * 3 * sizeof(fp2));
                        fp2_scalar_fp(&s0, &l[0], &ps[i].y);
                        fp2_scalar_fp(&s1, &l[1], &ps[i].x);
                        fp12_mul_by_034(&a, &s0, &s1, &l[2]);
                    }
                    w++;
                }
            }
            for (int step = 0; step < 2; step++) {
                for (int i = lo; i < hi; i++) {
                    if (ps[i].inf) continue;
                    const fp2 *l = (const fp2 *)(pre + ((long)i * lines + w) * 3 * sizeof(fp2));
                    fp2_scalar_fp(&s0, &l[0], &ps[i].y);
                    fp2_scalar_fp(&s1, &l[1], &ps[i].x);
                    fp12_mul_by_034(&a, &s0, &s1, &l[2]);
                }
                w++;
            }
            partial[c] = a;
        }
        for (int c = 0; c < nchunks; c++) {
            fp12 t;
            fp12_mul(&t, &acc, &partial[c]);
            acc = t;
        }
        free(partial);
    }
    free(ps);
    fp12 r;
    final_exp(&r, &acc);
    fp12_to_bytes_(&r, out);
}

/* ---------------- final exponentiation ---------------- */

#define BN_X_C 4965661367192848881ULL

static void exp_neg_x(fp12 *r, const fp12 *g) {
    fp12 acc, base = *g, t;
    fp12_one(&acc);
    u64 e = BN_X_C;
    while (e) {
        if (e & 1) { fp12_mul(&t, &acc, &base); acc = t; }
        e >>= 1;
        if (e) { fp12_cyc_sqr(&t, &base); base = t; }
    }
    fp12_conj(r, &acc);
}

static void final_exp(fp12 *r, const fp12 *f) {
    fp12 f1, finv, rr, t;
    fp12_conj(&f1, f);
    fp12_inv(&finv, f);
    fp12_mul(&t, &f1, &finv);
    fp12_frob(&rr, &t, 2);
    fp12 base;
    fp12_mul(&base, &rr, &t);       /* r = frob2(f1) * f1 */
    fp12 y0, y1, y2, y3, y4, y5, y6, y7, y8, y9, y10, y11, y12, y13, y14, y15;
    exp_neg_x(&y0, &base);
    fp12_cyc_sqr(&y1, &y0);
    fp12_cyc_sqr(&y2, &y1);
    fp12_mul(&y3, &y2, &y1);
    exp_neg_x(&y4, &y3);
    fp12_cyc_sqr(&y5, &y4);
    exp_neg_x(&y6, &y5);
    fp12_conj(&t, &y3); y3 = t;
    fp12_conj(&t, &y6); y6 = t;
    fp12_mul(&y7, &y6, &y4);
    fp12_mul(&y8, &y7, &y3);
    fp12_mul(&y9, &y8, &y1);
    fp12_mul(&y10, &y8, &y4);
    fp12_mul(&y11, &y10, &base);
    fp12_frob(&y12, &y9, 1);
    fp12_mul(&y13, &y12, &y11);
    fp12_frob(&t, &y8, 2); y8 = t;
    fp12_mul(&y14, &y8, &y13);
    fp12_conj(&t, &base);
    fp12_mul(&y15, &t, &y9);
    fp12_frob(&t, &y15, 3); y15 = t;
    fp12_mul(r, &y15, &y14);
}

/* ---------------- G1 / G2 Jacobian MSM ---------------- */

typedef struct { fp x, y, z; } g1jac;   /* z==0 => infinity */

static void g1_dbl(g1jac *r, const g1jac *a) {
    if (fp_is_zero(&a->z) || fp_is_zero(&a->y)) { memset(r, 0, sizeof *r); return; }
    fp A, B, C, D, E, F, t, t2;
    fp_sqr(&A, &a->x);
    fp_sqr(&B, &a->y);
    fp_sqr(&C, &B);
    fp_add(&t, &a->x, &B);
    fp_sqr(&t, &t);
    fp_sub(&t, &t, &A);
    fp_sub(&t, &t, &C);
    fp_dbl(&D, &t);
    fp_dbl(&E, &A);
    fp_add(&E, &E, &A);
    fp_sqr(&F, &E);
    g1jac out;
    fp_dbl(&t, &D);
    fp_sub(&out.x, &F, &t);
    fp_sub(&t, &D, &out.x);
    fp_mul(&t, &E, &t);
    fp_dbl(&t2, &C); fp_dbl(&t2, &t2); fp_dbl(&t2, &t2);
    fp_sub(&out.y, &t, &t2);
    fp_mul(&t, &a->y, &a->z);
    fp_dbl(&out.z, &t);
    *r = out;
}

static void g1_add_affine(g1jac *r, const g1jac *a, const fp *bx, const fp *by) {
    if (fp_is_zero(&a->z)) { r->x = *bx; r->y = *by; r->z = FP_ONE_; return; }
    fp z2, u2, z3, s2, h, hh, i, j, rr, v, t, t2;
    fp_sqr(&z2, &a->z);
    fp_mul(&u2, bx, &z2);
    fp_mul(&z3, &z2, &a->z);
    fp_mul(&s2, by, &z3);
    fp_sub(&h, &u2, &a->x);
    fp_sub(&t, &s2, &a->y);
    if (fp_is_zero(&h)) {
        if (fp_is_zero(&t)) { g1_dbl(r, a); return; }
        memset(r, 0, sizeof *r);
        return;
    }
    fp_sqr(&hh, &h);
    fp_dbl(&i, &hh); fp_dbl(&i, &i);
    fp_mul(&j, &h, &i);
    fp_dbl(&rr, &t);
    fp_mul(&v, &a->x, &i);
    g1jac out;
    fp_sqr(&t2, &rr);
    fp_sub(&t2, &t2, &j);
    fp_dbl(&t, &v);
    fp_sub(&out.x, &t2, &t);
    fp_sub(&t, &v, &out.x);
    fp_mul(&t, &rr, &t);
    fp_mul(&t2, &a->y, &j);
    fp_dbl(&t2, &t2);
    fp_sub(&out.y, &t, &t2);
    fp_add(&t, &a->z, &h);
    fp_sqr(&t, &t);
    fp_sub(&t, &t, &z2);
    fp_sub(&out.z, &t, &hh);
    *r = out;
}

static void g1_add(g1jac *r, const g1jac *a, const g1jac *b);

static void g1_scalar_mul(g1jac *r, const fp *px, const fp *py, const uint8_t *scalar_le) {
    g1jac acc;
    memset(&acc, 0, sizeof acc);
    int top = 255;
    while (top >= 0 && !((scalar_le[top >> 3] >> (top & 7)) & 1)) top--;
    for (int bit = top; bit >= 0; bit--) {
        g1jac t;
        g1_dbl(&t, &acc);
        acc = t;
        if ((scalar_le[bit >> 3] >> (bit & 7)) & 1) {
            g1_add_affine(&t, &acc, px, py);
            acc = t;
        }
    }
    *r = acc;
}

static void g1_add(g1jac *r, const g1jac *a, const g1jac *b) {
    if (fp_is_zero(&a->z)) { *r = *b; return; }
    if (fp_is_zero(&b->z)) { *r = *a; return; }
    fp z1z1, z2z2, u1, u2, s1, s2, t;
    fp_sqr(&z1z1, &a->z);
    fp_sqr(&z2z2, &b->z);
    fp_mul(&u1, &a->x, &z2z2);
    fp_mul(&u2, &b->x, &z1z1);
    fp_mul(&t, &b->z, &z2z2);
    fp_mul(&s1, &a->y, &t);
    fp_mul(&t, &a->z, &z1z1);
    fp_mul(&s2, &b->y, &t);
    fp h, rr;
    fp_sub(&h, &u2, &u1);
    fp_sub(&rr, &s2, &s1);
    if (fp_is_zero(&h)) {
        if (fp_is_zero(&rr)) { g1_dbl(r, a); return; }
        memset(r, 0, sizeof *r);
        return;
    }
    fp i, j, v, t2;
    fp_dbl(&t, &h);
    fp_sqr(&i, &t);
    fp_mul(&j, &h, &i);
    fp_dbl(&rr, &rr);
    fp_mul(&v, &u1, &i);
    g1jac out;
    fp_sqr(&t, &rr);
    fp_sub(&t, &t, &j);
    fp_dbl(&t2, &v);
    fp_sub(&out.x, &t, &t2);
    fp_sub(&t, &v, &out.x);
    fp_mul(&t, &rr, &t);
    fp_mul(&t2, &s1, &j);
    fp_dbl(&t2, &t2);
    fp_sub(&out.y, &t, &t2);
    fp_add(&t, &a->z, &b->z);
    fp_sqr(&t, &t);
    fp_sub(&t, &t, &z1z1);
    fp_sub(&t, &t, &z2z2);
    fp_mul(&out.z, &t, &h);
    *r = out;
}

/* G2 Jacobian over Fp2 */
typedef struct { fp2 x, y, z; } g2jac;

static void g2_dbl(g2jac *r, const g2jac *a) {
    if (fp2_is_zero(&a->z) || fp2_is_zero(&a->y)) { memset(r, 0, sizeof *r); return; }
    fp2 A, B, C, D, E, F, t, t2;
    fp2_sqr(&A, &a->x);
    fp2_sqr(&B, &a->y);
    fp2_sqr(&C, &B);
    fp2_add(&t, &a->x, &B);
    fp2_sqr(&t, &t);
    fp2_sub(&t, &t, &A);
    fp2_sub(&t, &t, &C);
    fp2_dbl(&D, &t);
    fp2_dbl(&E, &A);
    fp2_add(&E, &E, &A);
    fp2_sqr(&F, &E);
    g2jac out;
    fp2_dbl(&t, &D);
    fp2_sub(&out.x, &F, &t);
    fp2_sub(&t, &D, &out.x);
    fp2_mul(&t, &E, &t);
    fp2_dbl(&t2, &C); fp2_dbl(&t2, &t2); fp2_dbl(&t2, &t2);
    fp2_sub(&out.y, &t, &t2);
    fp2_mul(&t, &a->y, &a->z);
    fp2_dbl(&out.z, &t);
    *r = out;
}

static void g2_add_affine(g2jac *r, const g2jac *a, const fp2 *bx, const fp2 *by) {
    if (fp2_is_zero(&a->z)) {
        r->x = *bx; r->y = *by;
        memset(&r->z, 0, sizeof r->z);
        r->z.c0 = FP_ONE_;
        return;
    }
    fp2 z2, u2, z3, s2, h, hh, i, j, rr, v, t, t2;
    fp2_sqr(&z2, &a->z);
    fp2_mul(&u2, bx, &z2);
    fp2_mul(&z3, &z2, &a->z);
    fp2_mul(&s2, by, &z3);
    fp2_sub(&h, &u2, &a->x);
    fp2_sub(&t, &s2, &a->y);
    if (fp2_is_zero(&h)) {
        if (fp2_is_zero(&t)) { g2_dbl(r, a); return; }
        memset(r, 0, sizeof *r);
        return;
    }
    fp2_sqr(&hh, &h);
    fp2_dbl(&i, &hh); fp2_dbl(&i, &i);
    fp2_mul(&j, &h, &i);
    fp2_dbl(&rr, &t);
    fp2_mul(&v, &a->x, &i);
    g2jac out;
    fp2_sqr(&t2, &rr);
    fp2_sub(&t2, &t2, &j);
    fp2_dbl(&t, &v);
    fp2_sub(&out.x, &t2, &t);
    fp2_sub(&t, &v, &out.x);
    fp2_mul(&t, &rr, &t);
    fp2_mul(&t2, &a->y, &j);
    fp2_dbl(&t2, &t2);
    fp2_sub(&out.y, &t, &t2);
    fp2_add(&t, &a->z, &h);
    fp2_sqr(&t, &t);
    fp2_sub(&t, &t, &z2);
    fp2_sub(&out.z, &t, &hh);
    *r = out;
}

static void g2_scalar_mul(g2jac *r, const fp2 *px, const fp2 *py, const uint8_t *scalar_le) {
    g2jac acc;
    memset(&acc, 0, sizeof acc);
    int top = 255;
    while (top >= 0 && !((scalar_le[top >> 3] >> (top & 7)) & 1)) top--;
    for (int bit = top; bit >= 0; bit--) {
        g2jac t;
        g2_dbl(&t, &acc);
        acc = t;
        if ((scalar_le[bit >> 3] >> (bit & 7)) & 1) {
            g2_add_affine(&t, &acc, px, py);
            acc = t;
        }
    }
    *r = acc;
}

static void g2_add(g2jac *r, const g2jac *a, const g2jac *b) {
    if (fp2_is_zero(&a->z)) { *r = *b; return; }
    if (fp2_is_zero(&b->z)) { *r = *a; return; }
    fp2 z1z1, z2z2, u1, u2, s1, s2, t;
    fp2_sqr(&z1z1, &a->z);
    fp2_sqr(&z2z2, &b->z);
    fp2_mul(&u1, &a->x, &z2z2);
    fp2_mul(&u2, &b->x, &z1z1);
    fp2_mul(&t, &b->z, &z2z2);
    fp2_mul(&s1, &a->y, &t);
    fp2_mul(&t, &a->z, &z1z1);
    fp2_mul(&s2, &b->y, &t);
    fp2 h, rr;
    fp2_sub(&h, &u2, &u1);
    fp2_sub(&rr, &s2, &s1);
    if (fp2_is_zero(&h)) {
        if (fp2_is_zero(&rr)) { g2_dbl(r, a); return; }
        memset(r, 0, sizeof *r);
        return;
    }
    fp2 i, j, v, t2;
    fp2_dbl(&t, &h);
    fp2_sqr(&i, &t);
    fp2_mul(&j, &h, &i);
    fp2_dbl(&rr, &rr);
    fp2_mul(&v, &u1, &i);
    g2jac out;
    fp2_sqr(&t, &rr);
    fp2_sub(&t, &t, &j);
    fp2_dbl(&t2, &v);
    fp2_sub(&out.x, &t, &t2);
    fp2_sub(&t, &v, &out.x);
    fp2_mul(&t, &rr, &t);
    fp2_mul(&t2, &s1, &j);
    fp2_dbl(&t2, &t2);
    fp2_sub(&out.y, &t, &t2);
    fp2_add(&t, &a->z, &b->z);
    fp2_sqr(&t, &t);
    fp2_sub(&t, &t, &z1z1);
    fp2_sub(&t, &t, &z2z2);
    fp2_mul(&out.z, &t, &h);
    *r = out;
}

/* ---------------- byte I/O helpers ---------------- */

static void fp2_from_bytes(fp2 *r, const uint8_t *b) {
    fp_from_bytes(&r->c0, b);
    fp_from_bytes(&r->c1, b + 32);
}

static void fp2_to_bytes(const fp2 *a, uint8_t *b) {
    fp_to_bytes(&a->c0, b);
    fp_to_bytes(&a->c1, b + 32);
}

static void fp12_from_bytes(fp12 *r, const uint8_t *b) {
    fp_from_bytes(&r->c0.c0.c0, b);
    fp_from_bytes(&r->c0.c0.c1, b + 32);
    fp_from_bytes(&r->c0.c1.c0, b + 64);
    fp_from_bytes(&r->c0.c1.c1, b + 96);
    fp_from_bytes(&r->c0.c2.c0, b + 128);
    fp_from_bytes(&r->c0.c2.c1, b + 160);
    fp_from_bytes(&r->c1.c0.c0, b + 192);
    fp_from_bytes(&r->c1.c0.c1, b + 224);
    fp_from_bytes(&r->c1.c1.c0, b + 256);
    fp_from_bytes(&r->c1.c1.c1, b + 288);
    fp_from_bytes(&r->c1.c2.c0, b + 320);
    fp_from_bytes(&r->c1.c2.c1, b + 352);
}

static void fp12_to_bytes_(const fp12 *a, uint8_t *b) {
    fp_to_bytes(&a->c0.c0.c0, b);
    fp_to_bytes(&a->c0.c0.c1, b + 32);
    fp_to_bytes(&a->c0.c1.c0, b + 64);
    fp_to_bytes(&a->c0.c1.c1, b + 96);
    fp_to_bytes(&a->c0.c2.c0, b + 128);
    fp_to_bytes(&a->c0.c2.c1, b + 160);
    fp_to_bytes(&a->c1.c0.c0, b + 192);
    fp_to_bytes(&a->c1.c0.c1, b + 224);
    fp_to_bytes(&a->c1.c1.c0, b + 256);
    fp_to_bytes(&a->c1.c1.c1, b + 288);
    fp_to_bytes(&a->c1.c2.c0, b + 320);
    fp_to_bytes(&a->c1.c2.c1, b + 352);
}

/* ---------------- public API ---------------- */

/* consts blob (canonical LE bytes):
 *   p(32) r2(32) ninv(8) two_inv(32)
 *   g6_1(64) g6_2(64) gw(64) gamma12(64) gamma13(64) twist_b(64)
 */
void bn254_init(const uint8_t *blob) {
    const uint8_t *b = blob;
    for (int i = 0; i < 4; i++) {
        u64 v = 0;
        for (int j = 7; j >= 0; j--) v = (v << 8) | b[i * 8 + j];
        PMOD.l[i] = v;
    }
    b += 32;
    for (int i = 0; i < 4; i++) {
        u64 v = 0;
        for (int j = 7; j >= 0; j--) v = (v << 8) | b[i * 8 + j];
        R2.l[i] = v;   /* R2 is ALREADY the Montgomery representation of R */
    }
    b += 32;
    NINV = 0;
    for (int j = 7; j >= 0; j--) NINV = (NINV << 8) | b[j];
    b += 8;
    memset(&FP_ZERO_, 0, sizeof FP_ZERO_);
    fp one = {{1, 0, 0, 0}};
    fp_mul(&FP_ONE_, &one, &R2);
    fp_from_bytes(&TWO_INV_, b); b += 32;
    fp2_from_bytes(&G6_1_, b); b += 64;
    fp2_from_bytes(&G6_2_, b); b += 64;
    fp2_from_bytes(&GW_, b); b += 64;
    fp2_from_bytes(&GAMMA12_, b); b += 64;
    fp2_from_bytes(&GAMMA13_, b); b += 64;
    fp2_from_bytes(&TWIST_B_, b);
}

/* g1s: n*64 bytes (x,y canonical LE), g2s: n*128, mask: n bytes (0=skip).
 * out: 384 bytes — the multi-pairing WITH final exponentiation. */
void bn254_multi_pairing(const uint8_t *g1s, const uint8_t *g2s,
                         const uint8_t *mask, int n, uint8_t *out) {
    int nchunks = 1;
#ifdef _OPENMP
    nchunks = omp_get_max_threads();
    if (nchunks > n) nchunks = n;
    if (nchunks < 1) nchunks = 1;
#endif
    fp12 *partial = malloc((size_t)(nchunks > 0 ? nchunks : 1) * sizeof(fp12));
#ifdef _OPENMP
#pragma omp parallel for num_threads(nchunks) schedule(static)
#endif
    for (int c = 0; c < nchunks; c++) {
        int lo = (int)((long)n * c / nchunks);
        int hi = (int)((long)n * (c + 1) / nchunks);
        fp12 f;
        fp12_one(&f);
        for (int i = lo; i < hi; i++) {
            if (mask && !mask[i]) continue;
            g1aff p;
            fp_from_bytes(&p.x, g1s + (long)i * 64);
            fp_from_bytes(&p.y, g1s + (long)i * 64 + 32);
            p.inf = 0;
            g2aff q;
            fp2_from_bytes(&q.x, g2s + (long)i * 128);
            fp2_from_bytes(&q.y, g2s + (long)i * 128 + 64);
            q.inf = 0;
            miller_accum(&f, &p, &q);
        }
        partial[c] = f;
    }
    fp12 f;
    fp12_one(&f);
    for (int c = 0; c < nchunks; c++) {
        fp12 t;
        fp12_mul(&t, &f, &partial[c]);
        f = t;
    }
    free(partial);
    fp12 r;
    final_exp(&r, &f);
    fp12_to_bytes_(&r, out);
}

/* ---- batch group folds: out[i] = s·x[i] + y[i] (shared scalar) ----
 * The Dory reduce-and-fold rounds apply one challenge scalar across a whole
 * vector of points; batching gives a single call per round, OpenMP across
 * elements, and ONE Montgomery batch inversion for the affine outputs.
 * Point buffers: n*64 (G1) / n*128 (G2) canonical affine, all-zero = inf.
 * out: n*65 / n*129 flagged affine. */

void bn254_g1_fold(const uint8_t *xs, const uint8_t *ys, const uint8_t *scalar,
                   long n, uint8_t *out) {
    g1jac *acc = malloc((size_t)n * sizeof(g1jac));
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (long i = 0; i < n; i++) {
        const uint8_t *xb = xs + i * 64;
        const uint8_t *yb = ys + i * 64;
        int xz = 1, yz = 1;
        for (int k = 0; k < 64; k++) if (xb[k]) { xz = 0; break; }
        for (int k = 0; k < 64; k++) if (yb[k]) { yz = 0; break; }
        g1jac t;
        memset(&t, 0, sizeof t);
        if (!xz) {
            fp px, py;
            fp_from_bytes(&px, xb);
            fp_from_bytes(&py, xb + 32);
            g1_scalar_mul(&t, &px, &py, scalar);
        }
        if (!yz) {
            fp yx, yy;
            fp_from_bytes(&yx, yb);
            fp_from_bytes(&yy, yb + 32);
            g1jac t2;
            g1_add_affine(&t2, &t, &yx, &yy);
            t = t2;
        }
        acc[i] = t;
    }
    /* batch affine normalization: one inversion for all nonzero z */
    fp *zs = malloc((size_t)n * sizeof(fp));
    fp *pref = malloc((size_t)(n + 1) * sizeof(fp));
    pref[0] = FP_ONE_;
    for (long i = 0; i < n; i++) {
        zs[i] = fp_is_zero(&acc[i].z) ? FP_ONE_ : acc[i].z;
        fp_mul(&pref[i + 1], &pref[i], &zs[i]);
    }
    fp inv_all;
    fp_inv(&inv_all, &pref[n]);
    for (long i = n - 1; i >= 0; i--) {
        fp zinv, t;
        fp_mul(&zinv, &inv_all, &pref[i]);     /* 1/z_i */
        fp_mul(&t, &inv_all, &zs[i]);
        inv_all = t;
        uint8_t *o = out + i * 65;
        if (fp_is_zero(&acc[i].z)) { memset(o, 0, 65); continue; }
        fp zi2, zi3, ax, ay;
        fp_sqr(&zi2, &zinv);
        fp_mul(&zi3, &zi2, &zinv);
        fp_mul(&ax, &acc[i].x, &zi2);
        fp_mul(&ay, &acc[i].y, &zi3);
        o[0] = 1;
        fp_to_bytes(&ax, o + 1);
        fp_to_bytes(&ay, o + 33);
    }
    free(acc); free(zs); free(pref);
}

void bn254_g2_fold(const uint8_t *xs, const uint8_t *ys, const uint8_t *scalar,
                   long n, uint8_t *out) {
    g2jac *acc = malloc((size_t)n * sizeof(g2jac));
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (long i = 0; i < n; i++) {
        const uint8_t *xb = xs + i * 128;
        const uint8_t *yb = ys + i * 128;
        int xz = 1, yz = 1;
        for (int k = 0; k < 128; k++) if (xb[k]) { xz = 0; break; }
        for (int k = 0; k < 128; k++) if (yb[k]) { yz = 0; break; }
        g2jac t;
        memset(&t, 0, sizeof t);
        if (!xz) {
            fp2 px, py;
            fp2_from_bytes(&px, xb);
            fp2_from_bytes(&py, xb + 64);
            g2_scalar_mul(&t, &px, &py, scalar);
        }
        if (!yz) {
            fp2 yx, yy;
            fp2_from_bytes(&yx, yb);
            fp2_from_bytes(&yy, yb + 64);
            g2jac t2;
            g2_add_affine(&t2, &t, &yx, &yy);
            t = t2;
        }
        acc[i] = t;
    }
    fp2 *zs = malloc((size_t)n * sizeof(fp2));
    fp2 *pref = malloc((size_t)(n + 1) * sizeof(fp2));
    memset(&pref[0], 0, sizeof(fp2));
    pref[0].c0 = FP_ONE_;
    for (long i = 0; i < n; i++) {
        if (fp2_is_zero(&acc[i].z)) {
            memset(&zs[i], 0, sizeof(fp2));
            zs[i].c0 = FP_ONE_;
        } else {
            zs[i] = acc[i].z;
        }
        fp2_mul(&pref[i + 1], &pref[i], &zs[i]);
    }
    fp2 inv_all;
    fp2_inv(&inv_all, &pref[n]);
    for (long i = n - 1; i >= 0; i--) {
        fp2 zinv, t;
        fp2_mul(&zinv, &inv_all, &pref[i]);
        fp2_mul(&t, &inv_all, &zs[i]);
        inv_all = t;
        uint8_t *o = out + i * 129;
        if (fp2_is_zero(&acc[i].z)) { memset(o, 0, 129); continue; }
        fp2 zi2, zi3, ax, ay;
        fp2_sqr(&zi2, &zinv);
        fp2_mul(&zi3, &zi2, &zinv);
        fp2_mul(&ax, &acc[i].x, &zi2);
        fp2_mul(&ay, &acc[i].y, &zi3);
        o[0] = 1;
        fp2_to_bytes(&ax, o + 1);
        fp2_to_bytes(&ay, o + 65);
    }
    free(acc); free(zs); free(pref);
}

/* out = f^e where e is 32 bytes LE. 384-byte GT in/out. */
void bn254_fp12_pow(const uint8_t *f_in, const uint8_t *e_le, uint8_t *out) {
    fp12 base, acc, t;
    fp12_from_bytes(&base, f_in);
    fp12_one(&acc);
    int top = 255;
    while (top >= 0 && !((e_le[top >> 3] >> (top & 7)) & 1)) top--;
    for (int bit = 0; bit <= top; bit++) {
        if ((e_le[bit >> 3] >> (bit & 7)) & 1) {
            fp12_mul(&t, &acc, &base);
            acc = t;
        }
        if (bit < top) { fp12_sqr(&t, &base); base = t; }
    }
    fp12_to_bytes_(&acc, out);
}

/* MSM: points n*64 (x,y canonical; x==y==0 means infinity -> skip),
 * scalars n*32 LE. out 65 bytes: flag(1: 0=inf) + x + y. */
/* -------- Pippenger bucket method (G1 and G2) -------- */

static int pip_window_size(int n) {
    if (n < 32) return 0;            /* naive double-and-add */
    if (n < 128) return 5;
    if (n < 512) return 7;
    if (n < 2048) return 8;
    if (n < 8192) return 10;
    if (n < 32768) return 11;
    return 12;
}

/* highest set bit position (+1) across m 32-byte LE scalars; 0 if all zero.
 * One-hot indicators and u64 machine words dominate the committed-poly
 * workload, so capping the Pippenger window walk at the real top bit skips
 * the ~3/4 of window iterations whose buckets would all be empty.
 *
 * NOT constant-time: MSM wall time is proportional to the max scalar
 * bit-length (and zero scalars are skipped entirely), so timing leaks the
 * magnitude of committed values. All data committed here is derived from a
 * public execution trace, so this is fine for the zkVM workload; a
 * privacy-sensitive deployment committing secret witnesses would need to
 * disable this cap and the zero-skip. */
static int scalars_top_bits(const uint8_t *sc, int m) {
    int top_byte = -1;
    for (int i = 0; i < m; i++) {
        const uint8_t *s = sc + (long)i * 32;
        for (int k = 31; k > top_byte; k--)
            if (s[k]) { top_byte = k; break; }
    }
    if (top_byte < 0) return 0;
    uint8_t hi = 0;
    for (int i = 0; i < m; i++) {
        uint8_t v = sc[(long)i * 32 + top_byte];
        if (v > hi) hi = v;
    }
    int b = 0;
    while (hi) { hi >>= 1; b++; }
    int bits = top_byte * 8 + b;
    return bits > 254 ? 254 : bits;
}

/* bits [pos, pos+c) of a 256-bit little-endian scalar, c <= 12 */
static inline int scalar_digit(const uint8_t *s, int pos, int c) {
    int byte = pos >> 3, sh = pos & 7;
    unsigned int v = s[byte];
    if (byte + 1 < 32) v |= (unsigned int)s[byte + 1] << 8;
    if (byte + 2 < 32) v |= (unsigned int)s[byte + 2] << 16;
    return (int)((v >> sh) & ((1u << c) - 1));
}

/* core MSM over pre-parsed affine points (Montgomery coords); m entries */
static void g1_msm_core(g1jac *acc, const fp *px, const fp *py,
                        const uint8_t *sc, int m) {
    memset(acc, 0, sizeof *acc);
    int c = pip_window_size(m);
    if (c == 0) {
        for (int i = 0; i < m; i++) {
            g1jac term, t;
            g1_scalar_mul(&term, &px[i], &py[i], sc + (long)i * 32);
            g1_add(&t, acc, &term);
            *acc = t;
        }
        return;
    }
    int top_bits = scalars_top_bits(sc, m);
    if (top_bits == 0) return;
    int nbuckets = (1 << c) - 1;
    g1jac *buckets = malloc((size_t)nbuckets * sizeof(g1jac));
    int nwin = (top_bits + c - 1) / c;
    for (int w = nwin - 1; w >= 0; w--) {
        if (w != nwin - 1)
            for (int k = 0; k < c; k++) g1_dbl(acc, acc);
        memset(buckets, 0, (size_t)nbuckets * sizeof(g1jac));
        for (int i = 0; i < m; i++) {
            int d = scalar_digit(sc + (long)i * 32, w * c, c);
            if (d) g1_add_affine(&buckets[d - 1], &buckets[d - 1], &px[i], &py[i]);
        }
        g1jac run, sum, t;
        memset(&run, 0, sizeof run);
        memset(&sum, 0, sizeof sum);
        for (int b = nbuckets - 1; b >= 0; b--) {
            g1_add(&t, &run, &buckets[b]);
            run = t;
            g1_add(&t, &sum, &run);
            sum = t;
        }
        g1jac t2;
        g1_add(&t2, acc, &sum);
        *acc = t2;
    }
    free(buckets);
}

static void g2_msm_core(g2jac *acc, const fp2 *px, const fp2 *py,
                        const uint8_t *sc, int m) {
    memset(acc, 0, sizeof *acc);
    int c = pip_window_size(m);
    if (c == 0) {
        for (int i = 0; i < m; i++) {
            g2jac term, t;
            g2_scalar_mul(&term, &px[i], &py[i], sc + (long)i * 32);
            g2_add(&t, acc, &term);
            *acc = t;
        }
        return;
    }
    int top_bits = scalars_top_bits(sc, m);
    if (top_bits == 0) return;
    int nbuckets = (1 << c) - 1;
    g2jac *buckets = malloc((size_t)nbuckets * sizeof(g2jac));
    int nwin = (top_bits + c - 1) / c;
    for (int w = nwin - 1; w >= 0; w--) {
        if (w != nwin - 1)
            for (int k = 0; k < c; k++) g2_dbl(acc, acc);
        memset(buckets, 0, (size_t)nbuckets * sizeof(g2jac));
        for (int i = 0; i < m; i++) {
            int d = scalar_digit(sc + (long)i * 32, w * c, c);
            if (d) g2_add_affine(&buckets[d - 1], &buckets[d - 1], &px[i], &py[i]);
        }
        g2jac run, sum, t;
        memset(&run, 0, sizeof run);
        memset(&sum, 0, sizeof sum);
        for (int b = nbuckets - 1; b >= 0; b--) {
            g2_add(&t, &run, &buckets[b]);
            run = t;
            g2_add(&t, &sum, &run);
            sum = t;
        }
        g2jac t2;
        g2_add(&t2, acc, &sum);
        *acc = t2;
    }
    free(buckets);
}

static void g1_jac_out(const g1jac *acc, uint8_t *out) {
    if (fp_is_zero(&acc->z)) { memset(out, 0, 65); return; }
    fp zinv, zinv2, zinv3, ax, ay;
    fp_inv(&zinv, &acc->z);
    fp_sqr(&zinv2, &zinv);
    fp_mul(&zinv3, &zinv2, &zinv);
    fp_mul(&ax, &acc->x, &zinv2);
    fp_mul(&ay, &acc->y, &zinv3);
    out[0] = 1;
    fp_to_bytes(&ax, out + 1);
    fp_to_bytes(&ay, out + 33);
}

static void g2_jac_out(const g2jac *acc, uint8_t *out) {
    if (fp2_is_zero(&acc->z)) { memset(out, 0, 129); return; }
    fp2 zinv, zinv2, zinv3, ax, ay;
    fp2_inv(&zinv, &acc->z);
    fp2_sqr(&zinv2, &zinv);
    fp2_mul(&zinv3, &zinv2, &zinv);
    fp2_mul(&ax, &acc->x, &zinv2);
    fp2_mul(&ay, &acc->y, &zinv3);
    out[0] = 1;
    fp2_to_bytes(&ax, out + 1);
    fp2_to_bytes(&ay, out + 65);
}

void bn254_g1_msm(const uint8_t *pts, const uint8_t *scalars, int n, uint8_t *out) {
    fp *px = malloc((size_t)n * sizeof(fp));
    fp *py = malloc((size_t)n * sizeof(fp));
    uint8_t *sc = malloc((size_t)n * 32);
    int m = 0;
    for (int i = 0; i < n; i++) {
        const uint8_t *pb = pts + (long)i * 64;
        int allz = 1;
        for (int k = 0; k < 64; k++) if (pb[k]) { allz = 0; break; }
        if (allz) continue;
        int sz = 1;
        for (int k = 0; k < 32; k++) if (scalars[i * 32 + k]) { sz = 0; break; }
        if (sz) continue;
        fp_from_bytes(&px[m], pb);
        fp_from_bytes(&py[m], pb + 32);
        memcpy(sc + (long)m * 32, scalars + (long)i * 32, 32);
        m++;
    }
    g1jac acc;
    g1_msm_core(&acc, px, py, sc, m);
    free(px); free(py); free(sc);
    g1_jac_out(&acc, out);
}

/* G2 MSM: points n*128 (x,y fp2 canonical), scalars n*32 LE.
 * out 129 bytes: flag + x(64) + y(64). */
void bn254_g2_msm(const uint8_t *pts, const uint8_t *scalars, int n, uint8_t *out) {
    fp2 *px = malloc((size_t)n * sizeof(fp2));
    fp2 *py = malloc((size_t)n * sizeof(fp2));
    uint8_t *sc = malloc((size_t)n * 32);
    int m = 0;
    for (int i = 0; i < n; i++) {
        const uint8_t *pb = pts + (long)i * 128;
        int allz = 1;
        for (int k = 0; k < 128; k++) if (pb[k]) { allz = 0; break; }
        if (allz) continue;
        int sz = 1;
        for (int k = 0; k < 32; k++) if (scalars[i * 32 + k]) { sz = 0; break; }
        if (sz) continue;
        fp2_from_bytes(&px[m], pb);
        fp2_from_bytes(&py[m], pb + 64);
        memcpy(sc + (long)m * 32, scalars + (long)i * 32, 32);
        m++;
    }
    g2jac acc;
    g2_msm_core(&acc, px, py, sc, m);
    free(px); free(py); free(sc);
    g2_jac_out(&acc, out);
}

/* Fixed-base batch scalar multiplication over G2: out[i] = scalars[i]·B.
 * 4-bit windowed table (64 windows x 15 multiples) shared across the batch;
 * point: 128 bytes affine, scalars: n*32 LE, out: n*129 (flag + affine). */
void bn254_g2_batch_mul(const uint8_t *point, const uint8_t *scalars, int n,
                        uint8_t *out) {
    fp2 bx, by;
    fp2_from_bytes(&bx, point);
    fp2_from_bytes(&by, point + 64);
    g2jac *table = malloc((size_t)64 * 15 * sizeof(g2jac));
    g2jac base;   /* 2^{4w}·B as jacobian */
    memset(&base, 0, sizeof base);
    g2_add_affine(&base, &base, &bx, &by);
    for (int w = 0; w < 64; w++) {
        g2jac *row = table + w * 15;
        row[0] = base;
        for (int d = 1; d < 15; d++) g2_add(&row[d], &row[d - 1], &base);
        if (w < 63) {
            g2_add(&base, &row[14], &base);   /* 16·B_w */
        }
    }
    for (int i = 0; i < n; i++) {
        const uint8_t *s = scalars + (long)i * 32;
        g2jac acc, t;
        memset(&acc, 0, sizeof acc);
        for (int w = 0; w < 64; w++) {
            int d = (s[w >> 1] >> ((w & 1) * 4)) & 0xF;
            if (d) {
                g2_add(&t, &acc, &table[w * 15 + (d - 1)]);
                acc = t;
            }
        }
        g2_jac_out(&acc, out + (long)i * 129);
    }
    free(table);
}

/* Shared-base row MSMs with u64 scalars (the common committed-poly case:
 * one-hot chunk indicators and machine-word values). scalars: rows*n*8 LE. */
void bn254_g1_msm_rows_u64(const uint8_t *pts, const uint8_t *scalars, int n,
                           int rows, uint8_t *out) {
    fp *px = malloc((size_t)n * sizeof(fp));
    fp *py = malloc((size_t)n * sizeof(fp));
    uint8_t *inf = malloc((size_t)n);
    for (int i = 0; i < n; i++) {
        const uint8_t *pb = pts + (long)i * 64;
        int allz = 1;
        for (int k = 0; k < 64; k++) if (pb[k]) { allz = 0; break; }
        inf[i] = (uint8_t)allz;
        if (!allz) {
            fp_from_bytes(&px[i], pb);
            fp_from_bytes(&py[i], pb + 32);
        }
    }
#ifdef _OPENMP
#pragma omp parallel
    {
#endif
        fp *cpx = malloc((size_t)n * sizeof(fp));
        fp *cpy = malloc((size_t)n * sizeof(fp));
        uint8_t *csc = malloc((size_t)n * 32);
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
        for (int r = 0; r < rows; r++) {
            const uint8_t *sc = scalars + (long)r * n * 8;
            int m = 0;
            for (int i = 0; i < n; i++) {
                if (inf[i]) continue;
                int sz = 1;
                for (int k = 0; k < 8; k++) if (sc[i * 8 + k]) { sz = 0; break; }
                if (sz) continue;
                cpx[m] = px[i];
                cpy[m] = py[i];
                memcpy(csc + (long)m * 32, sc + (long)i * 8, 8);
                memset(csc + (long)m * 32 + 8, 0, 24);
                m++;
            }
            g1jac acc;
            g1_msm_core(&acc, cpx, cpy, csc, m);
            g1_jac_out(&acc, out + (long)r * 65);
        }
        free(cpx); free(cpy); free(csc);
#ifdef _OPENMP
    }
#endif
    free(px); free(py); free(inf);
}

/* Shared-base row MSMs (Dory row commitments): bases parsed once, `rows`
 * scalar rows of length n each; out: rows*65. */
void bn254_g1_msm_rows(const uint8_t *pts, const uint8_t *scalars, int n,
                       int rows, uint8_t *out) {
    fp *px = malloc((size_t)n * sizeof(fp));
    fp *py = malloc((size_t)n * sizeof(fp));
    uint8_t *inf = malloc((size_t)n);
    for (int i = 0; i < n; i++) {
        const uint8_t *pb = pts + (long)i * 64;
        int allz = 1;
        for (int k = 0; k < 64; k++) if (pb[k]) { allz = 0; break; }
        inf[i] = (uint8_t)allz;
        if (!allz) {
            fp_from_bytes(&px[i], pb);
            fp_from_bytes(&py[i], pb + 32);
        }
    }
#ifdef _OPENMP
#pragma omp parallel
    {
        fp *cpx = malloc((size_t)n * sizeof(fp));
        fp *cpy = malloc((size_t)n * sizeof(fp));
        uint8_t *csc = malloc((size_t)n * 32);
#pragma omp for schedule(dynamic)
        for (int r = 0; r < rows; r++) {
            const uint8_t *sc = scalars + (long)r * n * 32;
            int m = 0;
            for (int i = 0; i < n; i++) {
                if (inf[i]) continue;
                int sz = 1;
                for (int k = 0; k < 32; k++) if (sc[i * 32 + k]) { sz = 0; break; }
                if (sz) continue;
                cpx[m] = px[i];
                cpy[m] = py[i];
                memcpy(csc + (long)m * 32, sc + (long)i * 32, 32);
                m++;
            }
            g1jac acc;
            g1_msm_core(&acc, cpx, cpy, csc, m);
            g1_jac_out(&acc, out + (long)r * 65);
        }
        free(cpx); free(cpy); free(csc);
    }
#else
    fp *cpx = malloc((size_t)n * sizeof(fp));
    fp *cpy = malloc((size_t)n * sizeof(fp));
    uint8_t *csc = malloc((size_t)n * 32);
    for (int r = 0; r < rows; r++) {
        const uint8_t *sc = scalars + (long)r * n * 32;
        int m = 0;
        for (int i = 0; i < n; i++) {
            if (inf[i]) continue;
            int sz = 1;
            for (int k = 0; k < 32; k++) if (sc[i * 32 + k]) { sz = 0; break; }
            if (sz) continue;
            cpx[m] = px[i];
            cpy[m] = py[i];
            memcpy(csc + (long)m * 32, sc + (long)i * 32, 32);
            m++;
        }
        g1jac acc;
        g1_msm_core(&acc, cpx, cpy, csc, m);
        g1_jac_out(&acc, out + (long)r * 65);
    }
    free(cpx); free(cpy); free(csc);
#endif
    free(px); free(py); free(inf);
}

/* ---- Device row-MSM support: 8-point subset-sum tables -----------------
 *
 * The TPU row-commitment tier (msm/rows_device.py, matching the reference's
 * Dory commit hot loop, src/poly/commitment/dory.zig:989-1042) decomposes
 * small-scalar row MSMs into bit-plane subset sums over the FIXED G1 basis:
 * one precomputed table of all 256 subset sums per group of 8 consecutive
 * basis points turns 8 columns into a single gather + tree-add on device.
 * This builder runs once per SRS: Gray-code construction (one mixed add per
 * entry) + one global Montgomery batch inversion.
 *
 * pts: n*64 canonical affine bytes (x||y LE, all-zero = infinity), n%8==0.
 * out: (n/8)*256 entries * 64 bytes — x||y in MONTGOMERY residue bytes
 *      (u64[4] LE, the same R=2^256 form the device limb arrays hold).
 * valid: (n/8)*256 bytes, 0 where the subset sum is the identity. */
void bn254_g1_subset_tables_mont(const uint8_t *pts, int n,
                                 uint8_t *out, uint8_t *valid) {
    int ng = n / 8;
    long ntab = (long)ng * 256;
    g1jac *tab = malloc((size_t)ntab * sizeof(g1jac));
    fp *px = malloc((size_t)n * sizeof(fp));
    fp *py = malloc((size_t)n * sizeof(fp));
    uint8_t *pinf = malloc((size_t)n);
    for (int i = 0; i < n; i++) {
        const uint8_t *pb = pts + (long)i * 64;
        int allz = 1;
        for (int k = 0; k < 64; k++) if (pb[k]) { allz = 0; break; }
        pinf[i] = (uint8_t)allz;
        if (!allz) {
            fp_from_bytes(&px[i], pb);
            fp_from_bytes(&py[i], pb + 32);
        }
    }
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int g = 0; g < ng; g++) {
        g1jac *base = tab + (long)g * 256;
        memset(&base[0], 0, sizeof base[0]);
        for (int m = 1; m < 256; m++) {
            int low = m & -m;
            int i = __builtin_ctz((unsigned)m);
            if (pinf[g * 8 + i]) { base[m] = base[m ^ low]; continue; }
            g1_add_affine(&base[m], &base[m ^ low],
                          &px[g * 8 + i], &py[g * 8 + i]);
        }
    }
    /* one global batch affine normalization */
    fp *zs = malloc((size_t)ntab * sizeof(fp));
    fp *pref = malloc((size_t)(ntab + 1) * sizeof(fp));
    pref[0] = FP_ONE_;
    for (long i = 0; i < ntab; i++) {
        zs[i] = fp_is_zero(&tab[i].z) ? FP_ONE_ : tab[i].z;
        fp_mul(&pref[i + 1], &pref[i], &zs[i]);
    }
    fp inv_all;
    fp_inv(&inv_all, &pref[ntab]);
    for (long i = ntab - 1; i >= 0; i--) {
        fp zinv, t;
        fp_mul(&zinv, &inv_all, &pref[i]);
        fp_mul(&t, &inv_all, &zs[i]);
        inv_all = t;
        uint8_t *o = out + i * 64;
        if (fp_is_zero(&tab[i].z)) {
            memset(o, 0, 64);
            valid[i] = 0;
            continue;
        }
        fp zi2, zi3, ax, ay;
        fp_sqr(&zi2, &zinv);
        fp_mul(&zi3, &zi2, &zinv);
        fp_mul(&ax, &tab[i].x, &zi2);
        fp_mul(&ay, &tab[i].y, &zi3);
        memcpy(o, ax.l, 32);        /* Montgomery residue bytes, u64 LE */
        memcpy(o + 32, ay.l, 32);
        valid[i] = 1;
    }
    free(tab); free(px); free(py); free(pinf); free(zs); free(pref);
}
