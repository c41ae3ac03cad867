/* BN254 Fr vector runtime: batch Montgomery kernels for the host prover tier.
 *
 * The sumcheck provers' host hot loops are all shapes over Fr arrays:
 * eq-table construction (doubling algorithm, reference src/poly/mod.zig:252-290),
 * challenge folds new[i] = lo + r*(hi-lo) (bindLow/bindFirst,
 * src/poly/mod.zig:128-175), and per-round evaluation sums
 * Σ Π_k (lo_k + t*(hi_k-lo_k)) for t in 0..degree. This file implements them
 * over 4x u64-limb Montgomery elements so the host tier runs at native speed;
 * the Python big-int implementations remain the differential oracle
 * (tests/test_native.py), and the JAX limb kernels remain the device tier.
 *
 * ABI: element buffers are n*32 bytes of 4x u64 little-endian limbs in
 * MONTGOMERY form (convert at the boundary with frv_to_mont/frv_from_mont;
 * canonical values are plain LE 256-bit integers).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#ifdef _OPENMP
#include <omp.h>
#endif

typedef uint64_t u64;
typedef unsigned __int128 u128;

typedef struct { u64 l[4]; } fr;

static fr FRMOD, FR_R2;
static u64 FR_NINV;
static fr FR_ONE_M; /* to_mont(1) */

static inline int fr_geq_p(const fr *a) {
    for (int i = 3; i >= 0; i--) {
        if (a->l[i] > FRMOD.l[i]) return 1;
        if (a->l[i] < FRMOD.l[i]) return 0;
    }
    return 1;
}

static inline void fr_sub_p(fr *a) {
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a->l[i] - FRMOD.l[i] - (u64)borrow;
        a->l[i] = (u64)d;
        borrow = (d >> 64) & 1;
    }
}

static inline void fr_add(fr *r, const fr *a, const fr *b) {
    u128 carry = 0;
    for (int i = 0; i < 4; i++) {
        u128 s = (u128)a->l[i] + b->l[i] + (u64)carry;
        r->l[i] = (u64)s;
        carry = s >> 64;
    }
    if (carry || fr_geq_p(r)) fr_sub_p(r);
}

static inline void fr_sub(fr *r, const fr *a, const fr *b) {
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a->l[i] - b->l[i] - (u64)borrow;
        r->l[i] = (u64)d;
        borrow = (d >> 64) & 1;
    }
    if (borrow) {
        u128 carry = 0;
        for (int i = 0; i < 4; i++) {
            u128 s = (u128)r->l[i] + FRMOD.l[i] + (u64)carry;
            r->l[i] = (u64)s;
            carry = s >> 64;
        }
    }
}

/* CIOS Montgomery multiplication (same schedule as bn254.c fp_mul) */
static void fr_mul(fr *r, const fr *a, const fr *b) {
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

        u64 m = t[0] * FR_NINV;
        carry = 0;
        u128 s2 = (u128)t[0] + (u128)m * FRMOD.l[0];
        carry = s2 >> 64;
        for (int j = 1; j < 4; j++) {
            u128 s3 = (u128)t[j] + (u128)m * FRMOD.l[j] + (u64)carry;
            t[j - 1] = (u64)s3;
            carry = s3 >> 64;
        }
        u128 s4 = (u128)t[4] + (u64)carry;
        t[3] = (u64)s4;
        t[4] = t[5] + (u64)(s4 >> 64);
        t[5] = 0;
    }
    r->l[0] = t[0]; r->l[1] = t[1]; r->l[2] = t[2]; r->l[3] = t[3];
    if (t[4] || fr_geq_p(r)) fr_sub_p(r);
}

static inline void fr_load(fr *r, const uint8_t *b) { memcpy(r->l, b, 32); }
static inline void fr_store(const fr *a, uint8_t *b) { memcpy(b, a->l, 32); }

/* ------------------------------------------------------------------ */
/* init + boundary conversion                                          */
/* ------------------------------------------------------------------ */

void frv_init(const uint8_t *blob) {
    /* blob: fr modulus (32 LE) + R2 mod p (32 LE, canonical) + ninv (8 LE) */
    fr_load(&FRMOD, blob);
    fr r2_can;
    fr_load(&r2_can, blob + 32);
    FR_R2 = r2_can; /* R2 in canonical limbs IS the Montgomery rep of R */
    FR_NINV = 0;
    for (int j = 7; j >= 0; j--) FR_NINV = (FR_NINV << 8) | blob[64 + j];
    fr one = {{1, 0, 0, 0}};
    fr_mul(&FR_ONE_M, &one, &FR_R2);
}

/* u64 little-endian values -> Montgomery elements (fast ingest path) */
void frv_from_u64(const uint8_t *in, long n, uint8_t *out) {
#pragma omp parallel for schedule(static) if (n > 4096)
    for (long i = 0; i < n; i++) {
        fr a = {{0, 0, 0, 0}}, m;
        u64 v = 0;
        for (int j = 7; j >= 0; j--) v = (v << 8) | in[i * 8 + j];
        a.l[0] = v;
        fr_mul(&m, &a, &FR_R2);
        fr_store(&m, out + i * 32);
    }
}

/* field elements from signed 128-bit values hi*2^64 + lo (hi in a small
 * range; negatives wrap mod p). The columnar witness builder's ingest for
 * immediate/operand columns that are not u64-safe. */
void frv_from_i128(const uint64_t *lo, const int64_t *hi, long n, uint8_t *out) {
#pragma omp parallel for schedule(static) if (n > 4096)
    for (long i = 0; i < n; i++) {
        __int128 s = ((__int128)hi[i] << 64) + (__int128)lo[i];
        fr a = {{0, 0, 0, 0}}, m;
        if (s < 0) {
            unsigned __int128 t = (unsigned __int128)(-s);
            a.l[0] = (u64)t; a.l[1] = (u64)(t >> 64);
            fr m0, z = {{0, 0, 0, 0}};
            fr_mul(&m0, &a, &FR_R2);
            fr_sub(&m, &z, &m0);
        } else {
            unsigned __int128 t = (unsigned __int128)s;
            a.l[0] = (u64)t; a.l[1] = (u64)(t >> 64);
            fr_mul(&m, &a, &FR_R2);
        }
        fr_store(&m, out + i * 32);
    }
}

void frv_to_mont(const uint8_t *in, long n, uint8_t *out) {
#pragma omp parallel for schedule(static) if (n > 4096)
    for (long i = 0; i < n; i++) {
        fr a, m;
        fr_load(&a, in + i * 32);
        fr_mul(&m, &a, &FR_R2);
        fr_store(&m, out + i * 32);
    }
}

void frv_from_mont(const uint8_t *in, long n, uint8_t *out) {
    fr one = {{1, 0, 0, 0}};
#pragma omp parallel for schedule(static) if (n > 4096)
    for (long i = 0; i < n; i++) {
        fr a, c;
        fr_load(&a, in + i * 32);
        fr_mul(&c, &a, &one);
        fr_store(&c, out + i * 32);
    }
}

/* ------------------------------------------------------------------ */
/* eq tables                                                            */
/* ------------------------------------------------------------------ */

/* eq(point, j) for all j, big-endian (point[0] <-> MSB of j); doubling
 * algorithm. point: n_vars Montgomery elements; out: 2^n_vars elements. */
void frv_eq_table_be(const uint8_t *point, int n_vars, uint8_t *out) {
    fr *t = (fr *)out;
    t[0] = FR_ONE_M;
    long size = 1;
    for (int v = n_vars - 1; v >= 0; v--) {
        fr pv;
        fr_load(&pv, point + (long)v * 32);
        for (long i = size - 1; i >= 0; i--) {
            fr hi, lo;
            fr_mul(&hi, &t[i], &pv);
            fr_sub(&lo, &t[i], &hi);
            t[i + size] = hi; /* safe: walking i downward, writes stay above reads */
            t[i] = lo;
        }
        size <<= 1;
    }
}

/* ------------------------------------------------------------------ */
/* folds                                                                */
/* ------------------------------------------------------------------ */

/* out[i] = a[2i] + r*(a[2i+1] - a[2i]); out may alias a. n = input length. */
void frv_fold_adj(const uint8_t *in, long n, const uint8_t *r_mont, uint8_t *out) {
    fr r;
    fr_load(&r, r_mont);
    const fr *a = (const fr *)in;
    fr *o = (fr *)out;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n > 4096)
#endif
    for (long i = 0; i < n / 2; i++) {
        fr d, m;
        fr_sub(&d, &a[2 * i + 1], &a[2 * i]);
        fr_mul(&m, &d, &r);
        fr_add(&o[i], &a[2 * i], &m);
    }
}

/* Multi-row in-place adjacent fold: rows[k][i] = rows[k][2i] +
 * r*(rows[k][2i+1] - rows[k][2i]) for i < n/2, tail left stale.
 * Parallelized ACROSS rows — within one row a single thread's writes stay
 * behind its reads (o[i] from a[2i], a[2i+1]), so in-place is race-free and
 * there is NO allocation: the per-round multi-table binds (stage-4
 * registers: ~100 rows) avoid the mmap/munmap churn that made fresh-buffer
 * folds collapse at 2^20 x 97 rows (13x slowdown measured). */
void frv_fold_adj_rows(uint8_t *const *rows, int k, long n, const uint8_t *r_mont) {
    fr r;
    fr_load(&r, r_mont);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
    for (int t = 0; t < k; t++) {
        fr *a = (fr *)rows[t];
        for (long i = 0; i < n / 2; i++) {
            fr d, m;
            fr_sub(&d, &a[2 * i + 1], &a[2 * i]);
            fr_mul(&m, &d, &r);
            fr_add(&a[i], &a[2 * i], &m);
        }
    }
}

/* In-place prefix fold: buf[i] = buf[2i] + r*(buf[2i+1] - buf[2i]) for
 * i < active_n/2, leaving buf[active_n/2:] untouched (some byte-exact
 * provers read the stale tail of their in-place-folded tables). A scratch
 * copy keeps the parallel fold race-free. */
void frv_fold_adj_prefix(uint8_t *buf, long active_n, const uint8_t *r_mont) {
    long h = active_n / 2;
    if (h <= 0) return;
    uint8_t *tmp = malloc((size_t)h * 32);
    frv_fold_adj(buf, active_n, r_mont, tmp);
    memcpy(buf, tmp, (size_t)h * 32);
    free(tmp);
}

/* out[i] = a[i] + r*(a[i+h] - a[i]), h = n/2; out may alias a. */
void frv_fold_half(const uint8_t *in, long n, const uint8_t *r_mont, uint8_t *out) {
    fr r;
    fr_load(&r, r_mont);
    const fr *a = (const fr *)in;
    fr *o = (fr *)out;
    long h = n / 2;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (h > 2048)
#endif
    for (long i = 0; i < h; i++) {
        fr d, m;
        fr_sub(&d, &a[i + h], &a[i]);
        fr_mul(&m, &d, &r);
        fr_add(&o[i], &a[i], &m);
    }
}

/* ------------------------------------------------------------------ */
/* round-evaluation sums                                                */
/* ------------------------------------------------------------------ */

/* Stride-h pairing, degree-2 eq*f rounds (batch-opening reduction):
 * out = [a0, a2] with a0 = Σ_j e[j]*f[j],
 * a2 = Σ_j (2f[j+h]-f[j]) * (2e[j+h]-e[j]);  h = n/2. */
void frv_quad_sums_half(const uint8_t *fbuf, const uint8_t *ebuf, long n,
                        uint8_t *out) {
    const fr *f = (const fr *)fbuf;
    const fr *e = (const fr *)ebuf;
    long h = n / 2;
    fr a0 = {{0, 0, 0, 0}}, a2 = {{0, 0, 0, 0}};
#ifdef _OPENMP
#pragma omp parallel if (h > 2048)
    {
        fr l0 = {{0}}, l2 = {{0}};
#pragma omp for schedule(static) nowait
        for (long j = 0; j < h; j++) {
            fr t, f2, e2;
            fr_mul(&t, &e[j], &f[j]);
            fr_add(&l0, &l0, &t);
            fr_add(&f2, &f[j + h], &f[j + h]);
            fr_sub(&f2, &f2, &f[j]);
            fr_add(&e2, &e[j + h], &e[j + h]);
            fr_sub(&e2, &e2, &e[j]);
            fr_mul(&t, &f2, &e2);
            fr_add(&l2, &l2, &t);
        }
#pragma omp critical
        {
            fr_add(&a0, &a0, &l0);
            fr_add(&a2, &a2, &l2);
        }
    }
#else
    for (long j = 0; j < h; j++) {
        fr t, f2, e2;
        fr_mul(&t, &e[j], &f[j]);
        fr_add(&a0, &a0, &t);
        fr_add(&f2, &f[j + h], &f[j + h]);
        fr_sub(&f2, &f2, &f[j]);
        fr_add(&e2, &e[j + h], &e[j + h]);
        fr_sub(&e2, &e2, &e[j]);
        fr_mul(&t, &f2, &e2);
        fr_add(&a2, &a2, &t);
    }
#endif
    fr_store(&a0, out);
    fr_store(&a2, out + 32);
}

/* Adjacent pairing, k-factor product evaluated at t = 0..degree:
 * out[t] = Σ_i Π_k (lo_k + t*(hi_k - lo_k)) with lo_k = tab_k[2i],
 * hi_k = tab_k[2i+1]. tabs = k table pointers, each n elements.
 * k <= 8, degree <= 8. */
void frv_prod_evals_adj(const uint8_t *const *tabs, int k, long n, int degree,
                        uint8_t *out) {
    const fr *tp[40];
    for (int c = 0; c < k; c++) tp[c] = (const fr *)tabs[c];
    fr acc[41];
    for (int t = 0; t <= degree; t++) memset(&acc[t], 0, sizeof(fr));
#ifdef _OPENMP
#pragma omp parallel if (n > 4096)
    {
        fr lacc[41];
        for (int t = 0; t <= degree; t++) memset(&lacc[t], 0, sizeof(fr));
#pragma omp for schedule(static) nowait
        for (long i = 0; i < n / 2; i++) {
            fr val[40], d[40];
            for (int c = 0; c < k; c++) {
                val[c] = tp[c][2 * i];
                fr_sub(&d[c], &tp[c][2 * i + 1], &val[c]);
            }
            for (int t = 0; t <= degree; t++) {
                fr prod = val[0];
                for (int c = 1; c < k; c++) fr_mul(&prod, &prod, &val[c]);
                fr_add(&lacc[t], &lacc[t], &prod);
                for (int c = 0; c < k; c++) fr_add(&val[c], &val[c], &d[c]);
            }
        }
#pragma omp critical
        for (int t = 0; t <= degree; t++) fr_add(&acc[t], &acc[t], &lacc[t]);
    }
#else
    for (long i = 0; i < n / 2; i++) {
        fr val[40], d[40];
        for (int c = 0; c < k; c++) {
            val[c] = tp[c][2 * i];
            fr_sub(&d[c], &tp[c][2 * i + 1], &val[c]);
        }
        for (int t = 0; t <= degree; t++) {
            fr prod = val[0];
            for (int c = 1; c < k; c++) fr_mul(&prod, &prod, &val[c]);
            fr_add(&acc[t], &acc[t], &prod);
            for (int c = 0; c < k; c++) fr_add(&val[c], &val[c], &d[c]);
        }
    }
#endif
    for (int t = 0; t <= degree; t++) fr_store(&acc[t], out + (long)t * 32);
}

/* Stride-h pairing variant of the product-eval kernel. */
void frv_prod_evals_half(const uint8_t *const *tabs, int k, long n, int degree,
                         uint8_t *out) {
    const fr *tp[40];
    for (int c = 0; c < k; c++) tp[c] = (const fr *)tabs[c];
    long h = n / 2;
    fr acc[41];
    for (int t = 0; t <= degree; t++) memset(&acc[t], 0, sizeof(fr));
#ifdef _OPENMP
#pragma omp parallel if (h > 2048)
    {
        fr lacc[41];
        for (int t = 0; t <= degree; t++) memset(&lacc[t], 0, sizeof(fr));
#pragma omp for schedule(static) nowait
        for (long i = 0; i < h; i++) {
            fr val[40], d[40];
            for (int c = 0; c < k; c++) {
                val[c] = tp[c][i];
                fr_sub(&d[c], &tp[c][i + h], &val[c]);
            }
            for (int t = 0; t <= degree; t++) {
                fr prod = val[0];
                for (int c = 1; c < k; c++) fr_mul(&prod, &prod, &val[c]);
                fr_add(&lacc[t], &lacc[t], &prod);
                for (int c = 0; c < k; c++) fr_add(&val[c], &val[c], &d[c]);
            }
        }
#pragma omp critical
        for (int t = 0; t <= degree; t++) fr_add(&acc[t], &acc[t], &lacc[t]);
    }
#else
    for (long i = 0; i < h; i++) {
        fr val[40], d[40];
        for (int c = 0; c < k; c++) {
            val[c] = tp[c][i];
            fr_sub(&d[c], &tp[c][i + h], &val[c]);
        }
        for (int t = 0; t <= degree; t++) {
            fr prod = val[0];
            for (int c = 1; c < k; c++) fr_mul(&prod, &prod, &val[c]);
            fr_add(&acc[t], &acc[t], &prod);
            for (int c = 0; c < k; c++) fr_add(&val[c], &val[c], &d[c]);
        }
    }
#endif
    for (int t = 0; t <= degree; t++) fr_store(&acc[t], out + (long)t * 32);
}

/* RAF round sums (stage-2 RamRafEvaluation, adjacent pairs):
 * out = [s_lo, s_lo_i, s_2, s_2_i] with
 *   s_lo   = Σ_i ra[2i]            s_lo_i = Σ_i ra[2i]·i
 *   s_2    = Σ_i (2·ra[2i+1] − ra[2i])
 *   s_2_i  = Σ_i (2·ra[2i+1] − ra[2i])·i          (all mod p) */
void frv_raf_sums(const uint8_t *rabuf, long n, uint8_t *out) {
    const fr *ra = (const fr *)rabuf;
    fr s_lo = {{0}}, s_lo_i = {{0}}, s_2 = {{0}}, s_2_i = {{0}};
    fr iv = {{0}}; /* Montgomery i, incremented by FR_ONE_M */
    for (long i = 0; i < n / 2; i++) {
        fr lo = ra[2 * i], ra2, t;
        fr_add(&ra2, &ra[2 * i + 1], &ra[2 * i + 1]);
        fr_sub(&ra2, &ra2, &lo);
        fr_add(&s_lo, &s_lo, &lo);
        fr_add(&s_2, &s_2, &ra2);
        fr_mul(&t, &lo, &iv);
        fr_add(&s_lo_i, &s_lo_i, &t);
        fr_mul(&t, &ra2, &iv);
        fr_add(&s_2_i, &s_2_i, &t);
        fr_add(&iv, &iv, &FR_ONE_M);
    }
    fr_store(&s_lo, out);
    fr_store(&s_lo_i, out + 32);
    fr_store(&s_2, out + 64);
    fr_store(&s_2_i, out + 96);
}

/* Gruen-window quadratic sums (stage-2 ProductVirtualRemainder):
 * t0   = Σ_{x_out} e_out[x_out] · Σ_{x_in} e_in[x_in] · l_lo·r_lo
 * tinf = Σ_{x_out} e_out[x_out] · Σ_{x_in} e_in[x_in] · (l_hi−l_lo)(r_hi−r_lo)
 * where g = (x_out << head_in) | x_in indexes pairs (skip g >= num_groups),
 * l_lo = left[2g], l_hi = left[2g+1], same for right. out = [t0, tinf]. */
void frv_gruen_quad(const uint8_t *e_out, long n_out, const uint8_t *e_in,
                    long n_in, int head_in, const uint8_t *left,
                    const uint8_t *right, long num_groups, uint8_t *out) {
    const fr *eo = (const fr *)e_out;
    const fr *ei = (const fr *)e_in;
    const fr *l = (const fr *)left;
    const fr *r = (const fr *)right;
    fr t0 = {{0}}, tinf = {{0}};
#ifdef _OPENMP
#pragma omp parallel if (n_out * n_in > 4096)
    {
        fr l0 = {{0}}, lI = {{0}};
#pragma omp for schedule(static) nowait
        for (long xo = 0; xo < n_out; xo++) {
            fr inner0 = {{0}}, innerI = {{0}};
            for (long xi = 0; xi < n_in; xi++) {
                long g = (xo << head_in) | xi;
                if (g >= num_groups) continue;
                fr p0, dl, dr, pI;
                fr_mul(&p0, &l[2 * g], &r[2 * g]);
                fr_mul(&p0, &p0, &ei[xi]);
                fr_add(&inner0, &inner0, &p0);
                fr_sub(&dl, &l[2 * g + 1], &l[2 * g]);
                fr_sub(&dr, &r[2 * g + 1], &r[2 * g]);
                fr_mul(&pI, &dl, &dr);
                fr_mul(&pI, &pI, &ei[xi]);
                fr_add(&innerI, &innerI, &pI);
            }
            fr t;
            fr_mul(&t, &inner0, &eo[xo]);
            fr_add(&l0, &l0, &t);
            fr_mul(&t, &innerI, &eo[xo]);
            fr_add(&lI, &lI, &t);
        }
#pragma omp critical
        {
            fr_add(&t0, &t0, &l0);
            fr_add(&tinf, &tinf, &lI);
        }
    }
    fr_store(&t0, out);
    fr_store(&tinf, out + 32);
    return;
#endif
    for (long xo = 0; xo < n_out; xo++) {
        fr inner0 = {{0}}, innerI = {{0}};
        for (long xi = 0; xi < n_in; xi++) {
            long g = (xo << head_in) | xi;
            if (g >= num_groups) continue;
            fr p0, dl, dr, pI;
            fr_mul(&p0, &l[2 * g], &r[2 * g]);
            fr_mul(&p0, &p0, &ei[xi]);
            fr_add(&inner0, &inner0, &p0);
            fr_sub(&dl, &l[2 * g + 1], &l[2 * g]);
            fr_sub(&dr, &r[2 * g + 1], &r[2 * g]);
            fr_mul(&pI, &dl, &dr);
            fr_mul(&pI, &pI, &ei[xi]);
            fr_add(&innerI, &innerI, &pI);
        }
        fr t;
        fr_mul(&t, &inner0, &eo[xo]);
        fr_add(&t0, &t0, &t);
        fr_mul(&t, &innerI, &eo[xo]);
        fr_add(&tinf, &tinf, &t);
    }
    fr_store(&t0, out);
    fr_store(&tinf, out + 32);
}

/* Booleanity+Hamming round sums (stage 7), adjacent pairs, t = 0..3:
 * out[t]   = Σ_i e_b(t)·x(t)·(1−x(t))   (booleanity of the one-hot col)
 * out[4+t] = Σ_i e_hw(t)·x(t)           (Hamming-weight linkage)
 * where f(t) = f_lo + t·(f_hi − f_lo) over pairs (2i, 2i+1). */
void frv_bool_round(const uint8_t *eq_b, const uint8_t *eq_hw,
                    const uint8_t *oh, long n, uint8_t *out) {
    const fr *eb = (const fr *)eq_b;
    const fr *eh = (const fr *)eq_hw;
    const fr *x = (const fr *)oh;
    fr A[4], B[4];
    memset(A, 0, sizeof A);
    memset(B, 0, sizeof B);
#ifdef _OPENMP
#pragma omp parallel if (n > 4096)
    {
        fr LA[4], LB[4];
        memset(LA, 0, sizeof LA);
        memset(LB, 0, sizeof LB);
#pragma omp for schedule(static) nowait
        for (long i = 0; i < n / 2; i++) {
            fr ebv = eb[2 * i], ehv = eh[2 * i], xv = x[2 * i];
            fr ebd, ehd, xd;
            fr_sub(&ebd, &eb[2 * i + 1], &ebv);
            fr_sub(&ehd, &eh[2 * i + 1], &ehv);
            fr_sub(&xd, &x[2 * i + 1], &xv);
            for (int t = 0; t < 4; t++) {
                fr omx, tacc, tacc2;
                fr_sub(&omx, &FR_ONE_M, &xv);
                fr_mul(&tacc, &ebv, &xv);
                fr_mul(&tacc, &tacc, &omx);
                fr_add(&LA[t], &LA[t], &tacc);
                fr_mul(&tacc2, &ehv, &xv);
                fr_add(&LB[t], &LB[t], &tacc2);
                if (t < 3) {
                    fr_add(&ebv, &ebv, &ebd);
                    fr_add(&ehv, &ehv, &ehd);
                    fr_add(&xv, &xv, &xd);
                }
            }
        }
#pragma omp critical
        for (int t = 0; t < 4; t++) {
            fr_add(&A[t], &A[t], &LA[t]);
            fr_add(&B[t], &B[t], &LB[t]);
        }
    }
    for (int t = 0; t < 4; t++) {
        fr_store(&A[t], out + t * 32);
        fr_store(&B[t], out + (4 + t) * 32);
    }
    return;
#endif
    for (long i = 0; i < n / 2; i++) {
        fr ebv = eb[2 * i], ehv = eh[2 * i], xv = x[2 * i];
        fr ebd, ehd, xd;
        fr_sub(&ebd, &eb[2 * i + 1], &ebv);
        fr_sub(&ehd, &eh[2 * i + 1], &ehv);
        fr_sub(&xd, &x[2 * i + 1], &xv);
        for (int t = 0; t < 4; t++) {
            fr omx, tacc, tacc2;
            fr_sub(&omx, &FR_ONE_M, &xv);
            fr_mul(&tacc, &ebv, &xv);
            fr_mul(&tacc, &tacc, &omx);
            fr_add(&A[t], &A[t], &tacc);
            fr_mul(&tacc2, &ehv, &xv);
            fr_add(&B[t], &B[t], &tacc2);
            if (t < 3) {
                fr_add(&ebv, &ebv, &ebd);
                fr_add(&ehv, &ehv, &ehd);
                fr_add(&xv, &xv, &xd);
            }
        }
    }
    for (int t = 0; t < 4; t++) {
        fr_store(&A[t], out + t * 32);
        fr_store(&B[t], out + (4 + t) * 32);
    }
}

/* ------------------------------------------------------------------ */
/* elementwise / reduction utilities                                    */
/* ------------------------------------------------------------------ */

/* Stage-4 RegistersRWC phase-1 round sums (cycle binding with Gruen eq):
 * for each cycle pair i (je=2i, jo=2i+1), E = e_out[i>>head_in]·e_in[i&mask];
 *   c0  = Σ_k ra_e·v_e + wa_e·(v_e + inc0)
 *   cX2 = Σ_k ra_s·v_s + wa_s·(v_s + incs)   (s = odd − even slopes)
 * out2 = [Σ E·c0, Σ E·cX2]. rows are K pointers to length-T buffers. */
void frv_s4_phase1(const uint8_t *e_out, const uint8_t *e_in, int head_in,
                   const uint8_t *const *ra_rows, const uint8_t *const *wa_rows,
                   const uint8_t *const *val_rows, const uint8_t *inc,
                   int K, long T, uint8_t *out2) {
    const fr *eo = (const fr *)e_out;
    const fr *ei = (const fr *)e_in;
    const fr *incv = (const fr *)inc;
    long mask = (1L << head_in) - 1;
    fr q0 = {{0}}, qX2 = {{0}};
#ifdef _OPENMP
#pragma omp parallel if (T > 2048)
    {
        fr lq0 = {{0}}, lqX2 = {{0}};
#pragma omp for schedule(static) nowait
        for (long i = 0; i < T / 2; i++) {
            fr E;
            fr_mul(&E, &eo[i >> head_in], &ei[i & mask]);
            fr inc0 = incv[2 * i], incs;
            fr_sub(&incs, &incv[2 * i + 1], &inc0);
            fr c0 = {{0}}, cX2 = {{0}};
            for (int k = 0; k < K; k++) {
                const fr *ra = (const fr *)ra_rows[k];
                const fr *wa = (const fr *)wa_rows[k];
                const fr *v = (const fr *)val_rows[k];
                fr ra_e = ra[2 * i], wa_e = wa[2 * i], v_e = v[2 * i];
                fr ra_s, wa_s, v_s, t, t2;
                fr_sub(&ra_s, &ra[2 * i + 1], &ra_e);
                fr_sub(&wa_s, &wa[2 * i + 1], &wa_e);
                fr_sub(&v_s, &v[2 * i + 1], &v_e);
                fr_mul(&t, &ra_e, &v_e);
                fr_add(&c0, &c0, &t);
                fr_add(&t2, &v_e, &inc0);
                fr_mul(&t, &wa_e, &t2);
                fr_add(&c0, &c0, &t);
                fr_mul(&t, &ra_s, &v_s);
                fr_add(&cX2, &cX2, &t);
                fr_add(&t2, &v_s, &incs);
                fr_mul(&t, &wa_s, &t2);
                fr_add(&cX2, &cX2, &t);
            }
            fr t;
            fr_mul(&t, &E, &c0);
            fr_add(&lq0, &lq0, &t);
            fr_mul(&t, &E, &cX2);
            fr_add(&lqX2, &lqX2, &t);
        }
#pragma omp critical
        {
            fr_add(&q0, &q0, &lq0);
            fr_add(&qX2, &qX2, &lqX2);
        }
    }
    fr_store(&q0, out2);
    fr_store(&qX2, out2 + 32);
    return;
#endif
    for (long i = 0; i < T / 2; i++) {
        fr E;
        fr_mul(&E, &eo[i >> head_in], &ei[i & mask]);
        fr inc0 = incv[2 * i], incs;
        fr_sub(&incs, &incv[2 * i + 1], &inc0);
        fr c0 = {{0}}, cX2 = {{0}};
        for (int k = 0; k < K; k++) {
            const fr *ra = (const fr *)ra_rows[k];
            const fr *wa = (const fr *)wa_rows[k];
            const fr *v = (const fr *)val_rows[k];
            fr ra_e = ra[2 * i], wa_e = wa[2 * i], v_e = v[2 * i];
            fr ra_s, wa_s, v_s, t, t2;
            fr_sub(&ra_s, &ra[2 * i + 1], &ra_e);
            fr_sub(&wa_s, &wa[2 * i + 1], &wa_e);
            fr_sub(&v_s, &v[2 * i + 1], &v_e);
            fr_mul(&t, &ra_e, &v_e);
            fr_add(&c0, &c0, &t);
            fr_add(&t2, &v_e, &inc0);
            fr_mul(&t, &wa_e, &t2);
            fr_add(&c0, &c0, &t);
            fr_mul(&t, &ra_s, &v_s);
            fr_add(&cX2, &cX2, &t);
            fr_add(&t2, &v_s, &incs);
            fr_mul(&t, &wa_s, &t2);
            fr_add(&cX2, &cX2, &t);
        }
        fr t;
        fr_mul(&t, &E, &c0);
        fr_add(&q0, &q0, &t);
        fr_mul(&t, &E, &cX2);
        fr_add(&qX2, &qX2, &t);
    }
    fr_store(&q0, out2);
    fr_store(&qX2, out2 + 32);
}

/* Stage-4 phase-2 round sums (register binding, dense merged eq over T):
 * for register pair i (ke=2i, ko=2i+1) and every cycle j:
 *   e0 += eq[j]·(ra_e·v_e + wa_e·(v_e + inc_j))
 *   e2 += eq[j]·(ra2·v2 + wa2·(v2 + inc_j)),  x2 = 2·odd − even.
 * out2 = [e0, e2]; rows indexed 0..2·pairs−1. */
void frv_s4_phase2(const uint8_t *eq, const uint8_t *inc,
                   const uint8_t *const *ra_rows, const uint8_t *const *wa_rows,
                   const uint8_t *const *val_rows, long pairs, long T,
                   uint8_t *out2) {
    const fr *eqv = (const fr *)eq;
    const fr *incv = (const fr *)inc;
    fr e0 = {{0}}, e2 = {{0}};
    for (long i = 0; i < pairs; i++) {
        const fr *ra_e = (const fr *)ra_rows[2 * i];
        const fr *ra_o = (const fr *)ra_rows[2 * i + 1];
        const fr *wa_e = (const fr *)wa_rows[2 * i];
        const fr *wa_o = (const fr *)wa_rows[2 * i + 1];
        const fr *v_e = (const fr *)val_rows[2 * i];
        const fr *v_o = (const fr *)val_rows[2 * i + 1];
        for (long j = 0; j < T; j++) {
            fr t, t2, c;
            fr_mul(&c, &ra_e[j], &v_e[j]);
            fr_add(&t2, &v_e[j], &incv[j]);
            fr_mul(&t, &wa_e[j], &t2);
            fr_add(&c, &c, &t);
            fr_mul(&c, &c, &eqv[j]);
            fr_add(&e0, &e0, &c);
            fr ra2, wa2, v2;
            fr_add(&ra2, &ra_o[j], &ra_o[j]);
            fr_sub(&ra2, &ra2, &ra_e[j]);
            fr_add(&wa2, &wa_o[j], &wa_o[j]);
            fr_sub(&wa2, &wa2, &wa_e[j]);
            fr_add(&v2, &v_o[j], &v_o[j]);
            fr_sub(&v2, &v2, &v_e[j]);
            fr_mul(&c, &ra2, &v2);
            fr_add(&t2, &v2, &incv[j]);
            fr_mul(&t, &wa2, &t2);
            fr_add(&c, &c, &t);
            fr_mul(&c, &c, &eqv[j]);
            fr_add(&e2, &e2, &c);
        }
    }
    fr_store(&e0, out2);
    fr_store(&e2, out2 + 32);
}

/* Stage-4 phase-3 round sums (remaining cycle vars, dense eq, degree 3):
 * out3 = [e0, e2, e3] over cycle pairs with t-extensions at 0, 2, 3. */
void frv_s4_phase3(const uint8_t *eq, const uint8_t *inc,
                   const uint8_t *const *ra_rows, const uint8_t *const *wa_rows,
                   const uint8_t *const *val_rows, int K, long T,
                   uint8_t *out3) {
    const fr *eqv = (const fr *)eq;
    const fr *incv = (const fr *)inc;
    fr e0 = {{0}}, e2 = {{0}}, e3 = {{0}};
    for (long j = 0; j < T / 2; j++) {
        fr inc0 = incv[2 * j], incs;
        fr_sub(&incs, &incv[2 * j + 1], &inc0);
        fr inc2, inc3;
        fr_add(&inc2, &inc0, &incs);
        fr_add(&inc2, &inc2, &incs);
        fr_add(&inc3, &inc2, &incs);
        fr eq0 = eqv[2 * j], eqs;
        fr_sub(&eqs, &eqv[2 * j + 1], &eq0);
        fr eq2, eq3;
        fr_add(&eq2, &eq0, &eqs);
        fr_add(&eq2, &eq2, &eqs);
        fr_add(&eq3, &eq2, &eqs);
        fr i0 = {{0}}, i2 = {{0}}, i3 = {{0}};
        for (int k = 0; k < K; k++) {
            const fr *ra = (const fr *)ra_rows[k];
            const fr *wa = (const fr *)wa_rows[k];
            const fr *v = (const fr *)val_rows[k];
            fr ra_e = ra[2 * j], wa_e = wa[2 * j], v_e = v[2 * j];
            fr ra_s, wa_s, v_s, t, t2;
            fr_sub(&ra_s, &ra[2 * j + 1], &ra_e);
            fr_sub(&wa_s, &wa[2 * j + 1], &wa_e);
            fr_sub(&v_s, &v[2 * j + 1], &v_e);
            fr_mul(&t, &ra_e, &v_e);
            fr_add(&i0, &i0, &t);
            fr_add(&t2, &v_e, &inc0);
            fr_mul(&t, &wa_e, &t2);
            fr_add(&i0, &i0, &t);
            fr ra_t = ra_e, wa_t = wa_e, v_t = v_e;
            fr_add(&ra_t, &ra_t, &ra_s); fr_add(&ra_t, &ra_t, &ra_s);
            fr_add(&wa_t, &wa_t, &wa_s); fr_add(&wa_t, &wa_t, &wa_s);
            fr_add(&v_t, &v_t, &v_s); fr_add(&v_t, &v_t, &v_s);
            fr_mul(&t, &ra_t, &v_t);
            fr_add(&i2, &i2, &t);
            fr_add(&t2, &v_t, &inc2);
            fr_mul(&t, &wa_t, &t2);
            fr_add(&i2, &i2, &t);
            fr_add(&ra_t, &ra_t, &ra_s);
            fr_add(&wa_t, &wa_t, &wa_s);
            fr_add(&v_t, &v_t, &v_s);
            fr_mul(&t, &ra_t, &v_t);
            fr_add(&i3, &i3, &t);
            fr_add(&t2, &v_t, &inc3);
            fr_mul(&t, &wa_t, &t2);
            fr_add(&i3, &i3, &t);
        }
        fr t;
        fr_mul(&t, &eq0, &i0);
        fr_add(&e0, &e0, &t);
        fr_mul(&t, &eq2, &i2);
        fr_add(&e2, &e2, &t);
        fr_mul(&t, &eq3, &i3);
        fr_add(&e3, &e3, &t);
    }
    fr_store(&e0, out3);
    fr_store(&e2, out3 + 32);
    fr_store(&e3, out3 + 64);
}

/* out[2i] = a[i], out[2i+1] = b[i] */
void frv_interleave(const uint8_t *a, const uint8_t *b, long n, uint8_t *out) {
    for (long i = 0; i < n; i++) {
        memcpy(out + (2 * i) * 32, a + i * 32, 32);
        memcpy(out + (2 * i + 1) * 32, b + i * 32, 32);
    }
}

/* Σ_i e[i]·a[i]·b[i] */
void frv_triple_inner(const uint8_t *e, const uint8_t *a, const uint8_t *b,
                      long n, uint8_t *out) {
    const fr *ev = (const fr *)e;
    const fr *av = (const fr *)a;
    const fr *bv = (const fr *)b;
    fr acc = {{0, 0, 0, 0}};
#ifdef _OPENMP
#pragma omp parallel if (n > 4096)
    {
        fr l = {{0}};
#pragma omp for schedule(static) nowait
        for (long i = 0; i < n; i++) {
            fr t;
            fr_mul(&t, &av[i], &bv[i]);
            fr_mul(&t, &t, &ev[i]);
            fr_add(&l, &l, &t);
        }
#pragma omp critical
        fr_add(&acc, &acc, &l);
    }
#else
    for (long i = 0; i < n; i++) {
        fr t;
        fr_mul(&t, &av[i], &bv[i]);
        fr_mul(&t, &t, &ev[i]);
        fr_add(&acc, &acc, &t);
    }
#endif
    fr_store(&acc, out);
}

void frv_vec_add(const uint8_t *a, const uint8_t *b, long n, uint8_t *out) {
#pragma omp parallel for schedule(static) if (n > 16384)
    for (long i = 0; i < n; i++)
        fr_add((fr *)(out + i * 32), (const fr *)(a + i * 32), (const fr *)(b + i * 32));
}

void frv_vec_sub(const uint8_t *a, const uint8_t *b, long n, uint8_t *out) {
#pragma omp parallel for schedule(static) if (n > 16384)
    for (long i = 0; i < n; i++)
        fr_sub((fr *)(out + i * 32), (const fr *)(a + i * 32), (const fr *)(b + i * 32));
}

void frv_vec_mul(const uint8_t *a, const uint8_t *b, long n, uint8_t *out) {
#pragma omp parallel for schedule(static) if (n > 4096)
    for (long i = 0; i < n; i++)
        fr_mul((fr *)(out + i * 32), (const fr *)(a + i * 32), (const fr *)(b + i * 32));
}

/* out[j] = Σ_i coeffs[i]·cols[i][j] — fused linear combination (one pass
 * over memory instead of k axpys; the stage-1 Lagrange/UniSkip combos). */
void frv_lincomb(const uint8_t *const *cols, const uint8_t *coeffs, int k,
                 long n, uint8_t *out) {
    const fr *cf = (const fr *)coeffs;
    const fr **cp = (const fr **)cols;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n > 2048)
#endif
    for (long j = 0; j < n; j++) {
        fr acc = {{0, 0, 0, 0}};
        for (int i = 0; i < k; i++) {
            fr t;
            fr_mul(&t, &cp[i][j], &cf[i]);
            fr_add(&acc, &acc, &t);
        }
        fr_store(&acc, out + j * 32);
    }
}

/* acc += c * x (elementwise) */
void frv_axpy(uint8_t *acc, const uint8_t *x, const uint8_t *c_mont, long n) {
    fr c;
    fr_load(&c, c_mont);
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n > 4096)
#endif
    for (long i = 0; i < n; i++) {
        fr m;
        fr_mul(&m, (const fr *)(x + i * 32), &c);
        fr_add((fr *)(acc + i * 32), (const fr *)(acc + i * 32), &m);
    }
}

void frv_scale(const uint8_t *a, const uint8_t *c_mont, long n, uint8_t *out) {
    fr c;
    fr_load(&c, c_mont);
    for (long i = 0; i < n; i++)
        fr_mul((fr *)(out + i * 32), (const fr *)(a + i * 32), &c);
}

void frv_inner(const uint8_t *a, const uint8_t *b, long n, uint8_t *out) {
    fr acc = {{0, 0, 0, 0}};
    for (long i = 0; i < n; i++) {
        fr m;
        fr_mul(&m, (const fr *)(a + i * 32), (const fr *)(b + i * 32));
        fr_add(&acc, &acc, &m);
    }
    fr_store(&acc, out);
}

void frv_sum(const uint8_t *a, long n, uint8_t *out) {
    fr acc = {{0, 0, 0, 0}};
    for (long i = 0; i < n; i++) fr_add(&acc, &acc, (const fr *)(a + i * 32));
    fr_store(&acc, out);
}

/* MLE evaluation, big-endian point (point[0] binds the top index bit):
 * repeatedly fold-half. Scratch: caller passes a writable copy in `tab`. */
void frv_mle_eval_be(uint8_t *tab, long n, const uint8_t *point, int n_vars,
                     uint8_t *out) {
    long size = n;
    for (int v = 0; v < n_vars; v++) {
        frv_fold_half(tab, size, point + (long)v * 32, tab);
        size /= 2;
    }
    memcpy(out, tab, 32);
}

/* ------------------------------------------------------------------ */
/* Stage-8 phase-A primitives (zkvm/lookups_raf.py): the full-width    */
/* Lasso address rounds decompose into per-CATEGORY weighted sums plus */
/* per-category state updates, where the category of an entry is a     */
/* small integer computed from its concrete index bits (current bit,   */
/* suffix bit, lt/eq chain state, shift amount). ncat <= 65536.          */
/* ------------------------------------------------------------------ */

/* out[cat[i]] += wt[i] * x[i]  (x_fr Montgomery; or x_u64 canonical;   */
/* or neither -> just wt sums). out holds ncat Montgomery elements and  */
/* must be zeroed by the caller.                                        */
static void frv_cat_wsum_serial(const uint8_t *wt, const uint8_t *x_fr,
                                const u64 *x_u64, const uint16_t *cat,
                                long n, uint8_t *out) {
    for (long i = 0; i < n; i++) {
        fr v;
        fr_load(&v, wt + i * 32);
        if (x_fr) {
            fr x;
            fr_load(&x, x_fr + i * 32);
            fr_mul(&v, &v, &x);
        } else if (x_u64) {
            fr x = {{x_u64[i], 0, 0, 0}};
            fr_mul(&x, &x, &FR_R2);
            fr_mul(&v, &v, &x);
        }
        fr *slot = (fr *)(out + (long)cat[i] * 32);
        fr_add(slot, slot, &v);
    }
}

void frv_cat_wsum(const uint8_t *wt, const uint8_t *x_fr, const u64 *x_u64,
                  const uint16_t *cat, long n, int ncat, uint8_t *out) {
#ifdef _OPENMP
    int nthreads = omp_get_max_threads();
    if (n < 4096) nthreads = 1;
    fr *parts = (fr *)calloc((size_t)nthreads * ncat, sizeof(fr));
    if (!parts) {           /* allocation failure: serial path, no crash */
        frv_cat_wsum_serial(wt, x_fr, x_u64, cat, n, out);
        return;
    }
    #pragma omp parallel num_threads(nthreads)
    {
        int tid = omp_get_thread_num();
        fr *acc = parts + (size_t)tid * ncat;
        #pragma omp for schedule(static)
        for (long i = 0; i < n; i++) {
            fr v;
            fr_load(&v, wt + i * 32);
            if (x_fr) {
                fr x;
                fr_load(&x, x_fr + i * 32);
                fr_mul(&v, &v, &x);
            } else if (x_u64) {
                fr x = {{x_u64[i], 0, 0, 0}};
                fr_mul(&x, &x, &FR_R2);   /* to_mont */
                fr_mul(&v, &v, &x);
            }
            fr_add(&acc[cat[i]], &acc[cat[i]], &v);
        }
    }
    for (int c = 0; c < ncat; c++) {
        fr acc = {{0, 0, 0, 0}};
        for (int t = 0; t < nthreads; t++)
            fr_add(&acc, &acc, &parts[(size_t)t * ncat + c]);
        fr_store(&acc, out + (long)c * 32);
    }
    free(parts);
#else
    frv_cat_wsum_serial(wt, x_fr, x_u64, cat, n, out);
#endif
}

/* buf[i] *= consts[cat[i]]  (consts: ncat Montgomery elements) */
void frv_scale_by_cat(uint8_t *buf, const uint16_t *cat, long n,
                      const uint8_t *consts) {
    #pragma omp parallel for schedule(static) if (n >= 4096)
    for (long i = 0; i < n; i++) {
        fr *v = (fr *)(buf + i * 32);
        fr_mul(v, v, (const fr *)(consts + (long)cat[i] * 32));
    }
}

/* buf[i] += consts[cat[i]] */
void frv_add_by_cat(uint8_t *buf, const uint16_t *cat, long n,
                    const uint8_t *consts) {
    #pragma omp parallel for schedule(static) if (n >= 4096)
    for (long i = 0; i < n; i++) {
        fr *v = (fr *)(buf + i * 32);
        fr_add(v, v, (const fr *)(consts + (long)cat[i] * 32));
    }
}

/* ------------------------------------------------------------------ */
/* Moment matrix for the UniSkip first round (zkvm/streaming_outer):   */
/* out[a*kb + b] = Σ_i e[i]·A_a[i]·B_b[i].  The 19 extended-domain     */
/* targets are quadratic forms w_jᵀ·M·w_j in the Lagrange coefficient  */
/* vectors, so computing M once replaces 2 column combinations + one   */
/* triple inner product per target (each column read once, ~2x fewer   */
/* multiplications overall).                                           */
/* ------------------------------------------------------------------ */

/* Allocation-free fallback (direct accumulation into out; recomputes   */
/* ev*A per (a,b) cell — only used when the heap is exhausted).         */
static void frv_moment_noalloc(const uint8_t *e, const uint8_t *const *colsA,
                               const uint8_t *const *colsB, int ka, int kb,
                               long n, uint8_t *out) {
    fr zero = {{0, 0, 0, 0}};
    for (int c = 0; c < ka * kb; c++) fr_store(&zero, out + (long)c * 32);
    for (long i = 0; i < n; i++) {
        fr ev;
        fr_load(&ev, e + i * 32);
        for (int a = 0; a < ka; a++) {
            fr av;
            fr_load(&av, colsA[a] + i * 32);
            fr_mul(&av, &av, &ev);
            for (int b = 0; b < kb; b++) {
                fr bv, t;
                fr_load(&bv, colsB[b] + i * 32);
                fr_mul(&t, &av, &bv);
                fr *slot = (fr *)(out + ((long)a * kb + b) * 32);
                fr_add(slot, slot, &t);
            }
        }
    }
}

void frv_moment(const uint8_t *e, const uint8_t *const *colsA,
                const uint8_t *const *colsB, int ka, int kb, long n,
                uint8_t *out) {
    int cells = ka * kb;
#ifdef _OPENMP
    int nthreads = omp_get_max_threads();
    if (n < 4096) nthreads = 1;
    fr *parts = (fr *)calloc((size_t)nthreads * cells, sizeof(fr));
    fr *eas = (fr *)malloc((size_t)nthreads * ka * sizeof(fr));
    if (!parts || !eas) {   /* allocation failure: no-alloc path, no crash */
        free(parts); free(eas);
        frv_moment_noalloc(e, colsA, colsB, ka, kb, n, out);
        return;
    }
    #pragma omp parallel num_threads(nthreads)
    {
        int tid = omp_get_thread_num();
        fr *acc = parts + (size_t)tid * cells;
        fr *ea = eas + (size_t)tid * ka;
        #pragma omp for schedule(static)
        for (long i = 0; i < n; i++) {
            fr ev;
            fr_load(&ev, e + i * 32);
            for (int a = 0; a < ka; a++) {
                fr av;
                fr_load(&av, colsA[a] + i * 32);
                fr_mul(&ea[a], &ev, &av);
            }
            for (int b = 0; b < kb; b++) {
                fr bv;
                fr_load(&bv, colsB[b] + i * 32);
                for (int a = 0; a < ka; a++) {
                    fr t;
                    fr_mul(&t, &ea[a], &bv);
                    fr_add(&acc[a * kb + b], &acc[a * kb + b], &t);
                }
            }
        }
    }
    for (int c = 0; c < cells; c++) {
        fr acc = {{0, 0, 0, 0}};
        for (int t = 0; t < nthreads; t++)
            fr_add(&acc, &acc, &parts[(size_t)t * cells + c]);
        fr_store(&acc, out + (long)c * 32);
    }
    free(parts); free(eas);
#else
    fr *acc = (fr *)calloc((size_t)cells, sizeof(fr));
    fr *ea = (fr *)malloc((size_t)ka * sizeof(fr));
    if (!acc || !ea) {
        free(acc); free(ea);
        frv_moment_noalloc(e, colsA, colsB, ka, kb, n, out);
        return;
    }
    for (long i = 0; i < n; i++) {
        fr ev;
        fr_load(&ev, e + i * 32);
        for (int a = 0; a < ka; a++) {
            fr av;
            fr_load(&av, colsA[a] + i * 32);
            fr_mul(&ea[a], &ev, &av);
        }
        for (int b = 0; b < kb; b++) {
            fr bv;
            fr_load(&bv, colsB[b] + i * 32);
            for (int a = 0; a < ka; a++) {
                fr t;
                fr_mul(&t, &ea[a], &bv);
                fr_add(&acc[a * kb + b], &acc[a * kb + b], &t);
            }
        }
    }
    for (int c = 0; c < cells; c++) fr_store(&acc[c], out + (long)c * 32);
    free(acc); free(ea);
#endif
}
