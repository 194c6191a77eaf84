/* Host-side elliptic-curve kernels: 256-bit Montgomery field, Jacobian
 * group law, Pippenger MSM, windowed scalar mul.
 *
 * The reference implements these in Rust with BMI2/ADX intrinsics
 * (src/provider/msm.rs, src/big_num/limbs.rs).  Bulk prover MSMs run on
 * the card (csrc/comb.cu, csrc/msm.cu); the host serves the small ones:
 * the multiround verifier-circuit per-round commitments (bellpepper/
 * r1cs.rs:735-816), the Hyrax IPA's scalar multiplications and checks,
 * and MSMs below 64 points.  The JAX package's native/ec_host.c, copied.
 *
 * Built at first use with cc into build/native/ at the root of the
 * checkout (native/__init__.py) and loaded through ctypes; a failed
 * build raises.  ec/curve.py's scalar_mul_plain and msm_plain are the
 * Python versions the tests hold it against.
 *
 * Conventions:
 *   - field element: 4 x uint64 little-endian limbs, value < p < 2^256
 *   - curve params passed per call: p, n0 = -p^-1 mod 2^64,
 *     r2 = 2^512 mod p, a_mont = a * 2^256 mod p
 *   - affine input points: 64 bytes (x || y) canonical LE; x == y == 0
 *     encodes infinity (unused as a curve point: b != 0 on all curves)
 *   - scalars: 32 bytes canonical LE
 *   - output: 96 bytes Jacobian (X || Y || Z) canonical LE; Z == 0 is
 *     infinity
 */

#include <stdint.h>
#include <string.h>
#include <stdlib.h>

typedef unsigned __int128 u128;

typedef struct {
    uint64_t p[4];
    uint64_t n0;
    uint64_t a[4];      /* curve a, Montgomery form */
    uint64_t one[4];    /* R mod p (Montgomery 1) */
    int a_is_zero;
} ctx_t;

typedef struct { uint64_t x[4], y[4], z[4]; } jac_t;

static int fe_is_zero(const uint64_t a[4]) {
    return (a[0] | a[1] | a[2] | a[3]) == 0;
}

static int fe_cmp(const uint64_t a[4], const uint64_t b[4]) {
    for (int i = 3; i >= 0; i--) {
        if (a[i] < b[i]) return -1;
        if (a[i] > b[i]) return 1;
    }
    return 0;
}

static void fe_sub_raw(uint64_t r[4], const uint64_t a[4], const uint64_t b[4]) {
    u128 br = 0;
    for (int i = 0; i < 4; i++) {
        u128 v = (u128)a[i] - b[i] - (uint64_t)br;
        r[i] = (uint64_t)v;
        br = (v >> 64) & 1;  /* 1 if borrow */
    }
}

static void fe_add(const ctx_t *c, uint64_t r[4], const uint64_t a[4],
                   const uint64_t b[4]) {
    u128 cr = 0;
    uint64_t t[4];
    for (int i = 0; i < 4; i++) {
        cr += (u128)a[i] + b[i];
        t[i] = (uint64_t)cr;
        cr >>= 64;
    }
    if (cr || fe_cmp(t, c->p) >= 0) {
        fe_sub_raw(r, t, c->p);
    } else {
        memcpy(r, t, 32);
    }
}

static void fe_sub(const ctx_t *c, uint64_t r[4], const uint64_t a[4],
                   const uint64_t b[4]) {
    if (fe_cmp(a, b) >= 0) {
        fe_sub_raw(r, a, b);
    } else {
        uint64_t t[4];
        fe_sub_raw(t, b, a);
        fe_sub_raw(r, c->p, t);
    }
}

static void fe_neg(const ctx_t *c, uint64_t r[4], const uint64_t a[4]) {
    if (fe_is_zero(a)) { memset(r, 0, 32); return; }
    fe_sub_raw(r, c->p, a);
}

/* CIOS Montgomery multiplication: r = a * b * 2^-256 mod p */
static void fe_mul(const ctx_t *c, uint64_t r[4], const uint64_t a[4],
                   const uint64_t b[4]) {
    uint64_t t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u128 cr = 0;
        for (int j = 0; j < 4; j++) {
            cr = (u128)a[j] * b[i] + t[j] + (uint64_t)cr;
            t[j] = (uint64_t)cr;
            cr >>= 64;
        }
        cr += t[4];
        t[4] = (uint64_t)cr;
        t[5] = (uint64_t)(cr >> 64);

        uint64_t m = t[0] * c->n0;
        cr = (u128)m * c->p[0] + t[0];
        cr >>= 64;
        for (int j = 1; j < 4; j++) {
            cr = (u128)m * c->p[j] + t[j] + (uint64_t)cr;
            t[j - 1] = (uint64_t)cr;
            cr >>= 64;
        }
        cr += t[4];
        t[3] = (uint64_t)cr;
        t[4] = t[5] + (uint64_t)(cr >> 64);
    }
    if (t[4] || fe_cmp(t, c->p) >= 0) {
        fe_sub_raw(r, t, c->p);
        /* t[4] can only be 0 or 1; after one subtract value < p since
         * inputs < p guarantee t < 2p */
    } else {
        memcpy(r, t, 32);
    }
}

static void fe_sqr(const ctx_t *c, uint64_t r[4], const uint64_t a[4]) {
    fe_mul(c, r, a, a);
}

static void fe_dbl(const ctx_t *c, uint64_t r[4], const uint64_t a[4]) {
    fe_add(c, r, a, a);
}

static void jac_set_inf(const ctx_t *c, jac_t *p) {
    memset(p->x, 0, 32);
    memcpy(p->y, c->one, 32);
    memset(p->z, 0, 32);
}

static int jac_is_inf(const jac_t *p) { return fe_is_zero(p->z); }

/* dbl-2007-bl-compatible doubling (matches curve.py jac_double semantics:
 * Y == 0 or Z == 0 -> infinity via Z2 = 2*Y*Z == 0) */
static void jac_dbl(const ctx_t *c, jac_t *r, const jac_t *p) {
    uint64_t S[4], ZZ[4], M[4], t[4], t2[4], X2[4], Y2[4], Z2[4];
    if (jac_is_inf(p) || fe_is_zero(p->y)) { jac_set_inf(c, r); return; }
    /* S = 4*X*Y^2 */
    fe_sqr(c, t, p->y);            /* Y^2 */
    fe_mul(c, S, p->x, t);
    fe_dbl(c, S, S);
    fe_dbl(c, S, S);
    /* M = 3*X^2 + a*Z^4 */
    fe_sqr(c, M, p->x);
    fe_dbl(c, t2, M);
    fe_add(c, M, M, t2);
    if (!c->a_is_zero) {
        fe_sqr(c, ZZ, p->z);
        fe_sqr(c, ZZ, ZZ);
        fe_mul(c, ZZ, ZZ, c->a);
        fe_add(c, M, M, ZZ);
    }
    /* X2 = M^2 - 2S */
    fe_sqr(c, X2, M);
    fe_dbl(c, t2, S);
    fe_sub(c, X2, X2, t2);
    /* Y2 = M*(S - X2) - 8*Y^4 */
    fe_sub(c, t2, S, X2);
    fe_mul(c, Y2, M, t2);
    fe_sqr(c, t, t);               /* Y^4 */
    fe_dbl(c, t, t);
    fe_dbl(c, t, t);
    fe_dbl(c, t, t);
    fe_sub(c, Y2, Y2, t);
    /* Z2 = 2*Y*Z */
    fe_mul(c, Z2, p->y, p->z);
    fe_dbl(c, Z2, Z2);
    memcpy(r->x, X2, 32);
    memcpy(r->y, Y2, 32);
    memcpy(r->z, Z2, 32);
}

/* complete Jacobian addition (matches curve.py jac_add branches) */
static void jac_add(const ctx_t *c, jac_t *r, const jac_t *p, const jac_t *q) {
    uint64_t Z1Z1[4], Z2Z2[4], U1[4], U2[4], S1[4], S2[4], H[4], R[4];
    uint64_t HH[4], HHH[4], V[4], t[4], X3[4], Y3[4], Z3[4];
    if (jac_is_inf(p)) { *r = *q; return; }
    if (jac_is_inf(q)) { *r = *p; return; }
    fe_sqr(c, Z1Z1, p->z);
    fe_sqr(c, Z2Z2, q->z);
    fe_mul(c, U1, p->x, Z2Z2);
    fe_mul(c, U2, q->x, Z1Z1);
    fe_mul(c, S1, p->y, q->z);
    fe_mul(c, S1, S1, Z2Z2);
    fe_mul(c, S2, q->y, p->z);
    fe_mul(c, S2, S2, Z1Z1);
    fe_sub(c, H, U2, U1);
    fe_sub(c, R, S2, S1);
    if (fe_is_zero(H)) {
        if (fe_is_zero(R)) { jac_dbl(c, r, p); return; }
        jac_set_inf(c, r);
        return;
    }
    fe_sqr(c, HH, H);
    fe_mul(c, HHH, H, HH);
    fe_mul(c, V, U1, HH);
    fe_sqr(c, X3, R);
    fe_sub(c, X3, X3, HHH);
    fe_dbl(c, t, V);
    fe_sub(c, X3, X3, t);
    fe_sub(c, t, V, X3);
    fe_mul(c, Y3, R, t);
    fe_mul(c, t, S1, HHH);
    fe_sub(c, Y3, Y3, t);
    fe_mul(c, Z3, p->z, q->z);
    fe_mul(c, Z3, Z3, H);
    memcpy(r->x, X3, 32);
    memcpy(r->y, Y3, 32);
    memcpy(r->z, Z3, 32);
}

static void ctx_init(ctx_t *c, const uint64_t *params) {
    /* params: p[4], n0, a_mont[4], r2[4] (r2 unused beyond one calc) */
    memcpy(c->p, params, 32);
    c->n0 = params[4];
    memcpy(c->a, params + 5, 32);
    c->a_is_zero = fe_is_zero(c->a);
    /* one = mont(1) = R mod p = mont_mul(1, R2) */
    uint64_t onec[4] = {1, 0, 0, 0};
    fe_mul(c, c->one, onec, params + 9);
}

static void load_point(const ctx_t *c, jac_t *out, const uint8_t *pt,
                       const uint64_t r2[4]) {
    uint64_t x[4], y[4];
    memcpy(x, pt, 32);
    memcpy(y, pt + 32, 32);
    if (fe_is_zero(x) && fe_is_zero(y)) { jac_set_inf(c, out); return; }
    fe_mul(c, out->x, x, r2);
    fe_mul(c, out->y, y, r2);
    memcpy(out->z, c->one, 32);
}

static void store_jac(const ctx_t *c, uint8_t *out, const jac_t *p) {
    /* convert coordinates out of Montgomery form */
    uint64_t onec[4] = {1, 0, 0, 0}, v[4];
    fe_mul(c, v, p->x, onec); memcpy(out, v, 32);
    fe_mul(c, v, p->y, onec); memcpy(out + 32, v, 32);
    fe_mul(c, v, p->z, onec); memcpy(out + 64, v, 32);
}

/* Pippenger MSM.  scalars: n x 32 bytes LE canonical; points: n x 64
 * bytes affine canonical ((0,0) = infinity); out: 96-byte Jacobian. */
void sp2_ec_msm(const uint64_t *params, const uint8_t *scalars,
                const uint8_t *points, uint64_t n, uint8_t *out) {
    ctx_t c;
    ctx_init(&c, params);
    const uint64_t *r2 = params + 9;

    jac_t acc;
    jac_set_inf(&c, &acc);
    if (n == 0) { store_jac(&c, out, &acc); return; }

    int w = n < 128 ? 4 : n < 32768 ? 8 : 12;
    int nbuckets = (1 << w) - 1;
    int windows = (256 + w - 1) / w;

    jac_t *pts = (jac_t *)malloc(n * sizeof(jac_t));
    for (uint64_t i = 0; i < n; i++)
        load_point(&c, &pts[i], points + 64 * i, r2);
    jac_t *buckets = (jac_t *)malloc(nbuckets * sizeof(jac_t));

    for (int win = windows - 1; win >= 0; win--) {
        for (int d = 0; d < w; d++) jac_dbl(&c, &acc, &acc);
        for (int j = 0; j < nbuckets; j++) jac_set_inf(&c, &buckets[j]);
        int bit = win * w;
        for (uint64_t i = 0; i < n; i++) {
            const uint8_t *s = scalars + 32 * i;
            /* extract w bits starting at `bit` (LE byte order) */
            uint32_t d = 0;
            for (int b = 0; b < w; b++) {
                int bb = bit + b;
                if (bb < 256 && (s[bb >> 3] >> (bb & 7)) & 1) d |= 1u << b;
            }
            if (d) jac_add(&c, &buckets[d - 1], &buckets[d - 1], &pts[i]);
        }
        jac_t run, ssum;
        jac_set_inf(&c, &run);
        jac_set_inf(&c, &ssum);
        for (int j = nbuckets - 1; j >= 0; j--) {
            jac_add(&c, &run, &run, &buckets[j]);
            jac_add(&c, &ssum, &ssum, &run);
        }
        jac_add(&c, &acc, &acc, &ssum);
    }
    free(buckets);
    free(pts);
    store_jac(&c, out, &acc);
}

/* 4-bit windowed scalar mul: k (32 bytes LE) * pt -> Jacobian out. */
void sp2_ec_scalar_mul(const uint64_t *params, const uint8_t *k,
                       const uint8_t *pt, uint8_t *out) {
    ctx_t c;
    ctx_init(&c, params);
    const uint64_t *r2 = params + 9;
    jac_t P, acc, table[16];
    load_point(&c, &P, pt, r2);
    jac_set_inf(&c, &table[0]);
    table[1] = P;
    for (int i = 2; i < 16; i++) jac_add(&c, &table[i], &table[i - 1], &P);
    jac_set_inf(&c, &acc);
    for (int win = 63; win >= 0; win--) {
        for (int d = 0; d < 4; d++) jac_dbl(&c, &acc, &acc);
        int nib = (k[win >> 1] >> ((win & 1) ? 4 : 0)) & 0xF;
        if (nib) jac_add(&c, &acc, &acc, &table[nib]);
    }
    store_jac(&c, out, &acc);
}
