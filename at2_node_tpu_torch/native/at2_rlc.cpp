// at2_rlc.cpp — GIL-released random-linear-combination (RLC) batch
// verification engine for ed25519.
//
// One RLC check over B signatures replaces B double-scalar-mults:
//
//     [ sum z_i s_i mod L ] B  ==  sum [z_i] R_i  +  sum [z_i h_i] A_i
//
// with per-batch random 128-bit z_i. The two right-hand sums are
// Pippenger multi-scalar-mults (signed 8-bit windows), so the marginal
// cost per signature drops from one 512-bit Straus double-mult (~1500
// point ops) to ~55 point ops at B=1024 — that is the whole trick.
//
// Soundness on the full curve (cofactor 8) needs more than the equation:
// a signer-malleated R' = R + T (T small-order) passes the cofactorless
// per-signature check with probability 0 but would pass a naive RLC with
// probability 1/8 per torsion component (z_i mod ord(T) cancels). Two
// complementary defences, mirroring the exact [L]P precheck in
// ops/aggregate.py:
//
//   * A-side: `at2_rlc_certify` does the exact [L]A == identity test per
//     public key. The verifier caches the verdict per key (keys repeat
//     across batches; the ~80us exact test amortizes to ~0), and any key
//     whose A carries torsion is routed to the exact per-signature path
//     forever — certification REROUTES, it never rejects, so verdicts
//     still agree with per-sig on tainted-A inputs.
//   * R-side: R points are fresh per signature, so per-point exact tests
//     cannot amortize. Instead we run `k` randomized subset rounds: each
//     round folds S_r = sum c_{r,i} R_i with independent uniform 3-bit
//     coefficients c and requires [L] S_r == identity. A lane whose R
//     carries a torsion component of order m in {2,4,8} survives one
//     round with probability 1/m <= 1/2, so k rounds bound the miss
//     probability by 2^-k (k=64 from the Python side: 2^-64, far below
//     the 2^-124 prime-order soundness of the 128-bit z themselves).
//
// Layout mirrors at2_ingest.cpp: plain extern "C" entry points over
// packed numpy buffers, built by native/_build.py with g++ -O3, loaded
// via ctypes (which releases the GIL for the whole call).
//
// Field/point code: 5x51-bit limb arithmetic (unsigned __int128
// products) and extended twisted-Edwards coordinates with the complete
// a=-1 addition law (Hisil-Wong-Carter-Dawson), the same formulas as
// ops/edwards.py — completeness means bucket accumulation never needs
// case analysis. Decompression implements RFC 8032 §5.1.3 with the
// exact edge-case semantics of crypto/_fallback.py and ops/edwards.py:
// reject y >= p, reject non-square x^2, reject x=0 with sign bit set.

#include <cstdint>
#include <cstring>
#include <vector>

typedef uint64_t u64;
typedef unsigned __int128 u128;

static const u64 MASK51 = ((u64)1 << 51) - 1;

// ---------------------------------------------------------------- field

struct fe {
    u64 v[5];
};

static const fe FE_ZERO = {{0, 0, 0, 0, 0}};
static const fe FE_ONE = {{1, 0, 0, 0, 0}};
// d = -121665/121666 mod p
static const fe FE_D = {{0x34dca135978a3ULL, 0x1a8283b156ebdULL,
                         0x5e7a26001c029ULL, 0x739c663a03cbbULL,
                         0x52036cee2b6ffULL}};
// 2d mod p
static const fe FE_D2 = {{0x69b9426b2f159ULL, 0x35050762add7aULL,
                          0x3cf44c0038052ULL, 0x6738cc7407977ULL,
                          0x2406d9dc56dffULL}};
// sqrt(-1) mod p
static const fe FE_SQRTM1 = {{0x61b274a0ea0b0ULL, 0xd5a5fc8f189dULL,
                              0x7ef5e9cbd0c60ULL, 0x78595a6804c9eULL,
                              0x2b8324804fc1dULL}};

static inline void fe_reduce(fe &r) {
    u64 c;
    c = r.v[0] >> 51; r.v[0] &= MASK51; r.v[1] += c;
    c = r.v[1] >> 51; r.v[1] &= MASK51; r.v[2] += c;
    c = r.v[2] >> 51; r.v[2] &= MASK51; r.v[3] += c;
    c = r.v[3] >> 51; r.v[3] &= MASK51; r.v[4] += c;
    c = r.v[4] >> 51; r.v[4] &= MASK51; r.v[0] += 19 * c;
    c = r.v[0] >> 51; r.v[0] &= MASK51; r.v[1] += c;
}

static inline void fe_add(fe &r, const fe &a, const fe &b) {
    for (int i = 0; i < 5; i++) r.v[i] = a.v[i] + b.v[i];
    fe_reduce(r);
}

static inline void fe_sub(fe &r, const fe &a, const fe &b) {
    // add 2p so every limb stays non-negative before subtracting
    r.v[0] = a.v[0] + 0xFFFFFFFFFFFDAULL - b.v[0];
    r.v[1] = a.v[1] + 0xFFFFFFFFFFFFEULL - b.v[1];
    r.v[2] = a.v[2] + 0xFFFFFFFFFFFFEULL - b.v[2];
    r.v[3] = a.v[3] + 0xFFFFFFFFFFFFEULL - b.v[3];
    r.v[4] = a.v[4] + 0xFFFFFFFFFFFFEULL - b.v[4];
    fe_reduce(r);
}

static inline void fe_neg(fe &r, const fe &a) { fe_sub(r, FE_ZERO, a); }

static void fe_mul(fe &r, const fe &a, const fe &b) {
    const u64 a0 = a.v[0], a1 = a.v[1], a2 = a.v[2], a3 = a.v[3], a4 = a.v[4];
    const u64 b0 = b.v[0], b1 = b.v[1], b2 = b.v[2], b3 = b.v[3], b4 = b.v[4];
    const u64 b1_19 = b1 * 19, b2_19 = b2 * 19, b3_19 = b3 * 19, b4_19 = b4 * 19;

    u128 t0 = (u128)a0 * b0 + (u128)a1 * b4_19 + (u128)a2 * b3_19 +
              (u128)a3 * b2_19 + (u128)a4 * b1_19;
    u128 t1 = (u128)a0 * b1 + (u128)a1 * b0 + (u128)a2 * b4_19 +
              (u128)a3 * b3_19 + (u128)a4 * b2_19;
    u128 t2 = (u128)a0 * b2 + (u128)a1 * b1 + (u128)a2 * b0 +
              (u128)a3 * b4_19 + (u128)a4 * b3_19;
    u128 t3 = (u128)a0 * b3 + (u128)a1 * b2 + (u128)a2 * b1 +
              (u128)a3 * b0 + (u128)a4 * b4_19;
    u128 t4 = (u128)a0 * b4 + (u128)a1 * b3 + (u128)a2 * b2 +
              (u128)a3 * b1 + (u128)a4 * b0;

    u64 c;
    r.v[0] = (u64)t0 & MASK51; c = (u64)(t0 >> 51);
    t1 += c; r.v[1] = (u64)t1 & MASK51; c = (u64)(t1 >> 51);
    t2 += c; r.v[2] = (u64)t2 & MASK51; c = (u64)(t2 >> 51);
    t3 += c; r.v[3] = (u64)t3 & MASK51; c = (u64)(t3 >> 51);
    t4 += c; r.v[4] = (u64)t4 & MASK51; c = (u64)(t4 >> 51);
    r.v[0] += 19 * c;
    c = r.v[0] >> 51; r.v[0] &= MASK51; r.v[1] += c;
}

static inline void fe_sq(fe &r, const fe &a) { fe_mul(r, a, a); }

static void fe_sqn(fe &r, const fe &a, int n) {
    fe_sq(r, a);
    for (int i = 1; i < n; i++) fe_sq(r, r);
}

// z^(2^250 - 1) — the shared tail of the inversion and sqrt chains
static void fe_pow_2_250_1(fe &out, fe &t0_out, const fe &z) {
    fe t0, t1, t2, t3;
    fe_sq(t0, z);                  // z^2
    fe_sqn(t1, t0, 2);             // z^8
    fe_mul(t1, z, t1);             // z^9
    fe_mul(t0, t0, t1);            // z^11
    fe_sq(t2, t0);                 // z^22
    fe_mul(t1, t1, t2);            // z^31 = z^(2^5-1)
    fe_sqn(t2, t1, 5);
    fe_mul(t1, t2, t1);            // z^(2^10-1)
    fe_sqn(t2, t1, 10);
    fe_mul(t2, t2, t1);            // z^(2^20-1)
    fe_sqn(t3, t2, 20);
    fe_mul(t2, t3, t2);            // z^(2^40-1)
    fe_sqn(t2, t2, 10);
    fe_mul(t1, t2, t1);            // z^(2^50-1)
    fe_sqn(t2, t1, 50);
    fe_mul(t2, t2, t1);            // z^(2^100-1)
    fe_sqn(t3, t2, 100);
    fe_mul(t2, t3, t2);            // z^(2^200-1)
    fe_sqn(t2, t2, 50);
    fe_mul(out, t2, t1);           // z^(2^250-1)
    t0_out = t0;                   // z^11, reused by fe_invert
}

static void fe_invert(fe &r, const fe &z) {
    fe t, z11;
    fe_pow_2_250_1(t, z11, z);
    fe_sqn(t, t, 5);               // z^(2^255 - 32)
    fe_mul(r, t, z11);             // z^(2^255 - 21) = z^(p-2)
}

// z^((p-5)/8) = z^(2^252 - 3)
static void fe_pow22523(fe &r, const fe &z) {
    fe t, z11;
    fe_pow_2_250_1(t, z11, z);
    fe_sqn(t, t, 2);               // z^(2^252 - 4)
    fe_mul(r, t, z);               // z^(2^252 - 3)
}

// canonical little-endian bytes (freeze mod p)
static void fe_tobytes(uint8_t out[32], const fe &a) {
    fe t = a;
    fe_reduce(t);
    fe_reduce(t);
    u64 q = (t.v[0] + 19) >> 51;
    q = (t.v[1] + q) >> 51;
    q = (t.v[2] + q) >> 51;
    q = (t.v[3] + q) >> 51;
    q = (t.v[4] + q) >> 51;
    t.v[0] += 19 * q;
    u64 c;
    c = t.v[0] >> 51; t.v[0] &= MASK51; t.v[1] += c;
    c = t.v[1] >> 51; t.v[1] &= MASK51; t.v[2] += c;
    c = t.v[2] >> 51; t.v[2] &= MASK51; t.v[3] += c;
    c = t.v[3] >> 51; t.v[3] &= MASK51; t.v[4] += c;
    t.v[4] &= MASK51;
    u64 w0 = t.v[0] | (t.v[1] << 51);
    u64 w1 = (t.v[1] >> 13) | (t.v[2] << 38);
    u64 w2 = (t.v[2] >> 26) | (t.v[3] << 25);
    u64 w3 = (t.v[3] >> 39) | (t.v[4] << 12);
    memcpy(out, &w0, 8);
    memcpy(out + 8, &w1, 8);
    memcpy(out + 16, &w2, 8);
    memcpy(out + 24, &w3, 8);
}

static void fe_frombytes(fe &r, const uint8_t in[32]) {
    u64 w0, w1, w2, w3;
    memcpy(&w0, in, 8);
    memcpy(&w1, in + 8, 8);
    memcpy(&w2, in + 16, 8);
    memcpy(&w3, in + 24, 8);
    r.v[0] = w0 & MASK51;
    r.v[1] = ((w0 >> 51) | (w1 << 13)) & MASK51;
    r.v[2] = ((w1 >> 38) | (w2 << 26)) & MASK51;
    r.v[3] = ((w2 >> 25) | (w3 << 39)) & MASK51;
    r.v[4] = (w3 >> 12) & MASK51;  // drops bit 255 (the sign bit)
}

static bool fe_is_zero(const fe &a) {
    uint8_t b[32];
    fe_tobytes(b, a);
    uint8_t acc = 0;
    for (int i = 0; i < 32; i++) acc |= b[i];
    return acc == 0;
}

static bool fe_eq(const fe &a, const fe &b) {
    fe t;
    fe_sub(t, a, b);
    return fe_is_zero(t);
}

// ---------------------------------------------------------------- group

struct ge {
    fe X, Y, Z, T;  // extended homogeneous, T = XY/Z
};

static const ge GE_IDENTITY = {FE_ZERO, FE_ONE, FE_ONE, FE_ZERO};

// complete a=-1 addition (add-2008-hwcd-3 with precomputed 2d)
static void ge_add(ge &r, const ge &p, const ge &q) {
    fe a, b, c, d, e, f, g, h, t;
    fe_sub(a, p.Y, p.X);
    fe_sub(t, q.Y, q.X);
    fe_mul(a, a, t);
    fe_add(b, p.Y, p.X);
    fe_add(t, q.Y, q.X);
    fe_mul(b, b, t);
    fe_mul(c, p.T, FE_D2);
    fe_mul(c, c, q.T);
    fe_add(d, p.Z, p.Z);
    fe_mul(d, d, q.Z);
    fe_sub(e, b, a);
    fe_sub(f, d, c);
    fe_add(g, d, c);
    fe_add(h, b, a);
    fe_mul(r.X, e, f);
    fe_mul(r.Y, g, h);
    fe_mul(r.Z, f, g);
    fe_mul(r.T, e, h);
}

// dbl-2008-hwcd (a=-1): A=X^2 B=Y^2 C=2Z^2 E=(X+Y)^2-A-B G=B-A F=G-C H=-(A+B)
static void ge_dbl(ge &r, const ge &p) {
    fe a, b, c, e, f, g, h, t;
    fe_sq(a, p.X);
    fe_sq(b, p.Y);
    fe_sq(c, p.Z);
    fe_add(c, c, c);
    fe_add(t, p.X, p.Y);
    fe_sq(t, t);
    fe_add(e, a, b);
    fe_sub(e, t, e);
    fe_sub(g, b, a);
    fe_sub(f, g, c);
    fe_add(h, a, b);
    fe_neg(h, h);
    fe_mul(r.X, e, f);
    fe_mul(r.Y, g, h);
    fe_mul(r.Z, f, g);
    fe_mul(r.T, e, h);
}

static void ge_neg(ge &r, const ge &p) {
    fe_neg(r.X, p.X);
    r.Y = p.Y;
    r.Z = p.Z;
    fe_neg(r.T, p.T);
}

static bool ge_is_identity(const ge &p) {
    // (X:Y:Z) == (0:1:1) projectively: X == 0 and Y == Z
    return fe_is_zero(p.X) && fe_eq(p.Y, p.Z);
}

static bool ge_eq(const ge &p, const ge &q) {
    fe a, b;
    fe_mul(a, p.X, q.Z);
    fe_mul(b, q.X, p.Z);
    if (!fe_eq(a, b)) return false;
    fe_mul(a, p.Y, q.Z);
    fe_mul(b, q.Y, p.Z);
    return fe_eq(a, b);
}

// RFC 8032 §5.1.3 decompression; returns false on invalid encodings with
// the same edge semantics as crypto/_fallback.py::_recover_x.
static bool ge_decompress(ge &r, const uint8_t enc[32]) {
    int sign = enc[31] >> 7;
    fe y;
    fe_frombytes(y, enc);

    // canonical check: the masked 255-bit value must be < p
    {
        uint8_t canon[32];
        fe_tobytes(canon, y);
        uint8_t masked[32];
        memcpy(masked, enc, 32);
        masked[31] &= 0x7F;
        if (memcmp(canon, masked, 32) != 0) return false;  // y >= p
    }

    fe yy, u, v;
    fe_sq(yy, y);
    fe_sub(u, yy, FE_ONE);            // y^2 - 1
    fe_mul(v, yy, FE_D);
    fe_add(v, v, FE_ONE);             // d y^2 + 1

    // x = u v^3 (u v^7)^((p-5)/8)
    fe v3, v7, x, t;
    fe_sq(v3, v);
    fe_mul(v3, v3, v);
    fe_sq(v7, v3);
    fe_mul(v7, v7, v);
    fe_mul(t, u, v7);
    fe_pow22523(t, t);
    fe_mul(x, u, v3);
    fe_mul(x, x, t);

    fe vxx, neg_u;
    fe_sq(vxx, x);
    fe_mul(vxx, v, vxx);
    fe_neg(neg_u, u);
    if (!fe_eq(vxx, u)) {
        if (!fe_eq(vxx, neg_u)) return false;  // x^2 not a square
        fe_mul(x, x, FE_SQRTM1);
    }

    uint8_t xb[32];
    fe_tobytes(xb, x);
    bool x_zero = true;
    for (int i = 0; i < 32; i++)
        if (xb[i]) { x_zero = false; break; }
    if (x_zero && sign) return false;  // -0 encoding (RFC 8032 step 4)
    if ((xb[0] & 1) != sign) fe_neg(x, x);

    r.X = x;
    r.Y = y;
    r.Z = FE_ONE;
    fe_mul(r.T, x, y);
    return true;
}

static void ge_compress(uint8_t out[32], const ge &p) {
    fe zinv, x, y;
    fe_invert(zinv, p.Z);
    fe_mul(x, p.X, zinv);
    fe_mul(y, p.Y, zinv);
    fe_tobytes(out, y);
    uint8_t xb[32];
    fe_tobytes(xb, x);
    out[31] |= (xb[0] & 1) << 7;
}

// ------------------------------------------------- scalar multiplication

// group order L = 2^252 + 27742317777372353535851937790883648493, LE bytes
static const uint8_t L_BYTES[32] = {
    0xed, 0xd3, 0xf5, 0x5c, 0x1a, 0x63, 0x12, 0x58,
    0xd6, 0x9c, 0xf7, 0xa2, 0xde, 0xf9, 0xde, 0x14,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x10};

// r = (a + b) mod L for 32-byte LE scalars a, b < L
static void sc_add_mod_l(uint8_t r[32], const uint8_t a[32],
                         const uint8_t b[32]) {
    u64 aw[4], bw[4], lw[4], s[4];
    memcpy(aw, a, 32);
    memcpy(bw, b, 32);
    memcpy(lw, L_BYTES, 32);
    u128 c = 0;
    for (int i = 0; i < 4; i++) {
        c += (u128)aw[i] + bw[i];
        s[i] = (u64)c;
        c >>= 64;
    }
    // sum < 2L < 2^254: at most one subtraction of L needed
    bool ge = true;
    for (int i = 3; i >= 0; i--) {
        if (s[i] > lw[i]) break;
        if (s[i] < lw[i]) { ge = false; break; }
    }
    if (ge) {
        u128 borrow = 0;
        for (int i = 0; i < 4; i++) {
            u128 d = (u128)s[i] - lw[i] - borrow;
            s[i] = (u64)d;
            borrow = (d >> 64) ? 1 : 0;
        }
    }
    memcpy(r, s, 32);
}

// [k]P by plain double-and-add over big-endian bits of a 32-byte LE scalar.
// Verification-side: scalars are public, no constant-time requirement.
static void ge_scalarmul(ge &r, const ge &p, const uint8_t sc[32]) {
    ge acc = GE_IDENTITY;
    bool started = false;
    for (int byte = 31; byte >= 0; byte--) {
        for (int bit = 7; bit >= 0; bit--) {
            if (started) ge_dbl(acc, acc);
            if ((sc[byte] >> bit) & 1) {
                if (started) ge_add(acc, acc, p);
                else { acc = p; started = true; }
            }
        }
    }
    r = started ? acc : GE_IDENTITY;
}

static bool ge_mul_l_is_identity(const ge &p) {
    ge t;
    ge_scalarmul(t, p, L_BYTES);
    return ge_is_identity(t);
}

// ------------------------------------------------------- Pippenger MSM

// signed base-256 recoding of a 32-byte LE scalar: digits in [-128, 128),
// at most 33 digits (carry out of byte 31)
static void recode_signed(int16_t out[33], const uint8_t sc[32]) {
    int carry = 0;
    for (int i = 0; i < 32; i++) {
        int t = sc[i] + carry;
        if (t >= 128) {
            out[i] = (int16_t)(t - 256);
            carry = 1;
        } else {
            out[i] = (int16_t)t;
            carry = 0;
        }
    }
    out[32] = (int16_t)carry;
}

// acc += sum_i [scalars_i] pts_i over lanes with active[i] != 0.
// n_digits: 17 covers 128-bit scalars (+ carry), 33 covers 256-bit.
static void msm_accumulate(ge &acc, const ge *pts, const uint8_t *scalars,
                           const uint8_t *active, u64 n, int n_digits) {
    std::vector<int16_t> digits(n * 33);
    for (u64 i = 0; i < n; i++) {
        if (active && !active[i]) {
            memset(&digits[i * 33], 0, 33 * sizeof(int16_t));
            continue;
        }
        recode_signed(&digits[i * 33], scalars + i * 32);
    }

    ge buckets[128];
    bool used[128];
    ge local = GE_IDENTITY;
    bool acc_started = false;

    for (int w = n_digits - 1; w >= 0; w--) {
        if (acc_started)
            for (int k = 0; k < 8; k++) ge_dbl(local, local);
        memset(used, 0, sizeof(used));
        int max_b = -1;
        for (u64 i = 0; i < n; i++) {
            int d = digits[i * 33 + w];
            if (d == 0) continue;
            int b;
            ge p;
            if (d > 0) {
                b = d - 1;
                p = pts[i];
            } else {
                b = -d - 1;
                ge_neg(p, pts[i]);
            }
            if (used[b]) ge_add(buckets[b], buckets[b], p);
            else { buckets[b] = p; used[b] = true; }
            if (b > max_b) max_b = b;
        }
        if (max_b < 0) continue;
        // window sum = sum_b (b+1) * buckets[b] via running suffix sums
        ge run, wsum;
        bool run_started = false, wsum_started = false;
        for (int b = max_b; b >= 0; b--) {
            if (used[b]) {
                if (run_started) ge_add(run, run, buckets[b]);
                else { run = buckets[b]; run_started = true; }
            }
            if (run_started) {
                if (wsum_started) ge_add(wsum, wsum, run);
                else { wsum = run; wsum_started = true; }
            }
        }
        if (wsum_started) {
            if (acc_started) ge_add(local, local, wsum);
            else { local = wsum; acc_started = true; }
        }
    }
    if (acc_started) ge_add(acc, acc, local);
}

// ------------------------------------------------------------ base point

// B: y = 4/5, x even (RFC 8032), compressed encoding
static const uint8_t B_ENC[32] = {
    0x58, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66,
    0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66,
    0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66,
    0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66};

static ge BASE_POINT;
// eager init at dlopen time: no lazy races between verifier threads
static const bool BASE_READY = ge_decompress(BASE_POINT, B_ENC);

static const ge &base_point() { return BASE_POINT; }

// ------------------------------------------------------------- exports

extern "C" {

// out[i]: 0 = bad encoding, 1 = decompresses but carries torsion,
//         2 = certified torsion-free (exact [L]P == identity)
void at2_rlc_certify(const uint8_t *enc, u64 n, uint8_t *out) {
    for (u64 i = 0; i < n; i++) {
        ge p;
        if (!ge_decompress(p, enc + i * 32)) {
            out[i] = 0;
            continue;
        }
        out[i] = ge_mul_l_is_identity(p) ? 2 : 1;
    }
}

// One RLC check over n lanes.
//   r_enc, a_enc : n*32 compressed R_i / A_i
//   z_sc         : n*32 LE scalars z_i (128-bit, high half zero)
//   zh_sc        : n*32 LE scalars z_i*h_i mod L
//   zs_sc        : n*32 LE scalars z_i*s_i mod L (summed here over the
//                  lanes that actually decompress, so a bad encoding
//                  never unbalances the equation for the others)
//   valid        : n lane mask (0 lanes are excluded entirely)
//   tors         : k_rounds*n coefficients in [0,8) for the R-side
//                  randomized torsion rounds (row-major by round)
//   decomp_ok    : out, n — 1 when both R_i and A_i decompressed
// Returns 1 when the equation holds AND every torsion round folds to a
// point killed by [L], over lanes with valid && decomp_ok; 0 otherwise.
// Callers must treat decomp_ok[i]==0 lanes as individually invalid.
int at2_rlc_verify(const uint8_t *r_enc, const uint8_t *a_enc,
                   const uint8_t *z_sc, const uint8_t *zh_sc,
                   const uint8_t *zs_sc, const uint8_t *valid,
                   const uint8_t *tors, u64 k_rounds, u64 n,
                   uint8_t *decomp_ok) {
    if (n == 0) return 1;
    std::vector<ge> R(n), A(n);
    std::vector<uint8_t> active(n);
    u64 n_active = 0;
    for (u64 i = 0; i < n; i++) {
        if (!valid[i]) {
            decomp_ok[i] = 1;  // excluded lane: nothing to report
            active[i] = 0;
            continue;
        }
        bool ok = ge_decompress(R[i], r_enc + i * 32) &&
                  ge_decompress(A[i], a_enc + i * 32);
        decomp_ok[i] = ok ? 1 : 0;
        active[i] = ok ? 1 : 0;
        if (ok) n_active++;
    }
    if (n_active == 0) return 1;  // empty equation holds

    // RHS = sum [z_i] R_i + sum [z_i h_i] A_i
    ge rhs = GE_IDENTITY;
    msm_accumulate(rhs, R.data(), z_sc, active.data(), n, 17);
    msm_accumulate(rhs, A.data(), zh_sc, active.data(), n, 33);

    // LHS = [sum z_i s_i] B over the active lanes
    uint8_t zs[32] = {0};
    for (u64 i = 0; i < n; i++)
        if (active[i]) sc_add_mod_l(zs, zs, zs_sc + i * 32);
    ge lhs;
    ge_scalarmul(lhs, base_point(), zs);
    if (!ge_eq(lhs, rhs)) return 0;

    // R-side randomized torsion rounds: per-lane table of 1..7 multiples,
    // then k folds each killed by [L]
    std::vector<ge> tab(n * 7);
    for (u64 i = 0; i < n; i++) {
        if (!active[i]) continue;
        ge *t = &tab[i * 7];
        t[0] = R[i];
        ge_dbl(t[1], t[0]);          // 2R
        ge_add(t[2], t[1], t[0]);    // 3R
        ge_dbl(t[3], t[1]);          // 4R
        ge_add(t[4], t[3], t[0]);    // 5R
        ge_dbl(t[5], t[2]);          // 6R
        ge_add(t[6], t[5], t[0]);    // 7R
    }
    for (u64 r = 0; r < k_rounds; r++) {
        const uint8_t *c = tors + r * n;
        ge s = GE_IDENTITY;
        bool started = false;
        for (u64 i = 0; i < n; i++) {
            if (!active[i]) continue;
            int ci = c[i] & 7;
            if (ci == 0) continue;
            const ge &m = tab[i * 7 + (ci - 1)];
            if (started) ge_add(s, s, m);
            else { s = m; started = true; }
        }
        if (started && !ge_mul_l_is_identity(s)) return 0;
    }
    return 1;
}

// [k]P on a compressed point; returns 0 on bad encoding. Test hook for
// differential validation against the pure-python group law.
int at2_rlc_scalarmul(const uint8_t *enc, const uint8_t *sc, uint8_t *out) {
    ge p, r;
    if (!ge_decompress(p, enc)) return 0;
    ge_scalarmul(r, p, sc);
    ge_compress(out, r);
    return 1;
}

// decompression verdict alone (test hook)
int at2_rlc_decompress_check(const uint8_t *enc) {
    ge p;
    return ge_decompress(p, enc) ? 1 : 0;
}

// built-in sanity: field, decompression, group law, MSM, order
int at2_rlc_selftest() {
    // (p-1) + 2 == 1
    fe pm1 = {{MASK51 - 19, MASK51, MASK51, MASK51, MASK51}};
    fe two = FE_ONE, r;
    fe_add(two, FE_ONE, FE_ONE);
    fe_add(r, pm1, two);
    if (!fe_eq(r, FE_ONE)) return 1;
    // sqrt(-1)^2 == -1
    fe m1;
    fe_neg(m1, FE_ONE);
    fe_sq(r, FE_SQRTM1);
    if (!fe_eq(r, m1)) return 2;
    // base decompresses and [L]B == identity
    const ge &B = base_point();
    uint8_t benc[32];
    ge_compress(benc, B);
    if (memcmp(benc, B_ENC, 32) != 0) return 3;
    if (!ge_mul_l_is_identity(B)) return 4;
    // [2]B + [3]B == [5]B, dbl vs add agreement
    ge b2a, b2d, b3, b5a, b5b;
    ge_add(b2a, B, B);
    ge_dbl(b2d, B);
    if (!ge_eq(b2a, b2d)) return 5;
    ge_add(b3, b2d, B);
    ge_add(b5a, b2d, b3);
    uint8_t five[32] = {5};
    ge_scalarmul(b5b, B, five);
    if (!ge_eq(b5a, b5b)) return 6;
    // MSM: [2]B + [3]B via msm == [5]B
    ge pts[2] = {B, B};
    uint8_t scs[64] = {0};
    scs[0] = 2;
    scs[32] = 3;
    ge acc = GE_IDENTITY;
    msm_accumulate(acc, pts, scs, nullptr, 2, 33);
    if (!ge_eq(acc, b5b)) return 7;
    return 0;
}

}  // extern "C"
