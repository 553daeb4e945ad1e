// Per-lane ed25519 verification math: GF(2^255-19), extended Edwards
// points, RFC 8032 decompression and the 64-window Straus double-scalar
// multiplication, for ONE signature per call.
//
// The same source builds two ways: under nvcc every function is
// __host__ __device__ and ed25519_verify.cu runs it one signature per
// thread; under g++ the functions are plain inline and
// ed25519_lane_host.cpp builds a ctypes library that the CPU tests hold
// against the plain PyTorch version (ops/field.py, ops/edwards.py,
// ops/ed25519.py), whose formulas this file follows operation for
// operation.
//
// Field elements: 10 int32 limbs in the ref10 layout (limb i at bit
// ceil(25.5 i), 26 bits when i is even, 25 when odd). Every function keeps
// invariant W: each limb in [0, 2^w + 2^18]. Products accumulate in int64
// (10 terms of at most 2^57.3, below 2^61). Subtraction adds 4p limb by
// limb so limbs never go negative. All control flow is independent of the
// lane's data: choices are selects, and the only data-indexed accesses are
// the two window-table lookups (the data is public).

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define LANE_FN __host__ __device__ __forceinline__
// called many times: kept out of line so the kernel stays a few thousand
// instructions and nvcc builds it in seconds
#define LANE_FN_CALL __host__ __device__ __noinline__
#else
#define LANE_FN inline
#define LANE_FN_CALL inline
#endif

namespace ed25519_lane {

constexpr int NL = 10;
constexpr int ROW_BYTES = 129;  // a(32) | r(32) | s(32) | h(32) | valid(1)

// Layout of the int32 constants the caller passes in (ops/cuda_verify.py
// lane_consts): d, 2d, sqrt(-1), then the base table, multiples 0..15 of B
// as (X, Y, Z, T) limb vectors.
constexpr int CONST_D = 0;
constexpr int CONST_D2 = 10;
constexpr int CONST_SQRT_M1 = 20;
constexpr int CONST_BTABLE = 30;
constexpr int CONST_WORDS = 30 + 16 * 4 * NL;

struct Fe {
  int32_t v[NL];
};

struct Pt {
  Fe x, y, z, t;
};

LANE_FN int width(int i) { return (i & 1) ? 25 : 26; }

LANE_FN Fe fe_load(const int32_t* p) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NL; i++) r.v[i] = p[i];
  return r;
}

LANE_FN Fe fe_small(int32_t x) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NL; i++) r.v[i] = 0;
  r.v[0] = x;
  return r;
}

// One parallel carry round: each limb keeps its low w bits and passes the
// rest up; limb 9's carry has weight 2^255 = 19 (mod p) and folds into 0.
LANE_FN void carry_round(int64_t h[NL]) {
  int64_t c[NL];
#pragma unroll
  for (int i = 0; i < NL; i++) {
    c[i] = h[i] >> width(i);
    h[i] -= c[i] << width(i);
  }
  h[0] += 19 * c[NL - 1];
#pragma unroll
  for (int i = 1; i < NL; i++) h[i] += c[i - 1];
}

LANE_FN Fe fe_from64(int64_t h[NL]) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NL; i++) r.v[i] = (int32_t)h[i];
  return r;
}

LANE_FN Fe fe_add(const Fe& a, const Fe& b) {
  int64_t h[NL];
#pragma unroll
  for (int i = 0; i < NL; i++) h[i] = (int64_t)a.v[i] + b.v[i];
  carry_round(h);
  return fe_from64(h);
}

// 4p limb by limb: [4(2^26-19), 4(2^25-1), 4(2^26-1), 4(2^25-1), ...]
LANE_FN int64_t bias_4p(int i) {
  return i == 0 ? 4 * ((1LL << 26) - 19) : 4 * ((1LL << width(i)) - 1);
}

LANE_FN Fe fe_sub(const Fe& a, const Fe& b) {
  int64_t h[NL];
#pragma unroll
  for (int i = 0; i < NL; i++) h[i] = (int64_t)a.v[i] - b.v[i] + bias_4p(i);
  carry_round(h);
  return fe_from64(h);
}

LANE_FN Fe fe_neg(const Fe& a) { return fe_sub(fe_small(0), a); }

// Schoolbook product: f_i g_j lands in limb (i + j) mod 10, doubled when i
// and j are both odd, times 19 when i + j >= 10. Then two carry rounds.
LANE_FN Fe fe_mul(const Fe& f, const Fe& g) {
  int32_t f2[NL], g19[NL];
#pragma unroll
  for (int i = 0; i < NL; i++) {
    f2[i] = 2 * f.v[i];
    g19[i] = 19 * g.v[i];
  }
  int64_t h[NL];
#pragma unroll
  for (int k = 0; k < NL; k++) h[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
#pragma unroll
    for (int j = 0; j < NL; j++) {
      const int32_t a = (i & j & 1) ? f2[i] : f.v[i];
      const int32_t b = (i + j >= NL) ? g19[j] : g.v[j];
      h[(i + j) % NL] += (int64_t)a * b;
    }
  }
  carry_round(h);
  carry_round(h);
  return fe_from64(h);
}

LANE_FN Fe fe_sq(const Fe& a) { return fe_mul(a, a); }

LANE_FN Fe fe_pow2k(Fe x, int k) {
  for (int i = 0; i < k; i++) x = fe_sq(x);
  return x;
}

// x^((p-5)/8) = x^(2^252 - 3), the square-root exponent (RFC 8032).
LANE_FN_CALL Fe fe_pow22523(const Fe& x) {
  Fe z2 = fe_sq(x);
  Fe z9 = fe_mul(x, fe_pow2k(z2, 2));
  Fe z11 = fe_mul(z2, z9);
  Fe z_5_0 = fe_mul(z9, fe_sq(z11));
  Fe z_10_0 = fe_mul(fe_pow2k(z_5_0, 5), z_5_0);
  Fe z_20_0 = fe_mul(fe_pow2k(z_10_0, 10), z_10_0);
  Fe z_40_0 = fe_mul(fe_pow2k(z_20_0, 20), z_20_0);
  Fe z_50_0 = fe_mul(fe_pow2k(z_40_0, 10), z_10_0);
  Fe z_100_0 = fe_mul(fe_pow2k(z_50_0, 50), z_50_0);
  Fe z_200_0 = fe_mul(fe_pow2k(z_100_0, 100), z_100_0);
  Fe z_250_0 = fe_mul(fe_pow2k(z_200_0, 50), z_50_0);
  return fe_mul(fe_pow2k(z_250_0, 2), x);
}

// The unique representative in [0, p) (ref10 fe_tobytes): q = floor(x/p)
// is 0 or 1 and comes out of the carry of x + 19 through every limb; then
// x + 19q carried exactly and cut to 255 bits is x - qp.
LANE_FN_CALL Fe fe_canonical(const Fe& x) {
  int64_t h[NL];
#pragma unroll
  for (int i = 0; i < NL; i++) h[i] = x.v[i];
  carry_round(h);
  carry_round(h);
  int64_t q = (19 * h[NL - 1] + (1LL << 24)) >> 25;
#pragma unroll
  for (int i = 0; i < NL; i++) q = (h[i] + q) >> width(i);
  h[0] += 19 * q;
#pragma unroll
  for (int i = 0; i < NL - 1; i++) {
    int64_t c = h[i] >> width(i);
    h[i] -= c << width(i);
    h[i + 1] += c;
  }
  h[NL - 1] &= (1LL << 25) - 1;
  return fe_from64(h);
}

LANE_FN bool fe_is_zero_canonical(const Fe& c) {
  int32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) acc |= c.v[i];
  return acc == 0;
}

LANE_FN bool fe_eq(const Fe& a, const Fe& b) {
  Fe ca = fe_canonical(a), cb = fe_canonical(b);
  int32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) acc |= ca.v[i] ^ cb.v[i];
  return acc == 0;
}

LANE_FN Fe fe_select(bool c, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NL; i++) r.v[i] = c ? a.v[i] : b.v[i];
  return r;
}

// 32 little-endian bytes -> limbs, with bit 255 (the sign) cleared.
LANE_FN Fe fe_from_bytes(const uint8_t* b) {
  Fe r;
  int off = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    const int w = width(i);
    int64_t v = 0;
#pragma unroll
    for (int k = off / 8; k < 32 && 8 * k < off + w; k++) {
      int64_t byte = (k == 31) ? (b[k] & 0x7F) : b[k];
      const int shift = 8 * k - off;
      v |= shift >= 0 ? (byte << shift) : (byte >> -shift);
    }
    r.v[i] = (int32_t)(v & ((1LL << w) - 1));
    off += w;
  }
  return r;
}

// -- points (a = -1, extended coordinates) -------------------------------

LANE_FN Pt pt_load(const int32_t* p) {
  Pt r;
  r.x = fe_load(p);
  r.y = fe_load(p + NL);
  r.z = fe_load(p + 2 * NL);
  r.t = fe_load(p + 3 * NL);
  return r;
}

LANE_FN Pt pt_identity() {
  Pt r;
  r.x = fe_small(0);
  r.y = fe_small(1);
  r.z = fe_small(1);
  r.t = fe_small(0);
  return r;
}

LANE_FN Pt pt_finish(const Fe& e, const Fe& f, const Fe& g, const Fe& h) {
  Pt r;
  r.x = fe_mul(e, f);
  r.y = fe_mul(g, h);
  r.z = fe_mul(f, g);
  r.t = fe_mul(e, h);
  return r;
}

// Complete addition, 8M + 1 constant mul.
LANE_FN_CALL Pt pt_add(const Pt& p, const Pt& q, const Fe& d2) {
  Fe a = fe_mul(fe_sub(p.y, p.x), fe_sub(q.y, q.x));
  Fe b = fe_mul(fe_add(p.y, p.x), fe_add(q.y, q.x));
  Fe c = fe_mul(fe_mul(p.t, d2), q.t);
  Fe d = fe_mul(fe_add(p.z, p.z), q.z);
  return pt_finish(fe_sub(b, a), fe_sub(d, c), fe_add(d, c), fe_add(b, a));
}

// Unified doubling, 4M + 4S.
LANE_FN_CALL Pt pt_double(const Pt& p) {
  Fe a = fe_sq(p.x);
  Fe b = fe_sq(p.y);
  Fe zz = fe_sq(p.z);
  Fe c = fe_add(zz, zz);
  Fe h = fe_add(a, b);
  Fe e = fe_sub(h, fe_sq(fe_add(p.x, p.y)));
  Fe g = fe_sub(a, b);
  return pt_finish(e, fe_add(c, g), g, h);
}

LANE_FN Pt pt_select(bool c, const Pt& a, const Pt& b) {
  Pt r;
  r.x = fe_select(c, a.x, b.x);
  r.y = fe_select(c, a.y, b.y);
  r.z = fe_select(c, a.z, b.z);
  r.t = fe_select(c, a.t, b.t);
  return r;
}

// RFC 8032 §5.1.3 decompression. Returns false for a non-canonical y
// (y >= p), a non-square x^2, or x = 0 with the sign bit set; the point is
// then the base point, so the math that follows stays on the curve.
LANE_FN_CALL bool decompress(const uint8_t* enc, const int32_t* consts, Pt* out) {
  const int sign = enc[31] >> 7;
  const Fe y = fe_from_bytes(enc);

  // y < p  <=>  y + 19 does not carry out of bit 255
  int64_t carry = 19;
#pragma unroll
  for (int i = 0; i < NL; i++) carry = (y.v[i] + carry) >> width(i);
  const bool y_canonical = carry == 0;

  const Fe one = fe_small(1);
  const Fe yy = fe_sq(y);
  const Fe u = fe_sub(yy, one);                                   // y^2 - 1
  const Fe v = fe_add(fe_mul(yy, fe_load(consts + CONST_D)), one);  // d y^2 + 1

  // x = u v^3 (u v^7)^((p-5)/8)
  const Fe v3 = fe_mul(fe_sq(v), v);
  const Fe v7 = fe_mul(fe_sq(v3), v);
  Fe x = fe_mul(fe_mul(u, v3), fe_pow22523(fe_mul(u, v7)));

  const Fe vxx = fe_mul(v, fe_sq(x));
  const bool root_ok = fe_eq(vxx, u);
  const bool flipped_ok = fe_eq(vxx, fe_neg(u));
  x = fe_select(root_ok, x, fe_mul(x, fe_load(consts + CONST_SQRT_M1)));

  const Fe x_can = fe_canonical(x);
  const bool x_is_zero = fe_is_zero_canonical(x_can);
  const bool ok = y_canonical & (root_ok | flipped_ok) & !(x_is_zero & (sign == 1));

  const bool flip = (x_can.v[0] & 1) != sign;
  x = fe_select(flip, fe_neg(x), x);

  Pt pt;
  pt.x = x;
  pt.y = y;
  pt.z = one;
  pt.t = fe_mul(x, y);
  *out = pt_select(ok, pt, pt_load(consts + CONST_BTABLE + 4 * NL));
  return ok;
}

LANE_FN int nibble(const uint8_t* scalar_le, int idx) {
  const int byte = scalar_le[idx >> 1];
  return (idx & 1) ? (byte >> 4) : (byte & 0x0F);
}

// The verdict of one packed row: [S]B + [h](-A) == R (the RFC 8032
// cofactorless check) AND valid AND both points decoded.
LANE_FN bool lane_verify(const uint8_t* row, const int32_t* consts) {
  const Fe d2 = fe_load(consts + CONST_D2);
  Pt a_pt, r_pt;
  const bool a_ok = decompress(row, consts, &a_pt);
  const bool r_ok = decompress(row + 32, consts, &r_pt);

  Pt neg_a = a_pt;
  neg_a.x = fe_neg(a_pt.x);
  neg_a.t = fe_neg(a_pt.t);

  // multiples 0..15 of -A: evens by doubling, odds by one addition
  Pt table[16];
  table[0] = pt_identity();
  table[1] = neg_a;
  for (int k = 1; k < 8; k++) {
    table[2 * k] = pt_double(table[k]);
    table[2 * k + 1] = pt_add(table[2 * k], neg_a, d2);
  }

  // interleaved Straus, most significant window first: window w reads
  // nibble 63 - w of the little-endian scalars
  const uint8_t* s_le = row + 64;
  const uint8_t* h_le = row + 96;
  Pt acc = pt_identity();
  for (int w = 0; w < 64; w++) {
    acc = pt_double(pt_double(pt_double(pt_double(acc))));
    const int idx = 63 - w;
    acc = pt_add(acc, table[nibble(h_le, idx)], d2);
    acc = pt_add(acc, pt_load(consts + CONST_BTABLE + 4 * NL * nibble(s_le, idx)), d2);
  }

  // projective compare with the affine R (its Z is 1)
  const bool matches = fe_eq(acc.x, fe_mul(r_pt.x, acc.z)) & fe_eq(acc.y, fe_mul(r_pt.y, acc.z));
  return (row[128] != 0) & a_ok & r_ok & matches;
}

}  // namespace ed25519_lane
