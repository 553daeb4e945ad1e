// ed25519 verification math for the Hopper kernel: GF(2^255-19), RFC 8032
// decompression, and the extended-coordinate point operations run by a
// "quad", four threads that verify one signature together.
//
// The same source builds two ways. Under nvcc the quad functions are
// __device__ and each thread of a quad runs one role (its lane mod 4);
// operands move between roles with __shfl_sync(.., width 4) on the int32
// limbs. Under g++ a host quad runs the four roles in lockstep: a quad
// variable (QFe) holds one value per role, every phase runs for roles 0..3
// before the next reads across roles, and an exchange reads the other
// role's slot. ed25519_lane_host.cpp builds that into a ctypes library the
// CPU tests hold against the plain PyTorch version (ops/field.py,
// ops/edwards.py, ops/ed25519.py).
//
// Field elements: 10 int32 limbs in the ref10 layout (limb i at bit
// ceil(25.5 i), 26 bits when i is even, 25 when odd). Every function keeps
// invariant W: each limb in [0, 2^w + 2^18]; the operands of a product
// may also be uncarried sums (fe_add_lazy). Products accumulate in uint64.
// Subtraction adds 4p (2p uncarried) limb by limb so limbs never go
// negative. All control flow is independent of the data: choices are
// selects, and the only data-indexed accesses are the two window-table
// lookups (the data is public).
//
// Quad point operations (Hisil, Wong, Carter, Dawson, "Twisted Edwards
// Curves Revisited", ASIACRYPT 2008, the four-processor formulas): role k
// holds coordinate k of the point (X, Y, Z, T) and each round issues one
// of four independent field multiplications per role. A doubling is a
// round of four squarings (X^2, Y^2, Z^2, (X+Y)^2) and a round of four
// multiplications; an addition of a table entry in cached form
// (Y-X, Y+X, 2Z, 2dT), whose component k role k reads, is two rounds. h is
// recoded to signed radix-16 digits (a table of multiples 0..8 of -A per
// signature) and S to signed radix-256 digits (a constant table of
// multiples 0..128 of B), so the loop adds a multiple of B every second
// window.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define LANE_FN __host__ __device__ __forceinline__
#define QUAD_FN __device__ __forceinline__
#else
#define LANE_FN inline
#define QUAD_FN inline
#endif

namespace ed25519_lane {

constexpr int NL = 10;
constexpr int ROW_BYTES = 129;  // a(32) | r(32) | s(32) | h(32) | valid(1)

// Layout of the int32 constants the caller passes in (ops/cuda_verify.py
// lane_consts): d, 2d, sqrt(-1), the base point's affine x and y, then the
// base table: multiples 0..128 of B in cached form, word (e * NL + i) * 4 + k
// for limb i of component k of entry e.
constexpr int CONST_D = 0;
constexpr int CONST_D2 = 10;
constexpr int CONST_SQRT_M1 = 20;
constexpr int CONST_BX = 30;
constexpr int CONST_BY = 40;
constexpr int CONST_BTABLE = 50;
constexpr int TABLE_ENTRIES = 9;     // multiples 0..8 of -A: signed radix-16 digits
constexpr int BTABLE_ENTRIES = 129;  // multiples 0..128 of B: signed radix-256 digits
constexpr int ENTRY_WORDS = 4 * NL;
constexpr int CONST_WORDS = CONST_BTABLE + BTABLE_ENTRIES * ENTRY_WORDS;
constexpr int RBUF_WORDS = 2 * NL;  // R's affine x and y, per quad
constexpr int DIGIT_WORDS = 16;     // h's and s's recoded digits, per quad

// -- operation counts (host build only) ---------------------------------
//
// The g++ build counts the field multiplications, squarings and 32x32->64
// products that a signature's verification uses: a role's operations count
// only where the algorithm uses that role's result (quad_used), so the
// roles that repeat another's work, or whose product is thrown away, are
// not charged.

#ifdef __CUDACC__
#define LANE_COUNT(field, n)
#else
struct LaneCounts {
  int64_t muls = 0, squares = 0, products = 0;
  bool on = true;
};
inline LaneCounts lane_counts;
#define LANE_COUNT(field, n) (lane_counts.field += lane_counts.on ? (n) : 0)
#endif

struct Fe {
  int32_t v[NL];
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
template <typename T>
LANE_FN void carry_round(T h[NL]) {
  T c[NL];
#pragma unroll
  for (int i = 0; i < NL; i++) {
    c[i] = h[i] >> width(i);
    h[i] &= (T(1) << width(i)) - 1;
  }
  h[0] += 19 * c[NL - 1];
#pragma unroll
  for (int i = 1; i < NL; i++) h[i] += c[i - 1];
}

template <typename T>
LANE_FN Fe fe_from64(T h[NL]) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NL; i++) r.v[i] = (int32_t)h[i];
  return r;
}

// Sums and differences of W limbs stay below 2^29, so they carry in int32
// and give the same limbs as an int64 carry would.
LANE_FN Fe fe_add(const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NL; i++) r.v[i] = a.v[i] + b.v[i];
  carry_round(r.v);
  return r;
}

// 4p limb by limb: [4(2^26-19), 4(2^25-1), 4(2^26-1), 4(2^25-1), ...]
LANE_FN int32_t bias_4p(int i) {
  return i == 0 ? 4 * ((1 << 26) - 19) : 4 * ((1 << width(i)) - 1);
}

LANE_FN Fe fe_sub(const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NL; i++) r.v[i] = a.v[i] - b.v[i] + bias_4p(i);
  carry_round(r.v);
  return r;
}

LANE_FN Fe fe_neg(const Fe& a) { return fe_sub(fe_small(0), a); }

// Operands of a product, not carried. fe_mul and fe_sq multiply unsigned
// 32-bit limbs, so an operand limb may reach 2^32 / 19 = 2^27.75, not just
// the 2^w + 2^18 of W: a + b of W inputs (below 2^27.01) and a - b + 2p
// (2p's limbs, 2^27 - 38 and 2^26 - 2, exceed any W limb of b; below
// 2^27.59) qualify. A column of a product of two such operands is below
// 5 x 38 x 2^55.2 + 5 x 19 x 2^55.2 < 2^62.4, and two carry rounds bring
// it back into W.
LANE_FN Fe fe_add_lazy(const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NL; i++) r.v[i] = a.v[i] + b.v[i];
  return r;
}

LANE_FN Fe fe_sub_lazy(const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NL; i++) r.v[i] = a.v[i] - b.v[i] + bias_4p(i) / 2;
  return r;
}

// a + b - c and 2a + b - c of W inputs, carried once back into W.
LANE_FN Fe fe_add_sub(const Fe& a, const Fe& b, const Fe& c, bool twice_a) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NL; i++) r.v[i] = (twice_a ? 2 * a.v[i] : a.v[i]) + b.v[i] - c.v[i] + bias_4p(i) / 2;
  carry_round(r.v);
  return r;
}

// fe_sub(a, b) when `subtract`, else fe_add(a, b), in one carry round.
LANE_FN Fe fe_addsub(const Fe& a, const Fe& b, bool subtract) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NL; i++) r.v[i] = a.v[i] + (subtract ? bias_4p(i) - b.v[i] : b.v[i]);
  carry_round(r.v);
  return r;
}

// A 32x32->64-bit product. Under W every limb and every factor below is
// non-negative, so the unsigned product is the same number, and it is one
// IMAD.WIDE.U32 where a signed one costs three multiply-adds.
LANE_FN uint64_t wide(uint32_t a, uint32_t b) { return (uint64_t)a * b; }

// Schoolbook product: f_i g_j lands in limb (i + j) mod 10, doubled when i
// and j are both odd, times 19 when i + j >= 10. Then two carry rounds.
LANE_FN Fe fe_mul(const Fe& f, const Fe& g) {
  uint32_t f2[NL], g19[NL];
#pragma unroll
  for (int i = 0; i < NL; i++) {
    f2[i] = 2u * (uint32_t)f.v[i];
    g19[i] = 19u * (uint32_t)g.v[i];
  }
  uint64_t h[NL];
#pragma unroll
  for (int k = 0; k < NL; k++) h[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
#pragma unroll
    for (int j = 0; j < NL; j++) {
      const uint32_t a = (i & j & 1) ? f2[i] : f.v[i];
      const uint32_t b = (i + j >= NL) ? g19[j] : g.v[j];
      h[(i + j) % NL] += wide(a, b);
      LANE_COUNT(products, 1);
    }
  }
  carry_round(h);
  carry_round(h);
  LANE_COUNT(muls, 1);
  return fe_from64(h);
}

// ref10's fe_sq schedule: the 55 products f_i f_j with i <= j, each cross
// term once with a factor 2. The factors fe_mul(f, f) gives the pair
// (i, j) and (j, i) (x2 for odd i and j, x19 past limb 9) ride on the
// operands: f_i by 1, 2 or 4, f_j by 1 or 19, all below 2^31 under W. The
// int64 column sums equal fe_mul(f, f)'s exactly, so after the same two
// carry rounds the limbs are identical.
LANE_FN Fe fe_sq(const Fe& f) {
  uint64_t h[NL];
#pragma unroll
  for (int k = 0; k < NL; k++) h[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
#pragma unroll
    for (int j = i; j < NL; j++) {
      const uint32_t a = (uint32_t)f.v[i] * ((i == j ? 1u : 2u) * ((i & j & 1) ? 2u : 1u));
      const uint32_t b = (i + j >= NL) ? 19u * (uint32_t)f.v[j] : (uint32_t)f.v[j];
      h[(i + j) % NL] += wide(a, b);
      LANE_COUNT(products, 1);
    }
  }
  carry_round(h);
  carry_round(h);
  LANE_COUNT(muls, 1);
  LANE_COUNT(squares, 1);
  return fe_from64(h);
}

LANE_FN Fe fe_pow2k(Fe x, int k) {
#pragma unroll 1
  for (int i = 0; i < k; i++) x = fe_sq(x);
  return x;
}

// x^((p-5)/8) = x^(2^252 - 3), the square-root exponent (RFC 8032).
LANE_FN Fe fe_pow22523(const Fe& x) {
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
LANE_FN Fe fe_canonical(const Fe& x) {
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

// RFC 8032 §5.1.3 decompression to affine (x, y). Returns false for a
// non-canonical y (y >= p), a non-square x^2, or x = 0 with the sign bit
// set; the point is then the base point, so the math that follows stays
// on the curve.
LANE_FN bool decompress(const uint8_t* enc, const int32_t* consts, Fe* x_out, Fe* y_out) {
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
  *x_out = fe_select(ok, x, fe_load(consts + CONST_BX));
  *y_out = fe_select(ok, y, fe_load(consts + CONST_BY));
  return ok;
}

LANE_FN int nibble(const uint8_t* scalar_le, int idx) {
  const int byte = scalar_le[idx >> 1];
  return (idx & 1) ? (byte >> 4) : (byte & 0x0F);
}

// Signed recoding of a 256-bit little-endian scalar in radix 2^BITS
// (BITS = 4 or 8): scalar = sum_i d_i 2^(BITS i) + carry 2^256 with every
// d_i in [-2^(BITS-1), 2^(BITS-1) - 1]. The digits are stored BITS-bit two's
// complement, 32 / BITS of them to a word, word w at words[w * stride],
// only when `store`. Returns the carry (0 or 1; 0 for every scalar below
// 2^254, so for every h and S below L).
template <int BITS>
LANE_FN int recode(const uint8_t* scalar_le, uint32_t* words, int stride, bool store) {
  constexpr int PER_WORD = 32 / BITS, HALF = 1 << (BITS - 1), MASK = (1 << BITS) - 1;
  int carry = 0;
#pragma unroll 1
  for (int w = 0; w < 8; w++) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < PER_WORD; b++) {
      const int i = PER_WORD * w + b;
      const int n = (BITS == 4 ? nibble(scalar_le, i) : scalar_le[i]) + carry;
      carry = (n + HALF) >> BITS;
      word |= (uint32_t)((n - (carry << BITS)) & MASK) << (BITS * b);
    }
    if (store) words[w * stride] = word;
  }
  return carry;
}

template <int BITS>
LANE_FN int digit(const uint32_t* words, int stride, int i) {
  constexpr int PER_WORD = 32 / BITS, HALF = 1 << (BITS - 1), MASK = (1 << BITS) - 1;
  const int d = (words[(i / PER_WORD) * stride] >> (BITS * (i % PER_WORD))) & MASK;
  return d - ((d & HALF) << 1);
}

// -- the quad -------------------------------------------------------------

#ifdef __CUDACC__
constexpr int QN = 1;  // a thread holds its own role's value
#else
constexpr int QN = 4;  // the host quad holds all four roles' values
#endif

struct QFe {  // one quad variable: slot j is role role(j)'s value
  Fe r[QN];
};

struct QInt {
  int r[QN];
};

QUAD_FN int role(int j) {
#ifdef __CUDACC__
  (void)j;
  return threadIdx.x & 3;
#else
  return j;
#endif
}

// Role src's value of v, read by the role in slot j.
QUAD_FN Fe qget(const QFe& v, int j, int src) {
#ifdef __CUDACC__
  (void)j;
  Fe r;
#pragma unroll
  for (int i = 0; i < NL; i++) r.v[i] = __shfl_sync(0xffffffffu, v.r[0].v[i], src, 4);
  return r;
#else
  (void)j;
  return v.r[src];
#endif
}

QUAD_FN int qget(const QInt& v, int j, int src) {
#ifdef __CUDACC__
  (void)j;
  return __shfl_sync(0xffffffffu, v.r[0], src, 4);
#else
  (void)j;
  return v.r[src];
#endif
}

// Makes the quad's shared-memory stores visible to the other roles.
QUAD_FN void quad_sync() {
#ifdef __CUDACC__
  __syncwarp();
#endif
}

// The roles in `used` (a 4-bit mask) carry results the algorithm uses; the
// field operations of the others are not counted (host build only).
QUAD_FN void quad_used(int j, unsigned used) {
#ifdef __CUDACC__
  (void)j;
  (void)used;
#else
  lane_counts.on = (used >> j) & 1;
#endif
}

// Limb i of component k of table entry e: word (e * NL + i) * stride + k.
QUAD_FN Fe tab_load(const int32_t* tab, int stride, int e, int k) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NL; i++) r.v[i] = tab[(e * NL + i) * stride + k];
  return r;
}

QUAD_FN void tab_store(int32_t* tab, int stride, int e, int k, const Fe& x) {
#pragma unroll
  for (int i = 0; i < NL; i++) tab[(e * NL + i) * stride + k] = x.v[i];
}

// Second round of a doubling (DOUBLE) or an addition: s holds the first
// round's four products on roles 0..3. Every role gathers all four and
// forms e, f, g, h, independent operations that keep the chain short,
// then multiplies its pair: X = ef, Y = gh, Z = fg, T = eh. The sums and
// differences go into the products uncarried (fe_add_lazy).
template <bool DOUBLE>
QUAD_FN QFe quad_finish(const QFe& s) {
  QFe out;
  for (int j = 0; j < QN; j++) {
    const int k = role(j);
    quad_used(j, 0xF);
    const Fe s0 = qget(s, j, 0), s1 = qget(s, j, 1), s2 = qget(s, j, 2), s3 = qget(s, j, 3);
    Fe e, f, g, h;
    if (DOUBLE) {  // s = X^2, Y^2, Z^2, (X+Y)^2
      h = fe_add_lazy(s0, s1);
      g = fe_sub_lazy(s0, s1);
      e = fe_add_sub(s0, s1, s3, false);  // h - (X+Y)^2
      f = fe_add_sub(s2, s0, s1, true);   // 2Z^2 + g
    } else {  // s = (Y1-X1)(Y2-X2), (Y1+X1)(Y2+X2), Z1 2Z2, T1 2dT2
      e = fe_sub_lazy(s1, s0);
      f = fe_sub_lazy(s2, s3);
      g = fe_add_lazy(s2, s3);
      h = fe_add_lazy(s1, s0);
    }
    const Fe l = fe_select(k == 1, g, fe_select(k == 2, f, e));
    const Fe r = fe_select(k == 0, f, fe_select(k == 2, g, h));
    out.r[j] = fe_mul(l, r);
  }
  return out;
}

// Unified doubling, 4S + 4M: the formulas of ops/edwards.py double, on
// uncarried sums.
QUAD_FN QFe quad_double(const QFe& p) {
  QFe s;
  for (int j = 0; j < QN; j++) {
    const int k = role(j);
    quad_used(j, 0xF);
    const Fe x = qget(p, j, 0), y = qget(p, j, 1);
    s.r[j] = fe_sq(fe_select(k == 3, fe_add_lazy(x, y), p.r[j]));
  }
  return quad_finish<true>(s);
}

// p + q for q in cached form (Y-X, Y+X, 2Z, 2dT), role k holding
// component k of q: 8M, complete.
QUAD_FN QFe quad_add(const QFe& p, const QFe& q) {
  QFe s;
  for (int j = 0; j < QN; j++) {
    const int k = role(j);
    quad_used(j, 0xF);
    // roles 0 and 1 swap X and Y and form Y - X and Y + X
    const Fe own = p.r[j], other = qget(p, j, k ^ 1);
    const Fe l = fe_select(k == 0, fe_sub_lazy(other, own),
                           fe_select(k == 1, fe_add_lazy(own, other), own));
    s.r[j] = fe_mul(l, q.r[j]);
  }
  return quad_finish<false>(s);
}

// Extended -> cached form (Y-X, Y+X, 2Z, 2dT), 1M (role 3's).
QUAD_FN QFe quad_cache(const QFe& p, const Fe& d2) {
  QFe c;
  for (int j = 0; j < QN; j++) {
    const int k = role(j);
    quad_used(j, 0x8);
    const Fe own = p.r[j], other = qget(p, j, k ^ 1);
    const Fe t2d = fe_mul(own, d2);
    c.r[j] = fe_select(k == 3, t2d, fe_addsub(fe_select(k == 2, own, other), own, k == 0));
  }
  return c;
}

// Table entry e (cached) -> the same point in extended coordinates scaled
// by 2, (2X : 2Y : 2Z), which is all a doubling reads.
QUAD_FN QFe quad_uncache(const int32_t* tab, int stride, int e) {
  QFe p;
  for (int j = 0; j < QN; j++) {
    const int k = role(j);
    const Fe ymx = tab_load(tab, stride, e, 0), ypx = tab_load(tab, stride, e, 1);
    p.r[j] = fe_select(k < 2, fe_addsub(ypx, ymx, k == 0), tab_load(tab, stride, e, 2));
  }
  return p;
}

// [digit] times the table's point, |digit| below the table's size, in
// cached form: the negation -(X, Y, Z, T) swaps Y-X with Y+X and negates
// 2dT.
QUAD_FN QFe quad_lookup(const int32_t* tab, int stride, int digit) {
  const bool neg = digit < 0;
  const int e = neg ? -digit : digit;
  QFe q;
  for (int j = 0; j < QN; j++) {
    const int k = role(j);
    const Fe c = tab_load(tab, stride, e, k < 2 ? k ^ (int)neg : k);
    q.r[j] = fe_select(neg & (k == 3), fe_neg(c), c);
  }
  return q;
}

QUAD_FN void quad_store(int32_t* tab, int stride, int e, const QFe& q) {
  for (int j = 0; j < QN; j++) tab_store(tab, stride, e, role(j), q.r[j]);
}

// The verdict of one packed row, [S]B + [h](-A) == R (the RFC 8032
// cofactorless check) AND valid AND both points decoded, held by role 0.
//   consts: CONST_WORDS words (the base table included);
//   atab:   this quad's table of -A, TABLE_ENTRIES cached entries at
//           `astride` (component k of the quad at atab[... * astride + k]);
//   rbuf:   RBUF_WORDS words for R's affine coordinates;
//   digits: DIGIT_WORDS words at `dstride` for the recoded h and S.
QUAD_FN bool quad_verify(const uint8_t* row, const int32_t* consts, int32_t* atab, int astride,
                         int32_t* rbuf, uint32_t* digits, int dstride) {
  const Fe one = fe_small(1);
  const Fe d2 = fe_load(consts + CONST_D2);

  // Roles 0 and 2 decompress A, roles 1 and 3 R, in one instruction
  // stream; roles 2 and 3 repeat 0 and 1 and are not counted. Roles 0 and
  // 2 then hold coordinates 0 and 2 of -A = (-x, y, 1, -xy) and hand
  // coordinates 1 and 3 to roles 1 and 3.
  QFe own, handoff;
  QInt decoded;
  for (int j = 0; j < QN; j++) {
    const int k = role(j);
    quad_used(j, 0x3);
    Fe x, y;
    decoded.r[j] = decompress(row + 32 * (k & 1), consts, &x, &y);
    const Fe nx = fe_neg(x);
    quad_used(j, 0x4);  // role 2's T goes to role 3
    const Fe t = fe_mul(nx, y);
    own.r[j] = fe_select(k == 0, nx, one);
    handoff.r[j] = fe_select(k == 0, y, t);
    if (k == 1) {
      tab_store(rbuf, 1, 0, 0, x);
      tab_store(rbuf, 1, 1, 0, y);
    }
  }
  QFe neg_a;
  for (int j = 0; j < QN; j++) {
    const int k = role(j);
    neg_a.r[j] = fe_select(k & 1, qget(handoff, j, k ^ 1), own.r[j]);
  }

  // multiples 0..8 of -A, cached: 2m by doubling m, 2m+1 = 2m + (-A)
  QFe ident;
  for (int j = 0; j < QN; j++) {
    const int k = role(j);
    ident.r[j] = fe_small(k < 2 ? 1 : (k == 2 ? 2 : 0));
  }
  quad_store(atab, astride, 0, ident);
  const QFe neg_a_cached = quad_cache(neg_a, d2);
  quad_store(atab, astride, 1, neg_a_cached);
#pragma unroll 1
  for (int m = 1; m < 4; m++) {
    quad_sync();
    const QFe dbl = quad_double(quad_uncache(atab, astride, m));
    quad_store(atab, astride, 2 * m, quad_cache(dbl, d2));
    quad_store(atab, astride, 2 * m + 1, quad_cache(quad_add(dbl, neg_a_cached), d2));
  }
  quad_sync();
  quad_store(atab, astride, 8, quad_cache(quad_double(quad_uncache(atab, astride, 4)), d2));

  // signed digits of h (radix 16, stored by role 0) and S (radix 256,
  // stored by role 1); every role recodes both, so all hold the carries
  // out of the top digit, which start the accumulator: acc = [h_64](-A) +
  // [s_32]B. Then 32 steps, most significant first, of two radix-16
  // windows of h and one radix-256 digit of S.
  const uint8_t* s_le = row + 64;
  const uint8_t* h_le = row + 96;
  uint32_t* h_digits = digits;
  uint32_t* s_digits = digits + 8 * dstride;
  QFe acc;
  int s_top = 0;
  for (int j = 0; j < QN; j++) {
    const int k = role(j);
    const int h_top = recode<4>(h_le, h_digits, dstride, k == 0);
    s_top = recode<8>(s_le, s_digits, dstride, k == 1);
    acc.r[j] = fe_select(h_top, neg_a.r[j], ident.r[j]);
  }
  quad_sync();
  const int32_t* btab = consts + CONST_BTABLE;
  acc = quad_add(acc, quad_lookup(btab, 4, s_top));
#pragma unroll 1
  for (int w = 31; w >= 0; w--) {
#pragma unroll 1
    for (int half = 1; half >= 0; half--) {
#pragma unroll 1
      for (int i = 0; i < 4; i++) acc = quad_double(acc);
      acc = quad_add(acc, quad_lookup(atab, astride, digit<4>(h_digits, dstride, 2 * w + half)));
    }
    acc = quad_add(acc, quad_lookup(btab, 4, digit<8>(s_digits, dstride, w)));
  }

  // projective compare with the affine R (its Z is 1): role 0 checks
  // X == x_R Z, role 1 Y == y_R Z
  quad_sync();
  QInt good;
  for (int j = 0; j < QN; j++) {
    const int k = role(j);
    quad_used(j, 0x3);
    const Fe z = qget(acc, j, 2);
    const bool match = fe_eq(acc.r[j], fe_mul(tab_load(rbuf, 1, k & 1, 0), z));
    good.r[j] = match & decoded.r[j];
  }
  bool verdict = false;
  for (int j = 0; j < QN; j++) {
    const int theirs = qget(good, j, 1);
    if (role(j) == 0) verdict = (row[128] != 0) & good.r[j] & theirs;
  }
#ifndef __CUDACC__
  lane_counts.on = true;
#endif
  return verdict;
}

}  // namespace ed25519_lane
