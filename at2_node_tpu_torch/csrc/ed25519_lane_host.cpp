// g++ build of the kernel's math (ed25519_lane.cuh) for the CPU tests: the
// field functions every kernel thread runs, and the quad's point
// operations and verdict with its four roles run in lockstep, so the
// kernel's arithmetic is checked against the plain PyTorch version before
// any run on the card.

#include <stdint.h>

#include "ed25519_lane.cuh"

using namespace ed25519_lane;

namespace {

QFe quad_from(const int32_t* pt) {  // an extended point, (4, 10) limbs
  QFe q;
  for (int k = 0; k < 4; k++) q.r[k] = fe_load(pt + NL * k);
  return q;
}

void quad_to(const QFe& q, int32_t* pt) {
  for (int k = 0; k < 4; k++)
    for (int i = 0; i < NL; i++) pt[NL * k + i] = q.r[k].v[i];
}

}  // namespace

extern "C" {

// verdicts[i] = the host quad's verdict of packed row i, for n rows
void ed25519_lane_verify_rows(const uint8_t* packed, int64_t n, const int32_t* consts,
                              uint8_t* verdicts) {
  int32_t atab[TABLE_ENTRIES * ENTRY_WORDS];
  int32_t rbuf[RBUF_WORDS];
  uint32_t digits[DIGIT_WORDS];
  for (int64_t i = 0; i < n; i++) {
    verdicts[i] = quad_verify(packed + i * ROW_BYTES, consts, atab, 4, rbuf, digits, 1) ? 1 : 0;
  }
}

// codes[i] and the residual [z]R + [zh]A - [zs]B of the host quad's RLC
// lane math on packed RLC row i (ops/aggregate.py RLC_PACKED_WIDTH bytes),
// for n rows, as two extended points a row ((2, 4, 10) limbs, unmasked)
// whose sum is the residual. Layout 0 (whole, quad_rlc): the residual and
// the identity; layout 1 (split): quad_rlc_point of A and of R, their [L]P
// checks, then [zh]A - [zs]B and [z]R, run in that order.
void ed25519_lane_rlc_rows(const uint8_t* packed, int64_t n, const int32_t* consts, int layout,
                           uint8_t* codes, int32_t* residuals) {
  int32_t rtab[TABLE_ENTRIES * ENTRY_WORDS];
  int32_t atab[TABLE_ENTRIES * ENTRY_WORDS];
  uint32_t digits[RLC_DIGIT_WORDS];
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* row = packed + i * RLC_ROW_BYTES;
    int32_t* out = residuals + 2 * POINT_WORDS * i;
    if (layout == 0) {
      QFe e;
      codes[i] = (uint8_t)quad_rlc(row, consts, rtab, atab, 4, digits, 1, &e);
      quad_to(e, out);
      quad_to(quad_identity(), out + POINT_WORDS);
      continue;
    }
    QFe a, r;
    const bool a_ok = quad_rlc_point(row, consts, atab, 4, &a);
    const bool r_ok = quad_rlc_point(row + 32, consts, rtab, 4, &r);
    const bool a_clean = a_ok & quad_torsion_free(a, atab, 4);
    const bool r_clean = r_ok & quad_torsion_free(r, rtab, 4);
    quad_to(quad_rlc_residual_a(row, consts, atab, 4, digits, 1), out);
    quad_to(quad_rlc_residual_r(row, rtab, 4, digits + 16, 1), out + POINT_WORDS);
    codes[i] = (uint8_t)rlc_code(row[160] != 0, a_clean, r_clean);
  }
}

// The signed radix-2^bits digits (bits 4 or 8) of n 32-byte little-endian
// scalars and the carry: 256 / bits + 1 values per scalar.
void ed25519_lane_recode(const uint8_t* scalars, int64_t n, int bits, int16_t* out) {
  uint32_t words[8];
  const int m = 256 / bits;
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* s = scalars + 32 * i;
    const int carry = bits == 4 ? recode<4>(s, words, 1, true) : recode<8>(s, words, 1, true);
    for (int d = 0; d < m; d++)
      out[(m + 1) * i + d] = (int16_t)(bits == 4 ? digit<4>(words, 1, d) : digit<8>(words, 1, d));
    out[(m + 1) * i + m] = (int16_t)carry;
  }
}

// One field operation over n limb vectors (10 int32 each):
// op 0 mul, 1 add, 2 sub, 3 canonical(a), 4 pow22523(a), 5 sq(a), and the
// products of uncarried operands: 6 (a - b)(b - a), 7 (a + b)^2,
// 8 (a + b)(a - b), 9 a + b - b, 10 2a + b - a.
void ed25519_lane_fe_op(int op, const int32_t* a, const int32_t* b, int64_t n, int32_t* out) {
  for (int64_t i = 0; i < n; i++) {
    const Fe x = fe_load(a + NL * i), y = fe_load(b + NL * i);
    Fe r;
    switch (op) {
      case 0: r = fe_mul(x, y); break;
      case 1: r = fe_add(x, y); break;
      case 2: r = fe_sub(x, y); break;
      case 3: r = fe_canonical(x); break;
      case 4: r = fe_pow22523(x); break;
      case 5: r = fe_sq(x); break;
      case 6: r = fe_mul(fe_sub_lazy(x, y), fe_sub_lazy(y, x)); break;
      case 7: r = fe_sq(fe_add_lazy(x, y)); break;
      case 8: r = fe_mul(fe_add_lazy(x, y), fe_sub_lazy(x, y)); break;
      case 9: r = fe_add_sub(x, y, y, false); break;
      default: r = fe_add_sub(x, y, x, true); break;
    }
    for (int k = 0; k < NL; k++) out[NL * i + k] = r.v[k];
  }
}

// One quad point operation over n extended points ((4, 10) limbs each):
// op 0 double(p), op 1 p + q with q put in cached form by the quad.
void ed25519_quad_point_op(int op, const int32_t* p, const int32_t* q, const int32_t* consts,
                           int64_t n, int32_t* out) {
  const Fe d2 = fe_load(consts + CONST_D2);
  for (int64_t i = 0; i < n; i++) {
    const QFe a = quad_from(p + 4 * NL * i);
    const QFe r = op == 0 ? quad_double(a) : quad_add(a, quad_cache(quad_from(q + 4 * NL * i), d2));
    quad_to(r, out + 4 * NL * i);
  }
}

// The counts since the last call (field multiplications, of which
// squarings, and 32x32->64-bit products), then zeroed.
void ed25519_lane_take_counts(int64_t* out) {
  out[0] = lane_counts.muls;
  out[1] = lane_counts.squares;
  out[2] = lane_counts.products;
  lane_counts = LaneCounts();
}
}
