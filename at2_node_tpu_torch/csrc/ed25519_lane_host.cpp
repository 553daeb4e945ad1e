// g++ build of the kernel's per-lane math (ed25519_lane.cuh) for the CPU
// tests: the same functions the CUDA kernel runs per thread, called here
// in a loop, so the kernel's arithmetic is checked against the plain
// PyTorch version before any run on the card.

#include <stdint.h>

#include "ed25519_lane.cuh"

using namespace ed25519_lane;

extern "C" {

// verdicts[i] = lane_verify(row i) for n packed rows of 129 bytes
void ed25519_lane_verify_rows(const uint8_t* packed, int64_t n, const int32_t* consts,
                              uint8_t* verdicts) {
  for (int64_t i = 0; i < n; i++) {
    verdicts[i] = lane_verify(packed + i * ROW_BYTES, consts) ? 1 : 0;
  }
}

// One field operation over n limb vectors (10 int32 each):
// op 0 mul, 1 add, 2 sub, 3 canonical(a), 4 pow22523(a).
void ed25519_lane_fe_op(int op, const int32_t* a, const int32_t* b, int64_t n, int32_t* out) {
  for (int64_t i = 0; i < n; i++) {
    const Fe x = fe_load(a + NL * i), y = fe_load(b + NL * i);
    Fe r;
    switch (op) {
      case 0: r = fe_mul(x, y); break;
      case 1: r = fe_add(x, y); break;
      case 2: r = fe_sub(x, y); break;
      case 3: r = fe_canonical(x); break;
      default: r = fe_pow22523(x); break;
    }
    for (int k = 0; k < NL; k++) out[NL * i + k] = r.v[k];
  }
}
}
