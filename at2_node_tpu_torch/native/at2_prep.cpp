// Native host-side batch preparation for the CUDA ed25519 verifier.
//
// Fills a caller's staging buffer with one packed row a signature
// (at2_prep.h), optionally over std::thread workers.

#include <cstdint>
#include <thread>
#include <vector>

#include "at2_prep.h"

using at2_prep::prep_range;

extern "C" {

// Fill all `size` rows of `out` (size x 129 bytes): the first n from the
// items, the rest zero padding.
void at2_prep_packed(const uint8_t* pks, const uint64_t* pk_off,
                     const uint8_t* msgs, const uint64_t* msg_off,
                     const uint8_t* sigs, const uint64_t* sig_off,
                     int64_t n, int64_t size, int64_t n_threads,
                     uint8_t* out) {
  if (n_threads <= 1 || size < 256) {
    prep_range(pks, pk_off, msgs, msg_off, sigs, sig_off, n, 0, size, out);
    return;
  }
  std::vector<std::thread> workers;
  int64_t chunk = (size + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; t++) {
    int64_t lo = t * chunk, hi = lo + chunk < size ? lo + chunk : size;
    if (lo >= hi) break;
    workers.emplace_back(prep_range, pks, pk_off, msgs, msg_off, sigs,
                         sig_off, n, lo, hi, out);
  }
  for (auto& w : workers) w.join();
}
}
