// Sanitizer harness for the native batch prep (at2_prep.cpp), built by
// tests/test_torch_native_sanitize.py under -fsanitize=thread and under
// -fsanitize=address.
//
// at2_prep_packed's only concurrency is its std::thread fan-out: each
// worker writes a disjoint range of rows of the caller's one staging
// buffer. This harness proves (under TSAN) that the partition is
// race-free and (functionally) that every row of a multithreaded fill,
// padding rows included, is bit-identical to the single-threaded fill;
// under ASAN, that no row write or ragged read leaves its bounds. It
// pins SHA-512 and the mod-L reduction with RFC 8032's test 1: the row of
// that signature must carry h = SHA-512(R || A || M) mod L.
//
// Build: g++ -std=c++17 -O1 -g -fsanitize=thread at2_prep.cpp \
//            sanitize_test.cpp -o sanitize_test -lpthread && ./sanitize_test

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {
void at2_prep_packed(const uint8_t*, const uint64_t*, const uint8_t*,
                     const uint64_t*, const uint8_t*, const uint64_t*,
                     int64_t, int64_t, int64_t, uint8_t*);
}

static constexpr int64_t kRow = 129;  // A || R || S || h || valid

// RFC 8032 section 7.1, test 1 (the empty message)
static const uint8_t kPk[32] = {
    0xd7, 0x5a, 0x98, 0x01, 0x82, 0xb1, 0x0a, 0xb7, 0xd5, 0x4b, 0xfe,
    0xd3, 0xc9, 0x64, 0x07, 0x3a, 0x0e, 0xe1, 0x72, 0xf3, 0xda, 0xa6,
    0x23, 0x25, 0xaf, 0x02, 0x1a, 0x68, 0xf7, 0x07, 0x51, 0x1a};
static const uint8_t kSig[64] = {
    0xe5, 0x56, 0x43, 0x00, 0xc3, 0x60, 0xac, 0x72, 0x90, 0x86, 0xe2,
    0xcc, 0x80, 0x6e, 0x82, 0x8a, 0x84, 0x87, 0x7f, 0x1e, 0xb8, 0xe5,
    0xd9, 0x74, 0xd8, 0x73, 0xe0, 0x65, 0x22, 0x49, 0x01, 0x55, 0x5f,
    0xb8, 0x82, 0x15, 0x90, 0xa3, 0x3b, 0xac, 0xc6, 0x1e, 0x39, 0x70,
    0x1c, 0xf9, 0xb4, 0x6b, 0xd2, 0x5b, 0xf5, 0xf0, 0x59, 0x5b, 0xbe,
    0x24, 0x65, 0x51, 0x41, 0x43, 0x8e, 0x7a, 0x10, 0x0b};
// SHA-512(R || A) mod L, little-endian
static const uint8_t kH[32] = {
    0x86, 0xea, 0xbc, 0x8e, 0x4c, 0x96, 0x19, 0x3d, 0x29, 0x05, 0x04,
    0xe7, 0xc6, 0x00, 0xdf, 0x6c, 0xf8, 0xd8, 0x25, 0x61, 0x31, 0xec,
    0x2c, 0x13, 0x8a, 0x3e, 0x7e, 0x16, 0x2e, 0x52, 0x54, 0x04};

int main() {
  // a deterministic batch of n items in a bucket of `size` rows: item 0
  // is the RFC vector; most S are below L (top byte < 0x10) and pass the
  // range check, every 5th has S >= L, every 17th a 31-byte key, and the
  // messages are ragged (0..299 bytes). Contents need not be valid
  // signatures: the property is thread-count bit-identity.
  const int64_t n = 1000, size = 1024;
  uint64_t seed = 0x2545F4914F6CDD1DULL;
  auto next = [&seed]() {
    seed ^= seed << 13;
    seed ^= seed >> 7;
    seed ^= seed << 17;
    return static_cast<uint8_t>(seed);
  };
  std::vector<uint8_t> pks, msgs, sigs;
  std::vector<uint64_t> pk_off{0}, msg_off{0}, sig_off{0};
  int64_t want_valid = 0;
  for (int64_t i = 0; i < n; i++) {
    uint8_t sig[64];
    size_t pk_len = (i % 17 == 16) ? 31 : 32;
    size_t msg_len = size_t(i * 13 % 300);
    if (i == 0) {
      pks.insert(pks.end(), kPk, kPk + 32);
      std::memcpy(sig, kSig, 64);
      msg_len = 0;
    } else {
      for (size_t b = 0; b < pk_len; b++) pks.push_back(next());
      for (auto& b : sig) b = next();
      sig[63] = (i % 5 == 4) ? uint8_t(0xf0 | sig[63]) : uint8_t(sig[63] & 0x0f);
    }
    for (size_t b = 0; b < msg_len; b++) msgs.push_back(next());
    sigs.insert(sigs.end(), sig, sig + 64);
    pk_off.push_back(pks.size());
    msg_off.push_back(msgs.size());
    sig_off.push_back(sigs.size());
    want_valid += (pk_len == 32 && (i == 0 || i % 5 != 4)) ? 1 : 0;
  }

  auto run = [&](int64_t threads) {
    // garbage first: every row, padding included, must be written
    std::vector<uint8_t> out(size_t(size * kRow), 0xa5);
    at2_prep_packed(pks.data(), pk_off.data(), msgs.data(), msg_off.data(),
                    sigs.data(), sig_off.data(), n, size, threads, out.data());
    return out;
  };

  auto serial = run(1);
  const uint8_t* row0 = serial.data();
  if (std::memcmp(row0, kPk, 32) != 0 || std::memcmp(row0 + 32, kSig, 64) != 0 ||
      std::memcmp(row0 + 96, kH, 32) != 0 || row0[128] != 1) {
    std::fprintf(stderr, "FAIL: RFC 8032 test 1 row (SHA-512 / mod L)\n");
    return 1;
  }
  int64_t valid = 0;
  for (int64_t i = 0; i < size; i++) {
    const uint8_t* row = serial.data() + i * kRow;
    valid += row[128];
    bool zero = true;
    for (int64_t b = 0; b < kRow; b++) zero = zero && row[b] == 0;
    if (row[128] == 0 && !zero) {
      std::fprintf(stderr, "FAIL: rejected or padding row %lld not zero\n",
                   static_cast<long long>(i));
      return 1;
    }
  }
  if (valid != want_valid) {
    std::fprintf(stderr, "FAIL: %lld valid rows, want %lld\n",
                 static_cast<long long>(valid), static_cast<long long>(want_valid));
    return 1;
  }
  for (int64_t threads : {2, 3, 4, 8}) {
    auto multi = run(threads);
    for (int64_t i = 0; i < size; i++) {
      if (std::memcmp(multi.data() + i * kRow, serial.data() + i * kRow, kRow) != 0) {
        std::fprintf(stderr, "FAIL: %lld-thread row %lld differs from serial\n",
                     static_cast<long long>(threads), static_cast<long long>(i));
        return 1;
      }
    }
  }
  std::printf("sanitize_test: OK (%lld valid rows of %lld)\n",
              static_cast<long long>(valid), static_cast<long long>(size));
  return 0;
}
