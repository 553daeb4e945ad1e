// Native host-side batch preparation for the CUDA ed25519 verifier.
//
// Per signature: SHA-512(R || A || M) reduced mod L, the S < L check, and
// one packed row A(32) | R(32) | S(32) | h(32) | valid(1) written straight
// into the caller's staging buffer, optionally over std::thread workers.
// SHA-512 (FIPS 180-4) is implemented here so the library needs no OpenSSL
// headers.
//
// Exact-parity contract with ops.ed25519.prepare_batch_py + pack_prepared:
// invalid items (bad lengths, S >= L) and padding rows are all zero.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------- SHA-512 (FIPS 180-4) ----------------

constexpr uint64_t K[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL,
    0xe9b5dba58189dbbcULL, 0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL,
    0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL, 0xd807aa98a3030242ULL,
    0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL,
    0xc19bf174cf692694ULL, 0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL,
    0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL, 0x2de92c6f592b0275ULL,
    0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL,
    0xbf597fc7beef0ee4ULL, 0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL,
    0x06ca6351e003826fULL, 0x142929670a0e6e70ULL, 0x27b70a8546d22ffcULL,
    0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL,
    0x92722c851482353bULL, 0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL,
    0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL, 0xd192e819d6ef5218ULL,
    0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL,
    0x34b0bcb5e19b48a8ULL, 0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL,
    0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL, 0x748f82ee5defb2fcULL,
    0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL,
    0xc67178f2e372532bULL, 0xca273eceea26619cULL, 0xd186b8c721c0c207ULL,
    0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL, 0x06f067aa72176fbaULL,
    0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL,
    0x431d67c49c100d4cULL, 0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL,
    0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL};

inline uint64_t rotr(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }
inline uint64_t be64(const uint8_t* p) {
  uint64_t v = 0;
  for (int i = 0; i < 8; i++) v = (v << 8) | p[i];
  return v;
}

struct Sha512 {
  uint64_t h[8] = {0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL,
                   0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
                   0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
                   0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};
  uint8_t buf[128];
  size_t buflen = 0;
  uint64_t total = 0;

  void block(const uint8_t* p) {
    uint64_t w[80];
    for (int i = 0; i < 16; i++) w[i] = be64(p + 8 * i);
    for (int i = 16; i < 80; i++) {
      uint64_t s0 = rotr(w[i - 15], 1) ^ rotr(w[i - 15], 8) ^ (w[i - 15] >> 7);
      uint64_t s1 = rotr(w[i - 2], 19) ^ rotr(w[i - 2], 61) ^ (w[i - 2] >> 6);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint64_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int i = 0; i < 80; i++) {
      uint64_t S1 = rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41);
      uint64_t ch = (e & f) ^ (~e & g);
      uint64_t t1 = hh + S1 + ch + K[i] + w[i];
      uint64_t S0 = rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39);
      uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint64_t t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const uint8_t* p, size_t n) {
    total += n;
    if (buflen) {
      size_t take = n < 128 - buflen ? n : 128 - buflen;
      std::memcpy(buf + buflen, p, take);
      buflen += take; p += take; n -= take;
      if (buflen == 128) { block(buf); buflen = 0; }
    }
    while (n >= 128) { block(p); p += 128; n -= 128; }
    if (n) { std::memcpy(buf, p, n); buflen = n; }
  }

  void final(uint8_t out[64]) {
    uint64_t bits = total * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t z = 0;
    while (buflen != 112) update(&z, 1);
    uint8_t len[16] = {0};
    for (int i = 0; i < 8; i++) len[15 - i] = (uint8_t)(bits >> (8 * i));
    update(len, 16);
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 8; j++) out[8 * i + j] = (uint8_t)(h[i] >> (56 - 8 * j));
  }
};

// ---------------- mod-L scalar arithmetic ----------------
// L = 2^252 + C, C = 27742317777372353535851937790883648493

constexpr uint64_t C0 = 0x5812631a5cf5d3edULL;  // C low word
constexpr uint64_t C1 = 0x14def9dea2f79cd6ULL;  // C high word (C = C1<<64 | C0)
constexpr uint64_t L0 = C0, L1 = C1, L2 = 0, L3 = 1ULL << 60;  // L words

inline bool geq256(const uint64_t a[4], const uint64_t b[4]) {
  for (int i = 3; i >= 0; i--) {
    if (a[i] != b[i]) return a[i] > b[i];
  }
  return true;
}

// ---- sign/magnitude bignum helpers over fixed 7-word (448-bit) values --

constexpr int NW = 7;

struct Big {
  uint64_t w[NW] = {0};  // little-endian magnitude
  bool neg = false;
};

inline bool big_is_zero(const Big& a) {
  for (int i = 0; i < NW; i++)
    if (a.w[i]) return false;
  return true;
}

// magnitude >> 252 (252 = 3*64 + 60)
inline void shr252(const uint64_t in[NW], uint64_t out[NW]) {
  for (int i = 0; i < NW; i++) {
    uint64_t lo = (i + 3 < NW) ? in[i + 3] >> 60 : 0;
    uint64_t hi = (i + 4 < NW) ? in[i + 4] << 4 : 0;
    out[i] = lo | hi;
  }
}

// magnitude & (2^252 - 1)
inline void low252(const uint64_t in[NW], uint64_t out[NW]) {
  out[0] = in[0]; out[1] = in[1]; out[2] = in[2];
  out[3] = in[3] & 0x0FFFFFFFFFFFFFFFULL;
  for (int i = 4; i < NW; i++) out[i] = 0;
}

// out = a * C (C is 2 words); a limited so the product fits NW words
inline void mul_c(const uint64_t a[NW], uint64_t out[NW]) {
  uint64_t c[2] = {C0, C1};
  uint64_t t[NW + 2] = {0};
  for (int i = 0; i < NW; i++) {
    unsigned __int128 carry = 0;
    for (int j = 0; j < 2; j++) {
      if (i + j >= NW + 2) break;
      unsigned __int128 cur =
          (unsigned __int128)a[i] * c[j] + t[i + j] + (uint64_t)carry;
      t[i + j] = (uint64_t)cur;
      carry = cur >> 64;
    }
    for (int k = i + 2; carry && k < NW + 2; k++) {
      unsigned __int128 cur = (unsigned __int128)t[k] + (uint64_t)carry;
      t[k] = (uint64_t)cur;
      carry = cur >> 64;
    }
  }
  for (int i = 0; i < NW; i++) out[i] = t[i];
}

// out = |a - b|, returns true iff (a - b) is negative
inline bool sub_mag(const uint64_t a[NW], const uint64_t b[NW],
                    uint64_t out[NW]) {
  unsigned __int128 borrow = 0;
  uint64_t d[NW];
  for (int i = 0; i < NW; i++) {
    unsigned __int128 cur =
        (unsigned __int128)a[i] - b[i] - (uint64_t)borrow;
    d[i] = (uint64_t)cur;
    borrow = (cur >> 64) ? 1 : 0;
  }
  if (!borrow) {
    std::memcpy(out, d, sizeof(d));
    return false;
  }
  // negate (two's complement) to get |a - b|
  unsigned __int128 carry = 1;
  for (int i = 0; i < NW; i++) {
    unsigned __int128 cur = (unsigned __int128)(~d[i]) + (uint64_t)carry;
    out[i] = (uint64_t)cur;
    carry = cur >> 64;
  }
  return true;
}

// Reduce a 512-bit little-endian value mod L into out[32] (little-endian).
//
// Fold identity: x = h*2^252 + l  ==>  x === l - h*C (mod L), since
// 2^252 === -C (mod L). Each fold shrinks the magnitude by ~127 bits
// (C ~ 2^125), so three folds bring 512 bits under 2^253; sign is
// tracked explicitly and resolved against L at the end.
void mod_l(const uint8_t in[64], uint8_t out[32]) {
  Big x;
  for (int i = 0; i < 8; i++) {
    uint64_t v = 0;
    for (int j = 7; j >= 0; j--) v = (v << 8) | in[8 * i + j];
    if (i < NW) x.w[i] = v;
    else {
      // word 7 (bits 448..511): fold immediately via 2^448 = 2^196 * 2^252
      // by placing it in a high Big and running the generic folds below —
      // NW=7 can't hold it, so pre-fold: x = h448*2^448 + rest;
      // 2^448 === -C * 2^196 (mod L). h448 * C < 2^189, shifted by 196
      // stays < 2^385: subtract (h448*C) << 196 from the magnitude.
      uint64_t hc[NW] = {0};
      uint64_t h1[NW] = {v, 0, 0, 0, 0, 0, 0};
      mul_c(h1, hc);
      // shift hc left by 196 = 3*64 + 4
      uint64_t shifted[NW] = {0};
      for (int k = NW - 1; k >= 3; k--) {
        uint64_t lo = hc[k - 3] << 4;
        uint64_t hi = (k - 4 >= 0) ? hc[k - 4] >> 60 : 0;
        shifted[k] = lo | hi;
      }
      bool n = sub_mag(x.w, shifted, x.w);
      x.neg = n ? !x.neg : x.neg;
    }
  }
  for (int round = 0; round < 4; round++) {
    uint64_t h[NW], l[NW], hc[NW];
    shr252(x.w, h);
    bool h_zero = true;
    for (int i = 0; i < NW; i++) h_zero = h_zero && !h[i];
    if (h_zero) break;
    low252(x.w, l);
    mul_c(h, hc);
    bool n = sub_mag(l, hc, x.w);
    x.neg = n ? !x.neg : x.neg;  // l - h*C with x's sign preserved
  }
  // |x| < 2^253 < 2L; resolve into [0, L):
  //   1. if |x| >= L subtract L once (now |x| in [0, L))
  //   2. if the sign is negative and |x| != 0, result = L - |x|
  uint64_t Lw[NW] = {L0, L1, L2, L3, 0, 0, 0};
  uint64_t tmp[NW];
  if (!sub_mag(x.w, Lw, tmp)) {  // x.w >= L
    std::memcpy(x.w, tmp, sizeof(tmp));
  }
  if (x.neg && !big_is_zero(x)) {
    sub_mag(Lw, x.w, x.w);  // L - |x|, always non-negative here
  }
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 8; j++) out[8 * i + j] = (uint8_t)(x.w[i] >> (8 * j));
}

// S < L check on 32 little-endian bytes
bool scalar_in_range(const uint8_t s[32]) {
  uint64_t w[4];
  for (int i = 0; i < 4; i++) {
    uint64_t v = 0;
    for (int j = 7; j >= 0; j--) v = (v << 8) | s[8 * i + j];
    w[i] = v;
  }
  uint64_t Lw[4] = {L0, L1, L2, L3};
  return !geq256(w, Lw);
}

constexpr int64_t ROW = 129;  // a | r | s | h | valid

void prep_range(const uint8_t* pks, const uint64_t* pk_off,
                const uint8_t* msgs, const uint64_t* msg_off,
                const uint8_t* sigs, const uint64_t* sig_off,
                int64_t n, int64_t start, int64_t end, uint8_t* out) {
  for (int64_t i = start; i < end; i++) {
    uint8_t* row = out + ROW * i;
    std::memset(row, 0, ROW);
    if (i >= n) continue;  // padding
    const uint64_t pk_len = pk_off[i + 1] - pk_off[i];
    const uint64_t sig_len = sig_off[i + 1] - sig_off[i];
    if (pk_len != 32 || sig_len != 64) continue;
    const uint8_t* pk = pks + pk_off[i];
    const uint8_t* sig = sigs + sig_off[i];
    const uint8_t* r = sig;
    const uint8_t* s = sig + 32;
    if (!scalar_in_range(s)) continue;
    Sha512 ctx;
    ctx.update(r, 32);
    ctx.update(pk, 32);
    ctx.update(msgs + msg_off[i], msg_off[i + 1] - msg_off[i]);
    uint8_t digest[64];
    ctx.final(digest);
    std::memcpy(row, pk, 32);
    std::memcpy(row + 32, r, 32);
    std::memcpy(row + 64, s, 32);
    mod_l(digest, row + 96);
    row[128] = 1;
  }
}

}  // namespace

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
