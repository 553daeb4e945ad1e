// Sanitizer harness for the native ingest library (at2_ingest.cpp), built
// by tests/test_torch_native_sanitize.py under -fsanitize=thread and under
// -fsanitize=address.
//
// Proves, under TSAN, that at2_verify_bulk's thread fan-out is race-free
// (per-thread EVP contexts and pkey caches, disjoint output ranges) and
// bit-identical across thread counts; exercises at2_parse_frames over
// adversarial frames (truncations, unknown kinds, empty frames) under
// ASAN for memory safety; drives the native channel reader's thread over
// a socketpair (its queue and wake protocol under TSAN, a tampered frame
// killing the channel).
//
// Build: g++ -std=c++17 -O1 -g -fsanitize=thread at2_ingest.cpp \
//            sanitize_ingest_test.cpp -o t -lpthread -l:libcrypto.so.3 && ./t

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

extern "C" {
int64_t at2_parse_frames(const uint8_t*, const uint64_t*, int64_t, uint8_t*,
                         int64_t, uint32_t*, uint8_t*);
void at2_verify_bulk(const uint8_t*, const uint64_t*, const uint8_t*,
                     const uint64_t*, const uint8_t*, const uint64_t*,
                     int64_t, int64_t, uint8_t*);
int64_t at2_ingest_row_stride(void);
void* at2_reader_start(int fd, const uint8_t* key, int wake_fd);
int64_t at2_reader_take(void*, uint8_t*, int64_t, uint64_t*, int64_t,
                        int32_t*, uint64_t*);
void at2_reader_stop(void*);

// encrypt side for the reader test (stable libcrypto ABI)
typedef struct evp_cipher_st EVP_CIPHER;
typedef struct evp_cipher_ctx_st EVP_CIPHER_CTX;
typedef struct engine_st ENGINE;
const EVP_CIPHER* EVP_chacha20_poly1305(void);
EVP_CIPHER_CTX* EVP_CIPHER_CTX_new(void);
void EVP_CIPHER_CTX_free(EVP_CIPHER_CTX*);
int EVP_EncryptInit_ex(EVP_CIPHER_CTX*, const EVP_CIPHER*, ENGINE*,
                       const unsigned char*, const unsigned char*);
int EVP_CIPHER_CTX_ctrl(EVP_CIPHER_CTX*, int, int, void*);
int EVP_EncryptUpdate(EVP_CIPHER_CTX*, unsigned char*, int*,
                      const unsigned char*, int);
int EVP_EncryptFinal_ex(EVP_CIPHER_CTX*, unsigned char*, int*);
}

static constexpr int kSetIvlen = 0x9, kGetTag = 0x10;

// transport.py wire format: u32-LE ct length || ct (payload + 16B tag),
// nonce = LE counter || 4 zero bytes
static std::vector<uint8_t> encrypt_frame(const uint8_t key[32], uint64_t ctr,
                                          const std::vector<uint8_t>& pt) {
  EVP_CIPHER_CTX* ctx = EVP_CIPHER_CTX_new();
  uint8_t iv[12] = {0};
  for (int i = 0; i < 8; i++) iv[i] = uint8_t(ctr >> (8 * i));
  std::vector<uint8_t> ct(pt.size() + 16);
  int outl = 0, finl = 0;
  bool ok = EVP_EncryptInit_ex(ctx, EVP_chacha20_poly1305(), nullptr, nullptr,
                               nullptr) == 1 &&
            EVP_CIPHER_CTX_ctrl(ctx, kSetIvlen, 12, nullptr) == 1 &&
            EVP_EncryptInit_ex(ctx, nullptr, nullptr, key, iv) == 1 &&
            EVP_EncryptUpdate(ctx, ct.data(), &outl, pt.data(),
                              int(pt.size())) == 1 &&
            EVP_EncryptFinal_ex(ctx, ct.data() + outl, &finl) == 1 &&
            EVP_CIPHER_CTX_ctrl(ctx, kGetTag, 16,
                                ct.data() + pt.size()) == 1;
  EVP_CIPHER_CTX_free(ctx);
  if (!ok) { std::fprintf(stderr, "encrypt_frame failed\n"); std::exit(1); }
  std::vector<uint8_t> frame(4 + ct.size());
  uint32_t len = uint32_t(ct.size());
  for (int i = 0; i < 4; i++) frame[i] = uint8_t(len >> (8 * i));
  std::memcpy(frame.data() + 4, ct.data(), ct.size());
  return frame;
}

// drive the reader over a socketpair: frames round-trip byte-identical
// and in order; a tampered frame flips status to 2. Under TSAN this is
// the race check for the reader thread's queue/wake protocol.
static int reader_check() {
  uint8_t key[32];
  for (int i = 0; i < 32; i++) key[i] = uint8_t(i * 7 + 1);
  int socks[2];
  if (socketpair(AF_UNIX, SOCK_STREAM, 0, socks) != 0) return 1;
  int pipefd[2];
  if (pipe(pipefd) != 0) return 1;
  void* r = at2_reader_start(socks[1], key, pipefd[1]);

  std::vector<std::vector<uint8_t>> payloads;
  payloads.push_back({});  // empty frame is legal (tag-only ciphertext)
  for (int n = 1; n <= 64; n++)
    payloads.emplace_back(size_t(n * 37 % 3000), uint8_t(n));
  uint64_t ctr = 0;
  for (auto& p : payloads) {
    auto f = encrypt_frame(key, ctr++, p);
    if (::write(socks[0], f.data(), f.size()) != ssize_t(f.size())) return 1;
  }

  std::vector<uint8_t> buf(1 << 20);
  std::vector<uint64_t> offsets(4097);
  size_t got = 0;
  int32_t status = 0;
  uint64_t drops = 0;
  while (got < payloads.size()) {
    struct pollfd pfd{pipefd[0], POLLIN, 0};
    if (poll(&pfd, 1, 5000) <= 0) {
      std::fprintf(stderr, "reader never woke\n");
      return 1;
    }
    uint8_t scratch[256];
    (void)!::read(pipefd[0], scratch, sizeof scratch);
    for (;;) {
      int64_t n = at2_reader_take(r, buf.data(), int64_t(buf.size()),
                                  offsets.data(), 4096, &status, &drops);
      if (n <= 0) break;
      for (int64_t i = 0; i < n; i++) {
        const auto& want = payloads[got];
        size_t len = size_t(offsets[i + 1] - offsets[i]);
        if (len != want.size() ||
            std::memcmp(buf.data() + offsets[i], want.data(), len) != 0) {
          std::fprintf(stderr, "frame %zu mismatch\n", got);
          return 1;
        }
        got++;
      }
    }
  }
  if (status != 0 || drops != 0) return 1;

  // tamper: one flipped ciphertext bit must kill the channel (status 2)
  auto evil = encrypt_frame(key, ctr++, {1, 2, 3});
  evil[9] ^= 1;
  if (::write(socks[0], evil.data(), evil.size()) != ssize_t(evil.size()))
    return 1;
  for (int tries = 0; tries < 50 && status == 0; tries++) {
    struct pollfd pfd{pipefd[0], POLLIN, 0};
    poll(&pfd, 1, 200);
    uint8_t scratch[64];
    (void)!::read(pipefd[0], scratch, sizeof scratch);
    at2_reader_take(r, buf.data(), int64_t(buf.size()), offsets.data(), 4096,
                    &status, &drops);
  }
  if (status != 2) {
    std::fprintf(stderr, "tamper not detected: status=%d\n", status);
    return 1;
  }
  at2_reader_stop(r);
  close(socks[0]);
  close(socks[1]);
  close(pipefd[0]);
  close(pipefd[1]);
  return 0;
}

int main() {
  const int64_t stride = at2_ingest_row_stride();

  // -- parse: adversarial frame mix under ASAN ------------------------
  uint64_t seed = 0x9E3779B97F4A7C15ULL;
  auto next = [&seed]() {
    seed ^= seed << 13;
    seed ^= seed >> 7;
    seed ^= seed << 17;
    return static_cast<uint8_t>(seed);
  };
  std::vector<uint8_t> flat;
  std::vector<uint64_t> offsets{0};
  auto add_frame = [&](std::vector<uint8_t> f) {
    flat.insert(flat.end(), f.begin(), f.end());
    offsets.push_back(flat.size());
  };
  std::vector<uint8_t> gossip(141, 0);
  gossip[0] = 1;
  for (size_t i = 1; i < gossip.size(); i++) gossip[i] = next();
  std::vector<uint8_t> attest(165, 0);
  attest[0] = 2;
  for (size_t i = 1; i < attest.size(); i++) attest[i] = next();
  std::vector<uint8_t> request(69, 0);
  request[0] = 4;
  add_frame(gossip);
  add_frame(attest);
  add_frame(request);
  {
    auto both = gossip;
    both.insert(both.end(), attest.begin(), attest.end());
    add_frame(both);
  }
  add_frame({});                            // empty frame: ok, no messages
  add_frame({0xff, 0x01, 0x02});            // unknown kind
  add_frame(std::vector<uint8_t>(gossip.begin(), gossip.end() - 1));  // short
  add_frame({1});                           // kind byte only
  // catchup plane: HIST_IDX_REQ, HIST_BATCH carrying 2 payload bodies,
  // a HIST_BATCH whose count overruns the bytes (whole frame drops),
  // and a truncated HIST_IDX header
  add_frame({5, 1, 2, 3, 4, 5, 6, 7, 8});
  {
    std::vector<uint8_t> batch{8, 9, 9, 9, 9, 9, 9, 9, 9, 2, 0, 0, 0};
    for (int i = 0; i < 280; i++) batch.push_back(next());
    add_frame(batch);
    std::vector<uint8_t> overrun{8, 9, 9, 9, 9, 9, 9, 9, 9, 3, 0, 0, 0};
    for (int i = 0; i < 280; i++) overrun.push_back(next());
    add_frame(overrun);
  }
  add_frame({6, 1, 2, 3});                  // truncated HIST_IDX header
  // batched broadcast plane (kinds 9-12): a 2-entry TxBatch, a batch
  // whose count field overruns the cap (frame drops whole), a batch
  // attestation with an 8-byte bitmap, one with bm_len > 128 (drops),
  // and a BatchContentRequest
  {
    std::vector<uint8_t> batch{9};
    for (int i = 0; i < 40; i++) batch.push_back(next());  // origin+seq
    batch.push_back(2); batch.push_back(0); batch.push_back(0);
    batch.push_back(0);                                    // count = 2
    for (int i = 0; i < 64 + 2 * 140; i++) batch.push_back(next());
    add_frame(batch);
    std::vector<uint8_t> overcount{9};
    for (int i = 0; i < 40; i++) overcount.push_back(next());
    overcount.push_back(0x01); overcount.push_back(0x04);  // count 1025
    overcount.push_back(0); overcount.push_back(0);
    for (int i = 0; i < 64 + 140; i++) overcount.push_back(next());
    add_frame(overcount);
    std::vector<uint8_t> batt{10};
    for (int i = 0; i < 104; i++) batt.push_back(next());  // header pre-len
    batt.push_back(8); batt.push_back(0); batt.push_back(0);
    batt.push_back(0);                                     // bm_len = 8
    for (int i = 0; i < 8 + 64; i++) batt.push_back(next());
    add_frame(batt);
    std::vector<uint8_t> wide{11};
    for (int i = 0; i < 104; i++) wide.push_back(next());
    wide.push_back(0x81); wide.push_back(0);               // bm_len = 129
    wide.push_back(0); wide.push_back(0);
    for (int i = 0; i < 129 + 64; i++) wide.push_back(next());
    add_frame(wide);
    std::vector<uint8_t> breq(73, 0);
    breq[0] = 12;
    for (size_t i = 1; i < breq.size(); i++) breq[i] = next();
    add_frame(breq);
  }

  int64_t n_frames = int64_t(offsets.size()) - 1;
  int64_t cap = 64;
  std::vector<uint8_t> rows(size_t(cap) * size_t(stride), 0);
  std::vector<uint32_t> msg_frame(size_t(cap), 0);
  std::vector<uint8_t> frame_ok(size_t(n_frames), 9);
  int64_t n = at2_parse_frames(flat.data(), offsets.data(), n_frames,
                               rows.data(), cap, msg_frame.data(),
                               frame_ok.data());
  const uint8_t want_ok[17] = {1, 1, 1, 1, 1, 0, 0, 0, 1, 1, 0, 0,
                               1, 0, 1, 0, 1};
  if (n != 10 || std::memcmp(frame_ok.data(), want_ok, 17) != 0) {
    std::fprintf(stderr, "FAIL: parse results n=%lld\n", (long long)n);
    return 1;
  }

  // -- verify: thread-count bit-identity under TSAN -------------------
  // (contents are junk; identical verdicts across thread counts is the
  // property — EVP rejects junk deterministically)
  const int64_t k = 96;
  std::vector<uint8_t> pks(k * 32), msgs(k * 33), sigs(k * 64);
  std::vector<uint64_t> pk_off(k + 1), msg_off(k + 1), sig_off(k + 1);
  for (auto& b : pks) b = next();
  for (auto& b : msgs) b = next();
  for (auto& b : sigs) b = next();
  // repeat a few pubkeys to exercise the per-thread cache paths
  for (int64_t i = 8; i < k; i += 7)
    std::memcpy(&pks[i * 32], &pks[0], 32);
  for (int64_t i = 0; i <= k; i++) {
    pk_off[i] = uint64_t(i) * 32;
    msg_off[i] = uint64_t(i) * 33;
    sig_off[i] = uint64_t(i) * 64;
  }
  auto run = [&](int64_t threads) {
    std::vector<uint8_t> out(k, 7);
    at2_verify_bulk(pks.data(), pk_off.data(), msgs.data(), msg_off.data(),
                    sigs.data(), sig_off.data(), k, threads, out.data());
    return out;
  };
  auto serial = run(1);
  for (int64_t threads : {2, 4, 8}) {
    if (run(threads) != serial) {
      std::fprintf(stderr, "FAIL: %lld-thread verify differs\n",
                   (long long)threads);
      return 1;
    }
  }
  // -- native channel reader under TSAN/ASAN --------------------------
  if (reader_check() != 0) {
    std::fprintf(stderr, "FAIL: reader check\n");
    return 1;
  }

  std::printf("sanitize_ingest_test: OK\n");
  return 0;
}
