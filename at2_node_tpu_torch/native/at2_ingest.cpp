// Native message-plane ingest for the broadcast stack.
//
// The reference runs its message plane on native worker threads
// (at2-node/src/bin/server/rpc.rs:125 — num_cpus broadcast tasks
// in a compiled runtime); this build keeps the state machine in Python
// (single-writer asyncio, SURVEY.md §5) and moves the per-message grind
// here, called ONCE per worker chunk with the GIL released (ctypes):
//
//  * at2_parse_frames — wire-frame parsing for a whole chunk of frames:
//    kind dispatch, fixed-record extraction, and the SHA-256 payload
//    content hash (sieve's equivocation unit, broadcast/messages.py
//    Payload.content_hash) computed inline while the bytes are hot.
//  * at2_verify_bulk — ed25519 verification for every signature the
//    chunk needs, one call, fanned out over std::thread workers, each
//    thread reusing an EVP context and a per-call pubkey-object cache
//    (origins repeat heavily inside a chunk: echo/ready votes come from
//    the same small peer set). Backed by the system libcrypto
//    (OpenSSL 3), the same engine the Python `cryptography` path uses,
//    so verdicts are bit-identical with keys.verify_one.
//
// Wire layout parity (broadcast/messages.py, all integers LE):
//   GOSSIP       = 0x01 | sender(32) seq(u32) recipient(32) amount(u64) sig(64)
//   ECHO         = 0x02 | origin(32) sender(32) seq(u32) chash(32) sig(64)
//   READY        = 0x03 | (same body as ECHO)
//   REQUEST      = 0x04 | sender(32) seq(u32) chash(32)
//   HIST_IDX_REQ = 0x05 | nonce(u64)
//   HIST_IDX     = 0x06 | nonce(u64) count(u32) count*(sender(32) seq(u32))
//   HIST_REQ     = 0x07 | nonce(u64) sender(32) from(u32) to(u32)
//   HIST_BATCH   = 0x08 | nonce(u64) count(u32) count*(140-byte GOSSIP body)
// content_hash = SHA-256 over the 140-byte GOSSIP body (kind excluded).
// Variable-length kinds (6, 8) don't fit a fixed row: their row stores the
// body's (offset, length) into the caller's flat buffer and Python decodes
// the slice — they are rare control traffic, not the hot path.

#include <atomic>
#include <cerrno>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

#include <sys/socket.h>
#include <unistd.h>

// ---------------- OpenSSL 3 EVP surface (no headers in the image; the
// declarations below are the stable libcrypto ABI) ----------------

extern "C" {
typedef struct evp_pkey_st EVP_PKEY;
typedef struct evp_md_ctx_st EVP_MD_CTX;
typedef struct engine_st ENGINE;
typedef struct evp_md_st EVP_MD;
typedef struct evp_cipher_st EVP_CIPHER;
typedef struct evp_cipher_ctx_st EVP_CIPHER_CTX;
EVP_PKEY* EVP_PKEY_new_raw_public_key(int type, ENGINE* e,
                                      const unsigned char* pub, size_t len);
void EVP_PKEY_free(EVP_PKEY* k);
EVP_MD_CTX* EVP_MD_CTX_new(void);
void EVP_MD_CTX_free(EVP_MD_CTX* ctx);
int EVP_MD_CTX_reset(EVP_MD_CTX* ctx);
int EVP_DigestVerifyInit(EVP_MD_CTX* ctx, void** pctx, const EVP_MD* type,
                         ENGINE* e, EVP_PKEY* pkey);
int EVP_DigestVerify(EVP_MD_CTX* ctx, const unsigned char* sig, size_t siglen,
                     const unsigned char* data, size_t datalen);
const EVP_CIPHER* EVP_chacha20_poly1305(void);
EVP_CIPHER_CTX* EVP_CIPHER_CTX_new(void);
void EVP_CIPHER_CTX_free(EVP_CIPHER_CTX* ctx);
int EVP_DecryptInit_ex(EVP_CIPHER_CTX* ctx, const EVP_CIPHER* cipher,
                       ENGINE* impl, const unsigned char* key,
                       const unsigned char* iv);
int EVP_CIPHER_CTX_ctrl(EVP_CIPHER_CTX* ctx, int type, int arg, void* ptr);
int EVP_DecryptUpdate(EVP_CIPHER_CTX* ctx, unsigned char* out, int* outl,
                      const unsigned char* in, int inl);
int EVP_DecryptFinal_ex(EVP_CIPHER_CTX* ctx, unsigned char* outm, int* outl);
}

static constexpr int kEvpPkeyEd25519 = 1087;  // NID_ED25519
static constexpr int kEvpCtrlAeadSetIvlen = 0x9;
static constexpr int kEvpCtrlAeadSetTag = 0x11;

namespace {

// ---------------- SHA-256 (FIPS 180-4) ----------------

constexpr uint32_t K256[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

inline uint32_t rotr32(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }
inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

// One-shot SHA-256 for short inputs (the 140-byte payload body spans
// exactly two blocks with padding; generic loop kept for clarity).
void sha256(const uint8_t* data, size_t len, uint8_t out[32]) {
  uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                   0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  auto block = [&](const uint8_t* p) {
    uint32_t w[64];
    for (int i = 0; i < 16; i++) w[i] = be32(p + 4 * i);
    for (int i = 16; i < 64; i++) {
      uint32_t s0 = rotr32(w[i - 15], 7) ^ rotr32(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr32(w[i - 2], 17) ^ rotr32(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
    uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
      uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + S1 + ch + K256[i] + w[i];
      uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  };
  size_t off = 0;
  for (; off + 64 <= len; off += 64) block(data + off);
  uint8_t tail[128];
  size_t rem = len - off;
  std::memcpy(tail, data + off, rem);
  tail[rem] = 0x80;
  size_t padded = (rem + 9 <= 64) ? 64 : 128;
  std::memset(tail + rem + 1, 0, padded - rem - 9);
  uint64_t bits = uint64_t(len) * 8;
  for (int i = 0; i < 8; i++) tail[padded - 1 - i] = uint8_t(bits >> (8 * i));
  block(tail);
  if (padded == 128) block(tail + 64);
  for (int i = 0; i < 8; i++) {
    out[4 * i + 0] = uint8_t(h[i] >> 24);
    out[4 * i + 1] = uint8_t(h[i] >> 16);
    out[4 * i + 2] = uint8_t(h[i] >> 8);
    out[4 * i + 3] = uint8_t(h[i]);
  }
}

// ---------------- wire constants (must match broadcast/messages.py) ----

constexpr uint8_t kGossip = 1, kEcho = 2, kReady = 3, kRequest = 4;
constexpr uint8_t kHistIdxReq = 5, kHistIdx = 6, kHistReq = 7, kHistBatch = 8;
constexpr uint8_t kBatch = 9, kBatchEcho = 10, kBatchReady = 11, kBatchReq = 12;
constexpr uint8_t kDirAnnounce = 13, kConfigTx = 14, kBeacon = 15;
constexpr uint8_t kCertSig = 16;
constexpr size_t kPayloadWire = 1 + 140;
constexpr size_t kAttestWire = 1 + 164;
constexpr size_t kRequestWire = 1 + 68;
constexpr size_t kHistIdxReqWire = 1 + 8;
constexpr size_t kHistReqWire = 1 + 48;
constexpr size_t kHistHdrWire = 1 + 12;  // nonce(u64) + count(u32)
constexpr size_t kHistIdxEntry = 36;
constexpr size_t kHistBatchEntry = 140;
// Batched broadcast plane (messages.py BATCH/BATCH_ECHO/BATCH_READY/
// BATCH_REQ):
//   BATCH      = 0x09 | origin(32) batch_seq(u64) count(u32) sig(64)
//                       count*(140-byte GOSSIP body)
//   BATCH_ECHO = 0x0a | origin(32) b_origin(32) b_seq(u64) b_hash(32)
//                       bm_len(u32) bitmap(bm_len) sig(64)
//   BATCH_READY= 0x0b | (same body as BATCH_ECHO)
//   BATCH_REQ  = 0x0c | b_origin(32) b_seq(u64) b_hash(32)
constexpr size_t kBatchHdrWire = 1 + 108;  // header before entries
constexpr size_t kBatchAttWire = 1 + 108 + 64;  // + bitmap between hdr/sig
constexpr size_t kBatchReqWire = 1 + 72;
constexpr uint64_t kMaxBatchEntries = 1024;  // messages.MAX_BATCH_ENTRIES
constexpr uint64_t kMaxBitmapBytes = kMaxBatchEntries / 8;
// DIR_ANNOUNCE = 0x0d | origin(32) count(u32) count*(id(u64) pubkey(32))
constexpr size_t kDirHdrWire = 1 + 36;
constexpr size_t kDirEntry = 40;
constexpr uint64_t kMaxDirEntries = 4096;  // messages.MAX_DIR_ENTRIES
// CONFIG_TX = 0x0e | epoch(u64) len(u32) sig(64) len*JSON bytes
constexpr size_t kConfigHdrWire = 1 + 76;
constexpr uint64_t kMaxConfigBytes = 4096;  // messages.MAX_CONFIG_BYTES
// BEACON = 0x0f | origin(32) epoch(u64) commits(u64) wm(16) ranges(128)
//                 dir(8) chain(32) sig(64) — fixed, messages.BEACON_WIRE
constexpr size_t kBeaconWire = 1 + 232 + 64;
// CERT_SIG = 0x10 | origin(32) epoch(u64) commits(u64) wm(16) ranges(128)
//                   dir(8) sig(64) — fixed, messages.CERT_SIG_WIRE
constexpr size_t kCertSigWire = 1 + 200 + 64;
constexpr size_t kMinWire = kHistIdxReqWire;  // smallest message on the wire
// A legitimate frame coalesces at most MAX_BATCH_MSGS = 1024 messages
// (net/peers.py); 4x that is the malformed-frame bound. Without it a
// frame dense with 9-byte messages forces a row allocation ~8x the frame
// size and millions of Python objects downstream.
constexpr int64_t kMaxMsgsPerFrame = 4096;

inline uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
         (uint32_t(p[3]) << 24);
}

inline uint64_t le64(const uint8_t* p) {
  return uint64_t(le32(p)) | (uint64_t(le32(p + 4)) << 32);
}

// Output record: one fixed-stride row per message.
//   byte 0            : kind (0 = row unused)
//   GOSSIP  row [1..141): the 140-byte wire body, [141..173): content hash
//   ECHO/READY [1..165): the 164-byte wire body
//   REQUEST row [1..69) : the 68-byte wire body
//   HIST_IDX_REQ [1..9) : the 8-byte wire body
//   HIST_REQ  row [1..49): the 48-byte wire body
//   HIST_IDX / HIST_BATCH [1..9): u64 LE body offset into `flat`,
//                         [9..17): u64 LE body length (incl. the header)
constexpr size_t kRowStride = 176;  // 173 rounded up for alignment

inline void put_le64(uint8_t* p, uint64_t v) {
  for (int i = 0; i < 8; i++) p[i] = uint8_t(v >> (8 * i));
}

inline void put_le32(uint8_t* p, uint32_t v) {
  for (int i = 0; i < 4; i++) p[i] = uint8_t(v >> (8 * i));
}

// ---------------- distilled frames (proto/distill.py reference) --------

constexpr uint8_t kDistillMagic = 0xD5, kDistillVersion = 0x01;
constexpr uint64_t kDistillMaxEntries = 4096;  // distill.DISTILL_MAX_ENTRIES
constexpr size_t kEntryWire = 140;
constexpr size_t kSigWire = 64;

// LEB128 u64 with exactly distill._read_varint's acceptance set: up to
// 10 bytes, values <= 2^64-1, non-minimal encodings allowed (the Python
// and native decoders must accept/reject identical byte strings — they
// are differential-tested in tests/test_distill.py).
inline bool read_varint(const uint8_t* buf, size_t len, size_t& off,
                        uint64_t& out) {
  uint64_t result = 0;
  int shift = 0;
  for (int i = 0; i < 10; i++) {
    if (off >= len) return false;
    uint8_t b = buf[off++];
    uint64_t bits = uint64_t(b & 0x7F);
    if (shift == 63 && bits > 1) return false;  // > 2^64-1
    result |= bits << shift;
    if (!(b & 0x80)) {
      out = result;
      return true;
    }
    shift += 7;
  }
  return false;  // longer than 10 bytes
}

}  // namespace

extern "C" {

// Shared parse loop behind at2_parse_frames and at2_plane_drain: when
// `shard_ids` is non-null, every row additionally gets its owning
// shard — computed from the SLOT origin key exactly like
// broadcast/shards.shard_of (first 8 key bytes, little-endian, modulo):
//   GOSSIP/REQUEST            -> sender      (body offset 0)
//   ECHO/READY                -> sender      (body offset 32; byte 0..32
//                                             is the attesting origin)
//   BATCH/BATCH_REQ           -> batch origin (body offset 0)
//   BATCH_ECHO/BATCH_READY    -> batch origin (body offset 32)
//   control kinds             -> shard 0 (stateless wrt shard slots)
static int64_t parse_frames_impl(const uint8_t* flat, const uint64_t* offsets,
                                 int64_t n_frames, uint8_t* rows, int64_t cap,
                                 uint32_t* msg_frame, uint8_t* frame_ok,
                                 int64_t shards, uint32_t* shard_ids) {
  int64_t n_out = 0;
  for (int64_t f = 0; f < n_frames; f++) {
    const uint8_t* p = flat + offsets[f];
    const uint8_t* end = flat + offsets[f + 1];
    int64_t start = n_out;
    bool ok = true;
    while (p < end) {
      size_t left = size_t(end - p);
      uint8_t kind = p[0];
      size_t wire;
      if (kind == kGossip) wire = kPayloadWire;
      else if (kind == kEcho || kind == kReady) wire = kAttestWire;
      else if (kind == kRequest) wire = kRequestWire;
      else if (kind == kHistIdxReq) wire = kHistIdxReqWire;
      else if (kind == kHistReq) wire = kHistReqWire;
      else if (kind == kHistIdx || kind == kHistBatch) {
        if (left < kHistHdrWire) { ok = false; break; }
        uint64_t count = le32(p + 9);
        size_t entry = (kind == kHistIdx) ? kHistIdxEntry : kHistBatchEntry;
        wire = kHistHdrWire + size_t(count) * entry;  // < 2^40, no overflow
      } else if (kind == kBatch) {
        if (left < kBatchHdrWire) { ok = false; break; }
        uint64_t count = le32(p + 1 + 40);  // after origin(32) + seq(8)
        if (count < 1 || count > kMaxBatchEntries) { ok = false; break; }
        wire = kBatchHdrWire + size_t(count) * kHistBatchEntry;
      } else if (kind == kBatchEcho || kind == kBatchReady) {
        if (left < kBatchAttWire) { ok = false; break; }
        uint64_t bm_len = le32(p + 1 + 104);  // last header field
        if (bm_len > kMaxBitmapBytes) { ok = false; break; }
        wire = kBatchAttWire + size_t(bm_len);
      } else if (kind == kBatchReq) {
        wire = kBatchReqWire;
      } else if (kind == kDirAnnounce) {
        if (left < kDirHdrWire) { ok = false; break; }
        uint64_t count = le32(p + 1 + 32);
        if (count > kMaxDirEntries) { ok = false; break; }
        wire = kDirHdrWire + size_t(count) * kDirEntry;
      } else if (kind == kConfigTx) {
        if (left < kConfigHdrWire) { ok = false; break; }
        uint64_t body_len = le32(p + 1 + 8);  // after epoch(u64)
        if (body_len > kMaxConfigBytes) { ok = false; break; }
        wire = kConfigHdrWire + size_t(body_len);
      } else if (kind == kBeacon) {
        wire = kBeaconWire;  // fixed but wider than kRowStride
      } else if (kind == kCertSig) {
        wire = kCertSigWire;  // fixed but wider than kRowStride
      } else { ok = false; break; }
      if (left < wire) { ok = false; break; }
      if (n_out - start >= kMaxMsgsPerFrame) { ok = false; break; }
      if (n_out >= cap) return -1;
      uint8_t* row = rows + n_out * kRowStride;
      row[0] = kind;
      if (kind == kHistIdx || kind == kHistBatch || kind == kBatch ||
          kind == kBatchEcho || kind == kBatchReady || kind == kDirAnnounce ||
          kind == kConfigTx || kind == kBeacon || kind == kCertSig) {
        // variable-length kinds (and the beacon/cert co-sig, whose fixed
        // bodies are wider than kRowStride): row carries (offset, length)
        // into `flat`
        put_le64(row + 1, uint64_t(p + 1 - flat));
        put_le64(row + 9, uint64_t(wire - 1));
      } else {
        std::memcpy(row + 1, p + 1, wire - 1);
        if (kind == kGossip) sha256(p + 1, 140, row + 141);
      }
      if (shard_ids != nullptr) {
        const uint8_t* rkey = nullptr;
        if (kind == kGossip || kind == kRequest || kind == kBatch ||
            kind == kBatchReq) {
          rkey = p + 1;  // sender / batch origin leads the body
        } else if (kind == kEcho || kind == kReady || kind == kBatchEcho ||
                   kind == kBatchReady) {
          rkey = p + 33;  // slot key follows the attesting origin
        }
        shard_ids[n_out] =
            rkey ? uint32_t(le64(rkey) % uint64_t(shards)) : 0;
      }
      msg_frame[n_out] = uint32_t(f);
      n_out++;
      p += wire;
    }
    frame_ok[f] = ok ? 1 : 0;
    if (!ok) n_out = start;  // drop the whole frame, like parse_frame
  }
  return n_out;
}

// Parse n_frames concatenated-message frames (flat + offsets, like the
// prep library's ragged layout) into fixed rows. Returns the number of
// messages written, or -1 if `cap` rows were not enough (caller resizes
// and retries). A malformed frame sets frame_ok[f]=0 and contributes no
// rows (mirrors on_frame's per-frame drop); well-formed frames set 1.
// msg_frame[i] = source frame index of row i (the peer association).
int64_t at2_parse_frames(const uint8_t* flat, const uint64_t* offsets,
                         int64_t n_frames, uint8_t* rows, int64_t cap,
                         uint32_t* msg_frame, uint8_t* frame_ok) {
  return parse_frames_impl(flat, offsets, n_frames, rows, cap, msg_frame,
                           frame_ok, 1, nullptr);
}

// The owner drain loop's ONE GIL-released call: parse a whole
// chunk of frames AND route every row to its owning shard in the same
// pass, so the Python side goes straight from raw frames to per-shard
// record batches with no per-message isinstance dispatch. Outputs are
// at2_parse_frames' plus shard_ids[i] (owning shard of row i) and
// shard_counts[s] (rows routed to shard s, rollback-corrected for
// malformed frames). Quorum folding stays in at2_counts_add /
// at2_quorum_mask, which the shard cores call per transition — this
// kernel's job is everything BEFORE the cores: validate, extract, hash,
// route, tally.
int64_t at2_plane_drain(const uint8_t* flat, const uint64_t* offsets,
                        int64_t n_frames, int64_t shards, uint8_t* rows,
                        int64_t cap, uint32_t* msg_frame, uint8_t* frame_ok,
                        uint32_t* shard_ids, int64_t* shard_counts) {
  if (shards <= 0) return -2;
  int64_t n = parse_frames_impl(flat, offsets, n_frames, rows, cap,
                                msg_frame, frame_ok, shards, shard_ids);
  if (n < 0) return n;
  for (int64_t s = 0; s < shards; s++) shard_counts[s] = 0;
  for (int64_t i = 0; i < n; i++) shard_counts[shard_ids[i]]++;
  return n;
}

// Bulk ed25519 verify: out[i] = 1 iff signature i verifies under OpenSSL
// (bit-identical verdicts with crypto/keys.verify_one — same libcrypto).
// Ragged inputs like at2_prep_batch; fans out over n_threads.
void at2_verify_bulk(const uint8_t* pk_flat, const uint64_t* pk_off,
                     const uint8_t* msg_flat, const uint64_t* msg_off,
                     const uint8_t* sig_flat, const uint64_t* sig_off,
                     int64_t n, int64_t n_threads, uint8_t* out) {
  if (n <= 0) return;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;

  auto worker = [&](int64_t lo, int64_t hi) {
    // per-thread pubkey-object cache: echo/ready origins inside one
    // chunk come from the same handful of peers
    struct KeyHash {
      size_t operator()(const std::vector<uint8_t>& k) const {
        uint64_t h = 1469598103934665603ULL;
        for (uint8_t b : k) { h ^= b; h *= 1099511628211ULL; }
        return size_t(h);
      }
    };
    std::unordered_map<std::vector<uint8_t>, EVP_PKEY*, KeyHash> cache;
    EVP_MD_CTX* ctx = EVP_MD_CTX_new();
    for (int64_t i = lo; i < hi; i++) {
      out[i] = 0;
      size_t pk_len = size_t(pk_off[i + 1] - pk_off[i]);
      size_t sig_len = size_t(sig_off[i + 1] - sig_off[i]);
      if (pk_len != 32 || sig_len != 64 || ctx == nullptr) continue;
      std::vector<uint8_t> key(pk_flat + pk_off[i], pk_flat + pk_off[i + 1]);
      EVP_PKEY* pkey;
      auto it = cache.find(key);
      if (it != cache.end()) {
        pkey = it->second;
      } else {
        pkey = EVP_PKEY_new_raw_public_key(kEvpPkeyEd25519, nullptr,
                                           key.data(), 32);
        cache.emplace(std::move(key), pkey);  // cache NULL too (bad key)
      }
      if (pkey == nullptr) continue;
      // one-shot EdDSA contexts don't re-init cleanly: reset between items
      EVP_MD_CTX_reset(ctx);
      if (EVP_DigestVerifyInit(ctx, nullptr, nullptr, nullptr, pkey) != 1)
        continue;
      int rc = EVP_DigestVerify(ctx, sig_flat + sig_off[i], 64,
                                msg_flat + msg_off[i],
                                size_t(msg_off[i + 1] - msg_off[i]));
      out[i] = (rc == 1) ? 1 : 0;
    }
    EVP_MD_CTX_free(ctx);
    for (auto& kv : cache)
      if (kv.second != nullptr) EVP_PKEY_free(kv.second);
  };

  if (n_threads == 1) {
    worker(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t step = (n + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; t++) {
    int64_t lo = t * step;
    int64_t hi = lo + step < n ? lo + step : n;
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
}

// Distilled-frame bulk parse + expansion (the broker ingress fast path;
// proto/distill.py documents the wire format and is the reference
// decoder). One GIL-released pass: decode the varint/delta head, resolve
// sender/recipient client-ids against the directory table (`dir_keys` =
// dir_count x 32 contiguous rows, an all-zero row means unassigned), and
// expand every entry to its 140-byte canonical GOSSIP body — exactly the
// `entries_raw` bytes TxBatch carries — with the columnar signature
// copied in. No per-entry Python objects are ever built on this path.
//
// Returns the entry count, or -1 on any malformation (same acceptance
// set as distill.decode). Per entry i: out_ids[i] = sender client-id,
// out_ok[i] = 1 iff both sender and recipient ids resolved (misses zero
// the unresolved field; the caller counts them as directory_misses and
// drops the entry before verification).
int64_t at2_distill_parse(const uint8_t* frame, int64_t frame_len,
                          const uint8_t* dir_keys, int64_t dir_count,
                          uint8_t* out_bodies, uint64_t* out_ids,
                          uint8_t* out_ok, int64_t cap) {
  static const uint8_t kZero32[32] = {0};
  if (frame_len < 4) return -1;
  size_t len = size_t(frame_len);
  if (frame[0] != kDistillMagic || frame[1] != kDistillVersion) return -1;
  size_t off = 2;
  uint64_t n_groups, n_entries;
  if (!read_varint(frame, len, off, n_groups)) return -1;
  if (!read_varint(frame, len, off, n_entries)) return -1;
  if (n_groups == 0 || n_entries == 0) return -1;
  if (n_entries > kDistillMaxEntries || n_groups > n_entries) return -1;
  if (int64_t(n_entries) > cap) return -1;
  uint64_t sig_len = n_entries * kSigWire;
  if (len < off + sig_len) return -1;
  size_t sig_start = len - size_t(sig_len);

  auto resolve = [&](uint64_t id) -> const uint8_t* {
    if (id >= uint64_t(dir_count)) return nullptr;
    const uint8_t* row = dir_keys + size_t(id) * 32;
    if (std::memcmp(row, kZero32, 32) == 0) return nullptr;
    return row;
  };

  int64_t n_out = 0;
  uint64_t prev_id = 0;
  bool first_group = true;
  for (uint64_t g = 0; g < n_groups; g++) {
    uint64_t delta, gid;
    if (!read_varint(frame, len, off, delta)) return -1;
    if (first_group) {
      gid = delta;
      first_group = false;
    } else {
      if (delta == 0) return -1;  // ids not strictly increasing
      if (delta > UINT64_MAX - prev_id) return -1;  // id exceeds u64
      gid = prev_id + delta;
    }
    prev_id = gid;
    uint64_t n;
    if (!read_varint(frame, len, off, n)) return -1;
    if (n == 0 || uint64_t(n_out) + n > n_entries) return -1;
    const uint8_t* sender = resolve(gid);
    uint64_t prev_seq = 0;
    for (uint64_t e = 0; e < n; e++) {
      uint64_t sd;
      if (!read_varint(frame, len, off, sd)) return -1;
      if (sd == 0) return -1;  // seqs not strictly increasing
      uint64_t seq = prev_seq + sd;
      if (seq > 0xFFFFFFFFULL) return -1;  // sequence exceeds u32
      prev_seq = seq;
      uint64_t rtag;
      if (!read_varint(frame, len, off, rtag)) return -1;
      const uint8_t* recipient;
      bool recipient_ok;
      if (rtag == 0) {
        if (off + 32 > sig_start) return -1;  // truncated raw recipient
        recipient = frame + off;
        recipient_ok = true;
        off += 32;
      } else {
        recipient = resolve(rtag - 1);
        recipient_ok = recipient != nullptr;
      }
      uint64_t amount;
      if (!read_varint(frame, len, off, amount)) return -1;
      if (off > sig_start) return -1;  // head overruns signature block
      uint8_t* body = out_bodies + size_t(n_out) * kEntryWire;
      std::memcpy(body, sender != nullptr ? sender : kZero32, 32);
      put_le32(body + 32, uint32_t(seq));
      std::memcpy(body + 36, recipient != nullptr ? recipient : kZero32, 32);
      put_le64(body + 68, amount);
      std::memcpy(body + 76, frame + sig_start + size_t(n_out) * kSigWire,
                  kSigWire);
      out_ids[n_out] = gid;
      out_ok[n_out] = (sender != nullptr && recipient_ok) ? 1 : 0;
      n_out++;
    }
  }
  if (uint64_t(n_out) != n_entries) return -1;
  if (off != sig_start) return -1;  // trailing bytes before signatures
  return n_out;
}

}  // extern "C"

// ---------------- native channel reader ----------------
//
// One thread per INBOUND mesh connection (the responder side only ever
// reads — net/peers.py's one-connection-per-ordered-pair design). The
// thread owns the socket reads, the per-frame ChaCha20-Poly1305
// decryption (transport.py wire format: u32-LE ciphertext length ||
// ciphertext, nonce = LE frame counter || 4 zero bytes, 16-byte tag
// appended), and frame assembly; decrypted frames accumulate in a
// byte-bounded queue and Python is woken via ONE pipe byte per
// empty->nonempty transition — collapsing the per-frame event-loop
// wakeups that profiling showed were the plane's asyncio floor
// (BENCH_E2E.json analysis). Parsing stays in the existing per-chunk
// native call, so the inbox byte budget and catchup plane are
// untouched.

namespace {

constexpr size_t kReaderMaxFrame = 16 * 1024 * 1024;  // transport.MAX_FRAME
constexpr size_t kReaderQueueBytes = 32 * 1024 * 1024;

struct At2Reader {
  int fd = -1;
  int wake_fd = -1;
  uint8_t key[32];
  uint64_t ctr = 0;
  std::thread thread;
  std::mutex mu;
  std::deque<std::vector<uint8_t>> pending;
  size_t pending_bytes = 0;
  int32_t status = 0;  // 0 open, 1 clean eof, 2 protocol/decrypt error
  uint64_t drops = 0;
  std::atomic<bool> stopping{false};

  bool read_exact(uint8_t* buf, size_t n) {
    size_t off = 0;
    while (off < n) {
      ssize_t r = ::read(fd, buf + off, n - off);
      if (r > 0) {
        off += size_t(r);
      } else if (r == 0) {
        return false;  // eof
      } else if (errno == EINTR) {
        continue;
      } else {
        return false;
      }
    }
    return true;
  }

  void wake() {
    uint8_t b = 1;
    // best-effort: a full pipe already guarantees a pending wakeup
    (void)!::write(wake_fd, &b, 1);
  }

  void finish(int32_t st) {
    {
      std::lock_guard<std::mutex> lock(mu);
      status = st;
    }
    wake();
  }

  void run() {
    EVP_CIPHER_CTX* ctx = EVP_CIPHER_CTX_new();
    if (ctx == nullptr) { finish(2); return; }
    std::vector<uint8_t> ct, pt;
    while (!stopping.load(std::memory_order_relaxed)) {
      uint8_t hdr[4];
      if (!read_exact(hdr, 4)) { finish(1); break; }
      uint32_t len = le32(hdr);
      if (len < 16 || len > kReaderMaxFrame) { finish(2); break; }
      ct.resize(len);
      if (!read_exact(ct.data(), len)) { finish(1); break; }
      uint8_t iv[12] = {0};
      uint64_t c = ctr++;
      for (int i = 0; i < 8; i++) iv[i] = uint8_t(c >> (8 * i));
      pt.resize(len - 16);
      int outl = 0, finl = 0;
      bool ok = EVP_DecryptInit_ex(ctx, EVP_chacha20_poly1305(), nullptr,
                                   nullptr, nullptr) == 1 &&
                EVP_CIPHER_CTX_ctrl(ctx, kEvpCtrlAeadSetIvlen, 12,
                                    nullptr) == 1 &&
                EVP_DecryptInit_ex(ctx, nullptr, nullptr, key, iv) == 1 &&
                EVP_DecryptUpdate(ctx, pt.data(), &outl, ct.data(),
                                  int(len - 16)) == 1 &&
                EVP_CIPHER_CTX_ctrl(ctx, kEvpCtrlAeadSetTag, 16,
                                    ct.data() + (len - 16)) == 1 &&
                EVP_DecryptFinal_ex(ctx, pt.data() + outl, &finl) == 1;
      if (!ok || size_t(outl + finl) != pt.size()) {
        finish(2);  // bad tag == wire corruption/attacker: channel-fatal
        break;
      }
      bool was_empty;
      {
        std::lock_guard<std::mutex> lock(mu);
        if (pending_bytes + pt.size() > kReaderQueueBytes) {
          drops++;  // best-effort plane: saturated queue drops new frames
          continue;
        }
        was_empty = pending.empty();
        pending_bytes += pt.size();
        pending.emplace_back(std::move(pt));
        pt = std::vector<uint8_t>();
      }
      if (was_empty) wake();
    }
    EVP_CIPHER_CTX_free(ctx);
  }
};

}  // namespace

extern "C" {

void* at2_reader_start(int fd, const uint8_t* key, int wake_fd) {
  auto* r = new At2Reader();
  r->fd = fd;
  r->wake_fd = wake_fd;
  std::memcpy(r->key, key, 32);
  r->thread = std::thread([r] { r->run(); });
  return r;
}

// Copy out queued frames: up to max_frames frames whose total size fits
// buf_cap. offsets[0..n] are frame boundaries in buf. Returns the frame
// count (0 = nothing pending), or -(size) when the next frame alone
// exceeds buf_cap (the caller grows its buffer and retries — a frame can
// legitimately be up to transport.MAX_FRAME). *status_out reports the
// channel state and *drops_out the saturated-queue drop counter.
int64_t at2_reader_take(void* handle, uint8_t* buf, int64_t buf_cap,
                        uint64_t* offsets, int64_t max_frames,
                        int32_t* status_out, uint64_t* drops_out) {
  auto* r = static_cast<At2Reader*>(handle);
  std::lock_guard<std::mutex> lock(r->mu);
  int64_t n = 0;
  uint64_t off = 0;
  offsets[0] = 0;
  while (n < max_frames && !r->pending.empty()) {
    auto& f = r->pending.front();
    if (off + f.size() > uint64_t(buf_cap)) {
      if (n == 0) {
        *status_out = r->status;
        *drops_out = r->drops;
        return -int64_t(f.size());
      }
      break;
    }
    std::memcpy(buf + off, f.data(), f.size());
    off += f.size();
    offsets[++n] = off;
    r->pending_bytes -= f.size();
    r->pending.pop_front();
  }
  *status_out = r->status;
  *drops_out = r->drops;
  return n;
}

// Stop the thread (shutdown unblocks the read), join, free. The caller
// still owns fd and wake_fd and closes them afterwards.
void at2_reader_stop(void* handle) {
  auto* r = static_cast<At2Reader*>(handle);
  r->stopping.store(true, std::memory_order_relaxed);
  ::shutdown(r->fd, SHUT_RD);
  if (r->thread.joinable()) r->thread.join();
  delete r;
}

// Layout exports so the Python binding never hardcodes them.
int64_t at2_ingest_row_stride(void) { return int64_t(kRowStride); }
int64_t at2_ingest_min_wire(void) { return int64_t(kMinWire); }

// ---------------------------------------------------------------------------
// Shard-local quorum counting. The sharded broadcast plane keeps its per-slot
// endorsement bitmaps as little-endian byte strings (Python ints on the wire
// side) and its vote tallies as int32 arrays. The two hot loops — "fold a
// newly-seen bitmap into the tally" and "which entries cleared threshold" —
// used to bounce through numpy per attestation; here they run GIL-released
// per ctypes call so shard threads genuinely overlap.

// counts[i] += 1 for every set bit i in bm[0..nbytes). ncounts caps the
// writable tally range; bits at or past it are ignored (callers clamp nbits
// before ever reaching here, this is belt-and-braces against overrun).
// Returns the number of bits folded in.
int64_t at2_counts_add(const uint8_t* bm, int64_t nbytes,
                       int32_t* counts, int64_t ncounts) {
  int64_t folded = 0;
  for (int64_t byte = 0; byte < nbytes; ++byte) {
    uint8_t b = bm[byte];
    while (b) {
      int bit = __builtin_ctz(b);
      b &= uint8_t(b - 1);
      int64_t idx = byte * 8 + bit;
      if (idx < ncounts) {
        counts[idx] += 1;
        ++folded;
      }
    }
  }
  return folded;
}

// out[0..out_len) becomes the little-endian packed bitmap of indices with
// counts[i] >= threshold, for i < n. Returns the popcount of the mask.
int64_t at2_quorum_mask(const int32_t* counts, int64_t n, int32_t threshold,
                        uint8_t* out, int64_t out_len) {
  std::memset(out, 0, size_t(out_len));
  int64_t set = 0;
  int64_t lim = n < out_len * 8 ? n : out_len * 8;
  for (int64_t i = 0; i < lim; ++i) {
    if (counts[i] >= threshold) {
      out[i >> 3] |= uint8_t(1u << (i & 7));
      ++set;
    }
  }
  return set;
}

}  // extern "C"
