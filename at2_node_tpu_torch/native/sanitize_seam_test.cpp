// Sanitizer harness for the verifier's native seam (at2_seam.cpp) on its
// host stand-in (at2_seam_host.cpp, K1 as csrc/ed25519_lane_host.cpp's
// math), built by tests/test_torch_native_sanitize.py under
// -fsanitize=thread and under -fsanitize=address.
//
// This thread plays the event loop (submit, the eventfd, poll, release);
// the seam's worker and, while completions are held, a second thread that
// runs the held host functions race it. Under TSAN that proves the ring's
// hand-overs race-free; under ASAN that no slot's rows or bitmask leave
// their bounds and that destroy frees everything. Checks: completions in
// submit order with every job's size, a full ring refusing a submit, a
// failed launch failing its own job alone, a shutdown with jobs queued
// ending each of them, and jobs large enough that their prep is split over
// the seam's helper threads.
//
// Build: g++ -std=c++17 -O1 -g -fsanitize=thread at2_seam.cpp at2_seam_host.cpp
//            ../csrc/ed25519_lane_host.cpp sanitize_seam_test.cpp -lpthread

#include <poll.h>
#include <unistd.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {
void* at2_seam_create(int, int, int64_t, void*, void*, void*, const void*, int*);
int at2_seam_fd(void*);
int64_t at2_seam_submit(void*, const uint8_t*, const uint32_t*, const uint8_t*, const uint32_t*,
                        const uint8_t*, const uint32_t*, int64_t, int64_t);
struct JobInfo {
  int64_t id, n;
  int32_t err, launched;
  int64_t t_submit, t_uploaded, t_launched, t_done;
  const uint8_t* bits;
};
int at2_seam_poll(void*, JobInfo*);
void at2_seam_release(void*);
void at2_seam_shutdown(void*);
void at2_seam_destroy(void*);
int at2_seam_host_k1(const uint8_t*, int64_t, const int32_t*, uint8_t*, void*);
void at2_seam_host_hold(int, int);
void at2_seam_host_fail_launch(int64_t);
}

namespace {

constexpr int kDepth = 4;
constexpr int64_t kRows = 8;
int failures = 0;

void check(bool ok, const char* what) {
  if (!ok) {
    std::printf("FAIL: %s\n", what);
    failures++;
  }
}

struct Items {
  std::vector<uint8_t> pks, msgs, sigs;
  std::vector<uint32_t> pk_lens, msg_lens, sig_lens;
  explicit Items(int64_t n) {
    for (int64_t i = 0; i < n; i++) {
      pks.insert(pks.end(), 32, (uint8_t)(i + 1));
      sigs.insert(sigs.end(), 64, (uint8_t)(3 * i));
      msgs.insert(msgs.end(), (size_t)(i % 5), (uint8_t)i);
      pk_lens.push_back(32);
      sig_lens.push_back(i == 2 ? 63 : 64);  // one of the wrong length
      msg_lens.push_back((uint32_t)(i % 5));
    }
  }
};

int64_t submit(void* s, int64_t n, int64_t bucket = kRows) {
  Items it(n);
  return at2_seam_submit(s, it.pks.data(), it.pk_lens.data(), it.msgs.data(), it.msg_lens.data(),
                         it.sigs.data(), it.sig_lens.data(), n, bucket);
}

// Each drained job's bitmask, beside `done`.
std::vector<std::vector<uint8_t>> g_bits;

// Case 5's K1: a row's verdict is prep's valid byte, so the bitmask shows
// where the prep put every row.
int valid_k1(const uint8_t* packed, int64_t n, const int32_t*, uint8_t* bits, void*) {
  std::memset(bits, 0, (size_t)(n + 7) / 8);
  for (int64_t i = 0; i < n; i++)
    if (packed[129 * i + 128]) bits[i / 8] |= (uint8_t)(0x80 >> (i % 8));
  return 0;
}

// Items' row i preps as valid: a 64-byte signature whose s (every byte
// 3i) is below the group order, so its top byte is below 0x10.
bool row_valid(int64_t i) { return i != 2 && (uint8_t)(3 * i) < 0x10; }

// Wait for the eventfd, then take every finished job in order.
void drain(void* s, std::vector<JobInfo>& done, size_t want) {
  const int fd = at2_seam_fd(s);
  while (done.size() < want) {
    pollfd p{fd, POLLIN, 0};
    if (poll(&p, 1, 5000) <= 0) {
      check(false, "no completion within 5 s");
      return;
    }
    uint64_t v;
    if (read(fd, &v, sizeof v) < 0) continue;
    JobInfo info;
    while (at2_seam_poll(s, &info)) {
      g_bits.emplace_back(info.bits, info.bits + (info.n + 7) / 8);  // read the bitmask
      done.push_back(info);
      at2_seam_release(s);
    }
  }
}

void* make(std::vector<int32_t>& consts, int64_t rows = kRows, void* k1 = (void*)&at2_seam_host_k1) {
  int err = 0;
  void* s = at2_seam_create(0, kDepth, rows, nullptr, nullptr, k1,
                            consts.data(), &err);
  check(s != nullptr && err == 0, "create");
  return s;
}

}  // namespace

int main() {
  std::vector<int32_t> consts(8192, 0);  // verdicts are not checked here

  // 1. many jobs through a full ring: in order, each with its size
  void* s = make(consts);
  std::vector<JobInfo> done;
  int64_t sent = 0;
  const int64_t total = 120;
  while ((int64_t)done.size() < total) {
    while (sent < total) {
      const int64_t id = submit(s, 1 + sent % kRows);
      if (id == -1) break;  // full
      check(id == sent, "job ids follow submit order");
      sent++;
    }
    drain(s, done, done.size() + 1);
  }
  for (int64_t i = 0; i < total; i++) {
    check(done[i].id == i && done[i].n == 1 + i % kRows, "completion order and size");
    check(done[i].err == 0 && done[i].launched == 1, "clean job");
    check(done[i].t_submit <= done[i].t_uploaded && done[i].t_uploaded <= done[i].t_launched &&
              done[i].t_launched <= done[i].t_done,
          "stamps in order");
  }

  // 2. completions held on the "device", run from another thread
  at2_seam_host_hold(0, 1);
  done.clear();
  for (int i = 0; i < kDepth; i++) check(submit(s, 3) >= 0, "submit while held");
  check(submit(s, 3) == -1, "a full ring refuses a submit");
  std::thread releaser([] {
    usleep(20000);
    at2_seam_host_hold(0, 0);
  });
  drain(s, done, kDepth);
  releaser.join();
  check(done.size() == (size_t)kDepth, "held jobs complete");

  // 3. a failed launch fails its own job alone
  at2_seam_host_fail_launch(2);
  done.clear();
  for (int i = 0; i < 3; i++) submit(s, 4);
  drain(s, done, 3);
  check(done[0].err == 0 && done[1].err != 0 && done[1].launched == 0 && done[2].err == 0,
        "only the failed launch's job fails");
  at2_seam_destroy(s);

  // 4. shutdown with the worker held in a launch and jobs queued
  s = make(consts);
  at2_seam_host_hold(1, 0);
  done.clear();
  for (int i = 0; i < kDepth; i++) submit(s, 2);
  usleep(50000);  // the worker is inside the first job's K1
  at2_seam_shutdown(s);
  check(submit(s, 2) == -2, "no submit after shutdown");
  std::thread unhold([] {
    usleep(20000);
    at2_seam_host_hold(0, 0);
  });
  drain(s, done, kDepth);
  unhold.join();
  check(done[0].err == 0, "the running job ends as it would");
  for (int i = 1; i < kDepth; i++) check(done[i].err == -1, "queued jobs end closed");
  at2_seam_destroy(s);

  // 5. jobs whose prep the helpers share (1,024 rows and more), back to
  // back: every row where the prep of one thread would put it
  constexpr int64_t kBig = 1280;
  s = make(consts, kBig, (void*)&valid_k1);
  done.clear();
  g_bits.clear();
  check(submit(s, kBig, kBig) == 0 && submit(s, 1030, kBig) == 1, "submit large jobs");
  drain(s, done, 2);
  check(done.size() == 2 && done[0].n == kBig && done[0].err == 0 && done[1].n == 1030 &&
            done[1].err == 0,
        "large jobs complete");
  for (size_t k = 0; k < done.size(); k++)
    for (int64_t i = 0; i < done[k].n; i++)
      check(((g_bits[k][i / 8] >> (7 - i % 8)) & 1) == (int)row_valid(i), "a split prep's row");
  at2_seam_destroy(s);

  if (failures) return 1;
  std::printf("sanitize_seam_test: OK\n");
  return 0;
}
