// A host stand-in for the native seam's device calls, for the CPU tests
// (tests/test_torch_native_seam.py): g++ builds it with at2_seam.cpp and
// the kernel's lane math (csrc/ed25519_lane_host.cpp). The copies are
// memcpy, the host function is called directly, and at2_seam_host_k1 stands
// in for ed25519_verify_launch with the lane math's verdicts.
//
// Test hooks: at2_seam_host_hold(launch, complete) makes the stand-in K1
// wait before it runs (launch), and keeps host functions back until
// at2_seam_host_hold(.., 0) runs them in order (complete: jobs on the
// "device"); at2_seam_host_fail_launch(k) makes the k-th K1 call from
// now return an error; at2_seam_host_fault(1) drops the held host
// functions and has the stream report a fault, as a CUDA stream does after
// a kernel faults (at2_seam_host_fault(0) clears it).

#include <condition_variable>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <utility>
#include <vector>

#include "at2_seam_dev.h"

extern "C" void ed25519_lane_verify_rows(const uint8_t* packed, int64_t n, const int32_t* consts,
                                         uint8_t* verdicts);

namespace {

constexpr int ERR_STANDIN = 98;  // the code a failed stand-in launch returns
constexpr int ERR_FAULT = 97;    // the code a faulted stand-in stream reports

std::mutex g_mu;
std::condition_variable g_cv;
bool g_hold_launch = false;
bool g_hold_complete = false;
std::deque<std::pair<void (*)(void*), void*>> g_held;
int64_t g_fail_in = 0;  // fail the K1 call this many calls from now (0: none)
bool g_fault = false;

}  // namespace

namespace at2_seam_dev {

int bind_device(int) { return 0; }

int alloc_host(void** p, size_t bytes) {
  *p = std::calloc(1, bytes);
  return *p ? 0 : 2;
}

int alloc_device(void** p, size_t bytes) { return alloc_host(p, bytes); }

void free_host(void* p) { std::free(p); }

void free_device(void* p) { std::free(p); }

int event_create(void** ev) {
  *ev = std::malloc(1);
  return 0;
}

void event_destroy(void* ev) { std::free(ev); }

int copy_h2d(void* dst, const void* src, size_t bytes, void*) {
  std::memcpy(dst, src, bytes);
  return 0;
}

int copy_d2h(void* dst, const void* src, size_t bytes, void*) {
  std::memcpy(dst, src, bytes);
  return 0;
}

int event_record(void*, void*) { return 0; }

int stream_wait_event(void*, void*) { return 0; }

int launch_host_func(void*, void (*fn)(void*), void* arg) {
  {
    std::lock_guard<std::mutex> lk(g_mu);
    if (g_hold_complete) {
      g_held.emplace_back(fn, arg);
      return 0;
    }
  }
  fn(arg);
  return 0;
}

int stream_synchronize(void*) { return 0; }

int stream_query(void*) {
  std::lock_guard<std::mutex> lk(g_mu);
  if (g_fault) return ERR_FAULT;
  return g_held.empty() ? 0 : 1;
}

const char* error_string(int code) {
  if (code == ERR_STANDIN) return "stand-in launch failed";
  if (code == ERR_FAULT) return "stand-in device fault";
  return "stand-in error";
}

}  // namespace at2_seam_dev

extern "C" {

// ed25519_verify_launch's stand-in: the lane math's verdict of each of the
// n rows, packed MSB-first into ceil(n/8) bytes.
int at2_seam_host_k1(const uint8_t* packed, int64_t n, const int32_t* consts, uint8_t* bits,
                     void*) {
  {
    std::unique_lock<std::mutex> lk(g_mu);
    g_cv.wait(lk, [] { return !g_hold_launch; });
    if (g_fail_in > 0 && --g_fail_in == 0) return ERR_STANDIN;
  }
  std::vector<uint8_t> verdicts(n);
  ed25519_lane_verify_rows(packed, n, consts, verdicts.data());
  std::memset(bits, 0, (n + 7) / 8);
  for (int64_t i = 0; i < n; i++)
    if (verdicts[i]) bits[i / 8] |= (uint8_t)(0x80 >> (i % 8));
  return 0;
}

void at2_seam_host_hold(int launch, int complete) {
  std::deque<std::pair<void (*)(void*), void*>> run;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    g_hold_launch = launch != 0;
    g_hold_complete = complete != 0;
    if (!g_hold_complete) run.swap(g_held);
  }
  g_cv.notify_all();
  for (auto& [fn, arg] : run) fn(arg);
}

void at2_seam_host_fail_launch(int64_t k) {
  std::lock_guard<std::mutex> lk(g_mu);
  g_fail_in = k;
}

void at2_seam_host_fault(int on) {
  std::lock_guard<std::mutex> lk(g_mu);
  g_fault = on != 0;
  if (g_fault) g_held.clear();
}
}
