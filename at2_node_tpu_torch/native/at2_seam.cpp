// The CUDA verifier's native seam: one worker thread a verifier that takes
// each flush from prep to completion without Python.
//
// The event loop hands a flush over in one call (at2_seam_submit, bound
// with ctypes.PyDLL so the loop keeps the GIL): its ragged keys, messages
// and signatures are copied into the next slot of a ring of `depth` job
// slots, and the worker is woken. For each job, the worker
//   1. preps the n real rows into the slot's pinned staging rows and zeroes
//      the padding up to the bucket (at2_prep.h); a job of PREP_SPLIT rows
//      or more is split over helper threads started with the seam, so no
//      flush starts a thread;
//   2. copies the rows to the slot's device rows on the copy stream and
//      records the slot's event, which the compute stream waits on;
//   3. launches K1 through ed25519_verify_launch (a function pointer: the
//      kernel's library is loaded on its own) on the compute stream, and
//      counts the launch (at2_seam_launches);
//   4. copies the bitmask back into the slot's pinned bitmask, and
//   5. queues a host function after it, which stamps the completion and
//      wakes the loop through an eventfd.
// No thread spins on an event and none takes the GIL. The loop reads the
// eventfd, takes finished jobs in submit order (at2_seam_poll), reads each
// bitmask and frees the slot (at2_seam_release).
//
// Every buffer of a slot is allocated once, at create. A call that fails
// fails its own job; a fault the device reports later fails every job
// still on it (the worker looks at the compute stream while jobs wait).
// Stamps are CLOCK_MONOTONIC nanoseconds, the clock of Python's
// time.monotonic().

#include <sys/eventfd.h>
#include <time.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <sched.h>
#include <thread>
#include <vector>

#include "at2_prep.h"
#include "at2_seam_dev.h"

namespace dev = at2_seam_dev;

namespace {

// K1's launcher: ed25519_verify_launch(packed, n, consts, bits, stream)
using K1Launch = int (*)(const uint8_t*, int64_t, const int32_t*, uint8_t*, void*);

// a slot's states; only the loop moves FREE -> QUEUED and DONE -> FREE
enum : int { FREE = 0, QUEUED = 1, RUNNING = 2, ENDING = 3, DONE = 4 };

// errors of the seam's own, beside the backend's codes: a job queued when
// the seam closed; a seam that could not be set up (bad arguments, no eventfd)
constexpr int ERR_CLOSED = -1;
constexpr int ERR_SETUP = -2;

// A job's prep is split over the helpers from this many real rows, in
// parts of at least PREP_PART rows, over at most PREP_LANES threads
// (the worker and its helpers) or the cores this process may run on.
constexpr int64_t PREP_SPLIT = 1024;
constexpr int64_t PREP_PART = 256;
constexpr int PREP_LANES = 8;

std::atomic<int64_t> g_threads_started{0};

int prep_helpers() {
  cpu_set_t set;
  int cpus = sched_getaffinity(0, sizeof set, &set) == 0 ? CPU_COUNT(&set) : 1;
  return (cpus < PREP_LANES ? cpus : PREP_LANES) - 1;
}

int64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (int64_t)ts.tv_sec * 1000000000 + ts.tv_nsec;
}

struct Seam;

struct Job {
  Seam* seam = nullptr;
  std::atomic<int> state{FREE};
  int64_t id = 0, n = 0, bucket = 0;
  std::vector<uint8_t> pks, msgs, sigs;
  std::vector<uint64_t> pk_off, msg_off, sig_off;
  uint8_t* h_rows = nullptr;
  void* d_rows = nullptr;
  uint8_t* h_bits = nullptr;
  void* d_bits = nullptr;
  void* copied = nullptr;  // the event after the rows' upload
  int32_t err = 0;
  int32_t launched = 0;
  int64_t t_submit = 0, t_uploaded = 0, t_launched = 0, t_done = 0;
};

// What at2_seam_poll hands the loop (ctypes mirrors it in native/seam.py).
struct JobInfo {
  int64_t id, n;
  int32_t err, launched;
  int64_t t_submit, t_uploaded, t_launched, t_done;
  const uint8_t* bits;
};

struct Seam {
  int device = 0;
  int depth = 0;
  int64_t max_rows = 0;
  void* copy_stream = nullptr;
  void* compute_stream = nullptr;
  K1Launch k1 = nullptr;
  const int32_t* consts = nullptr;
  int efd = -1;
  std::vector<Job> jobs;
  int64_t next_submit = 0;  // the loop's
  int64_t next_done = 0;    // the loop's
  int64_t next_run = 0;     // the worker's, under mu
  std::mutex mu;
  std::condition_variable cv;
  bool closing = false;
  int bind_err = 0;
  std::atomic<int64_t> launches{0};  // K1 launches that returned 0
  std::thread worker;
  // the prep helpers and the parts of the job they share, under pmu
  std::vector<std::thread> helpers;
  std::mutex pmu;
  std::condition_variable pcv, pdone;
  Job* ptask = nullptr;
  int64_t p_next = 0, p_parts = 0, p_rows = 0, p_left = 0;
  bool p_stop = false;

  explicit Seam(int depth_) : depth(depth_), jobs(depth_) {}

  void wake_loop() {
    uint64_t one = 1;
    ssize_t w;
    do {
      w = write(efd, &one, sizeof one);
    } while (w < 0 && errno == EINTR);
  }

  // RUNNING -> DONE, once, by whichever of the host function and the
  // worker's fault sweep gets there first
  bool finish(Job* j, int err) {
    int expect = RUNNING;
    if (!j->state.compare_exchange_strong(expect, ENDING)) return false;
    j->t_done = now_ns();
    if (err && !j->err) j->err = err;
    j->state.store(DONE, std::memory_order_release);
    wake_loop();
    return true;
  }

  static void on_done(void* arg) {
    Job* j = static_cast<Job*>(arg);
    j->seam->finish(j, 0);
  }

  // Jobs still on the device while the worker waits: a fault the compute
  // stream reports fails them all (their host functions never run).
  void sweep_faults() {
    bool running = false;
    for (auto& j : jobs) running = running || j.state.load() == RUNNING;
    if (!running) return;
    const int rc = dev::stream_query(compute_stream);
    if (rc == 0 || rc == 1) return;  // idle, or still working
    for (auto& j : jobs)
      if (j.state.load() == RUNNING) finish(&j, rc);
  }

  static void prep_rows(Job* j, int64_t lo, int64_t hi) {
    at2_prep::prep_range(j->pks.data(), j->pk_off.data(), j->msgs.data(), j->msg_off.data(),
                         j->sigs.data(), j->sig_off.data(), j->n, lo, hi, j->h_rows);
  }

  // Part k of the shared job's real rows; the caller holds lk, which is
  // dropped while the rows are prepped.
  void prep_part(std::unique_lock<std::mutex>& lk) {
    Job* j = ptask;
    const int64_t lo = p_next++ * p_rows;
    const int64_t hi = lo + p_rows < j->n ? lo + p_rows : j->n;
    lk.unlock();
    prep_rows(j, lo, hi);
    lk.lock();
    if (--p_left == 0) pdone.notify_one();
  }

  void help() {
    std::unique_lock<std::mutex> lk(pmu);
    for (;;) {
      pcv.wait(lk, [this] { return p_stop || (ptask != nullptr && p_next < p_parts); });
      if (p_stop) return;
      prep_part(lk);
    }
  }

  void prep(Job* j) {
    int64_t parts = j->n < PREP_SPLIT ? 1 : j->n / PREP_PART;
    if (parts > (int64_t)helpers.size() + 1) parts = (int64_t)helpers.size() + 1;
    if (parts <= 1) {
      prep_rows(j, 0, j->bucket);
      return;
    }
    {
      std::lock_guard<std::mutex> lk(pmu);
      ptask = j;
      p_next = 0;
      p_parts = parts;
      p_rows = (j->n + parts - 1) / parts;
      p_left = parts;
    }
    pcv.notify_all();
    prep_rows(j, j->n, j->bucket);  // the padding
    std::unique_lock<std::mutex> lk(pmu);
    while (p_next < p_parts) prep_part(lk);
    pdone.wait(lk, [this] { return p_left == 0; });
    ptask = nullptr;
  }

  void run_job(Job* j) {
    prep(j);
    const size_t row_bytes = (size_t)j->bucket * at2_prep::ROW;
    const size_t bit_bytes = (size_t)(j->bucket + 7) / 8;
    int rc = bind_err;
    if (!rc) rc = dev::copy_h2d(j->d_rows, j->h_rows, row_bytes, copy_stream);
    if (!rc) rc = dev::event_record(j->copied, copy_stream);
    if (!rc) rc = dev::stream_wait_event(compute_stream, j->copied);
    const bool waits = rc == 0;  // the compute stream waits on this job's upload
    j->t_uploaded = now_ns();
    if (!rc) {
      rc = k1(static_cast<const uint8_t*>(j->d_rows), j->bucket, consts,
              static_cast<uint8_t*>(j->d_bits), compute_stream);
      j->launched = rc == 0;
      if (!rc) launches.fetch_add(1);
    }
    if (!rc) rc = dev::copy_d2h(j->h_bits, j->d_bits, bit_bytes, compute_stream);
    j->err = rc;
    j->t_launched = now_ns();
    // the slot is reused once the job is done: its upload must be over
    if (!waits && !bind_err) dev::stream_synchronize(copy_stream);
    const int hrc = bind_err ? bind_err : dev::launch_host_func(compute_stream, on_done, j);
    if (hrc) {
      // the stream takes no more work: complete here, after what it holds
      if (!bind_err) dev::stream_synchronize(compute_stream);
      finish(j, hrc);
    }
  }

  void run() {
    bind_err = dev::bind_device(device);
    for (;;) {
      Job* j = nullptr;
      bool closed = false;
      {
        std::unique_lock<std::mutex> lk(mu);
        for (;;) {
          Job* head = &jobs[next_run % depth];
          if (head->state.load() == QUEUED) {
            j = head;
            closed = closing;
            next_run++;
            // taken under mu: close() sees it as running, not queued
            j->state.store(RUNNING);
            break;
          }
          if (closing) break;
          if (cv.wait_for(lk, std::chrono::milliseconds(100)) == std::cv_status::timeout) {
            lk.unlock();
            sweep_faults();
            lk.lock();
          }
        }
      }
      if (j == nullptr) return;  // closing, nothing queued
      if (closed) {
        finish(j, ERR_CLOSED);  // queued when close came: never started
        continue;
      }
      run_job(j);
    }
  }
};

void free_slots(Seam* s) {
  for (auto& j : s->jobs) {
    if (j.h_rows) dev::free_host(j.h_rows);
    if (j.h_bits) dev::free_host(j.h_bits);
    if (j.d_rows) dev::free_device(j.d_rows);
    if (j.d_bits) dev::free_device(j.d_bits);
    if (j.copied) dev::event_destroy(j.copied);
  }
  if (s->efd >= 0) close(s->efd);
}

void copy_ragged(const uint8_t* flat, const uint32_t* lens, int64_t n, std::vector<uint8_t>& out,
                 std::vector<uint64_t>& off) {
  off.resize(n + 1);
  off[0] = 0;
  for (int64_t i = 0; i < n; i++) off[i + 1] = off[i] + lens[i];
  out.assign(flat, flat + off[n]);
}

}  // namespace

extern "C" {

// A seam of `depth` slots, each for up to `max_rows` rows, on `device`'s
// two streams; `k1` is ed25519_verify_launch, `consts` its device
// constants. Null on failure, with the backend's code in *err.
void* at2_seam_create(int device, int depth, int64_t max_rows, void* copy_stream,
                      void* compute_stream, void* k1, const void* consts, int* err) {
  *err = 0;
  if (depth <= 0 || max_rows <= 0 || k1 == nullptr) {
    *err = ERR_SETUP;
    return nullptr;
  }
  Seam* s = new Seam(depth);
  s->device = device;
  s->max_rows = max_rows;
  s->copy_stream = copy_stream;
  s->compute_stream = compute_stream;
  s->k1 = reinterpret_cast<K1Launch>(k1);
  s->consts = static_cast<const int32_t*>(consts);
  s->efd = eventfd(0, EFD_NONBLOCK | EFD_CLOEXEC);
  int rc = s->efd < 0 ? ERR_SETUP : 0;
  if (!rc) rc = dev::bind_device(device);
  const size_t row_bytes = (size_t)max_rows * at2_prep::ROW;
  const size_t bit_bytes = (size_t)(max_rows + 7) / 8;
  for (auto& j : s->jobs) {
    j.seam = s;
    void* rows = nullptr;
    void* bits = nullptr;
    if (!rc) rc = dev::alloc_host(&rows, row_bytes);
    if (!rc) rc = dev::alloc_host(&bits, bit_bytes);
    j.h_rows = static_cast<uint8_t*>(rows);
    j.h_bits = static_cast<uint8_t*>(bits);
    if (!rc) rc = dev::alloc_device(&j.d_rows, row_bytes);
    if (!rc) rc = dev::alloc_device(&j.d_bits, bit_bytes);
    if (!rc) rc = dev::event_create(&j.copied);
  }
  if (rc) {
    free_slots(s);
    delete s;
    *err = rc;
    return nullptr;
  }
  s->worker = std::thread(&Seam::run, s);
  for (int i = prep_helpers(); i > 0; i--) s->helpers.emplace_back(&Seam::help, s);
  g_threads_started.fetch_add(1 + (int64_t)s->helpers.size());
  return s;
}

int at2_seam_fd(void* h) { return static_cast<Seam*>(h)->efd; }

// The loop's one call a flush: n items (each given as a flat buffer and
// the items' lengths) into the next slot, padded to `bucket` rows. The
// job's id, or -2 after shutdown, -1 when every slot is taken, -3 when
// n or bucket does not fit a slot.
int64_t at2_seam_submit(void* h, const uint8_t* pks, const uint32_t* pk_lens, const uint8_t* msgs,
                        const uint32_t* msg_lens, const uint8_t* sigs, const uint32_t* sig_lens,
                        int64_t n, int64_t bucket) {
  Seam* s = static_cast<Seam*>(h);
  if (n < 0 || n > bucket || bucket <= 0 || bucket > s->max_rows) return -3;
  {
    std::lock_guard<std::mutex> lk(s->mu);
    if (s->closing) return -2;
  }
  Job* j = &s->jobs[s->next_submit % s->depth];
  if (j->state.load(std::memory_order_acquire) != FREE) return -1;
  j->t_submit = now_ns();
  copy_ragged(pks, pk_lens, n, j->pks, j->pk_off);
  copy_ragged(msgs, msg_lens, n, j->msgs, j->msg_off);
  copy_ragged(sigs, sig_lens, n, j->sigs, j->sig_off);
  j->id = s->next_submit;
  j->n = n;
  j->bucket = bucket;
  j->err = 0;
  j->launched = 0;
  j->t_uploaded = j->t_launched = j->t_done = 0;
  {
    std::lock_guard<std::mutex> lk(s->mu);
    j->state.store(QUEUED);
    s->next_submit++;
  }
  s->cv.notify_one();
  return j->id;
}

// The oldest job not yet released, when it is done: 1 and *out filled,
// else 0. Its bitmask stays valid until at2_seam_release.
int at2_seam_poll(void* h, JobInfo* out) {
  Seam* s = static_cast<Seam*>(h);
  if (s->next_done == s->next_submit) return 0;
  Job* j = &s->jobs[s->next_done % s->depth];
  if (j->state.load(std::memory_order_acquire) != DONE) return 0;
  *out = JobInfo{j->id,         j->n,          j->err,    j->launched, j->t_submit,
                 j->t_uploaded, j->t_launched, j->t_done, j->h_bits};
  return 1;
}

// Free the slot of the job at2_seam_poll returned last.
void at2_seam_release(void* h) {
  Seam* s = static_cast<Seam*>(h);
  Job* j = &s->jobs[s->next_done % s->depth];
  j->state.store(FREE, std::memory_order_release);
  s->next_done++;
}

// Take no more jobs; jobs queued and not started end with ERR_CLOSED,
// the worker's job in hand and those on the device end as they would.
void at2_seam_shutdown(void* h) {
  Seam* s = static_cast<Seam*>(h);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->closing = true;
  }
  s->cv.notify_one();
}

// After shutdown, once every job is done: join the worker, wait for the
// streams and free the slots.
void at2_seam_destroy(void* h) {
  Seam* s = static_cast<Seam*>(h);
  at2_seam_shutdown(h);
  if (s->worker.joinable()) s->worker.join();
  {
    std::lock_guard<std::mutex> lk(s->pmu);
    s->p_stop = true;
  }
  s->pcv.notify_all();
  for (auto& t : s->helpers) t.join();
  if (!s->bind_err) {
    dev::stream_synchronize(s->copy_stream);
    dev::stream_synchronize(s->compute_stream);
  }
  free_slots(s);
  delete s;
}

const char* at2_seam_error_string(int code) {
  if (code == ERR_CLOSED) return "verifier closed";
  if (code == ERR_SETUP) return "bad seam arguments, or no eventfd";
  return dev::error_string(code);
}

// K1 launches this seam made, counted as each returns.
int64_t at2_seam_launches(void* h) { return static_cast<Seam*>(h)->launches.load(); }

// Threads every seam of this process started: its worker and helpers.
int64_t at2_seam_threads_started() { return g_threads_started.load(); }
}
