// The device calls of the verifier's native seam (at2_seam.cpp), one
// backend a build: at2_seam_cuda.cpp (the CUDA runtime, built with nvcc)
// or at2_seam_host.cpp (a host stand-in for the CPU tests: the copies as
// memcpy, the host function called directly). Every call returns 0 or the
// backend's error code.

#pragma once

#include <cstddef>
#include <cstdint>

namespace at2_seam_dev {

// Called once on the seam's worker thread before its first job.
int bind_device(int device);
int alloc_host(void** p, size_t bytes);  // pinned on the card
int alloc_device(void** p, size_t bytes);
void free_host(void* p);
void free_device(void* p);
int event_create(void** ev);
void event_destroy(void* ev);
int copy_h2d(void* dst, const void* src, size_t bytes, void* stream);
int copy_d2h(void* dst, const void* src, size_t bytes, void* stream);
int event_record(void* ev, void* stream);
int stream_wait_event(void* stream, void* ev);
// fn(arg) runs once everything queued on `stream` before it has run; it
// must not call the device.
int launch_host_func(void* stream, void (*fn)(void*), void* arg);
int stream_synchronize(void* stream);
// 0 when everything queued on `stream` has run, 1 while some still runs,
// else the error the device reported
int stream_query(void* stream);
const char* error_string(int code);

}  // namespace at2_seam_dev
