// The native seam's device calls on the CUDA runtime (built with nvcc
// beside at2_seam.cpp). The streams are the verifier's own, created by
// PyTorch; a stream handle is a CUstream, valid in every runtime of the
// process, so this library queues work on them as PyTorch does.

#include <cuda_runtime.h>

#include "at2_seam_dev.h"

namespace at2_seam_dev {

namespace {
cudaStream_t st(void* s) { return static_cast<cudaStream_t>(s); }
}  // namespace

int bind_device(int device) { return (int)cudaSetDevice(device); }

int alloc_host(void** p, size_t bytes) { return (int)cudaHostAlloc(p, bytes, cudaHostAllocDefault); }

int alloc_device(void** p, size_t bytes) { return (int)cudaMalloc(p, bytes); }

void free_host(void* p) { cudaFreeHost(p); }

void free_device(void* p) { cudaFree(p); }

int event_create(void** ev) {
  cudaEvent_t e = nullptr;
  const int rc = (int)cudaEventCreateWithFlags(&e, cudaEventDisableTiming);
  *ev = e;
  return rc;
}

void event_destroy(void* ev) { cudaEventDestroy(static_cast<cudaEvent_t>(ev)); }

int copy_h2d(void* dst, const void* src, size_t bytes, void* stream) {
  return (int)cudaMemcpyAsync(dst, src, bytes, cudaMemcpyHostToDevice, st(stream));
}

int copy_d2h(void* dst, const void* src, size_t bytes, void* stream) {
  return (int)cudaMemcpyAsync(dst, src, bytes, cudaMemcpyDeviceToHost, st(stream));
}

int event_record(void* ev, void* stream) {
  return (int)cudaEventRecord(static_cast<cudaEvent_t>(ev), st(stream));
}

int stream_wait_event(void* stream, void* ev) {
  return (int)cudaStreamWaitEvent(st(stream), static_cast<cudaEvent_t>(ev), 0);
}

int launch_host_func(void* stream, void (*fn)(void*), void* arg) {
  return (int)cudaLaunchHostFunc(st(stream), fn, arg);
}

int stream_synchronize(void* stream) { return (int)cudaStreamSynchronize(st(stream)); }

int stream_query(void* stream) {
  const cudaError_t rc = cudaStreamQuery(st(stream));
  if (rc == cudaSuccess) return 0;
  if (rc == cudaErrorNotReady) return 1;
  return (int)rc;
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // namespace at2_seam_dev
