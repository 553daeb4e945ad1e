// Batched ed25519 signature verification on Hopper (sm_90a).
//
// Replaces the TPU kernel at2_node_tpu/ops/pallas_verify.py::_verify_tile
// together with the y-canonical check of its XLA prolog (verify_graph) and
// the jnp.packbits that follows it (ops/ed25519.py verify_kernel_packed_bits).
//
// In:  packed rows, n x 129 bytes: A(32) | R(32) | S(32) | h(32) | valid(1),
//      n need not be a multiple of anything (the ragged tail is masked);
//      the int32 constants of ed25519_lane.cuh (d, 2d, sqrt(-1), the base
//      table), copied into shared memory once per block.
// Out: the verdicts as a bitmask of ceil(n/8) bytes, MSB-first like
//      np.packbits: lane i is bit 7 - i%8 of byte i/8, the tail is zero.
//
// Design: one signature per thread, the per-lane math of ed25519_lane.cuh
// (about 3,900 field multiplications of 100 32x32->64-bit products each),
// the table of multiples of -A in local memory, the fixed base table in
// shared memory. The epilogue packs a warp's 32 verdicts with one ballot,
// and 4 threads of the warp each store one byte, bit-reversed.
//
// What bounds it on this card: int32 multiply-add issue. A lane reads 129
// bytes and writes 1/8 of a byte, but issues about 775k multiply-add slots
// (3,871 multiplications x 100 wide products x 2 slots), so at the H100's
// 16.7e12 slots/s the least time is ~46 ns per signature against ~0.04 ns
// for its bytes. This first version keeps everything simple (int64
// accumulators, the -A table in local memory, out-of-line point functions);
// register-resident tables, several threads per lane and IMAD.WIDE carry
// chains are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ed25519_lane.cuh"

namespace {

constexpr int THREADS = 128;  // a multiple of the warp: the epilogue packs whole warps

__global__ void __launch_bounds__(THREADS)
ed25519_verify_kernel(const uint8_t* __restrict__ packed, int64_t n,
                      const int32_t* __restrict__ consts,
                      uint8_t* __restrict__ bits) {
  __shared__ int32_t s_consts[ed25519_lane::CONST_WORDS];
  for (int i = threadIdx.x; i < ed25519_lane::CONST_WORDS; i += blockDim.x) {
    s_consts[i] = consts[i];
  }
  __syncthreads();

  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  // tail threads redo the last row so the warp runs one instruction stream;
  // their verdict is masked off below
  const int64_t row = lane < n ? lane : n - 1;
  const bool ok = ed25519_lane::lane_verify(packed + row * ed25519_lane::ROW_BYTES, s_consts) &&
                  lane < n;

  const unsigned ballot = __ballot_sync(0xffffffffu, ok);
  const int warp_lane = threadIdx.x & 31;
  if (warp_lane < 4) {
    const int64_t byte = (lane - warp_lane) / 8 + warp_lane;
    if (byte < (n + 7) / 8) {
      // ballot bit t (lane 8*warp_lane + t) goes to bit 7 - t
      bits[byte] = (uint8_t)(__brev((ballot >> (8 * warp_lane)) & 0xFFu) >> 24);
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 when the launch was
// accepted). Asynchronous: a fault during the run shows at the next sync.
int ed25519_verify_launch(const uint8_t* packed, int64_t n, const int32_t* consts,
                          uint8_t* bits, void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + THREADS - 1) / THREADS;
  ed25519_verify_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      packed, n, consts, bits);
  return (int)cudaGetLastError();
}

const char* ed25519_verify_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
}
