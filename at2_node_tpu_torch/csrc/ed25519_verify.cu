// Batched ed25519 signature verification on Hopper (sm_90a).
//
// Replaces the TPU kernel at2_node_tpu/ops/pallas_verify.py::_verify_tile
// together with the y-canonical check of its XLA prolog (verify_graph) and
// the jnp.packbits that follows it (ops/ed25519.py verify_kernel_packed_bits).
//
// In:  packed rows, n x 129 bytes: A(32) | R(32) | S(32) | h(32) | valid(1),
//      n need not be a multiple of anything (the ragged tail is masked);
//      the int32 constants of ed25519_lane.cuh (d, 2d, sqrt(-1), B, the
//      base table in cached form), copied into shared memory once per block.
// Out: the verdicts as a bitmask of ceil(n/8) bytes, MSB-first like
//      np.packbits: lane i is bit 7 - i%8 of byte i/8, the tail is zero.
//
// What bounds it on this card: 32-bit multiply-add issue. A signature
// reads 129 bytes and writes 1/8 of a byte, but its 3,439 field
// multiplications (1,550 of them squarings) are 274,150 32x32->64-bit
// products, ~550k multiply-add issue slots: ~33 ns per signature at the
// H100's 16.7e12 slots/s against ~0.04 ns for its bytes. Below a few
// thousand signatures the card is not full, and what bounds a launch is
// one signature's serial chain of multiplications.
//
// Design (ed25519_lane.cuh):
// - Four threads per signature (a quad, 4 adjacent lanes of a warp). Each
//   round of a point operation is four independent field multiplications,
//   one per thread, with operands exchanged by __shfl_sync on int32 limbs,
//   so a signature's chain is ~1,000 multiplications (275 for the two
//   decompressions, run side by side; 22 rounds for the table; 2 for the
//   carry digits; 64 x 10 + 32 x 2 for the Straus loop) instead of 3,871
//   on one thread, and n signatures fill 4n threads.
// - Signed digits: h in radix 16 against a per-quad table of multiples
//   0..8 of -A, S in radix 256 against a constant table of multiples
//   0..128 of B, both in cached form (Y-X, Y+X, 2Z, 2dT); a negative digit
//   swaps Y-X and Y+X and negates 2dT. A carry digit keeps every 256-bit
//   scalar exact.
// - Squarings take ref10's 55 products; products are unsigned (one
//   IMAD.WIDE.U32 each); the sums inside a round go into the next products
//   uncarried.
// - No stack: the point functions are inlined with the loops rolled (nvcc
//   builds it in ~12 s), the quad's -A table, R and recoded scalars sit in
//   shared memory, laid out so a warp's 32 reads of one limb hit 32 banks,
//   and the base table is a constant copied into shared memory per block
//   (71,528 B in all per 128-thread block).
// - Epilogue: a warp's 8 quads are 8 signatures, one bitmask byte: a
//   ballot, then lane 0 stores the byte.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ed25519_lane.cuh"

namespace {

using namespace ed25519_lane;

constexpr int THREADS = 128;  // a multiple of the warp: the epilogue packs whole warps
constexpr int QUADS = THREADS / 4;
// per block: the constants, each quad's -A table, R and recoded scalars
constexpr int ATAB_WORDS = TABLE_ENTRIES * NL * QUADS * 4;
constexpr size_t SMEM_BYTES =
    sizeof(int32_t) * (CONST_WORDS + ATAB_WORDS + QUADS * (RBUF_WORDS + DIGIT_WORDS));

__global__ void __launch_bounds__(THREADS)
ed25519_verify_kernel(const uint8_t* __restrict__ packed, int64_t n,
                      const int32_t* __restrict__ consts,
                      uint8_t* __restrict__ bits) {
  extern __shared__ int32_t smem[];
  int32_t* s_consts = smem;
  int32_t* s_atab = smem + CONST_WORDS;
  int32_t* s_rbuf = s_atab + ATAB_WORDS;
  uint32_t* s_digits = (uint32_t*)(s_rbuf + QUADS * RBUF_WORDS);
  for (int i = threadIdx.x; i < CONST_WORDS; i += blockDim.x) s_consts[i] = consts[i];
  __syncthreads();

  // quad q's component k of limb i of entry e at ((e * NL + i) * QUADS + q) * 4 + k,
  // its digit word w at w * QUADS + q: a warp's 32 reads hit 32 banks, or
  // 8 (one word per quad)
  const int q = threadIdx.x >> 2;
  const int64_t sig = (int64_t)blockIdx.x * QUADS + q;
  // quads past n redo the last row so every shuffle has all 32 lanes;
  // their verdict is masked off below
  const int64_t row = sig < n ? sig : n - 1;
  const bool ok = quad_verify(packed + row * ROW_BYTES, s_consts, s_atab + 4 * q, 4 * QUADS,
                              s_rbuf + q * RBUF_WORDS, s_digits + q, QUADS) &&
                  sig < n;

  // role 0 of quad i of the warp (lane 4i) holds signature i's verdict,
  // which goes to bit 7 - i of the warp's byte
  const unsigned ballot = __ballot_sync(0xffffffffu, ok);
  const int warp_lane = threadIdx.x & 31;
  if (warp_lane == 0) {
    const int64_t byte = ((int64_t)blockIdx.x * THREADS + threadIdx.x) / 32;
    if (byte < (n + 7) / 8) {
      unsigned b = 0;
#pragma unroll
      for (int i = 0; i < 8; i++) b |= ((ballot >> (4 * i)) & 1u) << (7 - i);
      bits[byte] = (uint8_t)b;
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns a cudaError_t (0 when the launch was
// accepted). Asynchronous: a fault during the run shows at the next sync.
int ed25519_verify_launch(const uint8_t* packed, int64_t n, const int32_t* consts,
                          uint8_t* bits, void* stream) {
  if (n <= 0) return 0;
  static cudaError_t attr = cudaFuncSetAttribute(
      ed25519_verify_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const int64_t blocks = (n + QUADS - 1) / QUADS;
  ed25519_verify_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      packed, n, consts, bits);
  return (int)cudaGetLastError();
}

const char* ed25519_verify_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
}
