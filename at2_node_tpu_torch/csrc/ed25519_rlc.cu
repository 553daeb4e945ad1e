// The classified random-linear-combination (RLC) batch check on Hopper
// (sm_90a): two kernels.
//
// Replaces the XLA graph at2_node_tpu/ops/aggregate.py::_rlc_graph_packed
// (with _rlc_residuals, mul_by_L, is_identity and tree_reduce_points) that
// the reference ran on the TPU; the per-lane math is ed25519_lane.cuh's
// quad_rlc, shared with the verify kernel.
//
// In:  packed rows, n x 161 bytes: A(32) | R(32) | z(32) | zh(32) | zs(32) |
//      valid(1), n need not be a multiple of anything (the ragged tail is
//      masked); the int32 constants of ed25519_lane.cuh, copied into shared
//      memory once per block.
// Out: one code a lane (0 out, 1 in the equation, 2 reroute), then eq_ok,
//      one byte: 1 when the sum of the code-1 lanes' residuals
//      [z]R + [zh]A - [zs]B is the identity (so 1 when no lane has code 1).
//
// ed25519_rlc_lanes: one quad (four threads) a lane, as the verify kernel:
//   decompress A and R side by side, tables of multiples 0..8 of R and of A
//   in shared memory, [L]R and [L]A by Horner over L's fixed signed digits
//   (252 doublings, 30 additions each), the code, then the residual by one
//   Straus loop over signed radix-16 digits of z and zh and radix-256 digits
//   of -zs (the verify kernel's constant table of B). A lane that is not
//   code 1, or lies past n, contributes the identity; a block's 16 points
//   fold through a tree in shared memory into one partial point.
// ed25519_rlc_fold: one block of 64 quads folds the partials (each quad a
//   strided share, then a tree) and writes eq_ok.
//
// What bounds it on this card: 32-bit multiply-add issue, as for the verify
// kernel. A lane reads 161 bytes and writes 1, but its 8,534 field
// multiplications (3,582 squarings) are ~1.38M multiply-add issue slots,
// 2.5x a verified signature's: ~83 ns a lane at the H100's 16.7e12 slots/s.
// The fold adds 9 multiplications a lane. Below several thousand lanes the
// card is not full and one lane's serial chain of ~2,300 quad rounds (the
// verify kernel's ~1,000) bounds a launch.
//
// Design: two tables a quad (2 x 1,440 B) beside the 20,840 B base table
// make a 128-thread block 121 KB, one block an SM; 64-thread blocks take
// 71,016 B, three an SM. The fold order differs from the reference's
// halving tree; the sum is a group sum and the identity test is exact on
// canonical limbs. Every thread of a warp runs every shuffle: quads past n
// redo the last row, and the tree's idle quads add and throw the sum away.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ed25519_lane.cuh"

namespace {

using namespace ed25519_lane;

constexpr int THREADS = 64;
constexpr int QUADS = THREADS / 4;
constexpr int TAB_WORDS = TABLE_ENTRIES * NL * QUADS * 4;
// per block: the constants, each quad's tables of R and A, its recoded
// scalars, and one point a quad for the tree
constexpr size_t SMEM_BYTES =
    sizeof(int32_t) * (CONST_WORDS + 2 * TAB_WORDS + QUADS * (RLC_DIGIT_WORDS + POINT_WORDS));
constexpr int FOLD_THREADS = 256;
constexpr int FOLD_QUADS = FOLD_THREADS / 4;

// A block's partial point in device memory, (4, 10) int32: component k,
// limb i at k * NL + i, one component a role.
__device__ __forceinline__ void store_point(int32_t* out, const QFe& p) {
  const int k = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < NL; i++) out[k * NL + i] = p.r[0].v[i];
}

__device__ __forceinline__ QFe load_point(const int32_t* in) {
  const int k = threadIdx.x & 3;
  QFe p;
#pragma unroll
  for (int i = 0; i < NL; i++) p.r[0].v[i] = in[k * NL + i];
  return p;
}

// The sum of the nq quads' points `p` (nq a power of two), in quad 0; `pts`
// holds nq points, quad q's component k of limb i at pts[(i * nq + q) * 4 + k].
// Every quad adds at every level so every shuffle has all 32 lanes; only
// the lower half keeps its sum.
__device__ __forceinline__ QFe block_fold(const QFe& p, int32_t* pts, int q, int nq, const Fe& d2) {
  QFe acc = p;
  quad_store(pts + 4 * q, 4 * nq, 0, acc);
#pragma unroll 1
  for (int s = nq / 2; s > 0; s >>= 1) {
    __syncthreads();
    const QFe other = quad_load(pts + 4 * (q + s < nq ? q + s : q), 4 * nq, 0);
    const QFe sum = quad_add(acc, quad_cache(other, d2));
    __syncthreads();
    if (q < s) {
      acc = sum;
      quad_store(pts + 4 * q, 4 * nq, 0, acc);
    }
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS)
ed25519_rlc_lanes(const uint8_t* __restrict__ packed, int64_t n,
                  const int32_t* __restrict__ consts, uint8_t* __restrict__ codes,
                  int32_t* __restrict__ partials) {
  extern __shared__ int32_t smem[];
  int32_t* s_consts = smem;
  int32_t* s_rtab = smem + CONST_WORDS;
  int32_t* s_atab = s_rtab + TAB_WORDS;
  uint32_t* s_digits = (uint32_t*)(s_atab + TAB_WORDS);
  int32_t* s_pts = (int32_t*)(s_digits + QUADS * RLC_DIGIT_WORDS);
  for (int i = threadIdx.x; i < CONST_WORDS; i += blockDim.x) s_consts[i] = consts[i];
  __syncthreads();

  // quad q's component k of limb i of table entry e at ((e * NL + i) *
  // QUADS + q) * 4 + k, its digit word w at w * QUADS + q, as in the
  // verify kernel
  const int q = threadIdx.x >> 2;
  const int64_t lane = (int64_t)blockIdx.x * QUADS + q;
  const int64_t row = lane < n ? lane : n - 1;
  QFe e;
  const int code = quad_rlc(packed + row * RLC_ROW_BYTES, s_consts, s_rtab + 4 * q,
                            s_atab + 4 * q, 4 * QUADS, s_digits + q, QUADS, &e);
  if (lane < n && (threadIdx.x & 3) == 0) codes[lane] = (uint8_t)code;

  const Fe d2 = fe_load(s_consts + CONST_D2);
  const QFe sum = block_fold(quad_select(lane < n && code == 1, e, quad_identity()), s_pts, q,
                             QUADS, d2);
  if (q == 0) store_point(partials + (int64_t)blockIdx.x * POINT_WORDS, sum);
}

__global__ void __launch_bounds__(FOLD_THREADS)
ed25519_rlc_fold(const int32_t* __restrict__ partials, int64_t nparts,
                 const int32_t* __restrict__ consts, uint8_t* __restrict__ eq) {
  __shared__ int32_t s_pts[FOLD_QUADS * POINT_WORDS];
  const int q = threadIdx.x >> 2;
  const Fe d2 = fe_load(consts + CONST_D2);
  const QFe ident = quad_identity();
  QFe acc = ident;
  // the same number of additions in every quad; a share past the end adds
  // the identity
  const int64_t rounds = (nparts + FOLD_QUADS - 1) / FOLD_QUADS;
#pragma unroll 1
  for (int64_t t = 0; t < rounds; t++) {
    const int64_t b = t * FOLD_QUADS + q;
    const QFe p = load_point(partials + (b < nparts ? b : nparts - 1) * POINT_WORDS);
    acc = quad_add(acc, quad_cache(quad_select(b < nparts, p, ident), d2));
  }
  const QFe sum = block_fold(acc, s_pts, q, FOLD_QUADS, d2);
  const bool id = quad_is_identity(sum);
  if (threadIdx.x == 0) *eq = id ? 1 : 0;
}

}  // namespace

extern "C" {

// Lanes a block of ed25519_rlc_lanes takes: its partials are ceil(n / this).
int ed25519_rlc_lanes_per_block() { return QUADS; }

// Launch on `stream`; returns a cudaError_t (0 when the launch was
// accepted). Asynchronous: a fault during the run shows at the next sync.
// `partials` holds ceil(n / QUADS) points of (4, 10) int32.
int ed25519_rlc_lanes_launch(const uint8_t* packed, int64_t n, const int32_t* consts,
                             uint8_t* codes, int32_t* partials, void* stream) {
  if (n <= 0) return 0;
  static cudaError_t attr = cudaFuncSetAttribute(
      ed25519_rlc_lanes, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const int64_t blocks = (n + QUADS - 1) / QUADS;
  ed25519_rlc_lanes<<<(unsigned)blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      packed, n, consts, codes, partials);
  return (int)cudaGetLastError();
}

int ed25519_rlc_fold_launch(const int32_t* partials, int64_t nparts, const int32_t* consts,
                            uint8_t* eq, void* stream) {
  if (nparts <= 0) return 0;
  ed25519_rlc_fold<<<1, FOLD_THREADS, 0, (cudaStream_t)stream>>>(partials, nparts, consts, eq);
  return (int)cudaGetLastError();
}

const char* ed25519_rlc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
}
