// The classified random-linear-combination (RLC) batch check on Hopper
// (sm_90a): two kernels.
//
// Replaces the XLA graph at2_node_tpu/ops/aggregate.py::_rlc_graph_packed
// (with _rlc_residuals, mul_by_L, is_identity and tree_reduce_points) that
// the reference ran on the TPU; the per-lane math is ed25519_lane.cuh's,
// shared with the verify kernel.
//
// In:  packed rows, n x 161 bytes: A(32) | R(32) | z(32) | zh(32) | zs(32) |
//      valid(1), n need not be a multiple of anything (the ragged tail is
//      masked); the int32 constants of ed25519_lane.cuh in device memory.
// Out: one code a lane (0 out, 1 in the equation, 2 reroute), then eq_ok,
//      one byte: 1 when the sum of the code-1 lanes' residuals
//      [z]R + [zh]A - [zs]B is the identity (so 1 when no lane has code 1).
//
// What bounds it on this card: 32-bit multiply-add issue, as for the verify
// kernel. A lane reads 161 bytes and writes 1, but its 8,534 field
// multiplications (3,582 squarings) are ~1.38M multiply-add issue slots,
// 2.5x a verified signature's: ~83 ns a lane at the H100's 16.7e12 slots/s.
// The fold adds 9 multiplications a point. Below several thousand lanes
// the card is not full, and one lane's serial chain of quad rounds bounds
// a launch.
//
// ed25519_rlc_lanes<LAYOUT>, one template, two layouts (ops/cuda_rlc.py
// choose_layout takes SPLIT while a launch fits in one wave of its
// resident blocks, else WHOLE):
// - WHOLE: one quad (four threads) a lane, 16 lanes a 64-thread block:
//   quad_rlc decompresses A and R side by side, builds their tables of
//   multiples 0..8 in shared memory, runs [L]R then [L]A (252 doublings,
//   30 additions each), then the residual by one Straus loop over signed
//   radix-16 digits of z and zh and radix-256 digits of -zs: a chain of
//   ~2,300 quad rounds. The base table stays in device memory, read
//   through the read-only path (20,840 B, resident in L1 and L2), so a
//   block takes 50,304 B of shared memory and four blocks (8 warps) fit
//   on an SM, where the copy per block allowed three.
// - SPLIT: one lane on four quads, each in its own warp, 8 lanes a
//   128-thread block. Warp 0 decompresses A and writes its table, warp 1
//   R's (quad_rlc_point); after a barrier warps 0 and 1 run [L]A and [L]R
//   while warp 2 computes [zh]A - [zs]B (256 doublings) and warp 3 [z]R
//   (z below 2^128: 128 doublings). Parts that run different code sit in
//   different warps, never in one. The chain is ~300 rounds then the
//   longer of ~564 ([L]P) and ~708 (warp 2): ~1,000, the verify kernel's;
//   the work is 9,302 multiplications a lane, 9% more than WHOLE's, so the
//   layout is for launches that leave SMs idle.
// Both: the two torsion verdicts meet in shared memory and give the code
// (rlc_code); a lane's residual (one point in WHOLE, two in SPLIT) enters
// the block's tree in shared memory masked by code == 1 and lane < n, and
// the block writes one partial point.
//
// ed25519_rlc_fold: blocks of up to 32 quads; each quad adds at most 4
// partials (ops/cuda_rlc.py fold_grid), then a tree in shared memory; with
// more than one block, each writes its point, and the last to take a
// ticket (atomicAdd after __threadfence) folds them the same way and
// writes eq_ok. The chain is 4 additions and a tree of 5 levels a level,
// two levels up to 4,096 partials (65,536 lanes). One block alone is
// issue-bound on one SM: on an H100 80GB HBM3 at 700 W, 0.026 ms at 4,096
// partials against 0.213 for one block of 32 quads adding 128 each in a
// row (chip_smoke.py phase 3b).
//
// The fold order differs from the reference's halving tree; the sum is a
// group sum and the identity test is exact on canonical limbs. Every
// thread of a warp runs every shuffle: quads past n redo the last row,
// and the tree's idle quads add and throw the sum away.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ed25519_lane.cuh"

namespace {

using namespace ed25519_lane;

constexpr int WHOLE = 0, SPLIT = 1;

template <int LAYOUT>
struct Shape {
  static constexpr int THREADS = LAYOUT == WHOLE ? 64 : 128;
  static constexpr int QUADS = THREADS / 4;
  static constexpr int LANES = LAYOUT == WHOLE ? QUADS : QUADS / 4;
  // one table of R and one of A a lane: lane l's component k of limb i of
  // entry e at ((e * NL + i) * LANES + l) * 4 + k, so a warp's 32 reads of
  // one limb hit 32 banks; its digit word w at w * LANES + l
  static constexpr int TAB_WORDS = TABLE_ENTRIES * NL * LANES * 4;
  // per block: the tables, each lane's recoded scalars, one point a quad
  // for the tree, and (SPLIT) A's and R's verdict a lane
  static constexpr size_t SMEM_BYTES =
      sizeof(int32_t) * (2 * TAB_WORDS + LANES * RLC_DIGIT_WORDS + QUADS * POINT_WORDS + 2 * LANES);
};

constexpr int FOLD_THREADS = 128;

// A block's partial point in device memory, (4, 10) int32: component k,
// limb i at k * NL + i, one component a role.
__device__ __forceinline__ void store_point(int32_t* out, const QFe& p) {
  const int k = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < NL; i++) out[k * NL + i] = p.r[0].v[i];
}

// The same, read through L2 (__ldcg): the fold's last block reads points
// other blocks wrote during the launch.
__device__ __forceinline__ QFe load_point(const int32_t* in) {
  const int k = threadIdx.x & 3;
  QFe p;
#pragma unroll
  for (int i = 0; i < NL; i++) p.r[0].v[i] = __ldcg(in + k * NL + i);
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

template <int LAYOUT>
__global__ void __launch_bounds__(Shape<LAYOUT>::THREADS)
ed25519_rlc_lanes(const uint8_t* __restrict__ packed, int64_t n,
                  const int32_t* __restrict__ consts, uint8_t* __restrict__ codes,
                  int32_t* __restrict__ partials, unsigned* __restrict__ ticket) {
  using S = Shape<LAYOUT>;
  extern __shared__ int32_t smem[];
  int32_t* s_rtab = smem;
  int32_t* s_atab = s_rtab + S::TAB_WORDS;
  uint32_t* s_digits = (uint32_t*)(s_atab + S::TAB_WORDS);
  int32_t* s_pts = (int32_t*)(s_digits + S::LANES * RLC_DIGIT_WORDS);
  int32_t* s_clean = s_pts + S::QUADS * POINT_WORDS;  // [part][lane], SPLIT

  const int q = threadIdx.x >> 2;
  // the quad's lane in the block; in SPLIT its warp is its part
  const int l = LAYOUT == WHOLE ? q : (threadIdx.x & 31) >> 2;
  const int64_t lane = (int64_t)blockIdx.x * S::LANES + l;
  const int64_t row_i = lane < n ? lane : n - 1;
  const uint8_t* row = packed + row_i * RLC_ROW_BYTES;
  const int tstride = 4 * S::LANES;
  int32_t* rtab = s_rtab + 4 * l;
  int32_t* atab = s_atab + 4 * l;

  QFe e;
  int code;
  bool keep;  // this quad's point enters the block's tree
  if constexpr (LAYOUT == WHOLE) {
    code = quad_rlc(row, consts, rtab, atab, tstride, s_digits + l, S::LANES, &e);
    keep = true;
  } else {
    const int part = threadIdx.x >> 5;
    QFe p;
    bool ok = false;
    e = quad_identity();
    if (part < 2) ok = quad_rlc_point(row + 32 * part, consts, part ? rtab : atab, tstride, &p);
    __syncthreads();  // every table in place
    if (part < 2) {
      const bool clean = ok & quad_torsion_free(p, part ? rtab : atab, tstride);
      if ((threadIdx.x & 3) == 0) s_clean[part * S::LANES + l] = clean;
    } else if (part == 2) {
      e = quad_rlc_residual_a(row, consts, atab, tstride, s_digits + l, S::LANES);
    } else {
      e = quad_rlc_residual_r(row, rtab, tstride, s_digits + 16 * S::LANES + l, S::LANES);
    }
    __syncthreads();  // every verdict in place
    code = rlc_code(row[160] != 0, s_clean[l] != 0, s_clean[S::LANES + l] != 0);
    keep = part >= 2;
  }
  if (lane < n && threadIdx.x < 4 * S::LANES && (threadIdx.x & 3) == 0) codes[lane] = (uint8_t)code;

  const Fe d2 = fe_load(consts + CONST_D2);
  const QFe sum = block_fold(quad_select(keep && lane < n && code == 1, e, quad_identity()), s_pts,
                             q, S::QUADS, d2);
  if (q == 0) store_point(partials + (int64_t)blockIdx.x * POINT_WORDS, sum);
  if (blockIdx.x == 0 && threadIdx.x == 0) *ticket = 0;  // the fold's, which runs after
}

// The sum of points [lo, hi) of `pts` over the block's nq quads (none when
// hi <= lo): quad q adds points lo + q, lo + q + nq, ... in a row, every
// quad as many, then the tree. A point past hi is the identity (point 0
// is read in its place).
__device__ __forceinline__ QFe fold_range(const int32_t* pts, int64_t lo, int64_t hi, int32_t* s_pts,
                                          int q, int nq, const Fe& d2) {
  const QFe ident = quad_identity();
  QFe acc = quad_select(lo + q < hi, load_point(pts + (lo + q < hi ? lo + q : 0) * POINT_WORDS), ident);
#pragma unroll 1
  for (int64_t b = lo + q + nq; b < lo + ((hi - lo + nq - 1) / nq) * nq; b += nq) {
    const QFe p = load_point(pts + (b < hi ? b : 0) * POINT_WORDS);
    acc = quad_add(acc, quad_cache(quad_select(b < hi, p, ident), d2));
  }
  return block_fold(acc, s_pts, q, nq, d2);
}

__global__ void __launch_bounds__(FOLD_THREADS)
ed25519_rlc_fold(const int32_t* __restrict__ partials, int64_t nparts,
                 const int32_t* __restrict__ consts, int32_t* __restrict__ level2,
                 unsigned* __restrict__ ticket, uint8_t* __restrict__ eq) {
  __shared__ int32_t s_pts[FOLD_THREADS / 4 * POINT_WORDS];
  __shared__ bool s_last;
  const int q = threadIdx.x >> 2;
  const int nq = blockDim.x >> 2;
  const Fe d2 = fe_load(consts + CONST_D2);
  const int64_t share = (nparts + gridDim.x - 1) / gridDim.x;
  const int64_t lo = (int64_t)blockIdx.x * share;
  const int64_t hi = lo + share < nparts ? lo + share : nparts;
  QFe sum = fold_range(partials, lo, hi, s_pts, q, nq, d2);
  if (gridDim.x > 1) {
    if (q == 0) store_point(level2 + (int64_t)blockIdx.x * POINT_WORDS, sum);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    sum = fold_range(level2, 0, gridDim.x, s_pts, q, nq, d2);
  }
  const bool id = quad_is_identity(sum);
  if (threadIdx.x == 0) {
    *eq = id ? 1 : 0;
    *ticket = 0;  // ready for another fold over the same scratch
  }
}

template <int LAYOUT>
cudaError_t lanes_attr() {
  static cudaError_t attr =
      cudaFuncSetAttribute(ed25519_rlc_lanes<LAYOUT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)Shape<LAYOUT>::SMEM_BYTES);
  return attr;
}

template <int LAYOUT>
int lanes_launch(const uint8_t* packed, int64_t n, const int32_t* consts, uint8_t* codes,
                 int32_t* partials, unsigned* ticket, cudaStream_t stream) {
  using S = Shape<LAYOUT>;
  const cudaError_t attr = lanes_attr<LAYOUT>();
  if (attr != cudaSuccess) return (int)attr;
  const int64_t blocks = (n + S::LANES - 1) / S::LANES;
  ed25519_rlc_lanes<LAYOUT><<<(unsigned)blocks, S::THREADS, S::SMEM_BYTES, stream>>>(
      packed, n, consts, codes, partials, ticket);
  return (int)cudaGetLastError();
}

template <int LAYOUT>
int lanes_occupancy() {
  const cudaError_t attr = lanes_attr<LAYOUT>();
  if (attr != cudaSuccess) return -(int)attr;
  int blocks = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, ed25519_rlc_lanes<LAYOUT>, Shape<LAYOUT>::THREADS, Shape<LAYOUT>::SMEM_BYTES);
  return rc == cudaSuccess ? blocks : -(int)rc;
}

}  // namespace

extern "C" {

// Lanes a block of ed25519_rlc_lanes takes in `layout` (0 WHOLE, 1 SPLIT):
// a launch's partial points are ceil(n / this).
int ed25519_rlc_lanes_per_block(int layout) {
  return layout == WHOLE ? Shape<WHOLE>::LANES : Shape<SPLIT>::LANES;
}

// Blocks of `layout` resident on one SM of the current device, or minus a
// cudaError_t.
int ed25519_rlc_lanes_occupancy(int layout) {
  return layout == WHOLE ? lanes_occupancy<WHOLE>() : lanes_occupancy<SPLIT>();
}

// Launch on `stream`; returns a cudaError_t (0 when the launch was
// accepted). Asynchronous: a fault during the run shows at the next sync.
// `partials` holds ceil(n / ed25519_rlc_lanes_per_block(layout)) points
// of (4, 10) int32; `ticket` is the fold's, zeroed here.
int ed25519_rlc_lanes_launch(const uint8_t* packed, int64_t n, const int32_t* consts,
                             uint8_t* codes, int32_t* partials, unsigned* ticket, int layout,
                             void* stream) {
  if (n <= 0) return 0;
  if (layout != WHOLE && layout != SPLIT) return (int)cudaErrorInvalidValue;
  return layout == WHOLE
             ? lanes_launch<WHOLE>(packed, n, consts, codes, partials, ticket, (cudaStream_t)stream)
             : lanes_launch<SPLIT>(packed, n, consts, codes, partials, ticket, (cudaStream_t)stream);
}

// The fold of `nparts` points over `blocks` blocks of `threads` (a power of
// two, 32 to FOLD_THREADS; each quad adds at most a few points): `level2`
// holds `blocks` points, `ticket` is 0 on entry and again on exit.
int ed25519_rlc_fold_launch(const int32_t* partials, int64_t nparts, const int32_t* consts,
                            int32_t* level2, unsigned* ticket, uint8_t* eq, int blocks,
                            int threads, void* stream) {
  if (nparts <= 0) return 0;
  if (blocks < 1 || threads < 32 || threads > FOLD_THREADS || (threads & (threads - 1)))
    return (int)cudaErrorInvalidValue;
  ed25519_rlc_fold<<<blocks, threads, 0, (cudaStream_t)stream>>>(partials, nparts, consts, level2,
                                                                 ticket, eq);
  return (int)cudaGetLastError();
}

const char* ed25519_rlc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
}
