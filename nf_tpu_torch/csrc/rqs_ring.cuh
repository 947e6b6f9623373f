// Kernel D's ring (rqs_bwd_autodiff.cu): a second form of the per-element
// backward launch (rqs_bwd_kernel.cuh), for where few of D's warps fit an
// SM. The math is rqs_vjp_math.cuh's, untouched, and ends in the same
// bwd_element as the one-tile kernel, so both forms give the same bits.
//
// Why D alone. At K 8 and 10 the adjoint's ~106-128 registers leave 4
// blocks of 4 warps an SM; where one wave does not hold every block, the
// one-tile kernel's warps wait out their loads with too few others to
// hide them. A and C keep 9-16 and 5-8 blocks an SM; the ring was timed
// for them at every shape of chip_smoke.py's PER_ELEMENT_BARS and at four
// times the image batch and was slower there (its stages cost occupancy
// and its reads a pass through shared memory), so they launch the
// one-tile kernel only and this header is not built into them.
//
// The ring. Blocks of kWarps warps walk the tiles persistently (warp w of
// W takes tiles w, w + W, ...), the grid at most what stays resident, so
// it is fixed per shape and a CUDA graph replays it. Each warp owns
// kStages stages in shared memory, a stage one tile's operands (x, every
// parameter plane, the tail bound, the two cotangents; kTile 4-byte slots
// a plane); while it computes a tile, cp.async copies bring its next tile
// into the other stage, and registers hold one element's operands at a
// time. Copy routes come from the caller (splines_kernel.ring_routes), a
// bit an operand in `routes`: a set bit says each plane of the operand
// holds every full tile as one run of kTile elements starting on 16
// bytes, and the tile comes in 16-byte copies, kTile*4/16 lanes a plane (a
// plane per 8 lanes in float32, per 4 in bfloat16), one copy instruction
// moving 4 or 8 planes. Otherwise each lane copies its own element's 4
// bytes: a float32 element, or the aligned word that holds a bfloat16
// element (cp.async has no 2-byte copy; the word never leaves the
// allocation, aligned to far more than 4 bytes), the half it needs kept as
// a bit an operand in `halves`. A broadcast operand (column stride 0)
// takes that route, and lanes that share an address share one
// transaction. The last tile, when ragged, takes it for every operand.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "rqs_bwd_kernel.cuh"

namespace nf {
namespace ring {

using tile::kTile;
using tile::kWarps;
using tile::kThreads;
using tile::kX, tile::kW, tile::kH, tile::kD, tile::kTb, tile::kCty,
    tile::kCtl, tile::kOperands;
constexpr int kStages = 2;        // tiles of a warp in shared memory
constexpr int kVectorBytes = 16;  // a copy of a tile's run
// the ring is launched only where the one-tile form keeps at most this
// many warps an SM and needs more than one wave (launch_form)
constexpr int kRingWarps = 16;
static_assert(kStages == 2, "the loop swaps the two stages");

template <class T, class I>
using Operand = tile::Operand<T, I>;
template <class T, class I>
using Operands = tile::Operands<T, I>;

template <int K>
__host__ __device__ constexpr int planes_of(int o) {
  return o == kW || o == kH ? K : o == kD ? K + 1 : 1;
}

template <int K>
__host__ __device__ constexpr int first_plane(int o) {
  return o == 0 ? 0 : first_plane<K>(o - 1) + planes_of<K>(o - 1);
}

// 4-byte slots of one warp's ring for a kernel with `ops` operands
template <int K>
__host__ __device__ constexpr int ring_slots(int ops) {
  return kStages * first_plane<K>(ops) * kTile;
}

// v, hidden from the optimiser: a running offset stays a running offset,
// one add a plane, and is not hoisted out of the tile loop as a product
// per plane (27 to 35 registers held across the chain)
template <class I>
__device__ __forceinline__ I opaque(I v) {
  if constexpr (sizeof(I) == 4)
    asm volatile("" : "+r"(v));
  else
    asm volatile("" : "+l"(v));
  return v;
}

// Operand O of the tile starting at linear index i0, row r0, column c0
// into `stage`; (r, c) is the lane's element, live when `active`.
template <int O, int K, class T, class I>
__device__ __forceinline__ void stage_operand(uint32_t* stage,
                                              const Operand<T, I>& op,
                                              bool vec, I r0, I c0, I r,
                                              I c, bool active, int lane,
                                              unsigned& halves) {
  constexpr int P = planes_of<K>(O), F = first_plane<K>(O);
  uint32_t* slot = stage + F * kTile;
  // the strides read afresh each tile, so that nothing derived from them
  // is hoisted out of the tile loop and held through the chain
  const I bin = opaque<I>(op.bin), row = opaque<I>(op.row);
  if (vec) {
    constexpr int kLanes = kTile * static_cast<int>(sizeof(T)) /
                           kVectorBytes;  // lanes a plane
    constexpr int kPer = 32 / kLanes;     // planes a copy instruction
    const int q = lane / kLanes, part = lane % kLanes;
    I off = opaque<I>(r0 * row + c0 + q * bin +
                      part * (kVectorBytes / static_cast<int>(sizeof(T))));
    uint32_t* dst = slot + q * kTile + part * (kVectorBytes / 4);
#pragma unroll
    for (int p0 = 0; p0 < P; p0 += kPer) {
      if (p0 + q < P)
        __pipeline_memcpy_async(dst + p0 * kTile, op.p + off, kVectorBytes);
      off = opaque<I>(off + kPer * bin);
    }
  } else if (active) {
    I off = opaque<I>(r * row + c * opaque<I>(op.col));
    if constexpr (sizeof(T) != 4) {
      // plane p's element is in the upper half of its word when bit 1 of
      // its address is set: plane 0's bit, flipped on odd planes where the
      // bin stride is odd (operand_planes)
      halves |= static_cast<unsigned>(
                    (reinterpret_cast<uintptr_t>(op.p + off) >> 1) & 1)
                << O;
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const T* e = op.p + off;
      if constexpr (sizeof(T) == 4) {
        __pipeline_memcpy_async(slot + p * kTile + lane, e, 4);
      } else {
        __pipeline_memcpy_async(
            slot + p * kTile + lane,
            reinterpret_cast<const void*>(reinterpret_cast<uintptr_t>(e) &
                                          ~static_cast<uintptr_t>(3)),
            4);
      }
      off = opaque<I>(off + bin);
    }
  }
}

// Copies of tile `t` (its first element's linear index t * kTile) into
// `stage`, for every operand; the caller commits. Bit o of `halves` set:
// operand o's first plane came by lanes and its bfloat16 element is the
// upper half of its slot.
template <int K, class T, class I>
__device__ __forceinline__ void stage_tile(uint32_t* stage,
                                           const Operands<T, I>& a,
                                           unsigned routes, I t, I n,
                                           int lane, unsigned& halves) {
  // the tile's first row and column, then the lane's (a second division
  // only where a row is shorter than a tile)
  const I cols = opaque<I>(a.cols);
  const I i0 = t * kTile;
  const I r0 = i0 / cols;
  const I c0 = i0 - r0 * cols;
  I r = r0, c = c0 + lane;
  if (c >= cols) {
    const I q = cols >= kTile ? I(1) : c / cols;
    r += q;
    c -= q * cols;
  }
  const bool full = i0 + kTile <= n, active = i0 + lane < n;
#define NF_RING_STAGE(O)                                                   \
  if (a.op[O].p)                                                           \
    stage_operand<(O), K>(stage, a.op[O], full && ((routes >> (O)) & 1),  \
                          r0, c0, r, c, active, lane, halves);
  NF_RING_STAGE(kX)
  NF_RING_STAGE(kW)
  NF_RING_STAGE(kH)
  NF_RING_STAGE(kD)
  NF_RING_STAGE(kTb)
  NF_RING_STAGE(kCty)
  NF_RING_STAGE(kCtl)
#undef NF_RING_STAGE
}

// The P planes of operand O for the lane's element in a stage, widened to
// float32 (exactly as to_f32 widens a load). A bfloat16 plane that came
// by 16-byte copies holds the element at half `lane` of its slot, one that
// came by lanes in half `lane` of its word, the upper one where `halves`
// says so for the first plane (flipped on odd planes of an odd bin
// stride): one index an operand, not a plane.
template <int O, int K, class T, class I, int P>
__device__ __forceinline__ void operand_planes(const uint32_t* stage,
                                               const Operands<T, I>& a,
                                               unsigned routes, bool full,
                                               int lane, unsigned halves,
                                               float (&v)[P]) {
  const uint32_t* slot = stage + first_plane<K>(O) * kTile;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int p = 0; p < P; ++p) v[p] = __uint_as_float(slot[p * kTile + lane]);
  } else {
    const unsigned short* half =
        reinterpret_cast<const unsigned short*>(slot);
    const bool vec = full && ((routes >> O) & 1);
    const int j0 =
        vec ? lane : 2 * lane + static_cast<int>((halves >> O) & 1);
    const int j1 = vec ? lane : j0 ^ static_cast<int>(a.op[O].bin & 1);
#pragma unroll
    for (int p = 0; p < P; ++p)
      v[p] = __bfloat162float(
          __ushort_as_bfloat16(half[p * 2 * kTile + (p & 1 ? j1 : j0)]));
  }
}

// The blocks of kThreads threads and `smem` bytes of dynamic shared memory
// (the ring's stages stay under the 48 KB a block takes without opting
// in) that one SM holds at once for `kernel`, the carveout set to shared
// memory where it takes any; 0 if the runtime cannot say. Asked once per
// instantiation by the launchers (a static).
template <class Kernel>
int blocks_per_sm(Kernel kernel, int smem) {
  int per_sm = 0;
  if ((smem > 0 &&
       cudaFuncSetAttribute(kernel,
                            cudaFuncAttributePreferredSharedMemoryCarveout,
                            cudaSharedmemCarveoutMaxShared) != cudaSuccess) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, smem) !=
          cudaSuccess)
    return 0;
  return per_sm;
}

// The current device's SMs (asked once, by the first launch).
inline int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    return n;
  }();
  return sms;
}

// The form of a launch over n elements, a block per kWarps tiles, from
// the blocks an SM holds of the one-tile kernel (`direct`) and of the
// ring's (`ring`): the ring (true) where the one-tile kernel keeps at most
// kRingWarps warps an SM and one wave does not take every block, with a
// persistent grid of at most what stays resident; else one tile a warp
// (false), whose warps' loads are then in flight together and hide each
// other's chains.
inline bool launch_form(long long n, int direct, int ring, unsigned& grid) {
  const long long tiles = (n + kTile - 1) / kTile;
  const long long blocks = (tiles + kWarps - 1) / kWarps;
  const long long resident = static_cast<long long>(ring) * sm_count();
  const bool use_ring =
      direct * kWarps <= kRingWarps &&
      blocks > static_cast<long long>(direct) * sm_count() && resident > 0;
  grid = static_cast<unsigned>(use_ring && resident < blocks ? resident
                                                             : blocks);
  return use_ring;
}

// The ring form of the per-element backward launch (kernel D's): each
// warp stages its next tile while it runs this one's math, then
// bwd_element as the one-tile kernel.
template <class Math, class T, int K, bool INVERSE, class I>
__global__ void rqs_bwd_ring_kernel(
    const __grid_constant__ Operands<T, I> a, unsigned routes,
    float tb_scalar, float min_bin_width, float min_bin_height,
    float min_derivative, T* __restrict__ gx, T* __restrict__ gw,
    T* __restrict__ gh, T* __restrict__ gd) {
  constexpr int kStage = ring_slots<K>(kOperands) / kStages;
  extern __shared__ __align__(16) uint32_t ring_smem[];
  const int lane = threadIdx.x & 31;
  uint32_t* stages =
      ring_smem + (threadIdx.x >> 5) * ring_slots<K>(kOperands);
  const I n = a.rows * a.cols;
  const I tiles = (n + kTile - 1) / kTile;
  const I step = static_cast<I>(gridDim.x) * kWarps;
  I t = static_cast<I>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  unsigned halves = 0;
  if (t < tiles) stage_tile<K>(stages, a, routes, t, n, lane, halves);
  __pipeline_commit();
  for (int s = 0; t < tiles; t += step, s ^= 1) {
    const I i0 = t * kTile;
    const bool full = i0 + kTile <= n;
    float w[K], h[K], d[K + 1], xv[1], tv[1] = {tb_scalar}, cy[1], cl[1];
    // the next tile's copies into the other stage (read before the last
    // iteration's second __syncwarp), in flight during this tile's chain
    unsigned halves_next = 0;
    if (t + step < tiles)
      stage_tile<K>(stages + (s ^ 1) * kStage, a, routes, t + step, n, lane,
                    halves_next);
    __pipeline_commit();
    // this tile's copies have landed, every lane's
    __pipeline_wait_prior(1);
    __syncwarp();
    const uint32_t* st = stages + s * kStage;
    operand_planes<kW, K>(st, a, routes, full, lane, halves, w);
    operand_planes<kH, K>(st, a, routes, full, lane, halves, h);
    operand_planes<kD, K>(st, a, routes, full, lane, halves, d);
    operand_planes<kX, K>(st, a, routes, full, lane, halves, xv);
    if (a.op[kTb].p)
      operand_planes<kTb, K>(st, a, routes, full, lane, halves, tv);
    operand_planes<kCty, K>(st, a, routes, full, lane, halves, cy);
    operand_planes<kCtl, K>(st, a, routes, full, lane, halves, cl);
    halves = halves_next;
    // every lane has read this stage: the next iteration may refill it
    __syncwarp();
    const I i = i0 + lane;
    if (i < n)
      bwd_element<Math, T, K, INVERSE>(w, h, d, xv[0], tv[0], cy[0], cl[0],
                                       min_bin_width, min_bin_height,
                                       min_derivative, i, n, gx, gw, gh, gd);
  }
}

// The Launch policy of kernel D (rqs_bwd_kernel.cuh's dispatch): the ring
// or the one-tile kernel, per launch_form. The occupancy of each is asked
// once per instantiation (statics).
struct RingLaunch {
  template <class Math, class T, int K, bool INVERSE, class I>
  static void launch(const Operands<T, I>& a, unsigned routes,
                     float tb_scalar, float mbw, float mbh, float md, T* gx,
                     T* gw, T* gh, T* gd, cudaStream_t stream) {
    constexpr int kSmem = kWarps * ring_slots<K>(kOperands) * 4;
    auto with_ring = rqs_bwd_ring_kernel<Math, T, K, INVERSE, I>;
    auto direct = rqs_bwd_kernel<Math, T, K, INVERSE, I>;
    static const int ring_per_sm = blocks_per_sm(with_ring, kSmem);
    static const int direct_per_sm = blocks_per_sm(direct, 0);
    unsigned grid;
    if (launch_form(static_cast<long long>(a.rows) * a.cols, direct_per_sm,
                    ring_per_sm, grid))
      with_ring<<<grid, kThreads, kSmem, stream>>>(
          a, routes, tb_scalar, mbw, mbh, md, gx, gw, gh, gd);
    else
      OneTileLaunch::launch<Math, T, K, INVERSE>(a, routes, tb_scalar, mbw,
                                                 mbh, md, gx, gw, gh, gd,
                                                 stream);
  }
};

}  // namespace ring
}  // namespace nf
