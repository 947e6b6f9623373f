// The per-element schedule of kernels A (rqs_fwd.cu) and C and D
// (rqs_bwd_kernel.cuh): how an element's operands reach the thread that
// runs its math. The math itself is rqs_math.cuh's, rqs_bwd_math.cuh's and
// rqs_vjp_math.cuh's, untouched, so the schedule gives the same bits as
// the one-thread-per-element kernels it replaced.
//
// What holds these kernels (PERF.md, section 6). A thread loads its
// element's 3K+3 operands (3K+5 in the backward), runs the chain of two
// softmaxes, the knots, the masked selects and the map, and stores. Timed
// with the chain removed, the earlier launch kept 80-94% of its time; with
// the stores removed, 84-100%: the loads, behind the launch floor, set the
// time, not bytes and arithmetic one after the other. With many warps
// resident their loads are in flight together and warps at other phases
// hide each other's chains already. What a redesign can still remove: the
// 64-bit division and offsets of every element, and, where few warps fit
// an SM, the exposed loads (D's ring, rqs_ring.cuh).
//
// One tile a warp: warp w of block b takes the kTile consecutive elements
// from (b * kWarps + w) * kTile of the (rows, cols) grid in row-major
// order, one a lane: the outputs' order, so every store of a warp is one
// run of kTile elements of a plane. A lane's row and column come from one
// division by cols, and each operand's planes are loaded straight into
// registers, through 32-bit offsets wherever the call's largest element
// offset fits (every path's shapes; a 64-bit instantiation for the rest,
// splines_kernel.per_element_offsets32 decides). No shared memory.
#pragma once

#include <cuda_runtime.h>

#include "rqs_math.cuh"

namespace nf {
namespace tile {

constexpr int kTile = 32;  // elements a warp takes, one a lane
constexpr int kWarps = 4;  // warps a block
constexpr int kThreads = kTile * kWarps;

// The operands, in the order of a C entry point's strides (and of the
// ring's route bits, rqs_ring.cuh); a kernel without cotangents stops at
// the tail bound.
enum : int { kX = 0, kW, kH, kD, kTb, kCty, kCtl, kOperands };

template <class T, class I>
struct Operand {
  const T* p;       // null: absent (a float tail bound; A's cotangents)
  I bin, row, col;  // element strides: plane, row, column
};

template <class T, class I>
struct Operands {
  Operand<T, I> op[kOperands];
  I rows, cols;
};

// The operands and 64-bit strides of a C entry point as a kernel takes
// them: x (2 strides), w, h, d (3 each), tb, cty, ctl (2 each); the first
// `ops` operands, the rest absent.
template <class T, class I>
Operands<T, I> operands(const T* const (&p)[kOperands], int ops,
                        const long long* strides, long long rows,
                        long long cols) {
  Operands<T, I> a = {};
  for (int o = 0; o < ops; ++o) {
    const bool planes = o == kW || o == kH || o == kD;
    a.op[o].p = p[o];
    a.op[o].bin = planes ? static_cast<I>(*strides++) : 0;
    a.op[o].row = static_cast<I>(*strides++);
    a.op[o].col = static_cast<I>(*strides++);
  }
  a.rows = static_cast<I>(rows);
  a.cols = static_cast<I>(cols);
  return a;
}

// The blocks of a launch over n elements, one tile a warp.
inline unsigned blocks_of(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// This thread's element i of the (rows, cols) grid, false past its end.
template <class I>
__device__ __forceinline__ bool element_of(const I rows, const I cols, I& i,
                                           I& r, I& c) {
  i = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= rows * cols) return false;
  r = i / cols;
  c = i - r * cols;
  return true;
}

// The P planes of operand O of element (r, c), read straight from device
// memory into registers and widened to float32.
template <int O, class T, class I, int P>
__device__ __forceinline__ void operand_direct(const Operands<T, I>& a, I r,
                                               I c, float (&v)[P]) {
  const Operand<T, I>& op = a.op[O];
  const T* e = op.p + (r * op.row + c * op.col);
#pragma unroll
  for (int p = 0; p < P; ++p) v[p] = to_f32(__ldg(e + p * op.bin));
}

}  // namespace tile
}  // namespace nf
