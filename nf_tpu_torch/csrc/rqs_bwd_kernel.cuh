// The launch shared by the two backward kernels of the standalone spline,
// kernel C (rqs_bwd.cu, the analytic transpose) and kernel D
// (rqs_bwd_autodiff.cu, the mechanical adjoint). They take the same
// operands and write the same outputs; only the per-element math differs,
// and it comes in as a policy type whose `apply<K, INVERSE>` has the
// signature of nf::rqs_bwd_element.
//
// The schedule is kernel A's (rqs_per_element.cuh): a warp takes a tile of
// 32 consecutive elements, indexed in 32 bits where the call fits, each
// lane loads its element's operands, runs the policy's math and stores gx
// and its 3K+1 gradients. A Launch policy of the dispatch may pick another
// form per launch: kernel D's picks its ring (rqs_ring.cuh) where few of
// its warps fit an SM. C keeps 5-8 blocks of 4 warps an SM and launches
// the one-tile kernel only: the ring was slower for it at every shape
// timed (PERF.md, section 6). Inputs are read
// through the same strides as kernel A (bin-minor, bin-major, transposed,
// stride-0 broadcast parameters), and the cotangents through their own,
// since autograd hands in expanded or transposed views. Outputs are written
// to fresh contiguous (K, rows, cols) planes, never through the input
// views: a parameter broadcast with stride 0 would have every thread of the
// batch writing the same address. Where a parameter was broadcast, the
// autograd function around the kernels sums its planes (splines_kernel.
// _RQSFunction), as XLA sums the transpose of the JAX package's broadcast;
// the unconditional CDF's case, where every row shares the parameters, has
// a path of its own in kernel C that sums inside the kernel (rqs_bwd.cu).
// The stores of a warp cover 32 consecutive elements of each plane, so
// they coalesce into full lines (128 bytes in float32, 64 in bfloat16).
//
// The kernel is a template on the storage type T of every operand and
// output, float or __nv_bfloat16: a bfloat16 element is widened on load,
// the math is the float32 policy's, and each result is rounded once on
// store (rqs_math.cuh's to_f32 / from_f32), so the bfloat16 launch reads
// and writes 2 bytes per element.
#pragma once

#include <cuda_runtime.h>

#include "rqs_math.cuh"
#include "rqs_per_element.cuh"

namespace nf {

struct BwdStrides {
  // as rqs_fwd.cu, plus the (rows, cols) strides of the two cotangents
  long long x[2], w[3], h[3], d[3], tb[2], cty[2], ctl[2];
};

// The 17 int64 the C entry points take: x(2), w(3), h(3), d(3), tb(2),
// cty(2), ctl(2).
inline BwdStrides bwd_strides(const long long* p) {
  BwdStrides s;
  for (int j = 0; j < 2; ++j) s.x[j] = *p++;
  for (int j = 0; j < 3; ++j) s.w[j] = *p++;
  for (int j = 0; j < 3; ++j) s.h[j] = *p++;
  for (int j = 0; j < 3; ++j) s.d[j] = *p++;
  for (int j = 0; j < 2; ++j) s.tb[j] = *p++;
  for (int j = 0; j < 2; ++j) s.cty[j] = *p++;
  for (int j = 0; j < 2; ++j) s.ctl[j] = *p++;
  return s;
}

// The policy's math on element i's operands, then gx and its 3K+1
// gradients stored (a warp's stores one run of 32 elements a plane). Each
// form of the launch ends in this.
template <class Math, class T, int K, bool INVERSE, class I>
__device__ __forceinline__ void bwd_element(
    const float (&w)[K], const float (&h)[K], const float (&d)[K + 1],
    float x, float tb, float cy, float cl, float mbw, float mbh, float md,
    I i, I n, T* __restrict__ gx, T* __restrict__ gw, T* __restrict__ gh,
    T* __restrict__ gd) {
  float gxv, gwv[K], ghv[K], gdv[K + 1];
  Math::template apply<K, INVERSE>(x, tb, w, h, d, cy, cl, mbw, mbh, md, gxv,
                                   gwv, ghv, gdv);
  gx[i] = from_f32<T>(gxv);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    gw[k * n + i] = from_f32<T>(gwv[k]);
    gh[k * n + i] = from_f32<T>(ghv[k]);
  }
#pragma unroll
  for (int k = 0; k < K + 1; ++k) gd[k * n + i] = from_f32<T>(gdv[k]);
}

// The per-element launch, one tile a warp: rqs_per_element.cuh's schedule
// over all seven operands, then bwd_element.
template <class Math, class T, int K, bool INVERSE, class I>
__global__ void rqs_bwd_kernel(
    const __grid_constant__ tile::Operands<T, I> a, float tb_scalar,
    float min_bin_width, float min_bin_height, float min_derivative,
    T* __restrict__ gx, T* __restrict__ gw, T* __restrict__ gh,
    T* __restrict__ gd) {
  namespace P = tile;
  I i, r, c;
  if (!P::element_of(a.rows, a.cols, i, r, c)) return;
  float w[K], h[K], d[K + 1], xv[1], tv[1] = {tb_scalar}, cy[1], cl[1];
  P::operand_direct<P::kW>(a, r, c, w);
  P::operand_direct<P::kH>(a, r, c, h);
  P::operand_direct<P::kD>(a, r, c, d);
  P::operand_direct<P::kX>(a, r, c, xv);
  if (a.op[P::kTb].p) P::operand_direct<P::kTb>(a, r, c, tv);
  P::operand_direct<P::kCty>(a, r, c, cy);
  P::operand_direct<P::kCtl>(a, r, c, cl);
  bwd_element<Math, T, K, INVERSE>(w, h, d, xv[0], tv[0], cy[0], cl[0],
                                   min_bin_width, min_bin_height,
                                   min_derivative, i, a.rows * a.cols, gx, gw,
                                   gh, gd);
}

// The Launch policy of kernel C: the one-tile kernel at every shape
// (`routes`, the ring's, unused).
struct OneTileLaunch {
  template <class Math, class T, int K, bool INVERSE, class I>
  static void launch(const tile::Operands<T, I>& a, unsigned /*routes*/,
                     float tb_scalar, float mbw, float mbh, float md, T* gx,
                     T* gw, T* gh, T* gd, cudaStream_t stream) {
    rqs_bwd_kernel<Math, T, K, INVERSE, I>
        <<<tile::blocks_of(static_cast<long long>(a.rows) * a.cols),
           tile::kThreads, 0, stream>>>(a, tb_scalar, mbw, mbh, md, gx, gw,
                                        gh, gd);
  }
};

template <class Math, class Launch, class T, int K, bool INVERSE>
void rqs_bwd_launch_k(const T* const (&p)[tile::kOperands],
                      const long long* strides, long long rows,
                      long long cols, float tb_scalar, float mbw, float mbh,
                      float md, T* gx, T* gw, T* gh, T* gd, int offsets32,
                      unsigned routes, cudaStream_t stream) {
  if (offsets32)
    Launch::template launch<Math, T, K, INVERSE>(
        tile::operands<T, unsigned>(p, tile::kOperands, strides, rows, cols),
        routes, tb_scalar, mbw, mbh, md, gx, gw, gh, gd, stream);
  else
    Launch::template launch<Math, T, K, INVERSE>(
        tile::operands<T, unsigned long long>(p, tile::kOperands, strides,
                                              rows, cols),
        routes, tb_scalar, mbw, mbh, md, gx, gw, gh, gd, stream);
}

// The body of the per-element C entry points. `strides` points to 17
// int64: x(2), w(3), h(3), d(3), tb(2), cty(2), ctl(2). gx (rows, cols), gw
// and gh (K, rows, cols), gd (K+1, rows, cols) are contiguous.
// `offsets32` (splines_kernel.per_element_offsets32): 32-bit element
// offsets; `routes` goes to the Launch policy (kernel D's ring routes,
// splines_kernel.ring_routes; 0 for C). Returns cudaGetLastError() after
// the launch; -1 for a bin count that has no instantiation. T is the
// storage type of every tensor (float or __nv_bfloat16).
template <class Math, class Launch, class T>
int rqs_bwd_dispatch(const T* x, const T* uw, const T* uh, const T* ud,
                     const T* tb, const T* cty, const T* ctl, float tb_scalar,
                     const long long* strides, long long rows, long long cols,
                     int num_bins, int inverse, float min_bin_width,
                     float min_bin_height, float min_derivative, T* gx, T* gw,
                     T* gh, T* gd, int offsets32, unsigned routes,
                     void* stream) {
  if (rows * cols == 0) return 0;
  const T* const p[tile::kOperands] = {x, uw, uh, ud, tb, cty, ctl};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NF_RQS_BWD_CASE(KK)                                                 \
  case KK:                                                                  \
    if (inverse)                                                            \
      rqs_bwd_launch_k<Math, Launch, T, KK, true>(                          \
          p, strides, rows, cols, tb_scalar, min_bin_width, min_bin_height, \
          min_derivative, gx, gw, gh, gd, offsets32, routes, st);           \
    else                                                                    \
      rqs_bwd_launch_k<Math, Launch, T, KK, false>(                         \
          p, strides, rows, cols, tb_scalar, min_bin_width, min_bin_height, \
          min_derivative, gx, gw, gh, gd, offsets32, routes, st);           \
    break;
  switch (num_bins) {
    NF_RQS_BWD_CASE(4)
    NF_RQS_BWD_CASE(8)
    NF_RQS_BWD_CASE(10)
    default:
      return -1;
  }
#undef NF_RQS_BWD_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nf
