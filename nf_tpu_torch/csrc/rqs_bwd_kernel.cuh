// The launch shared by the two backward kernels of the standalone spline,
// kernel C (rqs_bwd.cu, the analytic transpose) and kernel D
// (rqs_bwd_autodiff.cu, the mechanical adjoint). They take the same
// operands and write the same outputs; only the per-element math differs,
// and it comes in as a policy type whose `apply<K, INVERSE>` has the
// signature of nf::rqs_bwd_element.
//
// One thread per element, in blocks of kBwdThreads. Inputs are read
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

// 128: at the circular NSF's 32768 elements, 256 blocks reach all 132 SMs
// in one wave, where 128 blocks of 256 threads reach 128 of them
constexpr int kBwdThreads = 128;

template <class Math, class T, int K, bool INVERSE>
__global__ void rqs_bwd_kernel(const T* __restrict__ x,
                               const T* __restrict__ uw,
                               const T* __restrict__ uh,
                               const T* __restrict__ ud,
                               const T* __restrict__ tb, float tb_scalar,
                               const T* __restrict__ cty,
                               const T* __restrict__ ctl, BwdStrides s,
                               long long rows, long long cols,
                               float min_bin_width, float min_bin_height,
                               float min_derivative, T* __restrict__ gx,
                               T* __restrict__ gw, T* __restrict__ gh,
                               T* __restrict__ gd) {
  const long long n = rows * cols;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long r = i / cols;
  const long long c = i - r * cols;

  float w[K], h[K], d[K + 1];
  const long long ow = r * s.w[1] + c * s.w[2];
  const long long oh = r * s.h[1] + c * s.h[2];
  const long long od = r * s.d[1] + c * s.d[2];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    w[k] = to_f32(uw[ow + k * s.w[0]]);
    h[k] = to_f32(uh[oh + k * s.h[0]]);
  }
#pragma unroll
  for (int k = 0; k < K + 1; ++k) d[k] = to_f32(ud[od + k * s.d[0]]);
  const float t = tb ? to_f32(tb[r * s.tb[0] + c * s.tb[1]]) : tb_scalar;
  const float xv = to_f32(x[r * s.x[0] + c * s.x[1]]);
  const float cy = to_f32(cty[r * s.cty[0] + c * s.cty[1]]);
  const float cl = to_f32(ctl[r * s.ctl[0] + c * s.ctl[1]]);

  float gxv, gwv[K], ghv[K], gdv[K + 1];
  Math::template apply<K, INVERSE>(xv, t, w, h, d, cy, cl, min_bin_width,
                                   min_bin_height, min_derivative, gxv, gwv,
                                   ghv, gdv);
  gx[i] = from_f32<T>(gxv);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    gw[k * n + i] = from_f32<T>(gwv[k]);
    gh[k * n + i] = from_f32<T>(ghv[k]);
  }
#pragma unroll
  for (int k = 0; k < K + 1; ++k) gd[k * n + i] = from_f32<T>(gdv[k]);
}

template <class Math, class T, int K, bool INVERSE>
void rqs_bwd_launch_k(const T* x, const T* uw, const T* uh, const T* ud,
                      const T* tb, float tb_scalar, const T* cty,
                      const T* ctl, const BwdStrides& s, long long rows,
                      long long cols, float mbw, float mbh, float md, T* gx,
                      T* gw, T* gh, T* gd, cudaStream_t stream) {
  const long long n = rows * cols;
  const unsigned blocks =
      static_cast<unsigned>((n + kBwdThreads - 1) / kBwdThreads);
  rqs_bwd_kernel<Math, T, K, INVERSE><<<blocks, kBwdThreads, 0, stream>>>(
      x, uw, uh, ud, tb, tb_scalar, cty, ctl, s, rows, cols, mbw, mbh, md,
      gx, gw, gh, gd);
}

// The body of both C entry points. `strides` points to 17 int64: x(2),
// w(3), h(3), d(3), tb(2), cty(2), ctl(2). gx (rows, cols), gw and gh
// (K, rows, cols), gd (K+1, rows, cols) are contiguous. Returns
// cudaGetLastError() after the launch; -1 for a bin count that has no
// instantiation. T is the storage type of every tensor (float or
// __nv_bfloat16).
template <class Math, class T>
int rqs_bwd_dispatch(const T* x, const T* uw, const T* uh, const T* ud,
                     const T* tb, const T* cty, const T* ctl, float tb_scalar,
                     const long long* strides, long long rows, long long cols,
                     int num_bins, int inverse, float min_bin_width,
                     float min_bin_height, float min_derivative, T* gx, T* gw,
                     T* gh, T* gd, void* stream) {
  const BwdStrides s = bwd_strides(strides);
  if (rows * cols == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NF_RQS_BWD_CASE(KK)                                                  \
  case KK:                                                                   \
    if (inverse)                                                             \
      rqs_bwd_launch_k<Math, T, KK, true>(                                  \
          x, uw, uh, ud, tb, tb_scalar, cty, ctl, s, rows, cols,             \
          min_bin_width, min_bin_height, min_derivative, gx, gw, gh, gd, st); \
    else                                                                     \
      rqs_bwd_launch_k<Math, T, KK, false>(                                 \
          x, uw, uh, ud, tb, tb_scalar, cty, ctl, s, rows, cols,             \
          min_bin_width, min_bin_height, min_derivative, gx, gw, gh, gd, st); \
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
