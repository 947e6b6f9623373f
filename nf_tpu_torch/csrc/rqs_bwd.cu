// Kernel C: the analytic backward of the unconstrained RQ spline (kernel
// A), forward or inverse direction.
//
// Replaces nf_tpu/ops/splines_pallas.py:_rqs_bwd_kernel_analytic (launcher
// _pallas_bwd_impl, :474). Same function: the operands of kernel A plus
// the cotangents (cty, ctl) of (y, log|det|) -> gx and the K width, K
// height and K+1 derivative logit cotangents of every element.
//
// Design. One thread per element; the math is rqs_bwd_math.cuh, which
// recomputes the forward in registers, so the residuals are the inputs
// alone (as the JAX custom VJP saves them). Inputs are read through the
// same strides as kernel A (bin-minor, bin-major, transposed, stride-0
// broadcast parameters), and the cotangents through their own, since
// autograd hands in expanded or transposed views. Outputs are written to
// fresh contiguous (K, rows, cols) planes, never through the input views:
// a parameter broadcast with stride 0 would have every thread of the batch
// writing the same address. Its per-element gradients are summed by
// autograd's expand backward, as XLA sums the transpose of the JAX
// package's broadcast.
//
// Bound on the H100: per element it reads x, cty and ctl (the parameters
// of the CDF are stride-0 broadcasts that stay in cache) and writes gx and
// 3K+1 planes: (3K+5) * 4 bytes, 116 at K = 8, against ~450 flops of f32
// math, ~4 flop/byte, far below the f32 ridge of ~20: the stores bound it.
// The stores of a warp cover 32 consecutive floats of each plane, so they
// coalesce into full 128-byte lines.
#include <cuda_runtime.h>

#include <cstdint>

#include "rqs_bwd_math.cuh"

namespace {

struct Strides {
  // as rqs_fwd.cu, plus the (rows, cols) strides of the two cotangents
  long long x[2], w[3], h[3], d[3], tb[2], cty[2], ctl[2];
};

template <int K, bool INVERSE>
__global__ void rqs_bwd_kernel(const float* __restrict__ x,
                               const float* __restrict__ uw,
                               const float* __restrict__ uh,
                               const float* __restrict__ ud,
                               const float* __restrict__ tb, float tb_scalar,
                               const float* __restrict__ cty,
                               const float* __restrict__ ctl, Strides s,
                               long long rows, long long cols,
                               float min_bin_width, float min_bin_height,
                               float min_derivative, float* __restrict__ gx,
                               float* __restrict__ gw, float* __restrict__ gh,
                               float* __restrict__ gd) {
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
    w[k] = uw[ow + k * s.w[0]];
    h[k] = uh[oh + k * s.h[0]];
  }
#pragma unroll
  for (int k = 0; k < K + 1; ++k) d[k] = ud[od + k * s.d[0]];
  const float t = tb ? tb[r * s.tb[0] + c * s.tb[1]] : tb_scalar;
  const float xv = x[r * s.x[0] + c * s.x[1]];
  const float cy = cty[r * s.cty[0] + c * s.cty[1]];
  const float cl = ctl[r * s.ctl[0] + c * s.ctl[1]];

  float gxv, gwv[K], ghv[K], gdv[K + 1];
  nf::rqs_bwd_element<K, INVERSE>(xv, t, w, h, d, cy, cl, min_bin_width,
                                  min_bin_height, min_derivative, gxv, gwv,
                                  ghv, gdv);
  gx[i] = gxv;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    gw[k * n + i] = gwv[k];
    gh[k * n + i] = ghv[k];
  }
#pragma unroll
  for (int k = 0; k < K + 1; ++k) gd[k * n + i] = gdv[k];
}

template <int K, bool INVERSE>
void launch(const float* x, const float* uw, const float* uh, const float* ud,
            const float* tb, float tb_scalar, const float* cty,
            const float* ctl, const Strides& s, long long rows,
            long long cols, float mbw, float mbh, float md, float* gx,
            float* gw, float* gh, float* gd, cudaStream_t stream) {
  const int threads = 256;
  const long long n = rows * cols;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  rqs_bwd_kernel<K, INVERSE><<<blocks, threads, 0, stream>>>(
      x, uw, uh, ud, tb, tb_scalar, cty, ctl, s, rows, cols, mbw, mbh, md,
      gx, gw, gh, gd);
}

}  // namespace

// C interface for ctypes. `strides` points to 17 int64: x(2), w(3), h(3),
// d(3), tb(2), cty(2), ctl(2). gx (rows, cols), gw and gh (K, rows, cols),
// gd (K+1, rows, cols) are contiguous. Returns cudaGetLastError() after
// the launch; -1 for a bin count that has no instantiation.
extern "C" int rqs_bwd_launch(const float* x, const float* uw,
                              const float* uh, const float* ud,
                              const float* tb, const float* cty,
                              const float* ctl, float tb_scalar,
                              const long long* strides, long long rows,
                              long long cols, int num_bins, int inverse,
                              float min_bin_width, float min_bin_height,
                              float min_derivative, float* gx, float* gw,
                              float* gh, float* gd, void* stream) {
  Strides s;
  const long long* p = strides;
  for (int j = 0; j < 2; ++j) s.x[j] = *p++;
  for (int j = 0; j < 3; ++j) s.w[j] = *p++;
  for (int j = 0; j < 3; ++j) s.h[j] = *p++;
  for (int j = 0; j < 3; ++j) s.d[j] = *p++;
  for (int j = 0; j < 2; ++j) s.tb[j] = *p++;
  for (int j = 0; j < 2; ++j) s.cty[j] = *p++;
  for (int j = 0; j < 2; ++j) s.ctl[j] = *p++;
  if (rows * cols == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NF_RQS_BWD_CASE(KK)                                                 \
  case KK:                                                                  \
    if (inverse)                                                            \
      launch<KK, true>(x, uw, uh, ud, tb, tb_scalar, cty, ctl, s, rows,     \
                       cols, min_bin_width, min_bin_height, min_derivative, \
                       gx, gw, gh, gd, st);                                 \
    else                                                                    \
      launch<KK, false>(x, uw, uh, ud, tb, tb_scalar, cty, ctl, s, rows,    \
                        cols, min_bin_width, min_bin_height,                \
                        min_derivative, gx, gw, gh, gd, st);                \
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
