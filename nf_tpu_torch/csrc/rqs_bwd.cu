// Kernel C: the analytic backward of the unconstrained RQ spline (kernel
// A), forward or inverse direction.
//
// Replaces nf_tpu/ops/splines_pallas.py:_rqs_bwd_kernel_analytic (launcher
// _pallas_bwd_impl, :474). Same function: the operands of kernel A plus
// the cotangents (cty, ctl) of (y, log|det|) -> gx and the K width, K
// height and K+1 derivative logit cotangents of every element.
//
// Design. One thread per element (the launch, strides and output layout
// are rqs_bwd_kernel.cuh's, shared with kernel D); the math is
// rqs_bwd_math.cuh, which recomputes the forward in registers, so the
// residuals are the inputs alone (as the JAX custom VJP saves them).
//
// Bound on the H100: per element it reads x, cty and ctl (the parameters
// of the CDF are stride-0 broadcasts that stay in cache) and writes gx and
// 3K+1 planes: (3K+5) * 4 bytes, 116 at K = 8, against ~450 flops of f32
// math, ~4 flop/byte, far below the f32 ridge of ~20: the stores bound it.
#include "rqs_bwd_kernel.cuh"
#include "rqs_bwd_math.cuh"

struct AnalyticMath {
  template <int K, bool INVERSE>
  __device__ static void apply(float x, float tb, const float (&uw)[K],
                               const float (&uh)[K], const float (&ud)[K + 1],
                               float cty, float ctl, float mbw, float mbh,
                               float md, float& gx, float (&gw)[K],
                               float (&gh)[K], float (&gd)[K + 1]) {
    nf::rqs_bwd_element<K, INVERSE>(x, tb, uw, uh, ud, cty, ctl, mbw, mbh,
                                    md, gx, gw, gh, gd);
  }
};

// C interface for ctypes: see nf::rqs_bwd_dispatch.
extern "C" int rqs_bwd_launch(const float* x, const float* uw,
                              const float* uh, const float* ud,
                              const float* tb, const float* cty,
                              const float* ctl, float tb_scalar,
                              const long long* strides, long long rows,
                              long long cols, int num_bins, int inverse,
                              float min_bin_width, float min_bin_height,
                              float min_derivative, float* gx, float* gw,
                              float* gh, float* gd, void* stream) {
  return nf::rqs_bwd_dispatch<AnalyticMath>(
      x, uw, uh, ud, tb, cty, ctl, tb_scalar, strides, rows, cols, num_bins,
      inverse, min_bin_width, min_bin_height, min_derivative, gx, gw, gh, gd,
      stream);
}
