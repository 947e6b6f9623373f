// Kernel A: unconstrained RQ spline with identity tails, forward or inverse.
//
// Replaces nf_tpu/ops/splines_pallas.py:_rqs_kernel (launcher _pallas_impl,
// :450). Same function: per element x with tail bound tb, K width logits,
// K height logits and K+1 tail-padded derivative logits -> (y, log|det|).
//
// Design. One thread per element; the math is rqs_math.cuh. Elements form
// a (rows, cols) grid and every operand is addressed through its own
// strides, so the three callers run without materialising anything:
//   * bin-minor parameters (rows, cols, K): bin stride 1;
//   * bin-major planes (K, rows, cols): bin stride rows*cols;
//   * the unconditional CDF's per-feature parameters broadcast over the
//     batch with `.expand`: row stride 0.
// The ragged edge is masked in the kernel (no padding, unlike the TPU's
// (32, 128) blocks). A null tb pointer means the scalar tb_scalar.
//
// Bound on the H100: the work per element is ~30 loads of parameters and
// ~250 flops of f32 math. With materialised parameters (3K+3 reads and 2
// writes per element) it is memory bound; on the serving path the
// parameters are stride-0 broadcasts that stay in L1/L2, so per element it
// moves x, y and ld only (12 bytes): at B = 65536 that is under a
// microsecond of HBM time, and the launch itself dominates.
#include <cuda_runtime.h>

#include <cstdint>

#include "rqs_math.cuh"

namespace {

struct Strides {
  // element (r, c) of x at r*x[0] + c*x[1]; bin k of that element's width
  // logits at k*w[0] + r*w[1] + c*w[2]; likewise h, d; tb at r*tb[0] +
  // c*tb[1]
  long long x[2], w[3], h[3], d[3], tb[2];
};

template <int K, bool INVERSE>
__global__ void rqs_fwd_kernel(const float* __restrict__ x,
                               const float* __restrict__ uw,
                               const float* __restrict__ uh,
                               const float* __restrict__ ud,
                               const float* __restrict__ tb, float tb_scalar,
                               Strides s, long long rows, long long cols,
                               float min_bin_width, float min_bin_height,
                               float min_derivative, float* __restrict__ y,
                               float* __restrict__ ld) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rows * cols) return;
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

  float yv, lv;
  nf::rqs_element<K, INVERSE>(xv, t, w, h, d, min_bin_width, min_bin_height,
                              min_derivative, yv, lv);
  y[i] = yv;
  ld[i] = lv;
}

template <int K, bool INVERSE>
void launch(const float* x, const float* uw, const float* uh, const float* ud,
            const float* tb, float tb_scalar, const Strides& s,
            long long rows, long long cols, float mbw, float mbh, float md,
            float* y, float* ld, cudaStream_t stream) {
  const int threads = 256;
  const long long n = rows * cols;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  rqs_fwd_kernel<K, INVERSE><<<blocks, threads, 0, stream>>>(
      x, uw, uh, ud, tb, tb_scalar, s, rows, cols, mbw, mbh, md, y, ld);
}

}  // namespace

// C interface for ctypes. `strides` points to 13 int64: x(2), w(3), h(3),
// d(3), tb(2). Returns cudaGetLastError() after the launch; -1 for a bin
// count that has no instantiation.
extern "C" int rqs_fwd_launch(const float* x, const float* uw,
                              const float* uh, const float* ud,
                              const float* tb, float tb_scalar,
                              const long long* strides, long long rows,
                              long long cols, int num_bins, int inverse,
                              float min_bin_width, float min_bin_height,
                              float min_derivative, float* y, float* ld,
                              void* stream) {
  Strides s;
  const long long* p = strides;
  for (int j = 0; j < 2; ++j) s.x[j] = *p++;
  for (int j = 0; j < 3; ++j) s.w[j] = *p++;
  for (int j = 0; j < 3; ++j) s.h[j] = *p++;
  for (int j = 0; j < 3; ++j) s.d[j] = *p++;
  for (int j = 0; j < 2; ++j) s.tb[j] = *p++;
  if (rows * cols == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NF_RQS_CASE(KK)                                                     \
  case KK:                                                                  \
    if (inverse)                                                            \
      launch<KK, true>(x, uw, uh, ud, tb, tb_scalar, s, rows, cols,         \
                       min_bin_width, min_bin_height, min_derivative, y, ld, \
                       st);                                                 \
    else                                                                    \
      launch<KK, false>(x, uw, uh, ud, tb, tb_scalar, s, rows, cols,        \
                        min_bin_width, min_bin_height, min_derivative, y,   \
                        ld, st);                                            \
    break;
  switch (num_bins) {
    NF_RQS_CASE(4)
    NF_RQS_CASE(8)
    NF_RQS_CASE(10)
    default:
      return -1;
  }
#undef NF_RQS_CASE
  return static_cast<int>(cudaGetLastError());
}
