// Per-element unconstrained rational-quadratic spline with identity tails,
// shared by kernel A (rqs_fwd.cu) and kernel B (head_rqs_fwd.cu).
//
// A line-by-line reading of nf_tpu/ops/splines_pallas.py:_rqs_math
// (:140-206) for ONE element held in registers: the TPU version works on
// (rows, 128) planes, here each thread owns one element and the K-long bin
// loops are unrolled at compile time (K is a template parameter).
//
//   softmax with the min-size floor -> knots pinned at +-tb -> bin masks
//   from the bin-search step functions (mask_k = s_k - s_{k+1}) -> masked
//   selects -> softplus on the two selected derivatives -> RQ map (or the
//   quadratic root for the inverse) -> log|det| -> identity outside
//   [-tb, tb].
//
// Built without fast-math and with -fmad=false (ops/_build.py): expf, logf,
// log1pf and sqrtf are the accurate ones and every operation rounds on its
// own, so the kernels agree with the plain PyTorch version to rounding.
//
// Storage types. Kernels A, C and D are instantiated for float and for
// __nv_bfloat16 operands, and B and E have bfloat16 kernels of their own
// (head_mma_bf16.cuh: the head products on the tensor cores); the JAX
// package's Pallas kernels take any dtype, and build_image_nsf and the
// spline layers built with dtype=bfloat16 run them in bfloat16. Whatever
// the storage, the spline's math is this file's float32: a bfloat16
// operand is widened on load (to_f32, exact) and a result rounded to
// nearest even on store (from_f32, as torch's .to(torch.bfloat16)), so the
// reads and writes move 2 bytes per element and the values are the
// float32 math's on the widened inputs, rounded once.
#pragma once

#include <cuda_bf16.h>

namespace nf {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <class T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Four consecutive float32 (shared memory, aligned to 16 bytes) as one
// 16-byte load; the float32 kernels B and E read their staged h_t through
// it.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// jax.nn.softplus: logaddexp(v, 0) = max(v, 0) + log1p(exp(-|v|))
__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
}

// min_size + (1 - min_size * K) * softmax(u), as _normalized_sizes
template <int K>
__device__ __forceinline__ void normalized_sizes(const float (&u)[K],
                                                 float min_size,
                                                 float (&sizes)[K]) {
  float m = u[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m = fmaxf(m, u[k]);
  float e[K];
  float total = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    e[k] = expf(u[k] - m);
    total = (k == 0) ? e[k] : total + e[k];
  }
  const float c = 1.0f - min_size * K;
  const float si = c * (1.0f / total);
#pragma unroll
  for (int k = 0; k < K; ++k) sizes[k] = min_size + e[k] * si;
}

// cumulative knots with exact endpoint pinning (_knots): cum[0] = -tb,
// cum[K] = tb, sizes[k] = cum[k+1] - cum[k]
template <int K>
__device__ __forceinline__ void knots(float (&sizes)[K], float tb,
                                      float (&cum)[K + 1]) {
  const float lo = -tb;
  const float span = tb - lo;
  cum[0] = lo;
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < K - 1; ++k) {
    acc = (k == 0) ? sizes[0] : acc + sizes[k];
    cum[k + 1] = lo + span * acc;
  }
  cum[K] = tb;
#pragma unroll
  for (int k = 0; k < K; ++k) sizes[k] = cum[k + 1] - cum[k];
}

// The RQ map of one element once its bin is chosen: x, its tail bound tb
// and xin = x clipped into [-tb, tb]; the bin's left knots in_cw, in_ch,
// its width in_w and height in_h, and the derivatives at its two ends,
// in_d and in_dp1 (min_derivative + softplus of the logits) -> (y,
// log|det|), the identity outside [-tb, tb].
template <bool INVERSE>
__device__ __forceinline__ void rqs_map(float x, float tb, float xin,
                                        float in_cw, float in_w, float in_ch,
                                        float in_h, float in_d, float in_dp1,
                                        float& y, float& ld) {
  const float in_delta = in_h / in_w;
  const float d_sum = in_d + in_dp1 - 2.0f * in_delta;

  float out, l;
  if (INVERSE) {
    const float dy = xin - in_ch;
    const float a = dy * d_sum + in_h * (in_delta - in_d);
    const float b = in_h * in_d - dy * d_sum;
    const float c = -in_delta * dy;
    const float disc = fmaxf(b * b - 4.0f * a * c, 0.0f);
    const float root = (2.0f * c) / (-b - sqrtf(disc));
    out = root * in_w + in_cw;
    const float t1mt = root * (1.0f - root);
    const float denom = in_delta + d_sum * t1mt;
    const float dnum =
        in_delta * in_delta *
        (in_dp1 * root * root + 2.0f * in_delta * t1mt +
         in_d * (1.0f - root) * (1.0f - root));
    l = -(logf(dnum) - 2.0f * logf(denom));
  } else {
    const float theta = (xin - in_cw) / in_w;
    const float t1mt = theta * (1.0f - theta);
    const float numer = in_h * (in_delta * theta * theta + in_d * t1mt);
    const float denom = in_delta + d_sum * t1mt;
    out = in_ch + numer / denom;
    const float dnum =
        in_delta * in_delta *
        (in_dp1 * theta * theta + 2.0f * in_delta * t1mt +
         in_d * (1.0f - theta) * (1.0f - theta));
    l = logf(dnum) - 2.0f * logf(denom);
  }
  const bool inside = (x >= -tb) && (x <= tb);
  y = inside ? out : x;
  ld = inside ? l : 0.0f;
}

// One element: x and its tail bound tb, K width and K height logits, K+1
// tail-padded derivative logits -> (y, log|det|).
template <int K, bool INVERSE>
__device__ __forceinline__ void rqs_element(float x, float tb,
                                            const float (&uw)[K],
                                            const float (&uh)[K],
                                            const float (&ud)[K + 1],
                                            float min_bin_width,
                                            float min_bin_height,
                                            float min_derivative, float& y,
                                            float& ld) {
  float widths[K], heights[K], cumw[K + 1], cumh[K + 1];
  normalized_sizes<K>(uw, min_bin_width, widths);
  knots<K>(widths, tb, cumw);
  normalized_sizes<K>(uh, min_bin_height, heights);
  knots<K>(heights, tb, cumh);

  const float xin = fminf(fmaxf(x, -tb), tb);
  // step s_k = [xin >= cref_k] for interior knots, s_0 = 1, s_K = 0;
  // bin k is selected where s_k - s_{k+1} = 1
  bool step[K + 1];
  step[0] = true;
#pragma unroll
  for (int k = 1; k < K; ++k) step[k] = xin >= (INVERSE ? cumh[k] : cumw[k]);
  step[K] = false;

  float in_cw = 0.0f, in_w = 0.0f, in_ch = 0.0f, in_h = 0.0f;
  float d0_raw = 0.0f, d1_raw = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (step[k] && !step[k + 1]) {
      in_cw += cumw[k];
      in_w += widths[k];
      in_ch += cumh[k];
      in_h += heights[k];
      d0_raw += ud[k];
      d1_raw += ud[k + 1];
    }
  }
  rqs_map<INVERSE>(x, tb, xin, in_cw, in_w, in_ch, in_h,
                   min_derivative + softplus(d0_raw),
                   min_derivative + softplus(d1_raw), y, ld);
}

}  // namespace nf
