// Per-element analytic backward of the unconstrained rational-quadratic
// spline with identity tails, shared by kernel C (rqs_bwd.cu, both of its
// paths) and kernel E (head_rqs_bwd.cu).
//
// A line-by-line reading of nf_tpu/ops/splines_pallas.py:_rqs_bwd_math
// (:241-396) for ONE element held in registers, with the K-long bin loops
// unrolled at compile time:
//
//   recompute the forward (floored softmaxes, pinned knots, bin masks from
//   the step functions, the selected bin) -> partials of u = numer/denom
//   and of the log-det with respect to (theta, delta, d0, d1, hh), using
//   du/dtheta = wd * J -> in the inverse direction the root is
//   differentiated implicitly through the forward equation (theta_p =
//   -u_p / u_theta), never through sqrt -> derivative cotangents through
//   the softplus (sigmoid) -> knot cotangents through the pinned cumsum,
//   taken from the step planes, with the last bin's size pinned away ->
//   softmax transpose -> nothing for the parameters outside [-tb, tb],
//   where gx = cty.
//
// Every expression keeps the operand order of the Python version (and of
// the plain PyTorch port, splines_kernel.rqs_bwd_plain); built with
// -fmad=false, each operation rounds on its own.
#pragma once

#include "rqs_math.cuh"

namespace nf {

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// _normalized_sizes with the terms its transpose reuses: sizes, the
// softmax sm = exp(u - max) / total, and c = 1 - min_size * K
template <int K>
__device__ __forceinline__ void softmax_terms(const float (&u)[K],
                                              float min_size,
                                              float (&sizes)[K],
                                              float (&sm)[K], float& c) {
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
  c = 1.0f - min_size * K;
  const float inv_total = 1.0f / total;
  const float si = c * inv_total;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    sizes[k] = min_size + e[k] * si;
    sm[k] = e[k] * inv_total;
  }
}

// logits_grad of _rqs_bwd_math: cotangents of the selected knot (g_cum)
// and bin size (g_size) -> cotangents of the K logits
template <int K>
__device__ __forceinline__ void logits_grad(float g_cum, float g_size,
                                            const float (&sm)[K], float c,
                                            float span,
                                            const float (&steps)[K + 1],
                                            const float (&maskf)[K],
                                            bool inside, float (&out)[K]) {
  const float a = (span * c) * g_cum;
  const float b2 = (span * c) * g_size;
  const float bm = b2 * maskf[K - 1];
  float gsm[K];
#pragma unroll
  for (int j = 0; j < K - 1; ++j)
    gsm[j] = a * steps[j + 1] + b2 * maskf[j] - bm;
  gsm[K - 1] = 0.0f;  // size_{K-1} is pinned away
  float S = sm[0] * gsm[0];
#pragma unroll
  for (int j = 1; j < K - 1; ++j) S = S + sm[j] * gsm[j];
#pragma unroll
  for (int j = 0; j < K; ++j) out[j] = inside ? sm[j] * (gsm[j] - S) : 0.0f;
}

// The middle of _rqs_bwd_math for one element whose bin is chosen: its
// clipped input xin, the bin's left knots cw, ch, width wd, height hh and
// end derivatives d0, d1 (min_derivative + softplus of the logits), and
// the cotangents (cty, ctl) of (y, log|det|) -> the cotangents of xin and
// of the six selected values. Kernel C's shared-parameter path
// (rqs_bwd.cu) sums the last six per (column, bin); rqs_bwd_element
// scatters them to the logits of its own element.
template <bool INVERSE>
__device__ __forceinline__ void rqs_bwd_map(float xin, float cw, float wd,
                                            float ch, float hh, float d0,
                                            float d1, float cty, float ctl,
                                            float& g_x_in, float& g_cw,
                                            float& g_wd, float& g_ch,
                                            float& g_hh, float& g_d0,
                                            float& g_d1) {
  const float delta = hh / wd;
  const float s = d0 + d1 - 2.0f * delta;

  float theta, u = 0.0f;
  if (INVERSE) {
    const float dy = xin - ch;
    const float a = dy * s + hh * (delta - d0);
    const float b = hh * d0 - dy * s;
    const float c2 = -delta * dy;
    const float disc = fmaxf(b * b - 4.0f * a * c2, 0.0f);
    theta = (2.0f * c2) / (-b - sqrtf(disc));
    u = dy;  // = numer/denom at the root, by the defining equation
  } else {
    theta = (xin - cw) / wd;
  }

  const float t = theta * (1.0f - theta);
  const float om = 1.0f - theta;
  const float dtdth = 1.0f - 2.0f * theta;
  const float denom = delta + s * t;
  const float inv_denom = 1.0f / denom;
  if (!INVERSE) u = hh * (delta * theta * theta + d0 * t) * inv_denom;
  const float dnum =
      delta * delta * (d1 * theta * theta + 2.0f * delta * t + d0 * om * om);
  const float inv_dnum = 1.0f / dnum;
  const float J = dnum * inv_denom * inv_denom;

  const float u_th = wd * J;
  const float u_delta = (hh * theta * theta - u * (1.0f - 2.0f * t)) * inv_denom;
  const float u_d0 = t * (hh - u) * inv_denom;
  const float u_d1 = -u * t * inv_denom;
  const float u_hh = u / hh;
  const float denom_th = s * dtdth;
  const float dnum_th = delta * delta *
                        (2.0f * d1 * theta + 2.0f * delta * dtdth -
                         2.0f * d0 * om);
  const float ld_th = dnum_th * inv_dnum - 2.0f * denom_th * inv_denom;
  const float ld_delta = 2.0f / delta + 2.0f * delta * delta * t * inv_dnum -
                         2.0f * (1.0f - 2.0f * t) * inv_denom;
  const float ld_d0 = delta * delta * om * om * inv_dnum - 2.0f * t * inv_denom;
  const float ld_d1 =
      delta * delta * theta * theta * inv_dnum - 2.0f * t * inv_denom;

  float g_delta;
  if (INVERSE) {
    const float A = cty * wd - ctl * ld_th;
    const float inv_uth = 1.0f / u_th;
    g_x_in = A * inv_uth;
    g_delta = -A * u_delta * inv_uth - ctl * ld_delta;
    g_d0 = -A * u_d0 * inv_uth - ctl * ld_d0;
    g_d1 = -A * u_d1 * inv_uth - ctl * ld_d1;
    g_hh = -A * u_hh * inv_uth + g_delta / wd;
    g_ch = -g_x_in;
    g_cw = cty;
    g_wd = cty * theta - g_delta * delta / wd;
  } else {
    const float g_th = cty * u_th + ctl * ld_th;
    g_delta = cty * u_delta + ctl * ld_delta;
    g_d0 = cty * u_d0 + ctl * ld_d0;
    g_d1 = cty * u_d1 + ctl * ld_d1;
    g_hh = cty * u_hh + g_delta / wd;
    g_wd = -(g_th * theta + g_delta * delta) / wd;
    g_x_in = g_th / wd;
    g_cw = -g_x_in;
    g_ch = cty;
  }
}

// One element: the operands of rqs_element and the cotangents (cty, ctl)
// of (y, log|det|) -> gx and the K, K and K+1 logit cotangents.
template <int K, bool INVERSE>
__device__ __forceinline__ void rqs_bwd_element(
    float x, float tb, const float (&uw)[K], const float (&uh)[K],
    const float (&ud)[K + 1], float cty, float ctl, float min_bin_width,
    float min_bin_height, float min_derivative, float& gx, float (&gw)[K],
    float (&gh)[K], float (&gd)[K + 1]) {
  float widths[K], heights[K], sw[K], sh[K], cumw[K + 1], cumh[K + 1];
  float c_w, c_h;
  softmax_terms<K>(uw, min_bin_width, widths, sw, c_w);
  knots<K>(widths, tb, cumw);
  softmax_terms<K>(uh, min_bin_height, heights, sh, c_h);
  knots<K>(heights, tb, cumh);

  const float xin = fminf(fmaxf(x, -tb), tb);
  bool step[K + 1];
  step[0] = true;
#pragma unroll
  for (int k = 1; k < K; ++k) step[k] = xin >= (INVERSE ? cumh[k] : cumw[k]);
  step[K] = false;
  bool mask[K];
  float steps[K + 1], maskf[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    mask[k] = step[k] && !step[k + 1];
    maskf[k] = mask[k] ? 1.0f : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < K + 1; ++k) steps[k] = step[k] ? 1.0f : 0.0f;

  float cw = 0.0f, wd = 0.0f, ch = 0.0f, hh = 0.0f;
  float draw0 = 0.0f, draw1 = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (mask[k]) {
      cw += cumw[k];
      wd += widths[k];
      ch += cumh[k];
      hh += heights[k];
      draw0 += ud[k];
      draw1 += ud[k + 1];
    }
  }
  const float d0 = min_derivative + softplus(draw0);
  const float d1 = min_derivative + softplus(draw1);
  const float sig0 = sigmoid(draw0);
  const float sig1 = sigmoid(draw1);
  float g_x_in, g_cw, g_wd, g_ch, g_hh, g_d0, g_d1;
  rqs_bwd_map<INVERSE>(xin, cw, wd, ch, hh, d0, d1, cty, ctl, g_x_in, g_cw,
                       g_wd, g_ch, g_hh, g_d0, g_d1);

  const bool inside = (x >= -tb) && (x <= tb);
  const float gsp0 = g_d0 * sig0;
  const float gsp1 = g_d1 * sig1;
  gd[0] = inside ? (mask[0] ? gsp0 : 0.0f) : 0.0f;
#pragma unroll
  for (int k = 1; k < K; ++k) {
    const float v = (mask[k] ? gsp0 : 0.0f) + (mask[k - 1] ? gsp1 : 0.0f);
    gd[k] = inside ? v : 0.0f;
  }
  gd[K] = inside ? (mask[K - 1] ? gsp1 : 0.0f) : 0.0f;

  const float span = 2.0f * tb;
  logits_grad<K>(g_cw, g_wd, sw, c_w, span, steps, maskf, inside, gw);
  logits_grad<K>(g_ch, g_hh, sh, c_h, span, steps, maskf, inside, gh);
  gx = inside ? g_x_in : cty;
}

}  // namespace nf
