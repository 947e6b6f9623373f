// Per-element reverse-mode adjoint of the unconstrained rational-quadratic
// spline with identity tails: what jax.vjp of
// nf_tpu/ops/splines_pallas.py:_rqs_math (:140-206) computes, written out
// by hand for kernel D (rqs_bwd_autodiff.cu).
//
// Unlike kernel C's analytic transpose (rqs_bwd_math.cuh), this is the
// mechanical adjoint: a forward sweep that keeps every intermediate the
// adjoint reads, then one adjoint statement per forward operation, in
// reverse order. So, as in the JAX package's autodiff kernel:
//
//   * the inverse direction differentiates THROUGH the root formula
//     root = 2c / (-b - sqrt(disc)), not implicitly;
//   * ties split as JAX's max and min do: clip(x, -tb, tb) at a bound, and
//     max(disc, 0) or the softmax's running max at a tie, pass half of the
//     cotangent to each side (_balanced_eq); a where gives the unselected
//     branch 0;
//   * the softplus cotangent is g * exp(v - softplus(v)), the JVP of
//     jnp.logaddexp(v, 0);
//   * the tail bound gets no cotangent.
//
// Each forward expression keeps _rqs_math's operand tree (also the plain
// PyTorch version's, splines_kernel.rqs_plain with split_ties=True). The
// adjoint uses the formulas of PyTorch's autograd for each operation (for
// a / b: g / b and -g * ((a / b) / b); for sqrt: g / (2 sqrt); for 1 / t:
// -g * (1/t)^2) and sums the cotangents a value receives from its uses in
// the order autograd does, the last use first. With -fmad=false every
// operation rounds on its own, so kernel D follows its plain version
// (rqs_vjp_plain) to rounding: the gradients of the inverse pass through
// sums of terms ~100x larger than themselves, where another order would
// move them by more than the 1e-4 the parity checks allow.
#pragma once

#include "rqs_math.cuh"

namespace nf {

// d max(a, b) / da with JAX's tie rule: 1, 1/2 at a tie, else 0
__device__ __forceinline__ float max_share(float a, float b) {
  return a > b ? 1.0f : (a == b ? 0.5f : 0.0f);
}

// d min(a, b) / da with the same rule
__device__ __forceinline__ float min_share(float a, float b) {
  return a < b ? 1.0f : (a == b ? 0.5f : 0.0f);
}

// Forward sweep of one floored softmax and its pinned knots
// (_normalized_sizes, _knots), keeping what the adjoint reads: the running
// maxima, the exps, the total, 1/total and the scale, and the knots (the
// sizes are their differences).
template <int K>
struct KnotsFwd {
  float run_max[K];  // run_max[k] = max(u[0..k])
  float e[K];
  float inv_total, si;
  float cum[K + 1];
};

template <int K>
__device__ __forceinline__ void knots_fwd(const float (&u)[K], float min_size,
                                          float tb, KnotsFwd<K>& f) {
  f.run_max[0] = u[0];
#pragma unroll
  for (int k = 1; k < K; ++k) f.run_max[k] = fmaxf(f.run_max[k - 1], u[k]);
  const float m = f.run_max[K - 1];
  float total = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    f.e[k] = expf(u[k] - m);
    total = (k == 0) ? f.e[k] : total + f.e[k];
  }
  const float c = 1.0f - min_size * K;
  f.inv_total = 1.0f / total;
  f.si = c * f.inv_total;
  const float lo = -tb;
  const float span = tb - lo;
  f.cum[0] = lo;
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < K - 1; ++k) {
    const float size = min_size + f.e[k] * f.si;
    acc = (k == 0) ? size : acc + size;
    f.cum[k + 1] = lo + span * acc;
  }
  f.cum[K] = tb;
}

// Adjoint of knots_fwd and of the two selects that read it: g_c and g_s
// are the cotangents of the selected knot cum[k] and of the selected size
// cum[k+1] - cum[k], sel[k] the bin masks. Writes the logits' cotangents.
template <int K>
__device__ __forceinline__ void knots_adj(const KnotsFwd<K>& f,
                                          const float (&u)[K],
                                          const bool (&sel)[K], float g_c,
                                          float g_s, float min_size, float tb,
                                          float (&g_u)[K]) {
  // the selects, then size_k = cum[k+1] - cum[k]; cum[0] and cum[K] are
  // the tail bound, which gets no cotangent
  float g_cum[K + 1];
#pragma unroll
  for (int k = 0; k <= K; ++k) g_cum[k] = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (sel[k]) {
      g_cum[k] = g_cum[k] + g_c;
      g_cum[k] = g_cum[k] + (-g_s);
      g_cum[k + 1] = g_cum[k + 1] + g_s;
    }
  }
  // cum[k+1] = lo + span * acc_k with acc_k = acc_{k-1} + size_k; the last
  // size enters only through the pinned knot cum[K]
  const float span = tb - (-tb);
  float g_size[K];
  g_size[K - 1] = 0.0f;
  float g_acc = 0.0f;
#pragma unroll
  for (int k = K - 2; k >= 0; --k) {
    g_acc = g_acc + g_cum[k + 1] * span;
    g_size[k] = g_acc;
  }
  // size_k = min_size + e_k * si, si = c * (1 / total), total = sum e_k
  float g_si = 0.0f;
#pragma unroll
  for (int k = K - 2; k >= 0; --k) g_si = g_si + g_size[k] * f.e[k];
  const float c = 1.0f - min_size * K;
  const float g_inv_total = g_si * c;
  const float g_total = (-g_inv_total) * (f.inv_total * f.inv_total);
  // e_k = exp(u_k - m); m collects its cotangents from the last use first
  float g_arg[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    g_arg[k] = (g_size[k] * f.si + g_total) * f.e[k];
  float g_m = 0.0f;
#pragma unroll
  for (int k = K - 1; k >= 0; --k) g_m = g_m + (-g_arg[k]);
  // the running max, last link first: run_max[k] = max(run_max[k-1], u[k])
#pragma unroll
  for (int k = 0; k < K; ++k) g_u[k] = g_arg[k];
#pragma unroll
  for (int k = K - 1; k >= 1; --k) {
    const float a = f.run_max[k - 1];
    g_u[k] = g_u[k] + g_m * max_share(u[k], a);
    g_m = g_m * max_share(a, u[k]);
  }
  g_u[0] = g_u[0] + g_m;
}

// The cotangents that dnum = delta*delta * (dp1*t*t + 2*delta*t1mt +
// d*(1-t)*(1-t)) passes to its inputs (t is theta, or the root in the
// inverse direction), for its cotangent g, one per use.
struct DnumAdj {
  float t_omt3, t_omt2, t_r2, t_r1;  // to t, last use first
  float d_r6, dp1_r1, t1mt_r4, delta_r3, delta_dd;
};

__device__ __forceinline__ DnumAdj dnum_adj(float g, float delta, float dp1,
                                            float d, float t, float t1mt) {
  DnumAdj o;
  const float dd = delta * delta;
  const float r1 = dp1 * t;
  const float r2 = r1 * t;
  const float r3 = 2.0f * delta;
  const float r4 = r3 * t1mt;
  const float r5 = r2 + r4;
  const float omt = 1.0f - t;
  const float r6 = d * omt;
  const float r7 = r6 * omt;
  const float r8 = r5 + r7;
  const float g_dd = g * r8;
  const float g_r8 = g * dd;
  // r8 = r5 + r7; r7 = r6 * (1 - t); r6 = d * (1 - t)
  const float g_r6 = g_r8 * omt;
  o.t_omt3 = -(g_r8 * r6);
  o.d_r6 = g_r6 * omt;
  o.t_omt2 = -(g_r6 * d);
  // r5 = r2 + r4; r4 = (2 * delta) * t1mt
  o.t1mt_r4 = g_r8 * r3;
  o.delta_r3 = (g_r8 * t1mt) * 2.0f;
  // r2 = (dp1 * t) * t
  const float g_r1 = g_r8 * t;
  o.t_r2 = g_r8 * r1;
  o.dp1_r1 = g_r1 * t;
  o.t_r1 = g_r1 * dp1;
  // dd = delta * delta: two uses of delta
  o.delta_dd = g_dd * delta;
  return o;
}

// One element: x and its tail bound tb, K width and K height logits, K+1
// tail-padded derivative logits, and the cotangents cty, ctl of
// (y, log|det|) -> gx and the logits' cotangents.
template <int K, bool INVERSE>
__device__ __forceinline__ void rqs_vjp_element(
    float x, float tb, const float (&uw)[K], const float (&uh)[K],
    const float (&ud)[K + 1], float cty, float ctl, float min_bin_width,
    float min_bin_height, float min_derivative, float& gx, float (&gw)[K],
    float (&gh)[K], float (&gd)[K + 1]) {
  // ---- forward sweep ----
  KnotsFwd<K> fw, fh;
  knots_fwd<K>(uw, min_bin_width, tb, fw);
  knots_fwd<K>(uh, min_bin_height, tb, fh);

  const float mx = fmaxf(x, -tb);
  const float xin = fminf(mx, tb);
  bool step[K + 1];
  step[0] = true;
#pragma unroll
  for (int k = 1; k < K; ++k)
    step[k] = xin >= (INVERSE ? fh.cum[k] : fw.cum[k]);
  step[K] = false;
  bool sel[K];
#pragma unroll
  for (int k = 0; k < K; ++k) sel[k] = step[k] && !step[k + 1];

  float in_cw = 0.0f, in_w = 0.0f, in_ch = 0.0f, in_h = 0.0f;
  float sd0 = 0.0f, sd1 = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (sel[k]) {
      in_cw += fw.cum[k];
      in_w += fw.cum[k + 1] - fw.cum[k];
      in_ch += fh.cum[k];
      in_h += fh.cum[k + 1] - fh.cum[k];
      sd0 += ud[k];
      sd1 += ud[k + 1];
    }
  }
  const float sp0 = softplus(sd0);
  const float sp1 = softplus(sd1);
  const float in_d = min_derivative + sp0;
  const float in_dp1 = min_derivative + sp1;
  const float in_delta = in_h / in_w;
  const float d_sum = in_d + in_dp1 - 2.0f * in_delta;

  const bool inside = (x >= -tb) && (x <= tb);
  // where(inside, y, x) and where(inside, ld, 0)
  const float gy = inside ? cty : 0.0f;
  const float gl = inside ? ctl : 0.0f;

  // cotangents of the shared values, and of in_d, in_dp1, in_delta, in_h
  // and in_w from each of their uses in the map
  float g_xin, g_in_cw, g_in_ch, g_d_sum;
  float g_in_d, g_in_dp1, g_delta_map, g_h_map, g_w_map;

  if (INVERSE) {
    // forward sweep of the inverse map
    const float dy = xin - in_ch;
    const float a2 = in_delta - in_d;
    const float a = dy * d_sum + in_h * a2;
    const float b = in_h * in_d - dy * d_sum;
    const float nd = -in_delta;
    const float c = nd * dy;
    const float fa = 4.0f * a;
    const float qd = b * b - fa * c;
    const float disc = fmaxf(qd, 0.0f);
    const float c2 = 2.0f * c;
    const float sq = sqrtf(disc);
    const float s = -b - sq;
    const float root = c2 / s;
    const float omr = 1.0f - root;
    const float t1mt = root * omr;
    const float denom = in_delta + d_sum * t1mt;
    const float dnum =
        in_delta * in_delta *
        (in_dp1 * root * root + 2.0f * in_delta * t1mt +
         in_d * (1.0f - root) * (1.0f - root));

    // ---- adjoint, last operation first ----
    // ld = -(log(dnum) - 2 log(denom))
    const float g_inner = -gl;
    const float g_denom = ((-g_inner) * 2.0f) / denom;
    const float g_dnum = g_inner / dnum;
    const DnumAdj dn = dnum_adj(g_dnum, in_delta, in_dp1, in_d, root, t1mt);
    // denom = in_delta + d_sum * t1mt
    const float delta_denom = g_denom;
    const float dsum_p4 = g_denom * t1mt;
    const float t1mt_p4 = g_denom * d_sum;
    const float g_t1mt = dn.t1mt_r4 + t1mt_p4;
    // t1mt = root * (1 - root); y = root * in_w + in_cw
    const float root_t1mt = g_t1mt * omr;
    const float root_omr = -(g_t1mt * root);
    g_in_cw = gy;
    const float root_yw = gy * in_w;
    const float w_yw = gy * root;
    const float g_root = dn.t_omt3 + dn.t_omt2 + dn.t_r2 + dn.t_r1 +
                         root_t1mt + root_omr + root_yw;
    // root = c2 / s, s = -b - sqrt(disc)
    const float g_c2 = g_root / s;
    const float g_s = (-g_root) * ((c2 / s) / s);
    const float g_sq = -g_s;
    const float g_disc = g_sq / (2.0f * sq);
    const float b_nb = -g_s;
    const float c_c2 = g_c2 * 2.0f;
    // disc = max(qd, 0); qd = b*b - (4a)*c
    const float g_qd = g_disc * max_share(qd, 0.0f);
    const float g_fac = -g_qd;
    const float g_a = (g_fac * c) * 4.0f;
    const float c_fac = g_fac * fa;
    const float b_bb = g_qd * b;
    const float g_c = c_c2 + c_fac;
    // c = (-in_delta) * dy
    const float delta_nd = -(g_c * dy);
    const float dy_c = g_c * nd;
    const float g_b = b_nb + b_bb + b_bb;
    // b = in_h * in_d - dy * d_sum
    const float dy_b2 = (-g_b) * d_sum;
    const float dsum_b2 = (-g_b) * dy;
    const float h_b1 = g_b * in_d;
    const float d_b1 = g_b * in_h;
    // a = dy * d_sum + in_h * (in_delta - in_d)
    const float h_a3 = g_a * a2;
    const float g_a2 = g_a * in_h;
    const float dy_a1 = g_a * d_sum;
    const float dsum_a1 = g_a * dy;
    const float g_dy = dy_c + dy_b2 + dy_a1;
    // dy = xin - in_ch
    g_xin = g_dy;
    g_in_ch = -g_dy;
    g_d_sum = dsum_p4 + dsum_b2 + dsum_a1;
    // uses of in_d: d_sum, a2, b1, r6 (last first; d_sum's comes below)
    g_in_d = dn.d_r6 + d_b1 + (-g_a2);
    g_in_dp1 = dn.dp1_r1;
    // uses of in_delta: d_sum, a2, nd, denom, dd (twice), r3
    g_delta_map = dn.delta_r3 + dn.delta_dd + dn.delta_dd + delta_denom +
                  delta_nd + g_a2;
    // uses of in_h: the division, a3, b1; of in_w: the division, yw
    g_h_map = h_b1 + h_a3;
    g_w_map = w_yw;
  } else {
    // forward sweep of the forward map
    const float n1 = xin - in_cw;
    const float theta = n1 / in_w;
    const float omt = 1.0f - theta;
    const float t1mt = theta * omt;
    const float p1 = in_delta * theta;
    const float s1 = p1 * theta + in_d * t1mt;
    const float numer = in_h * s1;
    const float denom = in_delta + d_sum * t1mt;
    const float q = numer / denom;
    const float dnum =
        in_delta * in_delta *
        (in_dp1 * theta * theta + 2.0f * in_delta * t1mt +
         in_d * (1.0f - theta) * (1.0f - theta));

    // ---- adjoint, last operation first ----
    // ld = log(dnum) - 2 log(denom)
    const float denom_l2 = ((-gl) * 2.0f) / denom;
    const float g_dnum = gl / dnum;
    const DnumAdj dn = dnum_adj(g_dnum, in_delta, in_dp1, in_d, theta, t1mt);
    // y = in_ch + numer / denom
    g_in_ch = gy;
    const float g_numer = gy / denom;
    const float denom_q = (-gy) * ((numer / denom) / denom);
    const float g_denom = denom_l2 + denom_q;
    (void)q;
    // denom = in_delta + d_sum * t1mt
    const float delta_denom = g_denom;
    g_d_sum = g_denom * t1mt;
    const float t1mt_p4 = g_denom * d_sum;
    // numer = in_h * ((in_delta * theta) * theta + in_d * t1mt)
    const float h_numer = g_numer * s1;
    const float g_s1 = g_numer * in_h;
    const float d_p3 = g_s1 * t1mt;
    const float t1mt_p3 = g_s1 * in_d;
    const float g_p1 = g_s1 * theta;
    const float theta_p2 = g_s1 * p1;
    const float delta_p1 = g_p1 * theta;
    const float theta_p1 = g_p1 * in_delta;
    const float g_t1mt = dn.t1mt_r4 + t1mt_p4 + t1mt_p3;
    // t1mt = theta * (1 - theta)
    const float theta_t1mt = g_t1mt * omt;
    const float theta_omt = -(g_t1mt * theta);
    const float g_theta = dn.t_omt3 + dn.t_omt2 + dn.t_r2 + dn.t_r1 +
                          theta_p2 + theta_p1 + theta_t1mt + theta_omt;
    // theta = (xin - in_cw) / in_w
    const float g_n1 = g_theta / in_w;
    const float w_theta = (-g_theta) * ((n1 / in_w) / in_w);
    g_xin = g_n1;
    g_in_cw = -g_n1;
    // uses of in_d: d_sum, p3, r6 (last first; d_sum's comes below)
    g_in_d = dn.d_r6 + d_p3;
    g_in_dp1 = dn.dp1_r1;
    // uses of in_delta: d_sum, p1, denom, dd (twice), r3
    g_delta_map =
        dn.delta_r3 + dn.delta_dd + dn.delta_dd + delta_denom + delta_p1;
    // uses of in_h: the division, numer; of in_w: the division, theta
    g_h_map = h_numer;
    g_w_map = w_theta;
  }

  // d_sum = (in_d + in_dp1) - 2 * in_delta, its first use of each
  g_in_d = g_in_d + g_d_sum;
  g_in_dp1 = g_in_dp1 + g_d_sum;
  const float g_in_delta = g_delta_map + (-g_d_sum) * 2.0f;
  // in_delta = in_h / in_w, the first use of both
  const float g_in_h = g_h_map + g_in_delta / in_w;
  const float g_in_w = g_w_map + (-g_in_delta) * ((in_h / in_w) / in_w);
  // in_d = min_derivative + softplus(sd0): the JVP of logaddexp(v, 0)
  const float g_sd0 = g_in_d * expf(sd0 - sp0);
  const float g_sd1 = g_in_dp1 * expf(sd1 - sp1);
#pragma unroll
  for (int k = 0; k <= K; ++k) gd[k] = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (sel[k]) {
      gd[k] = gd[k] + g_sd0;
      gd[k + 1] = gd[k + 1] + g_sd1;
    }
  }
  knots_adj<K>(fw, uw, sel, g_in_cw, g_in_w, min_bin_width, tb, gw);
  knots_adj<K>(fh, uh, sel, g_in_ch, g_in_h, min_bin_height, tb, gh);
  // xin = min(max(x, -tb), tb); x also reaches the output through the
  // identity tail of where(inside, y, x)
  const float g_mx = g_xin * min_share(mx, tb);
  gx = (inside ? 0.0f : cty) + g_mx * max_share(x, -tb);
}

}  // namespace nf
