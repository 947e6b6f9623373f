// Kernel D: the autodiff backward of the unconstrained RQ spline (kernel
// A), forward or inverse direction.
//
// Replaces nf_tpu/ops/splines_pallas.py:_rqs_bwd_kernel (:220), the
// in-kernel jax.vjp of _rqs_math that _pallas_bwd_impl (:474) traces under
// set_pallas_bwd_kernel("autodiff"). Same operands and outputs as kernel C
// (rqs_bwd.cu), and the same launch (rqs_bwd_kernel.cuh); the per-element
// math is the mechanical reverse-mode adjoint of rqs_vjp_math.cuh, which
// differentiates the inverse through the sqrt root formula and splits
// ties at the clip and at max(disc, 0) as JAX does, where kernel C's
// analytic transpose passes the full slope.
//
// Design. The forward sweep keeps every intermediate the adjoint reads
// (running maxima, exps and totals of both softmaxes, both knot vectors,
// the selected values, the root's a, b, c, disc, sqrt(disc)), so the live
// set is about twice kernel C's: (6K + ~40) floats per thread at K bins.
// Registers, not bandwidth, decide how many threads an SM holds, and at
// K = 10 ptxas may spill (chip_smoke.py's build phase prints it).
//
// Bound on the H100: the bytes are kernel C's, per element x, cty, ctl and
// any parameter planes that are not stride-0 broadcasts read, gx and 3K+1
// planes written; the operations are ~2.5x the forward's
// (splines_kernel.rqs_vjp_ops_per_element), still below the f32 ridge of
// ~20 flop/byte on full planes, so the stores and loads bound it.
//
// Where the time went at the circular NSF's reverse-KLD shape (x (2,
// 16384), K = 10; variants of the earlier one-thread-per-element launch):
// the launch with its loads and stores alone took ~0.77x of the whole,
// the math without the stores ~0.97x. One wave of one element per thread
// left each thread's chain to run after its 34 loads arrived; two or four
// elements per thread lengthened that chain (1.2x and 1.8x), and block
// sizes of 64 to 256 threads moved it by about 1%. The launch is now
// rqs_bwd_kernel.cuh's (kernel C's), with a second form of D's own: at K 8
// and 10 the adjoint's ~106-128 registers leave 4 blocks of 4 warps an
// SM, too few to hide each other's loads, so where one wave does not hold
// every block the launch takes the ring (rqs_ring.cuh, instantiated in
// this library alone), each warp's next tile of operands arriving in
// shared memory while it runs this one's adjoint, with registers still
// holding one element's operands (chip_smoke.py's build phase prints
// registers and spills, none). Its math is not redesigned.
#include "rqs_ring.cuh"
#include "rqs_vjp_math.cuh"

struct AutodiffMath {
  template <int K, bool INVERSE>
  __device__ static void apply(float x, float tb, const float (&uw)[K],
                               const float (&uh)[K], const float (&ud)[K + 1],
                               float cty, float ctl, float mbw, float mbh,
                               float md, float& gx, float (&gw)[K],
                               float (&gh)[K], float (&gd)[K + 1]) {
    nf::rqs_vjp_element<K, INVERSE>(x, tb, uw, uh, ud, cty, ctl, mbw, mbh,
                                    md, gx, gw, gh, gd);
  }
};

// C interface for ctypes: the arguments of rqs_bwd_launch (rqs_bwd.cu),
// and `routes` (splines_kernel.ring_routes) before the stream: bit o
// (rqs_per_element.cuh's operand order) for an operand whose tiles come
// into the ring by 16-byte copies. See nf::rqs_bwd_dispatch.
extern "C" int rqs_bwd_autodiff_launch(
    const float* x, const float* uw, const float* uh, const float* ud,
    const float* tb, const float* cty, const float* ctl, float tb_scalar,
    const long long* strides, long long rows, long long cols, int num_bins,
    int inverse, float min_bin_width, float min_bin_height,
    float min_derivative, float* gx, float* gw, float* gh, float* gd,
    int offsets32, unsigned routes, void* stream) {
  return nf::rqs_bwd_dispatch<AutodiffMath, nf::ring::RingLaunch>(
      x, uw, uh, ud, tb, cty, ctl, tb_scalar, strides, rows, cols, num_bins,
      inverse, min_bin_width, min_bin_height, min_derivative, gx, gw, gh, gd,
      offsets32, routes, stream);
}

// The same for bfloat16 operands, cotangents and outputs: the float32
// adjoint (its tie rule at x = +-tail_bound included) on the widened
// inputs, each gradient rounded once on store.
extern "C" int rqs_bwd_autodiff_launch_bf16(
    const __nv_bfloat16* x, const __nv_bfloat16* uw, const __nv_bfloat16* uh,
    const __nv_bfloat16* ud, const __nv_bfloat16* tb,
    const __nv_bfloat16* cty, const __nv_bfloat16* ctl, float tb_scalar,
    const long long* strides, long long rows, long long cols, int num_bins,
    int inverse, float min_bin_width, float min_bin_height,
    float min_derivative, __nv_bfloat16* gx, __nv_bfloat16* gw,
    __nv_bfloat16* gh, __nv_bfloat16* gd, int offsets32, unsigned routes,
    void* stream) {
  return nf::rqs_bwd_dispatch<AutodiffMath, nf::ring::RingLaunch>(
      x, uw, uh, ud, tb, cty, ctl, tb_scalar, strides, rows, cols, num_bins,
      inverse, min_bin_width, min_bin_height, min_derivative, gx, gw, gh, gd,
      offsets32, routes, stream);
}
