// Kernel A: unconstrained RQ spline with identity tails, forward or inverse.
//
// Replaces nf_tpu/ops/splines_pallas.py:_rqs_kernel (launcher _pallas_impl,
// :450). Same function: per element x with tail bound tb, K width logits,
// K height logits and K+1 tail-padded derivative logits -> (y, log|det|).
//
// Elements form a (rows, cols) grid and every operand is addressed through
// its own strides, so the three callers run without materialising
// anything:
//   * bin-minor parameters (rows, cols, K): bin stride 1;
//   * bin-major planes (K, rows, cols): bin stride rows*cols;
//   * the unconditional CDF's per-feature parameters broadcast over the
//     batch with `.expand`: row stride 0.
// The ragged edge is masked in the kernel (no padding, unlike the TPU's
// (32, 128) blocks). A null tb pointer means the scalar tb_scalar.
//
// Bound on the H100: per element ~30 parameter loads and ~250 flops of f32
// math. With full parameter planes (3K+3 reads and 2 writes per element) it
// is memory bound; with the CDF's stride-0 parameters it moves x, y and ld
// only (12 bytes per element): at B = 65536 under a microsecond of HBM
// time, and the operations take a few hundred nanoseconds, so there the
// launch itself and the latency of one element's chain dominate.
//
// What holds the per-element path (PERF.md, section 6): the loads. Its
// time is the launch floor plus the reads of 3K+3 planes at the memory's
// pace; timed without the chain it kept 81-93% of its time, without the
// stores 98-100%, so the chain mostly hides behind other warps' loads.
//
// Design: two paths, both kernel A.
//   * Per element (any strides): rqs_per_element.cuh's schedule. Each
//     warp takes a tile of 32 consecutive elements, a lane's row and
//     column from one 32-bit division (no 64-bit division or offsets where
//     the call fits 32 bits), loads each lane's 3K+3 operands into
//     registers, runs rqs_math.cuh's rqs_element, as before, and stores y
//     and ld (a warp's stores one run of 32 elements each). A keeps 9-16
//     blocks of 4 warps an SM, enough that warps hide each other's loads;
//     a ring of shared-memory stages (rqs_ring.cuh, kernel D's) was timed
//     for A at every shape of chip_smoke.py's PER_ELEMENT_BARS and was
//     slower (its stages cost occupancy and its reads a pass through
//     shared memory).
//   * Shared parameters: when w, h and d have row stride 0, tb is a float
//     or has row stride 0 too (the knots depend on it), and there are at
//     most kMaxSharedCols columns (the CDF's call), every element of a
//     column has the same knots. Each block first computes, once per
//     column and into shared memory, the widths and their knots, the
//     heights and theirs (normalized_sizes, knots) and min_derivative +
//     softplus(d_k) for k = 0..K, each kind on warps of its own; then
//     each thread finds its bin by the same >= compares against the
//     search side's interior knots and reads the bin's six values by
//     index. rqs_element sums the selected
//     values onto 0.0f through masks, which gives that one value, and
//     computes the same functions in the same order, so both paths give
//     the same bits. Each element's x and tail bound are loaded before
//     the prologue, so their latency overlaps the prologue's.
//
// Both paths are templates on the storage type T of every operand and
// output: float (rqs_fwd_launch) or __nv_bfloat16 (rqs_fwd_launch_bf16,
// the bfloat16 image NSF's). A bfloat16 element is read as 2 bytes,
// widened, run through the same float32 math and rounded once on store
// (rqs_math.cuh), so the bfloat16 kernel moves half the float32 one's
// bytes and computes the float32 function of its widened inputs. The loads
// are one element a lane, so a row that starts at an odd element (a
// (B*C, H*W) view) needs no alignment.
#include <cuda_runtime.h>

#include <cstdint>

#include "rqs_math.cuh"
#include "rqs_per_element.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSharedCols = 64;  // columns the shared path's tables hold
static_assert(kThreads > 64, "the shared path's tables take three warps");

struct Strides {
  // element (r, c) of x at r*x[0] + c*x[1]; bin k of that element's width
  // logits at k*w[0] + r*w[1] + c*w[2]; likewise h, d; tb at r*tb[0] +
  // c*tb[1]
  long long x[2], w[3], h[3], d[3], tb[2];
};

// The per-element path: rqs_per_element.cuh's schedule over the operands
// x, w, h, d and tb (kPerElementOps), then rqs_element and two stores.
constexpr int kPerElementOps = nf::tile::kTb + 1;

// The launch bound keeps A at 32-56 registers (the previous kernel's 40 at
// K 8): without it, an earlier form of this kernel took 46-56 at K 8 and
// ran 3-6% slower on the one-wave K-major launches. C and D take none
// (their policies spill under it).
template <class T, int K, bool INVERSE, class I>
__global__ void __launch_bounds__(nf::tile::kThreads) rqs_fwd_kernel(
    const __grid_constant__ nf::tile::Operands<T, I> a, float tb_scalar,
    float min_bin_width, float min_bin_height, float min_derivative,
    T* __restrict__ y, T* __restrict__ ld) {
  namespace P = nf::tile;
  I i, r, c;
  if (!P::element_of(a.rows, a.cols, i, r, c)) return;
  float w[K], h[K], d[K + 1], xv[1], tv[1] = {tb_scalar};
  P::operand_direct<P::kW>(a, r, c, w);
  P::operand_direct<P::kH>(a, r, c, h);
  P::operand_direct<P::kD>(a, r, c, d);
  P::operand_direct<P::kX>(a, r, c, xv);
  if (a.op[P::kTb].p) P::operand_direct<P::kTb>(a, r, c, tv);
  float yv, lv;
  nf::rqs_element<K, INVERSE>(xv[0], tv[0], w, h, d, min_bin_width,
                              min_bin_height, min_derivative, yv, lv);
  y[i] = nf::from_f32<T>(yv);
  ld[i] = nf::from_f32<T>(lv);
}

template <class T, int K, bool INVERSE>
__global__ void __launch_bounds__(kThreads) rqs_fwd_shared_kernel(
    const T* __restrict__ x, const T* __restrict__ uw,
    const T* __restrict__ uh, const T* __restrict__ ud,
    const T* __restrict__ tb, float tb_scalar, Strides s, long long rows,
    long long cols, float min_bin_width, float min_bin_height,
    float min_derivative, T* __restrict__ y, T* __restrict__ ld) {
  // per column: each bin's left knots (cw, ch) and sizes (w, h), and the
  // derivatives at the K + 1 knots
  __shared__ float s_cw[kMaxSharedCols][K], s_w[kMaxSharedCols][K],
      s_ch[kMaxSharedCols][K], s_h[kMaxSharedCols][K],
      s_d[kMaxSharedCols][K + 1];
  const int ncols = static_cast<int>(cols);
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool active = i < rows * cols;
  const long long r = i / cols;
  const int c = static_cast<int>(i - r * cols);
  auto tail = [&](int cc) {
    return tb ? nf::to_f32(tb[cc * s.tb[1]]) : tb_scalar;
  };
  const float xv = active ? nf::to_f32(x[r * s.x[0] + c * s.x[1]]) : 0.0f;
  const float t = active ? tail(c) : 0.0f;

  // the column tables: warp 0 the widths, warp 1 the heights (a column per
  // lane), the other warps the derivatives (a column and knot per thread).
  // The three kinds run on separate warps, so that no warp waits for the
  // loads of one kind and then for those of another.
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const bool wid = warp == 0;
    for (int cc = threadIdx.x & 31; cc < ncols; cc += 32) {
      const T* u = wid ? uw + cc * s.w[2] : uh + cc * s.h[2];
      const long long bin_stride = wid ? s.w[0] : s.h[0];
      float logits[K], sizes[K], cum[K + 1];
#pragma unroll
      for (int k = 0; k < K; ++k) logits[k] = nf::to_f32(u[k * bin_stride]);
      nf::normalized_sizes<K>(logits, wid ? min_bin_width : min_bin_height,
                              sizes);
      nf::knots<K>(sizes, tail(cc), cum);
      float* sz = wid ? s_w[cc] : s_h[cc];
      float* cm = wid ? s_cw[cc] : s_ch[cc];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        sz[k] = sizes[k];
        cm[k] = cum[k];
      }
    }
  } else {
    for (int e = threadIdx.x - 64; e < ncols * (K + 1); e += kThreads - 64) {
      const int cc = e / (K + 1);
      const int k = e - cc * (K + 1);
      s_d[cc][k] = min_derivative +
                   nf::softplus(nf::to_f32(ud[cc * s.d[2] + k * s.d[0]]));
    }
  }
  __syncthreads();
  if (!active) return;

  const float xin = fminf(fmaxf(xv, -t), t);
  const float* cref = INVERSE ? s_ch[c] : s_cw[c];
  int bin = 0;  // the one k with xin >= cref[k] and not xin >= cref[k + 1]
#pragma unroll
  for (int k = 1; k < K; ++k) bin += xin >= cref[k] ? 1 : 0;
  float yv, lv;
  nf::rqs_map<INVERSE>(xv, t, xin, s_cw[c][bin], s_w[c][bin], s_ch[c][bin],
                       s_h[c][bin], s_d[c][bin], s_d[c][bin + 1], yv, lv);
  y[i] = nf::from_f32<T>(yv);
  ld[i] = nf::from_f32<T>(lv);
}

template <class T, int K, bool INVERSE, class I>
void launch_per_element(const nf::tile::Operands<T, I>& a, float tb_scalar,
                        float mbw, float mbh, float md, T* y, T* ld,
                        cudaStream_t stream) {
  rqs_fwd_kernel<T, K, INVERSE, I>
      <<<nf::tile::blocks_of(static_cast<long long>(a.rows) * a.cols),
         nf::tile::kThreads, 0, stream>>>(a, tb_scalar, mbw, mbh, md, y,
                                           ld);
}

template <class T, int K, bool INVERSE>
void launch(const T* x, const T* uw, const T* uh, const T* ud, const T* tb,
            float tb_scalar, const Strides& s, const long long* strides,
            long long rows, long long cols, float mbw, float mbh, float md,
            T* y, T* ld, int offsets32, cudaStream_t stream) {
  const bool shared = cols <= kMaxSharedCols && s.w[1] == 0 &&
                      s.h[1] == 0 && s.d[1] == 0 && (!tb || s.tb[0] == 0);
  if (shared) {
    const long long n = rows * cols;
    const unsigned blocks =
        static_cast<unsigned>((n + kThreads - 1) / kThreads);
    rqs_fwd_shared_kernel<T, K, INVERSE><<<blocks, kThreads, 0, stream>>>(
        x, uw, uh, ud, tb, tb_scalar, s, rows, cols, mbw, mbh, md, y, ld);
    return;
  }
  const T* const p[nf::tile::kOperands] = {x, uw, uh, ud, tb, nullptr,
                                           nullptr};
  if (offsets32)
    launch_per_element<T, K, INVERSE>(
        nf::tile::operands<T, unsigned>(p, kPerElementOps, strides, rows,
                                        cols),
        tb_scalar, mbw, mbh, md, y, ld, stream);
  else
    launch_per_element<T, K, INVERSE>(
        nf::tile::operands<T, unsigned long long>(p, kPerElementOps,
                                                  strides, rows, cols),
        tb_scalar, mbw, mbh, md, y, ld, stream);
}

// The body of both C entry points: see rqs_fwd_launch.
template <class T>
int dispatch(const T* x, const T* uw, const T* uh, const T* ud, const T* tb,
             float tb_scalar, const long long* strides, long long rows,
             long long cols, int num_bins, int inverse, float min_bin_width,
             float min_bin_height, float min_derivative, T* y, T* ld,
             int offsets32, void* stream) {
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
      launch<T, KK, true>(x, uw, uh, ud, tb, tb_scalar, s, strides, rows,   \
                          cols, min_bin_width, min_bin_height,              \
                          min_derivative, y, ld, offsets32, st);    \
    else                                                                    \
      launch<T, KK, false>(x, uw, uh, ud, tb, tb_scalar, s, strides, rows,  \
                           cols, min_bin_width, min_bin_height,             \
                           min_derivative, y, ld, offsets32, st);   \
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

}  // namespace

// C interface for ctypes. `strides` points to 13 int64: x(2), w(3), h(3),
// d(3), tb(2). `offsets32` (splines_kernel.per_element_offsets32) nonzero
// for the per-element path's 32-bit element offsets: every offset of the
// call, the outputs' included, fits. Returns cudaGetLastError() after the
// launch; -1 for a bin count that has no instantiation.
extern "C" int rqs_fwd_launch(const float* x, const float* uw,
                              const float* uh, const float* ud,
                              const float* tb, float tb_scalar,
                              const long long* strides, long long rows,
                              long long cols, int num_bins, int inverse,
                              float min_bin_width, float min_bin_height,
                              float min_derivative, float* y, float* ld,
                              int offsets32, void* stream) {
  return dispatch<float>(x, uw, uh, ud, tb, tb_scalar, strides, rows, cols,
                         num_bins, inverse, min_bin_width, min_bin_height,
                         min_derivative, y, ld, offsets32, stream);
}

// The same for bfloat16 operands and outputs (tb_scalar and the minima stay
// float).
extern "C" int rqs_fwd_launch_bf16(
    const __nv_bfloat16* x, const __nv_bfloat16* uw, const __nv_bfloat16* uh,
    const __nv_bfloat16* ud, const __nv_bfloat16* tb, float tb_scalar,
    const long long* strides, long long rows, long long cols, int num_bins,
    int inverse, float min_bin_width, float min_bin_height,
    float min_derivative, __nv_bfloat16* y, __nv_bfloat16* ld,
    int offsets32, void* stream) {
  return dispatch<__nv_bfloat16>(x, uw, uh, ud, tb, tb_scalar, strides, rows,
                                 cols, num_bins, inverse, min_bin_width,
                                 min_bin_height, min_derivative, y, ld,
                                 offsets32, stream);
}
