// Kernel C: the analytic backward of the unconstrained RQ spline (kernel
// A), forward or inverse direction.
//
// Replaces nf_tpu/ops/splines_pallas.py:_rqs_bwd_kernel_analytic (launcher
// _pallas_bwd_impl, :474). Same function: the operands of kernel A plus
// the cotangents (cty, ctl) of (y, log|det|) -> gx and the K width, K
// height and K+1 derivative logit cotangents of every element.
//
// Two paths, both kernel C; the math of both is rqs_bwd_math.cuh, which
// recomputes the forward in registers, so the residuals are the inputs
// alone (as the JAX custom VJP saves them).
//
// * Per element (any strides; rqs_bwd_launch, and rqs_bwd_launch_bf16 for
//   bfloat16 operands and outputs with float32 math inside, half the
//   bytes): the launch, strides and output layout of rqs_bwd_kernel.cuh,
//   shared with kernel D, on rqs_per_element.cuh's schedule (a warp a
//   tile of 32 elements, 32-bit offsets where the call fits; C launches
//   its one-tile kernel at every shape). Per element it reads x, cty, ctl and the parameter
//   planes, and writes gx and 3K+1 planes: (3K+5) * 4 bytes, 116 at
//   K = 8, against ~450 flops, below the f32 ridge of ~20 flop/byte: the
//   loads and stores bound it.
//
// * Shared parameters (rqs_bwd_shared_launch): when w, h and d have row
//   stride 0 (the unconditional CDF's (1, D, K) parameters broadcast over
//   the batch), tb is a float or has row stride 0 too, and there are at
//   most kMaxSharedCols columns. Its outputs are the parameter cotangents
//   already summed over the rows, (K, cols) and (K+1, cols), and gx per
//   element. The per-element gradient planes exist only to be summed, and
//   the map from an element's six selected values (g_cw, g_wd, g_ch, g_hh,
//   g_d0, g_d1) to the logits is linear and depends on its bin alone, so
//   the path sums those six per (column, bin) and maps the 6K sums to the
//   logits once per column. Two launches, counted as one call of kernel C:
//     1. rqs_bwd_shared_blocks, grid (chunks, cols): a block takes
//        kRowsPerBlock rows of one column. Its first warps compute the
//        column's knots, sizes and derivatives into shared memory (as
//        kernel A's shared path does); then each thread, per element,
//        finds the bin by the same >= compares, reads the six values by
//        index, runs rqs_bwd_map (the per-element path's arithmetic, so gx
//        comes out bitwise equal), writes gx, and adds the six cotangents
//        into its 6K register slots (the element's bin, and nothing
//        outside [-tb, tb]). The slots are summed over the warp by
//        recursive halving (warp_halve, ~6K shuffles where a tree per slot
//        takes 30K), over the block's warps in warp order, and written
//        as the block's partial to the workspace.
//     2. rqs_bwd_shared_sum, one block per column, launched as a
//        programmatic dependent launch: its threads first compute the
//        column's softmaxes and sigmoids, which need no partial, then wait
//        for launch 1 (griddepcontrol.wait), sum the column's partials in
//        chunk order (per lane, then a shuffle tree), and one thread per
//        kind maps them to the logits: the widths' and heights' softmax/knot
//        transposes (logits_grad_sums) and the derivatives' sigmoids.
//   No float atomics: the order of every sum is fixed by the launch, so
//   two runs give the same bits. The bytes are x, cty and ctl in and gx
//   out, 16 per element (1.05 MB at B = 65536), ~0.3 us of HBM time; the
//   launches and the latency of one element's chain set its time.
//   Like the per-element path it is a template on the storage type T of
//   the operands and outputs (rqs_bwd_shared_launch, and
//   rqs_bwd_shared_launch_bf16 for the coupled layers built with
//   dtype=bfloat16, 8 bytes per element): the tables, the per-block
//   partials in the workspace and their fixed-order total stay float32,
//   and gx and the parameter sums are rounded once into T.
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
                              float* gh, float* gd, int offsets32,
                              void* stream) {
  return nf::rqs_bwd_dispatch<AnalyticMath, nf::OneTileLaunch>(
      x, uw, uh, ud, tb, cty, ctl, tb_scalar, strides, rows, cols, num_bins,
      inverse, min_bin_width, min_bin_height, min_derivative, gx, gw, gh, gd,
      offsets32, 0, stream);
}

// The per-element path for bfloat16 operands, cotangents and outputs
// (float32 math inside).
extern "C" int rqs_bwd_launch_bf16(
    const __nv_bfloat16* x, const __nv_bfloat16* uw, const __nv_bfloat16* uh,
    const __nv_bfloat16* ud, const __nv_bfloat16* tb,
    const __nv_bfloat16* cty, const __nv_bfloat16* ctl, float tb_scalar,
    const long long* strides, long long rows, long long cols, int num_bins,
    int inverse, float min_bin_width, float min_bin_height,
    float min_derivative, __nv_bfloat16* gx, __nv_bfloat16* gw,
    __nv_bfloat16* gh, __nv_bfloat16* gd, int offsets32, void* stream) {
  return nf::rqs_bwd_dispatch<AnalyticMath, nf::OneTileLaunch>(
      x, uw, uh, ud, tb, cty, ctl, tb_scalar, strides, rows, cols, num_bins,
      inverse, min_bin_width, min_bin_height, min_derivative, gx, gw, gh, gd,
      offsets32, 0, stream);
}

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// columns the shared path takes (kernel A's limit, rqs_fwd.cu, mirrored by
// splines_kernel.SHARED_PARAM_MAX_COLS)
constexpr int kMaxSharedCols = 64;
// per (column, bin): g_cw, g_wd, g_ch, g_hh, g_d0, g_d1
constexpr int kSlots = 6;
// the rows a block of the first launch takes (mirrored by
// splines_kernel.SHARED_BWD_ROWS_PER_BLOCK, which sizes the workspace):
// 256 and 1024 were slower on the H100 (PERF.md, PR 7)
constexpr long long kRowsPerBlock = 512;
static_assert(kThreads >= 64 + 11, "the tables take warps 0, 1 and 2");

// The warp's sums of N values per lane, in a fixed order and with about N
// shuffles where a tree per value takes 5N: at each offset o (16, 8, ...),
// while the count n of values a lane holds is even, a lane keeps one half
// of them (the upper half where its bit o is set), sends the other half to
// lane ^ o and adds what it receives; the values left once n is odd (or
// the offsets run out) go through a tree over the remaining offsets. Then
// v[0, halving_left(N, 16)) are the sums of slots base.., the same in
// every lane of a group of 2 * halving_stop(N, 16) lanes.
__host__ __device__ constexpr int halving_left(int n, int o) {
  return (o > 0 && n % 2 == 0) ? halving_left(n / 2, o / 2) : n;
}

__host__ __device__ constexpr int halving_stop(int n, int o) {
  return (o > 0 && n % 2 == 0) ? halving_stop(n / 2, o / 2) : o;
}

template <int N, int O, int M>
__device__ __forceinline__ void warp_halve(float (&v)[M], int lane,
                                           int& base) {
  if constexpr (O > 0 && N % 2 == 0) {
    constexpr int H = N / 2;
    const bool up = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? v[i] : v[i + H];
      const float keep = up ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    if (up) base += H;
    warp_halve<H, O / 2>(v, lane, base);
  } else {
#pragma unroll
    for (int o = O; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
    }
  }
}

template <class T, int K, bool INVERSE>
__global__ void __launch_bounds__(kThreads) rqs_bwd_shared_blocks(
    const T* __restrict__ x, const T* __restrict__ uw,
    const T* __restrict__ uh, const T* __restrict__ ud,
    const T* __restrict__ tb, float tb_scalar, const T* __restrict__ cty,
    const T* __restrict__ ctl, nf::BwdStrides s, long long rows,
    long long cols, float min_bin_width, float min_bin_height,
    float min_derivative, T* __restrict__ gx, float* __restrict__ work) {
  // the column's bins: left knots (cw, ch), sizes (w, h), and the
  // derivatives at the K + 1 knots
  __shared__ float s_cw[K], s_w[K], s_ch[K], s_h[K], s_d[K + 1];
  __shared__ float s_part[kWarps][kSlots * K];
  // let the sum's launch begin (it waits for this grid's end itself)
  asm volatile("griddepcontrol.launch_dependents;");
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const long long r_end = min(rows, (blockIdx.x + 1) * kRowsPerBlock);
  long long r = blockIdx.x * kRowsPerBlock + tid;
  const float t = tb ? nf::to_f32(tb[c * s.tb[1]]) : tb_scalar;

  // the first element's operands, loaded before the tables so that their
  // latency overlaps the tables'
  float xv = 0.0f, cy = 0.0f, cl = 0.0f;
  if (r < r_end) {
    xv = nf::to_f32(x[r * s.x[0] + c * s.x[1]]);
    cy = nf::to_f32(cty[r * s.cty[0] + c * s.cty[1]]);
    cl = nf::to_f32(ctl[r * s.ctl[0] + c * s.ctl[1]]);
  }

  // warp 0 the widths, warp 1 the heights, warp 2 the derivatives
  if (tid == 0 || tid == 32) {
    const bool wid = tid == 0;
    const T* u = wid ? uw + c * s.w[2] : uh + c * s.h[2];
    const long long bin_stride = wid ? s.w[0] : s.h[0];
    float logits[K], sizes[K], sm[K], cum[K + 1], cc;
#pragma unroll
    for (int k = 0; k < K; ++k) logits[k] = nf::to_f32(u[k * bin_stride]);
    nf::softmax_terms<K>(logits, wid ? min_bin_width : min_bin_height, sizes,
                         sm, cc);
    nf::knots<K>(sizes, t, cum);
    float* sz = wid ? s_w : s_h;
    float* cm = wid ? s_cw : s_ch;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      sz[k] = sizes[k];
      cm[k] = cum[k];
    }
  } else if (tid >= 64 && tid < 64 + K + 1) {
    const int k = tid - 64;
    s_d[k] = min_derivative +
             nf::softplus(nf::to_f32(ud[c * s.d[2] + k * s.d[0]]));
  }
  __syncthreads();

  float acc[kSlots * K];
#pragma unroll
  for (int j = 0; j < kSlots * K; ++j) acc[j] = 0.0f;
  const float* cref = INVERSE ? s_ch : s_cw;
  while (r < r_end) {
    // the next element's operands, in flight during this one's chain
    const long long rn = r + kThreads;
    float xn = 0.0f, cyn = 0.0f, cln = 0.0f;
    if (rn < r_end) {
      xn = nf::to_f32(x[rn * s.x[0] + c * s.x[1]]);
      cyn = nf::to_f32(cty[rn * s.cty[0] + c * s.cty[1]]);
      cln = nf::to_f32(ctl[rn * s.ctl[0] + c * s.ctl[1]]);
    }
    const float xin = fminf(fmaxf(xv, -t), t);
    int bin = 0;  // the one k with xin >= cref[k] and not xin >= cref[k + 1]
#pragma unroll
    for (int k = 1; k < K; ++k) bin += xin >= cref[k] ? 1 : 0;
    float g[kSlots], g_x_in;
    nf::rqs_bwd_map<INVERSE>(xin, s_cw[bin], s_w[bin], s_ch[bin], s_h[bin],
                             s_d[bin], s_d[bin + 1], cy, cl, g_x_in, g[0],
                             g[1], g[2], g[3], g[4], g[5]);
    const bool inside = (xv >= -t) && (xv <= t);
    gx[r * cols + c] = nf::from_f32<T>(inside ? g_x_in : cy);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool sel = inside && bin == k;
#pragma unroll
      for (int j = 0; j < kSlots; ++j)
        acc[k * kSlots + j] += sel ? g[j] : 0.0f;
    }
    r = rn;
    xv = xn;
    cy = cyn;
    cl = cln;
  }

  const int lane = tid & 31, warp = tid >> 5;
  constexpr int kLeft = halving_left(kSlots * K, 16);
  constexpr int kStop = halving_stop(kSlots * K, 16);
  int base = 0;
  warp_halve<kSlots * K, 16>(acc, lane, base);
  if ((lane & (kStop > 0 ? 2 * kStop - 1 : 0)) == 0) {
#pragma unroll
    for (int i = 0; i < kLeft; ++i) s_part[warp][base + i] = acc[i];
  }
  __syncthreads();
  if (tid < kSlots * K) {
    float v = s_part[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += s_part[w][tid];
    work[(c * static_cast<long long>(gridDim.x) + blockIdx.x) * (kSlots * K) +
         tid] = v;
  }
}

// logits_grad (rqs_bwd_math.cuh) summed over a column's elements: g_cum[b]
// and g_size[b] are the sums over the elements in bin b of the
// cotangents of the selected knot and size. Per element, bin b gives
// gsm[j] = span*c * ([j < b] g_cum + [j == b] g_size - [b == K-1] g_size)
// for j < K-1; summed, gsm[j] = span*c * (sum_{b > j} g_cum[b] + g_size[j]
// - g_size[K-1]).
template <int K>
__device__ __forceinline__ void logits_grad_sums(const float (&g_cum)[K],
                                                 const float (&g_size)[K],
                                                 const float (&sm)[K],
                                                 float c, float span,
                                                 float (&out)[K]) {
  const float sc = span * c;
  float gsm[K];
  gsm[K - 1] = 0.0f;  // size_{K-1} is pinned away
  float suffix = 0.0f;
#pragma unroll
  for (int j = K - 2; j >= 0; --j) {
    suffix = suffix + g_cum[j + 1];
    gsm[j] = sc * ((suffix + g_size[j]) - g_size[K - 1]);
  }
  float S = sm[0] * gsm[0];
#pragma unroll
  for (int j = 1; j < K - 1; ++j) S = S + sm[j] * gsm[j];
#pragma unroll
  for (int j = 0; j < K; ++j) out[j] = sm[j] * (gsm[j] - S);
}

template <class T, int K>
__global__ void __launch_bounds__(kThreads) rqs_bwd_shared_sum(
    const T* __restrict__ uw, const T* __restrict__ uh,
    const T* __restrict__ ud, const T* __restrict__ tb, float tb_scalar,
    nf::BwdStrides s, long long cols, long long chunks, float min_bin_width,
    float min_bin_height, const float* __restrict__ work,
    T* __restrict__ gw, T* __restrict__ gh, T* __restrict__ gd) {
  constexpr int kPerWarp = (kSlots * K + kWarps - 1) / kWarps;
  __shared__ float s_sum[kSlots * K];
  const int c = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool wid = tid == 0;  // thread 0 the widths, thread 32 the heights
  const bool sizes_thread = tid == 0 || tid == 32;
  const int knot = tid - 64;  // warp 2: the derivatives, a knot a thread
  const bool knot_thread = knot >= 0 && knot < K + 1;

  // the column's own terms first: they need none of the partials, so they
  // overlap the end of rqs_bwd_shared_blocks (a programmatic launch)
  float sm[K], cc = 0.0f, sig = 0.0f;
  if (sizes_thread) {
    const T* u = wid ? uw + c * s.w[2] : uh + c * s.h[2];
    const long long bin_stride = wid ? s.w[0] : s.h[0];
    float logits[K], sizes[K];
#pragma unroll
    for (int k = 0; k < K; ++k) logits[k] = nf::to_f32(u[k * bin_stride]);
    nf::softmax_terms<K>(logits, wid ? min_bin_width : min_bin_height, sizes,
                         sm, cc);
  } else if (knot_thread) {
    sig = nf::sigmoid(nf::to_f32(ud[c * s.d[2] + knot * s.d[0]]));
  }
  // wait until rqs_bwd_shared_blocks has finished and its partials are
  // visible (returns at once after an ordinary launch)
  asm volatile("griddepcontrol.wait;" ::: "memory");

  // warp w takes slots w, w + kWarps, ...: each lane sums its chunks in
  // chunk order (the slots' loads, and four chunks', in flight together),
  // then a shuffle tree sums the lanes
  const float* p = work + c * chunks * (kSlots * K);
  float v[kPerWarp];
#pragma unroll
  for (int q = 0; q < kPerWarp; ++q) v[q] = 0.0f;
#pragma unroll 4
  for (long long ch = lane; ch < chunks; ch += 32) {
#pragma unroll
    for (int q = 0; q < kPerWarp; ++q) {
      const int j = warp + q * kWarps;
      if (j < kSlots * K) v[q] += p[ch * (kSlots * K) + j];
    }
  }
#pragma unroll
  for (int q = 0; q < kPerWarp; ++q) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[q] += __shfl_xor_sync(0xffffffffu, v[q], o);
    const int j = warp + q * kWarps;
    if (lane == 0 && j < kSlots * K) s_sum[j] = v[q];
  }
  __syncthreads();

  if (sizes_thread) {
    float g_cum[K], g_size[K], out[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      g_cum[k] = s_sum[k * kSlots + (wid ? 0 : 2)];
      g_size[k] = s_sum[k * kSlots + (wid ? 1 : 3)];
    }
    const float t = tb ? nf::to_f32(tb[c * s.tb[1]]) : tb_scalar;
    logits_grad_sums<K>(g_cum, g_size, sm, cc, 2.0f * t, out);
    T* g = wid ? gw : gh;
#pragma unroll
    for (int k = 0; k < K; ++k) g[k * cols + c] = nf::from_f32<T>(out[k]);
  } else if (knot_thread) {
    // knot k: the left end of bin k (g_d0) and the right end of bin k - 1
    // (g_d1), through the softplus
    float v_k;
    if (knot == 0)
      v_k = s_sum[4];
    else if (knot == K)
      v_k = s_sum[(K - 1) * kSlots + 5];
    else
      v_k = s_sum[knot * kSlots + 4] + s_sum[(knot - 1) * kSlots + 5];
    gd[knot * cols + c] = nf::from_f32<T>(sig * v_k);
  }
}

template <class T, int K, bool INVERSE>
cudaError_t launch_shared(const T* x, const T* uw, const T* uh, const T* ud,
                          const T* tb, float tb_scalar, const T* cty,
                          const T* ctl, const nf::BwdStrides& s,
                          long long rows, long long cols, float mbw,
                          float mbh, float md, T* gx, T* gw, T* gh, T* gd,
                          float* work, cudaStream_t stream) {
  const long long chunks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(cols));
  rqs_bwd_shared_blocks<T, K, INVERSE><<<grid, kThreads, 0, stream>>>(
      x, uw, uh, ud, tb, tb_scalar, cty, ctl, s, rows, cols, mbw, mbh, md,
      gx, work);
  // a programmatic dependent launch: the sum's blocks may start while the
  // first launch runs, and wait for it with griddepcontrol.wait
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cols));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, rqs_bwd_shared_sum<T, K>, uw, uh, ud, tb,
                            tb_scalar, s, cols, chunks, mbw, mbh,
                            static_cast<const float*>(work), gw, gh, gd);
}

// The body of both shared-path C entry points: see rqs_bwd_shared_launch.
template <class T>
int shared_dispatch(const T* x, const T* uw, const T* uh, const T* ud,
                    const T* tb, const T* cty, const T* ctl, float tb_scalar,
                    const long long* strides, long long rows, long long cols,
                    int num_bins, int inverse, float min_bin_width,
                    float min_bin_height, float min_derivative, T* gx, T* gw,
                    T* gh, T* gd, float* work, void* stream) {
  const nf::BwdStrides s = nf::bwd_strides(strides);
  const bool rows_share =
      rows == 1 ||
      (s.w[1] == 0 && s.h[1] == 0 && s.d[1] == 0 && (!tb || s.tb[0] == 0));
  if (cols > kMaxSharedCols || !rows_share) return -2;
  if (rows * cols == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NF_RQS_BWD_SHARED_CASE(KK)                                          \
  case KK:                                                                  \
    err = inverse ? launch_shared<T, KK, true>(                             \
                        x, uw, uh, ud, tb, tb_scalar, cty, ctl, s, rows,    \
                        cols, min_bin_width, min_bin_height,                \
                        min_derivative, gx, gw, gh, gd, work, st)           \
                  : launch_shared<T, KK, false>(                            \
                        x, uw, uh, ud, tb, tb_scalar, cty, ctl, s, rows,    \
                        cols, min_bin_width, min_bin_height,                \
                        min_derivative, gx, gw, gh, gd, work, st);          \
    break;
  cudaError_t err;
  switch (num_bins) {
    NF_RQS_BWD_SHARED_CASE(4)
    NF_RQS_BWD_SHARED_CASE(8)
    NF_RQS_BWD_SHARED_CASE(10)
    default:
      return -1;
  }
#undef NF_RQS_BWD_SHARED_CASE
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface for ctypes: the shared-parameter path. The operands and
// strides are rqs_bwd_launch's; gw and gh are (K, cols), gd (K+1, cols),
// contiguous, the sums over the rows; `work` holds
// cols * ceil(rows / kRowsPerBlock) * 6K floats. Returns
// cudaGetLastError() after the launches; -1 for a bin count that has no
// instantiation, -2 for operands the path does not take (more than
// kMaxSharedCols columns, a parameter or tail bound that varies down the
// rows). With no rows it launches nothing and writes nothing: the sums of
// an empty batch, zeros, are the caller's.
extern "C" int rqs_bwd_shared_launch(
    const float* x, const float* uw, const float* uh, const float* ud,
    const float* tb, const float* cty, const float* ctl, float tb_scalar,
    const long long* strides, long long rows, long long cols, int num_bins,
    int inverse, float min_bin_width, float min_bin_height,
    float min_derivative, float* gx, float* gw, float* gh, float* gd,
    float* work, void* stream) {
  return shared_dispatch<float>(x, uw, uh, ud, tb, cty, ctl, tb_scalar,
                                strides, rows, cols, num_bins, inverse,
                                min_bin_width, min_bin_height,
                                min_derivative, gx, gw, gh, gd, work, stream);
}

// The same for bfloat16 operands, cotangents and outputs; `work` stays
// float32.
extern "C" int rqs_bwd_shared_launch_bf16(
    const __nv_bfloat16* x, const __nv_bfloat16* uw, const __nv_bfloat16* uh,
    const __nv_bfloat16* ud, const __nv_bfloat16* tb,
    const __nv_bfloat16* cty, const __nv_bfloat16* ctl, float tb_scalar,
    const long long* strides, long long rows, long long cols, int num_bins,
    int inverse, float min_bin_width, float min_bin_height,
    float min_derivative, __nv_bfloat16* gx, __nv_bfloat16* gw,
    __nv_bfloat16* gh, __nv_bfloat16* gd, float* work, void* stream) {
  return shared_dispatch<__nv_bfloat16>(
      x, uw, uh, ud, tb, cty, ctl, tb_scalar, strides, rows, cols, num_bins,
      inverse, min_bin_width, min_bin_height, min_derivative, gx, gw, gh, gd,
      work, stream);
}
