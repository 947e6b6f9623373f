// Kernel B: conditioner head product + RQ spline in one pass, forward or
// inverse.
//
// Replaces nf_tpu/ops/spline_head_fused.py:_head_kernel (launcher
// _make_op.fwd_impl, :216). Same function: params = W_eff @ h_t + b, row
// planes p*D + d per bin, the K+1 derivative logits built in the kernel
// (linear tails: constant edge logits of slope 1; circular: plane 0 closes
// the circle), then the spline of rqs_math.cuh with a per-feature tb.
//
// Design. One thread per (d, b) element. A block is 256 consecutive b of
// one d (blockIdx.y = d), so a warp shares d and spans 32 consecutive b:
// its loads of h_t[j, b] are coalesced, and the rows p*D + d of W_eff it
// needs are the same for all its threads. The block stages those P = 2K+nd
// rows in shared memory, 32 columns of H at a time, and every thread reads
// them as broadcasts. Each thread keeps its P parameter sums in registers;
// the parameter planes never exist in device memory. The product is
// computed here, not by a library call.
//
// Bound on the H100: per element it reads H floats of h_t and does
// 2*P*H flops. At D = 1, H = 128, K = 8 (P = 23) that is 512 bytes against
// 5888 flops, ~11.5 flop/byte: below the f32 CUDA-core ridge (67 TFLOP/s
// over 3.35 TB/s = 20 flop/byte), so reading h_t bounds it. The design
// reads h_t once per feature d and nothing else of size B*H.
#include <cuda_runtime.h>

#include <cstdint>

#include "rqs_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;  // columns of H staged per step

template <int K, bool CIRCULAR, bool INVERSE>
__global__ void head_rqs_fwd_kernel(
    const float* __restrict__ x_t, long long x_rs, long long x_cs,
    const float* __restrict__ h_t, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ tb, int D,
    long long B, int H, float edge, float min_bin_width,
    float min_bin_height, float min_derivative, float* __restrict__ y,
    float* __restrict__ ld) {
  constexpr int ND = CIRCULAR ? K : K - 1;
  constexpr int P = 2 * K + ND;
  __shared__ float w_tile[P][kTile];

  const int d = blockIdx.y;
  const long long b =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool active = b < B;

  float acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.0f;

  for (int j0 = 0; j0 < H; j0 += kTile) {
    const int tile = min(kTile, H - j0);
    for (int e = threadIdx.x; e < P * kTile; e += blockDim.x) {
      const int p = e / kTile;
      const int j = e - p * kTile;
      w_tile[p][j] = (j < tile)
          ? w[static_cast<long long>(p * D + d) * H + j0 + j] : 0.0f;
    }
    __syncthreads();
    if (active) {
      const float* hp = h_t + static_cast<long long>(j0) * B + b;
#pragma unroll 4
      for (int j = 0; j < tile; ++j) {
        const float hv = hp[static_cast<long long>(j) * B];
#pragma unroll
        for (int p = 0; p < P; ++p) acc[p] = fmaf(w_tile[p][j], hv, acc[p]);
      }
    }
    __syncthreads();
  }
  if (!active) return;

  float uw[K], uh[K], ud[K + 1];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    uw[k] = acc[k] + bias[k * D + d];
    uh[k] = acc[K + k] + bias[(K + k) * D + d];
  }
  if (CIRCULAR) {
#pragma unroll
    for (int k = 0; k < K; ++k) ud[k] = acc[2 * K + k] + bias[(2 * K + k) * D + d];
    ud[K] = ud[0];
  } else {
    ud[0] = edge;
    ud[K] = edge;
#pragma unroll
    for (int k = 0; k < K - 1; ++k)
      ud[k + 1] = acc[2 * K + k] + bias[(2 * K + k) * D + d];
  }

  float yv, lv;
  nf::rqs_element<K, INVERSE>(x_t[d * x_rs + b * x_cs], tb[d], uw, uh, ud,
                              min_bin_width, min_bin_height, min_derivative,
                              yv, lv);
  y[d * B + b] = yv;
  ld[d * B + b] = lv;
}

template <int K, bool CIRCULAR, bool INVERSE>
void launch(const float* x_t, long long x_rs, long long x_cs,
            const float* h_t, const float* w, const float* bias,
            const float* tb, int D, long long B, int H, float edge, float mbw,
            float mbh, float md, float* y, float* ld, cudaStream_t stream) {
  dim3 grid(static_cast<unsigned>((B + kThreads - 1) / kThreads),
            static_cast<unsigned>(D));
  head_rqs_fwd_kernel<K, CIRCULAR, INVERSE><<<grid, kThreads, 0, stream>>>(
      x_t, x_rs, x_cs, h_t, w, bias, tb, D, B, H, edge, mbw, mbh, md, y, ld);
}

}  // namespace

// C interface for ctypes. x_t (D, B) with strides (x_rs, x_cs); h_t (H, B),
// w (P*D, H), bias (P*D,), tb (D,) contiguous; y, ld (D, B) contiguous.
// `edge` is the linear-tail derivative logit log(exp(1 - min_d) - 1).
// Returns cudaGetLastError() after the launch; -1 for a bin count that has
// no instantiation.
extern "C" int head_rqs_fwd_launch(
    const float* x_t, long long x_rs, long long x_cs, const float* h_t,
    const float* w, const float* bias, const float* tb, int D, long long B,
    int H, int num_bins, int circular, int inverse, float edge,
    float min_bin_width, float min_bin_height, float min_derivative,
    float* y, float* ld, void* stream) {
  if (B == 0 || D == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NF_HEAD_LAUNCH(KK, CC, II)                                          \
  launch<KK, CC, II>(x_t, x_rs, x_cs, h_t, w, bias, tb, D, B, H, edge,      \
                     min_bin_width, min_bin_height, min_derivative, y, ld,  \
                     st)
#define NF_HEAD_CASE(KK)                                                    \
  case KK:                                                                  \
    if (circular) {                                                         \
      if (inverse) NF_HEAD_LAUNCH(KK, true, true);                          \
      else NF_HEAD_LAUNCH(KK, true, false);                                 \
    } else {                                                                \
      if (inverse) NF_HEAD_LAUNCH(KK, false, true);                         \
      else NF_HEAD_LAUNCH(KK, false, false);                                \
    }                                                                       \
    break;
  switch (num_bins) {
    NF_HEAD_CASE(4)
    NF_HEAD_CASE(8)
    NF_HEAD_CASE(10)
    default:
      return -1;
  }
#undef NF_HEAD_CASE
#undef NF_HEAD_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
