// Kernel E: the fused backward of kernel B (conditioner head product + RQ
// spline), forward or inverse spline direction.
//
// Replaces nf_tpu/ops/spline_head_fused.py:_head_bwd_kernel (launcher
// _make_op.bwd_impl, :236). Same function: recompute params = W_eff @ h_t
// + b, run the analytic spline transpose (rqs_bwd_math.cuh), fold the
// derivative cotangents into head rows (linear tails: the two synthesised
// edge planes have no rows and are dropped; circular: gd[0] + gd[K] goes to
// row 0), and emit
//   gx (D, B)                      per element,
//   gh = W_eff^T @ gparams (H, B)  per batch column,
//   gW = gparams @ h_t^T (M, H) and gb = sum_b gparams (M,)  over the batch.
// All three products run in this file's kernels, not in a library call.
//
// Design. A block owns 256 consecutive batch columns b and every feature d
// of them (M = (2K+nd)*D head rows in all).
//   1. For each d, each thread recomputes its P = 2K+nd parameter sums in
//      registers exactly as kernel B does (same staging of W_eff rows in
//      shared memory, same fmaf order), runs the per-element backward,
//      writes gx, and parks its P parameter cotangents in shared memory
//      (gp, M x 256): the block's gparams tile never reaches device memory.
//   2. gh: each thread forms its column of W_eff^T @ gp, 32 rows of H at a
//      time (W_eff columns staged in shared memory, 32 accumulators in
//      registers), and stores them coalesced over b.
//   3. gW and gb: the block's partial gp @ h_t^T over its 256 columns, with
//      h_t staged 32 columns at a time ((H, 33): the pad keeps the
//      column-wise reads free of bank conflicts), each thread owning up to
//      kOut of the M*H outputs, plus the row sums of gp; written to the
//      block's row of a (blocks, M*(H+1)) workspace.
// On the TPU gW and gb accumulate across a sequential grid. Hopper's
// blocks run concurrently and in no order, so a second launch
// (reduce_partials) sums the workspace over the blocks in a fixed order:
// the gradients are the same bits from run to run, which atomics would not
// give.
//
// Bound on the H100: per batch column it reads h_t once (H floats) and
// writes gh (H floats); 2*M*H flops each for the recompute, gh and gW.
// At D = 1, H = 128, K = 8 (M = 23): 1 KB against ~17.7 kflop per column,
// ~17 flop/byte, near the f32 CUDA-core ridge (67 TFLOP/s / 3.35 TB/s =
// 20). This simple kernel pairs a shared-memory load with most FMAs and
// runs its three products one after the other, so instruction throughput
// bounds it.
#include <cuda_runtime.h>

#include <cstdint>

#include "rqs_bwd_math.cuh"

namespace {

constexpr int kThreads = 256;  // batch columns per block
constexpr int kTile = 32;      // columns of W_eff staged per step
constexpr int kChunk = 32;     // batch columns of h_t staged per step
constexpr int kOut = 12;       // gW outputs per thread per pass

template <int K, bool CIRCULAR, bool INVERSE>
__global__ void head_rqs_bwd_kernel(
    const float* __restrict__ x_t, long long x_rs, long long x_cs,
    const float* __restrict__ h_t, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ tb,
    const float* __restrict__ cty, long long cty_rs, long long cty_cs,
    const float* __restrict__ ctl, long long ctl_rs, long long ctl_cs, int D,
    long long B, int H, float edge, float min_bin_width,
    float min_bin_height, float min_derivative, float* __restrict__ gx,
    float* __restrict__ gh, float* __restrict__ partials) {
  constexpr int ND = CIRCULAR ? K : K - 1;
  constexpr int P = 2 * K + ND;
  const int M = P * D;
  extern __shared__ float smem[];
  float* gp = smem;                         // [M][kThreads]
  float* h_s = gp + M * kThreads;           // [H][kChunk + 1]
  float* w_s = h_s + H * (kChunk + 1);      // [M][kTile]

  const int tid = threadIdx.x;
  const long long b0 = static_cast<long long>(blockIdx.x) * kThreads;
  const long long b = b0 + tid;
  const bool active = b < B;

  // 1. recompute + per-element backward, one feature at a time
  for (int d = 0; d < D; ++d) {
    float acc[P];
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = 0.0f;
    for (int j0 = 0; j0 < H; j0 += kTile) {
      const int tile = min(kTile, H - j0);
      for (int e = tid; e < P * kTile; e += kThreads) {
        const int p = e / kTile;
        const int j = e - p * kTile;
        w_s[e] = (j < tile)
            ? w[static_cast<long long>(p * D + d) * H + j0 + j] : 0.0f;
      }
      __syncthreads();
      if (active) {
        const float* hp = h_t + static_cast<long long>(j0) * B + b;
#pragma unroll 4
        for (int j = 0; j < tile; ++j) {
          const float hv = hp[static_cast<long long>(j) * B];
#pragma unroll
          for (int p = 0; p < P; ++p)
            acc[p] = fmaf(w_s[p * kTile + j], hv, acc[p]);
        }
      }
      __syncthreads();
    }
    float g[P];
    if (active) {
      float uw[K], uh[K], ud[K + 1];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        uw[k] = acc[k] + bias[k * D + d];
        uh[k] = acc[K + k] + bias[(K + k) * D + d];
      }
      if (CIRCULAR) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          ud[k] = acc[2 * K + k] + bias[(2 * K + k) * D + d];
        ud[K] = ud[0];
      } else {
        ud[0] = edge;
        ud[K] = edge;
#pragma unroll
        for (int k = 0; k < K - 1; ++k)
          ud[k + 1] = acc[2 * K + k] + bias[(2 * K + k) * D + d];
      }
      float gxv, gwv[K], ghv[K], gdv[K + 1];
      nf::rqs_bwd_element<K, INVERSE>(
          x_t[d * x_rs + b * x_cs], tb[d], uw, uh, ud,
          cty[d * cty_rs + b * cty_cs], ctl[d * ctl_rs + b * ctl_cs],
          min_bin_width, min_bin_height, min_derivative, gxv, gwv, ghv, gdv);
      gx[d * B + b] = gxv;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        g[k] = gwv[k];
        g[K + k] = ghv[k];
      }
      if (CIRCULAR) {
        g[2 * K] = gdv[0] + gdv[K];
#pragma unroll
        for (int k = 1; k < K; ++k) g[2 * K + k] = gdv[k];
      } else {
#pragma unroll
        for (int k = 0; k < K - 1; ++k) g[2 * K + k] = gdv[k + 1];
      }
    } else {
#pragma unroll
      for (int p = 0; p < P; ++p) g[p] = 0.0f;  // no share in gW or gb
    }
#pragma unroll
    for (int p = 0; p < P; ++p) gp[(p * D + d) * kThreads + tid] = g[p];
  }
  __syncthreads();

  // 2. gh[:, b] = W_eff^T @ gp[:, b]
  for (int j0 = 0; j0 < H; j0 += kTile) {
    const int tile = min(kTile, H - j0);
    for (int e = tid; e < M * kTile; e += kThreads) {
      const int m = e / kTile;
      const int j = e - m * kTile;
      w_s[e] = (j < tile) ? w[static_cast<long long>(m) * H + j0 + j] : 0.0f;
    }
    __syncthreads();
    if (active) {
      float s[kTile];
#pragma unroll
      for (int j = 0; j < kTile; ++j) s[j] = 0.0f;
      for (int m = 0; m < M; ++m) {
        const float gv = gp[m * kThreads + tid];
#pragma unroll
        for (int j = 0; j < kTile; ++j) s[j] = fmaf(w_s[m * kTile + j], gv, s[j]);
      }
#pragma unroll
      for (int j = 0; j < kTile; ++j)
        if (j < tile) gh[static_cast<long long>(j0 + j) * B + b] = s[j];
    }
    __syncthreads();
  }

  // 3. this block's share of gW = gp @ h_t^T and gb = sum_b gp
  const int MH = M * H;
  float* out = partials + static_cast<long long>(blockIdx.x) * (MH + M);
  for (int o0 = 0; o0 < MH; o0 += kThreads * kOut) {
    float acc[kOut];
#pragma unroll
    for (int r = 0; r < kOut; ++r) acc[r] = 0.0f;
    for (int c0 = 0; c0 < kThreads; c0 += kChunk) {
      for (int e = tid; e < H * kChunk; e += kThreads) {
        const int j = e / kChunk;
        const int cc = e - j * kChunk;
        const long long bb = b0 + c0 + cc;
        h_s[j * (kChunk + 1) + cc] =
            (bb < B) ? h_t[static_cast<long long>(j) * B + bb] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kOut; ++r) {
        const int o = o0 + r * kThreads + tid;
        if (o < MH) {
          const int m = o / H;
          const int j = o - m * H;
          const float* gr = gp + m * kThreads + c0;
          const float* hr = h_s + j * (kChunk + 1);
#pragma unroll 8
          for (int cc = 0; cc < kChunk; ++cc)
            acc[r] = fmaf(gr[cc], hr[cc], acc[r]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < kOut; ++r) {
      const int o = o0 + r * kThreads + tid;
      if (o < MH) out[o] = acc[r];
    }
  }
  for (int m = tid; m < M; m += kThreads) {
    float s = 0.0f;
    for (int t = 0; t < kThreads; ++t) s += gp[m * kThreads + t];
    out[MH + m] = s;
  }
}

// Sum the blocks' (MH + M)-wide partial rows in a fixed order: 32 outputs
// per block, 8 rows of threads each summing every 8th partial in turn,
// then row 0 adds the 8 sums in order. gW takes outputs [0, MH), gb the
// rest.
__global__ void reduce_partials(const float* __restrict__ partials,
                                int blocks, int MH, int M,
                                float* __restrict__ gw,
                                float* __restrict__ gb) {
  __shared__ float part[8][33];
  const int width = MH + M;
  const int o = blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (o < width)
    for (int k = threadIdx.y; k < blocks; k += 8)
      s += partials[static_cast<long long>(k) * width + o];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && o < width) {
    float t = part[0][threadIdx.x];
#pragma unroll
    for (int y = 1; y < 8; ++y) t += part[y][threadIdx.x];
    if (o < MH)
      gw[o] = t;
    else
      gb[o - MH] = t;
  }
}

template <int K, bool CIRCULAR, bool INVERSE>
int launch(const float* x_t, long long x_rs, long long x_cs,
           const float* h_t, const float* w, const float* bias,
           const float* tb, const float* cty, long long cty_rs,
           long long cty_cs, const float* ctl, long long ctl_rs,
           long long ctl_cs, int D, long long B, int H, float edge,
           float mbw, float mbh, float md, float* gx, float* gh,
           float* partials, cudaStream_t stream) {
  constexpr int P = 2 * K + (CIRCULAR ? K : K - 1);
  const int M = P * D;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(M) * kThreads +
                       static_cast<size_t>(H) * (kChunk + 1) +
                       static_cast<size_t>(M) * kTile);
  auto kernel = head_rqs_bwd_kernel<K, CIRCULAR, INVERSE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, smem, stream>>>(
      x_t, x_rs, x_cs, h_t, w, bias, tb, cty, cty_rs, cty_cs, ctl, ctl_rs,
      ctl_cs, D, B, H, edge, mbw, mbh, md, gx, gh, partials);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface for ctypes. x_t, cty, ctl (D, B) with their (row, column)
// strides; h_t (H, B), w (M, H), bias (M,), tb (D,) contiguous; gx (D, B),
// gh (H, B), gw (M, H), gb (M,) contiguous outputs; partials a contiguous
// workspace of ceil(B / 256) * M * (H + 1) floats. `edge` is the
// linear-tail derivative logit log(exp(1 - min_d) - 1). Returns the first
// CUDA error of the two launches (0 if none); -1 for a bin count that has
// no instantiation.
extern "C" int head_rqs_bwd_launch(
    const float* x_t, long long x_rs, long long x_cs, const float* h_t,
    const float* w, const float* bias, const float* tb, const float* cty,
    long long cty_rs, long long cty_cs, const float* ctl, long long ctl_rs,
    long long ctl_cs, int D, long long B, int H, int num_bins, int circular,
    int inverse, float edge, float min_bin_width, float min_bin_height,
    float min_derivative, float* gx, float* gh, float* gw, float* gb,
    float* partials, void* stream) {
  if (D == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int P = 2 * num_bins + (circular ? num_bins : num_bins - 1);
  const int M = P * D;
  const int blocks = static_cast<int>((B + kThreads - 1) / kThreads);
  if (B == 0) {
    // no columns: every gradient of the head is zero
    cudaMemsetAsync(gw, 0, sizeof(float) * M * H, st);
    cudaMemsetAsync(gb, 0, sizeof(float) * M, st);
    return static_cast<int>(cudaGetLastError());
  }
  int err = 0;
#define NF_HEAD_BWD_LAUNCH(KK, CC, II)                                      \
  err = launch<KK, CC, II>(x_t, x_rs, x_cs, h_t, w, bias, tb, cty, cty_rs,  \
                           cty_cs, ctl, ctl_rs, ctl_cs, D, B, H, edge,      \
                           min_bin_width, min_bin_height, min_derivative,   \
                           gx, gh, partials, st)
#define NF_HEAD_BWD_CASE(KK)                                                \
  case KK:                                                                  \
    if (circular) {                                                         \
      if (inverse) NF_HEAD_BWD_LAUNCH(KK, true, true);                      \
      else NF_HEAD_BWD_LAUNCH(KK, true, false);                             \
    } else {                                                                \
      if (inverse) NF_HEAD_BWD_LAUNCH(KK, false, true);                     \
      else NF_HEAD_BWD_LAUNCH(KK, false, false);                            \
    }                                                                       \
    break;
  switch (num_bins) {
    NF_HEAD_BWD_CASE(4)
    NF_HEAD_BWD_CASE(8)
    NF_HEAD_BWD_CASE(10)
    default:
      return -1;
  }
#undef NF_HEAD_BWD_CASE
#undef NF_HEAD_BWD_LAUNCH
  if (err != 0) return err;
  const int width = M * H + M;
  reduce_partials<<<(width + 31) / 32, dim3(32, 8), 0, st>>>(
      partials, blocks, M * H, M, gw, gb);
  return static_cast<int>(cudaGetLastError());
}
