// Kernel B: conditioner head product + RQ spline in one pass, forward or
// inverse.
//
// Replaces nf_tpu/ops/spline_head_fused.py:_head_kernel (launcher
// _make_op.fwd_impl, :216). Same function: params = W_eff @ h_t + b, row
// planes p*D + d per bin, the K+1 derivative logits built in the kernel
// (linear tails: constant edge logits of slope 1; circular: plane 0 closes
// the circle), then the spline of rqs_math.cuh with a per-feature tb.
//
// Bound on the H100: per element it reads H floats of h_t and does
// 2*P*H flops (P = 2K + nd parameters). At D = 1, H = 128, K = 8 (P = 23)
// that is 512 bytes against 5888 flops, ~11.5 flop/byte: below the f32
// CUDA-core ridge (67 TFLOP/s over 3.35 TB/s = 20 flop/byte), so reading
// h_t bounds it. Two things stand between the kernel and that bound:
//   * the FMAs take more than half of it, and an SM issues only 4
//     warp-wide FMAs per clock while a warp's 16-byte load from shared
//     memory takes it more than one clock even as a broadcast, so the
//     product must not load a weight per FMA;
//   * at ~1 us of latency, 3.35 TB/s needs ~25 KB of h_t in flight on
//     each SM, more than registers hold.
//
// Design. A block of kThreads threads owns kBlockCols consecutive batch
// columns of one feature d (blockIdx.y = d), a warp kWarpCols of them. A
// lane pair owns 4 consecutive columns; lane 2q + half sums the parameters
// [half*PH, half*PH + PH) of all 4 (PP = P rounded up to 8, PH = PP/2).
//   0. W_eff's rows p*D + d are staged in shared memory by 4-byte cp.async
//      copies that transpose them to w_s[j][PP], kJ columns of H per tile
//      in two buffers: a tile's copies join the commit group of its first
//      h_t stage, so no thread waits on them alone, and a block barrier at
//      the tile's first stage publishes it.
//   1. Each warp streams its own columns of h_t through a ring of kS
//      stages in shared memory, kR rows each, filled by cp.async with
//      kS - 1 stages in flight (16-byte copies when every row of h_t starts
//      on 16 bytes, else 4-byte ones; columns past B are zero-filled). No
//      other warp reads them, so a warp barrier publishes a stage and frees
//      the slot the next copy reuses, and no warp waits for the slowest of
//      the block at every stage.
//   2. Per row j a thread reads PH/4 float4 of W_eff (the pair's two
//      addresses, each shared by 16 lanes) and one float4 of h_t (4
//      columns, shared with its pair), and does 4*PH FMAs: 12 per 16-byte
//      load at K = 8. Each (column, parameter) sums j ascending from 0
//      with fmaf(w, h, acc), the order of the previous designs, which
//      kernel E's recompute repeats (head_rqs_bwd.cu).
//   3. The pair swaps halves by shuffles, so each thread holds all P
//      parameters of 2 columns; + bias, then the spline (nf::rqs_element),
//      the two columns' chains side by side. Its operands (x, tb and the
//      bias, copied beside W_eff with the first stage) are loaded before
//      the product, so their latency is not paid after it.
// The parameter planes never reach device memory, and the product is
// computed here, not by a library call. What is left above the bound
// (PERF.md): reading h_t itself runs below the card's peak, and the
// spline at the end and the part of the product that the loads do not
// hide are latency-bound at the ~8 warps per SM that B = 65536 gives.
//
// bfloat16 (head_rqs_fwd_launch_bf16: the coupled layers built with
// dtype=bfloat16) has a kernel of its own, head_rqs_fwd_bf16_kernel below;
// the template above serves float32 alone. Its bound on the H100: h_t
// moves 2 bytes an element and the product runs on the tensor cores (at
// H 512, K 10 its 2.1 GFLOP take ~2 us at 989 TFLOP/s, against 20 us to
// read h_t), so reading h_t bounds it. Design: a block of 4 warps owns 128
// columns of one feature, a warp 32, a thread one.
//   0. The feature's W_eff rows (P padded with zeros to PM, a multiple of
//      16; H to a multiple of 32) are staged as bfloat16 by 16-byte
//      cp.async copies (element loads where H % 8 != 0), up to
//      kMaxTileCols = 256 columns of H at a time: at H 512 two tiles, so a
//      block takes 47 KB, four share an SM and B = 65536 is one wave.
//   1. Each warp streams its 32 columns of h_t through a ring of 3 chunks
//      of 32 rows, by 16-byte cp.async copies where B % 8 == 0 (else
//      element loads); rows of 80 bytes keep ldmatrix free of bank
//      conflicts. No operand is widened in shared memory.
//   2. head_mma_bf16.cuh's head_product_rows, chunk by chunk:
//      mma.sync.m16n8k16 bf16 x bf16 -> f32, W_eff by ldmatrix, h_t by
//      ldmatrix.trans. Kernel E's recompute calls the same function in the
//      same order, so it differentiates these very parameters.
//   3. column_params hands each lane its column's PM sums (through the
//      drained ring); + bias in float32, the spline of rqs_math.cuh, y and
//      ld rounded once.
// The tensor cores round each k16 step their own way, so the sums are not
// torch.matmul's: tests/test_torch_cuda.py holds y and ld against the
// plain version on the kernel's own sums (head_params_bf16.cu), and the
// sums against float64's. What is left above the bound (PERF.md): the
// write-back of the dirty lines the timing's L2 flush leaves (reading h_t
// evicts as many bytes) and the launch floor; dropping the product or the
// spline saves 0.6-1.8 us each. Tests: tests/test_torch_head_bf16_mma.py
// on the CPU; on the card, python -m pytest --noconftest -p no:cacheprovider
// tests/test_torch_cuda.py -k bf16.
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "head_mma_bf16.cuh"
#include "rqs_math.cuh"

namespace {

constexpr int kThreads = 128;             // threads per block
constexpr int kWarpCols = 64;             // batch columns per warp
constexpr int kBlockCols = kThreads / 32 * kWarpCols;
constexpr int kJ = 128;                   // columns of H per W_eff tile
constexpr int kR = 16;                    // rows of h_t per ring stage
constexpr int kS = 3;                     // stages in the ring
static_assert(kJ == kThreads, "a W_eff tile is one copy per thread per p");
static_assert(kJ % kR == 0, "a stage never straddles two W_eff tiles");
static_assert(kWarpCols == 2 * 32, "a lane pair owns 4 columns");
static_assert((kR * kWarpCols / 8) % 32 == 0,
              "a stage is whole 16-byte copies for every lane");

__host__ __device__ constexpr int padded_params(int p) {
  return (p + 7) / 8 * 8;
}

// dynamic shared memory of one block: two W_eff tiles and the bias
// (float32), and the h_t ring (T)
template <class T>
__host__ __device__ constexpr size_t shared_bytes(int pp) {
  return sizeof(float) * static_cast<size_t>(2 * kJ + 1) * pp
         + sizeof(T) * static_cast<size_t>(kS) * kR * kBlockCols;
}

// acc[c][p] = fmaf(w_row[p], h[c], acc[c][p]) for PH weights of one
// column j of W_eff (PH/4 float4 broadcasts) and 4 columns of h
template <int PH>
__device__ __forceinline__ void fma_row(const float* w_row, const float4 hq,
                                        float (&acc)[4][PH]) {
  const float4* wq = reinterpret_cast<const float4*>(w_row);
  const float hv[4] = {hq.x, hq.y, hq.z, hq.w};
#pragma unroll
  for (int q = 0; q < PH / 4; ++q) {
    const float4 wv = wq[q];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[c][4 * q] = fmaf(wv.x, hv[c], acc[c][4 * q]);
      acc[c][4 * q + 1] = fmaf(wv.y, hv[c], acc[c][4 * q + 1]);
      acc[c][4 * q + 2] = fmaf(wv.z, hv[c], acc[c][4 * q + 2]);
      acc[c][4 * q + 3] = fmaf(wv.w, hv[c], acc[c][4 * q + 3]);
    }
  }
}

template <class T, int K, bool CIRCULAR, bool INVERSE>
__global__ void __launch_bounds__(kThreads, 3) head_rqs_fwd_kernel(
    const T* __restrict__ x_t, long long x_rs, long long x_cs,
    const T* __restrict__ h_t, const T* __restrict__ w,
    const T* __restrict__ bias, const T* __restrict__ tb, int D,
    long long B, int H, bool quads, float edge, float min_bin_width,
    float min_bin_height, float min_derivative, T* __restrict__ y,
    T* __restrict__ ld) {
  constexpr int ND = CIRCULAR ? K : K - 1;
  constexpr int P = 2 * K + ND;
  constexpr int PP = padded_params(P);
  constexpr int PH = PP / 2;
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;               // [2][kJ][PP]
  float* b_s = w_s + 2 * kJ * PP;  // [PP]
  T* h_s = reinterpret_cast<T*>(b_s + PP);  // [warps][kS][kR][kWarpCols]

  const int d = blockIdx.y;
  const int tid = threadIdx.x;
  const int half = tid & 1;  // which half of the parameters
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // the warp's first column, and this thread's first spline column
  const long long bw =
      static_cast<long long>(blockIdx.x) * kBlockCols + warp * kWarpCols;
  const long long bq = bw + 2 * lane;
  T* h_w = h_s + warp * (kS * kR * kWarpCols);

  // 3.'s operands: a column past B reads column B - 1 and stores nothing
  float xv[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const long long b = min(bq + c, B - 1);
    xv[c] = nf::to_f32(x_t[d * x_rs + b * x_cs]);
  }
  const float t = nf::to_f32(tb[d]);

  // 0. W_eff columns [j0, j0 + kJ) of feature d -> tile buffer (j0 / kJ)
  // % 2, zero past H and P. Thread tid copies column j0 + tid: the reads
  // of a row coalesce.
  auto stage_w = [&](int j0) {
    float* dst = w_s + ((j0 / kJ) & 1) * (kJ * PP) + tid * PP;
    const bool col = j0 + tid < H;
#pragma unroll 4
    for (int p = 0; p < PP; ++p) {
      const bool in = col && p < P;
      const T* src =
          w + (in ? static_cast<long long>(p * D + d) * H + j0 + tid : 0);
      __pipeline_memcpy_async(dst + p, src, 4, in ? 0 : 4);
    }
  };
  // 1. rows [s*kR, s*kR + kR) of the warp's columns of h_t -> its ring
  // slot s % kS, then the W_eff tile they start; one commit per call, empty
  // past H. In float32 the bias and W_eff come by cp.async too, so no warp
  // waits on a load before its first stage is in flight (x and tb go to
  // registers that only 3. reads).
  const int stages = (H + kR - 1) / kR;
  auto stage_h = [&](int s) {
    if (s < stages) {
      const int j = s * kR;
      T* dst = h_w + (s % kS) * (kR * kWarpCols);
      if (quads) {
        constexpr int kV = 16 / sizeof(T);       // columns per 16 bytes
        constexpr int kQ = kWarpCols / kV;       // 16-byte chunks per row
#pragma unroll
        for (int it = 0; it < kR * kQ / 32; ++it) {
          const int e = it * 32 + lane;
          const int r = e / kQ;
          const int c = kV * (e % kQ);
          const bool in = j + r < H && bw + c < B;
          const T* src =
              h_t + (in ? static_cast<long long>(j + r) * B + bw + c : 0);
          __pipeline_memcpy_async(dst + r * kWarpCols + c, src, 16,
                                  in ? 0 : 16);
        }
      } else {
#pragma unroll 1
        for (int it = 0; it < kR * kWarpCols / 32; ++it) {
          const int e = it * 32 + lane;
          const int r = e / kWarpCols;
          const int c = e % kWarpCols;
          const bool in = j + r < H && bw + c < B;
          const T* src =
              h_t + (in ? static_cast<long long>(j + r) * B + bw + c : 0);
          __pipeline_memcpy_async(dst + r * kWarpCols + c, src, 4,
                                  in ? 0 : 4);
        }
      }
      if (j % kJ == 0) stage_w(j);
    }
    __pipeline_commit();
  };

  // 2. the head product, j ascending
  float acc[4][PH];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int p = 0; p < PH; ++p) acc[c][p] = 0.0f;
  if (tid < PP) {  // the bias, with the first stage
    const bool in = tid < P;
    const T* src = bias + (in ? tid * D + d : 0);
    __pipeline_memcpy_async(b_s + tid, src, 4, in ? 0 : 4);
  }
#pragma unroll
  for (int s = 0; s < kS - 1; ++s) stage_h(s);
  for (int s = 0; s < stages; ++s) {
    const int j = s * kR;
    __pipeline_wait_prior(kS - 2);
    // the warp's stage s is in place and its stage s - 1 slot is free; at a
    // tile's first stage every thread's copies of the tile are in place,
    // and every warp has left the tile whose buffer the next tile reuses
    if (j % kJ == 0)
      __syncthreads();
    else
      __syncwarp();
    stage_h(s + kS - 1);
    const float* ws =
        w_s + ((j / kJ) & 1) * (kJ * PP) + (j % kJ) * PP + half * PH;
    const T* hs = h_w + (s % kS) * (kR * kWarpCols) + 4 * (lane >> 1);
    if (j + kR <= H) {
#pragma unroll
      for (int u = 0; u < kR; ++u)
        fma_row<PH>(ws + u * PP, nf::load4(hs + u * kWarpCols), acc);
    } else {
      for (int u = 0; u < H - j; ++u)
        fma_row<PH>(ws + u * PP, nf::load4(hs + u * kWarpCols), acc);
    }
  }

  // 3. the pair swaps halves: this thread keeps columns 2*half and
  // 2*half + 1 of the pair's 4 and takes the other half of their
  // parameters
  float pr[2][PP];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int i = 0; i < PH; ++i) {
      const float own = half ? acc[2 + c][i] : acc[c][i];
      const float other = __shfl_xor_sync(
          0xffffffffu, half ? acc[c][i] : acc[2 + c][i], 1);
      pr[c][i] = half ? other : own;
      pr[c][PH + i] = half ? own : other;
    }
  }
  // bias and spline; the columns' chains are independent, so the compiler
  // interleaves them
  float uw[2][K], uh[2][K], ud[2][K + 1], yv[2], lv[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      uw[c][k] = pr[c][k] + b_s[k];
      uh[c][k] = pr[c][K + k] + b_s[K + k];
    }
    if (CIRCULAR) {
#pragma unroll
      for (int k = 0; k < K; ++k) ud[c][k] = pr[c][2 * K + k] + b_s[2 * K + k];
      ud[c][K] = ud[c][0];
    } else {
      ud[c][0] = edge;
      ud[c][K] = edge;
#pragma unroll
      for (int k = 0; k < K - 1; ++k)
        ud[c][k + 1] = pr[c][2 * K + k] + b_s[2 * K + k];
    }
  }
#pragma unroll
  for (int c = 0; c < 2; ++c)
    nf::rqs_element<K, INVERSE>(xv[c], t, uw[c], uh[c], ud[c], min_bin_width,
                                min_bin_height, min_derivative, yv[c], lv[c]);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const long long b = bq + c;
    if (b < B) {
      y[d * B + b] = nf::from_f32<T>(yv[c]);
      ld[d * B + b] = nf::from_f32<T>(lv[c]);
    }
  }
}

template <class T, int K, bool CIRCULAR, bool INVERSE>
int launch(const T* x_t, long long x_rs, long long x_cs, const T* h_t,
           const T* w, const T* bias, const T* tb, int D, long long B, int H,
           float edge, float mbw, float mbh, float md, T* y, T* ld,
           cudaStream_t stream) {
  constexpr int P = 2 * K + (CIRCULAR ? K : K - 1);
  constexpr size_t smem = shared_bytes<T>(padded_params(P));
  auto kernel = head_rqs_fwd_kernel<T, K, CIRCULAR, INVERSE>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies of h_t: every row starts on 16 bytes
  const bool quads = B % (16 / sizeof(T)) == 0 &&
                     reinterpret_cast<std::uintptr_t>(h_t) % 16 == 0;
  dim3 grid(static_cast<unsigned>((B + kBlockCols - 1) / kBlockCols),
            static_cast<unsigned>(D));
  kernel<<<grid, kThreads, smem, stream>>>(x_t, x_rs, x_cs, h_t, w, bias, tb,
                                           D, B, H, quads, edge, mbw, mbh,
                                           md, y, ld);
  return static_cast<int>(cudaGetLastError());
}

// The body of the float32 C entry point: see head_rqs_fwd_launch.
int dispatch(const float* x_t, long long x_rs, long long x_cs,
             const float* h_t, const float* w, const float* bias,
             const float* tb, int D, long long B, int H, int num_bins,
             int circular, int inverse, float edge, float min_bin_width,
             float min_bin_height, float min_derivative, float* y,
             float* ld, void* stream) {
  if (B == 0 || D == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NF_HEAD_LAUNCH(KK, CC, II)                                          \
  return launch<float, KK, CC, II>(x_t, x_rs, x_cs, h_t, w, bias, tb, D, B, \
                                   H, edge, min_bin_width, min_bin_height,  \
                                   min_derivative, y, ld, st)
#define NF_HEAD_CASE(KK)                                                    \
  case KK:                                                                  \
    if (circular) {                                                         \
      if (inverse) NF_HEAD_LAUNCH(KK, true, true);                          \
      NF_HEAD_LAUNCH(KK, true, false);                                      \
    }                                                                       \
    if (inverse) NF_HEAD_LAUNCH(KK, false, true);                           \
    NF_HEAD_LAUNCH(KK, false, false);
  switch (num_bins) {
    NF_HEAD_CASE(4)
    NF_HEAD_CASE(8)
    NF_HEAD_CASE(10)
  }
#undef NF_HEAD_CASE
#undef NF_HEAD_LAUNCH
  return -1;
}

// ---- bfloat16: the tensor-core kernel ------------------------------------

using nf::mma::bf16;
constexpr int kThreadsBf16 = 128;  // 4 warps of 32 columns; one per thread
constexpr int kStagesBf16 = 3;     // chunks of h_t in a warp's ring
constexpr int kMaxTileCols = 256;  // columns of H per staged W_eff tile
static_assert(kThreadsBf16 == 4 * nf::mma::kWarpCols, "a warp's columns");

// W_eff's tile width: all of H (padded) up to kMaxTileCols
__host__ __device__ inline int tile_cols_bf16(int H) {
  const int hp = nf::mma::padded_hidden(H);
  return hp < kMaxTileCols ? hp : kMaxTileCols;
}

// dynamic shared memory: the warps' rings (their column scratch after the
// product), the W_eff tile, the bias (float32)
__host__ __device__ inline size_t shared_bytes_bf16(int pm, int wj) {
  return sizeof(bf16) * (static_cast<size_t>(kThreadsBf16 / 32) *
                             kStagesBf16 * nf::mma::kRK * nf::mma::kRowW +
                         static_cast<size_t>(pm) * (wj + nf::mma::kPad)) +
         sizeof(float) * pm;
}

template <int K, bool CIRCULAR, bool INVERSE>
__global__ void __launch_bounds__(kThreadsBf16, 4) head_rqs_fwd_bf16_kernel(
    const bf16* __restrict__ x_t, long long x_rs, long long x_cs,
    const bf16* __restrict__ h_t, const bf16* __restrict__ w,
    const bf16* __restrict__ bias, const bf16* __restrict__ tb, int D,
    long long B, int H, int wj, bool hquads, bool wquads, float edge,
    float min_bin_width, float min_bin_height, float min_derivative,
    bf16* __restrict__ y, bf16* __restrict__ ld) {
  // block-scope names of head_mma_bf16.cuh: they hide this file's float32
  // layout (kWarpCols there is 64)
  using nf::mma::column_params;
  using nf::mma::head_product_rows;
  using nf::mma::kPad;
  using nf::mma::kRK;
  using nf::mma::kRowW;
  using nf::mma::kWarpCols;
  using nf::mma::padded_hidden;
  using nf::mma::param_rows;
  using nf::mma::stage_h_warp;
  using nf::mma::stage_w_rows;
  constexpr int ND = CIRCULAR ? K : K - 1;
  constexpr int P = 2 * K + ND;
  constexpr int PM = param_rows(P);
  constexpr int MT = PM / 16;
  constexpr int kRing = kStagesBf16 * kRK * kRowW;  // one warp's ring
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // [warps][kRing]
  bf16* w_s = ring + (kThreadsBf16 / 32) * kRing;  // [PM][wj + kPad]
  float* b_s = reinterpret_cast<float*>(w_s + PM * (wj + kPad));  // [PM]
  const int ws = wj + kPad;

  const int d = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long bw =
      static_cast<long long>(blockIdx.x) * kThreadsBf16 + warp * kWarpCols;
  const long long b = bw + lane;
  bf16* ring_w = ring + warp * kRing;
  const int chunks = padded_hidden(H) / kRK;

  // 0. W_eff's first tile (its own commit group, the oldest)
  stage_w_rows(w_s, ws, w, D, d, 1, P, PM, H, 0, wj, wquads, tid,
               kThreadsBf16);
  __pipeline_commit();
  // 1. chunk s of the warp's columns of h_t -> ring slot s % kStagesBf16;
  // one commit per call, empty past H
  auto stage = [&](int s) {
    if (s < chunks)
      stage_h_warp(ring_w + (s % kStagesBf16) * (kRK * kRowW), kRowW, h_t, B,
                   H, s * kRK, bw, hquads, lane);
    __pipeline_commit();
  };
#pragma unroll
  for (int s = 0; s < kStagesBf16 - 1; ++s) stage(s);
  // the spline's operands (a column past B reads column B - 1 and stores
  // nothing) and the bias, while the copies are in flight
  const long long bc = b < B ? b : B - 1;
  const float xv = nf::to_f32(x_t[d * x_rs + bc * x_cs]);
  const float t = nf::to_f32(tb[d]);
  if (tid < PM) b_s[tid] = tid < P ? nf::to_f32(bias[tid * D + d]) : 0.0f;

  // 2. the head product, chunk by chunk (head_mma_bf16.cuh)
  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
  for (int s = 0; s < chunks; ++s) {
    const int j0 = s * kRK;
    if (j0 > 0 && j0 % wj == 0) {  // the next W_eff tile (H > kMaxTileCols)
      __syncthreads();
      stage_w_rows(w_s, ws, w, D, d, 1, P, PM, H, j0, wj, wquads, tid,
                   kThreadsBf16);
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
    }
    // the warp's chunk s (and W_eff's first tile) is in place, and the slot
    // of chunk s - 1 is free
    __pipeline_wait_prior(kStagesBf16 - 2);
    if (s == 0)
      __syncthreads();  // every thread's share of the tile, and the bias
    else
      __syncwarp();
    stage(s + kStagesBf16 - 1);
    head_product_rows<MT>(w_s + j0 % wj, ws,
                          ring_w + (s % kStagesBf16) * (kRK * kRowW), kRowW,
                          lane, acc);
  }
  __pipeline_wait_prior(0);
  __syncwarp();

  // 3. this lane's column: its PM sums (through the warp's ring), + bias,
  // the spline, y and ld rounded once
  float pv[PM];
  column_params<MT>(acc, reinterpret_cast<float*>(ring_w), lane, pv);
  float uw[K], uh[K], ud[K + 1];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    uw[k] = pv[k] + b_s[k];
    uh[k] = pv[K + k] + b_s[K + k];
  }
  if (CIRCULAR) {
#pragma unroll
    for (int k = 0; k < K; ++k) ud[k] = pv[2 * K + k] + b_s[2 * K + k];
    ud[K] = ud[0];
  } else {
    ud[0] = edge;
    ud[K] = edge;
#pragma unroll
    for (int k = 0; k < K - 1; ++k) ud[k + 1] = pv[2 * K + k] + b_s[2 * K + k];
  }
  float yv, lv;
  nf::rqs_element<K, INVERSE>(xv, t, uw, uh, ud, min_bin_width,
                              min_bin_height, min_derivative, yv, lv);
  if (b < B) {
    y[d * B + b] = nf::from_f32<bf16>(yv);
    ld[d * B + b] = nf::from_f32<bf16>(lv);
  }
}

template <int K, bool CIRCULAR, bool INVERSE>
int launch_bf16(const bf16* x_t, long long x_rs, long long x_cs,
                const bf16* h_t, const bf16* w, const bf16* bias,
                const bf16* tb, int D, long long B, int H, float edge,
                float mbw, float mbh, float md, bf16* y, bf16* ld,
                cudaStream_t stream) {
  constexpr int P = 2 * K + (CIRCULAR ? K : K - 1);
  const int wj = tile_cols_bf16(H);
  const size_t smem = shared_bytes_bf16(nf::mma::param_rows(P), wj);
  auto kernel = head_rqs_fwd_bf16_kernel<K, CIRCULAR, INVERSE>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool hquads =
      B % 8 == 0 && reinterpret_cast<std::uintptr_t>(h_t) % 16 == 0;
  const bool wquads =
      H % 8 == 0 && reinterpret_cast<std::uintptr_t>(w) % 16 == 0;
  dim3 grid(static_cast<unsigned>((B + kThreadsBf16 - 1) / kThreadsBf16),
            static_cast<unsigned>(D));
  kernel<<<grid, kThreadsBf16, smem, stream>>>(
      x_t, x_rs, x_cs, h_t, w, bias, tb, D, B, H, wj, hquads, wquads, edge,
      mbw, mbh, md, y, ld);
  return static_cast<int>(cudaGetLastError());
}

// The body of the bfloat16 C entry point: see head_rqs_fwd_launch_bf16.
int dispatch_bf16(const bf16* x_t, long long x_rs, long long x_cs,
                  const bf16* h_t, const bf16* w, const bf16* bias,
                  const bf16* tb, int D, long long B, int H, int num_bins,
                  int circular, int inverse, float edge, float min_bin_width,
                  float min_bin_height, float min_derivative, bf16* y,
                  bf16* ld, void* stream) {
  if (B == 0 || D == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NF_HEAD_LAUNCH(KK, CC, II)                                          \
  return launch_bf16<KK, CC, II>(x_t, x_rs, x_cs, h_t, w, bias, tb, D, B,   \
                                 H, edge, min_bin_width, min_bin_height,    \
                                 min_derivative, y, ld, st)
#define NF_HEAD_CASE(KK)                                                    \
  case KK:                                                                  \
    if (circular) {                                                         \
      if (inverse) NF_HEAD_LAUNCH(KK, true, true);                          \
      NF_HEAD_LAUNCH(KK, true, false);                                      \
    }                                                                       \
    if (inverse) NF_HEAD_LAUNCH(KK, false, true);                           \
    NF_HEAD_LAUNCH(KK, false, false);
  switch (num_bins) {
    NF_HEAD_CASE(4)
    NF_HEAD_CASE(8)
    NF_HEAD_CASE(10)
  }
#undef NF_HEAD_CASE
#undef NF_HEAD_LAUNCH
  return -1;
}

}  // namespace

// C interface for ctypes. x_t (D, B) with strides (x_rs, x_cs); h_t (H, B),
// w (P*D, H), bias (P*D,), tb (D,) contiguous; y, ld (D, B) contiguous.
// `edge` is the linear-tail derivative logit log(exp(1 - min_d) - 1).
// Returns the CUDA error of the launch (0 if none); -1 for a bin count that
// has no instantiation.
extern "C" int head_rqs_fwd_launch(
    const float* x_t, long long x_rs, long long x_cs, const float* h_t,
    const float* w, const float* bias, const float* tb, int D, long long B,
    int H, int num_bins, int circular, int inverse, float edge,
    float min_bin_width, float min_bin_height, float min_derivative,
    float* y, float* ld, void* stream) {
  return dispatch(x_t, x_rs, x_cs, h_t, w, bias, tb, D, B, H, num_bins,
                  circular, inverse, edge, min_bin_width, min_bin_height,
                  min_derivative, y, ld, stream);
}

// The same with every operand and output in bfloat16 (edge and the minima
// stay float).
extern "C" int head_rqs_fwd_launch_bf16(
    const __nv_bfloat16* x_t, long long x_rs, long long x_cs,
    const __nv_bfloat16* h_t, const __nv_bfloat16* w,
    const __nv_bfloat16* bias, const __nv_bfloat16* tb, int D, long long B,
    int H, int num_bins, int circular, int inverse, float edge,
    float min_bin_width, float min_bin_height, float min_derivative,
    __nv_bfloat16* y, __nv_bfloat16* ld, void* stream) {
  return dispatch_bf16(x_t, x_rs, x_cs, h_t, w, bias, tb, D, B, H, num_bins,
                       circular, inverse, edge, min_bin_width,
                       min_bin_height, min_derivative, y, ld, stream);
}
