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
// Bound on the H100: per batch column it reads h_t once (H floats) and
// writes gh (H floats); 2*M*H flops each for the recompute, gh and gW.
// At D = 1, H = 128, K = 8 (M = 23): 1 KB against ~17.7 kflop per column,
// ~17 flop/byte, just under the f32 CUDA-core ridge (67 TFLOP/s over
// 3.35 TB/s = 20). So the products must run near the FMA rate, and that is
// set by shared memory: an SM issues 4 warp-wide FMAs per clock, and a
// warp's 16-byte-per-lane load from shared memory takes it more than one
// clock even when every lane reads the same address. Every load below
// feeds at least 4 FMAs, and the products with the most FMAs feed 8 or
// more.
//
// Design. A block owns kThreads consecutive batch columns b and every
// feature d of them (M = P*D head rows, P = 2K+nd), f32 on CUDA cores with
// explicit fmaf.
//   0. W_eff is staged in shared memory once, transposed and padded to
//      w_s[j][d][PP] (PP = P rounded up to 4), so the P weights one column
//      j gives feature d come in PP/4 float4 loads that the whole warp
//      shares. Above kJ columns of H it is staged kJ at a time.
//   1. For each d, each thread recomputes its column's P parameter sums in
//      registers: j ascending from 0, fmaf(w, h, acc), then + bias, the
//      order of kernel B (head_rqs_fwd.cu), so the parameters are the same
//      bits as B's. Then the per-element backward; gx is written, and the P
//      cotangents go to the block's gp tile ([M][kThreads + 4] in shared
//      memory, M rounded up to 24; the gparams never reach device
//      memory).
//   2. gb: one warp per head row sums its kThreads values (8 per lane in
//      order, then a fixed xor-shuffle tree).
//   3. gW = gp @ h_t^T over the block's columns as a register-tiled
//      product: a warp owns 24 x 32 outputs (4 x 8 lanes, each 6 x 4),
//      h_t arrives by cp.async kChunk columns at a time (h_s [H][kChunk +
//      4], H rounded up to 32; two buffers where they fit, the next chunk
//      in flight while one is multiplied; 16-byte copies when every row
//      of h_t starts on 16 bytes, else 4-byte ones),
//      and per 4 columns a thread reads 6 float4 of gp and
//      4 of h_s for 96 FMAs. The pads keep the reads free of bank conflicts
//      (row strides of 260 and 36 floats). Each output sums the columns in
//      order.
//   4. gh[:, b] = W_eff^T @ gp[:, b] with the weights as float4 broadcasts.
// At D = 1 and H <= kJ (build_nsf's couplings) phases 3 and 4 run at once:
// warps 0-3 take gW under their own barrier, while warps 4-7 take gh for
// two columns each (their own, whose cotangents are still in registers,
// and one of warps 0-3's), so each weight load feeds 8 FMAs and gh's
// stores drain while gW multiplies; W_eff and h_s then have separate
// shared memory. Otherwise all warps take gh, then gW (h_s reuses w_s).
// Blocks write their gW and gb partials to a (blocks, M*(H+1)) workspace;
// a second launch (reduce_partials) sums it over the blocks in a fixed
// order: the gradients are the same bits from run to run, which atomics
// would not give.
//
// Built with -DNF_BINS=K, the file instantiates kernel E for that bin
// count alone (ops/_build.py builds the three counts as three libraries,
// in parallel); without it, for every supported count.
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "rqs_bwd_math.cuh"

namespace {

constexpr int kThreads = 256;  // threads per block = batch columns per block
constexpr int kColPad = 4;     // pad of a gp row (stride 260 floats)
constexpr int kJ = 128;        // columns of H per staged W_eff tile
constexpr int kG = 16;         // rows of gh a thread holds per step
constexpr int kG2 = 8;         // the same for each of two columns
constexpr int kChunk = 32;     // batch columns of h_t staged per gW step
constexpr int kRowPad = 4;     // pad of an h_s row (stride 36 floats)
constexpr int kMaxSharedBytes = 232448;  // what a block may opt into
constexpr int kWarps = kThreads / 32;
constexpr int kGpStride = kThreads + kColPad;
constexpr int kHStride = kChunk + kRowPad;
constexpr int kTileM = 24;  // gW warp tile: 4 lanes x 6 rows of gW
constexpr int kTileJ = 32;  // by 8 lanes x 4 columns
static_assert(kChunk == 32, "a warp stages one h_t row of a chunk");
static_assert(kG % kG2 == 0, "w_s rows cover the split gh steps");
static_assert(kThreads / 2 == 128, "gw_sync's bar.sync counts 128 threads");

__host__ __device__ constexpr int padded_params(int p) {
  return (p + 3) / 4 * 4;
}

// rows of a staged W_eff tile: H rounded up to kG, at most kJ
__host__ __device__ inline int w_rows(int H) {
  const int r = (H + kG - 1) / kG * kG;
  return r < kJ ? r : kJ;
}

// phases 3 and 4 at once, on separate warps
__host__ __device__ inline bool split_warps(int D, int H) {
  return D == 1 && H <= kJ;
}

// rows of gp and of an h_t chunk, M and H rounded up to gW's warp tile:
// the tile reads them unclamped, and the rows past M and H only reach
// outputs that are not written
__host__ __device__ inline int gp_rows(int M) {
  return (M + kTileM - 1) / kTileM * kTileM;
}
__host__ __device__ inline int h_rows(int H) {
  return (H + kTileJ - 1) / kTileJ * kTileJ;
}

// gp, then W_eff's tile and nbuf h_t chunks: side by side when the warps
// split, else sharing one region (W_eff in phases 0-1 and 4, h_t in 3)
__host__ __device__ inline size_t shared_floats(int P, int D, int H,
                                                int nbuf) {
  const size_t w = static_cast<size_t>(w_rows(H)) * D * padded_params(P);
  const size_t h = static_cast<size_t>(nbuf) * h_rows(H) * kHStride;
  const size_t rest = split_warps(D, H) ? w + h : (w > h ? w : h);
  return static_cast<size_t>(gp_rows(P * D)) * kGpStride + rest;
}

// two h_t chunk buffers where they fit, else one
__host__ __device__ inline int h_buffers(int P, int D, int H) {
  return shared_floats(P, D, H, 2) * sizeof(float) <= kMaxSharedBytes ? 2
                                                                      : 1;
}

// the barrier of the warps that run phase 3: all of them, or warps 0-3
template <bool ALL>
__device__ __forceinline__ void gw_sync() {
  if (ALL) {
    __syncthreads();
  } else {
    asm volatile("bar.sync 1, 128;" ::: "memory");
  }
}

// Phase 3 on NW warps (wi = warp index among them): this block's share of
// gW = gp @ h_t^T, one 24 x 32 warp tile per pass; lane (mg, jg) owns rows
// m0 + 4r and columns j0 + 8s (r < 6, s < 4).
// quads: every row of h_t starts on 16 bytes, so a chunk's row is staged
// in 16-byte copies.
template <int NW, bool ALL>
__device__ void gw_product(const float* gp, float* h_s, int nbuf,
                           const float* __restrict__ h_t, long long B,
                           bool quads, long long b0, int M, int H,
                           float* __restrict__ out, int wi, int lane) {
  constexpr int kChunks = kThreads / kChunk;
  const int ti = wi * 32 + lane;
  const int mtiles = (M + kTileM - 1) / kTileM;
  const int tiles = mtiles * ((H + kTileJ - 1) / kTileJ);
  const int jg = lane & 7;
  const int mg = lane >> 3;
  auto stage_h = [&](int k) {  // chunk k -> buffer k % nbuf, zero past B
    float* buf = h_s + (k % nbuf) * (h_rows(H) * kHStride);
    if (quads) {  // 8 threads copy a row's 32 columns
      const int c = 4 * (ti & 7);
      const long long bb = b0 + k * kChunk + c;
      const bool in = bb < B;
      const float* src = h_t + (in ? bb : 0);
      for (int j = ti >> 3; j < H; j += 4 * NW)
        __pipeline_memcpy_async(buf + j * kHStride + c,
                                src + static_cast<long long>(j) * B, 16,
                                in ? 0 : 16);
    } else {  // a warp copies a row
      const long long bb = b0 + k * kChunk + lane;
      const bool in = bb < B;
      const float* src = h_t + (in ? bb : 0);
      for (int j = wi; j < H; j += NW)
        __pipeline_memcpy_async(buf + j * kHStride + lane,
                                src + static_cast<long long>(j) * B, 4,
                                in ? 0 : 4);
    }
    __pipeline_commit();
  };
  for (int pass = 0; pass * NW < tiles; ++pass) {
    const int wt = pass * NW + wi;
    const bool busy = wt < tiles;
    const int m0 = (wt % mtiles) * kTileM + mg;
    const int j0 = (wt / mtiles) * kTileJ + jg;
    float acc[6][4];
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[r][s] = 0.0f;
    gw_sync<ALL>();  // the last readers of these buffers are done
    stage_h(0);
    for (int k = 0; k < kChunks; ++k) {
      if (nbuf == 2 && k + 1 < kChunks) {
        stage_h(k + 1);  // into the buffer chunk k - 1 left
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      gw_sync<ALL>();  // chunk k is in place
      if (busy) {
        const float* hb =
            h_s + ((k % nbuf) * h_rows(H) + j0) * kHStride;
        const float* gk = gp + m0 * kGpStride + k * kChunk;
#pragma unroll 1
        for (int c = 0; c < kChunk; c += 4) {
          float4 gv[6], hv[4];
#pragma unroll
          for (int r = 0; r < 6; ++r)
            gv[r] = *reinterpret_cast<const float4*>(gk + 4 * r * kGpStride
                                                     + c);
#pragma unroll
          for (int s = 0; s < 4; ++s)
            hv[s] = *reinterpret_cast<const float4*>(hb + 8 * s * kHStride
                                                     + c);
#pragma unroll
          for (int r = 0; r < 6; ++r)
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              acc[r][s] = fmaf(gv[r].x, hv[s].x, acc[r][s]);
              acc[r][s] = fmaf(gv[r].y, hv[s].y, acc[r][s]);
              acc[r][s] = fmaf(gv[r].z, hv[s].z, acc[r][s]);
              acc[r][s] = fmaf(gv[r].w, hv[s].w, acc[r][s]);
            }
        }
      }
      gw_sync<ALL>();  // chunk k's readers are done with its buffer
      if (nbuf == 1 && k + 1 < kChunks) stage_h(k + 1);
    }
    if (busy) {
#pragma unroll
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int m = m0 + 4 * r;
          const int j = j0 + 8 * s;
          if (m < M && j < H) out[m * H + j] = acc[r][s];
        }
    }
  }
}

// ONE: D == 1, known when compiled, so that the cotangents of phase 1 stay
// in registers for phase 4 without a loop carrying them over features.
template <int K, bool CIRCULAR, bool INVERSE, bool ONE>
__global__ void __launch_bounds__(kThreads, 2) head_rqs_bwd_kernel(
    const float* __restrict__ x_t, long long x_rs, long long x_cs,
    const float* __restrict__ h_t, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ tb,
    const float* __restrict__ cty, long long cty_rs, long long cty_cs,
    const float* __restrict__ ctl, long long ctl_rs, long long ctl_cs,
    int feats, long long B, int H, bool quads, float edge,
    float min_bin_width, float min_bin_height, float min_derivative,
    float* __restrict__ gx, float* __restrict__ gh,
    float* __restrict__ partials) {
  constexpr int ND = CIRCULAR ? K : K - 1;
  constexpr int P = 2 * K + ND;
  constexpr int PP = padded_params(P);
  const int D = ONE ? 1 : feats;
  const int M = P * D;
  const int wrows = w_rows(H);
  const int ntiles = (H + kJ - 1) / kJ;
  extern __shared__ __align__(16) float smem[];
  float* gp = smem;                  // [gp_rows][kGpStride]
  float* w_s = gp + gp_rows(M) * kGpStride;  // [wrows][D][PP]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long b0 = static_cast<long long>(blockIdx.x) * kThreads;
  const long long b = b0 + tid;
  const bool active = b < B;

  // 0. W_eff columns [t*kJ, t*kJ + wrows) -> w_s, zero past H and P. The
  // element order puts consecutive j on consecutive threads, so the reads
  // of a W_eff row are coalesced.
  auto stage_w = [&](int t) {
    const int j0 = t * kJ;
    const int n = wrows * D * PP;
    for (int e = tid; e < n; e += kThreads) {
      const int j = e % wrows;
      const int pd = e / wrows;
      const int d = pd % D;
      const int p = pd / D;
      const int jj = j0 + j;
      w_s[(j * D + d) * PP + p] =
          (p < P && jj < H) ? w[static_cast<long long>(p * D + d) * H + jj]
                            : 0.0f;
    }
  };
  int staged = 0;  // the tile w_s holds (the same on every thread)
  auto ensure_tile = [&](int t) {
    if (t == staged) return;
    __syncthreads();
    stage_w(t);
    __syncthreads();
    staged = t;
  };
  stage_w(0);
  __syncthreads();

  // 1. recompute + per-element backward, one feature at a time
  float g[PP];  // when ONE, the cotangents phase 4 takes from registers
#pragma unroll
  for (int p = 0; p < PP; ++p) g[p] = 0.0f;
  for (int d = 0; d < D; ++d) {
    float acc[PP];
#pragma unroll
    for (int p = 0; p < PP; ++p) acc[p] = 0.0f;
    for (int t = 0; t < ntiles; ++t) {
      ensure_tile(t);
      if (active) {
        const int rows = min(kJ, H - t * kJ);
        const float* hp = h_t + static_cast<long long>(t * kJ) * B + b;
        const float4* wq = reinterpret_cast<const float4*>(w_s + d * PP);
        const int wstep = D * PP / 4;  // float4s from one j to the next
#pragma unroll 8
        for (int j = 0; j < rows; ++j) {
          const float hv = *hp;
          hp += B;
#pragma unroll
          for (int q = 0; q < PP / 4; ++q) {
            const float4 wv = wq[q];
            acc[4 * q] = fmaf(wv.x, hv, acc[4 * q]);
            acc[4 * q + 1] = fmaf(wv.y, hv, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(wv.z, hv, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(wv.w, hv, acc[4 * q + 3]);
          }
          wq += wstep;
        }
      }
    }
    float c[P];  // an inactive column keeps 0: no share in gW or gb
#pragma unroll
    for (int p = 0; p < P; ++p) c[p] = 0.0f;
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
        c[k] = gwv[k];
        c[K + k] = ghv[k];
      }
      if (CIRCULAR) {
        c[2 * K] = gdv[0] + gdv[K];
#pragma unroll
        for (int k = 1; k < K; ++k) c[2 * K + k] = gdv[k];
      } else {
#pragma unroll
        for (int k = 0; k < K - 1; ++k) c[2 * K + k] = gdv[k + 1];
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      gp[(p * D + d) * kGpStride + tid] = c[p];
      if (ONE) g[p] = c[p];
    }
  }
  __syncthreads();  // every column's gp is in place
  const bool split = ONE && split_warps(D, H);
  const int nbuf = h_buffers(P, D, H);
  float* h_s = split ? w_s + wrows * D * PP : w_s;  // [nbuf][h_rows][36]

  // 2. this block's share of gb = sum_b gp
  const int MH = M * H;
  float* out = partials + static_cast<long long>(blockIdx.x) * (MH + M);
  for (int m = warp; m < M; m += kWarps) {
    const float* row = gp + m * kGpStride;
    float s = row[lane];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) s += row[lane + 32 * i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) out[MH + m] = s;
  }

  if constexpr (ONE) {
    if (split) {
      // 3 and 4 at once: gW on warps 0-3; gh on warps 4-7, each thread for
      // its column b (g in registers) and column b - 128 (from gp). w_s
      // holds all of W_eff (H <= kJ) and stays.
      if (warp < kWarps / 2) {
        gw_product<kWarps / 2, false>(gp, h_s, nbuf, h_t, B, quads, b0, M,
                                      H, out, warp, lane);
        return;
      }
      const int t2 = tid - kThreads / 2;
      const bool active2 = b0 + t2 < B;
      float g2[PP];
#pragma unroll
      for (int p = 0; p < PP; ++p)
        g2[p] = (p < P) ? gp[p * kGpStride + t2] : 0.0f;
      for (int js = 0; js < H; js += kG2) {
        float s[kG2], s2[kG2];
#pragma unroll
        for (int i = 0; i < kG2; ++i) s[i] = s2[i] = 0.0f;
        const float4* wq = reinterpret_cast<const float4*>(w_s + js * PP);
#pragma unroll
        for (int i = 0; i < kG2; ++i) {
#pragma unroll
          for (int q = 0; q < PP / 4; ++q) {
            const float4 wv = wq[i * (PP / 4) + q];
            s[i] = fmaf(wv.x, g[4 * q], s[i]);
            s[i] = fmaf(wv.y, g[4 * q + 1], s[i]);
            s[i] = fmaf(wv.z, g[4 * q + 2], s[i]);
            s[i] = fmaf(wv.w, g[4 * q + 3], s[i]);
            s2[i] = fmaf(wv.x, g2[4 * q], s2[i]);
            s2[i] = fmaf(wv.y, g2[4 * q + 1], s2[i]);
            s2[i] = fmaf(wv.z, g2[4 * q + 2], s2[i]);
            s2[i] = fmaf(wv.w, g2[4 * q + 3], s2[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < kG2; ++i) {
          if (js + i < H) {
            float* row = gh + static_cast<long long>(js + i) * B + b0;
            if (active) row[tid] = s[i];
            if (active2) row[t2] = s2[i];
          }
        }
      }
      return;
    }
  }

  // 4. gh[:, b] = W_eff^T @ gp[:, b] on every warp
  for (int t = 0; t < ntiles; ++t) {
    ensure_tile(t);
    const int j0 = t * kJ;
    const int rows = min(kJ, H - j0);
    for (int js = 0; js < rows; js += kG) {
      float s[kG];
#pragma unroll
      for (int i = 0; i < kG; ++i) s[i] = 0.0f;
      for (int d = 0; d < D; ++d) {
        float gd[PP];
#pragma unroll
        for (int p = 0; p < PP; ++p)
          gd[p] = (ONE || p >= P) ? g[p]
                                  : gp[(p * D + d) * kGpStride + tid];
        const float4* wq =
            reinterpret_cast<const float4*>(w_s + (js * D + d) * PP);
#pragma unroll
        for (int i = 0; i < kG; ++i) {
#pragma unroll
          for (int q = 0; q < PP / 4; ++q) {
            const float4 wv = wq[i * (D * PP / 4) + q];
            s[i] = fmaf(wv.x, gd[4 * q], s[i]);
            s[i] = fmaf(wv.y, gd[4 * q + 1], s[i]);
            s[i] = fmaf(wv.z, gd[4 * q + 2], s[i]);
            s[i] = fmaf(wv.w, gd[4 * q + 3], s[i]);
          }
        }
      }
      if (active) {
#pragma unroll
        for (int i = 0; i < kG; ++i)
          if (js + i < rows)
            gh[static_cast<long long>(j0 + js + i) * B + b] = s[i];
      }
    }
  }

  // 3. gW on every warp; h_s reuses w_s once gh is done with it
  gw_product<kWarps, true>(gp, h_s, nbuf, h_t, B, quads, b0, M, H, out, warp,
                           lane);
}

// Sum the blocks' (MH + M)-wide partial rows in a fixed order: 32 outputs
// per block, 32 rows of threads each summing every 32nd partial in turn
// (their loads issued together), then row 0 adds the 32 sums in order.
// gW takes outputs [0, MH), gb the rest.
__global__ void __launch_bounds__(1024) reduce_partials(
    const float* __restrict__ partials, int blocks, int MH, int M,
    float* __restrict__ gw, float* __restrict__ gb) {
  __shared__ float part[32][33];
  const int width = MH + M;
  const int o = blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (o < width) {
#pragma unroll 8
    for (int k = threadIdx.y; k < blocks; k += 32)
      s += partials[static_cast<long long>(k) * width + o];
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && o < width) {
    float t = part[0][threadIdx.x];
#pragma unroll
    for (int y = 1; y < 32; ++y) t += part[y][threadIdx.x];
    if (o < MH)
      gw[o] = t;
    else
      gb[o - MH] = t;
  }
}

template <int K, bool CIRCULAR, bool INVERSE, bool ONE>
int launch(const float* x_t, long long x_rs, long long x_cs,
           const float* h_t, const float* w, const float* bias,
           const float* tb, const float* cty, long long cty_rs,
           long long cty_cs, const float* ctl, long long ctl_rs,
           long long ctl_cs, int D, long long B, int H, float edge,
           float mbw, float mbh, float md, float* gx, float* gh,
           float* partials, cudaStream_t stream) {
  constexpr int P = 2 * K + (CIRCULAR ? K : K - 1);
  const size_t smem =
      sizeof(float) * shared_floats(P, D, H, h_buffers(P, D, H));
  auto kernel = head_rqs_bwd_kernel<K, CIRCULAR, INVERSE, ONE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  const bool quads =
      B % 4 == 0 && reinterpret_cast<std::uintptr_t>(h_t) % 16 == 0;
  kernel<<<blocks, kThreads, smem, stream>>>(
      x_t, x_rs, x_cs, h_t, w, bias, tb, cty, cty_rs, cty_cs, ctl, ctl_rs,
      ctl_cs, D, B, H, quads, edge, mbw, mbh, md, gx, gh, partials);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface for ctypes. x_t, cty, ctl (D, B) with their (row, column)
// strides; h_t (H, B), w (M, H), bias (M,), tb (D,) contiguous; gx (D, B),
// gh (H, B), gw (M, H), gb (M,) contiguous outputs; partials a contiguous
// workspace of ceil(B / 256) * M * (H + 1) floats. `edge` is the
// linear-tail derivative logit log(exp(1 - min_d) - 1). The wrapper checks
// the block's shared memory (ops/spline_head_fused.py,
// kernel_e_shared_bytes, the same sum as shared_floats above) before it
// calls. Returns the first CUDA error of the two launches (0 if none); -1
// for a bin count that has no instantiation in this build.
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
  err = (D == 1 ? launch<KK, CC, II, true> : launch<KK, CC, II, false>)(    \
      x_t, x_rs, x_cs, h_t, w, bias, tb, cty, cty_rs, cty_cs, ctl, ctl_rs,  \
      ctl_cs, D, B, H, edge, min_bin_width, min_bin_height, min_derivative, \
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
#if !defined(NF_BINS) || NF_BINS == 4
    NF_HEAD_BWD_CASE(4)
#endif
#if !defined(NF_BINS) || NF_BINS == 8
    NF_HEAD_BWD_CASE(8)
#endif
#if !defined(NF_BINS) || NF_BINS == 10
    NF_HEAD_BWD_CASE(10)
#endif
    default:
      return -1;
  }
#undef NF_HEAD_BWD_CASE
#undef NF_HEAD_BWD_LAUNCH
  if (err != 0) return err;
  const int width = M * H + M;
  reduce_partials<<<(width + 31) / 32, dim3(32, 32), 0, st>>>(
      partials, blocks, M * H, M, gw, gb);
  return static_cast<int>(cudaGetLastError());
}
