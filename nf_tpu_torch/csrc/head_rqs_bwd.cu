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
//
// bfloat16 (head_rqs_bwd_launch_bf16: the coupled layers built with
// dtype=bfloat16) has a kernel of its own, head_rqs_bwd_bf16_kernel below;
// the template above serves float32 alone. Its bound on the H100: reading
// h_t and writing gh, 2 bytes an element; its three products (~6 GFLOP at
// H 512, K 10, B = 65536) run on the tensor cores in ~6 us against a byte
// bound of 40 us. Design: a block of W = 8 warps (4 where the layout does
// not fit in 227 KB: many features) owns 32 W columns of every feature, a
// warp 32, a thread one (plan_bf16 picks W and the W_eff tile width;
// ops/spline_head_fused.py kernel_e_bf16_plan is its twin, and raises
// where no layout fits).
//   0. W_eff's rows for every feature, [d*PM + p][j] (P padded to PM, a
//      multiple of 16; H to 32) as bfloat16 by 16-byte cp.async copies,
//      all of H where it fits, else in tiles staged again at the tile.
//   1. Per feature: kernel B's head product, head_product_rows over the
//      warp's ring of 3 chunks of h_t, in B's order and fragments, so the
//      parameters are B's bit for bit; + bias, rqs_bwd_element; gx out. The
//      float32 cotangents gp go to shared memory as two bfloat16 planes,
//      gp_hi = bf16(gp) and gp_lo = bf16(gp - gp_hi) (split_bf16_pair): the
//      products below see ~16 bits of gp, where JAX's bfloat16 scratch
//      (spline_head_fused.py:258) holds 8. gb's share: a fixed xor-shuffle
//      tree per warp, the warps in order.
//   2. gh[:, warp's columns] = W_eff^T gp_hi + W_eff^T gp_lo, 16 rows of H
//      at a time (W_eff^T and gp by ldmatrix.trans), summed in float32,
//      rounded through the warp's scratch and stored in 16-byte pieces.
//   3. gW = gp_hi h_t^T + gp_lo h_t^T over the block's columns, warp tiles
//      of 16 head rows x 32 rows of H, from chunks of 8 W rows of h_t
//      staged again (two buffers, the first in flight during 2): h_t is read
//      twice at every H, the second time mostly from L2 (holding a block's
//      h_t tile for gW measured slower: it halves the blocks an SM holds).
// The gW/gb partials stay float32, one row per block, and reduce_partials
// sums them in a fixed order and rounds once: two calls are bitwise equal.
// What is left above the bound (PERF.md): gh's 2-byte stores and their
// phase (dropping it saves 7 us at H 128, 38 at H 512), the second launch
// and the partials it reads (4.6 / 13.6 us at 4 warps a block), the
// flush's dirty lines. Tests: tests/test_torch_head_bf16_mma.py on the CPU
// (the split, the planner); on the card python -m pytest --noconftest -p
// no:cacheprovider tests/test_torch_cuda.py -k bf16, which holds gx, gh,
// gW and gb against head_rqs_bwd_plain on the kernel's own head sums
// (head_params_bf16.cu).
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "head_mma_bf16.cuh"
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
constexpr int kTileM = 24;  // gW warp tile: 4 lanes x 6 rows of gW
constexpr int kTileJ = 32;  // by 8 lanes x 4 columns
static_assert(kChunk == 32, "a warp stages one h_t row of a chunk");
static_assert(kG % kG2 == 0, "w_s rows cover the split gh steps");
static_assert(kThreads / 2 == 128, "gw_sync's bar.sync counts 128 threads");

// the row stride of a staged h_t chunk: 32 columns and a pad that keeps
// the gW product's reads free of bank conflicts and every row on 16 bytes
template <class T>
__host__ __device__ constexpr int h_stride() {
  return kChunk + kRowPad;
}

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

// gp and W_eff's tile (float32), then nbuf h_t chunks (T): the tile and
// the chunks side by side when the warps split, else sharing one region
// (W_eff in phases 0-1 and 4, h_t in 3)
template <class T>
__host__ __device__ inline size_t shared_bytes(int P, int D, int H,
                                               int nbuf) {
  const size_t w =
      sizeof(float) * static_cast<size_t>(w_rows(H)) * D * padded_params(P);
  const size_t h =
      sizeof(T) * static_cast<size_t>(nbuf) * h_rows(H) * h_stride<T>();
  const size_t rest = split_warps(D, H) ? w + h : (w > h ? w : h);
  return sizeof(float) * static_cast<size_t>(gp_rows(P * D)) * kGpStride
         + rest;
}

// two h_t chunk buffers where they fit, else one
template <class T>
__host__ __device__ inline int h_buffers(int P, int D, int H) {
  return shared_bytes<T>(P, D, H, 2) <= kMaxSharedBytes ? 2 : 1;
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
template <class T, int NW, bool ALL>
__device__ void gw_product(const float* gp, T* h_s, int nbuf,
                           const T* __restrict__ h_t, long long B,
                           bool quads, long long b0, int M, int H,
                           float* __restrict__ out, int wi, int lane) {
  constexpr int kChunks = kThreads / kChunk;
  constexpr int kHS = h_stride<T>();
  const int ti = wi * 32 + lane;
  const int mtiles = (M + kTileM - 1) / kTileM;
  const int tiles = mtiles * ((H + kTileJ - 1) / kTileJ);
  const int jg = lane & 7;
  const int mg = lane >> 3;
  auto stage_h = [&](int k) {  // chunk k -> buffer k % nbuf, zero past B
    T* buf = h_s + (k % nbuf) * (h_rows(H) * kHS);
    if (quads) {  // kTR threads copy a row's 32 columns, kV each
      constexpr int kV = 16 / sizeof(T);
      constexpr int kTR = kChunk / kV;
      const int c = kV * (ti % kTR);
      const long long bb = b0 + k * kChunk + c;
      const bool in = bb < B;
      const T* src = h_t + (in ? bb : 0);
      for (int j = ti / kTR; j < H; j += 32 * NW / kTR)
        __pipeline_memcpy_async(buf + j * kHS + c,
                                src + static_cast<long long>(j) * B, 16,
                                in ? 0 : 16);
    } else {  // a warp copies a row
      const long long bb = b0 + k * kChunk + lane;
      const bool in = bb < B;
      const T* src = h_t + (in ? bb : 0);
      for (int j = wi; j < H; j += NW) {
        __pipeline_memcpy_async(buf + j * kHS + lane,
                                src + static_cast<long long>(j) * B, 4,
                                in ? 0 : 4);
      }
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
        const T* hb = h_s + ((k % nbuf) * h_rows(H) + j0) * kHS;
        const float* gk = gp + m0 * kGpStride + k * kChunk;
#pragma unroll 1
        for (int c = 0; c < kChunk; c += 4) {
          float4 gv[6], hv[4];
#pragma unroll
          for (int r = 0; r < 6; ++r)
            gv[r] = *reinterpret_cast<const float4*>(gk + 4 * r * kGpStride
                                                     + c);
#pragma unroll
          for (int s = 0; s < 4; ++s) hv[s] = nf::load4(hb + 8 * s * kHS + c);
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
template <class T, int K, bool CIRCULAR, bool INVERSE, bool ONE>
__global__ void __launch_bounds__(kThreads, 2) head_rqs_bwd_kernel(
    const T* __restrict__ x_t, long long x_rs, long long x_cs,
    const T* __restrict__ h_t, const T* __restrict__ w,
    const T* __restrict__ bias, const T* __restrict__ tb,
    const T* __restrict__ cty, long long cty_rs, long long cty_cs,
    const T* __restrict__ ctl, long long ctl_rs, long long ctl_cs,
    int feats, long long B, int H, bool quads, float edge,
    float min_bin_width, float min_bin_height, float min_derivative,
    T* __restrict__ gx, T* __restrict__ gh, float* __restrict__ partials) {
  constexpr int ND = CIRCULAR ? K : K - 1;
  constexpr int P = 2 * K + ND;
  constexpr int PP = padded_params(P);
  const int D = ONE ? 1 : feats;
  const int M = P * D;
  const int wrows = w_rows(H);
  const int ntiles = (H + kJ - 1) / kJ;
  // rows of gh a thread sums per step (phase 4, and each of the two columns
  // of the split phase)
  constexpr int GS = kG;
  constexpr int GS2 = kG2;
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
          (p < P && jj < H)
              ? nf::to_f32(w[static_cast<long long>(p * D + d) * H + jj])
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
        const T* hp = h_t + static_cast<long long>(t * kJ) * B + b;
        const float4* wq = reinterpret_cast<const float4*>(w_s + d * PP);
        const int wstep = D * PP / 4;  // float4s from one j to the next
#pragma unroll 8
        for (int j = 0; j < rows; ++j) {
          const float hv = nf::to_f32(*hp);
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
        uw[k] = acc[k] + nf::to_f32(bias[k * D + d]);
        uh[k] = acc[K + k] + nf::to_f32(bias[(K + k) * D + d]);
      }
      if (CIRCULAR) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          ud[k] = acc[2 * K + k] + nf::to_f32(bias[(2 * K + k) * D + d]);
        ud[K] = ud[0];
      } else {
        ud[0] = edge;
        ud[K] = edge;
#pragma unroll
        for (int k = 0; k < K - 1; ++k)
          ud[k + 1] = acc[2 * K + k] + nf::to_f32(bias[(2 * K + k) * D + d]);
      }
      float gxv, gwv[K], ghv[K], gdv[K + 1];
      nf::rqs_bwd_element<K, INVERSE>(
          nf::to_f32(x_t[d * x_rs + b * x_cs]), nf::to_f32(tb[d]), uw, uh,
          ud, nf::to_f32(cty[d * cty_rs + b * cty_cs]),
          nf::to_f32(ctl[d * ctl_rs + b * ctl_cs]), min_bin_width,
          min_bin_height, min_derivative, gxv, gwv, ghv, gdv);
      gx[d * B + b] = nf::from_f32<T>(gxv);
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
  const int nbuf = h_buffers<T>(P, D, H);
  // [nbuf][h_rows][h_stride]
  T* h_s = reinterpret_cast<T*>(split ? w_s + wrows * D * PP : w_s);

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
        gw_product<T, kWarps / 2, false>(gp, h_s, nbuf, h_t, B, quads, b0,
                                         M, H, out, warp, lane);
        return;
      }
      const int t2 = tid - kThreads / 2;
      const bool active2 = b0 + t2 < B;
      float g2[PP];
#pragma unroll
      for (int p = 0; p < PP; ++p)
        g2[p] = (p < P) ? gp[p * kGpStride + t2] : 0.0f;
      for (int js = 0; js < H; js += GS2) {
        float s[GS2], s2[GS2];
#pragma unroll
        for (int i = 0; i < GS2; ++i) s[i] = s2[i] = 0.0f;
        const float4* wq = reinterpret_cast<const float4*>(w_s + js * PP);
#pragma unroll
        for (int i = 0; i < GS2; ++i) {
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
        for (int i = 0; i < GS2; ++i) {
          if (js + i < H) {
            T* row = gh + static_cast<long long>(js + i) * B + b0;
            if (active) row[tid] = nf::from_f32<T>(s[i]);
            if (active2) row[t2] = nf::from_f32<T>(s2[i]);
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
    for (int js = 0; js < rows; js += GS) {
      float s[GS];
#pragma unroll
      for (int i = 0; i < GS; ++i) s[i] = 0.0f;
      for (int d = 0; d < D; ++d) {
        float gd[PP];
#pragma unroll
        for (int p = 0; p < PP; ++p)
          gd[p] = (ONE || p >= P) ? g[p]
                                  : gp[(p * D + d) * kGpStride + tid];
        const float4* wq =
            reinterpret_cast<const float4*>(w_s + (js * D + d) * PP);
#pragma unroll
        for (int i = 0; i < GS; ++i) {
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
        for (int i = 0; i < GS; ++i)
          if (js + i < rows)
            gh[static_cast<long long>(j0 + js + i) * B + b] =
                nf::from_f32<T>(s[i]);
      }
    }
  }

  // 3. gW on every warp; h_s reuses w_s once gh is done with it
  gw_product<T, kWarps, true>(gp, h_s, nbuf, h_t, B, quads, b0, M, H, out,
                              warp, lane);
}

// Sum the blocks' (MH + M)-wide float32 partial rows in a fixed order: 32
// outputs per block, 32 rows of threads each summing every 32nd partial in
// turn (their loads issued together), then row 0 adds the 32 sums in order
// and rounds the total once into T. gW takes outputs [0, MH), gb the rest.
template <class T>
__global__ void __launch_bounds__(1024) reduce_partials(
    const float* __restrict__ partials, int blocks, int MH, int M,
    T* __restrict__ gw, T* __restrict__ gb) {
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
      gw[o] = nf::from_f32<T>(t);
    else
      gb[o - MH] = nf::from_f32<T>(t);
  }
}

template <class T, int K, bool CIRCULAR, bool INVERSE, bool ONE>
int launch(const T* x_t, long long x_rs, long long x_cs, const T* h_t,
           const T* w, const T* bias, const T* tb, const T* cty,
           long long cty_rs, long long cty_cs, const T* ctl, long long ctl_rs,
           long long ctl_cs, int D, long long B, int H, float edge,
           float mbw, float mbh, float md, T* gx, T* gh, float* partials,
           cudaStream_t stream) {
  constexpr int P = 2 * K + (CIRCULAR ? K : K - 1);
  const size_t smem = shared_bytes<T>(P, D, H, h_buffers<T>(P, D, H));
  auto kernel = head_rqs_bwd_kernel<T, K, CIRCULAR, INVERSE, ONE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  // 16-byte copies of h_t: every row starts on 16 bytes
  const bool quads = B % (16 / sizeof(T)) == 0 &&
                     reinterpret_cast<std::uintptr_t>(h_t) % 16 == 0;
  kernel<<<blocks, kThreads, smem, stream>>>(
      x_t, x_rs, x_cs, h_t, w, bias, tb, cty, cty_rs, cty_cs, ctl, ctl_rs,
      ctl_cs, D, B, H, quads, edge, mbw, mbh, md, gx, gh, partials);
  return static_cast<int>(cudaGetLastError());
}

// The body of the float32 C entry point: see head_rqs_bwd_launch.
int dispatch(const float* x_t, long long x_rs, long long x_cs,
             const float* h_t, const float* w, const float* bias,
             const float* tb, const float* cty, long long cty_rs,
             long long cty_cs, const float* ctl, long long ctl_rs,
             long long ctl_cs, int D, long long B, int H, int num_bins,
             int circular, int inverse, float edge, float min_bin_width,
             float min_bin_height, float min_derivative, float* gx,
             float* gh, float* gw, float* gb, float* partials,
             void* stream) {
  using T = float;
  if (D == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int P = 2 * num_bins + (circular ? num_bins : num_bins - 1);
  const int M = P * D;
  const int blocks = static_cast<int>((B + kThreads - 1) / kThreads);
  if (B == 0) {
    // no columns: every gradient of the head is zero
    cudaMemsetAsync(gw, 0, sizeof(T) * M * H, st);
    cudaMemsetAsync(gb, 0, sizeof(T) * M, st);
    return static_cast<int>(cudaGetLastError());
  }
  int err = 0;
#define NF_HEAD_BWD_LAUNCH(KK, CC, II)                                      \
  err = (D == 1 ? launch<T, KK, CC, II, true>                               \
                : launch<T, KK, CC, II, false>)(                            \
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
  reduce_partials<T><<<(width + 31) / 32, dim3(32, 32), 0, st>>>(
      partials, blocks, M * H, M, gw, gb);
  return static_cast<int>(cudaGetLastError());
}


// ---- bfloat16: the tensor-core kernel ------------------------------------

using nf::mma::bf16;
constexpr int kStagesBf16 = 3;  // chunks of h_t in a warp's ring

// A block of W warps (4 or 8) owns 32 W batch columns; gp's rows and the
// gW chunks of h_t are 32 W columns and the pad wide, and a gW chunk holds
// 8 W rows of H.
__host__ __device__ constexpr int col_row_bf16(int warps) {
  return 32 * warps + nf::mma::kPad;
}
__host__ __device__ constexpr int j_rows_bf16(int warps) { return 8 * warps; }

// the region of h_t: the warps' rings (phase 1), then two chunks for gW
__host__ __device__ constexpr size_t h_bytes_bf16(int warps) {
  return sizeof(bf16) * warps * kStagesBf16 * nf::mma::kRK * nf::mma::kRowW >
                 sizeof(bf16) * 2 * j_rows_bf16(warps) * col_row_bf16(warps)
             ? sizeof(bf16) * warps * kStagesBf16 * nf::mma::kRK *
                   nf::mma::kRowW
             : sizeof(bf16) * 2 * j_rows_bf16(warps) * col_row_bf16(warps);
}
static_assert(kStagesBf16 * nf::mma::kRK * nf::mma::kRowW * 2 >= 32 * 17 * 4,
              "a warp's ring holds its column scratch");
static_assert(j_rows_bf16(4) * col_row_bf16(4) >= 4 * 16 * nf::mma::kRowW &&
                  j_rows_bf16(8) * col_row_bf16(8) >= 8 * 16 * nf::mma::kRowW,
              "a gW chunk buffer holds the warps' gh scratch");

// How a block of the bfloat16 kernel lays out its shared memory for P
// parameters per feature, D features and hidden width H: its warps (8
// where they fit, else 4), the W_eff tile's width wj (all of H padded to
// 32 where it fits) and the bytes; wj == 0: the shape does not fit.
// ops/spline_head_fused.py kernel_e_bf16_plan is its twin.
struct PlanBf16 {
  int warps;
  int wj;
  size_t bytes;
};

__host__ __device__ inline PlanBf16 plan_bf16(int P, int D, int H) {
  using nf::mma::kPad;
  using nf::mma::kRK;
  const int rows = D * nf::mma::param_rows(P);
  const int hp = nf::mma::padded_hidden(H);
  for (int warps = 8; warps >= 4; warps -= 4) {
    // gp's two planes, h_t's region, the warps' gb shares
    const size_t used =
        sizeof(bf16) * 2 * static_cast<size_t>(rows) * col_row_bf16(warps) +
        h_bytes_bf16(warps) +
        sizeof(float) * warps * static_cast<size_t>(rows);
    if (used >= static_cast<size_t>(kMaxSharedBytes)) continue;
    const long long cols =
        static_cast<long long>((kMaxSharedBytes - used) / (2 * rows)) - kPad;
    int wj = static_cast<int>(cols < 0 ? 0 : cols / kRK * kRK);
    if (wj > hp) wj = hp;
    if (wj < kRK) continue;
    return {warps, wj,
            used + sizeof(bf16) * static_cast<size_t>(rows) * (wj + kPad)};
  }
  return {0, 0, 0};
}

// Kernel E in bfloat16. A block of W warps owns 32 W columns b0 + tid of
// every feature, a warp 32 of them (head_mma_bf16.cuh); 128 registers a
// thread, so that 4 blocks of 4 warps or 2 of 8 share an SM.
template <int K, bool CIRCULAR, bool INVERSE, int W>
__global__ void __launch_bounds__(32 * W, 16 / W) head_rqs_bwd_bf16_kernel(
    const bf16* __restrict__ x_t, long long x_rs, long long x_cs,
    const bf16* __restrict__ h_t, const bf16* __restrict__ w,
    const bf16* __restrict__ bias, const bf16* __restrict__ tb,
    const bf16* __restrict__ cty, long long cty_rs, long long cty_cs,
    const bf16* __restrict__ ctl, long long ctl_rs, long long ctl_cs, int D,
    long long B, int H, int wj, bool hquads, bool wquads, bool gquads,
    float edge, float min_bin_width, float min_bin_height,
    float min_derivative, bf16* __restrict__ gx, bf16* __restrict__ gh,
    float* __restrict__ partials) {
  using nf::mma::column_params;
  using nf::mma::head_product_rows;
  using nf::mma::kPad;
  using nf::mma::kRK;
  using nf::mma::kRowW;
  using nf::mma::kWarpCols;
  using nf::mma::ldsm_x4;
  using nf::mma::ldsm_x4_t;
  using nf::mma::mma_16816;
  using nf::mma::padded_hidden;
  using nf::mma::param_rows;
  using nf::mma::split_bf16_pair;
  using nf::mma::stage_h_warp;
  using nf::mma::stage_w_rows;
  using nf::mma::tile_f1;
  using nf::mma::tile_f2;
  constexpr int ND = CIRCULAR ? K : K - 1;
  constexpr int P = 2 * K + ND;
  constexpr int PM = param_rows(P);
  constexpr int MT = PM / 16;
  constexpr int kRing = kStagesBf16 * kRK * kRowW;  // one warp's ring
  constexpr int kThreadsW = 32 * W;  // threads = batch columns of a block
  constexpr int kColRow = col_row_bf16(W);
  constexpr int kJRows = j_rows_bf16(W);
  const int rows = D * PM;  // staged head rows, feature-major: d*PM + p
  const int ws = wj + kPad;
  const int hp = padded_hidden(H);
  const int chunks = hp / kRK;
  const int ntiles = (hp + wj - 1) / wj;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* w_s = reinterpret_cast<bf16*>(smem_raw);  // [rows][ws]
  bf16* gp_hi = w_s + rows * ws;                  // [rows][kColRow]
  bf16* gp_lo = gp_hi + rows * kColRow;           // [rows][kColRow]
  bf16* h_s = gp_lo + rows * kColRow;  // rings, then two gW chunks
  float* gbw = reinterpret_cast<float*>(
      h_s + h_bytes_bf16(W) / sizeof(bf16));  // [warps][rows]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long b0 = static_cast<long long>(blockIdx.x) * kThreadsW;
  const long long bw = b0 + warp * kWarpCols;
  const long long b = b0 + tid;
  const bool active = b < B;
  const int MH = P * D * H;
  float* out = partials + static_cast<long long>(blockIdx.x) * (MH + P * D);
  bf16* ring_w = h_s + warp * kRing;

  int staged = 0;  // the W_eff tile in w_s (the same on every thread)
  auto ensure_tile = [&](int t) {
    if (t == staged) return;
    __syncthreads();
    stage_w_rows(w_s, ws, w, D, 0, D, P, PM, H, t * wj, wj, wquads, tid,
                 kThreadsW);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    staged = t;
  };
  // 0. W_eff's first tile (its own commit group, the oldest)
  stage_w_rows(w_s, ws, w, D, 0, D, P, PM, H, 0, wj, wquads, tid,
               kThreadsW);
  __pipeline_commit();

  // 1. per feature: the head product (kernel B's, bit for bit), + bias,
  // the spline's backward; gx out, gp split into gp_hi / gp_lo, and the
  // warp's share of gb
  for (int d = 0; d < D; ++d) {
    auto stage = [&](int s) {  // chunk s -> the warp's ring slot
      if (s < chunks)
        stage_h_warp(ring_w + (s % kStagesBf16) * (kRK * kRowW), kRowW, h_t,
                     B, H, s * kRK, bw, hquads, lane);
      __pipeline_commit();
    };
#pragma unroll
    for (int s = 0; s < kStagesBf16 - 1; ++s) stage(s);
    float acc[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
    for (int s = 0; s < chunks; ++s) {
      const int j0 = s * kRK;
      ensure_tile(j0 / wj);
      __pipeline_wait_prior(kStagesBf16 - 2);
      if (d == 0 && s == 0)
        __syncthreads();  // every thread's share of W_eff's first tile
      else
        __syncwarp();
      stage(s + kStagesBf16 - 1);
      head_product_rows<MT>(w_s + d * PM * ws + j0 % wj, ws,
                            ring_w + (s % kStagesBf16) * (kRK * kRowW),
                            kRowW, lane, acc);
    }
    __pipeline_wait_prior(0);
    __syncwarp();
    float pv[PM];  // this lane's column, through the warp's drained ring
    column_params<MT>(acc, reinterpret_cast<float*>(ring_w), lane, pv);
    float c[PM];  // an inactive column keeps 0: no share in gW or gb
#pragma unroll
    for (int p = 0; p < PM; ++p) c[p] = 0.0f;
    if (active) {
      float uw[K], uh[K], ud[K + 1];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        uw[k] = pv[k] + nf::to_f32(bias[k * D + d]);
        uh[k] = pv[K + k] + nf::to_f32(bias[(K + k) * D + d]);
      }
      if (CIRCULAR) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          ud[k] = pv[2 * K + k] + nf::to_f32(bias[(2 * K + k) * D + d]);
        ud[K] = ud[0];
      } else {
        ud[0] = edge;
        ud[K] = edge;
#pragma unroll
        for (int k = 0; k < K - 1; ++k)
          ud[k + 1] = pv[2 * K + k] + nf::to_f32(bias[(2 * K + k) * D + d]);
      }
      float gxv, gwv[K], ghv[K], gdv[K + 1];
      nf::rqs_bwd_element<K, INVERSE>(
          nf::to_f32(x_t[d * x_rs + b * x_cs]), nf::to_f32(tb[d]), uw, uh,
          ud, nf::to_f32(cty[d * cty_rs + b * cty_cs]),
          nf::to_f32(ctl[d * ctl_rs + b * ctl_cs]), min_bin_width,
          min_bin_height, min_derivative, gxv, gwv, ghv, gdv);
      gx[d * B + b] = nf::from_f32<bf16>(gxv);
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
    for (int p = 0; p < PM; ++p) {
      bf16 hi, lo;
      split_bf16_pair(c[p], hi, lo);
      gp_hi[(d * PM + p) * kColRow + tid] = hi;
      gp_lo[(d * PM + p) * kColRow + tid] = lo;
    }
    // the warp's share of gb: a fixed xor-shuffle tree over its columns
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float v = c[p];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) gbw[warp * rows + d * PM + p] = v;
    }
  }
  __syncthreads();  // gp and gb's shares are in place; the rings are free

  // 2. this block's share of gb: the warps' shares in order
  for (int m = tid; m < P * D; m += kThreadsW) {
    const int r = (m % D) * PM + m / D;  // head row m = p*D + d
    float v = gbw[r];
#pragma unroll
    for (int i = 1; i < W; ++i) v += gbw[i * rows + r];
    out[MH + m] = v;
  }

  // 4's chunks of h_t, staged again (two buffers over the rings): the
  // first in flight during 3
  const int nchunks = (hp + kJRows - 1) / kJRows;
  auto stage_chunk = [&](int c) {  // rows [c kJRows, +kJRows) -> buffer c % 2
    if (c < nchunks) {
      bf16* buf = h_s + (c & 1) * (kJRows * kColRow) + warp * kWarpCols;
      for (int r = 0; r < kJRows; r += kRK)
        stage_h_warp(buf + r * kColRow, kColRow, h_t, B, H, c * kJRows + r,
                     bw, hquads, lane);
    }
    __pipeline_commit();
  };
  stage_chunk(0);

  // 3. gh[:, warp's columns] = W_eff^T (gp_hi + gp_lo), 16 rows of H at a
  // time (A: W_eff^T by ldmatrix.trans; B: gp by ldmatrix.trans), each
  // 16 x 32 tile rounded into the warp's scratch (in chunk buffer 1, not
  // yet staged) and stored as 16-byte pieces of rows
  const int g = lane >> 2;
  const int tq = lane & 3;
  bf16* stg = h_s + kJRows * kColRow + warp * (16 * kRowW);  // [16][kRowW]
  // one k16 step of the 16 x 32 tile: acc += A (hi + lo)
  auto gh_step = [&](float (&acc)[4][4], const uint32_t (&a)[4],
                     const uint32_t (&bh)[2][4], const uint32_t (&bl)[2][4]) {
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {
      mma_16816(acc[2 * n2], a, bh[n2][0], bh[n2][1]);
      mma_16816(acc[2 * n2], a, bl[n2][0], bl[n2][1]);
      mma_16816(acc[2 * n2 + 1], a, bh[n2][2], bh[n2][3]);
      mma_16816(acc[2 * n2 + 1], a, bl[n2][2], bl[n2][3]);
    }
  };
  auto gp_frags = [&](int k, uint32_t (&bh)[2][4], uint32_t (&bl)[2][4]) {
    const int go = k * kColRow + warp * kWarpCols + tile_f1(lane, kColRow);
    ldsm_x4_t(bh[0], gp_hi + go);
    ldsm_x4_t(bh[1], gp_hi + go + 16);
    ldsm_x4_t(bl[0], gp_lo + go);
    ldsm_x4_t(bl[1], gp_lo + go + 16);
  };
  // the warp's gp fragments are the same for every row of H: with at most
  // two k16 steps of head rows (one feature, or two at PM 16) they stay in
  // registers, and a tile loads only W_eff^T
  const bool hoist = rows <= 32;
  uint32_t hh[2][2][4], hl[2][2][4];
  if (hoist) {
    gp_frags(0, hh[0], hl[0]);
    if (rows > 16) gp_frags(16, hh[1], hl[1]);
  }
  for (int t = ntiles - 1; t >= 0; --t) {  // the staged tile first
    ensure_tile(t);
    const int jt_end = min(t * wj + wj, H);
    for (int jt = t * wj; jt < jt_end; jt += 16) {
      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;
      const bf16* wt = w_s + (jt - t * wj) + tile_f2(lane, ws);
      if (hoist) {
        uint32_t a[4];
        ldsm_x4_t(a, wt);
        gh_step(acc, a, hh[0], hl[0]);
        if (rows > 16) {
          ldsm_x4_t(a, wt + 16 * ws);
          gh_step(acc, a, hh[1], hl[1]);
        }
      } else {
        for (int k = 0; k < rows; k += 16) {
          uint32_t a[4], bh[2][4], bl[2][4];
          ldsm_x4_t(a, wt + k * ws);
          gp_frags(k, bh, bl);
          gh_step(acc, a, bh, bl);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<__nv_bfloat162*>(
              stg + (g + 8 * half) * kRowW + 8 * nt + 2 * tq) =
              __floats2bfloat162_rn(acc[nt][2 * half], acc[nt][2 * half + 1]);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // 16 rows x 4 pieces of 8 columns
        const int e = i * 32 + lane;
        const int j = jt + (e >> 2);
        const int c = (e & 3) * 8;
        const bf16* src = stg + (e >> 2) * kRowW + c;
        if (j >= H) continue;
        bf16* dst = gh + static_cast<long long>(j) * B + bw + c;
        if (gquads && bw + c + 8 <= B) {
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(src);
        } else {
          for (int q = 0; q < 8 && bw + c + q < B; ++q) dst[q] = src[q];
        }
      }
      __syncwarp();
    }
  }

  // 4. this block's share of gW = (gp_hi + gp_lo) h_t^T over its columns:
  // warp tiles of 16 head rows x 32 rows of H (A: gp by ldmatrix; B: the
  // chunk [j][column] by ldmatrix), chunk by chunk, the next in flight
  const int mtiles = rows / 16;
  for (int c = 0; c < nchunks; ++c) {
    __syncthreads();  // chunk c - 1's readers (3's scratch at c == 0)
    stage_chunk(c + 1);
    __pipeline_wait_prior(1);
    __syncthreads();  // chunk c is in place
    const bf16* hb = h_s + (c & 1) * (kJRows * kColRow);
    for (int it = warp; it < mtiles * (kJRows / 32); it += W) {
      const int m0 = (it % mtiles) * 16;
      const int n0 = (it / mtiles) * 32;
      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;
#pragma unroll 2
      for (int k = 0; k < kThreadsW; k += 16) {
        uint32_t ah[4], al[4], bq[2][4];
        ldsm_x4(ah, gp_hi + m0 * kColRow + k + tile_f1(lane, kColRow));
        ldsm_x4(al, gp_lo + m0 * kColRow + k + tile_f1(lane, kColRow));
        ldsm_x4(bq[0], hb + n0 * kColRow + k + tile_f2(lane, kColRow));
        ldsm_x4(bq[1], hb + (n0 + 16) * kColRow + k + tile_f2(lane, kColRow));
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2) {
          mma_16816(acc[2 * n2], ah, bq[n2][0], bq[n2][1]);
          mma_16816(acc[2 * n2], al, bq[n2][0], bq[n2][1]);
          mma_16816(acc[2 * n2 + 1], ah, bq[n2][2], bq[n2][3]);
          mma_16816(acc[2 * n2 + 1], al, bq[n2][2], bq[n2][3]);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + g + 8 * half;  // staged row d*PM + p
        const int p = r % PM;
        if (p >= P) continue;
        float* orow = out + static_cast<long long>(p * D + r / PM) * H;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int j = c * kJRows + n0 + 8 * nt + 2 * tq;
          if (j < H) orow[j] = acc[nt][2 * half];
          if (j + 1 < H) orow[j + 1] = acc[nt][2 * half + 1];
        }
      }
    }
  }
}

template <int K, bool CIRCULAR, bool INVERSE, int W>
int launch_bf16_w(const bf16* x_t, long long x_rs, long long x_cs,
                  const bf16* h_t, const bf16* w, const bf16* bias,
                  const bf16* tb, const bf16* cty, long long cty_rs,
                  long long cty_cs, const bf16* ctl, long long ctl_rs,
                  long long ctl_cs, int D, long long B, int H, float edge,
                  float mbw, float mbh, float md, bf16* gx, bf16* gh,
                  float* partials, const PlanBf16& plan,
                  cudaStream_t stream) {
  auto kernel = head_rqs_bwd_bf16_kernel<K, CIRCULAR, INVERSE, W>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(plan.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((B + 32 * W - 1) / (32 * W));
  const bool hquads =
      B % 8 == 0 && reinterpret_cast<std::uintptr_t>(h_t) % 16 == 0;
  const bool wquads =
      H % 8 == 0 && reinterpret_cast<std::uintptr_t>(w) % 16 == 0;
  const bool gquads =
      B % 8 == 0 && reinterpret_cast<std::uintptr_t>(gh) % 16 == 0;
  kernel<<<blocks, 32 * W, plan.bytes, stream>>>(
      x_t, x_rs, x_cs, h_t, w, bias, tb, cty, cty_rs, cty_cs, ctl, ctl_rs,
      ctl_cs, D, B, H, plan.wj, hquads, wquads, gquads, edge, mbw, mbh, md,
      gx, gh, partials);
  return static_cast<int>(cudaGetLastError());
}

template <int K, bool CIRCULAR, bool INVERSE>
int launch_bf16(const bf16* x_t, long long x_rs, long long x_cs,
                const bf16* h_t, const bf16* w, const bf16* bias,
                const bf16* tb, const bf16* cty, long long cty_rs,
                long long cty_cs, const bf16* ctl, long long ctl_rs,
                long long ctl_cs, int D, long long B, int H, float edge,
                float mbw, float mbh, float md, bf16* gx, bf16* gh,
                float* partials, const PlanBf16& plan, cudaStream_t stream) {
  return (plan.warps == 8 ? launch_bf16_w<K, CIRCULAR, INVERSE, 8>
                          : launch_bf16_w<K, CIRCULAR, INVERSE, 4>)(
      x_t, x_rs, x_cs, h_t, w, bias, tb, cty, cty_rs, cty_cs, ctl, ctl_rs,
      ctl_cs, D, B, H, edge, mbw, mbh, md, gx, gh, partials, plan, stream);
}

// The body of the bfloat16 C entry point: see head_rqs_bwd_launch_bf16.
int dispatch_bf16(const bf16* x_t, long long x_rs, long long x_cs,
                  const bf16* h_t, const bf16* w, const bf16* bias,
                  const bf16* tb, const bf16* cty, long long cty_rs,
                  long long cty_cs, const bf16* ctl, long long ctl_rs,
                  long long ctl_cs, int D, long long B, int H, int num_bins,
                  int circular, int inverse, float edge, float min_bin_width,
                  float min_bin_height, float min_derivative, bf16* gx,
                  bf16* gh, bf16* gw, bf16* gb, float* partials,
                  void* stream) {
  if (D == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int P = 2 * num_bins + (circular ? num_bins : num_bins - 1);
  const int M = P * D;
  const PlanBf16 plan = plan_bf16(P, D, H);
  if (plan.wj == 0) return -2;
  const int blocks =
      static_cast<int>((B + 32 * plan.warps - 1) / (32 * plan.warps));
  if (B == 0) {
    // no columns: every gradient of the head is zero
    cudaMemsetAsync(gw, 0, sizeof(bf16) * M * H, st);
    cudaMemsetAsync(gb, 0, sizeof(bf16) * M, st);
    return static_cast<int>(cudaGetLastError());
  }
  int err = 0;
#define NF_HEAD_BWD_LAUNCH(KK, CC, II)                                      \
  err = launch_bf16<KK, CC, II>(                                            \
      x_t, x_rs, x_cs, h_t, w, bias, tb, cty, cty_rs, cty_cs, ctl, ctl_rs,  \
      ctl_cs, D, B, H, edge, min_bin_width, min_bin_height, min_derivative, \
      gx, gh, partials, plan, st)
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
  reduce_partials<bf16><<<(width + 31) / 32, dim3(32, 32), 0, st>>>(
      partials, blocks, M * H, M, gw, gb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface for ctypes. x_t, cty, ctl (D, B) with their (row, column)
// strides; h_t (H, B), w (M, H), bias (M,), tb (D,) contiguous; gx (D, B),
// gh (H, B), gw (M, H), gb (M,) contiguous outputs; partials a contiguous
// float32 workspace of ceil(B / 256) * M * (H + 1) floats. `edge` is the
// linear-tail derivative logit log(exp(1 - min_d) - 1). The wrapper checks
// the block's shared memory (ops/spline_head_fused.py,
// kernel_e_shared_bytes, the same sum as shared_bytes above) before it
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
  return dispatch(x_t, x_rs, x_cs, h_t, w, bias, tb, cty, cty_rs, cty_cs,
                  ctl, ctl_rs, ctl_cs, D, B, H, num_bins, circular, inverse,
                  edge, min_bin_width, min_bin_height, min_derivative, gx,
                  gh, gw, gb, partials, stream);
}

// The same with every operand and output in bfloat16; the partials stay
// float32 (edge and the minima stay float).
extern "C" int head_rqs_bwd_launch_bf16(
    const __nv_bfloat16* x_t, long long x_rs, long long x_cs,
    const __nv_bfloat16* h_t, const __nv_bfloat16* w,
    const __nv_bfloat16* bias, const __nv_bfloat16* tb,
    const __nv_bfloat16* cty, long long cty_rs, long long cty_cs,
    const __nv_bfloat16* ctl, long long ctl_rs, long long ctl_cs, int D,
    long long B, int H, int num_bins, int circular, int inverse, float edge,
    float min_bin_width, float min_bin_height, float min_derivative,
    __nv_bfloat16* gx, __nv_bfloat16* gh, __nv_bfloat16* gw,
    __nv_bfloat16* gb, float* partials, void* stream) {
  return dispatch_bf16(x_t, x_rs, x_cs, h_t, w, bias, tb, cty, cty_rs,
                       cty_cs, ctl, ctl_rs, ctl_cs, D, B, H, num_bins,
                       circular, inverse, edge, min_bin_width,
                       min_bin_height, min_derivative, gx, gh, gw, gb,
                       partials, stream);
}
