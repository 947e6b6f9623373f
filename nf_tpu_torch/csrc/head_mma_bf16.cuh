// The bfloat16 head product of kernels B and E on Hopper's tensor cores,
// and the staging both kernels feed it from.
//
// The JAX reference computes the head products of _head_kernel and
// _head_bwd_kernel as bfloat16 dots on the MXU with a float32 result
// (nf_tpu/ops/spline_head_fused.py:109-110, 136-137, 169-176). Here they
// are mma.sync.m16n8k16 bf16 x bf16 -> f32 products, fed from shared
// memory by ldmatrix; no operand is widened before the product.
//
// The product (head_product_rows): params[p][c] = sum_j W[p][j] h[j][c]
// for the PM = P rounded up to 16 parameter rows of one feature (M, one
// or two m16 tiles) and the 32 batch columns of one warp (N, four n8
// tiles), over kRK rows of H (K, two k16 steps). W_eff's rows sit in
// shared memory as [p][j] (ldmatrix, A row-major), h_t's as [j][c]
// (ldmatrix.trans, B from a row-major K x N tile). A caller zeroes the
// accumulators and calls it for rows 0, kRK, 2 kRK, ... of H padded to
// kRK with zeros, in that order: kernel B (head_rqs_fwd.cu) and kernel E's
// recompute (head_rqs_bwd.cu) both do, with the same operands in the same
// fragments, so E's parameters are B's bit for bit and E differentiates
// what B computed. column_params then hands each lane the PM sums of its
// own column (through a [32][17] float32 scratch of the warp), to which
// both add the bias in float32.
//
// Kernel E's other two products (gh = W_eff^T gp, gW = gp h_t^T) take the
// float32 parameter cotangents gp as two bfloat16 planes, hi = bf16(gp)
// and lo = bf16(gp - hi) (split_bf16_pair), each product accumulated in
// float32 over both: hi + lo holds ~16 bits of gp (within max(2^-16 |gp|,
// 2^-134) of it, 2^-134 where lo underflows), where one bfloat16 would
// hold 8.
#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline_primitives.h>

#include <cstdint>

namespace nf {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kWarpCols = 32;  // batch columns of a warp's product
constexpr int kRK = 32;        // rows of H per staged chunk (two k16 steps)
constexpr int kPad = 8;        // pad of a staged bfloat16 row: 16 bytes
// a warp's h_t chunk row: 32 columns and the pad (80 bytes, so the eight
// rows one ldmatrix reads fall in eight distinct 16-byte bank groups)
constexpr int kRowW = kWarpCols + kPad;

__host__ __device__ constexpr int param_rows(int p) {
  return (p + 15) / 16 * 16;
}

__host__ __device__ constexpr int round_up(int v, int to) {
  return (v + to - 1) / to * to;
}

// rows of H the products run over: H rounded up to kRK, at least one chunk
__host__ __device__ constexpr int padded_hidden(int H) {
  return round_up(H > 0 ? H : 1, kRK);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 bfloat16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a b: a 16x16 (row), b 16x8 (col), c 16x8 float32
__device__ __forceinline__ void mma_16816(float (&c)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The ldmatrix row addresses of lane l, as offsets into a tile of row
// stride s:
//   * tile_f1: A from [m][k] (k contiguous), or B by .trans from [k][n]
//     (n contiguous): row l % 16, column 8 (l / 16);
//   * tile_f2: B from [n][k] (k contiguous), or A by .trans from [k][m]
//     (m contiguous): row 8 (l / 16) + l % 8, column 8 ((l / 8) % 2).
__device__ __forceinline__ int tile_f1(int lane, int s) {
  return (lane & 15) * s + (lane >> 4) * 8;
}
__device__ __forceinline__ int tile_f2(int lane, int s) {
  return ((lane >> 4) * 8 + (lane & 7)) * s + ((lane >> 3) & 1) * 8;
}

// THE head product: acc[mt][nt] += W[16 mt .. +16][0 .. kRK) h[0 .. kRK)
// [8 nt .. +8], two k16 steps in order, each an mma accumulating into acc
// (float32, the tensor cores' own rounding). w: the feature's W_eff rows at
// the chunk's first column (row stride ws); h: the chunk's first row at
// the warp's first column (row stride hs).
template <int MT>
__device__ __forceinline__ void head_product_rows(const bf16* w, int ws,
                                                  const bf16* h, int hs,
                                                  int lane,
                                                  float (&acc)[MT][4][4]) {
#pragma unroll
  for (int k = 0; k < kRK; k += 16) {
    uint32_t b[2][4];  // n tiles 0-1, then 2-3: {b0, b1} of each
    ldsm_x4_t(b[0], h + k * hs + tile_f1(lane, hs));
    ldsm_x4_t(b[1], h + k * hs + 16 + tile_f1(lane, hs));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t a[4];
      ldsm_x4(a, w + 16 * mt * ws + k + tile_f1(lane, ws));
      mma_16816(acc[mt][0], a, b[0][0], b[0][1]);
      mma_16816(acc[mt][1], a, b[0][2], b[0][3]);
      mma_16816(acc[mt][2], a, b[1][0], b[1][1]);
      mma_16816(acc[mt][3], a, b[1][2], b[1][3]);
    }
  }
}

// The warp's accumulators -> pv, the PM sums of this lane's column, one
// m16 tile at a time through tr ([32][17] float32, the warp's own).
template <int MT>
__device__ __forceinline__ void column_params(const float (&acc)[MT][4][4],
                                              float* tr, int lane,
                                              float (&pv)[16 * MT]) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = 8 * nt + 2 * t;
      tr[c * 17 + g] = acc[mt][nt][0];
      tr[(c + 1) * 17 + g] = acc[mt][nt][1];
      tr[c * 17 + g + 8] = acc[mt][nt][2];
      tr[(c + 1) * 17 + g + 8] = acc[mt][nt][3];
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 16; ++i) pv[16 * mt + i] = tr[lane * 17 + i];
    __syncwarp();
  }
}

// gp -> (hi, lo): hi = gp rounded to nearest even (toward zero where that
// would overflow a finite gp), lo = gp - hi (exact in float32) rounded.
// ops/spline_head_fused.py split_bf16_pair is its twin.
__device__ __forceinline__ void split_bf16_pair(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(v);
  if (isinf(__bfloat162float(hi)) && !isinf(v)) hi = __float2bfloat16_rz(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// A warp copies rows [j0, j0 + kRK) of h_t (H, B), columns [bw, bw + 32),
// to dst (row stride ds), zero past H and B. quads: every row of h_t starts
// on 16 bytes (B % 8 == 0), so by 16-byte cp.async copies (the caller
// commits and waits); else by element loads, which a __syncwarp publishes.
__device__ __forceinline__ void stage_h_warp(bf16* dst, int ds,
                                             const bf16* __restrict__ h_t,
                                             long long B, int H, int j0,
                                             long long bw, bool quads,
                                             int lane) {
  if (quads) {
#pragma unroll
    for (int it = 0; it < kRK * 4 / 32; ++it) {
      const int e = it * 32 + lane;
      const int r = e >> 2;
      const int c = (e & 3) * 8;
      const bool in = j0 + r < H && bw + c < B;
      const bf16* src =
          h_t + (in ? static_cast<long long>(j0 + r) * B + bw + c : 0);
      __pipeline_memcpy_async(dst + r * ds + c, src, 16, in ? 0 : 16);
    }
  } else {
#pragma unroll 4
    for (int r = 0; r < kRK; ++r) {
      const bool in = j0 + r < H && bw + lane < B;
      dst[r * ds + lane] =
          in ? h_t[static_cast<long long>(j0 + r) * B + bw + lane]
             : __float2bfloat16_rn(0.0f);
    }
  }
}

// The block copies W_eff (M = P*D rows p*D + d, H columns) rows of
// features [d0, d0 + nd), columns [j0, j0 + wj), to dst as [(d - d0) PM +
// p][j - j0] (row stride ds), zero for p >= P and j >= H. quads: H % 8 ==
// 0 and W_eff starts on 16 bytes, so by 16-byte cp.async copies (the
// caller commits and waits); else by element loads. The caller's
// __syncthreads publishes them.
__device__ __forceinline__ void stage_w_rows(bf16* dst, int ds,
                                             const bf16* __restrict__ w,
                                             int D, int d0, int nd, int P,
                                             int PM, int H, int j0, int wj,
                                             bool quads, int tid,
                                             int nthreads) {
  const int rows = nd * PM;
  if (quads) {
    const int per = wj / 8;
    for (int e = tid; e < rows * per; e += nthreads) {
      const int r = e / per;
      const int c = (e % per) * 8;
      const int d = d0 + r / PM;
      const int p = r % PM;
      const bool in = p < P && j0 + c < H;
      const bf16* src =
          w + (in ? static_cast<long long>(p * D + d) * H + j0 + c : 0);
      __pipeline_memcpy_async(dst + r * ds + c, src, 16, in ? 0 : 16);
    }
  } else {
    for (int e = tid; e < rows * wj; e += nthreads) {
      const int r = e / wj;
      const int c = e % wj;
      const int d = d0 + r / PM;
      const int p = r % PM;
      dst[r * ds + c] =
          (p < P && j0 + c < H)
              ? w[static_cast<long long>(p * D + d) * H + j0 + c]
              : __float2bfloat16_rn(0.0f);
    }
  }
}

}  // namespace mma
}  // namespace nf
