// The head product of the bfloat16 kernels B and E alone: params = W_eff
// @ h_t for every head row and batch column, in float32, as those kernels
// form it before they add the bias. It replaces no TPU kernel and runs on
// no model path: the parity checks (tests/test_torch_cuda.py,
// chip_smoke.py) hold kernel B's spline against its plain version on these
// sums, and the sums against float64 ones.
//
// Why: the tensor cores round each k16 step their own way (neither to
// nearest nor toward zero of the exact sum), so no float32 sum in PyTorch
// gives kernel B's parameters, and the last bits of a parameter move a
// log-det near 0 by several bfloat16 ulps. torch.matmul's float32 sums are
// themselves that far from the float64 ones on the card tests' shapes.
//
// Design: a block is one warp, 32 columns of one feature (blockIdx.y =
// d); it stages the feature's W_eff rows (PM = P rounded up to 16, H padded
// to kRK with zeros) and its columns of h_t in shared memory by element
// loads and calls head_mma_bf16.cuh's head_product_rows over the chunks of
// H in order: the operands reach the same fragments in the same order as
// in kernels B and E, so the sums are theirs bit for bit. Not timed.
#include <cuda_runtime.h>

#include "head_mma_bf16.cuh"

namespace {

using nf::mma::bf16;

template <int MT>
__global__ void __launch_bounds__(32) head_params_bf16_kernel(
    const bf16* __restrict__ h_t, const bf16* __restrict__ w, int D,
    long long B, int H, int P, float* __restrict__ out) {
  using nf::mma::kPad;
  using nf::mma::kRK;
  using nf::mma::kRowW;
  constexpr int PM = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hp = nf::mma::padded_hidden(H);
  const int ws = hp + kPad;
  bf16* w_s = reinterpret_cast<bf16*>(smem_raw);  // [PM][ws]
  bf16* h_s = w_s + PM * ws;                      // [hp][kRowW]
  const int d = blockIdx.y;
  const int lane = threadIdx.x;
  const long long bw = static_cast<long long>(blockIdx.x) * 32;
  for (int e = lane; e < PM * hp; e += 32) {
    const int p = e / hp;
    const int j = e % hp;
    w_s[p * ws + j] = (p < P && j < H)
                          ? w[static_cast<long long>(p * D + d) * H + j]
                          : __float2bfloat16_rn(0.0f);
  }
  for (int j = 0; j < hp; ++j)
    h_s[j * kRowW + lane] = (j < H && bw + lane < B)
                                ? h_t[static_cast<long long>(j) * B + bw + lane]
                                : __float2bfloat16_rn(0.0f);
  __syncwarp();
  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
  for (int j0 = 0; j0 < hp; j0 += kRK)
    nf::mma::head_product_rows<MT>(w_s + j0, ws, h_s + j0 * kRowW, kRowW,
                                   lane, acc);
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = 16 * mt + g + 8 * (i >> 1);
        const long long b = bw + 8 * nt + 2 * t + (i & 1);
        if (p < P && b < B) out[static_cast<long long>(p * D + d) * B + b] =
            acc[mt][nt][i];
      }
}

}  // namespace

// C interface for ctypes: h_t (H, B), w (P*D, H) contiguous bfloat16;
// out (P*D, B) contiguous float32, row p*D + d. Returns the CUDA error of
// the launch (0 if none); -1 for P outside 1..32.
extern "C" int head_params_bf16_launch(const bf16* h_t, const bf16* w,
                                       int D, long long B, int H, int P,
                                       float* out, void* stream) {
  if (B == 0 || D == 0) return 0;
  if (P < 1 || P > 32) return -1;
  const int hp = nf::mma::padded_hidden(H);
  const int mt = P > 16 ? 2 : 1;
  const size_t smem = sizeof(bf16) * (static_cast<size_t>(16 * mt) *
                                          (hp + nf::mma::kPad) +
                                      static_cast<size_t>(hp) *
                                          nf::mma::kRowW);
  auto kernel = mt == 2 ? head_params_bf16_kernel<2>
                        : head_params_bf16_kernel<1>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>((B + 31) / 32), static_cast<unsigned>(D));
  kernel<<<grid, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      h_t, w, D, B, H, P, out);
  return static_cast<int>(cudaGetLastError());
}
