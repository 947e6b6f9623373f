// Kernel F: the condition of the residual flows' fixed-point loop, and the
// host calls that build that loop as a WHILE conditional node of a CUDA
// graph under stream capture.
//
// Replaces no Pallas kernel. The JAX package solves x = y - g(x) and its
// implicit VJP with jax.lax.while_loop (nf_tpu/flows/residual.py:42-58 and
// :71-97), whose condition is
//     any((x - x_prev)**2 / tol >= 1) and i <= 1000,
// and XLA lowers such a loop on a GPU to a device-side `while` of its
// command buffer. The port's counterpart is a WHILE conditional node: the
// body graph runs while the node's condition handle is non-zero, and this
// kernel computes the condition on the device and sets the handle
// (cudaGraphSetConditional). Triton has no access to that device call.
//
// What it computes, per launch: over the n elements of x, x_prev and tol
// (one dtype, contiguous), whether any element has
//     (x - x_prev)^2 / tol >= 1,
// each operation rounded as PyTorch's separate ops round it (__fsub_rn,
// __fmul_rn, __fdiv_rn; for bfloat16 every result rounded to bfloat16, as
// PyTorch's bfloat16 ops do), so the decision is the plain version's bit
// for bit (flows/residual.py fixed_point_go). `d >= 1` is false for a NaN,
// as in JAX: a NaN element counts as settled. Then the count: set to 0
// (the test before the first pass) or incremented (after a pass), and
//     go = any && count <= cap.
// go is stored in state[2] and, when a handle is given, set as the node's
// condition.
//
// Design: one pass over the three planes; a block ORs its threads'
// decisions (__syncthreads_or) into a global flag, and the last block to
// finish (a fence, then an atomic ticket) reads the flag, writes the count
// and go, sets the handle, and resets the flag and the ticket for the next
// launch. An empty batch launches one block, which only does that.
//
// Bound on the H100: bytes. It reads 3 planes (12 bytes per float32
// element) and does 3 operations per element; at the residual sampler's
// B = 65536 x 2 that is 1.5 MB, under a microsecond of HBM time, so its
// time is the launch and the grid's ticket.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1056;  // 8 per SM on the H100's 132

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the storage type's rounding of a float32 result
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ bool moving(T a, T b, T t) {
  float d = round_to<T>(__fsub_rn(widen(a), widen(b)));
  d = round_to<T>(__fmul_rn(d, d));
  d = round_to<T>(__fdiv_rn(d, widen(t)));
  return d >= 1.0f;
}

// state: [flag, ticket, go], zero before the first launch; the last block
// leaves flag and ticket at zero again
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fixed_point_cond_kernel(const T* __restrict__ x,
                            const T* __restrict__ x_prev,
                            const T* __restrict__ tol, long long n,
                            int* count, unsigned int* state, int bump,
                            int cap, cudaGraphConditionalHandle handle,
                            int set_handle) {
  bool moved = false;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += step)
    moved |= moving(x[i], x_prev[i], tol[i]);
  const int any = __syncthreads_or(moved);
  if (threadIdx.x != 0) return;
  if (any) atomicOr(&state[0], 1u);
  __threadfence();
  const unsigned int ticket = atomicAdd(&state[1], 1u);
  if (ticket != gridDim.x - 1) return;
  __threadfence();
  const unsigned int flag = atomicExch(&state[0], 0u);
  const int c = bump ? *count + 1 : 0;
  *count = c;
  const unsigned int go = (flag != 0u && c <= cap) ? 1u : 0u;
  state[2] = go;
  state[1] = 0u;
  if (set_handle) cudaGraphSetConditional(handle, go);
}

template <typename T>
int launch(const T* x, const T* x_prev, const T* tol, long long n, int* count,
           unsigned int* state, int bump, int cap,
           unsigned long long handle, int set_handle, void* stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
  fixed_point_cond_kernel<T>
      <<<static_cast<unsigned int>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          x, x_prev, tol, n, count, state, bump, cap,
          static_cast<cudaGraphConditionalHandle>(handle), set_handle);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface for ctypes. `count` is one int32, `state` three uint32 (zero
// before the first launch). Returns cudaGetLastError() after the launch.
extern "C" int fixed_point_cond_launch(const float* x, const float* x_prev,
                                       const float* tol, long long n,
                                       int* count, unsigned int* state,
                                       int bump, int cap,
                                       unsigned long long handle,
                                       int set_handle, void* stream) {
  return launch<float>(x, x_prev, tol, n, count, state, bump, cap, handle,
                       set_handle, stream);
}

extern "C" int fixed_point_cond_launch_bf16(
    const __nv_bfloat16* x, const __nv_bfloat16* x_prev,
    const __nv_bfloat16* tol, long long n, int* count, unsigned int* state,
    int bump, int cap, unsigned long long handle, int set_handle,
    void* stream) {
  return launch<__nv_bfloat16>(x, x_prev, tol, n, count, state, bump, cap,
                               handle, set_handle, stream);
}

// --- the WHILE node under stream capture ------------------------------------
//
// The same surgery as ATen's CUDAGraph::begin_capture_to_if_node with
// another node type: the graph being captured on `stream` gets a
// conditional handle, then a WHILE node on the stream's current
// dependencies; the stream continues after the node, and `body_stream`
// captures into the node's body graph until while_node_end.

namespace {

cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph,
                                             deps, nullptr, n);
#else
  cudaError_t err =
      cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, n);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive
             ? cudaSuccess
             : cudaErrorIllegalState;
}

}  // namespace

// A condition handle of the graph that `stream` is capturing, no default
// value: kernel F sets it before the node and at the end of each pass.
extern "C" int while_handle_create(void* stream,
                                   unsigned long long* handle) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaError_t err =
      capture_info(static_cast<cudaStream_t>(stream), &graph, &deps, &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphConditionalHandle h;
  err = cudaGraphConditionalHandleCreate(&h, graph, 0, 0);
  *handle = static_cast<unsigned long long>(h);
  return static_cast<int>(err);
}

// Add the WHILE node on `handle` after everything `stream` has captured so
// far, make the stream continue after it, and start capturing
// `body_stream` into its body graph (capture mode `mode`, the parent's).
extern "C" int while_node_begin(void* stream, unsigned long long handle,
                                void* body_stream, int mode) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaError_t err = capture_info(s, &graph, &deps, &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = static_cast<cudaGraphConditionalHandle>(handle);
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n, &params);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraph_t body = params.conditional.phGraph_out[0];
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), body, nullptr, nullptr, 0,
      static_cast<cudaStreamCaptureMode>(mode)));
}

// End the body's capture.
extern "C" int while_node_end(void* body_stream) {
  cudaGraph_t body;
  return static_cast<int>(
      cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body));
}

// The name of a CUDA error code ("cudaErrorNotSupported").
extern "C" const char* cuda_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}
