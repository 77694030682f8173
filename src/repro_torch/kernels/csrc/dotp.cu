// dotp: out (a 0-d f32) = sum(f32(x) * f32(y)) over n values of x and y
// (f32 or bf16).
//
// Replaces the Pallas kernel `repro/kernels/dotp.py` _dotp_kernel / dotp:
// the paper's second memory-bound Table 1 kernel, per-core partial sums
// and a final reduction. The Pallas grid carries the sum from block to
// block in order; here the blocks run in parallel, so the carry becomes a
// second pass.
//
// Bound on an H100 (3.35 TB/s): bytes-bound; 2^28 f32 pairs take at least
// 0.641 ms.
//
// Design: pass 1, `dotp_partial_kernel`, a fixed grid of at most
// 8 blocks a SM; each thread walks its strided share of 16-byte vectors
// with an f32 sum, the block reduces its threads by warp shuffles and then
// over warps in shared memory, and writes one f32 partial to the
// workspace. Pass 2, `dotp_finish_kernel`, one block, sums the partials in
// a fixed order. No atomics: the order of every sum depends only on n and
// the card's SM count, so two runs give the same bits. Nothing is rounded
// through the operands' dtype.
#include "common.cuh"

namespace {
constexpr int THREADS = 256, FINISH = 1024;

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Sum over the calling block's threads, in a fixed order; valid in
// thread 0.
template <int NT>
__device__ __forceinline__ float block_sum(float s) {
  __shared__ float warps[NT / 32];
  s = warp_sum(s);
  if (threadIdx.x % 32 == 0) warps[threadIdx.x / 32] = s;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x < 32) {
    t = threadIdx.x < NT / 32 ? warps[threadIdx.x] : 0.f;
    t = warp_sum(t);
  }
  return t;
}

__device__ __forceinline__ float dot4(const float* x, const float* y,
                                      size_t i) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(x) + i);
  const float4 b = __ldg(reinterpret_cast<const float4*>(y) + i);
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float dot4(const bf16* x, const bf16* y,
                                      size_t i) {   // 8 values
  float a[8], b[8];
  unpack8(__ldg(reinterpret_cast<const uint4*>(x) + i), a);
  unpack8(__ldg(reinterpret_cast<const uint4*>(y) + i), b);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += a[j] * b[j];
  return s;
}

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
dotp_partial_kernel(const T* __restrict__ x, const T* __restrict__ y,
                    float* __restrict__ partials, size_t n) {
  constexpr int VEC = 16 / sizeof(T);
  const size_t nv = n / VEC;
  const size_t stride = (size_t)gridDim.x * THREADS;
  const size_t first = (size_t)blockIdx.x * THREADS + threadIdx.x;
  float s = 0.f;
#pragma unroll 4
  for (size_t i = first; i < nv; i += stride) s += dot4(x, y, i);
  for (size_t i = nv * VEC + first; i < n; i += stride)
    s += f32(x[i]) * f32(y[i]);
  s = block_sum<THREADS>(s);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

__global__ void __launch_bounds__(FINISH)
dotp_finish_kernel(const float* __restrict__ partials, int count,
                   float* __restrict__ out) {
  float s = 0.f;
  for (int i = threadIdx.x; i < count; i += FINISH) s += partials[i];
  s = block_sum<FINISH>(s);
  if (threadIdx.x == 0) *out = s;
}

int partial_blocks(size_t n, int vec) {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t want = (n / vec + THREADS - 1) / THREADS;
  const size_t cap = (size_t)sms * 8;          // one wave of 8 blocks a SM
  return (int)(want < 1 ? 1 : (want > cap ? cap : want));
}

template <typename T>
int launch(const void* x, const void* y, void* out, void* workspace,
           size_t n, void* stream) {
  if (n == 0 || workspace == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = partial_blocks(n, 16 / sizeof(T));
  dotp_partial_kernel<T><<<blocks, THREADS, 0, st>>>(
      (const T*)x, (const T*)y, (float*)workspace, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dotp_finish_kernel<<<1, FINISH, 0, st>>>((const float*)workspace, blocks,
                                           (float*)out);
  return (int)cudaGetLastError();
}
}  // namespace

// f32 partials the two passes exchange (the first pass's block count).
extern "C" size_t dotp_workspace_floats(size_t n) {
  return (size_t)partial_blocks(n, 4);
}

extern "C" int dotp_f32(const void* x, const void* y, void* out,
                        void* workspace, size_t n, void* stream) {
  return launch<float>(x, y, out, workspace, n, stream);
}

extern "C" int dotp_bf16(const void* x, const void* y, void* out,
                         void* workspace, size_t n, void* stream) {
  return launch<bf16>(x, y, out, workspace, n, stream);
}
