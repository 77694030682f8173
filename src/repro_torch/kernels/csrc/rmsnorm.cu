// rmsnorm: out (M,D) = x * rsqrt(mean(x^2) + eps) * (1 + scale), the
// arithmetic in f32 and one rounding to x's dtype (f32 or bf16).
//
// Replaces the Pallas kernel `repro/kernels/rmsnorm.py` _rmsnorm_kernel /
// rmsnorm: row blocks streamed through VMEM with the scale resident.
//
// Bound on an H100 (3.35 TB/s): bytes, 2 * M * D * size + D * size; qwen3-14b
// at M = 512 rows of 5120 bf16 moves 10.5 MB, at least 3.1 us.
//
// Design: one warp per row, four rows a block. The warp reads its row once
// to sum the squares (16-byte loads, eight bf16 or four f32 a lane, f32
// sums reduced by shuffles), then again, from L2, to normalise and store.
// No shared memory, no atomics: the sum order is fixed, so two runs give
// the same bits.
#include "common.cuh"

namespace {
constexpr int WARPS = 4, THREADS = WARPS * 32;

// V = 16 / sizeof(T) values of one row at `col` (holding `n`) as f32, zero
// past `n`: one 16-byte load when whole and aligned.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void load(const float* row, int col,
                                              int n, float* f) {
    const float* src = row + col;
    if (col + V <= n && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src));
      f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) f[i] = col + i < n ? src[i] : 0.f;
    }
  }
  static __device__ __forceinline__ void store(float* row, int col, int n,
                                               const float* f) {
    float* dst = row + col;
    if (col + V <= n && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (col + i < n) dst[i] = f[i];
    }
  }
};

template <>
struct Vec<bf16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ void load(const bf16* row, int col,
                                              int n, float* f) {
    unpack8(load8_reg(row, col, n), f);
  }
  static __device__ __forceinline__ void store(bf16* row, int col, int n,
                                               const float* f) {
    __align__(16) bf16 o[V];
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = __float2bfloat16(f[i]);
    bf16* dst = row + col;
    if (col + V <= n && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (col + i < n) dst[i] = o[i];
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ out, int M, int D, float eps) {
  constexpr int V = Vec<T>::V;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= M) return;
  const T* xr = x + (size_t)row * D;
  float ss = 0.f;
  for (int c = lane * V; c < D; c += 32 * V) {
    float f[V];
    Vec<T>::load(xr, c, D, f);
#pragma unroll
    for (int i = 0; i < V; ++i) ss += f[i] * f[i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float rstd = rsqrtf(ss / (float)D + eps);
  T* orow = out + (size_t)row * D;
  for (int c = lane * V; c < D; c += 32 * V) {
    float f[V], s[V];
    Vec<T>::load(xr, c, D, f);
    Vec<T>::load(scale, c, D, s);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = f[i] * rstd * (1.f + s[i]);
    Vec<T>::store(orow, c, D, f);
  }
}

template <typename T>
int launch(const void* x, const void* scale, void* out, int M, int D,
           float eps, void* stream) {
  if (M <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  rmsnorm_kernel<T><<<(M + WARPS - 1) / WARPS, THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const T*)x, (const T*)scale, (T*)out, M, D, eps);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" int rmsnorm_f32(const void* x, const void* scale, void* out, int M,
                           int D, float eps, void* stream) {
  return launch<float>(x, scale, out, M, D, eps, stream);
}

extern "C" int rmsnorm_bf16(const void* x, const void* scale, void* out,
                            int M, int D, float eps, void* stream) {
  return launch<bf16>(x, scale, out, M, D, eps, stream);
}
