// axpy: out = T(f32(alpha) * f32(x) + f32(y)), T the operands' dtype
// (f32 or bf16); alpha an f32 scalar read from device memory.
//
// Replaces the Pallas kernel `repro/kernels/axpy.py` _axpy_kernel / axpy,
// the paper's low-intensity Table 1 kernel (alpha read from SMEM there).
//
// Bound on an H100 (3.35 TB/s): bytes-bound, 2 flops per 3 elements moved;
// 2^28 f32 elements take at least 0.961 ms.
//
// Design: one pass, 16 bytes a thread a load (4 f32 or 8 bf16), a grid
// sized to a few waves that strides over the vectors, a scalar tail. The
// product and the sum are rounded separately (__fmul_rn, __fadd_rn), as the
// reference computes them, so no FMA contraction changes the result.
#include "common.cuh"

namespace {
constexpr int THREADS = 256;

__device__ __forceinline__ float axpy1(float a, float x, float y) {
  return __fadd_rn(__fmul_rn(a, x), y);
}

__global__ void __launch_bounds__(THREADS)
axpy_kernel_f32(const float* __restrict__ alpha, const float* __restrict__ x,
                const float* __restrict__ y, float* __restrict__ out,
                size_t n) {
  const float a = *alpha;
  const size_t nv = n / 4;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < nv;
       i += stride) {
    const float4 xv = __ldg(reinterpret_cast<const float4*>(x) + i);
    const float4 yv = __ldg(reinterpret_cast<const float4*>(y) + i);
    reinterpret_cast<float4*>(out)[i] =
        make_float4(axpy1(a, xv.x, yv.x), axpy1(a, xv.y, yv.y),
                    axpy1(a, xv.z, yv.z), axpy1(a, xv.w, yv.w));
  }
  for (size_t i = nv * 4 + (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    out[i] = axpy1(a, x[i], y[i]);
}

__global__ void __launch_bounds__(THREADS)
axpy_kernel_bf16(const float* __restrict__ alpha, const bf16* __restrict__ x,
                 const bf16* __restrict__ y, bf16* __restrict__ out,
                 size_t n) {
  const float a = *alpha;
  const size_t nv = n / 8;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < nv;
       i += stride) {
    float xf[8], yf[8];
    unpack8(__ldg(reinterpret_cast<const uint4*>(x) + i), xf);
    unpack8(__ldg(reinterpret_cast<const uint4*>(y) + i), yf);
    __align__(16) bf16 o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16(axpy1(a, xf[j], yf[j]));
    reinterpret_cast<uint4*>(out)[i] = *reinterpret_cast<uint4*>(o);
  }
  for (size_t i = nv * 8 + (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    out[i] = __float2bfloat16(
        axpy1(a, __bfloat162float(x[i]), __bfloat162float(y[i])));
}

// blocks for `vectors` 16-byte vectors: one per 256 of them, at most
// 8 waves of 8 resident blocks per SM
unsigned grid_for(size_t vectors) {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t want = (vectors + THREADS - 1) / THREADS;
  const size_t cap = (size_t)sms * 64;
  return (unsigned)(want < 1 ? 1 : (want > cap ? cap : want));
}
}  // namespace

// Operands are 16-byte aligned (the wrapper checks 32) and hold n values.
extern "C" int axpy_f32(const void* alpha, const void* x, const void* y,
                        void* out, size_t n, void* stream) {
  if (n == 0) return (int)cudaErrorInvalidValue;
  axpy_kernel_f32<<<grid_for(n / 4 + 1), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)alpha, (const float*)x, (const float*)y, (float*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int axpy_bf16(const void* alpha, const void* x, const void* y,
                         void* out, size_t n, void* stream) {
  if (n == 0) return (int)cudaErrorInvalidValue;
  axpy_kernel_bf16<<<grid_for(n / 8 + 1), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)alpha, (const bf16*)x, (const bf16*)y, (bf16*)out, n);
  return (int)cudaGetLastError();
}
