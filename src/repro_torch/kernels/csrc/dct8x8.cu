// dct8x8: out[n] = C (X[n] C^T) for each 8x8 block X[n] of (N,8,8) f32,
// C the orthonormal DCT-II matrix, passed in as an (8,8) f32 operand.
//
// Replaces the Pallas kernel `repro/kernels/dct8x8.py` _dct_kernel /
// dct8x8: the paper's Table 1 `dct` (JPEG-style block transform), there
// two small batched MXU products per grid step.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s f32): bytes-bound, 4 flops per
// byte moved; 4,194,304 blocks take at least 0.641 ms.
//
// Design: a block of 256 threads takes 16 consecutive 8x8 blocks (4 KB,
// contiguous) at a time, four elements a thread 256 apart, so loads and
// stores are coalesced and four loads a thread are in flight. Thread
// (b, i, l) keeps rows l and i of C in registers; for each of its four
// 8x8 blocks it computes T[i][l] = sum_k X[i][k] C[l][k] from row i of X
// in shared memory (two float4 reads), stores T transposed, and then
// Y[i][l] = sum_j C[i][j] T[j][l] from column l of T (again two float4
// reads). The grid strides over groups of 16 blocks; N is arbitrary.
#include "common.cuh"

namespace {
constexpr int THREADS = 256, Q = 4, PER = Q * THREADS / 64;  // blocks a step

__global__ void __launch_bounds__(THREADS)
dct8x8_kernel(const float* __restrict__ x, const float* __restrict__ c,
              float* __restrict__ out, size_t n) {
  __shared__ __align__(16) float xs[Q * THREADS];
  __shared__ __align__(16) float tt[Q * THREADS];  // T, transposed per block
  const int t = threadIdx.x, b = t / 64, i = (t % 64) / 8, l = t % 8;
  float cl[8], ci[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    cl[k] = __ldg(c + l * 8 + k);
    ci[k] = __ldg(c + i * 8 + k);
  }
  const size_t total = n * 64;
  const size_t groups = (n + PER - 1) / PER;
  for (size_t g = blockIdx.x; g < groups; g += gridDim.x) {
    const size_t base = g * (size_t)(Q * THREADS) + t;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const size_t idx = base + q * THREADS;
      xs[q * THREADS + t] = idx < total ? __ldg(x + idx) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float* xr = xs + q * THREADS + b * 64 + i * 8;
      float row[8];
      *reinterpret_cast<float4*>(row) = *reinterpret_cast<const float4*>(xr);
      *reinterpret_cast<float4*>(row + 4) =
          *reinterpret_cast<const float4*>(xr + 4);
      float tv = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) tv = fmaf(row[k], cl[k], tv);
      tt[q * THREADS + b * 64 + l * 8 + i] = tv;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float* tc = tt + q * THREADS + b * 64 + l * 8;
      float col[8];
      *reinterpret_cast<float4*>(col) = *reinterpret_cast<const float4*>(tc);
      *reinterpret_cast<float4*>(col + 4) =
          *reinterpret_cast<const float4*>(tc + 4);
      float y = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) y = fmaf(ci[j], col[j], y);
      const size_t idx = base + q * THREADS;
      if (idx < total) out[idx] = y;
    }
  }
}
}  // namespace

extern "C" int dct8x8_f32(const void* x, const void* c, void* out, size_t n,
                          void* stream) {
  if (n == 0) return (int)cudaErrorInvalidValue;
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t groups = (n + PER - 1) / PER;
  const size_t cap = (size_t)sms * 8;            // one wave, 8 blocks a SM
  const unsigned grid = (unsigned)(groups < cap ? groups : cap);
  dct8x8_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)c, (float*)out, n);
  return (int)cudaGetLastError();
}
