// conv2d_3x3: out (H,W) = the zero-padded "same" 3x3 correlation of x
// (H,W) with w (3,3), in f32.
//
// Replaces the Pallas kernel `repro/kernels/conv2d.py` _conv_kernel /
// conv2d_3x3: the paper's Table 1 `2dconv`. There a row block gets its
// halo rows from the neighbour blocks, zero only at the image's edge; the
// result is the zero-padded correlation at every block boundary, which is
// what a halo staged from the image itself gives here.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s f32): bytes-bound, 18 flops per
// 8 bytes; 8192 x 8192 takes at least 0.160 ms.
//
// Design: a block of 64 x 4 threads owns a 16-row x 64-column output tile
// and stages its (16+2) x (64+2) input tile, halo included, in shared
// memory, zero outside the image: each input value is read from device
// memory once per tile that needs it (16% more than once at this tile, the
// rest from L2). The nine products are summed in the reference's order
// (dy outer, dx inner, from 0), each product and each sum rounded on its
// own (__fmul_rn, __fadd_rn), so the kernel gives the plain version's bits.
// H and W are arbitrary.
#include "common.cuh"

namespace {
constexpr int TW = 64, TH = 16, TY = 4;

__global__ void __launch_bounds__(TW * TY)
conv2d_3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, int H, int W) {
  __shared__ float tile[TH + 2][TW + 2];
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;
  for (int i = tid; i < (TH + 2) * (TW + 2); i += TW * TY) {
    const int r = y0 - 1 + i / (TW + 2), c = x0 - 1 + i % (TW + 2);
    tile[i / (TW + 2)][i % (TW + 2)] =
        (r >= 0 && r < H && c >= 0 && c < W) ? __ldg(x + (size_t)r * W + c)
                                             : 0.f;
  }
  float wr[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) wr[j] = __ldg(w + j);
  __syncthreads();
  const int c = x0 + threadIdx.x;
  if (c >= W) return;
#pragma unroll
  for (int ry = threadIdx.y; ry < TH; ry += TY) {
    const int r = y0 + ry;
    if (r >= H) break;
    float acc = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        acc = __fadd_rn(acc, __fmul_rn(wr[dy * 3 + dx],
                                       tile[ry + dy][threadIdx.x + dx]));
    out[(size_t)r * W + c] = acc;
  }
}
}  // namespace

extern "C" int conv2d_3x3_f32(const void* x, const void* w, void* out, int H,
                              int W, void* stream) {
  if (H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  conv2d_3x3_kernel<<<grid, dim3(TW, TY), 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (float*)out, H, W);
  return (int)cudaGetLastError();
}
