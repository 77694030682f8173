// rmsnorm_matmul: out = bf16(bf16(rmsnorm(x, scale)) @ w), f32 accumulation.
//
// Replaces the Pallas kernel `repro/kernels/fused.py` build_rmsnorm_matmul
// (prologue `_norm_tile`, body `matmul._matmul_kernel`).
//
// Bound on an H100 (3.35 TB/s, 989 TFLOP/s bf16): at decode, M = slots (8)
// and the call is bytes-bound by the weight: qwen3-14b's gate/up weight
// (5120 x 17408 bf16, 178 MB) takes at least 53 us. At prefill (M = 512,
// 2*M*K*N / (K*N*2) = M = 512 flops per weight
// byte, above the card's ~295) it is bound by operations instead.
//
// Design, by shape:
//   * M <= 16 (decode), K and N multiples of 8: the decode kernel of
//     decode_gemm.cuh (`decode::tma_gemv_kernel<true,0>`): the weight
//     streamed by TMA into tensor-core MMAs, split over k inside a thread
//     block cluster; each CTA sums the squares of its slice of x, the
//     cluster exchanges the sums through DSMEM and each CTA normalises its
//     own slice. One launch, no workspace;
//   * M > 16, K and N multiples of 8 (prefill): `norm_rows_kernel`, a warp
//     a row, computes each row's 1/rms once and writes bf16((x * rstd) *
//     (1 + scale)) into a bf16 (M, K) workspace (5.2 MB at M 512 K 5120,
//     which stays in the 50 MB L2); then the TMA + wgmma mainloop of
//     wgmma_gemm.cuh multiplies it by w. The reference rounds the
//     normalised rows to bf16 before the product, so rstd cannot move into
//     the epilogue; the workspace costs one write and one read of x's size.
//   * any other shape (K or N not a multiple of 8): common.cuh's split-K
//     path at M <= 16, gemm::tile_kernel at M > 16, which normalise the
//     rows as they stage them.
#include "decode_gemm.cuh"

namespace {
constexpr int ROWS = 4;                 // rows (warps) a block
constexpr int U = 4;                    // 16-byte loads a lane keeps in flight

// One warp a row: the sum of squares, then the normalised row, each pass
// with U loads in flight a lane (the row's second read comes from L2).
__global__ void __launch_bounds__(ROWS * 32)
norm_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ scale,
                 bf16* __restrict__ xn, int M, int K, float eps) {
  const int row = blockIdx.x * ROWS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;                 // whole warps leave together
  const bf16* xr = x + (size_t)row * K;
  float ss = 0.f;
  for (int k0 = lane * 8; k0 < K; k0 += 256 * U) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = load8_reg(xr, k0 + u * 256, K);
#pragma unroll
    for (int u = 0; u < U; ++u) {       // past K: zeros
      float f[8];
      unpack8(v[u], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) ss += f[j] * f[j];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float rstd = rsqrtf(ss / (float)K + eps);
  bf16* o = xn + (size_t)row * K;
  for (int k0 = lane * 8; k0 < K; k0 += 256 * U) {
    uint4 v[U], s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      v[u] = load8_reg(xr, k0 + u * 256, K);
      s[u] = load8_reg(scale, k0 + u * 256, K);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)         // K % 8 == 0: whole vectors
      if (k0 + u * 256 < K)
        *reinterpret_cast<uint4*>(o + k0 + u * 256) = norm8(v[u], s[u], rstd);
  }
}
}  // namespace

// f32 workspace (in floats): the bf16 normalised rows on the wgmma path,
// the split-K partials at M <= 16 with K or N % 8 != 0, none on the decode
// kernel and on the tile path.
extern "C" size_t rmsnorm_matmul_workspace_floats(int M, int N, int K) {
  if (M > 0 && K > 0 && hopper::takes_prefill(M, N, K))
    return ((size_t)M * K + 1) / 2;
  return decode_workspace_floats(M, N, K);
}

extern "C" int rmsnorm_matmul_decode_plan(int M, int N, int K, int boxes,
                                          int cluster, int* plan) {
  return decode::report<true, EPI_NONE>(M, N, K, boxes, cluster, plan);
}

// `tile_n` pins the mainloop's N tile, `boxes` / `cluster` the decode
// kernel's plan (0: the kernel's own); a pin the shape's path does not have
// is refused.
extern "C" int rmsnorm_matmul_bf16(const void* x, const void* scale,
                                   const void* w, void* out, void* workspace,
                                   int M, int N, int K, float eps, int tile_n,
                                   int boxes, int cluster, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if (!hopper::takes_prefill(M, N, K)) {
    if (tile_n != 0) return (int)cudaErrorInvalidValue;
    return launch_matmul<true, EPI_NONE>(x, scale, w, nullptr, out,
                                         (float*)workspace, M, N, K, eps,
                                         stream, boxes, cluster);
  }
  if (workspace == nullptr || boxes != 0 || cluster != 0 ||
      hopper::plan(M, N, tile_n).bn == 0)
    return (int)cudaErrorInvalidValue;
  bf16* xn = static_cast<bf16*>(workspace);
  norm_rows_kernel<<<(M + ROWS - 1) / ROWS, ROWS * 32, 0,
                     (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)scale, xn, M, K, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return hopper::launch<EPI_NONE, hopper::OWNER_RMSNORM_MATMUL>(
      xn, w, nullptr, out, M, N, K, stream, tile_n);
}
