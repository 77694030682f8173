// matmul: out (M,N) = a (M,K) @ b (K,N), f32 accumulation, output in the
// operands' dtype (f32 or bf16), row-major, M, N and K masked at the edge.
//
// Replaces the Pallas kernel `repro/kernels/matmul.py` _matmul_kernel /
// matmul: the paper's Table 1 `matmul`, an output tile held across the K
// loop (MemPool's register tile) while operand tiles stream in.
//
// Bound on an H100 (67 TFLOP/s f32 on the CUDA cores, 495 TFLOP/s TF32 and
// 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s): operations-bound at
// every size the suite runs; 4096^3 takes at least 0.833 ms in f32 as three
// TF32 products (2.05 ms on the CUDA cores) and 0.139 ms in bf16.
//
// bf16, by shape (no prologue, no epilogue beyond the one rounding):
//   * M > 16, K and N multiples of 8: the TMA + wgmma mainloop of
//     wgmma_gemm.cuh, persistent when the tiles outnumber the SMs (4096^3
//     at BN 256: 512 tiles on 132 blocks);
//   * M <= 16, K and N multiples of 8: the decode kernel of
//     decode_gemm.cuh (`decode::tma_gemv_kernel<false,0>`: the weight
//     stream by TMA, tensor-core MMAs, split-K inside a cluster);
//   * any other shape: common.cuh's split-K path at M <= 16, the 64 x 128
//     wmma tile at M > 16.
//
// f32, by shape:
//   * K and N multiples of 4: three TF32 products on the tensor cores
//     (tf32x3_gemm.cuh: each operand split into a rounded TF32 part and a
//     TF32 remainder; at M > 256 b is split once by a pass of its own into
//     the workspace, at M <= 256 by the product itself), as accurate as an
//     f32 product;
//   * any other shape: true f32 on the CUDA cores (no TF32, no operand
//     rounding), `sgemm::matmul_f32_kernel`. A block of 256 threads owns a
//     128 x 128 output tile and each thread an 8 x 8 register tile (64 FMAs
//     for 16 shared-memory loads). K is walked 8 at a time through two
//     shared-memory buffers: the next step's A and B tiles are loaded into
//     registers while the current one is multiplied, A stored transposed so
//     that both operands are read as float4 along the tile.
#include "decode_gemm.cuh"
#include "tf32x3_gemm.cuh"

namespace sgemm {
constexpr int BM = 128, BN = 128, BK = 8, TM = 8, TN = 8, THREADS = 256;

// four consecutive floats of one row at `col` (holding `n`), zero past
// `n`: one float4 load when whole and aligned.
__device__ __forceinline__ float4 load4(const float* row, int col, int n) {
  const float* src = row + col;
  if (col + 4 <= n && (reinterpret_cast<uintptr_t>(src) & 15) == 0)
    return __ldg(reinterpret_cast<const float4*>(src));
  float4 v;
  v.x = col + 0 < n ? src[0] : 0.f;
  v.y = col + 1 < n ? src[1] : 0.f;
  v.z = col + 2 < n ? src[2] : 0.f;
  v.w = col + 3 < n ? src[3] : 0.f;
  return v;
}

__global__ void __launch_bounds__(THREADS)
matmul_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) float As[2][BK][BM];   // A tile, transposed
  __shared__ __align__(16) float Bs[2][BK][BN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int ty = tid / (BN / TN), tx = tid % (BN / TN);   // 16 x 16
  // A: 128 rows x 8 k, one float4 a thread; B: 8 k rows x 128, likewise
  const int ar = tid / 2, ac = (tid % 2) * 4;
  const int br = tid / (BN / 4), bc = (tid % (BN / 4)) * 4;

  float4 ra, rb;
  auto fetch = [&](int k0) {
    ra = (m0 + ar < M) ? load4(a + (size_t)(m0 + ar) * K, k0 + ac, K)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    rb = (k0 + br < K) ? load4(b + (size_t)(k0 + br) * N, n0 + bc, N)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto stash = [&](int buf) {
    As[buf][ac + 0][ar] = ra.x;
    As[buf][ac + 1][ar] = ra.y;
    As[buf][ac + 2][ar] = ra.z;
    As[buf][ac + 3][ar] = ra.w;
    *reinterpret_cast<float4*>(&Bs[buf][br][bc]) = rb;
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  fetch(0);
  stash(0);
  __syncthreads();
  const int steps = (K + BK - 1) / BK;
  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1;
    if (t + 1 < steps) fetch((t + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
      *reinterpret_cast<float4*>(av) =
          *reinterpret_cast<const float4*>(&As[cur][kk][ty * TM]);
      *reinterpret_cast<float4*>(av + 4) =
          *reinterpret_cast<const float4*>(&As[cur][kk][ty * TM + 4]);
      *reinterpret_cast<float4*>(bv) =
          *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * TN]);
      *reinterpret_cast<float4*>(bv + 4) =
          *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * TN + 4]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (t + 1 < steps) stash(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * TM + i;
    if (row >= M) break;
    float* dst = out + (size_t)row * N;
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      const int col = n0 + tx * TN + j;
      if (col + 4 <= N && (reinterpret_cast<uintptr_t>(dst + col) & 15) == 0) {
        *reinterpret_cast<float4*>(dst + col) =
            make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (col + u < N) dst[col + u] = acc[i][j + u];
      }
    }
  }
}
}  // namespace sgemm

// f32 workspace (in floats) of an (M, K) x (K, N) product: with `f32`,
// b's hi and lo parts when the 3xTF32 route splits b in a pass of its own
// (2NK), else none; in bf16, the decode path's (decode_workspace_floats).
extern "C" size_t matmul_workspace_floats(int M, int N, int K, int f32) {
  if (f32) return tf32x3::workspace_floats(M, N, K);
  return decode_workspace_floats(M, N, K);
}

extern "C" int matmul_decode_plan(int M, int N, int K, int boxes,
                                  int cluster, int* plan) {
  return decode::report<false, EPI_NONE>(M, N, K, boxes, cluster, plan);
}

// How an f32 product runs, for reports: {route (1: 3xTF32 on the tensor
// cores after the split pass, 2: the same with b split in the product, 0:
// the CUDA-core tile), N tile, cluster size, tiles, blocks, k a block
// walks, ring stages} in `plan` (the CUDA-core tile: {0, 128, 1, tiles,
// tiles, K, 2}), under the pinned `tile_n` / `cluster` (0: searched; the
// CUDA-core tile takes no pin).
extern "C" int matmul_f32_plan(int M, int N, int K, int tile_n, int cluster,
                               int* plan) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if (!tf32x3::takes(N, K)) {
    if (tile_n != 0 || cluster != 0) return (int)cudaErrorInvalidValue;
    const int tiles = ((M + sgemm::BM - 1) / sgemm::BM) *
                      ((N + sgemm::BN - 1) / sgemm::BN);
    const int v[7] = {0, sgemm::BN, 1, tiles, tiles, K, 2};
    for (int i = 0; i < 7; ++i) plan[i] = v[i];
    return 0;
  }
  const tf32x3::Plan p = tf32x3::plan(M, N, K, tile_n, cluster);
  if (p.bn == 0) return (int)cudaErrorInvalidValue;
  const int v[7] = {p.fused ? 2 : 1, p.bn, p.cluster, p.tiles, p.blocks,
                    p.kper * tf32x3::BK, p.stages};
  for (int i = 0; i < 7; ++i) plan[i] = v[i];
  return 0;
}

// f32: K % 4 == 0 and N % 4 == 0 on the tensor cores (tf32x3_gemm.cuh:
// the split pass into `workspace` and the product, or at M <= 256 the
// product alone), any other shape on the CUDA-core tile above. The route
// is chosen on the shape alone; a failed launch is returned, never retried
// on the other. `tile_n` / `cluster` pin the 3xTF32 plan (0: searched);
// `boxes` belongs to the bf16 decode kernel, and the CUDA-core tile takes
// no pin: both are refused.
extern "C" int matmul_f32(const void* a, const void* b, void* out,
                          void* workspace, int M, int N, int K, int tile_n,
                          int boxes, int cluster, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || boxes != 0)
    return (int)cudaErrorInvalidValue;
  if (tf32x3::takes(N, K))
    return tf32x3::launch(a, b, out, (float*)workspace, M, N, K,
                          (cudaStream_t)stream, tile_n, cluster);
  if (tile_n != 0 || cluster != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + sgemm::BM - 1) / sgemm::BM,
                  (N + sgemm::BN - 1) / sgemm::BN);
  sgemm::matmul_f32_kernel<<<grid, sgemm::THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)out, M, N, K);
  return (int)cudaGetLastError();
}

// bf16: `tile_n` pins the mainloop's N tile, `boxes` / `cluster` the
// decode kernel's plan (0: the kernel's own); a pin the shape's path does
// not have is refused.
extern "C" int matmul_bf16(const void* a, const void* b, void* out,
                           void* workspace, int M, int N, int K, int tile_n,
                           int boxes, int cluster, void* stream) {
  if (hopper::takes_prefill(M, N, K)) {
    if (boxes != 0 || cluster != 0) return (int)cudaErrorInvalidValue;
    return hopper::launch<EPI_NONE, hopper::OWNER_MATMUL>(
        a, b, nullptr, out, M, N, K, stream, tile_n);
  }
  if (tile_n != 0) return (int)cudaErrorInvalidValue;
  return launch_matmul<false, EPI_NONE>(a, nullptr, b, nullptr, out,
                                        (float*)workspace, M, N, K, 0.f,
                                        stream, boxes, cluster);
}
