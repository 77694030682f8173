// matmul_residual_add: out = bf16(f32(bf16(a @ b)) + f32(res)).
//
// Replaces the Pallas kernel `repro/kernels/fused.py`
// build_matmul_residual_add (body `matmul._matmul_kernel`, residual added
// in the store epilogue). The double rounding is the reference kernel's:
// its matmul body stores acc.astype(bf16) and the epilogue hook adds the
// residual to that already-rounded value (`epilogue<EPI_RESID>` of
// common.cuh, on every path).
//
// Bound on an H100 (3.35 TB/s, 989 TFLOP/s bf16): at decode (M = 8)
// bytes-bound by the weight — qwen3-14b's out-projection (5120 x 5120,
// 52 MB) at least 16 us, the down-projection (17408 x 5120, 178 MB) at
// least 53 us; at prefill (M = 512) operations-bound, the down projection
// at least 92 us.
//
// Design, by shape:
//   * M > 16, K and N multiples of 8 (prefill): the TMA + wgmma mainloop
//     of wgmma_gemm.cuh with the residual read in its register epilogue;
//     qwen3's down projection at M 512 is 128 tiles of 128 x 160, one
//     wave, 272 k steps each;
//   * M <= 16 (decode), K and N multiples of 8: the decode kernel of
//     decode_gemm.cuh (`decode::tma_gemv_kernel<false,1>`, TMA weight
//     stream, tensor-core MMAs, split-K inside a cluster), the residual
//     added as the cluster's partials are reduced; one launch, no
//     workspace;
//   * any other shape: common.cuh's split-K path at M <= 16 (the residual
//     added in its finish), the 64 x 128 wmma tile at M > 16.
// The rounded matmul output never round-trips device memory as bf16.
#include "decode_gemm.cuh"

extern "C" size_t matmul_residual_add_workspace_floats(int M, int N, int K) {
  return decode_workspace_floats(M, N, K);
}

extern "C" int matmul_residual_add_decode_plan(int M, int N, int K,
                                               int boxes, int cluster,
                                               int* plan) {
  return decode::report<false, EPI_RESID>(M, N, K, boxes, cluster, plan);
}

// `tile_n` pins the mainloop's N tile, `boxes` / `cluster` the decode
// kernel's plan (0: the kernel's own); a pin the shape's path does not have
// is refused.
extern "C" int matmul_residual_add_bf16(const void* a, const void* b,
                                        const void* res, void* out,
                                        void* workspace, int M, int N, int K,
                                        int tile_n, int boxes, int cluster,
                                        void* stream) {
  if (hopper::takes_prefill(M, N, K)) {
    if (boxes != 0 || cluster != 0) return (int)cudaErrorInvalidValue;
    return hopper::launch<EPI_RESID, hopper::OWNER_MATMUL_RESIDUAL_ADD>(
        a, b, res, out, M, N, K, stream, tile_n);
  }
  if (tile_n != 0) return (int)cudaErrorInvalidValue;
  return launch_matmul<false, EPI_RESID>(a, nullptr, b, res, out,
                                         (float*)workspace, M, N, K, 0.f,
                                         stream, boxes, cluster);
}
