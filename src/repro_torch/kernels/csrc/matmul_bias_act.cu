// matmul_bias_act: out = bf16(act(f32(bf16(a @ b)) + f32(bias))), act none,
// gelu (tanh form) or silu.
//
// Replaces the Pallas kernel `repro/kernels/fused.py` build_matmul_bias_act
// (body `matmul._matmul_kernel`, bias and activation in the store
// epilogue). The double rounding is the reference kernel's: its matmul body
// stores acc.astype(bf16), and the epilogue hook adds the bias to that
// already-rounded value in f32, applies the activation and rounds again
// (`epilogue<EPI_BIAS*>` of common.cuh, on every path;
// `ops._ref_matmul_bias_act` rounds once).
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s): whisper-small's encoder
// FFN at 8 x 1500 frames (M = 12000, K 768 / N 3072 and back) is 56.6 GFLOP
// a call, at least 57 us, bound by operations.
//
// Design, by shape:
//   * M > 16, K and N multiples of 8 (whisper's encoder MLP): the TMA +
//     wgmma mainloop of wgmma_gemm.cuh under an owner of its own, the bias
//     read 8 values a load and the activation applied in its register
//     epilogue; at M 12000 it walks 1,316 tiles of 128 x 224 (N 3072) or
//     470 of 128 x 160 (N 768) on 132 persistent blocks;
//   * M <= 16 (decode), K and N multiples of 8: the decode kernel of
//     decode_gemm.cuh (`decode::tma_gemv_kernel<false,2..4>`), the bias
//     and activation applied as the cluster's partials are reduced; one
//     launch, no workspace;
//   * any other shape: common.cuh's split-K path at M <= 16 (bias and
//     activation in its finish), the 64 x 128 wmma tile at M > 16.
// The pre-activation never round-trips device memory.
#include "decode_gemm.cuh"

extern "C" size_t matmul_bias_act_workspace_floats(int M, int N, int K) {
  return decode_workspace_floats(M, N, K);
}

extern "C" int matmul_bias_act_decode_plan(int M, int N, int K, int boxes,
                                           int cluster, int* plan) {
  return decode::report<false, EPI_BIAS>(M, N, K, boxes, cluster, plan);
}

// act: 0 none, 1 gelu, 2 silu (the wrapper's ACTS order). `tile_n` pins
// the mainloop's N tile, `boxes` / `cluster` the decode kernel's plan (0:
// the kernel's own); a pin the shape's path does not have is refused.
extern "C" int matmul_bias_act_bf16(const void* a, const void* b,
                                    const void* bias, void* out,
                                    void* workspace, int M, int N, int K,
                                    int act, int tile_n, int boxes,
                                    int cluster, void* stream) {
  float* ws = (float*)workspace;
  const bool mainloop = hopper::takes_prefill(M, N, K);
  if (mainloop ? (boxes != 0 || cluster != 0) : tile_n != 0)
    return (int)cudaErrorInvalidValue;
  switch (act) {
    case 0:
      return mainloop
          ? hopper::launch<EPI_BIAS, hopper::OWNER_MATMUL_BIAS_ACT>(
                a, b, bias, out, M, N, K, stream, tile_n)
          : launch_matmul<false, EPI_BIAS>(a, nullptr, b, bias, out, ws, M,
                                           N, K, 0.f, stream, boxes, cluster);
    case 1:
      return mainloop
          ? hopper::launch<EPI_BIAS_GELU, hopper::OWNER_MATMUL_BIAS_ACT>(
                a, b, bias, out, M, N, K, stream, tile_n)
          : launch_matmul<false, EPI_BIAS_GELU>(a, nullptr, b, bias, out, ws,
                                                M, N, K, 0.f, stream, boxes,
                                                cluster);
    case 2:
      return mainloop
          ? hopper::launch<EPI_BIAS_SILU, hopper::OWNER_MATMUL_BIAS_ACT>(
                a, b, bias, out, M, N, K, stream, tile_n)
          : launch_matmul<false, EPI_BIAS_SILU>(a, nullptr, b, bias, out, ws,
                                                M, N, K, 0.f, stream, boxes,
                                                cluster);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
