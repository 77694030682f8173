// matmul_bias_act: out = bf16(act(f32(bf16(a @ b)) + f32(bias))), act none,
// gelu (tanh form) or silu.
//
// Replaces the Pallas kernel `repro/kernels/fused.py` build_matmul_bias_act
// (body `matmul._matmul_kernel`, bias and activation in the store
// epilogue). The double rounding is the reference kernel's: its matmul body
// stores acc.astype(bf16), and the epilogue hook adds the bias to that
// already-rounded value in f32, applies the activation and rounds again
// (`ops._ref_matmul_bias_act` rounds once).
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s): whisper-small's encoder
// FFN at 8 x 1500 frames (M = 12000, K 768 / N 3072 and back) is 56.6 GFLOP
// a call, at least 57 us, bound by operations.
//
// Design: the same two matmul paths as rmsnorm_matmul (see common.cuh):
// split-K weight streaming for M <= 16, tiled wmma above, M masked at the
// ragged edge (12000 is no multiple of the 64-row tile). The bias is read
// and the activation applied in the epilogue (the tile store, or the
// split-K finish), so the pre-activation never round-trips device memory.
#include "common.cuh"

extern "C" size_t matmul_bias_act_workspace_floats(int M, int N, int K) {
  return split_k_workspace_floats(M, N, K);
}

// act: 0 none, 1 gelu, 2 silu (the wrapper's ACTS order).
extern "C" int matmul_bias_act_bf16(const void* a, const void* b,
                                    const void* bias, void* out,
                                    void* workspace, int M, int N, int K,
                                    int act, void* stream) {
  float* ws = (float*)workspace;
  switch (act) {
    case 0:
      return launch_matmul<false, EPI_BIAS>(a, nullptr, b, bias, out, ws, M,
                                            N, K, 0.f, stream);
    case 1:
      return launch_matmul<false, EPI_BIAS_GELU>(a, nullptr, b, bias, out, ws,
                                                 M, N, K, 0.f, stream);
    case 2:
      return launch_matmul<false, EPI_BIAS_SILU>(a, nullptr, b, bias, out, ws,
                                                 M, N, K, 0.f, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
