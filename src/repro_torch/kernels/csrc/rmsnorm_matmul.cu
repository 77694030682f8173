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
// Design: the normalised rows never exist in device memory. Each block
// computes the 1/rms of its rows once, then normalises the rows as it
// stages them into shared memory (in f32, rounded to bf16 as the reference
// prologue does). M <= 16 (decode) takes the split-K skinny path of
// common.cuh: the weight is streamed once with 16-byte loads, four k rows
// in flight per warp, f32 FMAs on the CUDA cores, and a fixed-order
// reduction over warps and splits. Larger M (prefill) takes the tiled
// wmma path, blocks ordered M-fastest so that the blocks sharing a weight
// column tile run together. Simple first: no TMA, no wgmma, no pipelining.
#include "common.cuh"

extern "C" size_t rmsnorm_matmul_workspace_floats(int M, int N, int K) {
  return split_k_workspace_floats(M, N, K);
}

extern "C" int rmsnorm_matmul_bf16(const void* x, const void* scale,
                                   const void* w, void* out, void* workspace,
                                   int M, int N, int K, float eps,
                                   void* stream) {
  return launch_matmul<true, EPI_NONE>(x, scale, w, nullptr, out,
                                    (float*)workspace, M, N, K, eps, stream);
}
