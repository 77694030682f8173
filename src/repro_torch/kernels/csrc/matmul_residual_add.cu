// matmul_residual_add: out = bf16(f32(bf16(a @ b)) + f32(res)).
//
// Replaces the Pallas kernel `repro/kernels/fused.py`
// build_matmul_residual_add (body `matmul._matmul_kernel`, residual added
// in the store epilogue). The double rounding is the reference kernel's:
// its matmul body stores acc.astype(bf16) and the epilogue hook adds the
// residual to that already-rounded value.
//
// Bound on an H100 (3.35 TB/s): at decode (M = 8) bytes-bound by the
// weight — qwen3-14b's out-projection (5120 x 5120, 52 MB) at least
// 16 us, the down-projection (17408 x 5120, 178 MB) at least 53 us.
//
// Design: the same two matmul paths as rmsnorm_matmul (see common.cuh):
// split-K weight streaming for M <= 16, tiled wmma above. The residual is
// read in the epilogue (the tile store, or the split-K finish), so the
// rounded matmul output never round-trips device memory as bf16.
#include "common.cuh"

extern "C" size_t matmul_residual_add_workspace_floats(int M, int N, int K) {
  return split_k_workspace_floats(M, N, K);
}

extern "C" int matmul_residual_add_bf16(const void* a, const void* b,
                                        const void* res, void* out,
                                        void* workspace, int M, int N, int K,
                                        void* stream) {
  return launch_matmul<false, EPI_RESID>(a, nullptr, b, res, out,
                                    (float*)workspace, M, N, K, 0.f, stream);
}
