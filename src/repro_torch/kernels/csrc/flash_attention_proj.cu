// flash_attention_proj: out (B,S,dm) = sum_h bf16(attention_h) @ wo[h],
// causal GQA attention with the output projection summed across heads.
//
// Replaces the Pallas kernel `repro/kernels/fused.py` _fa_proj_kernel /
// flash_attention_proj. Numerics follow it: the attention core of
// attention.cuh (scores in f32 times hd^-0.5, -1e30 mask, online softmax,
// p rounded to bf16, divide by max(l, 1e-30)); each head's output rounded
// to bf16 before the projection; the projection summed over all heads in
// f32 and rounded once, as the reference's `pacc += o_head.astype(bf16) @
// wo[h]` followed by one cast. GQA maps head h to kv head h / (H / KV).
//
// Bound on an H100 (989 TFLOP/s bf16): qwen3-14b at B=1, S=512 does
// ~2.7 GFLOP of causal attention and 26.8 GFLOP of projection, ~30 us if
// operation-bound.
//
// Design: two launches in one call.
//   1. `fa_proj_heads_kernel`, the Hopper attention core of attention.cuh
//      (a TMA ring of K and V tiles, Q K^T and P V on wgmma with the
//      scores and the output accumulator in registers), one block a
//      (batch, head, 128-row query tile): 160 blocks at the qwen3 shape. It
//      writes each head's output, rounded to bf16, into a workspace O laid
//      out (B, S, H, hd): row-major (B*S, H*hd).
//   2. the TMA + wgmma mainloop of wgmma_gemm.cuh computes O @ wo, with wo
//      (H, hd, dm) read as (H*hd, dm) row-major: one f32 accumulator over
//      all heads, rounded once.
// The Pallas kernel keeps the (bq, d_model) f32 projection accumulator in
// VMEM and never writes the head outputs out. Here that accumulator (20
// KiB a query row at d_model 5120) does not fit in an SM's shared memory,
// and splitting the heads across blocks costs a f32 partial per group
// (84 MB at the qwen3 shape) that a second pass sums. So the head outputs
// go to device memory instead, 5.2 MB at B1 S512, which stays in the 50
// MB L2, and the projection becomes one GEMM at the card's tensor-core
// rate.
#include "attention.cuh"
#include "wgmma_gemm.cuh"

namespace {
constexpr int HD = 128;

__global__ void __launch_bounds__(attn::THREADS, 1)
fa_proj_heads_kernel(const __grid_constant__ attn::Maps maps,
                     bf16* __restrict__ o, int H, int KV, int S, int causal) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  attn::attend<HD>(maps, bh, b * KV + h / (H / KV),
                   o + (size_t)b * S * H * HD + (size_t)h * HD,
                   (size_t)H * HD, S, attn::first_row(), causal,
                   1.0f / sqrtf((float)HD));
}
}  // namespace

// f32 workspace (in floats) for the bf16 head outputs O (B, S, H, hd).
extern "C" size_t flash_attention_proj_workspace_floats(int B, int H, int S,
                                                        int dm) {
  if (B <= 0 || H <= 0 || S <= 0 || dm <= 0) return 0;
  return ((size_t)B * S * H * HD + 1) / 2;
}

extern "C" int flash_attention_proj_bf16(const void* q, const void* k,
                                         const void* v, const void* wo,
                                         void* out, void* workspace, int B,
                                         int H, int KV, int S, int hd,
                                         int dm, int causal, int tile_n,
                                         void* stream) {
  // `tile_n` pins the projection's N tile (0: the mainloop's own pick); a
  // tile outside TILE_N is refused before anything is launched
  if (hd != HD || B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      dm <= 0 || !hopper::takes(dm, H * HD) || workspace == nullptr ||
      hopper::plan(B * S, dm, tile_n).bn == 0)
    return (int)cudaErrorInvalidValue;
  attn::Maps maps;
  cudaError_t err = attn::encode_maps<HD>(&maps, q, k, v, B, H, KV, S);
  if (err != cudaSuccess) return (int)err;
  const int smem = attn::Layout<HD>::SMEM;
  err = cudaFuncSetAttribute(fa_proj_heads_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  bf16* o = static_cast<bf16*>(workspace);
  fa_proj_heads_kernel<<<attn::grid(B, H, S), attn::THREADS, smem,
                         (cudaStream_t)stream>>>(maps, o, H, KV, S, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return hopper::launch<EPI_NONE, hopper::OWNER_FLASH_ATTENTION_PROJ>(
      o, wo, nullptr, out, B * S, dm, H * HD, stream, tile_n);
}
