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
//   1. `fa_proj_heads_kernel`, one (batch, head, 64-row q tile) a block
//      (320 blocks at the qwen3 shape), writes each head's output, rounded
//      to bf16, into a workspace O laid out (B, S, H, hd): row-major
//      (B*S, H*hd).
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

__global__ void __launch_bounds__(attn::THREADS)
fa_proj_heads_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     int H, int KV, int S, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  attn::attend<HD>(q + ((size_t)b * H + h) * S * HD,
                   k + ((size_t)b * KV + kvh) * S * HD,
                   v + ((size_t)b * KV + kvh) * S * HD,
                   o + (size_t)b * S * H * HD + (size_t)h * HD,
                   (size_t)H * HD, S, blockIdx.x * attn::BQ, causal,
                   1.0f / sqrtf((float)HD), smem);
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
                                         int dm, int causal, void* stream) {
  if (hd != HD || B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      dm <= 0 || !hopper::takes(dm, H * HD) || workspace == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t smem = attn::smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_proj_heads_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  bf16* o = static_cast<bf16*>(workspace);
  const dim3 grid((S + attn::BQ - 1) / attn::BQ, H, B);
  fa_proj_heads_kernel<<<grid, attn::THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, o, H, KV, S, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return hopper::launch<EPI_NONE, hopper::OWNER_FLASH_ATTENTION_PROJ>(
      o, wo, nullptr, out, B * S, dm, H * HD, stream);
}
