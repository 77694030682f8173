// flash_attention: out (B,H,S,hd) = softmax(q k^T * hd^-0.5) v per head,
// causal or full, GQA head h reading kv head h / (H / KV); bf16 in and out,
// hd 64 or 128, any S.
//
// Replaces the Pallas kernel `repro/kernels/flash_attention.py` _fa_kernel /
// flash_attention. Numerics follow it: scores q.k in f32 times the scale,
// masked with -1e30; online softmax with m, l and the accumulator in f32;
// p rounded to bf16 (v's dtype) before p @ v while l sums the unrounded p;
// the output acc / max(l, 1e-30), rounded once.
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s): qwen3-14b's prefill at
// B=1, H=40, KV=8, S=512, hd=128 reads q, k and v once and writes the output
// once, 12.6 MB (3.8 us), and does 2.7 GFLOP of causal attention (2.7 us):
// bytes-bound by a hair at this length, operations above it.
//
// Design: the attention core of attention.cuh (shared with
// flash_attention_proj.cu), one (batch, head, 64-row q tile) a block.
#include "attention.cuh"

namespace {
template <int HD>
__global__ void __launch_bounds__(attn::THREADS)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       int H, int KV, int S, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  attn::attend<HD>(q + ((size_t)b * H + h) * S * HD,
                   k + ((size_t)b * KV + kvh) * S * HD,
                   v + ((size_t)b * KV + kvh) * S * HD,
                   out + ((size_t)b * H + h) * S * HD, HD, S,
                   blockIdx.x * attn::BQ, causal, scale, smem);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KV, int S, int causal, float scale, void* stream) {
  const size_t smem = attn::smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + attn::BQ - 1) / attn::BQ, H, B);
  flash_attention_kernel<HD><<<grid, attn::THREADS, smem,
                               (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, H, KV, S,
      causal, scale);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int B, int H,
                                    int KV, int S, int hd, int causal,
                                    float scale, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || S <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  if (hd == 64)
    return launch<64>(q, k, v, out, B, H, KV, S, causal, scale, stream);
  if (hd == 128)
    return launch<128>(q, k, v, out, B, H, KV, S, causal, scale, stream);
  return (int)cudaErrorInvalidValue;
}
