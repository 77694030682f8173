// flash_attention: out (B,H,S,hd) = softmax(q k^T * hd^-0.5) v per head,
// causal or full, GQA head h reading kv head h / (H / KV); bf16 in and out,
// hd 64 or 128, any S.
//
// Replaces the Pallas kernel `repro/kernels/flash_attention.py` _fa_kernel /
// flash_attention, with its numerics (attention.cuh).
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s): qwen3-14b's prefill at
// B=1, H=40, KV=8, S=512, hd=128 reads q, k and v once and writes the output
// once, 12.6 MB (3.8 us), and does 2.7 GFLOP of causal attention (2.7 us):
// bytes-bound by a hair at this length, operations above it.
//
// Design: the Hopper attention core of attention.cuh (shared with
// flash_attention_proj.cu): a TMA ring of K and V tiles, Q K^T and P V on
// wgmma with the scores and the output accumulator in registers; one block
// a (batch, head, 128-row query tile), the output written (B, H, S, hd).
#include "attention.cuh"

namespace {
template <int HD>
__global__ void __launch_bounds__(attn::THREADS, 1)
flash_attention_kernel(const __grid_constant__ attn::Maps maps,
                       bf16* __restrict__ out, int H, int KV, int S,
                       int causal, float scale) {
  const int bh = blockIdx.x;                  // b * H + h
  const int kvs = (bh / H) * KV + (bh % H) / (H / KV);
  attn::attend<HD>(maps, bh, kvs, out + (size_t)bh * S * HD, HD, S,
                   attn::first_row(), causal, scale);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KV, int S, int causal, float scale, void* stream) {
  attn::Maps maps;
  cudaError_t err = attn::encode_maps<HD>(&maps, q, k, v, B, H, KV, S);
  if (err != cudaSuccess) return (int)err;
  const int smem = attn::Layout<HD>::SMEM;
  err = cudaFuncSetAttribute(flash_attention_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  flash_attention_kernel<HD><<<attn::grid(B, H, S), attn::THREADS, smem,
                               (cudaStream_t)stream>>>(
      maps, (bf16*)out, H, KV, S, causal, scale);
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
