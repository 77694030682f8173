// The online-softmax attention core that flash_attention.cu and
// flash_attention_proj.cu share: one block, BQ = 64 query rows of one
// (batch, head), against all its keys, written to device memory as bf16.
//
// Numerics follow the Pallas kernels (`repro/kernels/flash_attention.py`
// _fa_kernel, `repro/kernels/fused.py` _fa_proj_kernel): scores q.k in f32
// times the scale, masked with -1e30; online softmax with m, l and the
// accumulator in f32; p rounded to bf16 (v's dtype) before p @ v while l
// sums the unrounded p; the output acc / max(l, 1e-30), rounded once.
//
// The block walks BKV = 64 key tiles: q.k^T and p.v on the tensor cores
// (wmma, f32 accumulation), the softmax update by warps (eight rows a
// warp, two columns a lane) with the scores, p and the accumulator in
// shared memory. Causal key tiles past the block's last row are skipped:
// key 0 is always visible, so the -1e30 mask gives them exactly zero
// weight. Rows and keys past S are masked, so no length is padded.
// Simple first: no TMA, no wgmma, no pipelining of the K/V loads.
#pragma once

#include "common.cuh"

namespace attn {
constexpr int BQ = 64, BKV = 64, THREADS = 256, WARPS = 8;
constexpr float NEG = -1e30f;

template <int HD>
constexpr size_t smem_bytes() {
  return (size_t)BQ * HD * 2       // Q tile
         + 2 * BKV * HD * 2        // K, V tiles
         + BQ * BKV * 4            // scores
         + BQ * BKV * 2            // p in bf16
         + 2 * BQ * HD * 4         // output accumulator, p.v product
         + 3 * BQ * 4;             // m, l, alpha
}

// Rows q0 .. q0+BQ of one head: qh, kh, vh point at the head's (S, HD)
// q, k and v; output row r goes to oh + r * o_stride. Run by all THREADS
// threads of the block on `smem_bytes<HD>()` of dynamic shared memory.
template <int HD>
__device__ __forceinline__ void attend(const bf16* __restrict__ qh,
                                       const bf16* __restrict__ kh,
                                       const bf16* __restrict__ vh,
                                       bf16* __restrict__ oh, size_t o_stride,
                                       int S, int q0, int causal, float scale,
                                       unsigned char* smem) {
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * HD;
  bf16* Vs = Ks + BKV * HD;
  float* Ss = reinterpret_cast<float*>(Vs + BKV * HD);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + BQ * BKV);
  float* Acc = reinterpret_cast<float*>(Ps + BQ * BKV);
  float* Tmp = Acc + BQ * HD;
  float* m_s = Tmp + BQ * HD;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kv_end = causal ? min(S, q0 + BQ) : S;

  for (int i = tid; i < BQ * HD / 8; i += THREADS) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    if (q0 + r < S)
      load_row8(Qs + r * HD + c, qh + (size_t)(q0 + r) * HD, c, HD);
    else
      zero8(Qs + r * HD + c);
  }
  for (int i = tid; i < BQ * HD; i += THREADS) Acc[i] = 0.f;
  if (tid < BQ) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  for (int j0 = 0; j0 < kv_end; j0 += BKV) {
    __syncthreads();       // Q/Acc init visible; last tile's K/V consumed
    for (int i = tid; i < BKV * HD / 8; i += THREADS) {
      const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
      if (j0 + r < S) {
        load_row8(Ks + r * HD + c, kh + (size_t)(j0 + r) * HD, c, HD);
        load_row8(Vs + r * HD + c, vh + (size_t)(j0 + r) * HD, c, HD);
      } else {
        zero8(Ks + r * HD + c);
        zero8(Vs + r * HD + c);
      }
    }
    __syncthreads();
    {                       // scores: 4x4 tiles of 16x16, two per warp
      const int i = warp / 2;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = (warp % 2) * 2 + t;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc;
        wmma::fill_fragment(sc, 0.f);
#pragma unroll
        for (int kk = 0; kk < HD; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, Qs + i * 16 * HD + kk, HD);
          wmma::load_matrix_sync(fb, Ks + j * 16 * HD + kk, HD);
          wmma::mma_sync(sc, fa, fb, sc);
        }
        wmma::store_matrix_sync(Ss + i * 16 * BKV + j * 16, sc, BKV,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();
    // online softmax: warp w owns rows 8w .. 8w+7, two columns a lane
    for (int rr = 0; rr < BQ / WARPS; ++rr) {
      const int r = warp * (BQ / WARPS) + rr;
      const int qpos = q0 + r;
      float s[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t, kpos = j0 + c;
        const bool ok = kpos < S && (!causal || kpos <= qpos);
        s[t] = ok ? Ss[r * BKV + c] * scale : NEG;
      }
      float mx = fmaxf(s[0], s[1]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(s[0] - m_new), p1 = expf(s[1] - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      Ps[r * BKV + lane] = __float2bfloat16(p0);
      Ps[r * BKV + lane + 32] = __float2bfloat16(p1);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
    {                       // p.v: 4 x HD/16 tiles of 16x16, HD/32 per warp
      const int i = warp / 2;
#pragma unroll
      for (int t = 0; t < HD / 32; ++t) {
        const int j = (warp % 2) * (HD / 32) + t;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> pv;
        wmma::fill_fragment(pv, 0.f);
#pragma unroll
        for (int kk = 0; kk < BKV; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, Ps + i * 16 * BKV + kk, BKV);
          wmma::load_matrix_sync(fb, Vs + kk * HD + j * 16, HD);
          wmma::mma_sync(pv, fa, fb, pv);
        }
        wmma::store_matrix_sync(Tmp + i * 16 * HD + j * 16, pv, HD,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();
    for (int i = tid; i < BQ * HD; i += THREADS)
      Acc[i] = Acc[i] * a_s[i / HD] + Tmp[i];
  }
  __syncthreads();
  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, c = i % HD;
    if (q0 + r < S)
      oh[(size_t)(q0 + r) * o_stride + c] =
          __float2bfloat16(Acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}
}  // namespace attn
