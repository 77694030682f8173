// flash_attention_proj: out (B,S,dm) = sum_h bf16(attention_h) @ wo[h],
// causal GQA attention with the output projection fused across heads.
//
// Replaces the Pallas kernel `repro/kernels/fused.py` _fa_proj_kernel /
// flash_attention_proj. Numerics follow it: scores q.k in f32 times
// hd^-0.5, masked with -1e30; online softmax with m, l in f32; p rounded
// to bf16 before p @ v; the head output divided by max(l, 1e-30) and
// rounded to bf16 before the projection; the projection summed over heads
// in f32 and rounded once. GQA maps head h to kv head h / (H / KV).
//
// Bound on an H100 (989 TFLOP/s bf16): qwen3-14b at B=1, S=512 does
// ~2.7 GFLOP of causal attention and 26.8 GFLOP of projection, ~30 us if
// operation-bound.
//
// Design (the projection accumulator does not fit on chip): the Pallas
// kernel keeps a (bq, d_model) f32 accumulator in VMEM, 20 KiB per query
// row at d_model 5120 — too large for shared memory (227 KB). Here a block
// owns BQ = 64 query rows of one batch entry and one group of HG <= 5
// heads, and runs two phases:
//   1. for each head of its group, flash attention over BKV = 64 key
//      tiles (wmma for q.k and p.v, the online softmax by warps); the head
//      output, rounded to bf16, goes into shared memory at
//      O[:, h*hd : (h+1)*hd] (64 x 640 bf16 = 80 KB for five heads);
//   2. O (64 x HG*hd) @ wo[group] (HG*hd x dm) as a tensor-core matmul,
//      128 output columns at a time, wo streamed through a double-buffered
//      shared tile, f32 accumulators in registers.
// With one group the block writes bf16 output directly. With G groups each
// block writes its f32 partial into its own slab of a (G, B, S, dm)
// scratch tensor the wrapper allocates — every slab row has one owner, no
// atomics — and `finish_kernel` sums the G slabs in a fixed order and
// rounds once, so the result is deterministic. The per-head attention
// output never touches device memory. Causal key tiles past the block's
// last row are skipped (they contribute exactly zero in the reference).
#include "common.cuh"

namespace {
constexpr int HD = 128, BQ = 64, BKV = 64, THREADS = 256, WARPS = 8;
constexpr int MAX_HG = 5;            // heads per block (O tile <= 80 KB)
constexpr int PBN = 128, PBK = 32;   // phase-2 output columns / k step
constexpr float NEG = -1e30f;

// Heads per block: the largest divisor of H that is at most MAX_HG.
int heads_per_block(int H) {
  int hg = MAX_HG < H ? MAX_HG : H;
  while (H % hg) --hg;
  return hg;
}

size_t smem_bytes(int hg) {
  return (size_t)BQ * hg * HD * 2    // O: the group's head outputs, bf16
         + BQ * HD * 2               // Q tile
         + 2 * BKV * HD * 2          // K, V tiles (phase 2: the wo tiles)
         + BQ * BKV * 4              // scores (phase 2: warp staging)
         + BQ * BKV * 2              // p in bf16
         + 2 * BQ * HD * 4           // output accumulator, p.v product
         + 3 * BQ * 4;               // m, l, alpha
}

__global__ void __launch_bounds__(THREADS)
fa_proj_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ wo,
               bf16* __restrict__ out, float* __restrict__ scratch, int B,
               int H, int KV, int S, int dm, int hg, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int HGK = hg * HD;
  bf16* Os = reinterpret_cast<bf16*>(smem);
  bf16* Qs = Os + (size_t)BQ * HGK;
  bf16* Ks = Qs + BQ * HD;
  bf16* Vs = Ks + BKV * HD;
  float* Ss = reinterpret_cast<float*>(Vs + BKV * HD);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + BQ * BKV);
  float* Acc = reinterpret_cast<float*>(Ps + BQ * BKV);
  float* Tmp = Acc + BQ * HD;
  float* m_s = Tmp + BQ * HD;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int q0 = blockIdx.x * BQ;
  const int grp = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int group = H / KV;
  const float scale = 1.0f / sqrtf((float)HD);
  const int kv_end = causal ? min(S, q0 + BQ) : S;

  // ---- phase 1: the group's head outputs into O -------------------------
  for (int hh = 0; hh < hg; ++hh) {
    const int h = grp * hg + hh;
    const bf16* qh = q + ((size_t)b * H + h) * S * HD;
    const bf16* kh = k + ((size_t)b * KV + h / group) * S * HD;
    const bf16* vh = v + ((size_t)b * KV + h / group) * S * HD;
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
      __syncthreads();     // Q/Acc init visible; last tile's K/V consumed
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
      {                     // scores: 4x4 tiles of 16x16, two per warp
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
      {                     // p.v: 4x8 tiles of 16x16, four per warp
        const int i = warp / 2;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int j = (warp % 2) * 4 + t;
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
      Os[(size_t)r * HGK + hh * HD + c] =
          __float2bfloat16(Acc[i] / fmaxf(l_s[r], 1e-30f));
    }
    __syncthreads();
  }

  // ---- phase 2: O @ wo[group], 128 output columns at a time -------------
  bf16* Ws = Ks;                       // two 32 x 128 wo tiles (16 KB)
  float* stage = Ss + warp * 256;      // one 16x16 f32 tile per warp
  const bf16* wg = wo + (size_t)grp * HGK * dm;
  const int wm = warp / 4, wn = warp % 4;      // warp tile 32 x 32
  const int steps = HGK / PBK;
  for (int n0 = 0; n0 < dm; n0 += PBN) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    uint4 wv[2];
    auto fetch = [&](int k0) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int id = tid + t * THREADS;
        const int r = id / (PBN / 8), c = (id % (PBN / 8)) * 8;
        wv[t] = load8_reg(wg + (size_t)(k0 + r) * dm, n0 + c, dm);
      }
    };
    auto stash = [&](bf16* dst) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int id = tid + t * THREADS;
        const int r = id / (PBN / 8), c = (id % (PBN / 8)) * 8;
        *reinterpret_cast<uint4*>(dst + r * PBN + c) = wv[t];
      }
    };
    fetch(0);
    stash(Ws);
    __syncthreads();
    for (int t = 0; t < steps; ++t) {
      bf16* cur = Ws + (t & 1) * PBK * PBN;
      if (t + 1 < steps) fetch((t + 1) * PBK);
#pragma unroll
      for (int kk = 0; kk < PBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i],
                                 Os + (size_t)(wm * 32 + i * 16) * HGK +
                                     t * PBK + kk, HGK);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], cur + kk * PBN + wn * 32 + j * 16,
                                 PBN);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      if (t + 1 < steps) stash(Ws + ((t + 1) & 1) * PBK * PBN);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int row = q0 + wm * 32 + i * 16 + e / 16;
          const int col = n0 + wn * 32 + j * 16 + e % 16;
          if (row < S && col < dm) {
            const size_t o = ((size_t)b * S + row) * dm + col;
            if (scratch == nullptr)
              out[o] = __float2bfloat16(stage[e]);
            else
              scratch[(size_t)grp * B * S * dm + o] = stage[e];
          }
        }
        __syncwarp();
      }
  }
}

// out = bf16(sum over the G head-group slabs), summed in a fixed order.
__global__ void finish_kernel(const float* __restrict__ scratch,
                              bf16* __restrict__ out, size_t n, int groups) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int g = 0; g < groups; ++g) s += scratch[g * n + i];
  out[i] = __float2bfloat16(s);
}
}  // namespace

// f32 scratch (in floats) the wrapper allocates: G slabs of (B, S, dm)
// when the heads span more than one group, else none.
extern "C" size_t flash_attention_proj_workspace_floats(int B, int H, int S,
                                                        int dm) {
  if (B <= 0 || H <= 0 || S <= 0 || dm <= 0) return 0;
  const int groups = H / heads_per_block(H);
  return groups > 1 ? (size_t)groups * B * S * dm : 0;
}

extern "C" int flash_attention_proj_bf16(const void* q, const void* k,
                                         const void* v, const void* wo,
                                         void* out, void* workspace, int B,
                                         int H, int KV, int S, int hd,
                                         int dm, int causal, void* stream) {
  if (hd != HD || B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      dm % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int hg = heads_per_block(H);
  const int groups = H / hg;
  if (groups > 1 && workspace == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(hg);
  cudaError_t err = cudaFuncSetAttribute(
      fa_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((S + BQ - 1) / BQ, groups, B);
  float* scratch = groups > 1 ? (float*)workspace : nullptr;
  fa_proj_kernel<<<grid, THREADS, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)wo,
      (bf16*)out, scratch, B, H, KV, S, dm, hg, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return (int)err;
  const size_t n = (size_t)B * S * dm;
  finish_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(scratch,
                                                             (bf16*)out, n,
                                                             groups);
  return (int)cudaGetLastError();
}
