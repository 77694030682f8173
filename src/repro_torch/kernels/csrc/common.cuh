// Shared pieces of the port's Hopper kernels: bf16 tile loads and the two
// pre-Hopper matmul paths that `rmsnorm_matmul.cu`, `matmul_residual_add.cu`,
// `matmul_bias_act.cu` and `matmul.cu` instantiate with their prologue and
// epilogue (or none), for the shapes the Hopper kernels do not take (K or
// N not a multiple of 8):
//   * gemm::   a tiled tensor-core (wmma) matmul for M > 16;
//   * skinny:: a split-K CUDA-core matmul for M <= 16.
// `launch_matmul` (decode_gemm.cuh) picks between them and the decode
// kernel; wgmma_gemm.cuh holds the mainloop the wrappers call at M > 16.
//
// Every entry point has a plain C interface (loaded with ctypes by
// kernels/build.py), launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;
namespace wmma = nvcuda::wmma;

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// 8 bf16 of one row starting at `col` (holding `n`), as one register:
// a 16-byte load when whole and aligned, element loads (zero past `n`)
// otherwise.
__device__ __forceinline__ uint4 load8_reg(const bf16* row, int col, int n) {
  const bf16* src = row + col;
  if (col + 8 <= n && (reinterpret_cast<uintptr_t>(src) & 15) == 0)
    return __ldg(reinterpret_cast<const uint4*>(src));
  __align__(16) bf16 tmp[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    tmp[i] = (col + i < n) ? src[i] : __float2bfloat16(0.f);
  return *reinterpret_cast<uint4*>(tmp);
}

__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 p = __bfloat1622float2(h[j]);
    f[2 * j] = p.x;
    f[2 * j + 1] = p.y;
  }
}

// 1/rms of one row of K bf16 values, reduced across the calling warp (every
// lane gets the result): rsqrt(mean(x^2) + eps), the sum in f32.
__device__ __forceinline__ float row_rstd(const bf16* row, int K, float eps) {
  const int lane = threadIdx.x % 32;
  float ss = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    float f[8];
    unpack8(load8_reg(row, k, K), f);
#pragma unroll
    for (int j = 0; j < 8; ++j) ss += f[j] * f[j];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  return rsqrtf(ss / (float)K + eps);
}

// The prologue's arithmetic on 8 values: bf16((x * rstd) * (1 + scale)).
__device__ __forceinline__ uint4 norm8(const uint4& x, const uint4& s,
                                       float rstd) {
  float xf[8], sf[8];
  unpack8(x, xf);
  unpack8(s, sf);
  __align__(16) bf16 o[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16(xf[j] * rstd * (1.f + sf[j]));
  return *reinterpret_cast<uint4*>(o);
}

// ---------------------------------------------------------------------------
// Epilogues, applied to the f32 accumulator of one output element (row-major
// index `idx`, column `col`). Each first rounds the accumulator to bf16, as
// the reference kernels' matmul body stores acc.astype(bf16) before their
// epilogue hook sees it (two roundings, not one):
//   EPI_NONE       bf16(acc)
//   EPI_RESID      bf16(f32(bf16(acc)) + f32(res[idx]))
//   EPI_BIAS*      bf16(act(f32(bf16(acc)) + f32(bias[col]))), act none,
//                  gelu (the tanh form, jax.nn.gelu's default) or silu
// `extra` is the residual (M,N) or the bias (N,).
// ---------------------------------------------------------------------------

enum : int { EPI_NONE = 0, EPI_RESID = 1, EPI_BIAS = 2, EPI_BIAS_GELU = 3,
             EPI_BIAS_SILU = 4 };

template <int EPI>
__device__ __forceinline__ bf16 epilogue(float acc, const bf16* extra,
                                         size_t idx, int col) {
  const bf16 y = __float2bfloat16(acc);
  if (EPI == EPI_RESID)
    return __float2bfloat16(__bfloat162float(y) + __bfloat162float(extra[idx]));
  if (EPI >= EPI_BIAS) {
    float h = __bfloat162float(y) + __bfloat162float(extra[col]);
    if (EPI == EPI_BIAS_GELU)
      h = 0.5f * h * (1.f + tanhf(0.7978845608028654f *
                                  (h + 0.044715f * h * h * h)));
    if (EPI == EPI_BIAS_SILU) h = h / (1.f + expf(-h));
    return __float2bfloat16(h);
  }
  return y;
}

// ---------------------------------------------------------------------------
// Tiled matmul (M > 16) with an optional RMSNorm prologue and one of the
// epilogues above: out (M,N) = epilogue(prologue(a) (M,K) @ b (K,N)),
// row-major bf16, M, N and K masked at the ragged edge.
//
// A block owns a 64 x 128 output tile; its 8 warps (2 x 4) each hold a
// 32 x 32 f32 accumulator in four wmma fragments. K is walked in steps of
// 32 with two shared-memory buffers: the next step's tiles are loaded into
// registers (16-byte loads) while the tensor cores work on the current
// one, then stored to the other buffer — one barrier per step.
//
// NORM: the A tile is normalised as it is staged, with the rows' 1/rms
//   computed once per block: bf16((x * rstd) * (1 + scale)) — normalised
//   in f32 and rounded to bf16 *before* the product, as the reference
//   kernel's prologue does.
// EPI: applied as each output element is stored.
// ---------------------------------------------------------------------------

namespace gemm {
constexpr int BM = 64, BN = 128, BK = 32, THREADS = 256;
constexpr int WM = 32, WN = 32;              // warp tile; warps 2 x 4

struct Stage {                               // one thread's share of a step
  uint4 a, s, b[2];
};

template <bool NORM>
__device__ __forceinline__ void fetch(Stage& st, const bf16* a,
                                      const bf16* scale, const bf16* b,
                                      int m0, int n0, int k0, int M, int N,
                                      int K) {
  const int tid = threadIdx.x;
  const int r = tid / (BK / 8), c = (tid % (BK / 8)) * 8;
  st.a = (m0 + r < M) ? load8_reg(a + (size_t)(m0 + r) * K, k0 + c, K)
                      : make_uint4(0, 0, 0, 0);
  if (NORM) st.s = load8_reg(scale, k0 + c, K);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int id = tid + j * THREADS;
    const int br = id / (BN / 8), bc = (id % (BN / 8)) * 8;
    st.b[j] = (k0 + br < K) ? load8_reg(b + (size_t)(k0 + br) * N, n0 + bc, N)
                            : make_uint4(0, 0, 0, 0);
  }
}

template <bool NORM>
__device__ __forceinline__ void stash(const Stage& st, bf16* As, bf16* Bs,
                                      const float* rstd) {
  const int tid = threadIdx.x;
  const int r = tid / (BK / 8), c = (tid % (BK / 8)) * 8;
  *reinterpret_cast<uint4*>(As + r * BK + c) =
      NORM ? norm8(st.a, st.s, rstd[r]) : st.a;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int id = tid + j * THREADS;
    const int br = id / (BN / 8), bc = (id % (BN / 8)) * 8;
    *reinterpret_cast<uint4*>(Bs + br * BN + bc) = st.b[j];
  }
}

template <bool NORM, int EPI>
__global__ void __launch_bounds__(THREADS)
tile_kernel(const bf16* __restrict__ a, const bf16* __restrict__ scale,
            const bf16* __restrict__ b, const bf16* __restrict__ extra,
            bf16* __restrict__ out, int M, int N, int K, float eps) {
  __shared__ __align__(128) bf16 As[2][BM * BK];
  __shared__ __align__(128) bf16 Bs[2][BK * BN];
  __shared__ __align__(128) float stage[THREADS / 32][16 * 16];
  __shared__ float rstd[BM];

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);

  if (NORM) {
    for (int r = warp; r < BM; r += THREADS / 32) {
      const float v = (m0 + r < M) ? row_rstd(a + (size_t)(m0 + r) * K, K, eps)
                                   : 0.f;
      if (lane == 0) rstd[r] = v;
    }
    __syncthreads();
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  Stage st;
  fetch<NORM>(st, a, scale, b, m0, n0, 0, M, N, K);
  stash<NORM>(st, As[0], Bs[0], rstd);
  __syncthreads();
  const int steps = (K + BK - 1) / BK;
  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1;
    if (t + 1 < steps)
      fetch<NORM>(st, a, scale, b, m0, n0, (t + 1) * BK, M, N, K);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As[cur] + (wm * WM + i * 16) * BK + kk,
                               BK);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs[cur] + kk * BN + wn * WN + j * 16,
                               BN);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (t + 1 < steps) stash<NORM>(st, As[cur ^ 1], Bs[cur ^ 1], rstd);
    __syncthreads();
  }

  float* sw = stage[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(sw, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = m0 + wm * WM + i * 16 + e / 16;
        const int col = n0 + wn * WN + j * 16 + e % 16;
        if (row < M && col < N) {
          const size_t idx = (size_t)row * N + col;
          out[idx] = epilogue<EPI>(sw[e], extra, idx, col);
        }
      }
      __syncwarp();
    }
}

}  // namespace gemm

// ---------------------------------------------------------------------------
// Skinny path (M <= 16 with K or N not a multiple of 8; every other M <= 16
// product runs decode_gemm.cuh's kernel): split-K weight streaming on the
// CUDA cores.
//
// Block (x, y, z) owns 256 columns (32 lanes x 8 adjacent columns, one
// 16-byte weight load per lane per k row), the k range of split y, and 8
// rows of M (z). Its prologue stages those 8 rows' k range in shared
// memory — normalised and rounded to bf16 for NORM — while the warps'
// first weight loads are in flight; the 8 warps then stride over the k
// rows eight at a time, each lane keeping 8 x 8 f32 accumulators. Partial sums are reduced over warps in shared memory and
// over splits by `finish_kernel`, both in a fixed order, so results are
// deterministic. The finish applies the epilogue.
// ---------------------------------------------------------------------------

namespace skinny {
constexpr int MAX_M = 16, MR = 8, WARPS = 8, THREADS = 256, COLS = 256;
constexpr int KU = 8;               // k rows a warp loads before its FMAs
constexpr int BLOCKS_PER_SM = 2;    // held by __launch_bounds__ and smem

// Split K so that the grid fills whole waves of resident blocks (one or
// two waves, whichever leaves fewer slots idle; a partial last wave would
// double the time of a weight stream), each split holding at least 64 k
// rows (a multiple of 8).
inline void plan(int M, int N, int K, int* splits, int* kps) {
  const int tiles = ((N + COLS - 1) / COLS) * ((M + MR - 1) / MR);
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long slots = (long)BLOCKS_PER_SM * sms;
  const int max_s = K / 64 > 1 ? K / 64 : 1;
  int best = 1;
  double best_fill = -1.0;
  for (int waves = 1; waves <= 2; ++waves) {
    int s = (int)(waves * slots / tiles);
    s = s < 1 ? 1 : (s > max_s ? max_s : s);
    const long blocks = (long)s * tiles;
    const double fill =
        (double)blocks / (double)(((blocks + slots - 1) / slots) * slots);
    if (fill > best_fill + 1e-9) {
      best_fill = fill;
      best = s;
    }
  }
  int per = (K + best - 1) / best;
  per = (per + 7) / 8 * 8;
  *kps = per;
  *splits = (K + per - 1) / per;
}

inline size_t smem_bytes(int kps) {
  return (size_t)MR * kps * 2 + (size_t)WARPS * MR * COLS * 4;
}

// EPI does not change the partial sums: it names the instantiation, so
// that each entry point (rmsnorm_matmul <true,0>, matmul_residual_add
// <false,1>, matmul_bias_act <false,2..4>, matmul <false,0>) opens with a
// kernel of its own name, which is what a profiler trace counts its
// launches by.
template <bool NORM, int EPI>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
partial_kernel(const bf16* __restrict__ a, const bf16* __restrict__ scale,
               const bf16* __restrict__ b, float* __restrict__ ws, int M,
               int N, int K, int kps, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float rstd[MR];
  const int n0 = blockIdx.x * COLS;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MR;
  const int k0 = split * kps;
  const int kl = min(K, k0 + kps) - k0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  float* part = reinterpret_cast<float*>(smem + (size_t)MR * kps * 2);

  const int col = n0 + lane * 8;
  uint4 wv[KU];
  auto fetch = [&](int kk) {
#pragma unroll
    for (int u = 0; u < KU; ++u)
      wv[u] = (kk + u < kl && col < N)
                  ? load8_reg(b + (size_t)(k0 + kk + u) * N, col, N)
                  : make_uint4(0, 0, 0, 0);
  };
  fetch(warp * KU);                 // in flight during the prologue

  if (NORM) {                       // one warp per row: 1/rms over all K
    const float v = (m0 + warp < M) ? row_rstd(a + (size_t)(m0 + warp) * K,
                                               K, eps) : 0.f;
    if (lane == 0) rstd[warp] = v;
    __syncthreads();
  }
  for (int i = tid; i < MR * kl; i += THREADS) {
    const int r = i / kl, c = i % kl;
    const int row = m0 + r, k = k0 + c;
    float v = 0.f;
    if (row < M) {
      v = __bfloat162float(a[(size_t)row * K + k]);
      if (NORM) v = v * rstd[r] * (1.f + __bfloat162float(scale[k]));
    }
    xs[r * kps + c] = __float2bfloat16(v);
  }
  __syncthreads();

  float acc[MR][8];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  for (int kk = warp * KU; kk < kl; kk += WARPS * KU) {
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      if (kk + u >= kl) break;
      float wf[8];
      unpack8(wv[u], wf);
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        const float xv = __bfloat162float(xs[r * kps + kk + u]);
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(xv, wf[c], acc[r][c]);
      }
    }
    fetch(kk + WARPS * KU);
  }
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      part[(warp * MR + r) * COLS + lane * 8 + c] = acc[r][c];
  __syncthreads();
  for (int i = tid; i < MR * COLS; i += THREADS) {
    const int r = i / COLS, c = i % COLS;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += part[(w * MR + r) * COLS + c];
    const int row = m0 + r, n = n0 + c;
    if (row < M && n < N) ws[((size_t)split * M + row) * N + n] = s;
  }
}

template <int EPI>
__global__ void finish_kernel(const float* __restrict__ ws,
                              const bf16* __restrict__ extra,
                              bf16* __restrict__ out, int M, int N,
                              int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t mn = (size_t)M * N;
  if (i >= mn) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += ws[sp * mn + i];
  out[i] = epilogue<EPI>(s, extra, i, (int)(i % N));
}
}  // namespace skinny

// f32 workspace (in floats) the skinny path needs; 0 for the tiled path.
inline size_t split_k_workspace_floats(int M, int N, int K) {
  if (M > skinny::MAX_M || M <= 0 || N <= 0 || K <= 0) return 0;
  int splits, kps;
  skinny::plan(M, N, K, &splits, &kps);
  return (size_t)splits * M * N;
}
