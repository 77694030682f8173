// rmsnorm: out (M,D) = x * rsqrt(mean(x^2) + eps) * (1 + scale), the
// arithmetic in f32 and one rounding to x's dtype (f32 or bf16).
//
// Replaces the Pallas kernel `repro/kernels/rmsnorm.py` _rmsnorm_kernel /
// rmsnorm: row blocks streamed through VMEM with the scale resident.
//
// Bound on an H100 (3.35 TB/s): bytes, 2 * M * D * size + D * size; qwen3-14b
// at M = 512 rows of 5120 bf16 moves 10.5 MB, at least 3.1 us. It is a
// row pass with no reuse, so what it needs is every SM busy and many loads
// in flight.
//
// Design: a row's threads (tpr, a power of two from 32 to 256: the fewest
// that hold the row at 32 values a thread) read it once. Each thread issues
// all its 16-byte loads of x and of the scale before it sums a square, and
// keeps its 32 values in registers for the second pass, so the row is not
// read again (D <= 8192 at 256 threads). A longer row is swept in chunks of
// 256 x 32 values, each chunk's loads in flight together, and read again
// for the second pass. A block is one row of D > 2048 values (M8 D5120 runs
// on 8 SMs, M512 on all of them), or 128 threads of up to four shorter
// rows. The sum of squares takes norm_rows_kernel's order (each lane's
// chain of 16-byte vectors, then the lanes' xor-shuffle tree), the warps'
// values handed to the row's first warp through shared memory: no atomics,
// the same bits every run, and the same bits as the fused kernel's
// normalised rows.
#include "common.cuh"

namespace {

// V = 16 / sizeof(T) values of one row at `col` (holding `n`) as f32, zero
// past `n`: one 16-byte load when whole and aligned.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void load(const float* row, int col,
                                              int n, float* f) {
    const float* src = row + col;
    if (col + V <= n && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src));
      f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) f[i] = col + i < n ? src[i] : 0.f;
    }
  }
  static __device__ __forceinline__ void store(float* row, int col, int n,
                                               const float* f) {
    float* dst = row + col;
    if (col + V <= n && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (col + i < n) dst[i] = f[i];
    }
  }
};

template <>
struct Vec<bf16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ void load(const bf16* row, int col,
                                              int n, float* f) {
    unpack8(load8_reg(row, col, n), f);
  }
  static __device__ __forceinline__ void store(bf16* row, int col, int n,
                                               const float* f) {
    __align__(16) bf16 o[V];
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = __float2bfloat16(f[i]);
    bf16* dst = row + col;
    if (col + V <= n && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (col + i < n) dst[i] = o[i];
    }
  }
};

constexpr int HOLD = 32;                // values of a row a thread holds
constexpr int MAX_TPR = 256, MIN_BLOCK = 128;

// Threads a row: the fewest (32-256) that hold D values at HOLD a thread.
inline int threads_per_row(int D) {
  int tpr = 32;
  while (tpr < MAX_TPR && (long)tpr * HOLD < D) tpr *= 2;
  return tpr;
}

// The order of the sum of squares: the row as vectors of V values, vector
// v on lane v % 32 at place v / 32 of that lane's chain; each lane sums
// its chain in place order (values in order within a vector), then the
// 32 lanes' sums meet in an xor-shuffle tree. It is norm_rows_kernel's
// order (csrc/rmsnorm_matmul.cu, the fused kernel's prologue) in bf16, so
// the composition lane (this kernel, then matmul) normalises to the same
// bits as the fused kernel. A row's warp w holds places [w P, (w + 1) P)
// of every lane's chain (P = HOLD / V vectors a thread); with more than
// one warp a row, the warps stage their values in shared memory and the
// row's first warp runs the chains.
template <typename T>
__global__ void __launch_bounds__(MAX_TPR)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ out, int M, int D, float eps, int tpr) {
  constexpr int V = Vec<T>::V, P = HOLD / V;     // 16-byte vectors a thread
  __shared__ float buf[MAX_TPR * HOLD];   // a row's sweep: [place][e][lane]
  __shared__ float rstd_s[MIN_BLOCK / 32];
  const int rows = blockDim.x / tpr, q = tpr / 32;
  const int r = threadIdx.x / tpr, j = threadIdx.x % tpr;
  const int w = j / 32, l = j % 32;       // the row's warp, its lane
  const int row = blockIdx.x * rows + r;
  const bool live = row < M;              // dead threads still sync
  const T* xr = x + (size_t)(live ? row : 0) * D;
  T* orow = out + (size_t)(live ? row : 0) * D;
  const int chunk = tpr * HOLD;           // values one sweep of the row holds
  float* rb = buf + (size_t)r * chunk;
  auto col_of = [&](int c0, int i) { return c0 + (l + 32 * (w * P + i)) * V; };
  float f[P][V], s[P][V];
  float ss = 0.f;                         // lane l's chain (warp 0)
  for (int c0 = 0; c0 < D; c0 += chunk) {
#pragma unroll
    for (int i = 0; i < P; ++i) {         // every load first
      const int c = col_of(c0, i);
      if (live && c < D) {
        Vec<T>::load(xr, c, D, f[i]);
        if (D <= chunk) Vec<T>::load(scale, c, D, s[i]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) f[i][e] = 0.f;
      }
    }
    if (q == 1) {                         // the warp holds whole chains
#pragma unroll
      for (int i = 0; i < P; ++i)
#pragma unroll
        for (int e = 0; e < V; ++e) ss += f[i][e] * f[i][e];
      continue;
    }
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int e = 0; e < V; ++e) rb[((w * P + i) * V + e) * 32 + l] = f[i][e];
    __syncthreads();
    if (w == 0) {                         // places holding values: < D
      const int places = min(q * P, (D - c0 + 32 * V - 1) / (32 * V));
      for (int p = 0; p < places; ++p)
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float v = rb[(p * V + e) * 32 + l];
          ss += v * v;
        }
    }
    __syncthreads();
  }
  if (w == 0) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (l == 0) rstd_s[r] = rsqrtf(ss / (float)D + eps);
  }
  __syncthreads();
  const float rstd = rstd_s[r];
  if (!live) return;
  if (D <= chunk) {                       // the row is in registers
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int c = col_of(0, i);
      if (c >= D) continue;
#pragma unroll
      for (int e = 0; e < V; ++e) f[i][e] = f[i][e] * rstd * (1.f + s[i][e]);
      Vec<T>::store(orow, c, D, f[i]);
    }
    return;
  }
  for (int c0 = 0; c0 < D; c0 += chunk) { // a long row: read it again
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int c = col_of(c0, i);
      if (c < D) {
        Vec<T>::load(xr, c, D, f[i]);
        Vec<T>::load(scale, c, D, s[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int c = col_of(c0, i);
      if (c >= D) continue;
#pragma unroll
      for (int e = 0; e < V; ++e) f[i][e] = f[i][e] * rstd * (1.f + s[i][e]);
      Vec<T>::store(orow, c, D, f[i]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* scale, void* out, int M, int D,
           float eps, void* stream) {
  if (M <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const int tpr = threads_per_row(D);
  const int threads = tpr > MIN_BLOCK ? tpr : MIN_BLOCK;
  const int rows = threads / tpr;
  rmsnorm_kernel<T><<<(M + rows - 1) / rows, threads, 0,
                      (cudaStream_t)stream>>>(
      (const T*)x, (const T*)scale, (T*)out, M, D, eps, tpr);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" int rmsnorm_f32(const void* x, const void* scale, void* out, int M,
                           int D, float eps, void* stream) {
  return launch<float>(x, scale, out, M, D, eps, stream);
}

extern "C" int rmsnorm_bf16(const void* x, const void* scale, void* out,
                            int M, int D, float eps, void* stream) {
  return launch<bf16>(x, scale, out, M, D, eps, stream);
}
