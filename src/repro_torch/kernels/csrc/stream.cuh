// Streaming pieces that axpy.cu and dotp.cu share: 16-byte loads through
// the read-only path, a per-thread round of UNROLL 16-byte vectors of each
// operand issued before any is used, a block's round a tile of THREADS *
// UNROLL consecutive vectors, and the plan of a launch (blocks and the
// vectors a thread a round) from the kernel's wave, queried once per
// device.
//
// Why: both kernels move each byte once, so they are bound by HBM (3.35
// TB/s on an H100). A thread that keeps UNROLL vectors of x and of y in
// flight (128 bytes) hides the memory's latency with a quarter of the
// threads a one-vector loop needs, and consecutive tiles keep the grid's
// loads in one window of the arrays. On a small n a thread gets fewer
// vectors and every block of the wave gets work.
//
// What the H100 chose (NVIDIA H100 80GB HBM3, 700 W;
// tools/axpy_designs.py, PERF.md): plain read-only loads and plain stores.
// Loads that skip L1 (L1::no_allocate) or go first from L2 (an evict_first
// policy) were slower at 2^28 values, and streaming stores (st.global.cs)
// no faster.
#pragma once

#include <atomic>

#include "common.cuh"

namespace stream {
constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int MAX_DEVICES = 64;

// 16 bytes from global memory through the read-only path.
__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }

// f32 to T, rounded to nearest even for bf16.
template <typename T>
__device__ __forceinline__ T from_f32(float v);

template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

// The 16 / sizeof(T) values of one vector as f32.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& v, float* f);

template <>
__device__ __forceinline__ void unpack<float>(const uint4& v, float* f) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

template <>
__device__ __forceinline__ void unpack<bf16>(const uint4& v, float* f) {
  unpack8(v, f);
}

// The calling block's share of `nv` vectors, walked in rounds of `depth`
// vectors a thread: u is a vector's place in its thread's round, and a
// whole round's loads come first (`load(i, u)`), then their uses
// (`use(i, u)`), so a thread has a round's vectors in flight. A block's
// round is a tile of THREADS * depth consecutive vectors; block b walks
// tiles b, b + gridDim.x, ... With depth < UNROLL (a small n: `plan`) the
// grid's tiles cover nv in one round.
template <typename Load, typename Use>
__device__ __forceinline__ void rounds(size_t nv, int depth, Load load,
                                       Use use) {
  const size_t tile = (size_t)THREADS * depth;
  size_t i = blockIdx.x * tile + threadIdx.x;
  if (depth == 1) {                  // a small n: a vector a thread
    if (i < nv) {
      load(i, 0);
      use(i, 0);
    }
    return;
  }
  if (depth < UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (u < depth && i + u * THREADS < nv) load(i + u * THREADS, u);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (u < depth && i + u * THREADS < nv) use(i + u * THREADS, u);
    return;
  }
  for (; i < nv; i += gridDim.x * tile) {
    if (i + (UNROLL - 1) * THREADS < nv) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) load(i + u * THREADS, u);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) use(i + u * THREADS, u);
    } else {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (i + u * THREADS < nv) load(i + u * THREADS, u);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (i + u * THREADS < nv) use(i + u * THREADS, u);
    }
  }
}

// A launch over `vectors` 16-byte vectors: its blocks of THREADS and the
// vectors a thread a round.
struct Plan {
  int blocks, depth;
};

// The plan for `kernel` on device `dev`. Its wave is its resident blocks
// an SM (an occupancy query, made at the device's first launch and kept in
// `wave[dev]`: no device query after that) times the SMs. While a wave's
// threads take every vector in a round of fewer than UNROLL, one round on
// as many blocks as that needs (every block gets work); past that, rounds
// of UNROLL, on one wave (`persistent`: dotp, whose blocks each leave a
// partial sum) or on a block a tile (axpy). At most `cap` blocks, which
// then walk rounds of UNROLL.
template <typename Kernel>
cudaError_t plan(Kernel kernel, int dev, size_t vectors, bool persistent,
                 int cap, std::atomic<int>* wave, Plan* p) {
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  int w = wave[dev].load(std::memory_order_relaxed);
  if (w == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          THREADS, 0);
    if (err != cudaSuccess) return err;
    w = sms * (per_sm > 0 ? per_sm : 1);
    wave[dev].store(w, std::memory_order_relaxed);
  }
  const size_t wave_threads = (size_t)w * THREADS;
  const size_t depth = (vectors + wave_threads - 1) / wave_threads;
  size_t blocks;
  if (depth < (size_t)UNROLL) {
    p->depth = depth < 1 ? 1 : (int)depth;
    blocks = (vectors + (size_t)THREADS * p->depth - 1) /
             ((size_t)THREADS * p->depth);
  } else {
    p->depth = UNROLL;
    blocks = persistent ? (size_t)w
                        : (vectors + (size_t)THREADS * UNROLL - 1) /
                              ((size_t)THREADS * UNROLL);
  }
  if (blocks < 1) blocks = 1;
  if (blocks > (size_t)cap) {   // fewer blocks: rounds of UNROLL cover it
    blocks = cap;
    p->depth = UNROLL;
  }
  p->blocks = (int)blocks;
  return cudaSuccess;
}
}  // namespace stream
