// The axpy designs `tools/axpy_designs.py` times against the port's kernel
// (`src/repro_torch/kernels/csrc/axpy.cu`, register streaming with plain
// loads and stores, a block a tile). Each computes what that kernel
// computes, with the same roundings, and exports `<design>_f32`,
// `<design>_bf16` with the launchers' arguments and `<design>_grid`.
//
// `axpy_hinted`: the port's register streaming (csrc/stream.cuh) with the
// cache hints of A_HINTS: bits 1 loads skip L1 (L1::no_allocate), 2 loads
// go first from L2 (an evict_first policy), 4 stores stream (st.global.cs);
// and with A_PERSISTENT 1, one persistent wave walks the tiles. All three
// hints on one wave is design A as first drawn.
//
// `axpy_bulk`: persistent blocks (as many as fit an SM at once, by an
// occupancy query, times the SMs), each walking chunks of CHUNK bytes of x
// and y: chunk c = blockIdx.x, + gridDim.x, ... One producer thread keeps
// `cp.async.bulk` global -> shared copies of x's and y's chunk in flight
// in a ring of STAGES stages, each completing on a `full` mbarrier (its
// bytes) and released by the consumers' `empty` mbarrier. Eight consumer
// warps compute a chunk from shared memory into one of two output buffers
// in shared memory, fence it for the async proxy, and one thread stores it
// with `cp.async.bulk` shared -> global (a bulk group, waited on for its
// reads before the buffer is written again). With BULK_HINT 1 loads are
// marked evict-first in L2. A scalar tail takes the values after the last
// whole 16 bytes.
//
// Build (the tool does): nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -shared -Xcompiler -fPIC -I src/repro_torch/kernels/csrc
// [-DA_HINTS=.. -DA_PERSISTENT=.. -DBULK_HINT=..] tools/axpy_designs.cu
#include "stream.cuh"

#ifndef A_HINTS
#define A_HINTS 7
#endif
#ifndef A_PERSISTENT
#define A_PERSISTENT 1
#endif
#ifndef BULK_HINT
#define BULK_HINT 1
#endif

namespace {
__device__ __forceinline__ float axpy1(float a, float x, float y) {
  return __fadd_rn(__fmul_rn(a, x), y);
}

template <typename T>
__device__ __forceinline__ uint4 axpy16(float a, const uint4& xv,
                                        const uint4& yv) {
  constexpr int VEC = 16 / sizeof(T);
  float xf[VEC], yf[VEC];
  stream::unpack<T>(xv, xf);
  stream::unpack<T>(yv, yf);
  __align__(16) T o[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    o[j] = stream::from_f32<T>(axpy1(a, xf[j], yf[j]));
  return *reinterpret_cast<uint4*>(o);
}

// ---------------------------------------------------------------- hinted

__device__ __forceinline__ uint4 hinted_load(const uint4* p) {
  uint64_t policy = 0;
  if constexpr ((A_HINTS & 2) != 0)
    asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
        : "=l"(policy));
  uint4 v;
  if constexpr ((A_HINTS & 3) == 3)
    asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 "
        "{%0, %1, %2, %3}, [%4], %5;\n"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p), "l"(policy));
  else if constexpr ((A_HINTS & 3) == 2)
    asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p), "l"(policy));
  else if constexpr ((A_HINTS & 3) == 1)
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p));
  else
    v = __ldg(p);
  return v;
}

__device__ __forceinline__ void hinted_store(uint4* p, const uint4& v) {
  if constexpr ((A_HINTS & 4) != 0)
    asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
                 "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                 : "memory");
  else
    *p = v;
}

template <typename T>
__global__ void __launch_bounds__(stream::THREADS)
axpy_hinted_kernel(const float* __restrict__ alpha, float alpha_value,
                   const T* __restrict__ x, const T* __restrict__ y,
                   T* __restrict__ out, size_t n, int depth) {
  constexpr int VEC = 16 / sizeof(T);
  const float a = alpha ? *alpha : alpha_value;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* yv = reinterpret_cast<const uint4*>(y);
  uint4* ov = reinterpret_cast<uint4*>(out);
  uint4 xr[stream::UNROLL], yr[stream::UNROLL];
  stream::rounds(
      n / VEC, depth,
      [&](size_t i, int u) {
        xr[u] = hinted_load(xv + i);
        yr[u] = hinted_load(yv + i);
      },
      [&](size_t i, int u) {
        hinted_store(ov + i, axpy16<T>(a, xr[u], yr[u]));
      });
  for (size_t i = n / VEC * VEC + (size_t)blockIdx.x * stream::THREADS +
                  threadIdx.x;
       i < n; i += (size_t)gridDim.x * stream::THREADS)
    out[i] = stream::from_f32<T>(
        axpy1(a, stream::f32(x[i]), stream::f32(y[i])));
}

std::atomic<int> wave_f32[stream::MAX_DEVICES];
std::atomic<int> wave_bf16[stream::MAX_DEVICES];

template <typename T>
cudaError_t hinted_plan(size_t n, int dev, stream::Plan* p) {
  return stream::plan(axpy_hinted_kernel<T>, dev, n / (16 / sizeof(T)),
                      A_PERSISTENT != 0, 1 << 30,
                      sizeof(T) == 4 ? wave_f32 : wave_bf16, p);
}

template <typename T>
int hinted_launch(const void* alpha, float alpha_value, const void* x,
                  const void* y, void* out, size_t n, int dev, void* st) {
  if (n == 0) return (int)cudaErrorInvalidValue;
  stream::Plan p;
  const cudaError_t err = hinted_plan<T>(n, dev, &p);
  if (err != cudaSuccess) return (int)err;
  axpy_hinted_kernel<T><<<p.blocks, stream::THREADS, 0, (cudaStream_t)st>>>(
      (const float*)alpha, alpha_value, (const T*)x, (const T*)y, (T*)out, n,
      p.depth);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ bulk

constexpr int CONSUMER_WARPS = 8;
constexpr int CONSUMERS = 32 * CONSUMER_WARPS;
constexpr int THREADS = CONSUMERS + 32;       // + the producer warp
constexpr int CHUNK = 8192;                   // bytes of x (and of y) a stage
constexpr int STAGES = 4;
constexpr int SMEM = (2 * STAGES + 2) * CHUNK + 2 * STAGES * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  if constexpr (BULK_HINT != 0) {
    uint64_t policy;
    asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
        : "=l"(policy));
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
  }
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
axpy_bulk_kernel(const float* __restrict__ alpha, float alpha_value,
                 const T* __restrict__ x, const T* __restrict__ y,
                 T* __restrict__ out, size_t n) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* xs = smem;
  uint8_t* ys = smem + STAGES * CHUNK;
  uint8_t* os = smem + 2 * STAGES * CHUNK;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (2 * STAGES + 2) * CHUNK);
  uint64_t* empty = full + STAGES;
  const size_t bytes = n / VEC * 16;
  const size_t chunks = (bytes + CHUNK - 1) / CHUNK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const float a = alpha ? *alpha : alpha_value;
  if (warp == CONSUMER_WARPS) {
    if (lane == 0) {
      int k = 0;
      for (size_t c = blockIdx.x; c < chunks; c += gridDim.x, ++k) {
        const int s = k % STAGES;
        if (k >= STAGES) mbar_wait(&empty[s], ((k / STAGES) - 1) & 1);
        const size_t off = c * CHUNK;
        const uint32_t len =
            (uint32_t)(bytes - off < (size_t)CHUNK ? bytes - off : CHUNK);
        mbar_expect_tx(&full[s], 2 * len);
        bulk_load(xs + s * CHUNK, reinterpret_cast<const uint8_t*>(x) + off,
                  len, &full[s]);
        bulk_load(ys + s * CHUNK, reinterpret_cast<const uint8_t*>(y) + off,
                  len, &full[s]);
      }
    }
  } else {
    const int t = threadIdx.x;
    int k = 0;
    for (size_t c = blockIdx.x; c < chunks; c += gridDim.x, ++k) {
      const int s = k % STAGES, ob = k % 2;
      const size_t off = c * CHUNK;
      const uint32_t len =
          (uint32_t)(bytes - off < (size_t)CHUNK ? bytes - off : CHUNK);
      mbar_wait(&full[s], (k / STAGES) & 1);
      // the store of chunk k - 2 has read this output buffer
      if (t == 0)
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      consumers_sync();
      const uint4* xv = reinterpret_cast<const uint4*>(xs + s * CHUNK);
      const uint4* yv = reinterpret_cast<const uint4*>(ys + s * CHUNK);
      uint4* ov = reinterpret_cast<uint4*>(os + ob * CHUNK);
      for (uint32_t v = t; v < len / 16; v += CONSUMERS)
        ov[v] = axpy16<T>(a, xv[v], yv[v]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      consumers_sync();
      if (t == 0)
        bulk_store(reinterpret_cast<uint8_t*>(out) + off, os + ob * CHUNK,
                   len);
    }
    if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
  for (size_t i = n / VEC * VEC + (size_t)blockIdx.x * THREADS + threadIdx.x;
       i < n; i += (size_t)gridDim.x * THREADS)
    out[i] = stream::from_f32<T>(
        axpy1(a, stream::f32(x[i]), stream::f32(y[i])));
}

template <typename T>
int bulk_grid(int dev) {
  static int blocks = 0;
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    if (cudaFuncSetAttribute(axpy_bulk_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, axpy_bulk_kernel<T>, THREADS, SMEM) != cudaSuccess)
      return -1;
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

template <typename T>
int bulk_launch(const void* alpha, float alpha_value, const void* x,
                const void* y, void* out, size_t n, int dev, void* st) {
  const int blocks = bulk_grid<T>(dev);
  if (n == 0 || blocks < 0) return (int)cudaErrorInvalidValue;
  axpy_bulk_kernel<T><<<blocks, THREADS, SMEM, (cudaStream_t)st>>>(
      (const float*)alpha, alpha_value, (const T*)x, (const T*)y, (T*)out, n);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" int axpy_hinted_f32(const void* alpha, float alpha_value,
                               const void* x, const void* y, void* out,
                               size_t n, int dev, void* st) {
  return hinted_launch<float>(alpha, alpha_value, x, y, out, n, dev, st);
}

extern "C" int axpy_hinted_bf16(const void* alpha, float alpha_value,
                                const void* x, const void* y, void* out,
                                size_t n, int dev, void* st) {
  return hinted_launch<bf16>(alpha, alpha_value, x, y, out, n, dev, st);
}

extern "C" int axpy_hinted_grid(size_t n, int bf16_operands, int dev) {
  stream::Plan p;
  const cudaError_t err = bf16_operands ? hinted_plan<bf16>(n, dev, &p)
                                        : hinted_plan<float>(n, dev, &p);
  return err == cudaSuccess ? p.blocks : -1;
}

extern "C" int axpy_bulk_f32(const void* alpha, float alpha_value,
                             const void* x, const void* y, void* out,
                             size_t n, int dev, void* st) {
  return bulk_launch<float>(alpha, alpha_value, x, y, out, n, dev, st);
}

extern "C" int axpy_bulk_bf16(const void* alpha, float alpha_value,
                              const void* x, const void* y, void* out,
                              size_t n, int dev, void* st) {
  return bulk_launch<bf16>(alpha, alpha_value, x, y, out, n, dev, st);
}

extern "C" int axpy_bulk_grid(size_t, int bf16_operands, int dev) {
  return bf16_operands ? bulk_grid<bf16>(dev) : bulk_grid<float>(dev);
}
