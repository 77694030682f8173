// axpy: out = T(f32(alpha) * f32(x) + f32(y)), T the operands' dtype
// (f32 or bf16); alpha an f32 scalar, read from device memory or passed by
// value.
//
// Replaces the Pallas kernel `repro/kernels/axpy.py` _axpy_kernel / axpy,
// the paper's low-intensity Table 1 kernel (alpha read from SMEM there).
//
// Bound on an H100 (3.35 TB/s): bytes-bound, 2 flops per 3 elements moved;
// 2^28 f32 elements take at least 0.961 ms.
//
// Design (register streaming, stream.cuh): each thread issues UNROLL = 4
// 16-byte loads of x and of y (4 f32 or 8 bf16 each) before it uses any,
// then writes its 4 16-byte results; a block's round is a tile of 256 * 4
// consecutive vectors, and each block takes one tile, so the card's block
// scheduler hands the next tile to whichever SM finishes first. A small n
// spreads one vector a thread over as many blocks of the wave as it fills
// (the wave: an occupancy query at a device's first launch, kept). The
// last tile is masked, and a scalar tail takes the n % (16 / sizeof(T))
// values after the last whole vector. The product and the sum are rounded
// separately (__fmul_rn, __fadd_rn), as the reference computes them, so no
// FMA contraction changes the result; bf16 computes in f32 and rounds once.
// A Python number reaches the kernel by value (no allocation, no second
// launch); a 1-element f32 tensor is read on the card (no host sync, so a
// CUDA graph can capture the call); the two give the same bits. The launch
// makes no device query and no host sync.
//
// What the H100 chose (NVIDIA H100 80GB HBM3, 700 W; tools/axpy_designs.py,
// PERF.md): at 2^28 f32 one persistent wave walking the tiles was slower
// than a block a tile (some SMs finish their share later), and so were
// loads that skip L1 or go first from L2; the other design, 1-D bulk
// copies (cp.async.bulk) through an mbarrier ring in shared memory with
// bulk stores (`tools/axpy_designs.cu`), was slower than this one too.
#include "stream.cuh"

namespace {
using stream::THREADS;
using stream::UNROLL;

__device__ __forceinline__ float axpy1(float a, float x, float y) {
  return __fadd_rn(__fmul_rn(a, x), y);
}

// One 16-byte vector of results: 4 f32 or 8 bf16, each rounded once.
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
axpy_kernel(const float* __restrict__ alpha, float alpha_value,
            const T* __restrict__ x, const T* __restrict__ y,
            T* __restrict__ out, size_t n, int depth) {
  constexpr int VEC = 16 / sizeof(T);
  const float a = alpha ? *alpha : alpha_value;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* yv = reinterpret_cast<const uint4*>(y);
  uint4* ov = reinterpret_cast<uint4*>(out);
  const size_t tid = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const size_t threads = (size_t)gridDim.x * THREADS;
  uint4 xr[UNROLL], yr[UNROLL];
  stream::rounds(
      n / VEC, depth,
      [&](size_t i, int u) {
        xr[u] = stream::load16(xv + i);
        yr[u] = stream::load16(yv + i);
      },
      [&](size_t i, int u) {
        ov[i] = axpy16<T>(a, xr[u], yr[u]);
      });
  for (size_t i = n / VEC * VEC + tid; i < n; i += threads)
    out[i] = stream::from_f32<T>(
        axpy1(a, stream::f32(x[i]), stream::f32(y[i])));
}

std::atomic<int> wave_f32[stream::MAX_DEVICES];
std::atomic<int> wave_bf16[stream::MAX_DEVICES];

template <typename T>
cudaError_t plan(size_t n, int dev, stream::Plan* p) {
  return stream::plan(axpy_kernel<T>, dev, n / (16 / sizeof(T)),
                      false, 1 << 30,
                      sizeof(T) == 4 ? wave_f32 : wave_bf16, p);
}

template <typename T>
int launch(const void* alpha, float alpha_value, const void* x,
           const void* y, void* out, size_t n, int dev, void* st) {
  if (n == 0) return (int)cudaErrorInvalidValue;
  stream::Plan p;
  const cudaError_t err = plan<T>(n, dev, &p);
  if (err != cudaSuccess) return (int)err;
  axpy_kernel<T><<<p.blocks, THREADS, 0, (cudaStream_t)st>>>(
      (const float*)alpha, alpha_value, (const T*)x, (const T*)y, (T*)out, n,
      p.depth);
  return (int)cudaGetLastError();
}
}  // namespace

// Operands are 16-byte aligned (the wrapper checks 32) and hold n values;
// `alpha` is a device f32, or null and then `alpha_value` is alpha; `dev`
// is the device the stream belongs to (the current one).
extern "C" int axpy_f32(const void* alpha, float alpha_value, const void* x,
                        const void* y, void* out, size_t n, int dev,
                        void* st) {
  return launch<float>(alpha, alpha_value, x, y, out, n, dev, st);
}

extern "C" int axpy_bf16(const void* alpha, float alpha_value, const void* x,
                         const void* y, void* out, size_t n, int dev,
                         void* st) {
  return launch<bf16>(alpha, alpha_value, x, y, out, n, dev, st);
}

// The blocks a launch of n values takes (bf16: 1 for bf16 operands), or -1.
extern "C" int axpy_grid(size_t n, int bf16_operands, int dev) {
  stream::Plan p;
  const cudaError_t err =
      bf16_operands ? plan<bf16>(n, dev, &p) : plan<float>(n, dev, &p);
  return err == cudaSuccess ? p.blocks : -1;
}
