// dotp: out (a 0-d f32) = sum(f32(x) * f32(y)) over n values of x and y
// (f32 or bf16).
//
// Replaces the Pallas kernel `repro/kernels/dotp.py` _dotp_kernel / dotp:
// the paper's second memory-bound Table 1 kernel, per-core partial sums
// and a final reduction. The Pallas grid carries the sum from block to
// block in order; here the blocks run in parallel, and the last block to
// finish adds their partial sums.
//
// Bound on an H100 (3.35 TB/s): bytes-bound; 2^28 f32 pairs take at least
// 0.641 ms.
//
// Design: one launch a call. One persistent wave of 256-thread blocks (an
// occupancy query at a device's first launch, kept; on a small n as many
// blocks as give each thread a vector) walks tiles of the 16-byte vectors
// with axpy's loads (stream.cuh: 4 vectors of x and of y in flight a
// thread, plain read-only loads, which the H100 ran faster than loads that
// skip L1 or go first from L2); each thread keeps an f32 sum, the block
// reduces its threads by warp shuffles and then over warps in shared
// memory, and thread 0 writes the block's partial and takes a ticket from
// a counter (atom.add.acq_rel: the partial is released with it, and the
// partials before it acquired). The block that takes the last ticket sums
// the partials in block order, writes `out` and sets the counter back to
// 0. The order of every sum depends only on n and the card (its SMs and
// the kernel's occupancy), so two runs give the same bits. Nothing is
// rounded through the operands' dtype.
//
// The partials and the counter live in this library's own device memory
// (zero when the module loads: no allocation, no memset), in one of SLOTS
// slots, so that launches that can run at once never share one
// (`launch_in_slot`):
// - A launch its stream runs now takes the slot of its (device, stream).
//   A stream new to the library takes the next of EAGER_SLOTS slots in
//   turn, and its launch first waits (an event recorded after each launch
//   on a slot) for the last launch of the slot's old holder: past
//   EAGER_SLOTS streams, launches wait for one another, never share.
// - A launch a CUDA graph captures takes a free slot of the other SLOTS -
//   EAGER_SLOTS for its (device, capture, stream). The graph holds it (a
//   CUDA user object it owns) until the graph and its instantiations are
//   destroyed and their launches done; the replays of one instantiation
//   run in order. A capture that finds no slot free (that many captured
//   dotp streams alive) is refused with an error. A graph
//   instantiated twice, whose two instantiations run at once, would share
//   its slots: torch.cuda.CUDAGraph instantiates once.
// A launch that is refused never runs, and every launch that runs leaves
// its counter at 0, so a failed call spoils no later one.
#include <map>
#include <mutex>
#include <tuple>

#include "stream.cuh"

namespace {
using stream::THREADS;
using stream::UNROLL;
constexpr int MAX_BLOCKS = 2048;   // partials a slot holds: the grid's cap
constexpr int EAGER_SLOTS = 64;    // slots for streams, a device
constexpr int SLOTS = 256;         // and the rest for captured launches

__device__ float partials_of[SLOTS][MAX_BLOCKS];
__device__ unsigned tickets_of[SLOTS];

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Sum over the block's threads, in a fixed order; valid in thread 0.
__device__ __forceinline__ float block_sum(float s) {
  __shared__ float warps[THREADS / 32];
  s = warp_sum(s);
  if (threadIdx.x % 32 == 0) warps[threadIdx.x / 32] = s;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x < 32) {
    t = threadIdx.x < THREADS / 32 ? warps[threadIdx.x] : 0.f;
    t = warp_sum(t);
  }
  return t;
}

// sum(x * y) over one vector's values.
template <typename T>
__device__ __forceinline__ float dot16(const uint4& xv, const uint4& yv) {
  constexpr int VEC = 16 / sizeof(T);
  float a[VEC], b[VEC];
  stream::unpack<T>(xv, a);
  stream::unpack<T>(yv, b);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < VEC; ++j) s += a[j] * b[j];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dotp_kernel(const T* __restrict__ x, const T* __restrict__ y,
            float* __restrict__ out, size_t n, int depth, int slot) {
  constexpr int VEC = 16 / sizeof(T);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* yv = reinterpret_cast<const uint4*>(y);
  const size_t tid = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const size_t threads = (size_t)gridDim.x * THREADS;
  float s = 0.f;
  uint4 xr[UNROLL], yr[UNROLL];
  stream::rounds(
      n / VEC, depth,
      [&](size_t i, int u) {
        xr[u] = stream::load16(xv + i);
        yr[u] = stream::load16(yv + i);
      },
      [&](size_t, int u) { s += dot16<T>(xr[u], yr[u]); });
  for (size_t i = n / VEC * VEC + tid; i < n; i += threads)
    s += stream::f32(x[i]) * stream::f32(y[i]);
  s = block_sum(s);

  float* partials = partials_of[slot];
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
    // the ticket releases this block's partial and acquires every partial
    // released before it
    unsigned ticket;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(ticket) : "l"(&tickets_of[slot]) : "memory");
    last = ticket == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  float t = 0.f;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS)
    t += __ldcg(partials + b);
  t = block_sum(t);
  if (threadIdx.x == 0) {
    *out = t;
    tickets_of[slot] = 0;
  }
}

std::atomic<int> wave_f32[stream::MAX_DEVICES];
std::atomic<int> wave_bf16[stream::MAX_DEVICES];

template <typename T>
cudaError_t plan(size_t n, int dev, stream::Plan* p) {
  return stream::plan(dotp_kernel<T>, dev, n / (16 / sizeof(T)), true,
                      MAX_BLOCKS, sizeof(T) == 4 ? wave_f32 : wave_bf16, p);
}

// The captured slot (dev, EAGER_SLOTS + i) is held while
// graph_held[dev][i]; the destructor of the user object that holds it
// clears the flag (from any thread, so it takes no lock).
std::atomic<bool> graph_held[stream::MAX_DEVICES][SLOTS - EAGER_SLOTS];

void CUDART_CB free_graph_slot(void* ptr) {
  const size_t at = (size_t)ptr - 1;
  graph_held[at / SLOTS][at % SLOTS - EAGER_SLOTS].store(
      false, std::memory_order_release);
}

// Who holds which slot, for both dtypes' launches.
using Key = std::tuple<int, void*, unsigned long long>;  // capture 0: none
std::mutex mu;
std::map<Key, int> slot_of;
std::map<std::pair<int, int>, Key> holder;   // (dev, slot) -> key
cudaEvent_t done[stream::MAX_DEVICES][EAGER_SLOTS];
unsigned next_eager[stream::MAX_DEVICES];

// Launch dotp_kernel<T> on `st` of device `dev` in the slot the notes above
// give it.
template <typename T>
cudaError_t launch_in_slot(const T* x, const T* y, float* out, size_t n,
                           int dev, cudaStream_t st, const stream::Plan& p) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long capture = 0;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(st, &status, &capture, &graph);
  if (err != cudaSuccess) return err;
  if (status == cudaStreamCaptureStatusInvalidated)
    return cudaErrorStreamCaptureInvalidated;
  const bool captured = status == cudaStreamCaptureStatusActive;
  const Key key(dev, (void*)st, captured ? capture : 0ull);
  std::lock_guard<std::mutex> lock(mu);   // to the launch: no slot changes
  int s;                                  // hands while a launch is issued
  const auto hit = slot_of.find(key);
  if (hit != slot_of.end()) {
    s = hit->second;
  } else if (!captured) {
    s = (int)(next_eager[dev]++ % EAGER_SLOTS);
    cudaEvent_t& ev = done[dev][s];
    if (ev == nullptr) {
      err = cudaEventCreateWithFlags(&ev, cudaEventDisableTiming);
    } else {                              // after the old holder's launch
      slot_of.erase(holder.at({dev, s}));
      err = cudaStreamWaitEvent(st, ev, 0);
    }
    if (err != cudaSuccess) return err;
  } else {
    int i = 0;
    for (bool was = false; i < SLOTS - EAGER_SLOTS; ++i, was = false)
      if (graph_held[dev][i].compare_exchange_strong(
              was, true, std::memory_order_acquire))
        break;
    if (i == SLOTS - EAGER_SLOTS) return cudaErrorLaunchOutOfResources;
    s = EAGER_SLOTS + i;
    cudaUserObject_t hold;
    err = cudaUserObjectCreate(&hold, (void*)((size_t)dev * SLOTS + s + 1),
                               free_graph_slot, 1,
                               cudaUserObjectNoDestructorSync);
    if (err != cudaSuccess) {
      graph_held[dev][i].store(false, std::memory_order_release);
      return err;
    }
    err = cudaGraphRetainUserObject(graph, hold, 1, cudaGraphUserObjectMove);
    if (err != cudaSuccess) {
      cudaUserObjectRelease(hold, 1);     // frees the slot
      return err;
    }
    const auto was = holder.find({dev, s});   // a capture that has ended
    if (was != holder.end()) slot_of.erase(was->second);
  }
  holder[{dev, s}] = key;
  slot_of[key] = s;
  dotp_kernel<T><<<p.blocks, THREADS, 0, st>>>(x, y, out, n, p.depth, s);
  err = cudaGetLastError();
  if (err == cudaSuccess && !captured) err = cudaEventRecord(done[dev][s], st);
  return err;
}

template <typename T>
int launch(const void* x, const void* y, void* out, size_t n, int dev,
           void* st) {
  if (n == 0) return (int)cudaErrorInvalidValue;
  stream::Plan p;
  cudaError_t err = plan<T>(n, dev, &p);
  if (err == cudaSuccess)
    err = launch_in_slot<T>((const T*)x, (const T*)y, (float*)out, n, dev,
                            (cudaStream_t)st, p);
  return (int)err;
}
}  // namespace

// Operands are 16-byte aligned (the wrapper checks 32) and hold n values;
// `dev` is the device the stream belongs to (the current one).
extern "C" int dotp_f32(const void* x, const void* y, void* out, size_t n,
                        int dev, void* st) {
  return launch<float>(x, y, out, n, dev, st);
}

extern "C" int dotp_bf16(const void* x, const void* y, void* out, size_t n,
                         int dev, void* st) {
  return launch<bf16>(x, y, out, n, dev, st);
}

// The blocks (partial sums) a launch of n values takes (bf16: 1 for bf16
// operands), or -1.
extern "C" int dotp_grid(size_t n, int bf16_operands, int dev) {
  stream::Plan p;
  const cudaError_t err =
      bf16_operands ? plan<bf16>(n, dev, &p) : plan<float>(n, dev, &p);
  return err == cudaSuccess ? p.blocks : -1;
}
