// A Hopper GEMM mainloop: out (M,N) = epilogue(a (M,K) @ b (K,N)), row-major
// bf16 in and out, f32 accumulation, one rounding before the epilogue (the
// `epilogue<EPI>` of common.cuh, as gemm::tile_kernel applies it).
//
// It is the matrix product of the Pallas kernels `repro/kernels/matmul.py`
// _matmul_kernel (bf16) and of `repro/kernels/fused.py`
// build_rmsnorm_matmul, build_matmul_bias_act, build_matmul_residual_add
// and _fa_proj_kernel's projection, at M > 16. Bound on an H100: 2MNK
// operations at 989 TFLOP/s (qwen3-14b's prefill products at M 512 take
// 27-92 us, whisper-small's encoder MLP at M 12000 57 us), above the bytes
// of its operands. What holds it from that: a m64 wgmma reads B from
// shared memory for each 64-row warpgroup, and both consumer warpgroups
// run a tile's epilogue while the tensor cores wait (an activation's
// epilogue at K 768 costs about as much as the tile's products).
//
// Shape of the kernel (a block of 384 threads walks output tiles of BM =
// 128 rows by BN columns):
//   * warpgroup 0 is the producer: after giving up registers (setmaxnreg),
//     one thread keeps TMA loads (cp.async.bulk.tensor) of A and B tiles in
//     flight into a ring of STAGES shared-memory stages, each guarded by a
//     `full` mbarrier (the loads' bytes) and an `empty` one (the consumers'
//     release);
//   * warpgroups 1 and 2 are the consumers, one 64-row half of the tile
//     each: wgmma.mma_async m64nBNk16 over the stage's four k16 slices,
//     the accumulator (BN/2 floats a thread) in registers; each step
//     releases the stage of the step before once that step's products have
//     retired (wgmma.wait_group 1), so the tensor cores never wait on a
//     release, and the tile's last stage is released once all its products
//     have retired (wait_group 0);
//   * the epilogue rounds and stores from registers, 16 bytes a lane after
//     a shuffle transpose within each quad of lanes (`store_rows`), masked
//     at the edges.
// Tiles: a grid of at most one wave (tiles <= SMs) is one block a tile. A
// larger grid is persistent: one block an SM, block b walking tiles b,
// b + gridDim.x, ... in bands of GROUP row tiles walked column by column
// (`tile_origin`), so the tiles in flight at once share A rows and B
// columns in L2. The ring's stage index and mbarrier phases run on across
// a block's tiles, so the producer loads the next tile's first stages
// while the consumers store the current tile's epilogue.
// Layouts: A is K-major, loaded as one 64 (k) x 128 (rows) box a stage.
// B is the weight as the model stores it, (K, N) row-major, so it is
// MN-major for wgmma (the transpose bit of B is set). With the 128-byte
// swizzle a TMA box row holds at most 64 bf16, so a stage holds B as
// ceil(BN/64) boxes of 64 (n) x 64 (k), 8 KB apart; wgmma's descriptor
// steps between them with its leading byte offset (8 KB) and between
// groups of 8 k rows with its stride byte offset (1 KB). A BN that is not
// a multiple of 64 loads the last box whole and reads only its first
// columns.
//
// What it takes: K % 8 == 0 and N % 8 == 0 (TMA's global strides are
// multiples of 16 bytes) and 16-byte aligned operands. TMA fills boxes
// past the matrix edge with zeros, so ragged M, N and K need no masking in
// the mainloop. Shapes it does not take stay on gemm::tile_kernel; that
// choice is made on the shape (`hopper::takes`) before any launch, and a
// failed encode or launch is returned, never retried on another path.
//
// Each caller names itself in the kernel's last template argument, OWNER
// (a plain int, so a profiler trace reads `tma_wgmma_kernel<BN,EPI,
// OWNER>`): the five wrappers that launch the mainloop each have
// instantiations of their own, which is what a trace counts them by.
//
// The attention core (attention.cuh) builds on the same pieces: the
// mbarrier and TMA wrappers (with a 3-D box load and 3-D tensor maps),
// the swizzled descriptors, the register hand-over and `store_rows`.
//
// Tensor maps are encoded on the host for every call (a pointer can be
// reused by the caching allocator for another tensor, so they are not
// cached), with cuTensorMapEncodeTiled fetched once through
// cudaGetDriverEntryPoint (no -lcuda), and passed by value as
// `const __grid_constant__ CUtensorMap`.
//
// The N tile is chosen from the shape so that the tiles fill whole waves
// of the SMs (`pick_bn`): qwen3-14b's prefill at M = 512 takes 128 x 160
// at N 5120 (128 tiles, one wave), 128 x 224 at N 7168 (128 tiles) and
// 128 x 176 at N 17408 (396 tiles, three waves, persistent); 4096^3 takes
// 128 x 256 (512 tiles, persistent on 132 blocks); whisper-small's encoder
// MLP at M 12000 takes 128 x 224 at N 3072 (1,316 tiles) and 128 x 160 at
// N 768 (470 tiles), both persistent.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; no driver symbol is linked

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

#include "common.cuh"

namespace hopper {
constexpr int BM = 128, BK = 64, THREADS = 384;
constexpr int BOX = 64;                       // bf16 in a 128-byte box row
constexpr int A_BYTES = BM * BK * 2;          // 16 KB
constexpr int B_BOX_BYTES = BK * BOX * 2;     // 8 KB
constexpr int SMEM_CAP = 220 * 1024;          // of the 227 KB a block may use
constexpr int TILE_N[] = {128, 160, 176, 224, 256};
constexpr int GROUP = 8;                      // row tiles a band of the walk
constexpr int MAX_CLUSTER = 8;                // portable cluster size

// The wrapper that launches an instantiation (its OWNER argument).
enum : int { OWNER_RMSNORM_MATMUL = 0, OWNER_FLASH_ATTENTION_PROJ = 1,
             OWNER_MATMUL = 2, OWNER_MATMUL_RESIDUAL_ADD = 3,
             OWNER_MATMUL_BIAS_ACT = 4 };

template <int BN>
struct Tile {
  static_assert(BN % 8 == 0 && BN <= 256, "wgmma's N");
  static constexpr int BOXES = (BN + BOX - 1) / BOX;
  static constexpr int STAGE_BYTES = A_BYTES + BOXES * B_BOX_BYTES;
  static constexpr int STAGES =
      SMEM_CAP / STAGE_BYTES > 6 ? 6 : SMEM_CAP / STAGE_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // 1 KB to align
};

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

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

// Spin until the phase of `bar` with this parity has completed.
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

// One 2-D TMA box, coordinates innermost first, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(bar)), "r"(c0), "r"(c1) : "memory");
}

// One 3-D TMA box (a box of rows of slab c2), completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)) : "memory");
}

// Hand registers between warpgroups: the producer gives its up, the
// consumers take them (both called by a whole warpgroup, once, at the top
// of a branch that never rejoins the other).
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// A shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of the accumulator across the
// asynchronous products.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Thread-block clusters (the decode kernel's and the 3xTF32 product's
// split K): a block's rank and its cluster, the cluster barrier, and
// stores into another block's shared memory.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

// The cluster barrier: every thread of the cluster arrives (release), and
// a wait (acquire) returns once all have; what a CTA did before its arrive
// (initialising its mbarriers) is visible to every CTA after the wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// The address of the same shared-memory location in CTA `rank`.
__device__ __forceinline__ uint32_t dsmem(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// st.async: 4 or 8 bytes into (another) CTA's shared memory at cluster
// address `addr`, completing their bytes on the mbarrier at cluster
// address `bar`.
__device__ __forceinline__ void st_async(uint32_t addr, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(addr), "f"(v), "r"(bar) : "memory");
}
__device__ __forceinline__ void st_async2(uint32_t addr, float v0, float v1,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(addr), "f"(v0), "f"(v1), "r"(bar)
      : "memory");
}

// d (64 x BN, f32, the m64nBNk16 register layout) += a (64 x 16, K-major)
// @ b (16 x BN, MN-major): one wgmma.mma_async, operands by descriptor.
template <int BN>
struct Mma;

template <>
struct Mma<128> {
  __device__ static __forceinline__ void run(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        "%60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<160> {
  __device__ static __forceinline__ void run(float (&d)[80], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79"
        "}, %80, %81, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<176> {
  __device__ static __forceinline__ void run(float (&d)[88], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %90, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
        "%84, %85, %86, %87"
        "}, %88, %89, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<224> {
  __device__ static __forceinline__ void run(float (&d)[112], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %114, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
        "%108, %109, %110, %111"
        "}, %112, %113, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
          "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<256> {
  __device__ static __forceinline__ void run(float (&d)[128], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
          "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
          "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(1));
  }
};

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// The origin (m0, n0) of walk index `tile` of an mt x nt grid of tiles:
// bands of GROUP row tiles (the last band may hold fewer), each walked
// column by column, down the band's rows first.
template <int BN>
__device__ __forceinline__ void tile_origin(int tile, int mt, int nt,
                                            int& m0, int& n0) {
  const int band = tile / (GROUP * nt);
  const int first = band * GROUP;
  const int rows = min(GROUP, mt - first);
  const int in = tile - band * GROUP * nt;
  m0 = (first + in % rows) * BM;
  n0 = (in / rows) * BN;
}

// The epilogue of one consumer warp's rows, 16 bytes a store. In the
// m64nBNk16 layout lane l holds, of each 8-column group, columns 2(l%4)
// and 2(l%4) + 1 of row r0 (l/4 added by the caller) and of row r0 + 8:
// the four lanes of a quad share a row. Within a quad the groups of each
// 32-column chunk are transposed with shuffles (lane q receives group q
// of the chunk, its column pair p from lane p), so that each lane rounds 8
// contiguous columns through epilogue<EPI> and stores them as one 16-byte
// vector; the residual (M, N) or the bias (N,) is read likewise, 8 values
// a load. N % 8 == 0, so a group lies in or out of the matrix whole. Rows
// are `ld` elements apart in `out` and in the residual.
template <int BN, int EPI>
__device__ __forceinline__ void store_rows(const float (&acc)[BN / 2],
                                           const bf16* __restrict__ extra,
                                           bf16* __restrict__ out, int r0,
                                           int n0, int M, int N, int lane,
                                           size_t ld) {
  constexpr int GROUPS = BN / 8;
  const int q = lane % 4;
#pragma unroll
  for (int c = 0; c < (GROUPS + 3) / 4; ++c) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[8];                    // v[2p + e]: column 8g + 2p + e
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = q ^ r;         // the group sent, and the pair received
        float send0 = 0.f, send1 = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (4 * c + jj < GROUPS && jj == j) {
            send0 = acc[4 * (4 * c + jj) + 2 * h];
            send1 = acc[4 * (4 * c + jj) + 2 * h + 1];
          }
        const float got0 = __shfl_xor_sync(0xffffffffu, send0, r);
        const float got1 = __shfl_xor_sync(0xffffffffu, send1, r);
#pragma unroll
        for (int p = 0; p < 4; ++p)
          if (p == j) {
            v[2 * p] = got0;
            v[2 * p + 1] = got1;
          }
      }
      const int g = 4 * c + q, row = r0 + 8 * h, col = n0 + 8 * g;
      if (g >= GROUPS || row >= M || col >= N) continue;
      const size_t idx = (size_t)row * ld + col;
      __align__(16) bf16 ext[8], y[8];
      if (EPI != EPI_NONE)           // the residual's 8 values, or the bias's
        *reinterpret_cast<uint4*>(ext) = *reinterpret_cast<const uint4*>(
            extra + (EPI == EPI_RESID ? idx : (size_t)col));
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = epilogue<EPI>(v[i], ext, i, i);
      *reinterpret_cast<uint4*>(out + idx) = *reinterpret_cast<const uint4*>(y);
    }
  }
}

template <int BN, int EPI, int OWNER>
__global__ void __launch_bounds__(THREADS, 1)
tma_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const bf16* __restrict__ extra, bf16* __restrict__ out,
                 int M, int N, int K) {
  using T = Tile<BN>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[T::STAGES], empty[T::STAGES];
  // the 128-byte swizzle repeats every 1 KB: stages start on 1 KB
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int mt = (M + BM - 1) / BM, nt = (N + BN - 1) / BN;
  const int tiles = mt * nt;
  const int ktiles = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);                 // the producer's expect_tx
      mbar_init(&empty[s], 2);                // one release a consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // `it` counts the block's k steps over all its tiles: stage it % STAGES,
  // in its (it / STAGES)-th use
  if (wg == 0) {                              // producer
    reg_dealloc<40>();
    if (t == 0) {
      prefetch_map(&map_a);
      prefetch_map(&map_b);
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int m0, n0;
        tile_origin<BN>(tile, mt, nt, m0, n0);
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % T::STAGES;
          mbar_wait(&empty[s], ((it / T::STAGES) & 1) ^ 1);
          unsigned char* st = smem + s * T::STAGE_BYTES;
          mbar_expect_tx(&full[s], T::STAGE_BYTES);
          tma_load(st, &map_a, &full[s], kt * BK, m0);
#pragma unroll
          for (int j = 0; j < T::BOXES; ++j)
            tma_load(st + A_BYTES + j * B_BOX_BYTES, &map_b, &full[s],
                     n0 + j * BOX, kt * BK);
        }
      }
    }
  } else {                                    // consumers
    reg_alloc<232>();
    const uint32_t half = (wg - 1) * 64 * 128;     // 64 rows of 128 bytes
    // m64nBNk16 layout: warp w, lane l hold rows 16w + l/4 (+8) and, for
    // each 8-column group j, columns 8j + 2(l%4) (+1)
    const int warp = t / 32, lane = t % 32;
    float acc[BN / 2];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int m0, n0;
      tile_origin<BN>(tile, mt, nt, m0, n0);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int s = it % T::STAGES;
        mbar_wait(&full[s], (it / T::STAGES) & 1);
        const uint32_t a_addr = smem_u32(smem + s * T::STAGE_BYTES) + half;
        const uint32_t b_addr = smem_u32(smem + s * T::STAGE_BYTES + A_BYTES);
        fence_acc(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)     // k16 slices: A +32 bytes,
          Mma<BN>::run(acc,                      // B +16 rows of 128 bytes
                       sw128_desc(a_addr + kk * 32, 16, 1024),
                       sw128_desc(b_addr + kk * 2048, B_BOX_BYTES, 1024));
        wg_commit();
        fence_acc(acc);
        wg_wait<1>();                            // step it-1 has retired
        if (kt > 0 && t == 0) mbar_arrive(&empty[(it - 1) % T::STAGES]);
      }
      wg_wait<0>();
      fence_acc(acc);
      // the tile's last stage: the producer may be waiting on it for the
      // block's next tile
      if (t == 0) mbar_arrive(&empty[(it - 1) % T::STAGES]);

      store_rows<BN, EPI>(acc, extra, out,
                          m0 + (wg - 1) * 64 + warp * 16 + lane / 4, n0, M,
                          N, lane, N);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Whether the path takes a shape: TMA's global strides (K, N bf16) must
// be multiples of 16 bytes.
inline bool takes(int N, int K) { return N % 8 == 0 && K % 8 == 0; }

// Whether a wrapper with common.cuh's split-K path sends an (M, K) x (K, N)
// product here: above M = 16 (below, streaming the weight is the whole
// cost and split-K does it) when the path takes the shape.
inline bool takes_prefill(int M, int N, int K) {
  return M > skinny::MAX_M && takes(N, K);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a row-major (rows, cols) matrix of `type` (bf16 unless
// named; f32 for the 3xTF32 product, tf32x3_gemm.cuh) read in boxes of 128
// bytes of a row (64 bf16, 32 f32) by `box_rows` rows, 128-byte swizzled,
// zero past its edges. With `slabs` > 0 the map is 3-D: `slabs` such
// matrices end to end, a box reading rows of one slab only (zero past that
// slab's last row, where a 2-D map over all the rows would read the next
// slab's).
inline cudaError_t encode(
    CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows,
    int slabs = 0,
    CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t size = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)slabs};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * size,
                                 (cuuint64_t)rows * cols * size};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / size), (cuuint32_t)box_rows,
                             1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, type, slabs > 0 ? 3 : 2, const_cast<void*>(ptr),
                        dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline int sm_count() {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// How many clusters of c blocks (c = 1..MAX_CLUSTER) of `kernel` the card
// runs at once with `threads` threads and `smem` bytes of dynamic shared
// memory a block (the kernel already allows that much), into act[c]; 0
// where it runs none.
template <typename Kernel>
void active_clusters(Kernel kernel, int threads, int smem, int* act) {
  for (int c = 1; c <= MAX_CLUSTER; ++c) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
      cudaGetLastError();
      n = 0;
    }
    act[c] = n;
  }
}

// A launch on `st` with programmatic dependent launch (the kernel lets
// the next begin early and waits for the one before it) in clusters of
// `cluster` blocks (1 too: a kernel that runs cluster instructions, as
// the decode kernel does at every cluster size, needs a cluster launch).
template <typename... Params, typename... Actual>
cudaError_t launch_ex(void (*kernel)(Params...), dim3 grid, int threads,
                      size_t smem, int cluster, cudaStream_t st,
                      Actual&&... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = cluster;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, std::forward<Actual>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// `search(M, N, K)`, kept for each shape: a plan is searched once and a
// call's host time is a lookup. Each caller passes a lambda of its own
// (a type of its own), so each has its own table.
template <typename Search>
auto per_shape(int M, int N, int K, Search search)
    -> decltype(search(M, N, K)) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int>, decltype(search(M, N, K))> seen;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(M, N, K);
  const auto hit = seen.find(key);
  if (hit != seen.end()) return hit->second;
  return seen[key] = search(M, N, K);
}

// The N tile whose tiles fill the SMs' waves best: least ceil(tiles /
// SMs) * BN (the columns one SM walks), the wider tile on a tie.
inline int pick_bn(int M, int N, int sms) {
  const long mt = (M + BM - 1) / BM;
  int best = TILE_N[0];
  long best_cost = -1;
  for (int bn : TILE_N) {
    const long tiles = mt * ((N + bn - 1) / bn);
    const long cost = (tiles + sms - 1) / sms * bn;
    if (best_cost < 0 || cost <= best_cost) {
      best_cost = cost;
      best = bn;
    }
  }
  return best;
}

// How an (M, N) output is walked: its N tile, its tiles, and the blocks
// launched (one a tile up to one wave, else one an SM: persistent).
struct Plan {
  int bn, tiles, blocks;
};

// Whether `bn` is one of the N tiles `launch` instantiates.
inline bool is_tile_n(int bn) {
  for (int t : TILE_N)
    if (t == bn) return true;
  return false;
}

// The plan of N tile `tile_n`, or of `pick_bn`'s when it is 0 (a tuned
// caller pins the tile the tuning layer's race chose); {0, 0, 0} when
// `tile_n` is not one of TILE_N.
inline Plan plan(int M, int N, int tile_n = 0) {
  const int sms = sm_count();
  if (tile_n != 0 && !is_tile_n(tile_n)) return {0, 0, 0};
  const int bn = tile_n != 0 ? tile_n : pick_bn(M, N, sms);
  const int tiles = ((M + BM - 1) / BM) * ((N + bn - 1) / bn);
  return {bn, tiles, tiles < sms ? tiles : sms};
}

template <int BN, int EPI, int OWNER>
cudaError_t launch_bn(const CUtensorMap& map_a, const CUtensorMap& map_b,
                      const void* extra, void* out, int M, int N, int K,
                      int blocks, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      tma_wgmma_kernel<BN, EPI, OWNER>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::SMEM);
  if (err != cudaSuccess) return err;
  tma_wgmma_kernel<BN, EPI, OWNER><<<blocks, THREADS, Tile<BN>::SMEM, st>>>(
      map_a, map_b, (const bf16*)extra, (bf16*)out, M, N, K);
  return cudaGetLastError();
}

// out (M,N) = epilogue(a (M,K) @ b (K,N)); the caller has checked `takes`
// and names itself in OWNER. `tile_n` pins the N tile (0: `pick_bn`'s); a
// tile outside TILE_N is refused, never replaced.
template <int EPI, int OWNER>
int launch(const void* a, const void* b, const void* extra, void* out, int M,
           int N, int K, void* stream, int tile_n = 0) {
  if (M <= 0 || N <= 0 || K <= 0 || !takes(N, K))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(M, N, tile_n);
  if (p.bn == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  cudaError_t err = encode(&map_a, a, M, K, BM);
  if (err == cudaSuccess) err = encode(&map_b, b, K, N, BK);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  switch (p.bn) {
    case 128:
      err = launch_bn<128, EPI, OWNER>(map_a, map_b, extra, out, M, N, K,
                                       p.blocks, st);
      break;
    case 160:
      err = launch_bn<160, EPI, OWNER>(map_a, map_b, extra, out, M, N, K,
                                       p.blocks, st);
      break;
    case 176:
      err = launch_bn<176, EPI, OWNER>(map_a, map_b, extra, out, M, N, K,
                                       p.blocks, st);
      break;
    case 224:
      err = launch_bn<224, EPI, OWNER>(map_a, map_b, extra, out, M, N, K,
                                       p.blocks, st);
      break;
    default:
      err = launch_bn<256, EPI, OWNER>(map_a, map_b, extra, out, M, N, K,
                                       p.blocks, st);
  }
  return (int)err;
}
}  // namespace hopper

// The mainloop's plan for an (M, N) output on the current device under the
// pinned N tile `tile_n` (0: the kernel's own pick), as {BN, tiles,
// blocks} in `plan` (the walk is persistent when tiles > blocks); for
// reports, not for launching.
extern "C" int wgmma_plan(int M, int N, int tile_n, int* plan) {
  if (M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const hopper::Plan p = hopper::plan(M, N, tile_n);
  if (p.bn == 0) return (int)cudaErrorInvalidValue;
  plan[0] = p.bn;
  plan[1] = p.tiles;
  plan[2] = p.blocks;
  return 0;
}
