// The decode product on Hopper: out (M,N) = epilogue<EPI>(prologue<NORM>(a)
// (M,K) @ w (K,N)) for M <= 16 (M = the decode slots), bf16 in and out,
// f32 accumulation, one rounding before the epilogue (common.cuh's
// `epilogue<EPI>`), K and N multiples of 8.
//
// It is the M <= 16 product of the Pallas kernels `repro/kernels/fused.py`
// build_rmsnorm_matmul (NORM: bf16((x * rstd) * (1 + scale)) rounded
// before the product, as `_norm_tile` does), build_matmul_residual_add,
// build_matmul_bias_act and `repro/kernels/matmul.py` _matmul_kernel
// (bf16), which all four wrappers reach through `launch_matmul` below.
//
// Bound on an H100: the weight's bytes at 3.35 TB/s. At M <= 16 the
// product does at most 16 flops a weight byte against the ~295 the card
// does for every byte it reads, so the kernel's one job is to keep HBM
// busy: qwen3-14b's q/o weights (5120 x 5120) take at least 15.6 us, its
// gate/up and down weights (5120 x 17408) 53 us.
//
// Design:
//   * Weight stream by TMA. One producer thread keeps cp.async.bulk.tensor
//     loads of 64 (n) x 64 (k) weight boxes (8 KB, 128-byte swizzle, the
//     mainloop's B box) in flight into a ring of stages guarded by `full`
//     / `empty` mbarriers, k box outer and column box inner, so that a CTA
//     reads `boxes` x 128 contiguous bytes of each weight row at once. No
//     weight byte passes through registers on its way to shared memory.
//     Two CTAs share an SM (110 KB each, a ring of up to 12 stages: 96 KB
//     in flight a CTA), so that one streams while the other starts or
//     ends; a CTA whose slice of x leaves too little room takes an SM
//     alone (up to 24 stages).
//   * x's slice (and the scale's) comes by bulk copy (cp.async.bulk) on an
//     mbarrier of its own, issued ahead of the weight's boxes, so that it
//     does not queue behind the stream.
//   * Tensor cores, operands swapped: out^T = w^T . x^T, the weight's
//     columns on the MMA's M side and the <= 16 slots on its N side, as
//     `mma.sync m16n8k16` (one n8 tile at M <= 8, two at M <= 16). Each of
//     four consumer warps owns 16 columns of every box and an accumulator
//     for each box of the tile: its A fragments come from the swizzled box
//     through `ldmatrix.trans` (the weight is stored (K, N), N contiguous),
//     its B fragments are 32-bit loads of the staged rows of x, shared by
//     the k box's column boxes. A warp-level MMA, and not wgmma, because
//     the work is bytes-bound: a few MMAs a box keep pace with HBM, and
//     the slots need no 64-row warpgroup tile.
//   * Split-K inside a thread-block cluster of C CTAs (1-8): the cluster
//     owns one column tile of `boxes` x 64 columns, each CTA one k range.
//     With NORM each CTA sums the squares of its slice of x; the cluster
//     exchanges the sums through distributed shared memory (DSMEM), so
//     that every CTA holds the whole rows' rstd (summed in rank order),
//     and each CTA normalises its slice as it loads the B fragments:
//     bf16((x * rstd) * (1 + scale)), rounded before the product. No CTA
//     reads more of x than its slice.
//   * After the k loop each CTA pushes its f32 partial tile, through DSMEM,
//     to the CTAs that reduce it (column group v to CTA v % C); each sums
//     its groups' C partials in rank order, applies `epilogue<EPI>` and
//     stores 16 bytes. No f32 workspace in device memory, no second
//     launch: one launch a call, and a fixed sum order, so two runs give
//     the same bits.
//   * Programmatic dependent launch: the kernel lets the next one on the
//     stream start early, and waits for the one before it before it loads
//     anything into shared memory or writes `out` (the weight may be the
//     kernel before's output, as x and the residual may be). Before that
//     wait only its setup and an L2 prefetch of its first weight boxes
//     overlap the kernel before it: L2 is where every write lands, so a
//     prefetch cannot hand the SM stale bytes.
//   * `plan` picks the column tile (1-8 boxes) and the cluster size so
//     that the CTAs spread evenly over the SMs: the fewest weight boxes
//     any CTA streams, each further wave of clusters (cluster occupancy
//     from cudaOccupancyMaxActiveClusters) counted as another pass.
//
// Launch: `hopper::launch_ex` (a cluster dimension, programmatic
// dependent launch); the tensor map of the weight is encoded on the host
// for every call and passed by value, as the mainloop does; nothing in the
// launch synchronises or allocates, so it is captured in a CUDA graph like
// any other launch.
#pragma once

#include <atomic>

#include "wgmma_gemm.cuh"

namespace decode {
constexpr int MAX_M = skinny::MAX_M;         // 16: two n8 tiles of slots
constexpr int CONSUMERS = 4;                 // warps, 16 box columns each
constexpr int THREADS = (CONSUMERS + 1) * 32;  // + the producer warp
constexpr int BOX = hopper::BOX;             // 64 columns of the weight
constexpr int BOX_K = 64;                    // k rows of a box
constexpr int BOX_BYTES = hopper::B_BOX_BYTES;   // 8 KB
constexpr int MAX_CLUSTER = hopper::MAX_CLUSTER;   // 8
constexpr int MAX_BOXES = 8;                 // boxes across a column tile
constexpr int MIN_STAGES = 4, PAIR_STAGES = 12, SOLO_STAGES = 24;
constexpr int MAX_STAGES = SOLO_STAGES;
constexpr int PAIR_SMEM = 110 * 1024;        // a CTA's, two to an SM
constexpr int SOLO_SMEM = hopper::SMEM_CAP;  // a CTA's, alone on its SM
constexpr int MAX_K = MAX_CLUSTER * 4096;    // x's slice must fit a CTA
constexpr int WAVE_BOXES = 8;                // a wave's fixed time, in boxes

// What the kernel takes: M <= 16, TMA's 16-byte strides (K, N % 8) and
// K <= MAX_K, past which x's slice no longer fits a CTA of an eight-CTA
// cluster (no model shape comes near: qwen3-14b's largest K is 17408).
inline bool takes(int M, int N, int K) {
  return M > 0 && M <= MAX_M && K <= MAX_K && hopper::takes(N, K);
}

struct Args {
  const bf16* x;        // (M, K)
  const bf16* scale;    // (K,), NORM only
  const bf16* extra;    // the residual (M, N) or the bias (N,), or null
  bf16* out;            // (M, N)
  int M, N, K;
  int boxes;            // 64-column boxes across a column tile
  int kboxes;           // 64-row k boxes a CTA streams (its k range)
  int stages;           // ring stages
  float eps;
};

// ---------------------------------------------------------------------------
// PTX wrappers: cluster, DSMEM and the warp-level MMA
// ---------------------------------------------------------------------------

using hopper::cluster_arrive;
using hopper::cluster_id;
using hopper::cluster_rank;
using hopper::cluster_size;
using hopper::cluster_wait;
using hopper::dsmem;
using hopper::st_async;
using hopper::st_async2;

// A bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(hopper::smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
        "r"(bytes), "r"(hopper::smem_u32(bar))
      : "memory");
}

// A hint to bring one 2-D TMA box of `map` into L2 (no shared memory, no
// completion to wait for).
__device__ __forceinline__ void tma_prefetch_l2(const CUtensorMap* map,
                                                int c0, int c1) {
  asm volatile(
      "cp.async.bulk.prefetch.tensor.2d.L2.global [%0, {%1, %2}];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1) : "memory");
}

// norm8's arithmetic on a pair of bf16 (x, and the scale at the same k).
__device__ __forceinline__ uint32_t norm2(uint32_t x, uint32_t s,
                                          float rstd) {
  const float2 xf =
      __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  const float2 sf =
      __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&s));
  __nv_bfloat162 o;
  o.x = __float2bfloat16(xf.x * rstd * (1.f + sf.x));
  o.y = __float2bfloat16(xf.y * rstd * (1.f + sf.y));
  return *reinterpret_cast<uint32_t*>(&o);
}

// The 128 consumer threads' barrier (the producer warp is not in it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 32) : "memory");
}

// Four 8x8 b16 matrices, transposed: lanes 8j..8j+7 give the rows of
// matrix j; register j receives matrix j.
__device__ __forceinline__ void ldmatrix_t4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) @ b (16 x 8, bf16, col).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// Shared memory: the ring (1 KB aligned, the swizzle's period), then x's
// slice (mpad rows of kl + 8 bf16: the 16-byte pad puts the 8 rows an MMA
// fragment reads on distinct banks) and the scale's (one more row, NORM),
// then the partials this CTA reduces (`recv`). Grid: one cluster a column
// tile (%clusterid.x), rank r of it streaming k boxes [r * kboxes, (r + 1)
// * kboxes), boxes past K zero-filled by TMA.
//
// The cluster's exchanges are pushes, not barriers in the stream's way:
// each CTA stores its values into the receiving CTAs' shared memory with
// st.async, which completes bytes on the receiver's mbarrier (`exch` for
// the rows' sums of squares, `recv` for the partial tile); a receiver
// waits for the bytes it expects and sums its slots in rank order. The one
// cluster barrier, at the start, makes every CTA's mbarriers initialised
// before any push; no CTA reads another's shared memory, so none waits
// for the others to leave.
template <bool NORM, int EPI>
__global__ void __launch_bounds__(THREADS, 2)
tma_gemv_kernel(const __grid_constant__ CUtensorMap map_w, const Args a) {
  using hopper::mbar_arrive;
  using hopper::mbar_expect_tx;
  using hopper::mbar_init;
  using hopper::mbar_wait;
  using hopper::smem_u32;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  __shared__ __align__(8) uint64_t xbar, exch, recv_bar;
  __shared__ float ssq[MAX_CLUSTER][MAX_M], red[CONSUMERS][MAX_M];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int S = a.stages;
  const int mpad = a.M > 8 ? 16 : 8;          // slot tiles, zero past M
  const int kl = a.kboxes * BOX_K, xld = kl + 8;
  const int bn = a.boxes * BOX;
  bf16* xs = reinterpret_cast<bf16*>(ring + (size_t)S * BOX_BYTES);
  bf16* sc = xs + (size_t)mpad * xld;       // the scale's slice (NORM)
  float* recv = reinterpret_cast<float*>(sc + xld);

  const int C = (int)cluster_size(), rank = (int)cluster_rank();
  const int n0 = (int)cluster_id() * bn;
  const int nbox = min(a.boxes, (a.N - n0 + BOX - 1) / BOX);   // inside N
  const int kb0 = rank * a.kboxes;
  const int kb1 = min((a.K + BOX_K - 1) / BOX_K, kb0 + a.kboxes);
  const int nk = max(0, kb1 - kb0);
  const int k_begin = kb0 * BOX_K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the tile's groups of 8 columns: group v (inside N: v < 8 nbox) is
  // reduced by CTA v % C into its local group v / C; recv holds [rank of
  // the sender][local group][column][slot]
  const int lgroups = (a.boxes * 8 + C - 1) / C;
  const int owned = rank < 8 * nbox ? (8 * nbox - rank + C - 1) / C : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);                 // the producer's expect_tx
      mbar_init(&empty[s], CONSUMERS);        // one release a consumer warp
    }
    mbar_init(&xbar, 1);                      // x's slice (and the scale's)
    mbar_init(&exch, 1);
    mbar_init(&recv_bar, 1);
    if (NORM) mbar_expect_tx(&exch, (uint32_t)(C * mpad * 4));
    mbar_expect_tx(&recv_bar, (uint32_t)(C * owned * 8 * mpad * 4));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_arrive();                           // the mbarriers are ready
  // programmatic dependent launch: the next kernel on the stream may be
  // scheduled now (it waits for this grid before it touches what we write)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // x's slice: the columns [k_begin, k_begin + kcopy) a bulk copy brings,
  // the rest (past K, and rows M..mpad) zero
  const int kcopy = max(0, min(kl, a.K - k_begin));
  const int vpr = kl / 8;                     // 16-byte vectors a row

  // `it` counts the boxes the CTA streams: k box outer, column box inner;
  // stage it % S in its (it / S)-th use
  if (warp == CONSUMERS) {                    // producer warp
    if (lane == 0) {
      const int total = nk * nbox;
      // while the kernel before this one runs, only L2 is warmed: the ring's
      // first fill of boxes; what it writes may be any of x, the scale, the
      // residual or the weight, so nothing reaches shared memory before it
      // has finished
      if (total > 0) hopper::prefetch_map(&map_w);
      for (int it = 0; it < min(total, S); ++it)
        tma_prefetch_l2(&map_w, n0 + (it % nbox) * BOX,
                        (kb0 + it / nbox) * BOX_K);
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      const uint32_t bytes = (uint32_t)kcopy * 2;
      if (bytes > 0) {
        mbar_expect_tx(&xbar, bytes * (uint32_t)(a.M + (NORM ? 1 : 0)));
        for (int m = 0; m < a.M; ++m)
          bulk_load(xs + (size_t)m * xld, a.x + (size_t)m * a.K + k_begin,
                    bytes, &xbar);
        if (NORM) bulk_load(sc, a.scale + k_begin, bytes, &xbar);
      } else {
        mbar_arrive(&xbar);
      }
      for (int it = 0; it < total; ++it) {
        const int s = it % S, kb = kb0 + it / nbox, b = it % nbox;
        mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        mbar_expect_tx(&full[s], BOX_BYTES);
        hopper::tma_load(ring + (size_t)s * BOX_BYTES, &map_w, &full[s],
                         n0 + b * BOX, kb * BOX_K);
      }
    }
    return;
  }

  // consumers: the kernel before this one on the stream may still be
  // writing the residual or reading `out`'s memory: wait for it to finish
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int ct = threadIdx.x;                 // 0..127
  {                                           // the zeros around x's slice
    const int rows = mpad + (NORM ? 1 : 0), vc = kcopy / 8;
    for (int i = ct; i < rows * vpr; i += CONSUMERS * 32) {
      const int m = i / vpr, c = i - m * vpr;
      const bool copied = (m < a.M || m == mpad) && c < vc;
      if (!copied)
        *reinterpret_cast<uint4*>(xs + (size_t)m * xld + c * 8) =
            make_uint4(0, 0, 0, 0);
    }
  }
  mbar_wait(&xbar, 0);
  consumers_sync();
  cluster_wait();                             // every CTA's mbarriers ready
  if (NORM) {
    // this slice's sums of squares, all rows in one pass (thread ct sums
    // columns ct, ct + 128, ... of each row), reduced over the warp's lanes
    // and then the four warps in order; thread (m, r) pushes row m's sum to
    // CTA r of the cluster (slot `rank`)
    float ss[MAX_M] = {};
    for (int c = ct; c < vpr; c += CONSUMERS * 32)
#pragma unroll
      for (int m = 0; m < MAX_M; ++m) {
        if (m >= mpad) break;
        float f[8];
        unpack8(*reinterpret_cast<const uint4*>(xs + (size_t)m * xld + c * 8),
                f);
#pragma unroll
        for (int e = 0; e < 8; ++e) ss[m] += f[e] * f[e];
      }
#pragma unroll
    for (int m = 0; m < MAX_M; ++m) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ss[m] += __shfl_xor_sync(0xffffffffu, ss[m], o);
      if (lane == 0) red[warp][m] = ss[m];
    }
    consumers_sync();
    if (ct < mpad * C) {
      const int m = ct / C, r = ct - m * C;
      float tot = 0.f;
#pragma unroll
      for (int w = 0; w < CONSUMERS; ++w) tot += red[w][m];
      st_async(dsmem(smem_u32(&ssq[rank][m]), r), tot,
               dsmem(smem_u32(&exch), r));
    }
  }

  // the k loop, k box outer and column box inner, as the producer loads
  // them (a CTA reads `boxes` x 128 contiguous bytes of each weight row at
  // once). Warp w owns columns 16w..16w+15 of every box and keeps an
  // accumulator for each of the tile's boxes. ldmatrix lane l gives row
  // (l/8 >= 2 ? 8 : 0) + l%8 of the k16 slice, the 8 columns at 16w +
  // 8(l/8 % 2): matrices (k 0-7, n 0-7), (k 0-7, n 8-15), (k 8-15, n 0-7),
  // (k 8-15, n 8-15) are the A fragment's a0..a3 once transposed. A box row
  // is 128 bytes, its 16-byte chunk c stored at c ^ (row % 8) (the TMA's
  // 128-byte swizzle). The B fragments of a k box serve all its boxes.
  const int g = lane / 4, t = lane % 4;
  const bool two = mpad > 8;
  const int lj = lane / 8, lr = lane % 8;
  const uint32_t a_off = (uint32_t)((((lj >> 1) * 8 + lr) * 128) +
                                    (((2 * warp + (lj & 1)) ^ lr) << 4));
  const uint32_t ring_u = smem_u32(ring);
  // NORM: the rstd of this thread's two slots g and g + 8, summed from the
  // C slices in rank order (the same bits in every thread and CTA)
  float rs[2] = {0.f, 0.f};
  if (NORM) {
    mbar_wait(&exch, 0);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float tot = 0.f;
      for (int r = 0; r < C; ++r) tot += ssq[r][8 * mt + g];
      rs[mt] = rsqrtf(tot / (float)a.K + a.eps);
    }
  }
  float acc[MAX_BOXES][2][4] = {};
  int it = 0;
  for (int j = 0; j < nk; ++j) {
    // the B fragments of this k box: slots g (+8), k 2t, 2t + 1 (+8) of
    // each k16 slice, normalised here with NORM: bf16((x * rstd) * (1 +
    // scale)), as norm8 computes it
    uint32_t bf[2][BOX_K / 16][2];            // [slot tile][k16 slice]
    const bf16* xp = xs + (size_t)g * xld + j * BOX_K + 2 * t;
    const bf16* sp = sc + j * BOX_K + 2 * t;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int kk = 0; kk < BOX_K / 16; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bf16* xk = xp + (size_t)(8 * mt) * xld + kk * 16 + 8 * h;
          uint32_t v = 0u;
          if (mt == 0 || two) {
            v = *reinterpret_cast<const uint32_t*>(xk);
            if (NORM) v = norm2(v, *reinterpret_cast<const uint32_t*>(
                                       sp + kk * 16 + 8 * h), rs[mt]);
          }
          bf[mt][kk][h] = v;
        }
#pragma unroll
    for (int b = 0; b < MAX_BOXES; ++b) {
      if (b >= nbox) break;
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      const uint32_t base = ring_u + (uint32_t)s * BOX_BYTES + a_off;
#pragma unroll
      for (int kk = 0; kk < BOX_K / 16; ++kk) {
        uint32_t af[4];
        ldmatrix_t4(base + kk * 2048, af);    // 16 k rows of 128 bytes
        mma16816(acc[b][0], af, bf[0][kk][0], bf[0][kk][1]);
        if (two) mma16816(acc[b][1], af, bf[1][kk][0], bf[1][kk][1]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      ++it;
    }
  }

  // push the partial tile: the D fragment holds d0, d1 at (column g, slots
  // 2t, 2t+1) and d2, d3 at column g + 8, i.e. groups 8b + 2w and 8b + 2w
  // + 1, column g of each; a pair of slots is one 8-byte st.async into the
  // owning CTA's recv[rank][v / C][g][2t]
  const uint32_t recv_u = smem_u32(recv);
#pragma unroll
  for (int b = 0; b < MAX_BOXES; ++b) {
    if (b >= nbox) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = 8 * b + 2 * warp + h, owner = v % C;
      const uint32_t bar = dsmem(smem_u32(&recv_bar), owner);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt == 1 && !two) break;
        const uint32_t off =
            (uint32_t)((((rank * lgroups + v / C) * 8 + g) * mpad +
                        8 * mt + 2 * t) * 4);
        st_async2(dsmem(recv_u + off, owner), acc[b][mt][2 * h],
                  acc[b][mt][2 * h + 1], bar);
      }
    }
  }

  // this CTA's groups: the C partials of each in rank order, rounded
  // through the epilogue, 16 bytes a store
  mbar_wait(&recv_bar, 0);
  for (int i = ct; i < owned * a.M; i += CONSUMERS * 32) {
    const int lg = i / a.M, m = i - lg * a.M;
    const int n = n0 + 8 * (lg * C + rank);
    if (n >= a.N) continue;                   // N % 8 == 0: whole groups
    float sum[8] = {};
    for (int r = 0; r < C; ++r) {
      const float* p = recv + ((size_t)(r * lgroups + lg) * 8) * mpad + m;
#pragma unroll
      for (int e = 0; e < 8; ++e) sum[e] += p[e * mpad];
    }
    const size_t idx = (size_t)m * a.N + n;
    __align__(16) bf16 ext[8], y[8];
    if (EPI != EPI_NONE)                      // the residual's 8, or the bias's
      *reinterpret_cast<uint4*>(ext) = *reinterpret_cast<const uint4*>(
          a.extra + (EPI == EPI_RESID ? idx : (size_t)n));
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = epilogue<EPI>(sum[e], ext, e, e);
    *reinterpret_cast<uint4*>(a.out + idx) = *reinterpret_cast<const uint4*>(y);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The ring, x's and the scale's slices, and the partials a CTA receives
// (at most C * ceil(8 boxes / C) groups of 8 columns of mpad slots).
inline size_t smem_bytes(int mpad, int boxes, int kboxes, int stages) {
  return 1024 + (size_t)stages * BOX_BYTES +
         (size_t)(mpad + 1) * (kboxes * BOX_K + 8) * 2 +
         (size_t)(boxes * 8 + MAX_CLUSTER) * 8 * mpad * 4;
}

// How many clusters of c CTAs the card runs at once (0: not at all), for
// each c <= 8, when each CTA takes `smem` bytes: [per SM - 1][c] for
// PAIR_SMEM (two CTAs an SM) and SOLO_SMEM (one); asked once per
// instantiation.
template <bool NORM, int EPI>
const int (*active_clusters())[MAX_CLUSTER + 1] {
  static int act[2][MAX_CLUSTER + 1] = {};
  static std::once_flag once;
  std::call_once(once, [] {
    auto kernel = tma_gemv_kernel<NORM, EPI>;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SOLO_SMEM) != cudaSuccess) {
      cudaGetLastError();
      return;
    }
    hopper::active_clusters(kernel, THREADS, SOLO_SMEM, act[0]);
    hopper::active_clusters(kernel, THREADS, PAIR_SMEM, act[1]);
  });
  return act;
}

struct Plan {
  int boxes, cluster, tiles, kboxes, stages;
  size_t smem;
  int per_sm;           // CTAs an SM holds: 2 in PAIR_SMEM, else 1
};

// A plan of `boxes` x `kboxes` a CTA in clusters of `cluster`. Its ring
// takes what is left of PAIR_SMEM (4-12 stages; two CTAs an SM, so that
// one streams while the other starts or ends), or, when x's slice leaves
// too little of it, of SOLO_SMEM (4-24 stages, one CTA an SM); {0, ...}
// if neither fits.
inline Plan fit(int M, int N, int K, int boxes, int cluster, int kboxes) {
  Plan p = {0, 0, 0, 0, 0, 0, 0};
  const int mpad = M > 8 ? 16 : 8;
  const size_t fixed = smem_bytes(mpad, boxes, kboxes, 0);
  const size_t room = MIN_STAGES * BOX_BYTES;
  int stages;
  if (fixed + room <= (size_t)PAIR_SMEM) {
    p.per_sm = 2;
    stages = (int)((PAIR_SMEM - fixed) / BOX_BYTES);
    stages = stages > PAIR_STAGES ? PAIR_STAGES : stages;
  } else if (fixed + room <= (size_t)SOLO_SMEM) {
    p.per_sm = 1;
    stages = (int)((SOLO_SMEM - fixed) / BOX_BYTES);
    stages = stages > SOLO_STAGES ? SOLO_STAGES : stages;
  } else {
    return p;
  }
  p.boxes = boxes;
  p.cluster = cluster;
  p.tiles = (N + boxes * BOX - 1) / (boxes * BOX);
  p.kboxes = kboxes;
  p.stages = stages;
  p.smem = smem_bytes(mpad, boxes, kboxes, stages);
  return p;
}

// The column tile (boxes) and cluster size with the least time by this
// count: each wave of clusters (as many as run at once, one or two CTAs
// an SM) costs WAVE_BOXES (its launch, prologue and reduction, in boxes
// streamed meanwhile) plus the boxes its busiest CTA streams, boxes x k
// boxes. Ties go to the smaller cluster (a shorter DSMEM reduction), then
// the narrower tile. No rank of a cluster is left without k boxes.
// `boxes` / `cluster` other than 0 pin that knob (the tuning layer's race):
// the search then runs over the other alone, and finds nothing ({0, ...})
// when the pinned value cannot run.
template <bool NORM, int EPI>
Plan search(int M, int N, int K, int boxes = 0, int cluster = 0) {
  Plan best = {0, 0, 0, 0, 0, 0, 0};
  if (!takes(M, N, K)) return best;
  const int sms = hopper::sm_count();
  const auto act = active_clusters<NORM, EPI>();
  const int kbox = (K + BOX_K - 1) / BOX_K;
  long best_cost = -1;
  for (int c = 1; c <= MAX_CLUSTER; ++c) {
    if (cluster != 0 && c != cluster) continue;
    const int kbc = (kbox + c - 1) / c;
    if ((c - 1) * kbc >= kbox) continue;
    for (int b = 1; b <= MAX_BOXES; ++b) {
      if (boxes != 0 && b != boxes) continue;
      const Plan p = fit(M, N, K, b, c, kbc);
      if (p.boxes == 0) break;
      const int slots = p.per_sm * sms / c, avail = act[p.per_sm - 1][c];
      const int wave = avail < slots ? avail : slots;
      if (wave <= 0) continue;
      const long cost =
          (long)((p.tiles + wave - 1) / wave) * (WAVE_BOXES + b * kbc);
      if (best_cost < 0 || cost < best_cost) {
        best_cost = cost;
        best = p;
      }
    }
  }
  return best;
}

// `search`'s plan, kept for each shape (a decode step asks for the same few
// shapes every call; the launch's host time is part of an eager step's). A
// pinned plan (`boxes` or `cluster` not 0) is searched each call and kept
// nowhere.
template <bool NORM, int EPI>
Plan plan(int M, int N, int K, int boxes = 0, int cluster = 0) {
  if (boxes != 0 || cluster != 0)
    return search<NORM, EPI>(M, N, K, boxes, cluster);
  return hopper::per_shape(M, N, K, [](int m, int n, int k) {
    return search<NORM, EPI>(m, n, k);
  });
}

// out = epilogue<EPI>(prologue<NORM>(x) @ w) in one launch on `st`; the
// caller has checked `takes`. A pinned plan the kernel cannot take is
// refused, never replaced by the searched one.
template <bool NORM, int EPI>
int launch(const void* x, const void* scale, const void* w, const void* extra,
           void* out, int M, int N, int K, float eps, cudaStream_t st,
           int boxes = 0, int cluster = 0) {
  const Plan p = plan<NORM, EPI>(M, N, K, boxes, cluster);
  if (p.boxes == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap map_w;
  cudaError_t err = hopper::encode(&map_w, w, K, N, BOX_K);
  if (err != cudaSuccess) return (int)err;
  auto kernel = tma_gemv_kernel<NORM, EPI>;
  static std::atomic<int> allowed{0};         // the most asked for so far
  if ((int)p.smem > allowed.load()) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)p.smem);
    if (err != cudaSuccess) return (int)err;
    int cur = allowed.load();
    while ((int)p.smem > cur &&
           !allowed.compare_exchange_weak(cur, (int)p.smem)) {
    }
  }
  const Args args = {(const bf16*)x, (const bf16*)scale, (const bf16*)extra,
                     (bf16*)out, M, N, K, p.boxes, p.kboxes, p.stages, eps};
  return (int)hopper::launch_ex(kernel, dim3(p.tiles * p.cluster), THREADS,
                                p.smem, p.cluster, st, map_w, args);
}

// The plan as {N tile, cluster size, CTAs, k rows a CTA, ring stages} in
// `out`, for reports (each wrapper exports it as `<wrapper>_decode_plan`).
template <bool NORM, int EPI>
int report(int M, int N, int K, int boxes, int cluster, int* out) {
  const Plan p = plan<NORM, EPI>(M, N, K, boxes, cluster);
  if (p.boxes == 0) return (int)cudaErrorInvalidValue;
  out[0] = p.boxes * BOX;
  out[1] = p.cluster;
  out[2] = p.tiles * p.cluster;
  out[3] = p.kboxes * BOX_K;
  out[4] = p.stages;
  return 0;
}
}  // namespace decode

// f32 workspace (in floats) of an (M, K) x (K, N) product at M <= 16: none
// on the decode kernel, the split-K partials on common.cuh's skinny path.
inline size_t decode_workspace_floats(int M, int N, int K) {
  if (decode::takes(M, N, K)) return 0;
  return split_k_workspace_floats(M, N, K);
}

// The products of the four GEMM wrappers outside the Hopper mainloop: M <=
// 16 with K, N % 8 == 0 and K <= 32768 on the decode kernel above; any
// other M <= 16 on common.cuh's split-K path (partials in `workspace`,
// then its finish); the rest (M > 16, K or N % 8 != 0) on the 64 x 128
// wmma tile. `boxes` / `cluster` pin the decode kernel's plan; the other
// paths have no plan to pin and refuse a pin.
template <bool NORM, int EPI>
int launch_matmul(const void* a, const void* scale, const void* b,
                  const void* extra, void* out, float* workspace, int M, int N,
                  int K, float eps, void* stream, int boxes = 0,
                  int cluster = 0) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (decode::takes(M, N, K))
    return decode::launch<NORM, EPI>(a, scale, b, extra, out, M, N, K, eps,
                                     st, boxes, cluster);
  if (boxes != 0 || cluster != 0) return (int)cudaErrorInvalidValue;
  if (M <= skinny::MAX_M) {
    if (workspace == nullptr) return (int)cudaErrorInvalidValue;
    int splits, kps;
    skinny::plan(M, N, K, &splits, &kps);
    const size_t smem = skinny::smem_bytes(kps);
    cudaError_t err = cudaFuncSetAttribute(
        skinny::partial_kernel<NORM, EPI>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((N + skinny::COLS - 1) / skinny::COLS, splits,
                    (M + skinny::MR - 1) / skinny::MR);
    skinny::partial_kernel<NORM, EPI><<<grid, skinny::THREADS, smem, st>>>(
        (const bf16*)a, (const bf16*)scale, (const bf16*)b, workspace, M, N,
        K, kps, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t mn = (size_t)M * N;
    skinny::finish_kernel<EPI><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(
        workspace, (const bf16*)extra, (bf16*)out, M, N, splits);
    return (int)cudaGetLastError();
  }
  const dim3 grid((M + gemm::BM - 1) / gemm::BM, (N + gemm::BN - 1) / gemm::BN);
  gemm::tile_kernel<NORM, EPI><<<grid, gemm::THREADS, 0, st>>>(
      (const bf16*)a, (const bf16*)scale, (const bf16*)b, (const bf16*)extra,
      (bf16*)out, M, N, K, eps);
  return (int)cudaGetLastError();
}
