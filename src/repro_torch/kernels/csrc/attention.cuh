// The attention core that flash_attention.cu and flash_attention_proj.cu
// share: one block, BQ = 128 query rows of one (batch, head), against all
// the keys it needs, written to device memory as bf16.
//
// Replaces the attention of the Pallas kernels
// `repro/kernels/flash_attention.py` _fa_kernel and
// `repro/kernels/fused.py` _fa_proj_kernel. Numerics follow them: scores
// q.k in f32 times the scale, masked with -1e30; online softmax with m, l
// and the accumulator in f32; p rounded to bf16 (v's dtype) before p @ v
// while l sums the unrounded p; the output acc / max(l, 1e-30), rounded
// once. (The exponentials are taken as exp2 of the scores times
// scale * log2(e): the same function, rounded in another place.)
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s): qwen3-14b's prefill at
// B=1, H=40, KV=8, S=512, hd=128 reads q, k and v once and writes the
// output once, 12.6 MB (3.8 us), and does 2.7 GFLOP of causal attention
// (2.7 us); full attention is 5.4 GFLOP (5.4 us). Short of the bound, what
// costs is latency: each block walks its key tiles one after another.
//
// Design (a block of 384 threads, one a block an SM):
//   * warpgroup 0 is the producer: one thread brings the block's Q (128
//     rows) in by TMA, then keeps the K and V tiles of BKV = 64 keys in
//     flight into a ring of STAGES stages, each with a `full` mbarrier for
//     K, one for V (so Q.K^T starts before V lands) and an `empty` one
//     released by both consumers. The tensor maps are 3-D, (hd, S, batch *
//     heads), so a box never reads past its head's last row: TMA fills
//     rows past S with zeros.
//   * warpgroups 1 and 2 are the consumers, 64 query rows each. The scores
//     S = Q K^T are one wgmma m64n64k16 per 16 of hd, Q and K from shared
//     memory, both K-major (hd contiguous; K is B = K^T without the
//     transpose bit). The online softmax runs on the S fragment in
//     registers: a row's 64 scores sit in the four lanes of a quad, so its
//     max is two shuffles; l stays a per-lane partial until the end. p is
//     rounded to bf16 in registers, whose pairs are wgmma's register A
//     fragment for each 16 keys as they stand, and O += P V is one wgmma
//     m64nHDk16 per 16 keys, V from shared memory MN-major (the transpose
//     bit, the layout of the mainloop's B). O (HD/2 floats a thread) and S
//     (32) never leave registers.
//   * each tile overlaps the tensor cores with the softmax: the scores of
//     tile j+1 are issued before tile j's P V, and tile j+1's softmax runs
//     while P V of tile j is in flight (wgmma.wait_group 1); a stage is
//     released once the P V that read it has retired.
//   * causal: key tiles wholly past the block's last row are never loaded;
//     only the tiles a warp's rows cross (and the ragged last tile) are
//     masked. Blocks run the longest causal rows first (blockIdx.y counts
//     the query tiles down), so the short ones fill the last wave.
//   * the epilogue divides by max(l, 1e-30) and stores 16 bytes a lane
//     (`hopper::store_rows`), rows past S skipped, `ld` elements a row.
// Grid: (B * H, ceil(S / 128)), one block an SM (the consumers take 232
// registers). qwen3-14b's prefill (H 40, S 512) is 160 blocks; whisper's
// H 12 at S 1000, 96.
#pragma once

#include "wgmma_gemm.cuh"

namespace attn {
using hopper::fence_acc;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::sw128_desc;
using hopper::tma_load;
using hopper::wg_commit;
using hopper::wg_fence;
using hopper::wg_wait;

constexpr int BQ = 128, BKV = 64, STAGES = 4, THREADS = 384;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Layout {
  static_assert(HD == 64 || HD == 128, "the head sizes compiled");
  static constexpr int BOXES = HD / 64;          // 128-byte boxes a row
  static constexpr int Q_BOX = BQ * 128;         // 16 KB
  static constexpr int KV_BOX = BKV * 128;       // 8 KB
  static constexpr int Q_BYTES = BOXES * Q_BOX;
  static constexpr int TILE_BYTES = BOXES * KV_BOX;    // one K or V tile
  static constexpr int SMEM = Q_BYTES + STAGES * 2 * TILE_BYTES + 1024;
};

// The tensor maps of q (B*H slabs of (S, HD)), k and v (B*KV slabs).
struct Maps {
  CUtensorMap q, k, v;
};

// d (64 x 64, f32) = [d +] a (64 x 16) @ b (16 x 64): both operands by
// descriptor, K-major (no transpose); `accumulate` 0 overwrites d.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += a (64 x 16, bf16 pairs in registers, the m64k16
// A fragment) @ b (16 x 64, MN-major by descriptor: the transpose bit).
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                          const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, f32) += a (64 x 16, bf16 pairs in registers, the m64k16
// A fragment) @ b (16 x 128, MN-major by descriptor: the transpose bit).
__device__ __forceinline__ void mma_rs_n128(float (&d)[64],
                                          const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// s (64 x 64) = Q (this warpgroup's 64 rows) @ K^T of one tile, issued and
// committed, not waited for.
template <int HD>
__device__ __forceinline__ void scores(float (&s)[32], uint32_t q_addr,
                                       uint32_t k_addr) {
  using L = Layout<HD>;
  fence_acc(s);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)   // k16 slices: +32 bytes in a box
    mma_ss_n64(s,
               sw128_desc(q_addr + (kk / 4) * L::Q_BOX + (kk % 4) * 32, 16,
                          1024),
               sw128_desc(k_addr + (kk / 4) * L::KV_BOX + (kk % 4) * 32, 16,
                          1024),
               kk > 0);
  wg_commit();
}

// o (64 x HD) += p (64 x 64 keys, registers) @ V of one tile, issued and
// committed, not waited for.
template <int HD>
__device__ __forceinline__ void pv(float (&o)[HD / 2],
                                   const uint32_t (&p)[BKV / 16][4],
                                   uint32_t v_addr) {
  fence_acc(o);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {  // 16 keys: +16 rows of 128 bytes
    const uint64_t b = sw128_desc(v_addr + kk * 2048, Layout<HD>::KV_BOX,
                                  1024);
    if constexpr (HD == 64)
      mma_rs_n64(o, p[kk], b);
    else
      mma_rs_n128(o, p[kk], b);
  }
  wg_commit();
}

template <int HD>
__device__ __forceinline__ void rescale(float (&o)[HD / 2],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i / 2) % 2];
}

// The online softmax of one tile on the S fragment (rows row0 and row0 + 8,
// for each 8-key group g keys k0 + 8g + 2(lane%4) + e): s becomes p =
// exp(score - m) in f32, m and the lane's partial l move on, alpha is the
// factor for O. `edge`: the tile holds keys that some of these rows must
// not see (past S, or past a row when causal).
__device__ __forceinline__ void softmax(float (&s)[32], int k0, int row0,
                                        int S, int causal, bool edge,
                                        float scale2, float (&m)[2],
                                        float (&l)[2], float (&alpha)[2]) {
  const int c0 = k0 + 2 * (threadIdx.x % 4);
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int g = 0; g < 8; ++g)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = s[4 * g + 2 * h + e] * scale2;
        const int key = c0 + 8 * g + e;
        if (edge && (key >= S || (causal && key > row0 + 8 * h))) v = NEG;
        s[4 * g + 2 * h + e] = v;
        mx[h] = fmaxf(mx[h], v);
      }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    alpha[h] = exp2f(m[h] - m_new);
    m[h] = m_new;
  }
#pragma unroll
  for (int g = 0; g < 8; ++g)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = exp2f(s[4 * g + 2 * h + e] - m[h]);
        s[4 * g + 2 * h + e] = p;
        sum[h] += p;
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
}

// Query rows q0 .. q0 + BQ of q slab `qs` against kv slab `kvs`; output
// row r goes to oh + r * ld. Run by all THREADS threads of the block on
// Layout<HD>::SMEM bytes of dynamic shared memory; q0 is the block's.
template <int HD>
__device__ __forceinline__ void attend(const Maps& maps, int qs, int kvs,
                                       bf16* __restrict__ oh, size_t ld,
                                       int S, int q0, int causal,
                                       float scale) {
  using L = Layout<HD>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, k_full[STAGES], v_full[STAGES],
      empty[STAGES];
  // the 128-byte swizzle repeats every 1 KB: tiles start on 1 KB
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem + L::Q_BYTES;   // stage s: K, then V

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int tiles = (kv_end + BKV - 1) / BKV;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 2);               // one release a consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {                               // producer
    hopper::reg_dealloc<40>();
    if (t == 0) {
      hopper::prefetch_map(&maps.q);
      hopper::prefetch_map(&maps.k);
      hopper::prefetch_map(&maps.v);
      mbar_expect_tx(&q_full, L::Q_BYTES);
#pragma unroll
      for (int j = 0; j < L::BOXES; ++j)
        tma_load(smem + j * L::Q_BOX, &maps.q, &q_full, 64 * j, q0, qs);
      for (int it = 0; it < tiles; ++it) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        unsigned char* st = ring + s * 2 * L::TILE_BYTES;
        mbar_expect_tx(&k_full[s], L::TILE_BYTES);
#pragma unroll
        for (int j = 0; j < L::BOXES; ++j)
          tma_load(st + j * L::KV_BOX, &maps.k, &k_full[s], 64 * j,
                   it * BKV, kvs);
        mbar_expect_tx(&v_full[s], L::TILE_BYTES);
#pragma unroll
        for (int j = 0; j < L::BOXES; ++j)
          tma_load(st + L::TILE_BYTES + j * L::KV_BOX, &maps.v, &v_full[s],
                   64 * j, it * BKV, kvs);
      }
    }
  } else {                                     // consumers
    hopper::reg_alloc<232>();
    const int w = wg - 1, warp = t / 32, lane = t % 32;
    const int qw = q0 + 64 * w + 16 * warp;    // the warp's first row
    const int row0 = qw + lane / 4;            // this lane's: row0, row0 + 8
    const float scale2 = scale * LOG2E;
    const uint32_t q_addr = smem_u32(smem) + w * 64 * 128;
    const uint32_t ring_addr = smem_u32(ring);
    float o[HD / 2], s[32];
    uint32_t p[BKV / 16][4];
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;

    mbar_wait(&q_full, 0);
    mbar_wait(&k_full[0], 0);
    scores<HD>(s, q_addr, ring_addr);
    wg_wait<0>();
    fence_acc(s);
    // Tile it: its softmax, then (unless it is the last) tile it+1's
    // scores issued before its P V. The last tile leaves the loop by its
    // own path, so that on every path the scores have retired before the
    // softmax reads them (no wgmma is serialized).
    for (int it = 0;; ++it) {
      const int st = it % STAGES, k0 = it * BKV;
      const bool edge = k0 + BKV > S || (causal && k0 + BKV - 1 > qw);
      float alpha[2];
      softmax(s, k0, row0, S, causal, edge, scale2, m, l, alpha);
      wg_wait<0>();                            // P V of tile it-1 retired
      fence_acc(o);
      fence_acc(s);
      if (it > 0 && t == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)    // the register A fragments
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
      const uint32_t v_addr = ring_addr + st * 2 * L::TILE_BYTES +
                              L::TILE_BYTES;
      if (it + 1 == tiles) {
        rescale<HD>(o, alpha);
        mbar_wait(&v_full[st], (it / STAGES) & 1);
        pv<HD>(o, p, v_addr);
        break;
      }
      const int sn = (it + 1) % STAGES;        // tile it+1's scores, now
      mbar_wait(&k_full[sn], ((it + 1) / STAGES) & 1);
      scores<HD>(s, q_addr, ring_addr + sn * 2 * L::TILE_BYTES);
      rescale<HD>(o, alpha);
      mbar_wait(&v_full[st], (it / STAGES) & 1);
      pv<HD>(o, p, v_addr);
      wg_wait<1>();                            // the scores have retired
      fence_acc(s);
    }
    wg_wait<0>();
    fence_acc(o);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      l[h] = fmaxf(l[h], 1e-30f);
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = o[i] / l[(i / 2) % 2];
    hopper::store_rows<HD, EPI_NONE>(o, nullptr, oh, row0, 0, S, HD, lane,
                                     ld);
  }
}

// Host side: the three tensor maps of one call (q (B, H, S, HD), k and v
// (B, KV, S, HD), contiguous), the grid and the launch's shared memory.
template <int HD>
inline cudaError_t encode_maps(Maps* maps, const void* q, const void* k,
                               const void* v, int B, int H, int KV, int S) {
  cudaError_t err = hopper::encode(&maps->q, q, S, HD, BQ, B * H);
  if (err == cudaSuccess) err = hopper::encode(&maps->k, k, S, HD, BKV, B * KV);
  if (err == cudaSuccess) err = hopper::encode(&maps->v, v, S, HD, BKV, B * KV);
  return err;
}

inline dim3 grid(int B, int H, int S) {
  return dim3(B * H, (S + BQ - 1) / BQ);
}

// The block's first query row: blockIdx.y counts the query tiles down, so
// that the longest causal rows are dispatched first.
__device__ __forceinline__ int first_row() {
  return (gridDim.y - 1 - blockIdx.y) * BQ;
}
}  // namespace attn
