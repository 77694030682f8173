// matmul in f32 on Hopper's tensor cores: out (M,N) = a (M,K) @ b (K,N),
// f32 in and out, row-major, as three TF32 products (3xTF32).
//
// It is the f32 product of the Pallas kernel `repro/kernels/matmul.py`
// _matmul_kernel (the paper's Table 1 `matmul`, which the Table 1 bench
// runs at 256 x 256 x 256 in f32), for K % 4 == 0 and N % 4 == 0; other f32
// shapes stay on matmul.cu's CUDA-core tile (`sgemm::matmul_f32_kernel`).
//
// The arithmetic. Each f32 operand x is split into hi = tf32(x) and lo =
// tf32(x - hi), both rounded to nearest, ties away (cvt.rna.tf32.f32), so
// that x = hi + lo + e with |e| <= 2^-22 |x| (`split`: how inf, NaN and
// values next to FLT_MAX are split). a.b is taken as hi_a.hi_b +
// hi_a.lo_b + lo_a.hi_b, three TF32 products on the tensor cores; what is
// dropped (lo_a.lo_b and the e terms) is at most about 3 * 2^-22 of each
// |a.b|. One TF32 product alone would keep only 2^-11. The tensor cores'
// own f32 accumulation rounds each sum toward zero, and over a long K that
// error grows with the sum (at 4096^3 a single accumulator was several
// times further from an f64 product than an f32 product is), so each
// stage's 12 products (32 k) go into a fresh accumulator that is then
// added into the tile's sum with f32 adds: the sum is as close to an f64
// product as an f32 product's (chip_smoke's suite rows print both).
//
// Bound on an H100: 3 * 2MNK operations at 495 TFLOP/s dense TF32 (4096^3:
// 0.833 ms, against 2.05 ms for f32 on the CUDA cores), above the bytes of
// its operands and of the split's workspace.
//
// Shape of the work:
//   * `split_kernel` writes b's hi and lo parts transposed, as two (N, K)
//     matrices end to end in the wrapper's workspace (2NK floats): wgmma
//     reads a .tf32 operand from shared memory only K-major, and b (K, N)
//     row-major is not.
//   * `gemm_kernel<BN>`: a block of 384 threads owns a 128 x BN output
//     tile. Warpgroup 0 is the producer: one thread keeps TMA loads of a's
//     128 x 32 box and the two BN x 32 boxes of b's parts (128-byte
//     swizzle, zeros past every edge) in flight through a ring of stages on
//     `full` / `empty` mbarriers. Warpgroups 1 and 2 are the consumers, one
//     64-row half each: they read their rows of a's box from shared memory
//     into registers, split them there, and issue, for each k8 slice,
//     wgmma.mma_async m64nBNk8 .tf32 three times (lo_a.hi_b, hi_a.lo_b,
//     hi_a.hi_b) with a from registers and b by descriptor; while those
//     run they read and split the next stage's a into a second set of
//     registers; the stage's sum (BN/2 floats a thread) is then added into
//     the tile's, also in registers.
//   * `fused_kernel<BN>` is the same product for M <= 256, where few row
//     tiles share each column of b: the producer loads b's own 32 x 32
//     boxes, and the consumers split each stage's b into its K-major parts
//     in shared memory themselves (then a proxy fence and a barrier of the
//     256 consumer threads), so that a call is one launch: at the paper's
//     256^3 a second kernel's launch is a large share of the call.
//   * Tiles: up to one wave, one block a tile; past it, persistent, one
//     block an SM walking tiles in bands (`hopper::tile_origin`).
//   * Small outputs (the paper's 256^3 is 8 tiles of 128 x 64 on 132 SMs)
//     split K inside a thread-block cluster of C <= 8 blocks: rank r walks
//     k blocks [r * kper, (r + 1) * kper). After the k loop each block
//     pushes its f32 partial tile through distributed shared memory
//     (st.async) to the blocks that reduce it (column group v to rank v %
//     C); each sums its groups' C partials in rank order and stores them.
//     No atomics: two runs give the same bits.
//   * `plan` picks the N tile and the cluster size from the shape: the
//     least waves x (tile columns x k blocks a block + a fixed cost a tile),
//     plus the exchange's cost when C > 1.
//   * Every kernel is launched with programmatic dependent launch: each
//     lets the next kernel on the stream begin its launch early, and waits
//     (griddepcontrol.wait) for the one before it to finish before it
//     reads anything the kernel before may have written: the split pass
//     before it reads b or writes the workspace, a product's producer
//     before its first load.
// The output is stored from registers (8 bytes a lane, masked at the
// edges) or, with C > 1, from the reduction (16 bytes a lane).
#pragma once

#include "wgmma_gemm.cuh"

namespace tf32x3 {
constexpr int BM = hopper::BM;               // 128: two 64-row consumers
constexpr int BK = 32;                       // f32 in a 128-byte box row
constexpr int THREADS = hopper::THREADS;     // 384
constexpr int A_BYTES = BM * BK * 4;         // 16 KB
constexpr int MAX_STAGES = 6;
constexpr int MAX_CLUSTER = hopper::MAX_CLUSTER;   // 8
constexpr int SMEM_CAP = hopper::SMEM_CAP;
// N tiles: a consumer holds two accumulators of BN/2 floats and the
// stage's 32 split registers of a, which leaves no room past 128
constexpr int TILE_N[] = {64, 128};
// the plan's cost model, in units of one k block (32 k) of one tile column
constexpr int TILE_FIXED = 300;              // a tile's fixed time (~2 us)
constexpr int REDUCE_FIXED = 150;            // the cluster's exchange (~1 us)

// What the kernel takes: TMA's global strides (K floats for a and for the
// split b) are multiples of 16 bytes; the split pass reads b by rows of N.
inline bool takes(int N, int K) { return N % 4 == 0 && K % 4 == 0; }

struct Args {
  float* out;           // (M, N)
  int M, N, K;
  int kper;             // k blocks a rank of a cluster walks
  int stages;           // ring stages
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x as hi + lo, both TF32: hi = tf32(x), lo = tf32(x - hi). Two edges keep
// the three products' sum what an f32 product gives:
//   * a finite x within half a TF32 ulp of FLT_MAX, which rounds to inf,
//     takes hi = x truncated to TF32 instead (finite; lo = tf32(x - hi));
//   * a non-finite x (inf, NaN) is hi = +-1 (x's sign), lo = x. x then
//     meets only the other operand's hi (lo_a.hi_b, hi_a.lo_b), which is 0
//     only where that operand is 0 (as inf * 0 is NaN in f32) or below
//     2^-137 in magnitude (an f32 subnormal that TF32 rounds to 0, where
//     f32 gives inf and this gives NaN); never its lo, which is 0 for
//     every value TF32 holds exactly. The +-1 keeps the other products
//     finite and gives inf * inf its sign.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  if ((hi & 0x7f800000u) != 0x7f800000u) {    // the common case
    lo = tf32_rna(x - __uint_as_float(hi));
    return;
  }
  const uint32_t bits = __float_as_uint(x);
  if ((bits & 0x7f800000u) != 0x7f800000u) {  // finite: rounded past FLT_MAX
    hi = bits & 0xffffe000u;
    lo = tf32_rna(x - __uint_as_float(hi));
  } else {
    hi = (bits & 0x80000000u) | 0x3f800000u;
    lo = bits;
  }
}

// `split`'s common case, for a run of values: hi = tf32(x), lo = tf32(x -
// hi), and `edge` made NaN (0 * inf, 0 * NaN) where hi came out inf or
// NaN, so that one test after the run tells whether any value of it needs
// `split` (one FMA a value, where a test of each would hold up the run).
__device__ __forceinline__ void split_common(float x, uint32_t& hi,
                                             uint32_t& lo, float& edge) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
  edge = fmaf(0.f, __uint_as_float(hi), edge);
}

// ---------------------------------------------------------------------------
// The split pass: bt (2, N, K) = (hi, lo) of b (K, N), transposed
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
split_kernel(const float* __restrict__ b, float* __restrict__ bt, int K,
             int N) {
  __shared__ float tile[32][33];
  // b may be the kernel before's output, and the workspace what it reads
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const int k = k0 + i, n = n0 + tx;
    tile[i][tx] = (k < K && n < N) ? __ldg(b + (size_t)k * N + n) : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const int n = n0 + i, k = k0 + tx;
    if (n < N && k < K) {
      uint32_t hi, lo;
      split(tile[tx][i], hi, lo);
      bt[(size_t)n * K + k] = __uint_as_float(hi);
      bt[((size_t)N + n) * K + k] = __uint_as_float(lo);
    }
  }
}

// ---------------------------------------------------------------------------
// The product
// ---------------------------------------------------------------------------

// d (64 x BN, f32, the m64nBNk8 register layout) += a (64 x 8, tf32, from
// registers: lane l of warp w holds rows 16w + l/4 (+8), k l%4 (+4)) @ b
// (8 x BN, K-major, by descriptor); scale_d 0 overwrites d.
template <int BN>
struct Mma;

template <>
struct Mma<64> {
  __device__ static __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<128> {
  __device__ static __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        "%60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// One stage's products into d, issued and committed, not waited for: for
// each k8 slice, lo_a.hi_b (overwriting d at the first), hi_a.lo_b,
// hi_a.hi_b; b's parts at b_hi and b_hi + BN * 128 bytes, K-major,
// 128-byte swizzled: a k8 slice is 32 bytes along each row.
template <int BN>
__device__ __forceinline__ void products(float (&d)[BN / 2],
                                         const uint32_t (&hi)[BK / 8][4],
                                         const uint32_t (&lo)[BK / 8][4],
                                         uint32_t b_hi) {
  const uint32_t b_lo = b_hi + BN * BK * 4;
  hopper::fence_acc(d);
  hopper::wg_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    Mma<BN>::run(d, lo[kk], hopper::sw128_desc(b_hi + kk * 32, 16, 1024),
                 kk == 0 ? 0 : 1);
    Mma<BN>::run(d, hi[kk], hopper::sw128_desc(b_lo + kk * 32, 16, 1024), 1);
    Mma<BN>::run(d, hi[kk], hopper::sw128_desc(b_hi + kk * 32, 16, 1024), 1);
  }
  hopper::wg_commit();
  hopper::fence_acc(d);
}

// The consumer's rows of a's box in a stage, split: a's box row r holds k
// 0..31 as eight 16-byte chunks, chunk c at c ^ (r % 8) (the 128-byte
// swizzle), and r % 8 == g for all four registers of a k8 slice: a0 (r0, k
// 8kk + q), a1 (r0 + 8, same), a2 (r0, +4), a3 (r0 + 8, +4).
__device__ __forceinline__ void split_a(const unsigned char* a, int r0, int g,
                                        int q, uint32_t (&hi)[BK / 8][4],
                                        uint32_t (&lo)[BK / 8][4]) {
  auto x = [&](int kk, int i) {
    const int row = r0 + (i & 1) * 8, chunk = 2 * kk + (i >> 1);
    return *reinterpret_cast<const float*>(a + row * 128 +
                                           ((chunk ^ g) << 4) + q * 4);
  };
  float edge = 0.f;
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_common(x(kk, i), hi[kk][i], lo[kk][i], edge);
  // an inf, a NaN, or a value next to FLT_MAX: split them again
  if (edge != edge) {
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) split(x(kk, i), hi[kk][i], lo[kk][i]);
  }
}

// b's stage as TMA loaded it for the fused product (BN/32 boxes of 32 k
// rows x 32 columns, 128-byte swizzled, 4 KB apart) into its hi and lo
// parts, K-major (row n of b_hi holds k 0..31, chunk c at c ^ (n % 8)):
// the 256 consumer threads take a column n and four k each, consecutive
// threads consecutive columns, 16 bytes a store; then every consumer
// thread orders its stores before the tensor cores' reads (the async
// proxy) and waits for the others.
template <int BN, bool EDGES>
__device__ __forceinline__ void split_b_pass(const unsigned char* raw,
                                            unsigned char* b_hi, int ct,
                                            float& edge) {
  unsigned char* b_lo = b_hi + BN * BK * 4;
#pragma unroll
  for (int i = ct; i < BN * (BK / 4); i += 256) {
    const int n = i % BN, kq = i / BN;
    const unsigned char* col =
        raw + (n / 32) * 4096 + (n & 3) * 4;
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * kq + e;
      const float x = *reinterpret_cast<const float*>(
          col + k * 128 + ((((n % 32) / 4) ^ (k & 7)) << 4));
      if (EDGES)
        split(x, h[e], l[e]);
      else
        split_common(x, h[e], l[e], edge);
    }
    const int off = n * 128 + ((kq ^ (n & 7)) << 4);
    *reinterpret_cast<uint4*>(b_hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(b_lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

template <int BN>
__device__ __forceinline__ void split_b(const unsigned char* raw,
                                       unsigned char* b_hi, int ct) {
  float edge = 0.f;
  split_b_pass<BN, false>(raw, b_hi, ct, edge);
  // an inf, a NaN, or next to FLT_MAX: this thread's values split again
  if (edge != edge) split_b_pass<BN, true>(raw, b_hi, ct, edge);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

template <int BN, bool SPLIT>
struct Tile {
  static constexpr int B_BYTES = BN * BK * 4;          // one part of b
  // a, b's parts, and with SPLIT b's stage as loaded
  static constexpr int STAGE_BYTES = A_BYTES + (SPLIT ? 3 : 2) * B_BYTES;
  static constexpr int LOAD_BYTES = A_BYTES + (SPLIT ? 1 : 2) * B_BYTES;
  static constexpr int GROUPS = BN / 8;                // 8-column groups
};

// The partials a block receives with C > 1: [sender rank][local group
// (at most ceil(GROUPS / C))][128 rows][8 columns] floats.
inline size_t recv_bytes(int bn, int cluster) {
  if (cluster <= 1) return 0;
  const int lg = (bn / 8 + cluster - 1) / cluster;
  return (size_t)cluster * lg * BM * 8 * 4;
}

// The product's block, on b's parts from the split pass (map_b: the
// workspace, 3-D) or, with SPLIT, splitting b's tiles itself (map_b: b).
// Shared memory: 1 KB to align the ring (the swizzle's period), the ring,
// then the partials.
template <int BN, bool SPLIT>
__device__ __forceinline__ void product(const CUtensorMap* map_a,
                                        const CUtensorMap* map_b,
                                        const Args& args) {
  using hopper::mbar_arrive;
  using hopper::mbar_expect_tx;
  using hopper::mbar_init;
  using hopper::mbar_wait;
  using hopper::smem_u32;
  using T = Tile<BN, SPLIT>;
  constexpr int R = BN / 2;                   // accumulator floats a thread
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  __shared__ __align__(8) uint64_t recv_bar;
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int S = args.stages;
  float* recv = reinterpret_cast<float*>(ring + (size_t)S * T::STAGE_BYTES);

  const int M = args.M, N = args.N, K = args.K;
  const int C = (int)hopper::cluster_size(), rank = (int)hopper::cluster_rank();
  const int mt = (M + BM - 1) / BM, nt = (N + BN - 1) / BN;
  const int tiles = mt * nt;
  const int kb0 = rank * args.kper;
  const int kb1 = min((K + BK - 1) / BK, kb0 + args.kper);
  // a cluster walks tiles cluster_id, cluster_id + clusters, ...; with C > 1
  // the plan launches one cluster a tile
  const int first = (int)hopper::cluster_id(), step = gridDim.x / C;
  const int lgroups = (T::GROUPS + C - 1) / C;
  const int owned = rank < T::GROUPS ? (T::GROUPS - rank + C - 1) / C : 0;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);                 // the producer's expect_tx
      mbar_init(&empty[s], 2);                // one release a consumer
    }
    mbar_init(&recv_bar, 1);
    if (C > 1) mbar_expect_tx(&recv_bar, (uint32_t)(C * owned * BM * 8 * 4));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (C > 1) hopper::cluster_arrive();        // the mbarriers are ready
  // the next kernel on the stream may begin its launch (it waits for this
  // grid before it touches memory)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if (wg == 0) {                              // producer
    hopper::reg_dealloc<40>();
    if (t == 0) {
      hopper::prefetch_map(map_a);
      hopper::prefetch_map(map_b);
      // a and b may be the kernel before's output (b's parts are the split
      // pass's)
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      int it = 0;
      for (int tile = first; tile < tiles; tile += step) {
        int m0, n0;
        hopper::tile_origin<BN>(tile, mt, nt, m0, n0);
        for (int kb = kb0; kb < kb1; ++kb, ++it) {
          const int s = it % S;
          mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          unsigned char* st = ring + (size_t)s * T::STAGE_BYTES;
          mbar_expect_tx(&full[s], T::LOAD_BYTES);
          hopper::tma_load(st, map_a, &full[s], kb * BK, m0);
          if (SPLIT) {                        // b's boxes of 32 columns
#pragma unroll
            for (int j = 0; j < BN / 32; ++j)
              hopper::tma_load(st + A_BYTES + 2 * T::B_BYTES + j * 4096,
                               map_b, &full[s], n0 + 32 * j, kb * BK);
          } else {                            // hi, lo
            hopper::tma_load(st + A_BYTES, map_b, &full[s], kb * BK, n0, 0);
            hopper::tma_load(st + A_BYTES + T::B_BYTES, map_b, &full[s],
                             kb * BK, n0, 1);
          }
        }
      }
    }
    return;
  }

  hopper::reg_alloc<232>();                   // consumers
  const int cw = wg - 1, warp = t / 32, lane = t % 32;
  const int g = lane / 4, q = lane % 4;
  const int r0 = cw * 64 + warp * 16 + g;     // tile row of a0 (and d's)
  const int ct = threadIdx.x - 128;           // 0..255
  float acc[R], part[R];                      // the tile's sum, a stage's
  // a stage: its operands ready (SPLIT: b split), this consumer's a split
  auto prepare = [&](int it, uint32_t(&hi)[BK / 8][4],
                     uint32_t(&lo)[BK / 8][4]) {
    const int s = it % S;
    mbar_wait(&full[s], (it / S) & 1);
    unsigned char* st = ring + (size_t)s * T::STAGE_BYTES;
    if (SPLIT) split_b<BN>(st + A_BYTES + 2 * T::B_BYTES, st + A_BYTES, ct);
    split_a(st, r0, g, q, hi, lo);
  };
  int it = 0;
  for (int tile = first; tile < tiles; tile += step) {
    int m0, n0;
    hopper::tile_origin<BN>(tile, mt, nt, m0, n0);
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
    uint32_t hi[BK / 8][4], lo[BK / 8][4];
    if (kb0 < kb1) prepare(it, hi, lo);
    for (int kb = kb0; kb < kb1; ++kb, ++it) {
      const int s = it % S;
      products<BN>(part, hi, lo, smem_u32(ring + (size_t)s * T::STAGE_BYTES +
                                          A_BYTES));
      // while the tensor cores run, the next stage of the tile (its
      // registers are others than those the products read)
      uint32_t nhi[BK / 8][4], nlo[BK / 8][4];
      if (kb + 1 < kb1) prepare(it + 1, nhi, nlo);
      hopper::wg_wait<0>();
      hopper::fence_acc(part);
      if (t == 0) mbar_arrive(&empty[s]);     // its products have retired
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] += part[i];
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          hi[kk][i] = nhi[kk][i];
          lo[kk][i] = nlo[kk][i];
        }
    }

    // d's layout: of each 8-column group j, lane (g, q) holds columns 8j +
    // 2q (+1) of rows r0 (acc[4j], acc[4j + 1]) and r0 + 8 (acc[4j + 2, 3])
    if (C == 1) {
#pragma unroll
      for (int j = 0; j < T::GROUPS; ++j) {
        const int col = n0 + 8 * j + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + r0 + 8 * h;
          if (row < M && col < N)             // N % 4 == 0: col + 1 < N
            *reinterpret_cast<float2*>(args.out + (size_t)row * N + col) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
      continue;
    }

    // C > 1: push the partial tile, a pair of columns a st.async, into
    // recv[rank][j / C][row][col] of the group's owner, rank j % C
    hopper::cluster_wait();                   // every block's mbarriers ready
    const uint32_t recv_u = smem_u32(recv);
    const uint32_t bar_u = smem_u32(&recv_bar);
#pragma unroll
    for (int j = 0; j < T::GROUPS; ++j) {
      const int owner = j % C;
      const uint32_t base = hopper::dsmem(recv_u, owner);
      const uint32_t bar = hopper::dsmem(bar_u, owner);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t off = (uint32_t)(
            (((rank * lgroups + j / C) * BM + r0 + 8 * h) * 8 + 2 * q) * 4);
        hopper::st_async2(base + off, acc[4 * j + 2 * h],
                          acc[4 * j + 2 * h + 1], bar);
      }
    }
    // this block's groups: the C partials of each in rank order
    mbar_wait(&recv_bar, 0);
    for (int i = ct; i < owned * BM; i += 256) {
      const int lg = i / BM, row = i - lg * BM;
      const int m = m0 + row, n = n0 + 8 * (lg * C + rank);
      if (m >= M || n >= N) continue;
      float4 lo4 = make_float4(0.f, 0.f, 0.f, 0.f), hi4 = lo4;
      for (int r = 0; r < C; ++r) {
        const float4* p = reinterpret_cast<const float4*>(
            recv + ((size_t)(r * lgroups + lg) * BM + row) * 8);
        const float4 u = p[0], v = p[1];
        lo4.x += u.x; lo4.y += u.y; lo4.z += u.z; lo4.w += u.w;
        hi4.x += v.x; hi4.y += v.y; hi4.z += v.z; hi4.w += v.w;
      }
      float* dst = args.out + (size_t)m * N + n;
      *reinterpret_cast<float4*>(dst) = lo4;  // N % 4 == 0: n + 4 <= N
      if (n + 8 <= N) *reinterpret_cast<float4*>(dst + 4) = hi4;
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_b, const Args args) {
  product<BN, false>(&map_a, &map_b, args);
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
fused_kernel(const __grid_constant__ CUtensorMap map_a,
             const __grid_constant__ CUtensorMap map_b, const Args args) {
  product<BN, true>(&map_a, &map_b, args);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

struct Plan {
  int bn, cluster, tiles, blocks, kper, stages;
  bool fused;           // the product splits b itself (no split pass)
  size_t smem;
};

// A product splits b's tiles itself when at most two row tiles share each
// of them (M <= FUSED_MAX_M): it saves the split pass, which small
// products feel; past that the product's own splits cost more than the
// pass (on an H100, `tools/f32_matmul_routes.py`: the fused product ahead
// at M 128 and level at M 256 with K = N = 4096, behind from M 300).
constexpr int FUSED_MAX_M = 2 * BM;

// Once per N tile: allow SMEM_CAP of shared memory for both products and
// ask how many clusters of c blocks (c = 1..8) the card runs at once at
// that size (one block an SM); [0] is 1 when that succeeded.
template <int BN>
const int* prepared() {
  static int act[MAX_CLUSTER + 1] = {};
  static std::once_flag once;
  std::call_once(once, [] {
    for (auto kernel : {gemm_kernel<BN>, fused_kernel<BN>})
      if (cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_CAP) != cudaSuccess) {
        cudaGetLastError();
        return;
      }
    act[0] = 1;
    hopper::active_clusters(gemm_kernel<BN>, THREADS, SMEM_CAP, act);
  });
  return act;
}

inline const int* active(int bn) {
  return bn == 64 ? prepared<64>() : prepared<128>();
}

// A plan of N tile bn in clusters of c blocks, its ring as deep as the
// shared memory left allows (at most MAX_STAGES; with c > 1 at most the k
// blocks a block walks), its blocks one a tile up to a wave and then one
// an SM (c == 1), or one cluster a tile (c > 1); {0, ...} if no ring of
// two stages (one, for one k block) fits.
inline Plan fit(int M, int N, int K, int bn, int c, bool fused) {
  Plan p = {0, 0, 0, 0, 0, 0, false, 0};
  const int kb = (K + BK - 1) / BK, kper = (kb + c - 1) / c;
  const size_t stage =
      (size_t)BM * BK * 4 + (fused ? 3 : 2) * (size_t)bn * BK * 4;
  const size_t fixed = 1024 + recv_bytes(bn, c);
  if (fixed + stage > (size_t)SMEM_CAP) return p;
  int stages = (int)((SMEM_CAP - fixed) / stage);
  stages = stages > MAX_STAGES ? MAX_STAGES : stages;
  if (c > 1 && stages > kper) stages = kper;
  if (stages < (kper < 2 ? kper : 2)) return p;
  const int sms = hopper::sm_count();
  p.bn = bn;
  p.cluster = c;
  p.tiles = ((M + BM - 1) / BM) * ((N + bn - 1) / bn);
  p.blocks = c > 1 ? p.tiles * c : (p.tiles < sms ? p.tiles : sms);
  p.kper = kper;
  p.stages = stages;
  p.fused = fused;
  p.smem = fixed + stages * stage;
  return p;
}

// The N tile and cluster size of least cost: waves x (bn x k blocks a
// block + TILE_FIXED), plus, with a cluster, a wave's exchange
// (REDUCE_FIXED + bn / 2). Waves: tiles over SMs (c == 1, persistent), or
// over the clusters the card runs at once. Every rank of a cluster walks
// at least one k block. `tile_n` / `cluster` other than 0 pin that knob
// (the tuning layer's race): the search runs over the other alone, and
// finds nothing ({0, ...}) when the pinned value cannot run.
inline Plan search(int M, int N, int K, int tile_n = 0, int cluster = 0) {
  Plan best = {0, 0, 0, 0, 0, 0, false, 0};
  const int sms = hopper::sm_count();
  const int kb = (K + BK - 1) / BK;
  long best_cost = -1;
  for (int bn : TILE_N) {
    if (tile_n != 0 && bn != tile_n) continue;
    const int* act = active(bn);
    if (act[0] == 0) continue;
    for (int c = 1; c <= MAX_CLUSTER; ++c) {
      if (cluster != 0 && c != cluster) continue;
      const int kper = (kb + c - 1) / c;
      if ((c - 1) * kper >= kb || bn / 8 < c) continue;
      const Plan p = fit(M, N, K, bn, c, M <= FUSED_MAX_M);
      if (p.bn == 0) continue;
      const int conc = c == 1 ? sms : (act[c] < sms / c ? act[c] : sms / c);
      if (conc <= 0) continue;
      const long waves = (p.tiles + conc - 1) / conc;
      const long cost = waves * ((long)bn * kper + TILE_FIXED) +
                        (c > 1 ? waves * (REDUCE_FIXED + bn / 2) : 0);
      if (best_cost < 0 || cost < best_cost) {
        best_cost = cost;
        best = p;
      }
    }
  }
  return best;
}

// `search`'s plan, kept for each shape; a pinned plan is searched each
// call and kept nowhere.
inline Plan plan(int M, int N, int K, int tile_n = 0, int cluster = 0) {
  if (tile_n != 0 || cluster != 0) return search(M, N, K, tile_n, cluster);
  return hopper::per_shape(M, N, K,
                           [](int m, int n, int k) { return search(m, n, k); });
}

// The workspace a call needs, in floats: b's parts (2NK) unless the product
// splits b itself.
inline size_t workspace_floats(int M, int N, int K) {
  if (M <= 0 || N <= 0 || K <= 0 || !takes(N, K)) return 0;
  return plan(M, N, K).fused ? 0 : 2 * (size_t)N * K;
}

// out = a @ b under plan p: the split pass and the product, or the fused
// product alone. Every tensor map is encoded before anything is launched,
// so a call either launches all its kernels or returns an error having
// launched none.
inline int run(const Plan& p, const void* a, const void* b, void* out,
               float* workspace, int M, int N, int K, cudaStream_t st) {
  if (p.bn == 0 || (!p.fused && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  if (active(p.bn)[0] == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  cudaError_t err = hopper::encode(&map_a, a, M, K, BM, 0,
                                   CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err == cudaSuccess)
    err = p.fused ? hopper::encode(&map_b, b, K, N, BK, 0,
                                   CU_TENSOR_MAP_DATA_TYPE_FLOAT32)
                  : hopper::encode(&map_b, workspace, N, K, p.bn, 2,
                                   CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err != cudaSuccess) return (int)err;
  if (!p.fused) {
    err = hopper::launch_ex(split_kernel,
                            dim3((N + 31) / 32, (K + 31) / 32), 256, 0, 1,
                            st, (const float*)b, workspace, K, N);
    if (err != cudaSuccess) return (int)err;
  }
  const Args args = {(float*)out, M, N, K, p.kper, p.stages};
  const dim3 grid(p.blocks);
  if (p.bn == 64)
    err = hopper::launch_ex(p.fused ? fused_kernel<64> : gemm_kernel<64>,
                            grid, THREADS, p.smem, p.cluster, st, map_a,
                            map_b, args);
  else
    err = hopper::launch_ex(p.fused ? fused_kernel<128> : gemm_kernel<128>,
                            grid, THREADS, p.smem, p.cluster, st, map_a,
                            map_b, args);
  return (int)err;
}

// out (M,N) = a (M,K) @ b (K,N) in f32 on the tensor cores; the caller has
// checked `takes`. `workspace` holds 2NK floats (b's parts). `tile_n` /
// `cluster` pin the plan (0: searched); a pinned plan that cannot run is
// refused, never replaced.
inline int launch(const void* a, const void* b, void* out, float* workspace,
                  int M, int N, int K, cudaStream_t st, int tile_n = 0,
                  int cluster = 0) {
  if (M <= 0 || N <= 0 || K <= 0 || !takes(N, K))
    return (int)cudaErrorInvalidValue;
  return run(plan(M, N, K, tile_n, cluster), a, b, out, workspace, M, N, K,
             st);
}
}  // namespace tf32x3
