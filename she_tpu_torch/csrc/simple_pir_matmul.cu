// SimplePIR's response product on Hopper's tensor cores (sm_90a): u8 x u8
// -> s32 `wgmma` from shared memory, fed by a ring of bulk copies.
//
// Replaces she_tpu/pir/simple_pir.py:283, `self.database @ requests.T` on
// numpy object arrays: a product on the host, not a Pallas kernel. PyTorch
// has no integer matrix product on CUDA, so the port computes it here, and
// bit-identically in ops/simple_pir_cuda.simple_pir_matmul_plain.
//
// Function: out[k, r] = sum_c D[r, c] * Q[k, c] mod 2^b, for a database D
// of R rows and C columns with entries below 2^p and K request rows Q of
// b-bit words (int64). Every D entry is P_D = ceil(p / 8) byte planes and
// every Q word P_Q = ceil(b / 8), so the product is the sum of the plane
// products D_i Q_j^T weighted by 2^(8 (i + j)). A pair with 8 (i + j) >= b
// vanishes mod 2^b and is never issued: D plane i meets query planes
// j < J_i = P_Q - i only, and a D plane i >= P_Q is never read. Each pair
// keeps its own s32 sum over a column segment of at most 32,768 columns,
// exact because 32,768 * 255^2 < 2^31; the sums are weighted and added in
// uint64 (exact mod 2^64, a multiple of 2^b), the segments' sums added in
// a last pass and masked to b bits.
//
// Bound: bytes. A launch must read the D planes it needs (P_D * R * C
// bytes), the int64 query and write the int64 output once; at 3.35 TB/s
// (H100 SXM), at the SimplePIR cell's R = 3641, C = 262,144, P_D = 2:
//   K = 32: 1.909 GB + 67.1 MB + 0.9 MB = 1.977 GB, 0.590 ms;
//   K = 1:  1.909 GB + 2.1 MB = 1.911 GB, 0.571 ms.
// Its u8 operations with the vanishing pair skipped (2 R C K * 7 pairs at
// b = 32: 4.3e11 at K = 32) take 0.22 ms at 1,979 TOPS. An mma.sync form
// in which every warp loaded its own query fragments from L2 reached 40%
// of the bound at K = 32: its query loads and mma.sync, not the D bytes,
// held it back. Here the query sits in shared memory, read there by every
// consumer warp, the products run as wgmma, and a producer warp keeps the
// D bytes moving; a copy_ of the planes moves them at 90% of 3.35 TB/s,
// and the products of a launch hide behind its bytes (PERF.md).
//
// Domain: every P_D <= 8 and 1 <= b <= 62, any R, C and K whose units
// (segments x query chunks x blocks of 128 rows) number below 2^31; the
// wrapper raises on anything else.
//
// Layouts, each tile the exact image of a 128-byte-swizzled shared-memory
// tile (Swizzle<3,4,3>: the 16-byte chunk c of row r lands at chunk
// c ^ (r % 8), rows 128 bytes apart, 8-row atoms of 1,024 bytes), so a
// 1-D bulk copy moves it and wgmma reads it through a descriptor with
// 128-byte swizzling, K-major (8-bit wgmma takes no transpose):
//   planes  uint8 [P_D, R64, KB, 8192]: plane i, row tile t (64 rows, R
//           zero-padded to R64 * 64), box kb (128 columns, C zero-padded
//           to KB * 128): 64 rows x 128 bytes;
//   qtiles  uint8 [NC, KB, P_Q * KQT * 128]: chunk nc of KQT request rows
//           (8, 16 or 32; K zero-padded to NC * KQT), box kb: the rows of
//           query plane j at j * KQT .. j * KQT + KQT - 1, 128 bytes each.
//           Made by split_query from the int64 query.
//   partials uint64 [G * S, K, R]: one per D-plane group and column
//           segment.
//
// Three launches on the caller's stream:
//   1. split_query: the query's byte planes in their tiles;
//   2. plane_products<JA, NI, KQT>, once per group of NI <= 2 D planes
//      (planes i0 .. i0 + NI - 1, JA = P_Q - i0): a persistent grid, one
//      block an SM, walks units (segment, chunk, row block of 128 rows)
//      segment by segment, so the query tiles in use stay within a few
//      segments' (4.2 MB each at K = 32) of the 50 MB L2. A block is one
//      producer warp and two consumer warpgroups of 64 rows. The producer's
//      one thread fills a ring of stages (each the NI x 2 D tiles and the
//      query tile of one box) with cp.async.bulk on an mbarrier a stage.
//      Each consumer warpgroup waits for a stage, issues for each of the 4
//      k32 steps and each D plane i one wgmma m64nNk32 of its 64 rows
//      against the J_i query planes (N = J_i * KQT, in pieces of powers of
//      two: the widths Hopper's u8 wgmma takes), waits for them and frees
//      the stage. At a unit's end each thread weights its pair sums (it
//      holds the same request rows of every pair) and writes them;
//   3. sum_segments: out = (sum over the G * S partials) & (2^b - 1).

#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned int u32;
typedef unsigned long long u64;

namespace {

constexpr int kConsumers = 2;                    // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * kConsumers + 32;  // and one producer warp
constexpr int kTileRows = 64;                    // rows of one wgmma
constexpr int kBox = 128;                        // columns of a box: one swizzled 128-byte row
constexpr int kTileBytes = kTileRows * kBox;
constexpr int kSegmentBoxes = 256;               // 32,768 columns: the most one s32 sum takes
constexpr int kMaxStages = 8;
constexpr int kSharedLimit = 232448;             // 227 KB of shared memory a block
constexpr int kAccColumns = 256;                 // wgmma columns a consumer thread holds sums of

// a launch takes ni <= 2 D planes, the first meeting ja query planes, the
// second ja - 1, where their pair sums of kqt request rows fit
__host__ __device__ constexpr bool fits(int ja, int ni, int kqt) {
  return ni >= 1 && ni <= 2 && ni <= ja && ja <= 8 && (ni * ja - ni * (ni - 1) / 2) * kqt <= kAccColumns;
}

// the ring of such a launch: a stage holds the ni x 2 D tiles and the ja
// query planes' tile of one box; as many stages as fit (at most 8), after
// 1,024 bytes of slack to align the tiles, and two mbarriers a stage
__host__ __device__ constexpr int stage_bytes(int ja, int ni, int kqt) {
  return ni * kConsumers * kTileBytes + ja * kqt * kBox;
}
__host__ __device__ constexpr int ring_stages(int ja, int ni, int kqt) {
  const int fit = (kSharedLimit - 1024 - 16 * kMaxStages) / stage_bytes(ja, ni, kqt);
  return fit < kMaxStages ? fit : kMaxStages;
}
__host__ __device__ constexpr int ring_shared(int ja, int ni, int kqt) {
  return 1024 + ring_stages(ja, ni, kqt) * (stage_bytes(ja, ni, kqt) + 16);
}

template <int JA, int NI, int KQT>
struct Group {
  static constexpr int kStageA = NI * kConsumers * kTileBytes;
  static constexpr int kStageB = JA * KQT * kBox;
  static constexpr int kStageBytes = stage_bytes(JA, NI, KQT);
  static constexpr int kStages = ring_stages(JA, NI, KQT);
  static constexpr int kShared = ring_shared(JA, NI, KQT);
};

__device__ __forceinline__ u32 shared_address(const void* p) {
  return static_cast<u32>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(u32 bar, u32 count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect_bytes(u32 bar, u32 bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(u32 bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ u64 global_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ u32 bar_try_wait(u32 bar, u32 parity) {
  u32 done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// waits for the phase of parity `parity` to complete, by one thread or
// (warp) by a whole warp on lane 0's reading, a value the compiler knows
// to be the warp's: its wgmma then run on a path it sees as convergent. A
// wait of more than 10 s (a lost stage: a whole launch takes milliseconds)
// traps, so a fault ends the launch with an error instead of holding the
// card.
template <bool kWarp>
__device__ __forceinline__ void bar_wait(u32 bar, u32 parity) {
  u64 start = 0;
  for (u32 spin = 1;; ++spin) {
    u32 done = bar_try_wait(bar, parity);
    if constexpr (kWarp) done = __shfl_sync(0xffffffffu, done, 0);
    if (done) return;
    if (spin % 1024 == 0) {
      if (start == 0) start = global_ns();
      else if (global_ns() - start > 10000000000ull) __trap();
    }
  }
}

// bytes (a multiple of 16) from global to shared memory, counted on `bar`
__device__ __forceinline__ void bulk_load(u32 dst, const void* src, u32 bytes, u32 bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// wgmma's descriptor of a K-major tile with 128-byte swizzling: start
// address, stride of 1,024 bytes between 8-row atoms (the leading offset
// is not read for this layout)
__device__ __forceinline__ u64 tile_descriptor(u32 address) {
  return static_cast<u64>((address & 0x3FFFF) >> 4) | (static_cast<u64>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// keeps the compiler from moving reads of the first `used` of M sums above
// the wait for the asynchronous wgmma (a constant trip count, so that every
// index folds to a register)
template <int M>
__device__ __forceinline__ void fence_sums(int* d, int used) {
#pragma unroll
  for (int x = 0; x < M; ++x)
    if (x < used) asm volatile("" : "+r"(d[x])::"memory");
}

#define D4(o) "+r"(d[o]), "+r"(d[o + 1]), "+r"(d[o + 2]), "+r"(d[o + 3])
#define D8(o) D4(o), D4(o + 4)
#define D16(o) D8(o), D8(o + 8)
#define D32(o) D16(o), D16(o + 16)
#define D64(o) D32(o), D32(o + 32)
#define D128(o) D64(o), D64(o + 64)

// d (N / 2 s32 sums a thread) += A (64 x 32 u8, descriptor a) . B (N x 32
// u8, descriptor b)^T, or = where accumulate is 0. The register lists run
// %0 .. %(N / 2 - 1), then the two descriptors and the flag.
template <int N>
__device__ __forceinline__ void wgmma(int* d, u64 a, u64 b, int accumulate);

template <>
__device__ __forceinline__ void wgmma<8>(int* d, u64 a, u64 b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.u8.u8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n}\n"
      : D4(0)
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<16>(int* d, u64 a, u64 b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : D8(0)
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<32>(int* d, u64 a, u64 b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : D16(0)
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<64>(int* d, u64 a, u64 b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : D32(0)
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<128>(int* d, u64 a, u64 b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : D64(0)
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<256>(int* d, u64 a, u64 b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : D128(0)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef D4
#undef D8
#undef D16
#undef D32
#undef D64
#undef D128

// the widest power of two m <= J with m * KQT columns a wgmma takes (<= 256)
template <int J, int KQT>
__host__ __device__ constexpr int piece() {
  int m = 1;
  while (2 * m <= J && 2 * m * KQT <= 256) m *= 2;
  return m;
}

// one k32 step of a D plane against its J query planes, starting at J0:
// the sums of query plane j are d[j * KQT / 2 ..], its B rows at j * KQT
template <int J, int KQT, int J0 = 0>
__device__ __forceinline__ void plane_step(int* d, u64 a, u32 b, int accumulate) {
  if constexpr (J0 < J) {
    constexpr int m = piece<J - J0, KQT>();
    wgmma<m * KQT>(d + J0 * KQT / 2, a, tile_descriptor(b + J0 * KQT * kBox), accumulate);
    plane_step<J, KQT, J0 + m>(d, a, b, accumulate);
  }
}

// qtiles [NC, KB, PQ * KQT * 128] (see above) from query int64 [K, C]: a
// thread takes 16 columns of one request row in one box, reads the 16
// words once and writes their PQ byte planes, 16 bytes each
__global__ void split_query(const long long* __restrict__ query, unsigned char* __restrict__ qtiles, int K,
                            long long C, int KQT, int NC, int KB, int PQ) {
  const long long total = static_cast<long long>(NC) * KQT * KB * 8;
  const long long tile = static_cast<long long>(PQ) * KQT * kBox;
  for (long long v = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; v < total;
       v += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int chunk16 = static_cast<int>(v & 7);
    const long long t = v >> 3;
    const int kb = static_cast<int>(t % KB);
    const int row = static_cast<int>((t / KB) % KQT);
    const int nc = static_cast<int>(t / (static_cast<long long>(KB) * KQT));
    const int n = nc * KQT + row;
    const long long c0 = static_cast<long long>(kb) * kBox + 16 * chunk16;
    u64 w[16];
#pragma unroll
    for (int x = 0; x < 16; ++x)
      w[x] = n < K && c0 + x < C ? static_cast<u64>(query[static_cast<long long>(n) * C + c0 + x]) : 0;
    unsigned char* out = qtiles + (static_cast<long long>(nc) * KB + kb) * tile + (row & 7) * kBox +
                         16 * (chunk16 ^ (row & 7));
    for (int j = 0; j < PQ; ++j) {
      u32 b[4];
#pragma unroll
      for (int x = 0; x < 4; ++x)
        b[x] = static_cast<u32>((w[4 * x] >> (8 * j)) & 0xFF) | static_cast<u32>((w[4 * x + 1] >> (8 * j)) & 0xFF) << 8 |
               static_cast<u32>((w[4 * x + 2] >> (8 * j)) & 0xFF) << 16 |
               static_cast<u32>((w[4 * x + 3] >> (8 * j)) & 0xFF) << 24;
      const int r = j * KQT + row;  // the tile's row: 8-row atoms of 1,024 bytes
      *reinterpret_cast<uint4*>(out + (r >> 3) * 1024) = make_uint4(b[0], b[1], b[2], b[3]);
    }
  }
}

struct Shape {
  const unsigned char* planes;
  const unsigned char* qtiles;
  u64* partials;
  int R, tiles, boxes, K, NC, PQ;
  int i0, group;         // the group's first D plane and its index
  int segment, segments;  // boxes a segment, segments
};

template <int JA, int NI, int KQT>
__global__ void __launch_bounds__(kThreads, 1) plane_products(const Shape s) {
  using G = Group<JA, NI, KQT>;
  constexpr int kStages = G::kStages;
  extern __shared__ unsigned char shared_raw[];
  const u32 base = (shared_address(shared_raw) + 1023) & ~1023u;
  const u32 full = base + kStages * G::kStageBytes;  // full[i] at full + 8 i, empty[i] after them
  const u32 empty = full + 8 * kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int blocks_of_rows = (s.tiles + kConsumers - 1) / kConsumers;
  const int units = s.segments * s.NC * blocks_of_rows;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      bar_init(full + 8 * i, 1);
      bar_init(empty + 8 * i, 4 * kConsumers);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {  // the producer warp: one thread issues every copy
    if (lane != 0) return;
    const long long qtile = static_cast<long long>(s.PQ) * KQT * kBox;
    int stage = 0;
    u32 phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int seg = u / (s.NC * blocks_of_rows), nc = u / blocks_of_rows % s.NC, tile0 = u % blocks_of_rows * kConsumers;
      const int kb0 = seg * s.segment, kb1 = kb0 + s.segment < s.boxes ? kb0 + s.segment : s.boxes;
      const int present = s.tiles - tile0 < kConsumers ? s.tiles - tile0 : kConsumers;
      const u32 bytes = present * NI * kTileBytes + G::kStageB;
      for (int kb = kb0; kb < kb1; ++kb) {
        bar_wait<false>(empty + 8 * stage, phase ^ 1);
        bar_expect_bytes(full + 8 * stage, bytes);
        const u32 dst = base + stage * G::kStageBytes;
        for (int i = 0; i < NI; ++i)
          for (int w = 0; w < present; ++w)
            bulk_load(dst + (i * kConsumers + w) * kTileBytes,
                      s.planes + ((static_cast<long long>(s.i0 + i) * s.tiles + tile0 + w) * s.boxes + kb) * kTileBytes,
                      kTileBytes, full + 8 * stage);
        bulk_load(dst + G::kStageA, s.qtiles + (static_cast<long long>(nc) * s.boxes + kb) * qtile, G::kStageB,
                  full + 8 * stage);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // a consumer warpgroup: 64 rows of the block's 128 (read through a
  // shuffle, so the compiler knows it is the same across the warp)
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int row = (warp & 3) * 16 + (lane >> 2);  // and row + 8: the rows of this thread's sums
  int acc[NI][JA * KQT / 2];  // plane i uses the first (JA - i) * KQT / 2
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int x = 0; x < JA * KQT / 2; ++x)
      if (x < (JA - i) * KQT / 2) acc[i][x] = 0;
  int stage = 0;
  u32 phase = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int seg = u / (s.NC * blocks_of_rows), nc = u / blocks_of_rows % s.NC;
    const int tile = u % blocks_of_rows * kConsumers + wg;
    const int kb0 = seg * s.segment, kb1 = kb0 + s.segment < s.boxes ? kb0 + s.segment : s.boxes;
    // a warpgroup whose row tile is past R (the last block's second, where
    // R64 is odd) multiplies stale tiles like the others and writes nothing:
    // no branch stands between the wait and its wgmma
    for (int kb = kb0; kb < kb1; ++kb) {
      bar_wait<true>(full + 8 * stage, phase);
      const u32 a = base + stage * G::kStageBytes + wg * kTileBytes;
      const u32 b = base + stage * G::kStageBytes + G::kStageA;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBox / 32; ++ks) {
        const int accumulate = kb > kb0 || ks > 0;
        plane_step<JA, KQT>(acc[0], tile_descriptor(a + 32 * ks), b + 32 * ks, accumulate);
        if constexpr (NI == 2)
          plane_step<JA - 1, KQT>(acc[1], tile_descriptor(a + kConsumers * kTileBytes + 32 * ks), b + 32 * ks,
                                  accumulate);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < NI; ++i) fence_sums<JA * KQT / 2>(acc[i], (JA - i) * KQT / 2);
      if (lane == 0) bar_arrive(empty + 8 * stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    // sum (i, j) of request row n, row r sits in acc[i][j * KQT / 2 + 4 b8 +
    // 2 h + e] with n = nc * KQT + 8 b8 + 2 (lane % 4) + e, r = tile * 64 +
    // row + 8 h (the accumulator layout of wgmma, 8 columns a register quad)
    u64* out = s.partials + static_cast<long long>(s.group * s.segments + seg) * s.K * s.R;
#pragma unroll
    for (int b8 = 0; b8 < KQT / 8; ++b8)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          u64 sum = 0;
#pragma unroll
          for (int i = 0; i < NI; ++i)
#pragma unroll
            for (int j = 0; j < JA; ++j)  // constant trip counts, so every index folds to a register
              if (j < JA - i)
                sum += static_cast<u64>(static_cast<u32>(acc[i][j * KQT / 2 + 4 * b8 + 2 * h + e])) << (8 * (s.i0 + i + j));
          const int r = tile * kTileRows + row + 8 * h;
          const int n = nc * KQT + 8 * b8 + 2 * (lane & 3) + e;
          if (r < s.R && n < s.K) out[static_cast<long long>(n) * s.R + r] = sum;
        }
  }
}

__global__ void sum_segments(const u64* __restrict__ partials, long long* __restrict__ out, int slots, int K, int R,
                             u64 mask) {
  const long long total = static_cast<long long>(K) * R;
  for (long long v = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; v < total;
       v += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long n = v / R, r = v % R;
    u64 sum = 0;
    for (int slot = 0; slot < slots; ++slot) sum += partials[(static_cast<long long>(slot) * K + n) * R + r];
    out[v] = static_cast<long long>(sum & mask);
  }
}

template <int JA, int NI, int KQT>
int launch_group(const Shape& s, int grid, cudaStream_t stream) {
  if constexpr (!fits(JA, NI, KQT)) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    auto kernel = plane_products<JA, NI, KQT>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Group<JA, NI, KQT>::kShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, Group<JA, NI, KQT>::kShared, stream>>>(s);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int KQT, int JA>
int launch_ni(int ni, const Shape& s, int grid, cudaStream_t stream) {
  if (ni == 1) return launch_group<JA, 1, KQT>(s, grid, stream);
  if (ni == 2) return launch_group<JA, 2, KQT>(s, grid, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int KQT>
int launch_ja(int ja, int ni, const Shape& s, int grid, cudaStream_t stream) {
  switch (ja) {
    case 1: return launch_ni<KQT, 1>(ni, s, grid, stream);
    case 2: return launch_ni<KQT, 2>(ni, s, grid, stream);
    case 3: return launch_ni<KQT, 3>(ni, s, grid, stream);
    case 4: return launch_ni<KQT, 4>(ni, s, grid, stream);
    case 5: return launch_ni<KQT, 5>(ni, s, grid, stream);
    case 6: return launch_ni<KQT, 6>(ni, s, grid, stream);
    case 7: return launch_ni<KQT, 7>(ni, s, grid, stream);
    case 8: return launch_ni<KQT, 8>(ni, s, grid, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int blocks_for(long long total) {
  const long long b = (total + 255) / 256;
  return static_cast<int>(b < 8192 ? (b > 0 ? b : 1) : 8192);
}

}  // namespace

// planes uint8 [PD, ceil(R / 64), Kpad / 128, 8192] (tiles, see above);
// query int64 [K, C]; qtiles uint8 [NC, Kpad / 128, PQ * KQT * 128] and
// partials uint64 [G * S, K, R] scratch; out int64 [K, R]. KQT 8,
// 16 or 32, NC = ceil(K / KQT), G the D-plane groups (planes below
// min(PD, PQ), two a group where fits() allows), segment boxes of 128
// columns (1 .. 256), S = ceil(Kpad / 128 / segment), grid the blocks of
// each group's persistent launch. Returns the CUDA error of the launches
// (0 on success).
extern "C" int she_simple_pir_matmul(const void* planes, const void* query, void* qtiles, void* partials, void* out,
                                     int PD, int R, long long Kpad, int K, long long C, int bits, int KQT, int NC,
                                     int G, int segment, int S, int grid, void* stream) {
  const int PQ = (bits + 7) / 8;
  const long long boxes = Kpad / kBox;
  if (PD < 1 || PD > 8 || R < 1 || K < 1 || C < 1 || Kpad % kBox || Kpad < C || Kpad - C >= kBox || bits < 1 ||
      bits > 62 || (KQT != 8 && KQT != 16 && KQT != 32) || NC != (K + KQT - 1) / KQT || segment < 1 ||
      segment > kSegmentBoxes || S != (boxes + segment - 1) / segment || grid < 1 || boxes > (1 << 30) ||
      static_cast<long long>(S) * NC * ((R + 2 * kTileRows - 1) / (2 * kTileRows)) > (1ll << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto* qt = static_cast<unsigned char*>(qtiles);
  split_query<<<blocks_for(static_cast<long long>(NC) * KQT * boxes * 8), 256, 0, st>>>(
      static_cast<const long long*>(query), qt, K, C, KQT, NC, static_cast<int>(boxes), PQ);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int needed = PD < PQ ? PD : PQ;  // D planes i >= PQ meet no query plane below weight 2^b
  Shape s{static_cast<const unsigned char*>(planes), qt, static_cast<u64*>(partials), R, (R + kTileRows - 1) / kTileRows,
          static_cast<int>(boxes), K, NC, PQ, 0, 0, segment, S};
  int group = 0;
  for (int i0 = 0; i0 < needed; ++group) {
    const int ja = PQ - i0;
    const int ni = needed - i0 >= 2 && fits(ja, 2, KQT) ? 2 : 1;
    if (group >= G) return static_cast<int>(cudaErrorInvalidValue);
    s.i0 = i0;
    s.group = group;
    int e = KQT == 8 ? launch_ja<8>(ja, ni, s, grid, st)
                     : KQT == 16 ? launch_ja<16>(ja, ni, s, grid, st) : launch_ja<32>(ja, ni, s, grid, st);
    if (e != 0) return e;
    i0 += ni;
  }
  if (group != G) return static_cast<int>(cudaErrorInvalidValue);
  const u64 mask = (1ull << bits) - 1;
  sum_segments<<<blocks_for(static_cast<long long>(K) * R), 256, 0, st>>>(
      static_cast<const u64*>(partials), static_cast<long long*>(out), G * S, K, R, mask);
  return static_cast<int>(cudaGetLastError());
}

// the ring of the launch of ni D planes whose first meets ja query planes,
// kqt request rows a query tile: its stages and dynamic shared memory.
// Returns 0, or cudaErrorInvalidValue where no such launch is built.
extern "C" int she_simple_pir_ring(int ja, int ni, int kqt, int* stages, int* shared) {
  if (!fits(ja, ni, kqt) || (kqt != 8 && kqt != 16 && kqt != 32)) return static_cast<int>(cudaErrorInvalidValue);
  *stages = ring_stages(ja, ni, kqt);
  *shared = ring_shared(ja, ni, kqt);
  return 0;
}
