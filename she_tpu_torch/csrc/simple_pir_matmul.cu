// SimplePIR's response product as u8 x u8 -> s32 products on the tensor
// cores, for Hopper (sm_90a).
//
// Replaces she_tpu/pir/simple_pir.py:283, `self.database @ requests.T` on
// numpy object arrays: a product on the host, not a Pallas kernel. PyTorch
// has no integer matrix product on CUDA, so the port computes it here, and
// bit-identically in ops/simple_pir_cuda.simple_pir_matmul_plain.
//
// Function: out[k, r] = sum_c D[r, c] * Q[k, c] mod 2^b, for a database D
// of R rows and C columns with entries below 2^p and K request rows Q of
// b-bit words (int64). Every D entry is P_D = ceil(p / 8) byte planes and
// every Q word P_Q = ceil(b / 8) byte planes, so the product is the sum of
// the plane products D_i Q_j^T weighted by 2^(8 (i + j)). Each is a u8 x u8
// -> s32 product (mma.sync m16n8k32). A block takes the planes of D in
// groups of PG <= 2 and sums the products of equal weight i + j in one
// int32 register: at most min(PG, P_Q) of them, over a column segment of
// at most 32,768 / min(PG, P_Q) columns, so every int32 sum is exact
// (32,768 * 255^2 < 2^31): no sum relies on an int32 wrapping. The weighted
// sums are added in uint64, which wraps mod 2^64, a multiple of 2^b
// (b <= 62), and the segments' sums are masked to b bits at the end: exact.
//
// Inputs: `planes` uint8 [P_D, R16, Kpad / 64, 1024], D's byte planes in
// tiles of 16 rows x 64 columns (R padded with zero rows to R16 * 16, C
// with zero columns to Kpad, a multiple of kKStep), made once when the
// server is built: in a tile, rows 0-7 then rows 8-15, each half as 32
// runs of 16 bytes, run 4g + t holding columns 16t..16t+15 of row g. So
// the two 16-byte loads of lane 4g + t of a warp are the lane's 16 bytes
// of two contiguous 512-byte halves, and a warp reads its 16 rows of a
// plane as one contiguous stream. `query` int64 [K, C]. Scratch: `qplanes`
// uint8 [P_Q, KQ, Kpad] (the query's byte planes, rows zero-padded to KQ,
// a multiple of 8 * NT), `partials` uint64 [S, KQ, R] (one per segment).
// Output: int64 [K, R] in [0, 2^b).
//
// Three launches on the caller's stream:
//   1. split_query: the query's byte planes (a pre-pass over K * C words);
//   2. plane_products<P_Q, NT, PG>: a block of 8 warps takes 128 rows of D,
//      one column segment and 8 * NT request rows; warp w takes 16 rows.
//      For each 64 columns, thread (g, t) holds 16 bytes of rows g and
//      g + 8 of each plane of the group, and 16 bytes of its request row g
//      of each n tile and query plane (read through L1 from L2). The order
//      of the columns inside an MMA does not change a sum, so the 16 bytes
//      feed the k positions 4t..4t+3 and 16+4t..16+4t+3 of two m16n8k32
//      MMAs (bytes 0-7 the first, 8-15 the second), in A and B alike. The
//      loads of four 64-column steps (two for one n tile) are issued before
//      their MMAs. Each block reads its rows of every D plane once; the
//      query planes (K * C * P_Q bytes: 33.6 MB at the chip phase's shape)
//      are read again by every block along R and stay in the 50 MB L2.
//   3. sum_segments: out = (sum over the S segments) & (2^b - 1).
//
// Bound: bytes. A launch must read the D planes (P_D * R * C bytes) and the
// int64 query once and write the int64 output once; at 3.35 TB/s (H100
// SXM), for the chip phase's shape R = 3641, C = 262,144, P_D = 2:
//   K = 32: 1.909 GB + 67.1 MB + 0.9 MB = 1.977 GB, 0.590 ms;
//   K = 1:  1.909 GB + 2.1 MB = 1.911 GB, 0.571 ms.
// Its int8 operations (2 P_D P_Q R C K: 4.9e11 at b = 32, K = 32) take 0.25
// ms at 1,979 TOPS.

#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned int u32;
typedef unsigned long long u64;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerBlock = 16 * kWarps;
constexpr int kStep = 64;               // columns of one tile
constexpr int kTileBytes = 16 * kStep;  // 16 rows x 64 columns
constexpr int kKStep = 4 * kStep;       // Kpad and the segment are multiples
// 64-column steps whose loads a warp issues together: 4 where a block takes
// 2 or 4 n tiles (the MMAs of a step outlast its loads), 2 for one n tile
// (half the registers: two blocks an SM)
template <int NT>
__host__ __device__ constexpr int steps_for() {
  return NT == 1 ? 2 : 4;
}
constexpr long long kSegment = 32768;   // the most columns one int32 product sums

// not volatile: the compiler may interleave the MMAs of independent sums
__device__ __forceinline__ void mma_u8(int (&c)[4], u32 a0, u32 a1, u32 a2, u32 a3, u32 b0,
                                       u32 b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 load16(const unsigned char* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// D's rows stream once: keep them out of L1
__device__ __forceinline__ uint4 load16_stream(const unsigned char* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__global__ void split_query(const long long* __restrict__ query, unsigned char* __restrict__ qplanes,
                            int K, long long C, int KQ, long long Kpad, int PQ) {
  const long long total = static_cast<long long>(KQ) * Kpad;
  for (long long v = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; v < total;
       v += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long n = v / Kpad, c = v % Kpad;
    const u64 w = n < K && c < C ? static_cast<u64>(query[n * C + c]) : 0;
    for (int j = 0; j < PQ; ++j)
      qplanes[static_cast<long long>(j) * total + v] = static_cast<unsigned char>(w >> (8 * j));
  }
}

template <int PQ, int NT, int PG>
__global__ void __launch_bounds__(kThreads)
    plane_products(const unsigned char* __restrict__ planes,
                   const unsigned char* __restrict__ qplanes, u64* __restrict__ partials, int PD,
                   int R, long long Kpad, int KQ, long long segment) {
  constexpr int kWeights = PG + PQ - 1;
  constexpr int kSteps = steps_for<NT>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tile_row = blockIdx.x * kWarps + warp;  // 16-row tile of the warp
  const int ra = tile_row * 16 + g, rb = ra + 8;
  const long long k0 = blockIdx.y * segment;
  const long long k1 = k0 + segment < Kpad ? k0 + segment : Kpad;
  const int n0 = blockIdx.z * NT * 8;
  const long long ktiles = Kpad / kStep;
  const long long plane_bytes = ((R + 15) / 16) * ktiles * kTileBytes;
  const long long qplane_bytes = static_cast<long long>(KQ) * Kpad;
  if (tile_row * 16 >= R) return;  // a warp past the last row has no work

  for (int p0 = 0; p0 < PD; p0 += PG) {
    const unsigned char* a = planes + p0 * plane_bytes + tile_row * ktiles * kTileBytes + 16 * lane;
    const unsigned char* b = qplanes + static_cast<long long>(n0 + g) * Kpad + 16 * t;
    int acc[kWeights][NT][4];
#pragma unroll
    for (int w = 0; w < kWeights; ++w)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[w][nt][e] = 0;

    for (long long k = k0; k < k1; k += kSteps * kStep) {
      uint4 lo[PG][kSteps], hi[PG][kSteps];
#pragma unroll
      for (int i = 0; i < PG; ++i)
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          const bool has = p0 + i < PD;
          const unsigned char* tile = a + i * plane_bytes + (k / kStep + s) * kTileBytes;
          lo[i][s] = has ? load16_stream(tile) : make_uint4(0, 0, 0, 0);
          hi[i][s] = has ? load16_stream(tile + kTileBytes / 2) : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
#pragma unroll
        for (int j = 0; j < PQ; ++j) {
          uint4 q[NT];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) q[nt] = load16(b + j * qplane_bytes + nt * 8 * Kpad + k + s * kStep);
          // the first halves (bytes 0-7) of every (plane, n tile), then the
          // second: consecutive MMAs add into different sums
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < PG; ++i)
              mma_u8(acc[i + j][nt], lo[i][s].x, hi[i][s].x, lo[i][s].y, hi[i][s].y, q[nt].x, q[nt].y);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < PG; ++i)
              mma_u8(acc[i + j][nt], lo[i][s].z, hi[i][s].z, lo[i][s].w, hi[i][s].w, q[nt].z, q[nt].w);
        }
    }
    // weight 2^(8 (p0 + w)); a weight of 2^64 or more vanishes mod 2^64. C
    // fragment: e = 0, 1 row g, columns 2t, 2t + 1; e = 2, 3 row g + 8
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        u64 sum = 0;
#pragma unroll
        for (int w = 0; w < kWeights; ++w) {
          const int shift = 8 * (p0 + w);
          if (shift < 64) sum += static_cast<u64>(static_cast<u32>(acc[w][nt][e])) << shift;
        }
        const int r = e < 2 ? ra : rb;
        const int n = n0 + nt * 8 + 2 * t + (e & 1);
        if (r < R) {
          u64* out = partials + (static_cast<long long>(blockIdx.y) * KQ + n) * R + r;
          *out = p0 == 0 ? sum : *out + sum;
        }
      }
  }
}

__global__ void sum_segments(const u64* __restrict__ partials, long long* __restrict__ out, int S,
                             int K, int KQ, int R, u64 mask) {
  const long long total = static_cast<long long>(K) * R;
  for (long long v = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; v < total;
       v += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long n = v / R, r = v % R;
    u64 s = 0;
    for (int seg = 0; seg < S; ++seg) s += partials[(static_cast<long long>(seg) * KQ + n) * R + r];
    out[v] = static_cast<long long>(s & mask);
  }
}

struct Launch {
  dim3 grid;
  const unsigned char* planes;
  const unsigned char* qplanes;
  u64* partials;
  int PD, R;
  long long Kpad;
  int KQ;
  long long segment;
  cudaStream_t stream;
};

template <int PQ, int NT>
void launch_products(const Launch& l) {
  if (l.PD == 1)
    plane_products<PQ, NT, 1><<<l.grid, kThreads, 0, l.stream>>>(l.planes, l.qplanes, l.partials, l.PD,
                                                                  l.R, l.Kpad, l.KQ, l.segment);
  else
    plane_products<PQ, NT, 2><<<l.grid, kThreads, 0, l.stream>>>(l.planes, l.qplanes, l.partials, l.PD,
                                                                  l.R, l.Kpad, l.KQ, l.segment);
}

template <int PQ>
bool launch_nt(int NT, const Launch& l) {
  if (NT == 1) {
    launch_products<PQ, 1>(l);
  } else if (NT == 2) {
    launch_products<PQ, 2>(l);
  } else if constexpr (PQ <= 4) {  // four n tiles only where the sums fit the registers
    if (NT != 4) return false;
    launch_products<PQ, 4>(l);
  } else {
    return false;
  }
  return true;
}

int blocks_for(long long total) {
  const long long b = (total + 255) / 256;
  return static_cast<int>(b < 8192 ? (b > 0 ? b : 1) : 8192);
}

}  // namespace

// planes uint8 [PD, ceil(R / 16), Kpad / 64, 1024] (tiles, see above);
// query int64 [K, C]; qplanes uint8 [PQ, KQ, Kpad] and partials uint64 [S,
// KQ, R] scratch; out int64 [K, R]. NT n tiles a block (1, 2, or 4 where
// PQ <= 4), KQ a multiple of 8 * NT, segment a multiple of 256 and at most
// 32,768 / min(PD, 2, PQ), S = ceil(Kpad / segment). Returns the CUDA error
// of the launches (0 on success).
extern "C" int she_simple_pir_matmul(const void* planes, const void* query, void* qplanes,
                                     void* partials, void* out, int PD, int R, long long Kpad,
                                     int K, long long C, int bits, int PQ, int NT, int KQ,
                                     long long segment, int S, void* stream) {
  const int shared = PD < 2 || PQ < 2 ? 1 : 2;  // products sharing one int32 sum
  if (PD < 1 || PD > 8 || R < 1 || K < 1 || C < 1 || Kpad % kKStep || Kpad < C ||
      Kpad - C >= kKStep || bits < 1 || bits > 62 || PQ != (bits + 7) / 8 || KQ < K ||
      KQ % (8 * NT) || segment % kKStep || segment < kKStep || segment * shared > kSegment ||
      S != (Kpad + segment - 1) / segment || S > 65535 || KQ / (8 * NT) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto* qp = static_cast<unsigned char*>(qplanes);
  auto* ps = static_cast<u64*>(partials);
  split_query<<<blocks_for(static_cast<long long>(KQ) * Kpad), 256, 0, st>>>(
      static_cast<const long long*>(query), qp, K, C, KQ, Kpad, PQ);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Launch l{dim3((R + kRowsPerBlock - 1) / kRowsPerBlock, S, KQ / (8 * NT)),
                 static_cast<const unsigned char*>(planes), qp, ps, PD, R, Kpad, KQ, segment, st};
  bool ok = false;
  switch (PQ) {
    case 1: ok = launch_nt<1>(NT, l); break;
    case 2: ok = launch_nt<2>(NT, l); break;
    case 3: ok = launch_nt<3>(NT, l); break;
    case 4: ok = launch_nt<4>(NT, l); break;
    case 5: ok = launch_nt<5>(NT, l); break;
    case 6: ok = launch_nt<6>(NT, l); break;
    case 7: ok = launch_nt<7>(NT, l); break;
    case 8: ok = launch_nt<8>(NT, l); break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const u64 mask = (1ull << bits) - 1;
  sum_segments<<<blocks_for(static_cast<long long>(K) * R), 256, 0, st>>>(
      ps, static_cast<long long*>(out), S, K, KQ, R, mask);
  return static_cast<int>(cudaGetLastError());
}
