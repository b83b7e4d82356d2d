// Dim-0 ct-pt inner products as int8 digit products on the tensor cores, for
// Hopper (sm_90a).
//
// Replaces she_tpu/pir/serving.py:222 dim0_inner_products_mxu, the form of
// dim-0 she_tpu serves on its accelerator at w32 (the MXU digit matmuls),
// and is bit-identical to it and to the int64 lazy MAC
// (she_tpu_torch/pir/serving.py dim0_inner_products).
//
// Function: out[c, p, l, n] = sum_j db[c, j, l, n] * query[j, p, l, n] mod
// q_l, for a database chunk of C columns of d0 plaintexts and P query
// polynomials (two a query). Every residue is D base-2^7 digits in [0, 127]
// (D = ceil(bits(q) / 7), D <= 8, so q < 2^56), and each (l, n) is the int8
// product [D * C, d0] x [d0, D * P] with int32 sums; the partial sums of
// equal digit weight i + j are recombined by Horner's rule and reduced mod q
// in the epilogue, so the output is exact.
//
// Inputs: `digits` int8 [L, N, D * C, K], row i * C + c digit i of column c,
// K = d0 zero-padded to a multiple of 32 (made once per chunk, at server
// build); `query` int64 [d0, P, L, N] in [0, q) in Eval; per-l q and
// Barrett constant floor(2^64 / q). Output int64 [C, P, L, N] in [0, q).
//
// Bound: bytes. At the keyword cell's shape (C = 31, d0 = 97, P = 256,
// L = 2, N = 4096, D = 4) a launch reads 1.63 GB of query and 0.10 GB of
// digits and writes 0.52 GB, 0.67 ms at 3.35 TB/s; its 2.0e11 int8
// operations are 0.10 ms at 1,979 TOPS.
//
// Design (simple and right first; no wgmma, no TMA, no pipelining):
//   1. A block takes one l, 8 consecutive n and a tile of TP = 64 / D query
//      polynomials, with all C columns and all d0, so the int64 query is
//      read from device memory once. Its threads load the query tile with
//      n fastest (64-byte runs), split each residue into D digits as they
//      load it, and scatter the digits into shared memory as the B operand
//      of each n: [64 columns (digit d of local p at column d * TP + p)][K]
//      bytes, rows padded by 16 bytes and planes by 16 bytes so that both
//      the scatter and the fragment loads are free of bank conflicts.
//      Padding (j >= d0, p >= P, columns >= D * TP) is written as zeros.
//   2. For each of the 8 n: the warps run mma.sync m16n8k32 s8 x s8 -> s32
//      over [ceil(D * C / 16) m-tiles] x [8 column tiles] x [K / 32]; the A
//      fragments come straight from the digits in device memory (rows past
//      D * C load as zeros), the B fragments from shared memory. The int32
//      tiles go to shared memory.
//   3. The epilogue of that n: each (c, p) sums its D x D digit products by
//      weight into 2D - 1 partials (each below 2^31: d0 * 127^2 * D < 2^31
//      is checked by the wrapper) and folds them, r <- (r * 2^7 + partial)
//      mod q, with a Barrett reduction of a 64-bit value (r < q < 2^56, so
//      r * 2^7 + partial < 2^64). The int64 results go to the n's plane,
//      whose B operand is no longer needed.
//   4. The block writes its [C, TP, 8] results with n fastest (64-byte runs).

#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned int u32;
typedef unsigned long long u64;

namespace {

constexpr int kTn = 8;          // n positions a block
constexpr int kCols = 64;       // GEMM columns a block: D * TP <= 64
constexpr int kColTiles = kCols / 8;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMmaK = 32;
constexpr int kAccStride = kCols + 8;  // int32 words a row of the tile sums
constexpr int kLoadBatch = 8;          // query loads in flight a thread

__device__ __forceinline__ void mma_s8(int (&c)[4], u32 a0, u32 a1, u32 a2, u32 a3, u32 b0,
                                       u32 b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// x mod q for x < 2^64, m = floor(2^64 / q): the estimate is floor(x / q) or
// one less, so one conditional subtraction finishes.
__device__ __forceinline__ u64 barrett(u64 x, u64 q, u64 m) {
  u64 r = x - __umul64hi(x, m) * q;
  return r >= q ? r - q : r;
}

struct Dims {
  int C, D, d0, K, P, L, N, TP, rows, m_tiles, plane_bytes;
};

__host__ __device__ inline int plane_bytes_of(int C, int D, int K) {
  int tp = kCols / D;
  int b = kCols * (K + 16);
  int out = C * tp * 8;
  if (out > b) b = (out + 127) / 128 * 128;
  return b + 16;  // 4 words mod 32: the planes fall on different banks
}

__global__ void __launch_bounds__(kThreads)
    dim0_int8_kernel(const int8_t* __restrict__ digits, const u64* __restrict__ query,
                     u64* __restrict__ out, const u64* __restrict__ moduli,
                     const u64* __restrict__ barrett_m, Dims s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rs = s.K + 16;  // bytes a B row (one column of the GEMM)

  const int p_tiles = (s.P + s.TP - 1) / s.TP;
  const int n_tiles = s.N / kTn;
  const int p_tile = blockIdx.x % p_tiles;
  const int nt = blockIdx.x / p_tiles;
  const int l = nt / n_tiles;
  const int n0 = (nt % n_tiles) * kTn;
  const int p0 = p_tile * s.TP;
  unsigned char* planes = smem;
  int* acc_tile = reinterpret_cast<int*>(smem + kTn * s.plane_bytes);

  // 1. the query tile's digits, B operands of the 8 n
  if (s.D * s.TP < kCols) {  // columns past D * TP stay zero
    uint4* w = reinterpret_cast<uint4*>(planes);
    for (int i = tid; i < kTn * s.plane_bytes / 16; i += kThreads) w[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  const long long plane_stride = (long long)s.L * s.N;  // between consecutive p
  const int values = s.K * s.TP * kTn;                  // j < K: padding included
  for (int base = 0; base < values; base += kThreads * kLoadBatch) {
    u64 x[kLoadBatch];
#pragma unroll
    for (int r = 0; r < kLoadBatch; ++r) {
      int v = base + r * kThreads + tid;
      int n = v & 7, jl = (v >> 3) & 3, rest = v >> 5;
      int p = rest % s.TP, j = (rest / s.TP) * 4 + jl;
      x[r] = 0;
      if (v < values && j < s.d0 && p0 + p < s.P)
        x[r] = query[((long long)j * s.P + p0 + p) * plane_stride + (long long)l * s.N + n0 + n];
    }
#pragma unroll
    for (int r = 0; r < kLoadBatch; ++r) {
      int v = base + r * kThreads + tid;
      if (v >= values) continue;
      int n = v & 7, jl = (v >> 3) & 3, rest = v >> 5;
      int p = rest % s.TP, j = (rest / s.TP) * 4 + jl;
      unsigned char* dst = planes + n * s.plane_bytes + p * rs + j;
      for (int d = 0; d < s.D; ++d) dst[d * s.TP * rs] = (unsigned char)((x[r] >> (7 * d)) & 0x7F);
    }
  }
  __syncthreads();

  // warps split the [m_tiles x 8 column tiles] products of one n
  const int warps_per_m = s.m_tiles >= kWarps ? 1 : kWarps / s.m_tiles;
  const int tiles_per_item = (kColTiles + warps_per_m - 1) / warps_per_m;
  const int items = s.m_tiles * warps_per_m;
  const int k_tiles = s.K / kMmaK;
  const u64 q = moduli[l], m = barrett_m[l];
  const int outs = s.C * s.TP;

  for (int n = 0; n < kTn; ++n) {
    const unsigned char* bplane = planes + n * s.plane_bytes;
    const int8_t* a_base = digits + ((long long)l * s.N + n0 + n) * s.rows * s.K;
    // 2. int8 products on the tensor cores
    for (int item = warp; item < items; item += kWarps) {
      const int mt = item / warps_per_m;
      const int ct0 = (item % warps_per_m) * tiles_per_item;
      const int row0 = mt * 16 + g, row1 = row0 + 8;
      int acc[kColTiles][4];
#pragma unroll
      for (int c = 0; c < kColTiles; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0;
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int k = kt * kMmaK + t * 4;
        u32 a0 = 0, a1 = 0, a2 = 0, a3 = 0;
        if (row0 < s.rows) {
          a0 = *reinterpret_cast<const u32*>(a_base + (long long)row0 * s.K + k);
          a2 = *reinterpret_cast<const u32*>(a_base + (long long)row0 * s.K + k + 16);
        }
        if (row1 < s.rows) {
          a1 = *reinterpret_cast<const u32*>(a_base + (long long)row1 * s.K + k);
          a3 = *reinterpret_cast<const u32*>(a_base + (long long)row1 * s.K + k + 16);
        }
#pragma unroll
        for (int c = 0; c < kColTiles; ++c) {
          if (c < tiles_per_item && ct0 + c < kColTiles) {
            const unsigned char* b = bplane + ((ct0 + c) * 8 + g) * rs + k;
            u32 b0 = *reinterpret_cast<const u32*>(b);
            u32 b1 = *reinterpret_cast<const u32*>(b + 16);
            mma_s8(acc[c], a0, a1, a2, a3, b0, b1);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kColTiles; ++c) {
        if (c < tiles_per_item && ct0 + c < kColTiles) {
          const int col = (ct0 + c) * 8 + t * 2;
          *reinterpret_cast<int2*>(acc_tile + row0 * kAccStride + col) = make_int2(acc[c][0], acc[c][1]);
          *reinterpret_cast<int2*>(acc_tile + row1 * kAccStride + col) = make_int2(acc[c][2], acc[c][3]);
        }
      }
    }
    __syncthreads();
    // 3. partials by digit weight, folded mod q; results into plane n
    u64* result = reinterpret_cast<u64*>(planes + n * s.plane_bytes);
    for (int o = tid; o < outs; o += kThreads) {
      const int c = o / s.TP, p = o % s.TP;
      u64 r = 0;
      for (int k = 2 * s.D - 2; k >= 0; --k) {
        const int i_lo = k - s.D + 1 > 0 ? k - s.D + 1 : 0;
        const int i_hi = k < s.D - 1 ? k : s.D - 1;
        u64 partial = 0;
        for (int i = i_lo; i <= i_hi; ++i)
          partial += (u32)acc_tile[(i * s.C + c) * kAccStride + (k - i) * s.TP + p];
        r = barrett((r << 7) + partial, q, m);
      }
      result[o] = r;
    }
    __syncthreads();
  }

  // 4. the block's results, n fastest
  for (int o = tid; o < outs * kTn; o += kThreads) {
    const int n = o % kTn, cp = o / kTn;
    const int c = cp / s.TP, p = cp % s.TP;
    if (p0 + p >= s.P) continue;
    out[(((long long)c * s.P + p0 + p) * s.L + l) * s.N + n0 + n] =
        reinterpret_cast<const u64*>(planes + n * s.plane_bytes)[cp];
  }
}

}  // namespace

// Plain C interface for ctypes. `digits`, `query`, `out`, `moduli` and
// `barrett_m` are device pointers of contiguous tensors: int8
// [L, N, D * C, K], int64 [d0, P, L, N], int64 [C, P, L, N], and int64 [L]
// (q_l < 2^56 and floor(2^64 / q_l)); `stream` is a cudaStream_t. The
// wrapper checks shapes, types and the int32 bound. Returns a cudaError_t
// value (0 on success) covering the launch itself.
extern "C" int she_dim0_int8(const void* digits, const void* query, void* out,
                             const void* moduli, const void* barrett_m, int C, int D, int d0,
                             int K, int P, int L, int N, void* stream) {
  if (C < 1 || D < 1 || D > 8 || d0 < 1 || K < d0 || K % kMmaK || P < 1 || L < 1 || N < kTn ||
      N % kTn)
    return static_cast<int>(cudaErrorInvalidValue);
  Dims s;
  s.C = C, s.D = D, s.d0 = d0, s.K = K, s.P = P, s.L = L, s.N = N;
  s.TP = kCols / D;
  s.rows = D * C;
  s.m_tiles = (s.rows + 15) / 16;
  s.plane_bytes = plane_bytes_of(C, D, K);
  size_t smem = (size_t)kTn * s.plane_bytes + (size_t)s.m_tiles * 16 * kAccStride * 4;
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = dim0_int8_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (long long)((P + s.TP - 1) / s.TP) * L * (N / kTn);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(digits), static_cast<const u64*>(query), static_cast<u64*>(out),
      static_cast<const u64*>(moduli), static_cast<const u64*>(barrett_m), s);
  return static_cast<int>(cudaGetLastError());
}
