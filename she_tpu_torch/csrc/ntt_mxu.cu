// One phase of the matrix NTT (she_tpu_torch/ops/ntt_mxu.py) as int8 digit
// products on the tensor cores, for Hopper (sm_90a).
//
// Replaces she_tpu/ops/ntt_mxu.py:310 _phase_row and :330 _phase_block,
// the jnp einsums (:319, :339) of she_tpu's opt-in NTT (SHE_TPU_NTT_MXU=1),
// and is bit-identical to the port's plain version (ntt_mxu.phase_plain).
//
// Function: for x int64 [batch, L, A, 64] in [0, q) (N = 64 A),
//   row phase (Lf, Li):   out[., l, u, b] = sum_a M[l, u, a] x[., l, a, b] mod q_l
//   block phase (Rf, Ri): out[., l, a, u] = sum_b M[l, a, u, b] x[., l, a, b] mod q_l
// with M given as D base-2^7 digit planes in [0, 127] (D = ceil(bits(q) / 7),
// D <= 9, so q < 2^62): int8 [L, D, A, A] (row) or [L, D, A, 64, 64]
// (block). Both are one product out[g, u, p] = sum_k M[l(g), h(g), u, k]
// x[g, k, p] read through strides, with no permute copies: the row phase
// takes group g = l, k = a (stride 64), p = (batch, b); the block phase g =
// (l, a), k = b (stride 1), p = batch. Each weight i + j of the digit
// products, i of M and j of x, is summed in int32 (below 2^31: K * 127^2 * D
// with K <= 128, D <= 9, checked by the tables); the 2D - 1 weights are
// recombined and reduced mod q in the epilogue, so the output is exact.
//
// Bound (H100 SXM: 3.35 TB/s, 1,979 dense int8 TOPS): the larger of the
// bytes (x read once, out written once as int64, the digit planes once) and
// the int8 operations (2 D^2 K per output). At the widest launch of the
// w32 cell, [32, 128, 2, 3, 4096] (A = 64, D = 4), a phase moves 1.61 GB
// (0.48 ms) and does 2.1e11 operations (0.10 ms): bytes bind. At the w64
// cell's [7, 128, 2, 3, 8192] (A = 128, D = 8) a phase moves 0.70 GB (0.21
// ms); the row phase does 7.2e11 operations (0.365 ms) and the block phase
// 3.6e11 (0.18 ms): operations bind the row phase.
//
// Design (a first, simple kernel: right before fast). A block takes one
// group and 64 columns: it copies the raw int64 tile x[k, p] (K rows, zero
// past K up to a multiple of 32 and past the last column) into shared
// memory with 8-byte cp.async pieces, coalesced along whichever of k and p
// has stride 1; the rows are 65 words apart, so the B-fragment reads below
// meet no bank conflict. Each of the 8 warps owns 8 columns and walks every
// 16-row m tile of the output: per 32-deep k tile it reads the 8 raw words
// of its m16n8k32 B fragment (k = 4t..4t+3 and 4t+16..4t+19 of column g),
// makes the D digit planes' fragments in registers (funnel shifts and byte
// permutes), reads each A digit plane's fragment straight from device
// memory (four 32-bit loads; the planes are shared by many blocks and stay
// in L2), and issues the D^2 mma.sync s8 products into 2D - 1 int32
// accumulators by weight. At A < 16 the m tile is padded with zero rows and
// at A < 32 the k tile with zero columns. The epilogue: where the exact sum
// fits 64 bits (K (q - 1)^2 < 2^64, the w32 cell) the weights are summed and
// reduced once (Barrett, floor(2^64 / q)); else four weights at a time are
// summed (below 2^53), reduced, and folded by Horner's rule
// r <- r * 2^28 + group mod q, the product by 2^28 mod q a Shoup step
// (__umul64hi), which is exact for every q < 2^62, the 60-bit moduli too.
// Results go straight to device memory. A fused two-phase kernel (wgmma,
// TMA, X kept in shared memory between the phases) is later work.

#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned int u32;
typedef unsigned long long u64;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileCols = 8 * kWarps;  // columns a block: 8 a warp
constexpr int kPitch = kTileCols + 1;  // words a shared-memory row
constexpr int kMaxA = 128;

__device__ __forceinline__ void mma_s8(int (&c)[4], const u32 (&a)[4], u32 b0, u32 b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 bytes from device memory into shared memory, or 8 zero bytes
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, bool valid) {
  u32 s = static_cast<u32>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// x mod q for x < 2^64, m = floor(2^64 / q): the estimate is floor(x / q)
// or one less, so one conditional subtraction finishes
__device__ __forceinline__ u64 barrett(u64 x, u64 q, u64 m) {
  u64 r = x - __umul64hi(x, m) * q;
  return r >= q ? r - q : r;
}

// r * w mod q for any r < 2^64, w < q < 2^63, ws = floor(w * 2^64 / q)
__device__ __forceinline__ u64 shoup(u64 r, u64 w, u64 ws, u64 q) {
  u64 v = r * w - __umul64hi(r, ws) * q;
  return v >= q ? v - q : v;
}

// digit d (bits 7d..7d+6) of four residues, one byte each, in one word: the
// four k of one B-fragment register of digit plane d
__device__ __forceinline__ u32 digit_word(const uint2 (&x)[4], int d) {
  u32 u[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    u[r] = 7 * d >= 32 ? x[r].y >> (7 * d - 32) : __funnelshift_r(x[r].x, x[r].y, 7 * d);
  const u32 lo = __byte_perm(u[0], u[1], 0x0040), hi = __byte_perm(u[2], u[3], 0x0040);
  return __byte_perm(lo, hi, 0x5410) & 0x7F7F7F7Fu;
}

// four digits M[u, k..k+3] of a row-major [K, K] digit plane, zero past the
// edge (k is a multiple of 4; K is a power of two)
__device__ __forceinline__ u32 a_word(const int8_t* __restrict__ m, int u, int k, int K) {
  if (u >= K || k >= K) return 0u;
  if (K >= 4) return __ldg(reinterpret_cast<const u32*>(m + u * K + k));
  u32 w = 0;
  for (int e = 0; e < 4 && k + e < K; ++e) w |= static_cast<u32>(static_cast<uint8_t>(m[u * K + k + e])) << (8 * e);
  return w;
}

struct Dims {
  int A, L, row;   // row: the row phase (Lf, Li), else the block phase (Rf, Ri)
  int K, lg_kp;    // contraction length (= output rows): A or 64; log2 of K padded to 32
  int exact64;     // K (max q - 1)^2 < 2^64: the exact sum fits 64 bits
  long long batch; // polynomials of L rows
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    ntt_mxu_phase_kernel(const int8_t* __restrict__ M, const u64* __restrict__ x, u64* __restrict__ out,
                         const u64* __restrict__ consts, Dims s) {
  constexpr int kW = 2 * D - 1;  // digit weights
  extern __shared__ __align__(16) u64 tile[];  // [KP][kPitch]: x[k, column]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int K = s.K, KP = 1 << s.lg_kp, N = s.A * 64;
  const long long LN = static_cast<long long>(s.L) * N;
  const long long ct = blockIdx.x;  // column tile
  const int l = s.row ? blockIdx.y : blockIdx.y / s.A;
  const int h = s.row ? 0 : blockIdx.y % s.A;  // the block phase's row a
  const int sk = s.row ? 64 : 1;               // stride of k (and of the output row u)
  const long long base = static_cast<long long>(l) * N + h * 64;

  // offset of column c of the tile from `base`, or -1 past the last polynomial
  auto column = [&](int c) -> long long {
    if (s.row) return ct * LN + c;  // one polynomial a tile, its 64 b
    const long long p = ct * kTileCols + c;
    return p < s.batch ? p * LN : -1;
  };

  for (int e = tid; e < KP * kTileCols; e += kThreads) {
    int k, c;
    if (sk == 1) {  // consecutive threads along k
      k = e & (KP - 1), c = e >> s.lg_kp;
    } else {  // along the 64 b
      c = e & (kTileCols - 1), k = e / kTileCols;
    }
    const long long off = column(c);
    const bool valid = k < K && off >= 0;
    cp_async8(tile + k * kPitch + c, valid ? x + base + static_cast<long long>(k) * sk + off : x, valid);
  }
  cp_async_wait_all();
  __syncthreads();

  const int c0 = warp * 8;  // the warp's 8 columns
  if (column(c0) < 0) return;  // past the last polynomial (block phase)
  const long long plane = static_cast<long long>(s.row ? 1 : s.A) * K * K;  // one digit plane of every h
  const int8_t* m_base = M + (static_cast<long long>(l) * D * (s.row ? 1 : s.A) + h) * K * K;
  const u64 q = consts[l], bm = consts[s.L + l], w28 = consts[2 * s.L + l], w28s = consts[3 * s.L + l];
  const int m_tiles = (K + 15) >> 4, k_tiles = KP >> 5;

  for (int mt = 0; mt < m_tiles; ++mt) {
    int acc[kW][4];
#pragma unroll
    for (int w = 0; w < kW; ++w) acc[w][0] = acc[w][1] = acc[w][2] = acc[w][3] = 0;
    for (int kt = 0; kt < k_tiles; ++kt) {
      uint2 x0[4], x1[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k0 = kt * 32 + 4 * t + r;
        x0[r] = *reinterpret_cast<const uint2*>(tile + k0 * kPitch + c0 + g);
        x1[r] = *reinterpret_cast<const uint2*>(tile + (k0 + 16) * kPitch + c0 + g);
      }
      u32 b[D][2];
#pragma unroll
      for (int d = 0; d < D; ++d) b[d][0] = digit_word(x0, d), b[d][1] = digit_word(x1, d);
      const int u0 = mt * 16 + g, k0 = kt * 32 + 4 * t;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const int8_t* m = m_base + i * plane;
        const u32 a[4] = {a_word(m, u0, k0, K), a_word(m, u0 + 8, k0, K), a_word(m, u0, k0 + 16, K),
                          a_word(m, u0 + 8, k0 + 16, K)};
#pragma unroll
        for (int j = 0; j < D; ++j) mma_s8(acc[i + j], a, b[j][0], b[j][1]);
      }
    }
    // epilogue: element e is row u0 + 8 (e >> 1), column c0 + 2t + (e & 1)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int u = mt * 16 + g + (e >> 1) * 8;
      const long long off = column(c0 + 2 * t + (e & 1));
      if (u >= K || off < 0) continue;
      u64 r = 0;
      if (s.exact64) {
        // every weight with 7w >= 64 is 0 when the exact sum is below 2^64
#pragma unroll
        for (int w = 0; w < kW; ++w)
          if (7 * w < 64) r += static_cast<u64>(static_cast<u32>(acc[w][e])) << (7 * w);
        r = barrett(r, q, bm);
      } else {
#pragma unroll
        for (int k4 = (kW - 1) / 4; k4 >= 0; --k4) {
          u64 group = 0;  // below 2^31 (1 + 2^7 + 2^14 + 2^21) < 2^53
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (4 * k4 + i < kW) group += static_cast<u64>(static_cast<u32>(acc[4 * k4 + i][e])) << (7 * i);
          r = shoup(r, w28, w28s, q) + barrett(group, q, bm);
          r = r >= q ? r - q : r;
        }
      }
      out[base + static_cast<long long>(u) * sk + off] = r;
    }
  }
}

template <int D>
int launch(const int8_t* M, const u64* x, u64* out, const u64* consts, Dims s, unsigned col_tiles,
           unsigned groups, cudaStream_t stream) {
  auto kernel = ntt_mxu_phase_kernel<D>;
  const size_t smem = static_cast<size_t>(1 << s.lg_kp) * kPitch * sizeof(u64);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(col_tiles, groups), kThreads, smem, stream>>>(M, x, out, consts, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. `M`, `x`, `out` and `consts` are device
// pointers of contiguous tensors: int8 digit planes [L, D, A, A] (row == 1)
// or [L, D, A, 64, 64] (row == 0), int64 [batch, L, 64 A] in and out, and
// int64 [4, L]: q_l < 2^62, floor(2^64 / q_l), 2^28 mod q_l and its Shoup
// constant floor((2^28 mod q_l) 2^64 / q_l). `exact64` says K (max q - 1)^2
// < 2^64; `stream` is a cudaStream_t. The wrapper checks shapes, types and
// the int32 bound. Returns a cudaError_t value (0 on success) covering the
// launch itself.
extern "C" int she_ntt_mxu_phase(const void* M, const void* x, void* out, const void* consts, int D, int A,
                                 int L, int row, int exact64, long long batch, void* stream) {
  if (D < 1 || D > 9 || A < 2 || A > kMaxA || (A & (A - 1)) || L < 1 || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Dims s;
  s.A = A, s.L = L, s.row = row != 0, s.exact64 = exact64 != 0, s.batch = batch;
  s.K = s.row ? A : 64;
  s.lg_kp = 5;
  while ((1 << s.lg_kp) < s.K) ++s.lg_kp;
  const long long groups = s.row ? L : static_cast<long long>(L) * A;
  const long long col_tiles = s.row ? batch : (batch + kTileCols - 1) / kTileCols;
  if (groups > 65535 || col_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto* m = static_cast<const int8_t*>(M);
  const auto* xi = static_cast<const u64*>(x);
  auto* o = static_cast<u64*>(out);
  const auto* c = static_cast<const u64*>(consts);
  auto st = static_cast<cudaStream_t>(stream);
  const auto ct = static_cast<unsigned>(col_tiles), gr = static_cast<unsigned>(groups);
  switch (D) {
#define SHE_D(d) \
  case d:        \
    return launch<d>(m, xi, o, c, s, ct, gr, st);
    SHE_D(1) SHE_D(2) SHE_D(3) SHE_D(4) SHE_D(5) SHE_D(6) SHE_D(7) SHE_D(8) SHE_D(9)
#undef SHE_D
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
