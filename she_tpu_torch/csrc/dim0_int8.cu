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
// product [D * C, d0] x [d0, D * P] with int32 sums; the sums of equal digit
// weight i + j are recombined by Horner's rule mod q, so the output is exact.
//
// Inputs: `digits` int8 [L, N, D * C, K], row i * C + c digit i of column c,
// K = d0 zero-padded to a multiple of 32 (made once per chunk, at server
// build); `query` int64 [d0, P, L, N] in [0, q) in Eval; per-l q and
// Barrett constant floor(2^64 / q). Output int64 [C, P, L, N] in [0, q).
//
// Bound: bytes. A launch must read the int64 query once, the rows x d0
// digits once and write the int64 output once; at 3.35 TB/s (H100 SXM):
//   keyword       C = 31, d0 =  97, P = 256, L = 2, N = 4096, D = 4: 0.6705 ms
//   w32 index     C =  9, d0 =  55, P = 256, L = 2, N = 4096, D = 4: 0.3254 ms
//   keyword_large C = 21, d0 = 228, P =  64, L = 2, N = 4096, D = 4: 0.3586 ms
//   w64 check     C =  4, d0 =  11, P = 256, L = 2, N = 8192, D = 8: 0.1520 ms
// The int8 operations (2.0e11 at the keyword shape) take 0.10 ms at 1,979
// TOPS.
//
// The first design of this kernel (a block per 64 / D query polynomials, 8
// n and all C; phases in turn) reached 12-18% of that bound, 2.4% at the
// w64 check. Timed on an NVIDIA H100 80GB HBM3 at 700 W, its time was in
// the per-k work, not in device-memory bytes: padding K from 128 to 256 at
// the keyword shape, which adds no query bytes, took it from 4.6 to 10.6
// ms. The four causes and what this design does about each:
//   1. A (the digits) was re-read from device memory for every p tile, one
//      L2 round trip per k tile before each mma.sync. Here a block owns one
//      l, NG consecutive n and 16 or 32 rows of every digit plane, loads
//      that A operand into shared memory once (cp.async) and walks every p
//      tile of the launch over it: the digits are read once per launch.
//   2. A block's phases (load, split, MMA, epilogue, store) ran in strict
//      order with at most 2 blocks an SM. Here the raw int64 query streams
//      through a ring of kStages = 4 shared-memory stages of 16 KB (one k
//      tile of 32 j x 64 / NG p x NG n each) filled by cp.async 16-byte
//      pieces (zero-filled past d0 and P) while the warps multiply the
//      stage before: up to 3 stages, 48 KB, in flight an SM, more than the
//      ~25 KB that covers device-memory latency at 3.35 TB/s on 132 SMs.
//   3. Query loads were 64-byte runs issued 8 at a time a thread, with two
//      runtime divisions a value. Here each run is NG * 8 bytes (64 B at
//      NG = 8), a warp's cp.async covers a whole j row of the stage, and
//      every index is a shift of compile-time tile sizes.
//   4. Digits were scattered to shared memory one byte at a time. Here a
//      warp owns one n and 8 p; thread (g, t) reads the 8 raw words of its
//      m16n8k32 B fragment (j = 4t..4t+3 and 4t+16..4t+19 of p = g) and
//      packs the D digit planes' fragments in registers (funnel shifts and
//      byte permutes, four j a 32-bit word), so no digit is stored.
// The epilogue stays exact and needs no shared-memory round trip of the
// int32 sums: each digit plane of A is padded to 16-row m tiles, so a tile
// of A digit i times B digit j accumulates straight into the registers of
// weight i + j: 2D - 1 int32 partials per (c, p) (each below 2^31:
// d0 * 127^2 * D < 2^31, checked by the wrapper). Where the exact dot
// product fits 64 bits (d0 * (2^(7D) - 1)^2 < 2^64: every served w32
// shape) the partials are summed by weight with 32 x 32 -> 64-bit
// multiply-adds and reduced once (Barrett, floor(2^64 / q)); else they are
// folded by Horner's rule, r <- r * 2^7 + partial, reduced only where the
// next step could pass 2^64. Padding rows skip it. The results go through a
// shared-memory tile (XOR-swizzled) to NG * 8-byte runs of the output.
//
// Shared memory a block (A + ring + output tile):
//   A = NG * D * 16 * MT * (K + 16) bytes (rows padded by 16 bytes: the
//   ldmatrix phases fall on distinct banks), ring 4 * 16 KB, output tile
//   MT * 8 KB, MT = m tiles of a digit plane in the block (2 where C > 16,
//   else 1). The launch takes the first (NG, MT) of (8, MT), (4, MT), (8,
//   1), (4, 1), (2, 1) whose block fits the 227 KB a block may use: the
//   query read once in 64-byte runs, then once in 32-byte runs, then once
//   per 16 columns (MT = 1, more blocks along c). So the kernel takes any C
//   and every D * (K + 16) <= 4960 (K up to 1216 at D = 4, 576 at D = 8);
//   the wrapper refuses a deeper K. The served shapes:
//   keyword       MT 2, NG 8: 147,456 + 65,536 + 16,384 = 229,376 B, 1 block/SM
//   w32 index     MT 1, NG 8:  40,960 + 65,536 +  8,192 = 114,688 B, 2 blocks/SM
//   keyword_large MT 2, NG 4: 139,264 + 65,536 + 16,384 = 221,184 B, 1 block/SM
//   w64 check     MT 1, NG 8:  49,152 + 65,536 +  8,192 = 122,880 B, 1 block/SM
// (ptxas: 158, 90, 158 and 146 registers a thread, no spills.) C above 32
// takes more blocks along c (each with its 16 * MT rows of every digit
// plane), which read the query again.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py --only
// dim0): 1.19 ms at the keyword shape (56% of the bound), 0.50 ms at w32
// index (64%), 0.62 ms at keyword_large (58%), 1.30 ms at the w64 check
// (12%: its 4 columns fill a quarter of each 16-row tile). A ring of 3
// stages, or 5 with the output tile in a spent stage, an L2 prefetch hint
// on the query copies, and m16n8k16 products for a last k tile that is
// half padding were each slower or no faster.

#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned int u32;
typedef unsigned long long u64;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMmaK = 32;                           // j a stage (one k tile)
constexpr int kStages = 4;                          // ring depth
constexpr int kStageWords = kMmaK * 64;             // 64 (p, n) pairs a j: 16 KB
constexpr int kStageBytes = kStageWords * 8;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ void mma_s8(int (&c)[4], const u32 (&a)[4], u32 b0, u32 b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(u32 (&a)[4], const void* smem) {
  u32 s = static_cast<u32>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s));
}

// 16 bytes from device memory into shared memory, or 16 zero bytes
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  u32 s = static_cast<u32>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x mod q for x < 2^64, m = floor(2^64 / q): the estimate is floor(x / q) or
// one less, so one conditional subtraction finishes.
__device__ __forceinline__ u64 barrett(u64 x, u64 q, u64 m) {
  u64 r = x - __umul64hi(x, m) * q;
  return r >= q ? r - q : r;
}

// digit d (bits 7d..7d+6) of four residues, one byte each, in one word: the
// four j of one B-fragment register of digit plane d (d is a constant once
// the callers' loops are unrolled)
__device__ __forceinline__ u32 digit_word(const uint2 (&x)[4], int d) {
  u32 u[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    u[r] = 7 * d >= 32 ? x[r].y >> (7 * d - 32) : __funnelshift_r(x[r].x, x[r].y, 7 * d);
  const u32 lo = __byte_perm(u[0], u[1], 0x0040), hi = __byte_perm(u[2], u[3], 0x0040);
  return __byte_perm(lo, hi, 0x5410) & 0x7F7F7F7Fu;
}

struct Dims {
  int C, d0, K, P, L, N, rows;  // rows = D * C, the digits' row count
  int lg_ng;                    // log2 of NG, the n a block (1, 2 or 3)
  int c_groups;                 // blocks along c, each 16 * MT rows of a digit plane
  int k_tiles, p_tiles;         // K / 32, ceil(P / TP), TP = 64 / NG
  int exact64;                  // d0 * (2^(7D) - 1)^2 < 2^64: the exact sums fit 64 bits
};

__host__ __device__ constexpr int a_row_bytes(int K) { return K + 16; }

template <int D, int MT>
__global__ void __launch_bounds__(kThreads, 1)
    dim0_int8_kernel(const int8_t* __restrict__ digits, const u64* __restrict__ query,
                     u64* __restrict__ out, const u64* __restrict__ moduli,
                     const u64* __restrict__ barrett_m, Dims s) {
  constexpr int kW = 2 * D - 1;  // digit weights
  constexpr int kRows = 16 * MT;  // rows of a digit plane in the block
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int NG = 1 << s.lg_ng, TP = 64 >> s.lg_ng, lg_tp = 6 - s.lg_ng;
  const int rs = a_row_bytes(s.K);

  const int cg = blockIdx.x % s.c_groups;
  const int ln = blockIdx.x / s.c_groups;
  const int n_groups = s.N >> s.lg_ng;
  const int l = ln / n_groups, n0 = (ln % n_groups) << s.lg_ng;
  const int c0 = cg * kRows;

  unsigned char* a_smem = smem;                                      // [NG][D][kRows][rs]
  u64* ring = reinterpret_cast<u64*>(smem + NG * D * kRows * rs);   // [kStages][32][TP][NG]
  u64* tile = ring + kStages * kStageWords;                          // [kRows][TP][NG]

  // the block's A: rows c0..c0 + kRows of every digit plane of its NG n,
  // zero past C (one cp.async group with the first stage)
  {
    const int chunks_a_row = s.K >> 4;
    const int total = NG * D * kRows * chunks_a_row;
    for (int v = tid; v < total; v += kThreads) {
      const int chunk = v % chunks_a_row, row = v / chunks_a_row;
      const int cl = row % kRows, nd = row / kRows, i = nd % D, n = nd / D;
      const int c = c0 + cl;
      const bool valid = c < s.C;
      const int8_t* src =
          valid ? digits + (((long long)l * s.N + n0 + n) * s.rows + i * s.C + c) * s.K + chunk * 16
                : digits;
      cp_async16(a_smem + row * rs + chunk * 16, src, valid);
    }
  }

  // one stage: query[j, p, l, n0..n0 + NG] for 32 j of k tile kt and TP p of
  // p tile pt; 16-byte pieces (2 n), 32 of them a j; the pair index is
  // XOR-swizzled by bits 2-3 of j so that the B-fragment reads below meet at
  // most 2-way bank conflicts
  const long long p_stride = (long long)s.L * s.N;
  const u64* q_base = query + (long long)l * s.N + n0;
  auto issue = [&](int pt, int kt, int buf) {
    u64* dst = ring + buf * kStageWords;
#pragma unroll
    for (int r = 0; r < kStageWords / 2 / kThreads; ++r) {
      const int v = r * kThreads + tid;
      const int j = v >> 5, pn = v & 31;
      const int np = pn & ((NG >> 1) - 1), p = pn >> (s.lg_ng - 1);
      const int jj = kt * kMmaK + j, pp = pt * TP + p;
      const bool valid = jj < s.d0 && pp < s.P;
      const int sw = ((j >> 2) & 3) << 1 & (NG - 1);
      const u64* src = valid ? q_base + ((long long)jj * s.P + pp) * p_stride + 2 * np : query;
      cp_async16(dst + ((j << lg_tp) + p) * NG + ((2 * np) ^ sw), src, valid);
    }
  };

  const int total = s.p_tiles * s.k_tiles;
  int ipt = 0, ikt = 0;  // the next stage to issue
#pragma unroll
  for (int b = 0; b < kStages - 1; ++b) {
    if (b < total) {
      issue(ipt, ikt, b);
      if (++ikt == s.k_tiles) ikt = 0, ++ipt;
    }
    cp_async_commit();
  }

  const int wn = warp & (NG - 1);  // the warp's n and 8 p of the tile
  const int wp = (warp >> s.lg_ng) * 8;
  const u64 q = moduli[l], m = barrett_m[l];
  // ldmatrix: lanes 0-15 address rows 0-15 at byte 0, lanes 16-31 at byte 16
  const unsigned char* a_warp = a_smem + (wn * D * kRows + (lane & 15)) * rs + (lane >> 4) * 16;

  int acc[kW][MT][4];
  int pt = 0, kt = 0;
  for (int st = 0; st < total; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage st landed for every thread; stage st - 1 is free
    if (st + kStages - 1 < total) {
      issue(ipt, ikt, (st + kStages - 1) % kStages);
      if (++ikt == s.k_tiles) ikt = 0, ++ipt;
    }
    cp_async_commit();

    if (kt == 0) {
#pragma unroll
      for (int w = 0; w < kW; ++w)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) acc[w][mt][0] = acc[w][mt][1] = acc[w][mt][2] = acc[w][mt][3] = 0;
    }
    // B fragments: 8 raw words of this thread's p, j = 4t..4t+3, 4t+16..4t+19
    const u64* stage = ring + (st % kStages) * kStageWords;
    uint2 x0[4], x1[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j0 = 4 * t + r, j1 = j0 + 16;
      const int sw = (t << 1) & (NG - 1);  // bits 2-3 of j0 and j1 are t
      x0[r] = *reinterpret_cast<const uint2*>(stage + ((j0 << lg_tp) + wp + g) * NG + (wn ^ sw));
      x1[r] = *reinterpret_cast<const uint2*>(stage + ((j1 << lg_tp) + wp + g) * NG + (wn ^ sw));
    }
    u32 b[D][2];
#pragma unroll
    for (int d = 0; d < D; ++d) b[d][0] = digit_word(x0, d), b[d][1] = digit_word(x1, d);
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        u32 a[4];
        ldmatrix_x4(a, a_warp + (i * kRows + mt * 16) * rs + kt * kMmaK);
#pragma unroll
        for (int j = 0; j < D; ++j) mma_s8(acc[i + j][mt], a, b[j][0], b[j][1]);
      }
    }

    if (kt == s.k_tiles - 1) {
      // epilogue of p tile pt: the weights recombined mod q, into the tile
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = mt * 16 + g + (e >> 1) * 8, pl = wp + 2 * t + (e & 1);
          if (c0 + cl >= s.C) continue;  // padding rows
          u64 r = 0;
          if (s.exact64) {
            // the exact dot product fits 64 bits: sum the weights in groups
            // of four (32 x 32 -> 64-bit multiply-adds), join the groups,
            // reduce once
#pragma unroll
            for (int k = (kW - 1) / 4; k >= 0; --k) {
              u64 group = 0;
#pragma unroll
              for (int i = 0; i < 4; ++i)
                if (4 * k + i < kW) group += (u64)(u32)acc[4 * k + i][mt][e] * (1u << (7 * i));
              r = (r << 28) + group;
            }
          } else {
            // Horner's rule, r <- r * 2^7 + partial, reduced where the next
            // step could pass 2^64
            r = (u32)acc[kW - 1][mt][e];
            int bits = 31;  // r < 2^bits; resolved at compile time
#pragma unroll
            for (int w = kW - 2; w >= 0; --w) {
              if (bits + 8 > 64) r = barrett(r, q, m), bits = 7 * D;
              r = (r << 7) + (u32)acc[w][mt][e];
              bits = (bits + 7 > 31 ? bits + 7 : 31) + 1;
            }
          }
          r = barrett(r, q, m);
          const int h = (((pl >> 1) & 3) | ((cl & 1) << 2)) & (NG - 1);
          tile[((cl << lg_tp) + pl) * NG + (wn ^ h)] = r;
        }
      }
      __syncthreads();
      // the tile to out[c, p, l, n0..n0 + NG], NG * 8-byte runs
      for (int v = tid; v < kRows * 64; v += kThreads) {
        const int n = v & (NG - 1), pl = (v >> s.lg_ng) & (TP - 1), cl = v >> 6;
        const int c = c0 + cl, p = pt * TP + pl;
        if (c < s.C && p < s.P) {
          const int h = (((pl >> 1) & 3) | ((cl & 1) << 2)) & (NG - 1);
          out[((long long)c * s.P + p) * p_stride + (long long)l * s.N + n0 + n] =
              tile[((cl << lg_tp) + pl) * NG + (n ^ h)];
        }
      }
      kt = 0, ++pt;
    } else {
      ++kt;
    }
  }
  cp_async_wait<0>();
}

size_t smem_bytes(int D, int MT, int NG, int K) {
  return (size_t)NG * D * 16 * MT * a_row_bytes(K) + (size_t)kStages * kStageBytes +
         (size_t)16 * MT * 64 * 8;
}

template <int D, int MT>
int launch(const int8_t* digits, const u64* query, u64* out, const u64* moduli,
           const u64* barrett_m, Dims s, size_t smem, cudaStream_t stream) {
  auto kernel = dim0_int8_kernel<D, MT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (long long)s.c_groups * s.L * (s.N >> s.lg_ng);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(digits, query, out, moduli,
                                                                     barrett_m, s);
  return static_cast<int>(cudaGetLastError());
}

template <int MT>
int launch_d(int D, const int8_t* digits, const u64* query, u64* out, const u64* moduli,
             const u64* barrett_m, Dims s, size_t smem, cudaStream_t stream) {
  switch (D) {
#define SHE_D(d) \
  case d:        \
    return launch<d, MT>(digits, query, out, moduli, barrett_m, s, smem, stream);
    SHE_D(1) SHE_D(2) SHE_D(3) SHE_D(4) SHE_D(5) SHE_D(6) SHE_D(7) SHE_D(8)
#undef SHE_D
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
  if (C < 1 || D < 1 || D > 8 || d0 < 1 || K < d0 || K % kMmaK || P < 1 || L < 1 || N < 8 ||
      N % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  // the first layout whose block fits: the query read once with 64-byte
  // runs, then once with 32-byte runs, then once per 16 columns
  const int m_tiles = (C + 15) / 16;
  const int mt0 = m_tiles == 1 ? 1 : 2;
  const int layouts[5][2] = {{8, mt0}, {4, mt0}, {8, 1}, {4, 1}, {2, 1}};  // {NG, MT}
  int NG = 0, MT = 0;
  for (const auto& ly : layouts)
    if (smem_bytes(D, ly[1], ly[0], K) <= kMaxSmem) {
      NG = ly[0], MT = ly[1];
      break;
    }
  if (NG == 0) return static_cast<int>(cudaErrorInvalidValue);  // D * (K + 16) > 4960
  const size_t smem = smem_bytes(D, MT, NG, K);
  Dims s;
  s.C = C, s.d0 = d0, s.K = K, s.P = P, s.L = L, s.N = N, s.rows = D * C;
  s.lg_ng = NG == 8 ? 3 : NG == 4 ? 2 : 1;
  s.c_groups = (m_tiles + MT - 1) / MT;
  s.k_tiles = K / kMmaK;
  s.p_tiles = (P + (64 / NG) - 1) / (64 / NG);
  const unsigned __int128 top = ((unsigned __int128)1 << (7 * D)) - 1;
  s.exact64 = (unsigned __int128)d0 * top * top < ((unsigned __int128)1 << 64);
  const auto* dg = static_cast<const int8_t*>(digits);
  const auto* qy = static_cast<const u64*>(query);
  auto* o = static_cast<u64*>(out);
  const auto* qm = static_cast<const u64*>(moduli);
  const auto* bm = static_cast<const u64*>(barrett_m);
  auto st = static_cast<cudaStream_t>(stream);
  return MT == 1 ? launch_d<1>(D, dg, qy, o, qm, bm, s, smem, st)
                 : launch_d<2>(D, dg, qy, o, qm, bm, s, smem, st);
}
