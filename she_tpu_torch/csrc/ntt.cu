// Negacyclic NTT, forward and inverse, for Hopper (sm_90a).
//
// Replaces she_tpu/ops/ntt_pallas.py:_fwd_kernel and _inv_kernel (the fused
// Pallas TPU NTT, its one pl.pallas_call) and the staged XLA NTT they are
// bit-identical to (she_tpu/ops/ntt.py:forward_ntt_arrays /
// inverse_ntt_arrays).
//
// Data: int64 words [rows, N] row-major; row r is transformed modulo
// q[r % L] with its modulus' tables (roots and inverse roots in the
// bit-reversed order of utils/refimpl.ntt_root_tables, each with its Shoup
// constant, and per-modulus q, n^-1, n^-1 * w^-1 with theirs). The element
// order and the radix-2 stage order are those of she_tpu; every output is
// fully reduced into [0, q), so it is bit-identical to the plain version.
//
// Bound: bytes. A transform reads N int64 words and writes N (16 bytes a
// coefficient; the tables stay in L1/L2) and does 3 * log2(N) / 2 32-bit
// multiplies a coefficient (18 at N = 4096) on the 32-bit route.
//
// PR 1's design (one CTA per row, 64-bit words, one shared-memory pass and
// barrier per radix-2 stage, one twiddle load per butterfly) reached a
// third of the byte bound at N = 4096. Measured on an H100 (PERF.md, PR 2):
// this design on 64-bit words runs 1.4x faster than PR 1's, and on 32-bit
// words 1.8-2x faster again; a version of it that stored its last round
// with strided 16-byte vectors and loaded twiddles one word at a time
// spent 1.3-1.6x the time of the one below, which keeps every access of a
// warp contiguous or conflict-free.
//
// The design:
//   1. The word follows the modulus (template W; the wrapper picks it). When
//      every modulus of a launch is below 2^30, Harvey's lazy range [0, 4q)
//      fits 32 bits: the kernel narrows the int64 words on load, runs on
//      uint32_t with 32-bit Shoup constants floor(w * 2^32 / q) (she_tpu's
//      own w32 constants) and widens on store, so a butterfly is one
//      __umulhi and two 32-bit multiplies. Moduli in [2^30, 2^62) take the
//      same code on uint64_t with 64-bit Shoup constants.
//   2. Stages in registers. Each thread holds 16 coefficients and runs four
//      radix-2 stages on them before it exchanges them through shared
//      memory, so at N = 4096 (256 threads) the 12 stages are three rounds
//      with two exchanges between them. Round k holds the index bits
//      [lo, lo + 4), lo = 8, 4, 0 (the inverse runs the rounds the other way
//      round, in Gentleman-Sande order, and folds n^-1 / n^-1 * w^-1 into
//      its last stage in registers). Device memory is read and written only
//      in the lo = 8 layout, where thread j takes j + 256 r and every warp
//      access is one contiguous 256-byte run; the lo = 0 layout (16
//      consecutive coefficients a thread) meets device memory through one
//      more pass through shared memory, at the forward's end and the
//      inverse's start: three barriers a transform against PR 1's twelve.
//      Shared memory holds words of the route's width (16 KB a row at
//      N = 4096 on the 32-bit route) under an XOR swizzle that makes every
//      access pattern free of bank conflicts. log2 N is a template
//      parameter (1..13); below N = 16 one thread holds the whole row, and
//      below 128 threads a row a CTA takes several rows.
//   3. Twiddles once per round: the 1 + 2 + 4 + 8 (w, w_shoup) pairs of a
//      thread's round lie in four runs of consecutive table entries, each
//      loaded with the widest vector loads that fit.
// Tensor cores compute no modular 32-bit products, and 16 independent
// coalesced loads a thread at four CTAs an SM keep the memory busy (the
// 32-bit kernels run at about 90% of a copy of the same bytes), so there
// is no wgmma and no TMA pipeline here.

#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned int u32;
typedef unsigned long long u64;

namespace {

constexpr int kMaxLog2n = 13;
constexpr int kLog2PerThread = 4;  // 16 coefficients a thread
constexpr int kMinThreads = 128;   // small N packs rows into a CTA

__device__ __forceinline__ u32 mulhi(u32 a, u32 b) { return __umulhi(a, b); }
__device__ __forceinline__ u64 mulhi(u64 a, u64 b) { return __umul64hi(a, b); }

template <typename W>
__device__ __forceinline__ W mul_shoup_lazy(W x, W w, W ws, W q) {
  // w * x mod q in [0, 2q) for any word x, w < q, ws = floor(w * 2^bits / q).
  return w * x - mulhi(x, ws) * q;
}

template <typename W>
__device__ __forceinline__ W sub_if_ge(W x, W bound) {
  return x >= bound ? x - bound : x;
}

// Shared-memory slot of coefficient i: bits 0-3 ^= bits 4-7, bit 4 ^= bit 8.
// A bijection on [0, N), linear over XOR, that maps each warp access of the
// three round layouts at N = 4096 (lo = 8, 4, 0) to 32 distinct banks (16
// distinct 8-byte bank pairs a half warp for 64-bit words).
__device__ __forceinline__ int swizzle(int i) {
  return i ^ ((i >> 4) & 15) ^ (((i >> 8) & 1) << 4);
}

// COUNT consecutive table words from p (p aligned to COUNT words), with the
// widest vector loads that fit.
template <int COUNT>
__device__ __forceinline__ void load_run(u32 (&o)[COUNT], const u32* __restrict__ p) {
  if constexpr (COUNT >= 4) {
#pragma unroll
    for (int j = 0; j < COUNT / 4; ++j) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p) + j);
      o[4 * j] = x.x;
      o[4 * j + 1] = x.y;
      o[4 * j + 2] = x.z;
      o[4 * j + 3] = x.w;
    }
  } else if constexpr (COUNT == 2) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    o[0] = x.x;
    o[1] = x.y;
  } else {
    o[0] = __ldg(p);
  }
}

template <int COUNT>
__device__ __forceinline__ void load_run(u64 (&o)[COUNT], const u64* __restrict__ p) {
  if constexpr (COUNT >= 2) {
#pragma unroll
    for (int j = 0; j < COUNT / 2; ++j) {
      const ulonglong2 x = __ldg(reinterpret_cast<const ulonglong2*>(p) + j);
      o[2 * j] = x.x;
      o[2 * j + 1] = x.y;
    }
  } else {
    o[0] = __ldg(p);
  }
}

template <int LOG2N>
struct Layout {
  static constexpr int kE = LOG2N < kLog2PerThread ? LOG2N : kLog2PerThread;
  static constexpr int kP = 1 << kE;            // coefficients a thread
  static constexpr int kT = 1 << (LOG2N - kE);  // threads a row
  static constexpr int kRounds = (LOG2N + kE - 1) / kE;
  static constexpr int kRowsPerCta = kT >= kMinThreads ? 1 : kMinThreads / kT;
  static constexpr int kThreads = kT * kRowsPerCta;
  // Round k (in forward order) transforms index bits [lo(k), hi(k)) and
  // holds bits [lo(k), lo(k) + kE) in a thread's registers.
  __host__ __device__ static constexpr int hi(int k) { return LOG2N - kE * k; }
  __host__ __device__ static constexpr int lo(int k) { return hi(k) > kE ? hi(k) - kE : 0; }
  // Index of register 0 of thread t when bits [lo, lo + kE) are held: t's
  // bits fill the index bits outside that range, so register r holds
  // base + (r << lo) = base ^ (r << lo), whose slot is
  // swizzle(base) ^ swizzle(r << lo) (the swizzle is linear over XOR).
  __device__ static __forceinline__ int base(int lo, int t) {
    return (t & ((1 << lo) - 1)) | ((t >> lo) << (lo + kE));
  }
};

// One row's modulus and tables.
template <typename W>
struct Row {
  const W* __restrict__ w;   // roots or inverse roots, [N]
  const W* __restrict__ ws;  // their Shoup constants
  W q, q2;
  W ni, nis, nw, nws;        // inverse only: n^-1, n^-1 * w^-1 and theirs
};

// Everything below is unrolled by template recursion: every register index
// is a compile-time constant, so the coefficients never leave registers.

// Cooley-Tukey stage on index bit B (m = 2^(LOG2N-1-B)), held in registers
// at bit B - LO; then the stages of the bits below it down to LO.
template <int LOG2N, int LO, int B, typename W>
__device__ __forceinline__ void forward_stages(W (&v)[Layout<LOG2N>::kP], int base,
                                               const Row<W>& c) {
  constexpr int rb = B - LO;
  constexpr int kCount = 1 << (Layout<LOG2N>::kE - 1 - rb);  // twiddles of this stage
  // the blocks of this thread's pairs are consecutive: m + (base >> (B + 1)) + rh
  const int i0 = (1 << (LOG2N - 1 - B)) + (base >> (B + 1));
  W tw[kCount], tws[kCount];
  load_run(tw, c.w + i0);
  load_run(tws, c.ws + i0);
#pragma unroll
  for (int rh = 0; rh < kCount; ++rh) {
#pragma unroll
    for (int rl = 0; rl < (1 << rb); ++rl) {
      const int r = (rh << (rb + 1)) | rl;
      const W x = sub_if_ge(v[r], c.q2);                                  // [0, 2q)
      const W y = mul_shoup_lazy(v[r | (1 << rb)], tw[rh], tws[rh], c.q);  // [0, 2q)
      v[r] = x + y;                                                 // [0, 4q)
      v[r | (1 << rb)] = x - y + c.q2;                              // [0, 4q)
    }
  }
  if constexpr (B > LO) forward_stages<LOG2N, LO, B - 1>(v, base, c);
}

// Gentleman-Sande stage on index bit B, then the bits above it up to HI.
// The transform's last stage (B = LOG2N - 1, m = 1) folds n^-1 into the
// x half and n^-1 * w^-1 into the y half and reduces fully.
template <int LOG2N, int B, int HI, int LO, typename W>
__device__ __forceinline__ void inverse_stages(W (&v)[Layout<LOG2N>::kP], int base,
                                               const Row<W>& c) {
  constexpr int rb = B - LO;
  if constexpr (B == LOG2N - 1) {
#pragma unroll
    for (int r = 0; r < (1 << rb); ++r) {
      const W x = v[r], y = v[r | (1 << rb)];                       // [0, 2q)
      v[r] = sub_if_ge(mul_shoup_lazy(x + y, c.ni, c.nis, c.q), c.q);
      v[r | (1 << rb)] = sub_if_ge(mul_shoup_lazy(x - y + c.q2, c.nw, c.nws, c.q), c.q);
    }
  } else {
    constexpr int kCount = 1 << (Layout<LOG2N>::kE - 1 - rb);
    const int i0 = (1 << (LOG2N - 1 - B)) + (base >> (B + 1));
    W tw[kCount], tws[kCount];
    load_run(tw, c.w + i0);
    load_run(tws, c.ws + i0);
#pragma unroll
    for (int rh = 0; rh < kCount; ++rh) {
#pragma unroll
      for (int rl = 0; rl < (1 << rb); ++rl) {
        const int r = (rh << (rb + 1)) | rl;
        const W x = v[r], y = v[r | (1 << rb)];                                // [0, 2q)
        v[r] = sub_if_ge(x + y, c.q2);                                         // [0, 2q)
        v[r | (1 << rb)] = mul_shoup_lazy(x - y + c.q2, tw[rh], tws[rh], c.q);  // [0, 2q)
      }
    }
  }
  if constexpr (B + 1 < HI) inverse_stages<LOG2N, B + 1, HI, LO>(v, base, c);
}

// Registers held at bits [FROM, FROM + kE) -> bits [TO, TO + kE). Each
// thread writes back only the slots it read at the previous exchange (or
// the staging load), so one barrier suffices.
template <int LOG2N, int FROM, int TO, typename W>
__device__ __forceinline__ void exchange(W (&v)[Layout<LOG2N>::kP], W* s, int t) {
  using S = Layout<LOG2N>;
  const int s0 = swizzle(S::base(FROM, t)), s1 = swizzle(S::base(TO, t));
#pragma unroll
  for (int r = 0; r < S::kP; ++r) s[s0 ^ swizzle(r << FROM)] = v[r];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < S::kP; ++r) v[r] = s[s1 ^ swizzle(r << TO)];
}

// Device memory is always read and written in round 0's layout, thread t
// taking t + (r << lo(0)), so each warp access is contiguous. The inverse
// starts, and the forward ends, in the last round's layout (kP consecutive
// coefficients a thread); they go through shared memory once more there.
template <int LOG2N, typename W>
__device__ __forceinline__ void load_coalesced(W (&v)[Layout<LOG2N>::kP],
                                               const u64* __restrict__ src, int t, bool live) {
  using S = Layout<LOG2N>;
#pragma unroll
  for (int r = 0; r < S::kP; ++r) v[r] = live ? static_cast<W>(src[t + (r << S::lo(0))]) : W(0);
}

template <int LOG2N, typename W>
__device__ __forceinline__ void store_coalesced(const W (&v)[Layout<LOG2N>::kP],
                                                u64* __restrict__ dst, int t, bool live) {
  using S = Layout<LOG2N>;
  if (!live) return;
#pragma unroll
  for (int r = 0; r < S::kP; ++r) dst[t + (r << S::lo(0))] = static_cast<u64>(v[r]);
}

// Forward rounds K, K+1, ...: exchange into round K's layout (except for
// round 0, which was loaded in it), then its stages, top bit first.
template <int LOG2N, int K, typename W>
__device__ __forceinline__ void forward_rounds(W (&v)[Layout<LOG2N>::kP], W* s, int t,
                                               const Row<W>& c) {
  using S = Layout<LOG2N>;
  if constexpr (K > 0) exchange<LOG2N, S::lo(K - 1), S::lo(K)>(v, s, t);
  forward_stages<LOG2N, S::lo(K), S::hi(K) - 1>(v, S::base(S::lo(K), t), c);
  if constexpr (K + 1 < S::kRounds) forward_rounds<LOG2N, K + 1>(v, s, t, c);
}

// Inverse rounds K, K-1, ..., 0, bottom bit first.
template <int LOG2N, int K, typename W>
__device__ __forceinline__ void inverse_rounds(W (&v)[Layout<LOG2N>::kP], W* s, int t,
                                               const Row<W>& c) {
  using S = Layout<LOG2N>;
  if constexpr (K + 1 < S::kRounds) exchange<LOG2N, S::lo(K + 1), S::lo(K)>(v, s, t);
  inverse_stages<LOG2N, S::lo(K), S::hi(K), S::lo(K)>(v, S::base(S::lo(K), t), c);
  if constexpr (K > 0) inverse_rounds<LOG2N, K - 1>(v, s, t, c);
}

// At most 64 registers a thread on the 32-bit route (four 256-thread CTAs
// an SM), 128 on the 64-bit route.
template <typename W, int LOG2N>
struct Occupancy {
  static constexpr int kPerSm = sizeof(W) == 4 ? 1024 : 512;
  static constexpr int kMinBlocks =
      kPerSm / Layout<LOG2N>::kThreads > 0 ? kPerSm / Layout<LOG2N>::kThreads : 1;
};

template <typename W, int LOG2N>
__global__ void __launch_bounds__(Layout<LOG2N>::kThreads, Occupancy<W, LOG2N>::kMinBlocks)
ntt_forward_kernel(const u64* __restrict__ in, u64* __restrict__ out, long long rows,
                   int L, const W* __restrict__ roots, const W* __restrict__ roots_shoup,
                   const W* __restrict__ moduli) {
  using S = Layout<LOG2N>;
  constexpr int n = 1 << LOG2N;
  extern __shared__ __align__(16) unsigned char smem[];
  W* s = reinterpret_cast<W*>(smem) + threadIdx.y * n;
  const long long row = static_cast<long long>(blockIdx.x) * S::kRowsPerCta + threadIdx.y;
  const bool live = row < rows;
  const int l = live ? static_cast<int>(row % L) : 0;
  const int t = threadIdx.x;
  Row<W> c;
  c.q = moduli[l];
  c.q2 = c.q << 1;
  c.w = roots + static_cast<long long>(l) * n;
  c.ws = roots_shoup + static_cast<long long>(l) * n;

  W v[S::kP];
  load_coalesced<LOG2N>(v, in + row * n, t, live);
  forward_rounds<LOG2N, 0>(v, s, t, c);
#pragma unroll
  for (int r = 0; r < S::kP; ++r) v[r] = sub_if_ge(sub_if_ge(v[r], c.q2), c.q);
  if constexpr (S::kRounds > 1) exchange<LOG2N, S::lo(S::kRounds - 1), S::lo(0)>(v, s, t);
  store_coalesced<LOG2N>(v, out + row * n, t, live);
}

template <typename W, int LOG2N>
__global__ void __launch_bounds__(Layout<LOG2N>::kThreads, Occupancy<W, LOG2N>::kMinBlocks)
ntt_inverse_kernel(const u64* __restrict__ in, u64* __restrict__ out, long long rows,
                   int L, const W* __restrict__ inv_roots,
                   const W* __restrict__ inv_roots_shoup, const W* __restrict__ moduli,
                   const W* __restrict__ n_inv, const W* __restrict__ n_inv_shoup,
                   const W* __restrict__ n_inv_w, const W* __restrict__ n_inv_w_shoup) {
  using S = Layout<LOG2N>;
  constexpr int n = 1 << LOG2N;
  extern __shared__ __align__(16) unsigned char smem[];
  W* s = reinterpret_cast<W*>(smem) + threadIdx.y * n;
  const long long row = static_cast<long long>(blockIdx.x) * S::kRowsPerCta + threadIdx.y;
  const bool live = row < rows;
  const int l = live ? static_cast<int>(row % L) : 0;
  const int t = threadIdx.x;
  Row<W> c;
  c.q = moduli[l];
  c.q2 = c.q << 1;
  c.ni = n_inv[l];
  c.nis = n_inv_shoup[l];
  c.nw = n_inv_w[l];
  c.nws = n_inv_w_shoup[l];
  c.w = inv_roots + static_cast<long long>(l) * n;
  c.ws = inv_roots_shoup + static_cast<long long>(l) * n;

  W v[S::kP];
  load_coalesced<LOG2N>(v, in + row * n, t, live);
  if constexpr (S::kRounds > 1) exchange<LOG2N, S::lo(0), S::lo(S::kRounds - 1)>(v, s, t);
  inverse_rounds<LOG2N, S::kRounds - 1>(v, s, t, c);
  store_coalesced<LOG2N>(v, out + row * n, t, live);
}

template <typename W, int LOG2N>
int launch_shape(const void* kernel, long long rows, dim3* grid, dim3* block, size_t* smem) {
  using S = Layout<LOG2N>;
  *smem = S::kRounds > 1 ? (sizeof(W) * S::kRowsPerCta) << LOG2N : 0;
  if (*smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(*smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  *grid = dim3(static_cast<unsigned>((rows + S::kRowsPerCta - 1) / S::kRowsPerCta));
  *block = dim3(S::kT, S::kRowsPerCta);
  return 0;
}

template <typename W, int LOG2N = 1>
int forward(int log2n, const void* in, void* out, long long rows, int L, const void* roots,
            const void* roots_shoup, const void* moduli, cudaStream_t stream) {
  if (log2n == LOG2N) {
    auto kernel = ntt_forward_kernel<W, LOG2N>;
    dim3 grid, block;
    size_t smem;
    int err = launch_shape<W, LOG2N>(reinterpret_cast<const void*>(kernel), rows, &grid,
                                     &block, &smem);
    if (err) return err;
    kernel<<<grid, block, smem, stream>>>(
        static_cast<const u64*>(in), static_cast<u64*>(out), rows, L,
        static_cast<const W*>(roots), static_cast<const W*>(roots_shoup),
        static_cast<const W*>(moduli));
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (LOG2N < kMaxLog2n) {
    return forward<W, LOG2N + 1>(log2n, in, out, rows, L, roots, roots_shoup, moduli, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename W, int LOG2N = 1>
int inverse(int log2n, const void* in, void* out, long long rows, int L,
            const void* inv_roots, const void* inv_roots_shoup, const void* moduli,
            const void* n_inv, const void* n_inv_shoup, const void* n_inv_w,
            const void* n_inv_w_shoup, cudaStream_t stream) {
  if (log2n == LOG2N) {
    auto kernel = ntt_inverse_kernel<W, LOG2N>;
    dim3 grid, block;
    size_t smem;
    int err = launch_shape<W, LOG2N>(reinterpret_cast<const void*>(kernel), rows, &grid,
                                     &block, &smem);
    if (err) return err;
    kernel<<<grid, block, smem, stream>>>(
        static_cast<const u64*>(in), static_cast<u64*>(out), rows, L,
        static_cast<const W*>(inv_roots), static_cast<const W*>(inv_roots_shoup),
        static_cast<const W*>(moduli), static_cast<const W*>(n_inv),
        static_cast<const W*>(n_inv_shoup), static_cast<const W*>(n_inv_w),
        static_cast<const W*>(n_inv_w_shoup));
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (LOG2N < kMaxLog2n) {
    return inverse<W, LOG2N + 1>(log2n, in, out, rows, L, inv_roots, inv_roots_shoup,
                                 moduli, n_inv, n_inv_shoup, n_inv_w, n_inv_w_shoup, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

bool bad_args(int L, int log2n, int word_bits) {
  return log2n < 1 || log2n > kMaxLog2n || L < 1 || (word_bits != 32 && word_bits != 64);
}

}  // namespace

// Plain C interface for ctypes. `in` / `out` are device pointers of
// contiguous int64 tensors [rows, N]; the tables are u32
// (word_bits 32, every q < 2^30) or u64 (word_bits 64, q < 2^62) device
// arrays; `stream` is a cudaStream_t. Returns a cudaError_t value (0 on
// success) covering the launch itself; faults during the run surface at the
// caller's next synchronisation.
extern "C" int she_ntt_forward(const void* in, void* out, long long rows, int L, int log2n,
                               int word_bits, const void* roots, const void* roots_shoup,
                               const void* moduli, void* stream) {
  if (rows <= 0) return 0;
  if (bad_args(L, log2n, word_bits)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (word_bits == 32)
    return forward<u32>(log2n, in, out, rows, L, roots, roots_shoup, moduli, st);
  return forward<u64>(log2n, in, out, rows, L, roots, roots_shoup, moduli, st);
}

extern "C" int she_ntt_inverse(const void* in, void* out, long long rows, int L, int log2n,
                               int word_bits, const void* inv_roots,
                               const void* inv_roots_shoup, const void* moduli,
                               const void* n_inv, const void* n_inv_shoup,
                               const void* n_inv_w, const void* n_inv_w_shoup,
                               void* stream) {
  if (rows <= 0) return 0;
  if (bad_args(L, log2n, word_bits)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (word_bits == 32)
    return inverse<u32>(log2n, in, out, rows, L, inv_roots, inv_roots_shoup, moduli, n_inv,
                        n_inv_shoup, n_inv_w, n_inv_w_shoup, st);
  return inverse<u64>(log2n, in, out, rows, L, inv_roots, inv_roots_shoup, moduli, n_inv,
                      n_inv_shoup, n_inv_w, n_inv_w_shoup, st);
}
