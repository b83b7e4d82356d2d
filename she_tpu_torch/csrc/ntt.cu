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
// is no wgmma here, and the 32-bit route has no TMA pipeline.
//
// The 64-bit route at N = 8192 (the w64 cell's 55-bit q, the 61-bit B_sk
// primes) is its own design, the row walk (Design::kWalk, Walk). Measured
// before it (PERF.md, PR 17, step 1), the template above on u64 at
// log2n = 13 ran at a third of the byte bound: 512 threads of 16
// coefficients and 64 KB of shared memory a row at 123-128 registers left
// one CTA an SM, whose load, 13 stages, four exchanges and store ran one
// after another, and a butterfly took 33 integer instructions (a 64-bit
// Shoup product is three 64 x 64-bit products of 3-4 IMADs each), whose
// issue alone takes longer than the bytes. 32 coefficients a thread (three
// rounds) needs more than 255 registers; two CTAs an SM leave 64 and
// spill. So the walk keeps 512 threads of 16 coefficients and one CTA an
// SM, and takes the time out elsewhere:
//   a. A persistent CTA walks rows with a ring of two 64 KB buffers; a
//      row arrives by one bulk copy (cp.async.bulk on an mbarrier) while
//      the previous row's rounds run, and leaves by stores from registers.
//   b. Rounds 1-3 keep a warp's coefficients in its own 4 KB slice of the
//      buffer, so their exchanges wait on a warp barrier, and the warps
//      drift apart: one CTA barrier a row, where round 0's warp bits move
//      (through natural-order slots, with no swizzle to undo).
//   c. The round on index bit 0 alone holds bits 0, 6, 7, 8 (pair_index):
//      its twiddles are coalesced across a warp, the forward stores and
//      the inverse loads a pair of adjacent coefficients a 16-byte access.
//   d. Below 2^58 (kLazyBits) sums go unreduced: the forward leaves every
//      sum of its 13 stages lazy and reduces once at the end; the inverse
//      tracks each register's bound within a round (lazy_bound) and reduces
//      only what the next round cannot take.
//   e. A Shoup product is hi * (-q) + w * x, so each product folds into a
//      multiply-add, and the walk's exchanges address shared memory by byte
//      (slot_address: one LOP3 an access).
// Bound: bytes (0.2105 ms at [7, 128, 2, 3, 8192] on 3.35 TB/s); the
// 64-bit multiplies' issue on the FMA pipe is of the same order, so the
// walk sits between the two (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned int u32;
typedef unsigned long long u64;

namespace {

constexpr int kMaxLog2n = 13;
// Below 2^58 the transforms run lazily (kLazy): the forward's 13 stages
// leave every sum unreduced, each adding under 2q to a value below q, so
// all stay below 27q < 2^64; the inverse's bounds are lazy_bound's, at most
// 64q.
constexpr int kLazyBits = 58;
constexpr int kLog2PerThread = 4;  // 16 coefficients a thread
constexpr int kMinThreads = 128;   // small N packs rows into a CTA

__device__ __forceinline__ u32 mulhi(u32 a, u32 b) { return __umulhi(a, b); }
__device__ __forceinline__ u64 mulhi(u64 a, u64 b) { return __umul64hi(a, b); }

// w * x mod q in [0, 2q) for any word x, w < q, ws = floor(w * 2^bits / q).
// On 64-bit words as w * x + hi * (-q) mod 2^64, with nq = -q from
// negate(): each product then folds into the other's multiply-add (the
// compiler would turn a visible 0 - q back into a subtraction).
template <typename W>
__device__ __forceinline__ W mul_shoup_lazy(W x, W w, W ws, W q, W nq) {
  if constexpr (sizeof(W) == 8) return mulhi(x, ws) * nq + w * x;
  return w * x - mulhi(x, ws) * q;
}

__device__ __forceinline__ u32 negate(u32 q) { return 0u - q; }
__device__ __forceinline__ u64 negate(u64 q) {
  u64 r;
  asm("neg.s64 %0, %1;\n" : "=l"(r) : "l"(q));
  return r;
}

template <typename W>
__device__ __forceinline__ W sub_if_ge(W x, W bound) {
  return x >= bound ? x - bound : x;
}

// Shared-memory slot of coefficient i: bits 0-3 ^= bits 4-7, bit 4 ^= bit 8.
// A bijection on [0, N), linear over XOR, that maps each warp access of the
// three round layouts at N = 4096 (lo = 8, 4, 0) to 32 distinct banks (16
// distinct 8-byte bank pairs a half warp for 64-bit words), and so each of
// the row walk's at N = 8192 (lo = 9, 5, 1, 0 and the pair layout). It
// moves only bits 0-4, so it keeps a warp's slice (bits 9-12) in place.
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
  W q, q2, nq;               // nq = -q (negate)
  W q4, q8, q16, q32;        // the lazy inverse's multiples of q
  W ni, nis, nw, nws;        // inverse only: n^-1, n^-1 * w^-1 and theirs
};

// Everything below is unrolled by template recursion: every register index
// is a compile-time constant, so the coefficients never leave registers.

// Cooley-Tukey stage on index bit B (m = 2^(LOG2N-1-B)), held in registers
// at bit B - LO; then the stages of the bits below it down to LO.
template <int LOG2N, int LO, int B, bool kLazy = false, typename W>
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
      const W x = kLazy ? v[r] : sub_if_ge(v[r], c.q2);  // [0, 2q); lazy: below (2k + 1)q after k stages
      const W y = mul_shoup_lazy(v[r | (1 << rb)], tw[rh], tws[rh], c.q, c.nq);  // [0, 2q)
      v[r] = x + y;                                       // [0, 4q); lazy: below (2k + 3)q
      v[r | (1 << rb)] = x - y + c.q2;                    // [0, 4q); lazy: below (2k + 3)q
    }
  }
  if constexpr (B > LO) forward_stages<LOG2N, LO, B - 1, kLazy>(v, base, c);
}

// The (w, w') pairs of one thread in the stage on index bit B, bits [LO,
// LO + kE) held in registers: consecutive table entries.
template <int LOG2N, int LO, int B, typename W>
struct Twiddles {
  static constexpr int kCount = 1 << (Layout<LOG2N>::kE - 1 - (B - LO));
  W w[kCount], ws[kCount];
  __device__ __forceinline__ Twiddles(const Row<W>& c, int base) {
    const int i0 = (1 << (LOG2N - 1 - B)) + (base >> (B + 1));
    load_run(w, c.w + i0);
    load_run(ws, c.ws + i0);
  }
};

// The lazy inverse (kLazy, every q < 2^58) leaves sums unreduced. A round
// starts with every register below 4q; after its first `stages` stages
// register r is below lazy_bound(r, stages) * q: a Shoup product (r's bit
// of that stage set) is below 2q, a sum doubles the bound its two inputs
// share (they differ only in that bit). After 4 stages the largest is 64q
// < 2^64.
__host__ __device__ constexpr int lazy_bound(int r, int stages) {
  int b = 4;
  for (int j = 0; j < stages; ++j) b = (r >> j) & 1 ? 2 : 2 * b;
  return b;
}

// b * q for a bound b of lazy_bound before a stage (a constant)
template <int b, typename W>
__device__ __forceinline__ W bound_q(const Row<W>& c) {
  static_assert(b == 2 || b == 4 || b == 8 || b == 16 || b == 32, "a bound before a stage of a round of 4");
  if constexpr (b == 2) return c.q2;
  else if constexpr (b == 4) return c.q4;
  else if constexpr (b == 8) return c.q8;
  else if constexpr (b == 16) return c.q16;
  else return c.q32;
}

// The lazy butterflies of a Gentleman-Sande stage on index bit B (not the
// last one), held in registers at bit B - LO, whose registers' bits below
// it are RL: their inputs are below lazy_bound(RL, B - LO) * q.
template <int LOG2N, int LO, int B, int RL, typename W>
__device__ __forceinline__ void lazy_inverse_column(W (&v)[Layout<LOG2N>::kP], const Row<W>& c,
                                                    const Twiddles<LOG2N, LO, B, W>& tw) {
  constexpr int rb = B - LO;
#pragma unroll
  for (int rh = 0; rh < tw.kCount; ++rh) {
    const int r = (rh << (rb + 1)) | RL;
    const W x = v[r], y = v[r | (1 << rb)];
    v[r] = x + y;
    v[r | (1 << rb)] = mul_shoup_lazy(x - y + bound_q<lazy_bound(RL, rb)>(c), tw.w[rh], tw.ws[rh], c.q, c.nq);
  }
  if constexpr (RL + 1 < (1 << rb)) lazy_inverse_column<LOG2N, LO, B, RL + 1>(v, c, tw);
}

// Gentleman-Sande stage on index bit B (not the last one), held in
// registers at bit B - LO.
template <int LOG2N, int LO, int B, bool kLazy = false, typename W>
__device__ __forceinline__ void inverse_stage(W (&v)[Layout<LOG2N>::kP], const Row<W>& c,
                                              const Twiddles<LOG2N, LO, B, W>& tw) {
  constexpr int rb = B - LO;
  if constexpr (kLazy) {
    lazy_inverse_column<LOG2N, LO, B, 0>(v, c, tw);
  } else {
#pragma unroll
    for (int rh = 0; rh < tw.kCount; ++rh) {
#pragma unroll
      for (int rl = 0; rl < (1 << rb); ++rl) {
        const int r = (rh << (rb + 1)) | rl;
        const W x = v[r], y = v[r | (1 << rb)];                                          // [0, 2q)
        v[r] = sub_if_ge(x + y, c.q2);                                                   // [0, 2q)
        v[r | (1 << rb)] = mul_shoup_lazy(x - y + c.q2, tw.w[rh], tw.ws[rh], c.q, c.nq);  // [0, 2q)
      }
    }
  }
}

// The transform's last stage (B = LOG2N - 1, m = 1) on register pair (R,
// R + 2^(B - LO)) and the ones after it: folds n^-1 into the x half and
// n^-1 * w^-1 into the y half and reduces fully.
template <int LOG2N, int LO, int R, bool kLazy, typename W>
__device__ __forceinline__ void inverse_fold(W (&v)[Layout<LOG2N>::kP], const Row<W>& c) {
  constexpr int rb = LOG2N - 1 - LO;
  const W x = v[R], y = v[R | (1 << rb)];  // [0, 2q) (lazy: below lazy_bound(R, rb) * q <= 32q)
  W lift = c.q2;
  if constexpr (kLazy) lift = bound_q<lazy_bound(R, rb)>(c);
  v[R] = sub_if_ge(mul_shoup_lazy(x + y, c.ni, c.nis, c.q, c.nq), c.q);
  v[R | (1 << rb)] = sub_if_ge(mul_shoup_lazy(x - y + lift, c.nw, c.nws, c.q, c.nq), c.q);
  if constexpr (R + 1 < (1 << rb)) inverse_fold<LOG2N, LO, R + 1, kLazy>(v, c);
}

// Gentleman-Sande stages on index bits B, B + 1, ..., HI - 1.
template <int LOG2N, int B, int HI, int LO, bool kLazy = false, typename W>
__device__ __forceinline__ void inverse_stages(W (&v)[Layout<LOG2N>::kP], int base,
                                               const Row<W>& c) {
  if constexpr (B == LOG2N - 1) {
    inverse_fold<LOG2N, LO, 0, kLazy>(v, c);
  } else {
    inverse_stage<LOG2N, LO, B, kLazy>(v, c, Twiddles<LOG2N, LO, B, W>(c, base));
  }
  if constexpr (B + 1 < HI) inverse_stages<LOG2N, B + 1, HI, LO, kLazy>(v, base, c);
}

// The end of a lazy round of STAGES stages: register R and the ones after
// it back below 4q (below 8q: one conditional subtraction of 4q; else a
// Shoup product with 1, whose constant one_s = floor(2^64 / q) is the
// table's entry 0).
template <int LOG2N, int STAGES, int R = 0, typename W>
__device__ __forceinline__ void lazy_reduce(W (&v)[Layout<LOG2N>::kP], const Row<W>& c, W one_s) {
  constexpr int b = lazy_bound(R, STAGES);
  if constexpr (b == 8) v[R] = sub_if_ge(v[R], c.q4);
  else if constexpr (b > 8) v[R] = mul_shoup_lazy(v[R], W(1), one_s, c.q, c.nq);
  if constexpr (R + 1 < Layout<LOG2N>::kP) lazy_reduce<LOG2N, STAGES, R + 1>(v, c, one_s);
}

// The row walk's shared memory by byte address. Its row buffers start on
// 4 KB boundaries, so slot(i) ^ c of a thread's base slot s0 (c a constant
// below 512) is the byte address (a ^ 8c) with a = buffer + 8 * s0: one
// LOP3 an access. A constant with bits from 9 up (round 0's layout, where
// s0 < 512) adds as an immediate. Accesses and barriers are volatile asm,
// so the compiler keeps their order and may still move the twiddle loads.
__device__ __forceinline__ u32 shared_address(const void* p) {
  return static_cast<u32>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ u64 ld_shared(u32 a) {
  u64 v;
  asm volatile("ld.shared.u64 %0, [%1];\n" : "=l"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void st_shared(u32 a, u64 v) {
  asm volatile("st.shared.u64 [%0], %1;\n" ::"r"(a), "l"(v));
}
__device__ __forceinline__ u32 slot_address(u32 a, int c) {
  return (a ^ (8u * static_cast<u32>(c & 511))) + 8u * static_cast<u32>(c & ~511);
}
__device__ __forceinline__ void warp_sync() { asm volatile("bar.warp.sync -1;\n" ::: "memory"); }
__device__ __forceinline__ void cta_sync() { asm volatile("bar.sync 0;\n" ::: "memory"); }

// Registers held at bits [FROM, FROM + kE) -> bits [TO, TO + kE). Each
// thread writes back only the slots it read at the previous exchange (or
// the staging load), so one barrier suffices. kWalk: the row walk's, by
// byte address (slot_address), within a warp's slice under a warp barrier.
template <int LOG2N, int FROM, bool kWalk = false, typename W>
__device__ __forceinline__ void exchange_write(const W (&v)[Layout<LOG2N>::kP], W* s, int t) {
  const int s0 = swizzle(Layout<LOG2N>::base(FROM, t));
  if constexpr (kWalk) {
    const u32 a = shared_address(s) + 8u * s0;
#pragma unroll
    for (int r = 0; r < Layout<LOG2N>::kP; ++r) st_shared(slot_address(a, swizzle(r << FROM)), v[r]);
  } else {
#pragma unroll
    for (int r = 0; r < Layout<LOG2N>::kP; ++r) s[s0 ^ swizzle(r << FROM)] = v[r];
  }
}

template <int LOG2N, int TO, bool kWalk = false, typename W>
__device__ __forceinline__ void exchange_read(W (&v)[Layout<LOG2N>::kP], const W* s, int t) {
  const int s1 = swizzle(Layout<LOG2N>::base(TO, t));
  if constexpr (kWalk) {
    const u32 a = shared_address(s) + 8u * s1;
#pragma unroll
    for (int r = 0; r < Layout<LOG2N>::kP; ++r) v[r] = ld_shared(slot_address(a, swizzle(r << TO)));
  } else {
#pragma unroll
    for (int r = 0; r < Layout<LOG2N>::kP; ++r) v[r] = s[s1 ^ swizzle(r << TO)];
  }
}

template <int LOG2N, int FROM, int TO, bool kWalk = false, typename W>
__device__ __forceinline__ void exchange(W (&v)[Layout<LOG2N>::kP], W* s, int t) {
  exchange_write<LOG2N, FROM, kWalk>(v, s, t);
  if constexpr (kWalk) warp_sync();
  else __syncthreads();
  exchange_read<LOG2N, TO, kWalk>(v, s, t);
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

// Forward rounds K, K+1, ..., LAST: exchange into round K's layout (except
// for round 0, which was loaded in it), then its stages, top bit first.
template <int LOG2N, int K, bool kWalk = false, bool kLazy = false, int LAST = Layout<LOG2N>::kRounds - 1,
          typename W>
__device__ __forceinline__ void forward_rounds(W (&v)[Layout<LOG2N>::kP], W* s, int t,
                                               const Row<W>& c) {
  using S = Layout<LOG2N>;
  if constexpr (K > 0) exchange<LOG2N, S::lo(K - 1), S::lo(K), kWalk>(v, s, t);
  forward_stages<LOG2N, S::lo(K), S::hi(K) - 1, kLazy>(v, S::base(S::lo(K), t), c);
  if constexpr (K < LAST) forward_rounds<LOG2N, K + 1, kWalk, kLazy, LAST>(v, s, t, c);
}

// Inverse rounds K, K-1, ..., LAST, bottom bit first; a lazy round
// (kLazy) other than round 0 ends with lazy_reduce. In the row walk
// (kWalk) a round's first twiddles, the most of its stages (2^(kE - 1)
// pairs a thread), are loaded before the exchange that precedes it, which
// measured a little faster (PERF.md, PR 17).
template <int LOG2N, int K, bool kWalk = false, int LAST = 0, bool kLazy = false, typename W>
__device__ __forceinline__ void inverse_rounds(W (&v)[Layout<LOG2N>::kP], W* s, int t,
                                               const Row<W>& c) {
  using S = Layout<LOG2N>;
  constexpr int LO = S::lo(K);
  if constexpr (kWalk && K + 1 < S::kRounds && LO + 1 < S::hi(K)) {
    const Twiddles<LOG2N, LO, LO, W> first(c, S::base(LO, t));
    exchange<LOG2N, S::lo(K + 1), LO, kWalk>(v, s, t);
    inverse_stage<LOG2N, LO, LO, kLazy>(v, c, first);
    inverse_stages<LOG2N, LO + 1, S::hi(K), LO, kLazy>(v, S::base(LO, t), c);
  } else {
    if constexpr (K + 1 < S::kRounds) exchange<LOG2N, S::lo(K + 1), LO, kWalk>(v, s, t);
    inverse_stages<LOG2N, LO, S::hi(K), LO, kLazy>(v, S::base(LO, t), c);
  }
  if constexpr (kLazy && K > 0) lazy_reduce<LOG2N, S::hi(K) - LO>(v, c, c.ws[0]);
  if constexpr (K > LAST) inverse_rounds<LOG2N, K - 1, kWalk, LAST, kLazy>(v, s, t, c);
}

// The row walk's layouts in shared memory, natural order: register r of
// thread t holds coefficient base(LO, t) + (r << LO) at that slot.
template <int LOG2N, int LO, typename W>
__device__ __forceinline__ void load_natural(W (&v)[Layout<LOG2N>::kP], const W* s, int t) {
  const int b = Layout<LOG2N>::base(LO, t);
#pragma unroll
  for (int r = 0; r < Layout<LOG2N>::kP; ++r) v[r] = s[b + (r << LO)];
}

template <int LOG2N, int LO, typename W>
__device__ __forceinline__ void store_natural(const W (&v)[Layout<LOG2N>::kP], W* __restrict__ s, int t) {
  const int b = Layout<LOG2N>::base(LO, t);
#pragma unroll
  for (int r = 0; r < Layout<LOG2N>::kP; ++r) s[b + (r << LO)] = v[r];
}

// The row walk's last round (forward) or first (inverse) transforms index
// bit 0 alone. It holds bits 0, 6, 7 and 8 in registers (register r: bit 0
// = r & 1, bits 6-8 = r >> 1) and gives the lanes bits 1-5, so pair h's
// twiddle, table entry N/2 + (index >> 1), is one of 32 consecutive words
// across a warp: each (w, w') load is one coalesced 256-byte run, where
// 16 consecutive coefficients a thread would read 8 pairs a thread in
// runs 64 bytes apart. The warp bits stay on bits 9-12.
template <int LOG2N>
__device__ __forceinline__ int pair_index(int t, int r) {
  static_assert(LOG2N == 13, "the pair round's layout is N = 8192's");
  return (r & 1) | ((t & 31) << 1) | ((r >> 1) << 6) | ((t >> 5) << 9);
}

template <int LOG2N, typename W>
__device__ __forceinline__ void pair_twiddles(W (&w)[8], W (&ws)[8], const Row<W>& c, int t) {
  const int i0 = (1 << (LOG2N - 1)) + (t & 31) + ((t >> 5) << 8);
#pragma unroll
  for (int h = 0; h < 8; ++h) {
    w[h] = __ldg(c.w + i0 + (h << 5));
    ws[h] = __ldg(c.ws + i0 + (h << 5));
  }
}

// The pair layout through the swizzled slots, by byte address.
template <int LOG2N, typename W>
__device__ __forceinline__ void pair_write(const W (&v)[Layout<LOG2N>::kP], W* s, int t) {
  const u32 a = shared_address(s) + 8u * swizzle(pair_index<LOG2N>(t, 0));
#pragma unroll
  for (int r = 0; r < Layout<LOG2N>::kP; ++r) st_shared(slot_address(a, swizzle(pair_index<LOG2N>(0, r))), v[r]);
}

template <int LOG2N, typename W>
__device__ __forceinline__ void pair_read(W (&v)[Layout<LOG2N>::kP], const W* s, int t) {
  const u32 a = shared_address(s) + 8u * swizzle(pair_index<LOG2N>(t, 0));
#pragma unroll
  for (int r = 0; r < Layout<LOG2N>::kP; ++r) v[r] = ld_shared(slot_address(a, swizzle(pair_index<LOG2N>(0, r))));
}

// The row walk's copies: one 64 KB bulk copy (TMA) a row into one of two
// buffers, completing on that buffer's mbarrier.
__device__ __forceinline__ void bar_init(u32 bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ u64 global_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// waits for the phase of parity `parity`; a wait of more than 10 s (a lost
// copy: a launch takes milliseconds) traps, so a fault ends the launch with
// an error instead of holding the card
__device__ __forceinline__ void bar_wait(u32 bar, u32 parity) {
  u64 start = 0;
  for (u32 spin = 1;; ++spin) {
    u32 done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin % 1024 == 0) {
      if (start == 0) start = global_ns();
      else if (global_ns() - start > 10000000000ull) __trap();
    }
  }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory, counted on `bar`; by one thread, after a barrier that
// ordered the buffer's earlier generic accesses before it.
__device__ __forceinline__ void bulk_load(u32 dst, const void* src, u32 bytes, u32 bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// The 64-bit route at N = 8192 (Design::kWalk): block b transforms rows b,
// b + gridDim.x, ... (each with its modulus, row % L) through two row
// buffers of shared memory, on 4 KB boundaries; while a row's rounds run in
// one, the bulk copy of the block's next row fills the other. Round 0
// holds index bits 9-12 in registers, so a warp's lanes take bits 0-4 and
// its warp bits 5-8; every later round (lo = 5, 1 and the pair layout)
// keeps the warp bits on bits 9-12, so a warp's coefficients fill one 4 KB
// slice of the buffer and those rounds exchange under a warp barrier. One
// CTA barrier a row remains, where the warp bits move; the next row's copy
// is issued after it. The mbarriers follow the buffers.
template <int LOG2N, typename W>
struct Walk {
  static constexpr int n = 1 << LOG2N;
  // the buffers from the first 4 KB boundary of the dynamic shared memory
  static constexpr size_t kShared = 4096 + (2 * sizeof(W) << LOG2N) + 16;
  static_assert(Layout<LOG2N>::kRowsPerCta == 1 && Layout<LOG2N>::lo(1) <= 5,
                "rounds after the first keep a warp's coefficients in one slice");
  W* buf;
  u32 bars;
  long long row;
  int k;  // rows done: buffer k & 1, its (k >> 1)-th copy

  __device__ __forceinline__ explicit Walk(unsigned char* smem) {
    smem += (0u - shared_address(smem)) & 4095u;
    buf = reinterpret_cast<W*>(smem);
    bars = shared_address(smem + 2 * n * sizeof(W));
    row = blockIdx.x;
    k = 0;
    if (threadIdx.x == 0) {
      bar_init(bars);
      bar_init(bars + 8);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  // the copy of the row `ahead` rows after this one, by thread 0
  __device__ __forceinline__ void fetch(const u64* __restrict__ in, long long rows, int ahead) const {
    const long long r = row + static_cast<long long>(ahead) * gridDim.x;
    const int b = (k + ahead) & 1;
    if (threadIdx.x == 0 && r < rows) bulk_load(shared_address(buf + b * n), in + r * n, n * sizeof(u64), bars + 8 * b);
  }
  // this row's buffer, once its copy has landed
  __device__ __forceinline__ W* wait() const {
    bar_wait(bars + 8 * (k & 1), (k >> 1) & 1);
    return buf + (k & 1) * n;
  }
  // after the row's CTA barrier: the block's previous row is done in every
  // warp, so its buffer takes the next row
  __device__ __forceinline__ void fetch_next(const u64* __restrict__ in, long long rows) const {
    fetch(in, rows, 1);
  }
};

template <typename W, int LOG2N>
struct Design {
  static constexpr bool kWalk = sizeof(W) == 8 && LOG2N == 13;
};

template <typename W>
__device__ __forceinline__ Row<W> forward_row(int l, const W* __restrict__ roots,
                                              const W* __restrict__ roots_shoup,
                                              const W* __restrict__ moduli, int n) {
  Row<W> c;
  c.q = moduli[l];
  c.q2 = c.q << 1;
  c.nq = negate(c.q);
  c.w = roots + static_cast<long long>(l) * n;
  c.ws = roots_shoup + static_cast<long long>(l) * n;
  return c;
}

template <typename W>
__device__ __forceinline__ Row<W> inverse_row(int l, const W* __restrict__ inv_roots,
                                              const W* __restrict__ inv_roots_shoup,
                                              const W* __restrict__ moduli, const W* __restrict__ n_inv,
                                              const W* __restrict__ n_inv_shoup,
                                              const W* __restrict__ n_inv_w,
                                              const W* __restrict__ n_inv_w_shoup, int n) {
  Row<W> c = forward_row(l, inv_roots, inv_roots_shoup, moduli, n);
  c.q4 = c.q2 << 1;
  c.q8 = c.q2 << 2;
  c.q16 = c.q2 << 3;
  c.q32 = c.q2 << 4;
  c.ni = n_inv[l];
  c.nis = n_inv_shoup[l];
  c.nw = n_inv_w[l];
  c.nws = n_inv_w_shoup[l];
  return c;
}

// At most 64 registers a thread on the 32-bit route (four 256-thread CTAs
// an SM), 128 on the 64-bit route.
template <typename W, int LOG2N>
struct Occupancy {
  static constexpr int kPerSm = sizeof(W) == 4 ? 1024 : 512;
  static constexpr int kMinBlocks =
      kPerSm / Layout<LOG2N>::kThreads > 0 ? kPerSm / Layout<LOG2N>::kThreads : 1;
};

template <typename W, int LOG2N, bool kLazy = false>
__global__ void __launch_bounds__(Layout<LOG2N>::kThreads, Occupancy<W, LOG2N>::kMinBlocks)
ntt_forward_kernel(const u64* __restrict__ in, u64* __restrict__ out, long long rows,
                   int L, const W* __restrict__ roots, const W* __restrict__ roots_shoup,
                   const W* __restrict__ moduli) {
  using S = Layout<LOG2N>;
  constexpr int n = 1 << LOG2N;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  W v[S::kP];
  if constexpr (Design<W, LOG2N>::kWalk) {
    constexpr int L0 = S::lo(0), L1 = S::lo(1);
    Walk<LOG2N, W> walk(smem);
    walk.fetch(in, rows, 0);
    for (; walk.row < rows; walk.row += gridDim.x, ++walk.k) {
      const Row<W> c = forward_row(static_cast<int>(walk.row % L), roots, roots_shoup, moduli, n);
      W* s = walk.wait();
      load_natural<LOG2N, L0>(v, s, t);  // each warp access 32 consecutive words
      forward_stages<LOG2N, L0, S::hi(0) - 1, kLazy>(v, S::base(L0, t), c);
      store_natural<LOG2N, L0>(v, s, t);  // into the slots it read: no barrier before
      cta_sync();
      walk.fetch_next(in, rows);
      load_natural<LOG2N, L1>(v, s, t);  // half warps on 16 bank pairs
      warp_sync();  // the warp's natural-order reads come before its swizzled writes
      forward_stages<LOG2N, L1, S::hi(1) - 1, kLazy>(v, S::base(L1, t), c);
      forward_rounds<LOG2N, 2, true, kLazy, S::kRounds - 2>(v, s, t, c);
      static_assert(S::lo(S::kRounds - 1) == 0 && S::hi(S::kRounds - 1) == 1, "the last round is bit 0");
      W tw[8], tws[8];
      pair_twiddles<LOG2N>(tw, tws, c, t);
      exchange_write<LOG2N, S::lo(S::kRounds - 2), true>(v, s, t);
      warp_sync();
      pair_read<LOG2N>(v, s, t);
#pragma unroll
      for (int h = 0; h < 8; ++h) {  // Cooley-Tukey on bit 0: registers 2h and 2h + 1
        const W x = kLazy ? v[2 * h] : sub_if_ge(v[2 * h], c.q2);
        const W y = mul_shoup_lazy(v[2 * h + 1], tw[h], tws[h], c.q, c.nq);
        v[2 * h] = x + y;
        v[2 * h + 1] = x - y + c.q2;
      }
      if constexpr (kLazy) {  // [0, 27q) -> [0, 2q) by a Shoup product with 1, whose constant is roots_shoup[0]
        const W one_s = c.ws[0];
#pragma unroll
        for (int r = 0; r < S::kP; ++r) v[r] = sub_if_ge(mul_shoup_lazy(v[r], W(1), one_s, c.q, c.nq), c.q);
      } else {
#pragma unroll
        for (int r = 0; r < S::kP; ++r) v[r] = sub_if_ge(sub_if_ge(v[r], c.q2), c.q);
      }
      // straight from the pair layout: registers 2h and 2h + 1 are adjacent
      // coefficients, so each warp store is 32 consecutive 16-byte pairs
      ulonglong2* dst = reinterpret_cast<ulonglong2*>(out + walk.row * n + pair_index<LOG2N>(t, 0));
#pragma unroll
      for (int h = 0; h < 8; ++h) dst[h << 5] = make_ulonglong2(v[2 * h], v[2 * h + 1]);
    }
  } else {
    W* s = reinterpret_cast<W*>(smem) + threadIdx.y * n;
    const long long row = static_cast<long long>(blockIdx.x) * S::kRowsPerCta + threadIdx.y;
    const bool live = row < rows;
    const Row<W> c = forward_row(live ? static_cast<int>(row % L) : 0, roots, roots_shoup, moduli, n);
    load_coalesced<LOG2N>(v, in + row * n, t, live);
    forward_rounds<LOG2N, 0>(v, s, t, c);
#pragma unroll
    for (int r = 0; r < S::kP; ++r) v[r] = sub_if_ge(sub_if_ge(v[r], c.q2), c.q);
    if constexpr (S::kRounds > 1) exchange<LOG2N, S::lo(S::kRounds - 1), S::lo(0)>(v, s, t);
    store_coalesced<LOG2N>(v, out + row * n, t, live);
  }
}

template <typename W, int LOG2N, bool kLazy = false>
__global__ void __launch_bounds__(Layout<LOG2N>::kThreads, Occupancy<W, LOG2N>::kMinBlocks)
ntt_inverse_kernel(const u64* __restrict__ in, u64* __restrict__ out, long long rows,
                   int L, const W* __restrict__ inv_roots,
                   const W* __restrict__ inv_roots_shoup, const W* __restrict__ moduli,
                   const W* __restrict__ n_inv, const W* __restrict__ n_inv_shoup,
                   const W* __restrict__ n_inv_w, const W* __restrict__ n_inv_w_shoup) {
  using S = Layout<LOG2N>;
  constexpr int n = 1 << LOG2N;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  W v[S::kP];
  if constexpr (Design<W, LOG2N>::kWalk) {
    constexpr int L0 = S::lo(0), L1 = S::lo(1);
    Walk<LOG2N, W> walk(smem);
    walk.fetch(in, rows, 0);
    for (; walk.row < rows; walk.row += gridDim.x, ++walk.k) {
      const Row<W> c = inverse_row(static_cast<int>(walk.row % L), inv_roots, inv_roots_shoup, moduli, n_inv,
                                   n_inv_shoup, n_inv_w, n_inv_w_shoup, n);
      constexpr int K2 = S::kRounds - 2, L2 = S::lo(K2);
      static_assert(S::lo(S::kRounds - 1) == 0 && S::hi(S::kRounds - 1) == 1, "the first round is bit 0");
      // its twiddles are in flight while the row's copy lands
      W tw[8], tws[8];
      pair_twiddles<LOG2N>(tw, tws, c, t);
      W* s = walk.wait();
      {  // the warp's own slice, in natural order: each 16-byte read a pair of registers
        const ulonglong2* src = reinterpret_cast<const ulonglong2*>(s + pair_index<LOG2N>(t, 0));
#pragma unroll
        for (int h = 0; h < 8; ++h) {
          const ulonglong2 x = src[h << 5];
          v[2 * h] = x.x;
          v[2 * h + 1] = x.y;
        }
      }
#pragma unroll
      for (int h = 0; h < 8; ++h) {  // Gentleman-Sande on bit 0: registers 2h and 2h + 1
        const W x = v[2 * h], y = v[2 * h + 1];  // [0, 2q)
        v[2 * h] = kLazy ? x + y : sub_if_ge(x + y, c.q2);  // [0, 2q) (lazy: 4q)
        v[2 * h + 1] = mul_shoup_lazy(x - y + c.q2, tw[h], tws[h], c.q, c.nq);
      }
      const Twiddles<LOG2N, L2, L2, W> second(c, S::base(L2, t));  // ahead, as in inverse_rounds
      warp_sync();  // the warp's natural-order reads come before its swizzled writes
      pair_write<LOG2N>(v, s, t);
      warp_sync();
      exchange_read<LOG2N, L2, true>(v, s, t);
      inverse_stage<LOG2N, L2, L2, kLazy>(v, c, second);
      inverse_stages<LOG2N, L2 + 1, S::hi(K2), L2, kLazy>(v, S::base(L2, t), c);
      if constexpr (kLazy) lazy_reduce<LOG2N, S::hi(K2) - L2>(v, c, c.ws[0]);
      inverse_rounds<LOG2N, K2 - 1, true, 1, kLazy>(v, s, t, c);
      // round 0 moves the warp bits, through natural slots: one CTA barrier
      const Twiddles<LOG2N, L0, L0, W> last(c, S::base(L0, t));  // ahead, as in inverse_rounds
      warp_sync();  // the warp's swizzled reads come before its natural-order writes
      store_natural<LOG2N, L1>(v, s, t);  // the warp's own slice
      cta_sync();
      walk.fetch_next(in, rows);
      load_natural<LOG2N, L0>(v, s, t);  // each warp access 32 consecutive words
      inverse_stage<LOG2N, L0, L0, kLazy>(v, c, last);
      inverse_stages<LOG2N, L0 + 1, S::hi(0), L0, kLazy>(v, S::base(L0, t), c);
      store_coalesced<LOG2N>(v, out + walk.row * n, t, true);
    }
  } else {
    W* s = reinterpret_cast<W*>(smem) + threadIdx.y * n;
    const long long row = static_cast<long long>(blockIdx.x) * S::kRowsPerCta + threadIdx.y;
    const bool live = row < rows;
    const Row<W> c = inverse_row(live ? static_cast<int>(row % L) : 0, inv_roots, inv_roots_shoup, moduli, n_inv,
                                 n_inv_shoup, n_inv_w, n_inv_w_shoup, n);
    load_coalesced<LOG2N>(v, in + row * n, t, live);
    if constexpr (S::kRounds > 1) exchange<LOG2N, S::lo(0), S::lo(S::kRounds - 1)>(v, s, t);
    inverse_rounds<LOG2N, S::kRounds - 1>(v, s, t, c);
    store_coalesced<LOG2N>(v, out + row * n, t, live);
  }
}

// The grid, block and dynamic shared memory of a launch over `rows` rows.
// The row walk takes one block an SM (no more blocks than rows), its row
// buffers and their mbarriers.
template <typename W, int LOG2N>
int launch_shape(const void* kernel, long long rows, dim3* grid, dim3* block, size_t* smem) {
  using S = Layout<LOG2N>;
  if constexpr (Design<W, LOG2N>::kWalk) {
    *smem = Walk<LOG2N, W>::kShared;
  } else {
    *smem = S::kRounds > 1 ? (sizeof(W) * S::kRowsPerCta) << LOG2N : 0;
  }
  if (*smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(*smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if constexpr (Design<W, LOG2N>::kWalk) {
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    *grid = dim3(static_cast<unsigned>(rows < sms ? rows : sms));
  } else {
    *grid = dim3(static_cast<unsigned>((rows + S::kRowsPerCta - 1) / S::kRowsPerCta));
  }
  *block = dim3(S::kT, S::kRowsPerCta);
  return 0;
}

template <typename W, int LOG2N = 1>
int forward(int log2n, const void* in, void* out, long long rows, int L, const void* roots,
            const void* roots_shoup, const void* moduli, bool lazy, cudaStream_t stream) {
  if (log2n == LOG2N) {
    auto kernel = ntt_forward_kernel<W, LOG2N>;
    if constexpr (Design<W, LOG2N>::kWalk) {
      if (lazy) kernel = ntt_forward_kernel<W, LOG2N, true>;
    }
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
    return forward<W, LOG2N + 1>(log2n, in, out, rows, L, roots, roots_shoup, moduli, lazy, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename W, int LOG2N = 1>
int inverse(int log2n, const void* in, void* out, long long rows, int L,
            const void* inv_roots, const void* inv_roots_shoup, const void* moduli,
            const void* n_inv, const void* n_inv_shoup, const void* n_inv_w,
            const void* n_inv_w_shoup, bool lazy, cudaStream_t stream) {
  if (log2n == LOG2N) {
    auto kernel = ntt_inverse_kernel<W, LOG2N>;
    if constexpr (Design<W, LOG2N>::kWalk) {
      if (lazy) kernel = ntt_inverse_kernel<W, LOG2N, true>;
    }
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
                                 moduli, n_inv, n_inv_shoup, n_inv_w, n_inv_w_shoup, lazy, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int LOG2N = 1>
int coefficients_per_thread(int log2n) {
  if (log2n == LOG2N) return Layout<LOG2N>::kP;
  if constexpr (LOG2N < kMaxLog2n) return coefficients_per_thread<LOG2N + 1>(log2n);
  return 0;
}

bool bad_args(int L, int log2n, int word_bits) {
  return log2n < 1 || log2n > kMaxLog2n || L < 1 || (word_bits != 32 && word_bits != 64);
}

}  // namespace

// Plain C interface for ctypes. `in` / `out` are device pointers of
// contiguous int64 tensors [rows, N], 16-byte aligned (the row walk copies
// and stores 16 bytes at a time); the tables are u32 (word_bits 32, every
// q < 2^30) or u64 (word_bits 64, q < 2^62) device arrays; modulus_bits is
// the largest modulus' bit length (kLazyBits); `stream` is a cudaStream_t.
// Returns a cudaError_t value (0 on success) covering the launch itself;
// faults during the run surface at the caller's next synchronisation.
extern "C" int she_ntt_forward(const void* in, void* out, long long rows, int L, int log2n,
                               int word_bits, int modulus_bits, const void* roots,
                               const void* roots_shoup, const void* moduli, void* stream) {
  if (rows <= 0) return 0;
  if (bad_args(L, log2n, word_bits)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (word_bits == 32)
    return forward<u32>(log2n, in, out, rows, L, roots, roots_shoup, moduli, false, st);
  return forward<u64>(log2n, in, out, rows, L, roots, roots_shoup, moduli, modulus_bits <= kLazyBits, st);
}

// 1 where a launch at (word_bits, log2n) with a largest modulus of
// modulus_bits bits takes the lazy instance (kLazy) of the row walk, else 0:
// which instance a diagnostic of the build reads.
extern "C" int she_ntt_lazy(int word_bits, int log2n, int modulus_bits) {
  return word_bits == 64 && log2n == 13 && Design<u64, 13>::kWalk && modulus_bits <= kLazyBits;
}

// Coefficients one thread holds at (word_bits, log2n), 0 for arguments
// the kernels do not take: what a diagnostic of the build divides by.
extern "C" int she_ntt_coefficients_per_thread(int word_bits, int log2n) {
  return bad_args(1, log2n, word_bits) ? 0 : coefficients_per_thread(log2n);
}

extern "C" int she_ntt_inverse(const void* in, void* out, long long rows, int L, int log2n,
                               int word_bits, int modulus_bits, const void* inv_roots,
                               const void* inv_roots_shoup, const void* moduli,
                               const void* n_inv, const void* n_inv_shoup,
                               const void* n_inv_w, const void* n_inv_w_shoup,
                               void* stream) {
  if (rows <= 0) return 0;
  if (bad_args(L, log2n, word_bits)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (word_bits == 32)
    return inverse<u32>(log2n, in, out, rows, L, inv_roots, inv_roots_shoup, moduli, n_inv,
                        n_inv_shoup, n_inv_w, n_inv_w_shoup, false, st);
  return inverse<u64>(log2n, in, out, rows, L, inv_roots, inv_roots_shoup, moduli, n_inv,
                      n_inv_shoup, n_inv_w, n_inv_w_shoup, modulus_bits <= kLazyBits, st);
}
