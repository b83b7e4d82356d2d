// The negacyclic NTT's device code for Hopper (sm_90a), shared by the NTT
// kernels (csrc/ntt.cu, whose header sets out the design) and the fused key
// switch (csrc/key_switch.cu): the word-generic Shoup butterflies, the
// register rounds of 16 coefficients a thread (Layout), the swizzled
// shared-memory exchanges between them, the twiddle loads, the coalesced
// row loads and stores, and the per-row tables (Row, forward_row,
// inverse_row). Everything is inline device code in an anonymous
// namespace, so each source that includes it compiles its own copy.

#pragma once

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
// measured a little faster (PERF.md).
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

}  // namespace
