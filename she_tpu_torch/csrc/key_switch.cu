// Key switching for Hopper (sm_90a) on two routes, the combine of an
// oblivious-expansion level, and the mod switch, which shares the key
// switch's divide-and-round.
//
// The split route, for every shape: the three passes around a key switch's
// two NTTs (csrc/ntt.cu),
//     ks_digits -> forward NTT -> ks_mac -> inverse NTT -> ks_finish,
// each writing its intermediate to device memory as int64 words. The fused
// route (ops/key_switch.fused_route: every key-switching modulus below 2^30,
// the NTT's 32-bit route, 8 <= N <= 4096 and at most kMaxFusedModuli moduli; the
// w32 sets' rotations, expansion levels and relinearizations) is two
// kernels that run the NTTs in registers with csrc/ntt_device.cuh's rounds,
//     ks_digits_ntt_mac -> ks_intt_finish,
// whose products, fully reduced below 2^30, cross between them once as
// 32-bit words in the forward NTT's last-round layout (natural order); the
// digits and the transforms never reach device memory. At the keyword
// cell's widest level that is 14 U of traffic (read c1 2 U and c0 2 U,
// write and read the products 3 U each, write 4 U; U as below) against the
// split route's 56 U. Where the shape does not fit (the w64 set's 55-bit
// moduli at N = 8192, 64-bit moduli at any N) the split route stays.
//
// Replaces what she_tpu leaves to XLA to fuse inside its jitted key switch
// and expansion (none of it is a Pallas kernel):
//   ks_digits       she_tpu/ops/galois.py:61 apply_galois_coeff and the
//                   digit step of she_tpu/bfv/keys.py:294-312 (w32 form
//                   :228-235);
//   ks_mac          the lazy MAC against the key rows, keys.py:319-347
//                   (w32 form :238-255);
//   ks_finish       she_tpu/core/poly.py:207 divide_and_round_q_last of every
//                   component, then the add into the ciphertext,
//                   she_tpu/bfv/bfv.py:796-811 (relinearize) and :814-840
//                   (apply_galois);
//   expand_combine  the tail of an expansion level,
//                   she_tpu/pir/serving.py:160-167 (c' + parent and
//                   (parent - c') x^-shift, the negacyclic shift of
//                   core/poly.py:252), reading the parents from the slot
//                   pool and writing both children into it; its leaf
//                   instance (expand_leaves) also writes a level's leaves
//                   straight into the output in output order, doubled
//                   where the plan says (she_tpu/pir/serving.py:168-171),
//                   so no pass over the output follows the last level;
//   mod_switch      she_tpu/core/poly.py:207 divide_and_round_q_last, once
//                   a dropped modulus, under she_tpu/bfv/bfv.py:694
//                   mod_switch_down and :707 mod_switch_down_to_single: a
//                   ciphertext batch from L moduli down to L' in one launch;
//   ks_digits_ntt_mac  ks_digits, the forward NTT and ks_mac of the w32
//                   form (she_tpu/bfv/keys.py:228-255, ops/galois.py:61);
//   ks_intt_finish  the inverse NTT and ks_finish (core/poly.py:207 and the
//                   add of bfv/bfv.py:796-840).
// The plain versions are she_tpu_torch/ops/key_switch.py; every output is
// fully reduced, so the kernels equal them bit for bit.
//
// Data: int64 words holding residues in [0, q), moduli in [2, 2^62), any
// N = 2^log2n in [2, 8192]. Products take the exact 64 x 64 -> 128-bit route
// (__umul64hi; the helpers are csrc/modarith64.cuh's), so one code serves
// the w32 and the w64 parameter sets. Every key-switching key has two
// components, so ks_mac and ks_finish are built for two, and ks_finish for
// the three adds its callers make (none, g(c0) for apply_galois, c0 and c1
// for relinearize).
//
// Bound: bytes. Each kernel reads each input once and writes each output
// once, a handful of 64-bit multiplies a word; at the keyword cell's widest
// expansion level (16,384 target polynomials, L_t = 2, L_ks = 3, N = 4096;
// U = 16,384 * 4096 * 8 bytes) ks_digits moves 8 U, ks_mac 12 U (and the
// key, which stays in L2), ks_finish 12 U and expand_combine 16 U;
// mod_switch reads L rows and writes L' a polynomial.
//
// The fused pair's design: ks_digits_ntt_mac's CTA takes one target
// polynomial (256 threads of 16 coefficients at N = 4096, the NTT's
// layout), stages its L_t rows of c1 in shared memory as 32-bit words with
// coalesced loads, and for each output modulus q_i and digit j gathers the
// digit from there (negate mod q_j, then reduce mod q_i) and runs the
// forward NTT in registers; the transforms of digits 0 .. L_t - 2 wait in
// shared memory (each thread its own words), and after the last one the
// MAC against the key rows (32-bit words that stay in L2) runs four
// coefficients at a time, one IMAD.WIDE a product into u64 sums folded to
// [0, q) in 32-bit words (reduce_sum32); it writes each product row once.
// ks_intt_finish's CTA takes one (polynomial, component): it loads the
// product rows straight into the inverse NTT's first-round registers (no
// exchange before it), transforms q_ks's row first and keeps its rounded
// residues, then each row i < L_t, the next row's load in flight: transform,
// divide and round (round_last, divide_round in 32-bit words), add as
// ks_finish does (g(c0) from c0's row staged in shared memory), and store
// int64 words with coalesced stores. Both are bound by the NTTs' integer
// issue where the split passes were byte-bound: the transforms' work
// stays, the intermediates' bytes go (PERF.md).
//
// The split route's design is the simple one: a block takes one row of N words (a
// polynomial residue), each thread two consecutive words at a time with
// 16-byte loads and stores, so every warp access is one contiguous 512-byte
// run. The Galois gather (ks_digits, and ks_finish on c0) first copies its
// row into shared memory with coalesced loads and gathers from there; the
// source index of output k is computed, not loaded: t = k * element^-1
// mod 2N, the word at t mod N, negated where t >= N. mod_switch's block
// takes 512 coefficients of one polynomial, each thread two of them with
// all L residues in registers, so the L - L' drops run without another
// pass over memory.
//
// Traps the kernels keep, each pinned by tests/test_torch_key_switch.py:
//  * negate, then reduce: the Galois negation is taken mod q_j (the row's
//    own modulus) and the result is then reduced mod each q_i; where
//    q_j > q_i, (q_j - a) mod q_i is not q_i - (a mod q_i);
//  * the key rows are the first L_t rows and the last (q_ks) row of the top
//    key-switching context (KeySwitchKey.key_rows), so the MAC reads
//    key[j, c, i] for i < L_ks of the launch's own moduli;
//  * the divide-and-round is last_plus = (last + floor(q_ks / 2)) mod q_ks,
//    then (x_i + floor(q_ks / 2) mod q_i - last_plus mod q_i) *
//    q_ks^-1 mod q_i, with a 128-bit product (round_last and
//    divide_round, which ks_finish and mod_switch both call);
//  * mod_switch's drops run in order, each on the previous drop's fully
//    reduced residues: the next drop's last row is this drop's output;
//  * a MAC sum of 16 products of residues below 2^62 can pass 2^128: the
//    accumulator is reduced after every 15.

#include "modarith64.cuh"
#include "ntt_device.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLazyProducts = 15;
constexpr int kComps = 2;  // the components of every key-switching key
constexpr int kMaxModSwitchRows = 8;  // the moduli a mod_switch input may have

// What ks_finish adds after the divide-and-round: nothing (the update
// alone), g(c0) into component 0 (apply_galois), or c0 and c1 into
// components 0 and 1 (relinearize).
enum class Finish { kUpdate, kGalois, kRelinearize };

// Copy one row of n words into shared memory, 16 bytes a thread at a time.
__device__ __forceinline__ void stage_row(u64* row, const u64* src, int n) {
  for (int k = 2 * threadIdx.x; k < n; k += 2 * blockDim.x) {
    const ulonglong2 v = load2(src + k);
    row[k] = v.x;
    row[k + 1] = v.y;
  }
  __syncthreads();
}

// Output k of the signed Galois gather of a staged row over modulus q.
__device__ __forceinline__ u64 gathered(const u64* row, int k, u64 pinv, int log2n, u64 q) {
  const u64 two_n_mask = (2ull << log2n) - 1;
  const u64 t = (static_cast<u64>(k) * pinv) & two_n_mask;
  const u64 v = row[t & ((1ull << log2n) - 1)];
  return (t >> log2n) ? neg_mod(v, q) : v;
}

// What the divide-and-round by a last modulus q_last needs of a remaining
// modulus q_i: q_i with its Barrett words, floor(q_last / 2) mod q_i, and
// q_last^-1 mod q_i with its Shoup constant (a row of
// ops/key_switch_cuda.constants).
struct DivRow {
  Mod m;
  u64 half_mod, w, ws;
};

__device__ __forceinline__ DivRow load_div(const u64* consts, int i) {
  const u64* c = consts + kConstWords * i;
  return DivRow{load_mod(consts, i), __ldg(c + 3), __ldg(c + 4), __ldg(c + 5)};
}

// (last + floor(q_last / 2)) mod q_last, once a coefficient, in 64-bit or
// (q_last < 2^31) 32-bit words.
template <typename W>
__device__ __forceinline__ W round_last(W last, W q_last) {
  const W lp = last + (q_last >> 1);
  return lp >= q_last ? lp - q_last : lp;
}

// she_tpu's divide_and_round_q_last of residue x mod q_i:
// (x + floor(q_last / 2) - last_plus) * q_last^-1 mod q_i, every step
// fully reduced.
__device__ __forceinline__ u64 divide_round(u64 x, u64 last_plus, const DivRow& r) {
  const u64 coeff = sub_mod(add_mod(x, r.half_mod, r.m.q), reduce64(last_plus, r.m), r.m.q);
  return mul_shoup(coeff, r.w, r.ws, r.m.q);
}

// Block (m, j): digit j of batch entry m, reduced mod every key-switching
// modulus: out[m, j, i, k] = (g(c1)[m, j, k] mod q_j) mod q_i.
template <bool GALOIS>
__global__ void __launch_bounds__(kThreads) ks_digits_kernel(Operand c1, u64* __restrict__ out, int lt, int lks,
                                                              int log2n, const u64* __restrict__ consts, u64 pinv) {
  extern __shared__ u64 row[];
  const i64 mj = blockIdx.x;
  const int j = static_cast<int>(mj % lt);
  const int n = 1 << log2n;
  const u64* src = c1.base + batch_offset(c1, mj / lt) + j * c1.lstride;
  u64* dst = out + ((mj * lks) << log2n);
  const u64 qj = __ldg(consts + kConstWords * j);
  if constexpr (GALOIS) stage_row(row, src, n);
  for (int k = 2 * threadIdx.x; k < n; k += 2 * blockDim.x) {
    u64 v0, v1;
    if constexpr (GALOIS) {
      v0 = gathered(row, k, pinv, log2n, qj);
      v1 = gathered(row, k + 1, pinv, log2n, qj);
    } else {
      const ulonglong2 v = load2(src + k);
      v0 = v.x;
      v1 = v.y;
    }
    for (int i = 0; i < lks; ++i) {
      const Mod m = load_mod(consts, i);
      store2(dst + (static_cast<i64>(i) << log2n) + k, reduce64(v0, m), reduce64(v1, m));
    }
  }
}

// Block (m, i): out[m, c, i, k] = sum_j fwd[m, j, i, k] * key[j, c, i, k]
// mod q_i for both key components c, in one 128-bit accumulator each.
__global__ void __launch_bounds__(kThreads) ks_mac_kernel(const u64* __restrict__ fwd, const u64* __restrict__ key,
                                                           u64* __restrict__ out, int lt, int lks, int log2n,
                                                           const u64* __restrict__ consts) {
  const i64 mi = blockIdx.x;
  const int i = static_cast<int>(mi % lks);
  const i64 m = mi / lks;
  const int n = 1 << log2n;
  const Mod md = load_mod(consts, i);
  for (int k = 2 * threadIdx.x; k < n; k += 2 * blockDim.x) {
    u64 hi[kComps][2], lo[kComps][2];
#pragma unroll
    for (int c = 0; c < kComps; ++c) hi[c][0] = hi[c][1] = lo[c][0] = lo[c][1] = 0;
    int count = 0;
    for (int j = 0; j < lt; ++j) {
      if (count == kLazyProducts) {  // a 16th product could pass 2^128
#pragma unroll
        for (int c = 0; c < kComps; ++c) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            lo[c][e] = reduce128(hi[c][e], lo[c][e], md);
            hi[c][e] = 0;
          }
        }
        count = 0;
      }
      const ulonglong2 f = load2(fwd + ((((m * lt + j) * lks) + i) << log2n) + k);
#pragma unroll
      for (int c = 0; c < kComps; ++c) {
        const ulonglong2 w = load2(key + ((((static_cast<i64>(j) * kComps + c) * lks) + i) << log2n) + k);
        mac128(hi[c][0], lo[c][0], f.x, w.x);
        mac128(hi[c][1], lo[c][1], f.y, w.y);
      }
      ++count;
    }
#pragma unroll
    for (int c = 0; c < kComps; ++c)
      store2(out + ((((m * kComps + c) * lks) + i) << log2n) + k, reduce128(hi[c][0], lo[c][0], md),
             reduce128(hi[c][1], lo[c][1], md));
  }
}

// Block (m, i), i < L_t: the divide-and-round by q_ks = q_{L_t} of both
// components' row i, then the add that the caller's FINISH names.
template <Finish FINISH>
__global__ void __launch_bounds__(kThreads) ks_finish_kernel(const u64* __restrict__ inv, Operand c0, Operand c1,
                                                              u64* __restrict__ out, int lt, int log2n,
                                                              const u64* __restrict__ consts, u64 pinv) {
  constexpr bool kGather = FINISH == Finish::kGalois;
  extern __shared__ u64 row[];
  const i64 mi = blockIdx.x;
  const int i = static_cast<int>(mi % lt);
  const i64 m = mi / lt;
  const int lks = lt + 1;
  const int n = 1 << log2n;
  const DivRow dr = load_div(consts, i);
  const Mod& mq = dr.m;
  const u64 q_last = __ldg(consts + kConstWords * lt);
  const u64* src0 = nullptr;
  const u64* src1 = nullptr;
  if constexpr (FINISH != Finish::kUpdate) src0 = c0.base + batch_offset(c0, m) + i * c0.lstride;
  if constexpr (FINISH == Finish::kRelinearize) src1 = c1.base + batch_offset(c1, m) + i * c1.lstride;
  if constexpr (kGather) stage_row(row, src0, n);
  for (int k = 2 * threadIdx.x; k < n; k += 2 * blockDim.x) {
#pragma unroll
    for (int c = 0; c < kComps; ++c) {
      const u64* base = inv + ((m * kComps + c) * lks << log2n);
      const ulonglong2 last = load2(base + (static_cast<i64>(lt) << log2n) + k);
      const ulonglong2 x = load2(base + (static_cast<i64>(i) << log2n) + k);
      u64 u[2] = {divide_round(x.x, round_last(last.x, q_last), dr), divide_round(x.y, round_last(last.y, q_last), dr)};
      if (FINISH != Finish::kUpdate && c == 0) {
        if constexpr (kGather) {
          u[0] = add_mod(gathered(row, k, pinv, log2n, mq.q), u[0], mq.q);
          u[1] = add_mod(gathered(row, k + 1, pinv, log2n, mq.q), u[1], mq.q);
        } else {
          const ulonglong2 a = load2(src0 + k);
          u[0] = add_mod(a.x, u[0], mq.q);
          u[1] = add_mod(a.y, u[1], mq.q);
        }
      }
      if (FINISH == Finish::kRelinearize && c == 1) {
        const ulonglong2 a = load2(src1 + k);
        u[0] = add_mod(a.x, u[0], mq.q);
        u[1] = add_mod(a.y, u[1], mq.q);
      }
      store2(out + ((((m * kComps + c) * lt) + i) << log2n) + k, u[0], u[1]);
    }
  }
}

// Block (m, s): coefficients [512 s, 512 s + 512) of batch entry m of x
// [..., L, N] (read in place), two a thread with their L residues in
// registers, divided and rounded by the last modulus L - lt times, each
// drop on the previous drop's fully reduced output; rows < lt are written
// to out [..., lt, N]. consts holds the drops' tables one after another:
// drop d (modulus q_d dropped, d = L - 1 down to lt) is d + 1 rows of
// constants(q_0..q_d).
template <int L>
__global__ void __launch_bounds__(kThreads) mod_switch_kernel(Operand x, u64* __restrict__ out, int lt, int log2n,
                                                               int segs, const u64* __restrict__ consts) {
  const i64 m = blockIdx.x / segs;
  const int k = (blockIdx.x % segs) * 2 * kThreads + 2 * threadIdx.x;
  if (k >= (1 << log2n)) return;
  const u64* src = x.base + batch_offset(x, m) + k;
  u64 v[L][2];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const ulonglong2 a = load2(src + l * x.lstride);
    v[l][0] = a.x;
    v[l][1] = a.y;
  }
  const u64* table = consts;
#pragma unroll
  for (int d = L - 1; d >= 1; --d) {
    if (d >= lt) {
      const u64 q_last = __ldg(table + kConstWords * d);
      const u64 lp0 = round_last(v[d][0], q_last), lp1 = round_last(v[d][1], q_last);
#pragma unroll
      for (int i = 0; i < d; ++i) {
        const DivRow r = load_div(table, i);
        v[i][0] = divide_round(v[i][0], lp0, r);
        v[i][1] = divide_round(v[i][1], lp1, r);
      }
      table += kConstWords * (d + 1);
    }
  }
  u64* dst = out + ((m * lt) << log2n) + k;
#pragma unroll
  for (int l = 0; l < L; ++l)
    if (l < lt) store2(dst + (static_cast<i64>(l) << log2n), v[l][0], v[l][1]);
}

// Where a child goes: code >= 0 is a slot of the pool, code < 0 the leaf at
// output position -code - 1 (only where the level writes leaves).
template <bool LEAVES>
__device__ __forceinline__ u64* child_row(u64* pool, u64* out, i64 code, i64 slot, i64 row, int log2n) {
  if (LEAVES && code < 0) return out + (-code - 1) * slot + (row << log2n);
  return pool + code * slot + (row << log2n);
}

// Block (r, row): row `row` (of `inner` rows a slot; its modulus is row mod
// L) of level node r: p0 = c' + parent into child0[r], and
// p1 = (parent - c') x^-shift into child1[r]: the word at s goes to
// s - shift, or negated to s - shift + N where s < shift. LEAVES: a child
// may be a leaf, written into `out` at its position (she_tpu/pir/serving.py
// :168-171, the leaves gathered in output order); DOUBLE: a leaf whose
// `doubled` flag is set (first children's flags, then second children's)
// is written as 2 p mod q. The doubling commutes with the shift's
// negation, and every value is fully reduced, so the order is free.
template <bool LEAVES, bool DOUBLE>
__global__ void __launch_bounds__(kThreads) expand_combine_kernel(u64* pool, u64* out, const u64* __restrict__ upd,
                                                                   const i64* __restrict__ parents,
                                                                   const i64* __restrict__ child0,
                                                                   const i64* __restrict__ child1,
                                                                   const unsigned char* __restrict__ doubled,
                                                                   i64 count, i64 inner, int l_count, int log2n,
                                                                   int shift, const u64* __restrict__ consts) {
  const i64 rr = blockIdx.x;
  const i64 r = rr / inner, row = rr % inner;
  const int n = 1 << log2n;
  const u64 q = __ldg(consts + kConstWords * static_cast<int>(row % l_count));
  const i64 slot = inner << log2n;
  const u64* par = pool + __ldg(parents + r) * slot + (row << log2n);
  const u64* c = upd + (rr << log2n);
  u64* p0 = child_row<LEAVES>(pool, out, __ldg(child0 + r), slot, row, log2n);
  u64* p1 = child_row<LEAVES>(pool, out, __ldg(child1 + r), slot, row, log2n);
  bool twice0 = false, twice1 = false;
  if constexpr (DOUBLE) {
    twice0 = __ldg(doubled + r) != 0;
    twice1 = __ldg(doubled + count + r) != 0;
  }
  for (int k = 2 * threadIdx.x; k < n; k += 2 * blockDim.x) {
    const ulonglong2 cv = load2(c + k);
    const ulonglong2 pv = *reinterpret_cast<const ulonglong2*>(par + k);  // the pool is written too: no __ldg
    u64 s0 = add_mod(cv.x, pv.x, q), s1 = add_mod(cv.y, pv.y, q);
    u64 d[2] = {sub_mod(pv.x, cv.x, q), sub_mod(pv.y, cv.y, q)};
    if (DOUBLE && twice0) {
      s0 = add_mod(s0, s0, q);
      s1 = add_mod(s1, s1, q);
    }
    if (DOUBLE && twice1) {
      d[0] = add_mod(d[0], d[0], q);
      d[1] = add_mod(d[1], d[1], q);
    }
    store2(p0 + k, s0, s1);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int dst = k + e - shift;
      if (dst >= 0)
        p1[dst] = d[e];
      else
        p1[dst + n] = neg_mod(d[e], q);
    }
  }
}

// -- the fused route ----------------------------------------------------------

// The fused kernels' degrees, N = 8 .. 4096: one instance of each kernel
// a degree (the Galois gather and the finish's add are runtime branches,
// uniform across a launch), so that the library builds in about the time
// the NTT's, built beside it, takes (28 s against 20-24; PERF.md).
constexpr int kMinFusedLog2n = 3;
constexpr int kMaxFusedLog2n = 12;
// The most key-switching moduli (L_ks = L_t + 1) the fused kernels take.
// Their registers do not grow with L_ks: the loops over moduli and digits
// are runtime loops, and ks_digits_ntt_mac keeps the transforms of digits
// 0 .. L_t - 2 of the modulus it is on in shared memory, not in
// accumulators, so ptxas -v gives one count for every L_ks. What grows is
// its shared memory, 2 L_t rows of 16 KB at N = 4096 (c1's rows, the kept
// transforms, the exchange): three CTAs an SM fit at L_t = 2 (the w32
// sets), one up to L_t = 7 (224 KB of the 227 KB a block may have); and
// the MAC's sums, L_t products of a [0, 2q) transform by a key word below
// q < 2^30, stay below 7 x 2^61 < 2^64 up to L_t = 7.
constexpr int kMaxFusedModuli = 8;

// The fused kernels' CTA is Layout<LOG2N>'s: a row's threads (16
// coefficients a thread) by its rows a CTA (small N packs rows). At most 80
// registers a thread for ks_digits_ntt_mac (three 256-thread CTAs an SM),
// 128 for ks_intt_finish (two). Measured at the keyword cell's widest level
// (PERF.md): ks_digits_ntt_mac ran 2.52 ms at three CTAs an SM,
// spilling up to 104 bytes, against 2.64 at two with none; ks_intt_finish,
// which holds a row in flight while it finishes the last, 2.21 ms at two
// CTAs against 2.81 at three, where 80 registers spill.
template <int LOG2N>
struct Fused {
  using S = Layout<LOG2N>;
  static constexpr int kMacBlocks = 768 / S::kThreads;
  static constexpr int kFinishBlocks = 512 / S::kThreads;
};

// x mod q for any 32-bit x, q < 2^30, r = floor(2^32 / q) (the high word
// of a constants row's floor(2^64 / q)): __umulhi(x, r) is at most one
// below floor(x / q).
__device__ __forceinline__ u32 reduce32(u32 x, u32 q, u32 r) {
  const u32 y = x - __umulhi(x, r) * q;
  return y >= q ? y - q : y;
}

// x mod q for a sum x < 2^64 of products of 32-bit words (q < 2^30):
// x = h 2^32 + l, and h (2^32 mod q) by a Shoup product ([0, 2q)) plus
// l mod q is below 3q; c = 2^32 mod q, cs its Shoup constant (a constants
// row's word 6).
__device__ __forceinline__ u32 reduce_sum32(u64 x, u32 q, u32 r, u32 c, u32 cs) {
  const u32 y = mul_shoup_lazy(static_cast<u32>(x >> 32), c, cs, q, q) + reduce32(static_cast<u32>(x), q, r);
  return sub_if_ge(sub_if_ge(y, q << 1), q);
}

// divide_round in 32-bit words (every modulus below 2^30): a constants row
// narrowed, floor(2^32 / q_i) and q_last^-1's 32-bit Shoup constant being
// the high words of the row's floor(2^64 / q_i) and 64-bit one.
struct DivRow32 {
  u32 q, r, half_mod, w, ws;
};

__device__ __forceinline__ DivRow32 load_div32(const u64* consts, int i) {
  const DivRow d = load_div(consts, i);
  return DivRow32{static_cast<u32>(d.m.q), static_cast<u32>(d.m.r_hi >> 32), static_cast<u32>(d.half_mod),
                  static_cast<u32>(d.w), static_cast<u32>(d.ws >> 32)};
}

__device__ __forceinline__ u32 divide_round(u32 x, u32 last_plus, const DivRow32& d) {
  const u32 a = sub_if_ge(x + d.half_mod, d.q);
  const u32 b = reduce32(last_plus, d.q, d.r);
  const u32 coeff = a >= b ? a - b : a + d.q - b;
  return sub_if_ge(mul_shoup_lazy(coeff, d.w, d.ws, d.q, d.q), d.q);  // the last argument is unread at 32 bits
}

// Output k of the signed Galois gather of a staged row of 32-bit words over
// q (gathered's, in 32 bits: k * element^-1 < 2^26).
__device__ __forceinline__ u32 gathered32(const u32* row, int k, u32 pinv, int log2n, u32 q) {
  const u32 t = (static_cast<u32>(k) * pinv) & ((2u << log2n) - 1);
  const u32 v = row[t & ((1u << log2n) - 1)];
  return (t >> log2n) && v ? q - v : v;
}

// `rows` rows of n int64 words from src (RNS stride lstride) into shared
// memory as 32-bit words, by a row's threads, 16 bytes a load.
template <int LOG2N>
__device__ __forceinline__ void stage_rows32(u32* dst, const u64* src, i64 lstride, int rows, int t) {
  using S = Layout<LOG2N>;
  for (int j = 0; j < rows; ++j) {
#pragma unroll
    for (int e = 0; e < S::kP / 2; ++e) {
      const int k = 2 * (t + e * S::kT);
      const ulonglong2 v = load2(src + j * lstride + k);
      *reinterpret_cast<uint2*>(dst + (j << LOG2N) + k) = make_uint2(static_cast<u32>(v.x), static_cast<u32>(v.y));
    }
  }
}

// COUNT consecutive 32-bit words (a thread's product row) to and from
// device memory, 16 bytes at a time where COUNT allows.
template <int COUNT>
__device__ __forceinline__ void store_run32(u32* p, const u32 (&v)[COUNT]) {
  if constexpr (COUNT >= 4) {
#pragma unroll
    for (int e = 0; e < COUNT / 4; ++e)
      reinterpret_cast<uint4*>(p)[e] = make_uint4(v[4 * e], v[4 * e + 1], v[4 * e + 2], v[4 * e + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < COUNT / 2; ++e) reinterpret_cast<uint2*>(p)[e] = make_uint2(v[2 * e], v[2 * e + 1]);
  }
}

template <int COUNT>
__device__ __forceinline__ void load_run32(u32 (&v)[COUNT], const u32* p, bool live) {
  if (!live) {
#pragma unroll
    for (int r = 0; r < COUNT; ++r) v[r] = 0;
    return;
  }
  if constexpr (COUNT >= 4) {
#pragma unroll
    for (int e = 0; e < COUNT / 4; ++e) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[e];
      v[4 * e] = x.x;
      v[4 * e + 1] = x.y;
      v[4 * e + 2] = x.z;
      v[4 * e + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < COUNT / 2; ++e) {
      const uint2 x = reinterpret_cast<const uint2*>(p)[e];
      v[2 * e] = x.x;
      v[2 * e + 1] = x.y;
    }
  }
}

// Block (m, y): target polynomial m = blockIdx.x * rows + y, where a CTA
// holds `rows` (Layout's kRowsPerCta) of them. Its L_t rows of c1 are
// staged once; then for each key-switching modulus q_i and digit j, the
// digit (g(c1)[m, j] mod q_j) mod q_i in round 0's layout, its forward NTT
// mod q_i in registers (csrc/ntt_device.cuh's rounds, the 32-bit Shoup
// butterflies), and the multiply-add against key[j, c, i] (32-bit words,
// read from L2 by every CTA) for both components into u64 accumulators; out[m, c, i] = the sums mod q_i, as
// 32-bit words in the last round's layout, which is natural order (thread
// t holds coefficients 16 t ... 16 t + 15).
template <int LOG2N>
__global__ void __launch_bounds__(Layout<LOG2N>::kThreads, Fused<LOG2N>::kMacBlocks)
ks_digits_ntt_mac_kernel(Operand c1, const u32* __restrict__ key, u32* __restrict__ out, i64 count, int lt,
                         const u64* __restrict__ consts, u32 pinv, bool galois, const u32* __restrict__ roots,
                         const u32* __restrict__ roots_shoup, const u32* __restrict__ moduli) {
  using S = Layout<LOG2N>;
  constexpr int n = 1 << LOG2N;
  constexpr int L0 = S::lo(0);
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  const int lks = lt + 1;
  const i64 m = static_cast<i64>(blockIdx.x) * S::kRowsPerCta + threadIdx.y;
  const bool live = m < count;
  constexpr int kV = S::kP < 4 ? S::kP : 4;  // words a vector access
  // a slice: c1's L_t rows, the transforms of digits 0 .. L_t - 2, the exchange
  u32* rows = reinterpret_cast<u32*>(smem) + ((threadIdx.y * 2 * lt) << LOG2N);
  u32* held = rows + (lt << LOG2N);
  u32* s = held + ((lt - 1) << LOG2N);
  if (live) stage_rows32<LOG2N>(rows, c1.base + batch_offset(c1, m), c1.lstride, lt, t);
  const int b0 = S::base(L0, t);
  const int b_last = t << S::kE;  // the last round's layout: 16 consecutive coefficients
  for (int i = 0; i < lks; ++i) {
    const u32 qi = static_cast<u32>(__ldg(consts + kConstWords * i));
    const u32 ri = static_cast<u32>(__ldg(consts + kConstWords * i + 2) >> 32);  // floor(2^32 / q_i)
    const u32 ci = 0u - qi * ri, csi = static_cast<u32>(__ldg(consts + kConstWords * i + 6));  // 2^32 mod q_i
    const Row<u32> c = forward_row(i, roots, roots_shoup, moduli, n);
    u32 v[S::kP];
    for (int j = 0; j < lt; ++j) {
      const u32 qj = static_cast<u32>(__ldg(consts + kConstWords * j));
      const u32* row = rows + (j << LOG2N);
      __syncthreads();  // the staging, or the previous transform's last exchange reads, are done
      if (galois) {
#pragma unroll
        for (int r = 0; r < S::kP; ++r) v[r] = reduce32(gathered32(row, b0 + (r << L0), pinv, LOG2N, qj), qi, ri);
      } else {
#pragma unroll
        for (int r = 0; r < S::kP; ++r) v[r] = reduce32(row[b0 + (r << L0)], qi, ri);
      }
      forward_rounds<LOG2N, 0>(v, s, t, c);
#pragma unroll
      for (int r = 0; r < S::kP; ++r) v[r] = sub_if_ge(v[r], c.q2);  // [0, 2q)
      if (j + 1 < lt) {  // kept by this thread alone: vector g of thread t at (g * threads + t) * kV
        u32* h = held + (j << LOG2N);
#pragma unroll
        for (int g = 0; g < S::kP / kV; ++g) {
          u32 part[kV];
#pragma unroll
          for (int e = 0; e < kV; ++e) part[e] = v[g * kV + e];
          store_run32(h + (g * S::kT + t) * kV, part);
        }
      }
    }
    if (!live) continue;
    // the MAC against key[j, c, i], kV coefficients at a time: [0, 2q) by
    // [0, q), one IMAD.WIDE.U32 a product, L_t of them below 2^64
#pragma unroll
    for (int g = 0; g < S::kP / kV; ++g) {
      u64 acc[kComps][kV];
      const u32* k_last = key + ((static_cast<i64>(lt - 1) * kComps * lks + i) << LOG2N) + b_last + g * kV;
#pragma unroll
      for (int cc = 0; cc < kComps; ++cc) {
        u32 w[kV];
        load_run(w, k_last + ((static_cast<i64>(cc) * lks) << LOG2N));
#pragma unroll
        for (int e = 0; e < kV; ++e) acc[cc][e] = static_cast<u64>(v[g * kV + e]) * w[e];
      }
      for (int j = 0; j + 1 < lt; ++j) {
        u32 h[kV];
        load_run32(h, held + (j << LOG2N) + (g * S::kT + t) * kV, true);
#pragma unroll
        for (int cc = 0; cc < kComps; ++cc) {
          u32 w[kV];
          load_run(w, key + (((static_cast<i64>(j) * kComps + cc) * lks + i) << LOG2N) + b_last + g * kV);
#pragma unroll
          for (int e = 0; e < kV; ++e) acc[cc][e] += static_cast<u64>(h[e]) * w[e];
        }
      }
#pragma unroll
      for (int cc = 0; cc < kComps; ++cc) {
        u32 o[kV];
#pragma unroll
        for (int e = 0; e < kV; ++e) o[e] = reduce_sum32(acc[cc][e], qi, ri, ci, csi);
        store_run32(out + (((m * kComps + cc) * lks + i) << LOG2N) + b_last + g * kV, o);
      }
    }
  }
}

// Block (m, c, y): component c of target polynomial m, (m, c) =
// blockIdx.x * rows + y. Its L_ks product rows, in ks_digits_ntt_mac's
// layout, each inverse-transformed in registers (from the last round's
// layout, so no exchange precedes the first round; every value fully
// reduced, in round 0's layout): q_ks's row first, its rounded residues
// kept, then each row i < L_t divided and rounded by q_ks (round_last,
// divide_round) and added to as `finish` says (ks_finish's three adds: none,
// g(c0) into component 0 with c0's row staged in shared memory, or c0 and
// c1), written to out [m, c, i] as int64 words.
template <int LOG2N>
__global__ void __launch_bounds__(Layout<LOG2N>::kThreads, Fused<LOG2N>::kFinishBlocks)
ks_intt_finish_kernel(const u32* __restrict__ prod, Operand c0, Operand c1, u64* __restrict__ out, i64 count, int lt,
                      const u64* __restrict__ consts, u32 pinv, Finish finish, const u32* __restrict__ inv_roots,
                      const u32* __restrict__ inv_roots_shoup, const u32* __restrict__ moduli,
                      const u32* __restrict__ n_inv, const u32* __restrict__ n_inv_shoup,
                      const u32* __restrict__ n_inv_w, const u32* __restrict__ n_inv_w_shoup) {
  using S = Layout<LOG2N>;
  constexpr int n = 1 << LOG2N;
  constexpr int L0 = S::lo(0);
  const bool gather = finish == Finish::kGalois;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  const int lks = lt + 1;
  const i64 mc = static_cast<i64>(blockIdx.x) * S::kRowsPerCta + threadIdx.y;
  const bool live = mc < kComps * count;
  const i64 m = live ? mc / kComps : 0;
  const int comp = static_cast<int>(mc % kComps);
  u32* s = reinterpret_cast<u32*>(smem) + ((threadIdx.y * (gather ? 2 : 1)) << LOG2N);
  u32* crow = s + n;  // the Galois finish: c0's row i
  const u32* src = prod + ((mc * lks) << LOG2N) + (t << S::kE);
  const int b0 = S::base(L0, t);
  const u64* a0 = nullptr;
  const u64* a1 = nullptr;
  if (live && finish != Finish::kUpdate) a0 = c0.base + batch_offset(c0, m);
  if (live && finish == Finish::kRelinearize) a1 = c1.base + batch_offset(c1, m);
  u32 v[S::kP], lp[S::kP];
  {
    const Row<u32> c = inverse_row(lt, inv_roots, inv_roots_shoup, moduli, n_inv, n_inv_shoup, n_inv_w,
                                   n_inv_w_shoup, n);
    load_run32(v, src + (lt << LOG2N), live);
    inverse_rounds<LOG2N, S::kRounds - 1>(v, s, t, c);
#pragma unroll
    for (int r = 0; r < S::kP; ++r) lp[r] = round_last(v[r], c.q);
  }
  load_run32(v, src, live);  // row 0, in flight while c0's row is staged
  for (int i = 0; i < lt; ++i) {
    __syncthreads();  // the previous transform's exchange reads, and gathers, are done
    if (gather) {  // uniform across the launch
      if (live && comp == 0) stage_rows32<LOG2N>(crow, a0 + i * c0.lstride, 0, 1, t);
      __syncthreads();
    }
    const Row<u32> c = inverse_row(i, inv_roots, inv_roots_shoup, moduli, n_inv, n_inv_shoup, n_inv_w,
                                   n_inv_w_shoup, n);
    inverse_rounds<LOG2N, S::kRounds - 1>(v, s, t, c);
    u32 next[S::kP];  // row i + 1, in flight while row i is finished
    load_run32(next, src + ((i + 1) << LOG2N), live && i + 1 < lt);
    if (!live) continue;  // past the last (m, c): no operand to read, nothing to write
    const DivRow32 dr = load_div32(consts, i);
#pragma unroll
    for (int r = 0; r < S::kP; ++r) v[r] = divide_round(v[r], lp[r], dr);
    // the add: g(c0) or c0 into component 0, c1 into component 1 (relinearize)
    const u64* addend = comp == 0 ? a0 : finish == Finish::kRelinearize ? a1 : nullptr;
    const i64 lstride = comp == 0 ? c0.lstride : c1.lstride;
    if (gather && comp == 0) {
#pragma unroll
      for (int r = 0; r < S::kP; ++r) v[r] = sub_if_ge(v[r] + gathered32(crow, b0 + (r << L0), pinv, LOG2N, dr.q), dr.q);
    } else if (addend != nullptr) {
      const u64* a = addend + i * lstride + b0;
#pragma unroll
      for (int r = 0; r < S::kP; ++r) v[r] = sub_if_ge(v[r] + static_cast<u32>(__ldg(a + (r << L0))), dr.q);
    }
    u64* dst = out + ((mc * lt + i) << LOG2N) + b0;
#pragma unroll
    for (int r = 0; r < S::kP; ++r) dst[r << L0] = v[r];
#pragma unroll
    for (int r = 0; r < S::kP; ++r) v[r] = next[r];
  }
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

bool bad_shape(int lt, int log2n) { return lt < 1 || log2n < 1 || log2n > 13; }

template <Finish FINISH>
cudaError_t finish(const void* inv, const Operand* c0, const Operand* c1, void* out, i64 m, int lt, int log2n,
                   const void* consts, u64 pinv, cudaStream_t st) {
  auto kernel = ks_finish_kernel<FINISH>;
  const int shared = FINISH == Finish::kGalois ? (8 << log2n) : 0;
  cudaError_t err = allow_shared(kernel, shared);
  if (err != cudaSuccess) return err;
  const Operand none{};
  kernel<<<static_cast<unsigned>(m * lt), kThreads, shared, st>>>(
      static_cast<const u64*>(inv), c0 != nullptr ? *c0 : none, c1 != nullptr ? *c1 : none, static_cast<u64*>(out),
      lt, log2n, static_cast<const u64*>(consts), pinv);
  return cudaGetLastError();
}

template <int L>
cudaError_t mod_switch_rows(const Operand& x, void* out, i64 m, int lt, int log2n, const void* consts,
                            cudaStream_t st) {
  const int segs = ((1 << log2n) + 2 * kThreads - 1) / (2 * kThreads);
  mod_switch_kernel<L><<<static_cast<unsigned>(m * segs), kThreads, 0, st>>>(
      x, static_cast<u64*>(out), lt, log2n, segs, static_cast<const u64*>(consts));
  return cudaGetLastError();
}

template <int LOG2N>
cudaError_t digits_ntt_mac(const Operand& c1, const void* key, void* out, i64 m, int lt, const void* consts, u32 pinv,
                           bool galois, const void* roots, const void* roots_shoup, const void* moduli,
                           cudaStream_t st) {
  using S = Layout<LOG2N>;
  auto kernel = ks_digits_ntt_mac_kernel<LOG2N>;
  const int shared = (static_cast<int>(sizeof(u32)) * S::kRowsPerCta * 2 * lt) << LOG2N;
  cudaError_t err = allow_shared(kernel, shared);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>((m + S::kRowsPerCta - 1) / S::kRowsPerCta), dim3(S::kT, S::kRowsPerCta), shared,
           st>>>(c1, static_cast<const u32*>(key), static_cast<u32*>(out), m, lt, static_cast<const u64*>(consts),
                 pinv, galois, static_cast<const u32*>(roots), static_cast<const u32*>(roots_shoup),
                 static_cast<const u32*>(moduli));
  return cudaGetLastError();
}

template <int LOG2N = kMinFusedLog2n>
cudaError_t fused_mac(int log2n, bool galois, const Operand& c1, const void* key, void* out, i64 m, int lt,
                      const void* consts, u32 pinv, const void* roots, const void* roots_shoup, const void* moduli,
                      cudaStream_t st) {
  if (log2n == LOG2N)
    return digits_ntt_mac<LOG2N>(c1, key, out, m, lt, consts, pinv, galois, roots, roots_shoup, moduli, st);
  if constexpr (LOG2N < kMaxFusedLog2n) {
    return fused_mac<LOG2N + 1>(log2n, galois, c1, key, out, m, lt, consts, pinv, roots, roots_shoup, moduli, st);
  }
  return cudaErrorInvalidValue;
}

// The inverse tables of the 32-bit route (ops/ntt.NttTables.w32), in the
// order the kernels take them.
struct InverseTables {
  const void *roots, *roots_shoup, *moduli, *n_inv, *n_inv_shoup, *n_inv_w, *n_inv_w_shoup;
};

template <int LOG2N>
cudaError_t intt_finish(Finish finish, const void* prod, const Operand* c0, const Operand* c1, void* out, i64 m,
                        int lt, const void* consts, u32 pinv, const InverseTables& tb, cudaStream_t st) {
  using S = Layout<LOG2N>;
  auto kernel = ks_intt_finish_kernel<LOG2N>;
  const int shared = (static_cast<int>(sizeof(u32)) * S::kRowsPerCta * (finish == Finish::kGalois ? 2 : 1))
                     << LOG2N;
  cudaError_t err = allow_shared(kernel, shared);
  if (err != cudaSuccess) return err;
  const Operand none{};
  kernel<<<static_cast<unsigned>((kComps * m + S::kRowsPerCta - 1) / S::kRowsPerCta), dim3(S::kT, S::kRowsPerCta),
           shared, st>>>(
      static_cast<const u32*>(prod), c0 != nullptr ? *c0 : none, c1 != nullptr ? *c1 : none, static_cast<u64*>(out), m,
      lt, static_cast<const u64*>(consts), pinv, finish, static_cast<const u32*>(tb.roots),
      static_cast<const u32*>(tb.roots_shoup), static_cast<const u32*>(tb.moduli), static_cast<const u32*>(tb.n_inv),
      static_cast<const u32*>(tb.n_inv_shoup), static_cast<const u32*>(tb.n_inv_w),
      static_cast<const u32*>(tb.n_inv_w_shoup));
  return cudaGetLastError();
}

template <int LOG2N = kMinFusedLog2n>
cudaError_t fused_finish(int log2n, Finish finish, const void* prod, const Operand* c0, const Operand* c1, void* out,
                         i64 m, int lt, const void* consts, u32 pinv, const InverseTables& tb, cudaStream_t st) {
  if (log2n == LOG2N) return intt_finish<LOG2N>(finish, prod, c0, c1, out, m, lt, consts, pinv, tb, st);
  if constexpr (LOG2N < kMaxFusedLog2n) {
    return fused_finish<LOG2N + 1>(log2n, finish, prod, c0, c1, out, m, lt, consts, pinv, tb, st);
  }
  return cudaErrorInvalidValue;
}

bool bad_fused_shape(int lt, int log2n) {
  return lt < 1 || lt + 1 > kMaxFusedModuli || log2n < kMinFusedLog2n || log2n > kMaxFusedLog2n;
}

}  // namespace

extern "C" int she_ks_digits(const Operand* c1, void* out, long long m, int lt, int lks, int log2n,
                             const void* consts, unsigned long long pinv, int galois, void* stream) {
  if (m <= 0) return 0;
  if (bad_shape(lt, log2n) || lks != lt + 1 || c1 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(m * lt);
  if (galois) {
    const int shared = 8 << log2n;
    cudaError_t err = allow_shared(ks_digits_kernel<true>, shared);
    if (err != cudaSuccess) return static_cast<int>(err);
    ks_digits_kernel<true><<<grid, kThreads, shared, st>>>(*c1, static_cast<u64*>(out), lt, lks, log2n,
                                                            static_cast<const u64*>(consts), pinv);
  } else {
    ks_digits_kernel<false><<<grid, kThreads, 0, st>>>(*c1, static_cast<u64*>(out), lt, lks, log2n,
                                                        static_cast<const u64*>(consts), 0);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int she_ks_mac(const void* fwd, const void* key, void* out, long long m, int lt, int lks, int log2n,
                          const void* consts, void* stream) {
  if (m <= 0) return 0;
  if (bad_shape(lt, log2n) || lks != lt + 1) return static_cast<int>(cudaErrorInvalidValue);
  ks_mac_kernel<<<static_cast<unsigned>(m * lks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(fwd), static_cast<const u64*>(key), static_cast<u64*>(out), lt, lks, log2n,
      static_cast<const u64*>(consts));
  return static_cast<int>(cudaGetLastError());
}

// c0 and c1 null: the update alone; c0 with a Galois element: apply_galois;
// c0 and c1 without one: relinearize. Any other combination is refused.
extern "C" int she_ks_finish(const void* inv, const Operand* c0, const Operand* c1, void* out, long long m, int lt,
                             int log2n, const void* consts, unsigned long long pinv, int galois, void* stream) {
  if (m <= 0) return 0;
  if (bad_shape(lt, log2n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c0 == nullptr && c1 == nullptr && !galois)
    return static_cast<int>(finish<Finish::kUpdate>(inv, c0, c1, out, m, lt, log2n, consts, pinv, st));
  if (c0 != nullptr && c1 == nullptr && galois)
    return static_cast<int>(finish<Finish::kGalois>(inv, c0, c1, out, m, lt, log2n, consts, pinv, st));
  if (c0 != nullptr && c1 != nullptr && !galois)
    return static_cast<int>(finish<Finish::kRelinearize>(inv, c0, c1, out, m, lt, log2n, consts, pinv, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// out null: every child is a pool slot; else a negative child is a leaf's
// output position, and doubled (null: no leaf doubled) flags 2n children.
extern "C" int she_expand_combine(void* pool, void* out, const void* upd, const void* parents, const void* child0,
                                  const void* child1, const void* doubled, long long count, long long inner,
                                  int l_count, int log2n, int shift, const void* consts, void* stream) {
  if (count <= 0 || inner <= 0) return 0;
  if (l_count < 1 || log2n < 1 || log2n > 13 || shift <= 0 || shift >= (1 << log2n) ||
      (out == nullptr && doubled != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(count * inner);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  u64* p = static_cast<u64*>(pool);
  u64* o = static_cast<u64*>(out);
  const u64* u = static_cast<const u64*>(upd);
  const i64* par = static_cast<const i64*>(parents);
  const i64* c0 = static_cast<const i64*>(child0);
  const i64* c1 = static_cast<const i64*>(child1);
  const unsigned char* dbl = static_cast<const unsigned char*>(doubled);
  const u64* cs = static_cast<const u64*>(consts);
  if (out == nullptr)
    expand_combine_kernel<false, false><<<grid, kThreads, 0, st>>>(p, o, u, par, c0, c1, dbl, count, inner, l_count,
                                                                   log2n, shift, cs);
  else if (doubled == nullptr)
    expand_combine_kernel<true, false><<<grid, kThreads, 0, st>>>(p, o, u, par, c0, c1, dbl, count, inner, l_count,
                                                                  log2n, shift, cs);
  else
    expand_combine_kernel<true, true><<<grid, kThreads, 0, st>>>(p, o, u, par, c0, c1, dbl, count, inner, l_count,
                                                                 log2n, shift, cs);
  return static_cast<int>(cudaGetLastError());
}

// x [..., l, N] (m polynomials, read in place) -> out [..., lt, N],
// 1 <= lt < l <= kMaxModSwitchRows; consts: the drops' tables (see
// mod_switch_kernel).
extern "C" int she_mod_switch(const Operand* x, void* out, long long m, int l, int lt, int log2n, const void* consts,
                              void* stream) {
  if (m <= 0) return 0;
  if (x == nullptr || lt < 1 || lt >= l || l > kMaxModSwitchRows || log2n < 1 || log2n > 13)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (l) {
    case 2: return static_cast<int>(mod_switch_rows<2>(*x, out, m, lt, log2n, consts, st));
    case 3: return static_cast<int>(mod_switch_rows<3>(*x, out, m, lt, log2n, consts, st));
    case 4: return static_cast<int>(mod_switch_rows<4>(*x, out, m, lt, log2n, consts, st));
    case 5: return static_cast<int>(mod_switch_rows<5>(*x, out, m, lt, log2n, consts, st));
    case 6: return static_cast<int>(mod_switch_rows<6>(*x, out, m, lt, log2n, consts, st));
    case 7: return static_cast<int>(mod_switch_rows<7>(*x, out, m, lt, log2n, consts, st));
    default: return static_cast<int>(mod_switch_rows<8>(*x, out, m, lt, log2n, consts, st));
  }
}

// The fused route (every key-switching modulus below 2^30, 8 <= N <= 4096,
// at most kMaxFusedModuli of them): c1 [..., L_t, N] (m polynomials, read in
// place) and the key rows [L_t, 2, L_ks, N] as 32-bit words -> out
// [m, 2, L_ks, N] 32-bit words, the products in the Eval domain; the
// tables are the 32-bit forward tables of the L_ks moduli.
extern "C" int she_ks_digits_ntt_mac(const Operand* c1, const void* key, void* out, long long m, int lt, int log2n,
                                     const void* consts, unsigned long long pinv, int galois, const void* roots,
                                     const void* roots_shoup, const void* moduli, void* stream) {
  if (m <= 0) return 0;
  if (c1 == nullptr || bad_fused_shape(lt, log2n)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fused_mac(log2n, galois != 0, *c1, key, out, m, lt, consts, static_cast<u32>(pinv), roots,
                                    roots_shoup, moduli, static_cast<cudaStream_t>(stream)));
}

// prod [m, 2, L_ks, N] (ks_digits_ntt_mac's) -> out [m, 2, L_t, N] int64,
// with ks_finish's adds (c0 and c1 as she_ks_finish takes them); the
// tables are the 32-bit inverse tables of the L_ks moduli.
extern "C" int she_ks_intt_finish(const void* prod, const Operand* c0, const Operand* c1, void* out, long long m,
                                  int lt, int log2n, const void* consts, unsigned long long pinv, int galois,
                                  const void* inv_roots, const void* inv_roots_shoup, const void* moduli,
                                  const void* n_inv, const void* n_inv_shoup, const void* n_inv_w,
                                  const void* n_inv_w_shoup, void* stream) {
  if (m <= 0) return 0;
  if (bad_fused_shape(lt, log2n)) return static_cast<int>(cudaErrorInvalidValue);
  const InverseTables tb{inv_roots, inv_roots_shoup, moduli, n_inv, n_inv_shoup, n_inv_w, n_inv_w_shoup};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const u32 p = static_cast<u32>(pinv);
  Finish finish;
  if (c0 == nullptr && c1 == nullptr && !galois)
    finish = Finish::kUpdate;
  else if (c0 != nullptr && c1 == nullptr && galois)
    finish = Finish::kGalois;
  else if (c0 != nullptr && c1 != nullptr && !galois)
    finish = Finish::kRelinearize;
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fused_finish(log2n, finish, prod, c0, c1, out, m, lt, consts, p, tb, st));
}
