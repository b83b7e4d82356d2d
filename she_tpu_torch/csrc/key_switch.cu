// Key switching for Hopper (sm_90a): the four passes around a key switch's
// two NTTs (csrc/ntt.cu), the combine of an oblivious-expansion level, and
// the mod switch, which shares ks_finish's divide-and-round.
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
//                   ciphertext batch from L moduli down to L' in one launch.
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
// The design is the simple one: a block takes one row of N words (a
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

// (last + floor(q_last / 2)) mod q_last, once a coefficient.
__device__ __forceinline__ u64 round_last(u64 last, u64 q_last) {
  const u64 lp = last + (q_last >> 1);
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
