// Exact 64-bit modular arithmetic for Hopper kernels, shared by
// csrc/key_switch.cu and csrc/behz.cu: residues in [0, q) for moduli in
// [2, 2^62) held in one u64 word, products by the 64 x 64 -> 128-bit route
// (__umul64hi) with a Barrett reduction of any 128-bit value by
// floor(2^128 / q) or a Shoup multiply by a constant, so one code serves the
// 32- and 64-bit parameter sets; and the operand that a kernel reads in
// place through batch strides.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned long long u64;
typedef long long i64;

constexpr int kMaxDims = 6;

// An operand read in place: element (batch..., l, k) lies at
// base + offset(batch) + l * lstride + k, and axis 0 of the batch goes
// through `index` where it is given (the expansion's slot pool).
struct Operand {
  const u64* base;
  int nd;
  i64 size[kMaxDims];
  i64 stride[kMaxDims];
  const i64* index;
  i64 lstride;
};

namespace {

__device__ __forceinline__ i64 batch_offset(const Operand& o, i64 m) {
  i64 off = 0;
#pragma unroll
  for (int d = kMaxDims - 1; d >= 0; --d) {
    if (d < o.nd) {
      i64 c = m % o.size[d];
      m /= o.size[d];
      if (d == 0 && o.index != nullptr) c = o.index[c];
      off += c * o.stride[d];
    }
  }
  return off;
}

struct Mod {
  u64 q, r_lo, r_hi;  // r = floor(2^128 / q)
};

// A modulus's row of ops/key_switch_cuda.constants: q, r_lo, r_hi, then
// what the divide-and-round reads (half mod q, q_ks^-1 mod q, its Shoup
// constant), the fused MAC's fold constant and 0.
constexpr int kConstWords = 8;

__device__ __forceinline__ Mod load_mod(const u64* consts, int i) {
  const u64* c = consts + kConstWords * i;
  return Mod{__ldg(c), __ldg(c + 1), __ldg(c + 2)};
}

// x mod q for any 64-bit x: the quotient estimate floor(x * floor(2^64 / q) /
// 2^64) is at most one below floor(x / q), so one subtraction finishes.
__device__ __forceinline__ u64 reduce64(u64 x, const Mod& m) {
  const u64 r = x - __umul64hi(x, m.r_hi) * m.q;
  return r >= m.q ? r - m.q : r;
}

// (hi * 2^64 + lo) mod q for any 128-bit value (Barrett with the two words of
// floor(2^128 / q)): the estimate floor(x * r / 2^128) is computed exactly
// and is at most one below floor(x / q), so x - estimate * q lies in [0, 2q)
// and fits 64 bits for q < 2^63.
__device__ __forceinline__ u64 reduce128(u64 hi, u64 lo, const Mod& m) {
  const u64 carry = __umul64hi(lo, m.r_lo);
  const u64 a_lo = lo * m.r_hi, a_hi = __umul64hi(lo, m.r_hi);
  const u64 s = a_lo + carry;
  const u64 t = a_hi + (s < a_lo);
  const u64 b_lo = hi * m.r_lo, b_hi = __umul64hi(hi, m.r_lo);
  const u64 s2 = s + b_lo;
  const u64 carry2 = b_hi + (s2 < s);
  const u64 est = hi * m.r_hi + t + carry2;
  const u64 r = lo - est * m.q;
  return r >= m.q ? r - m.q : r;
}

__device__ __forceinline__ void mac128(u64& hi, u64& lo, u64 a, u64 b) {
  const u64 p_lo = a * b, p_hi = __umul64hi(a, b);
  lo += p_lo;
  hi += p_hi + (lo < p_lo);
}

__device__ __forceinline__ u64 add_mod(u64 a, u64 b, u64 q) {
  const u64 s = a + b;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ u64 sub_mod(u64 a, u64 b, u64 q) { return a >= b ? a - b : a + q - b; }

__device__ __forceinline__ u64 neg_mod(u64 a, u64 q) { return a == 0 ? 0 : q - a; }

// w * x mod q for any 64-bit x, w < q < 2^63, ws = floor(w * 2^64 / q).
__device__ __forceinline__ u64 mul_shoup(u64 x, u64 w, u64 ws, u64 q) {
  const u64 r = w * x - __umul64hi(x, ws) * q;
  return r >= q ? r - q : r;
}

__device__ __forceinline__ ulonglong2 load2(const u64* p) {
  return __ldg(reinterpret_cast<const ulonglong2*>(p));
}

__device__ __forceinline__ void store2(u64* p, u64 a, u64 b) {
  *reinterpret_cast<ulonglong2*>(p) = make_ulonglong2(a, b);
}

}  // namespace
