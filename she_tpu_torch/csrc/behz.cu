// The BEHZ ciphertext product for Hopper (sm_90a): the lift of a ciphertext
// from q to [q, B_sk], the tensor product summed in the extended base, and
// the floor back to q, around the product's two NTTs (csrc/ntt.cu).
//
// Replaces what she_tpu leaves to XLA to fuse (none of it is a Pallas
// kernel):
//   behz_lift        she_tpu/core/rns.py:312-380 convert_approximate_bsk_mtilde,
//                    small_montgomery_reduce and lift_q_to_qbsk, over
//                    RnsBaseConverter :56-136;
//   behz_tensor_mac  the tensor product of she_tpu/bfv/bfv.py:723-749
//                    (multiply_without_scaling), its sum over the K pairs
//                    of inner_product_ct_ct :774-793 and the scale by t of
//                    drop_extended_base :762, in one pass;
//   behz_floor       she_tpu/core/rns.py:382-461 approximate_floor,
//                    convert_approximate_bsk_to_q and floor_qbsk_to_q.
// The plain versions are she_tpu_torch/ops/behz.py; every output is fully
// reduced, so the kernels equal them bit for bit.
//
// Data: int64 words holding residues in [0, q), moduli in [2, 2^62), L <= 8
// ciphertext moduli (the predefined sets have at most 5), L_bsk = L + 1
// (B, then m_sk), m~ = 2^16 or 2^32; any even count n of columns (N, or a
// block of N / S columns on a mesh). Products take the exact 64 x 64 ->
// 128-bit route of csrc/modarith64.cuh, so one code serves the w32 and the
// w64 parameter sets. The per-launch constants travel in a struct passed by
// value (kernel parameters, read through the constant cache); the lift and
// the floor are templates on L, so every loop over the moduli unrolls and
// every constant has a fixed place.
//
// Bound: bytes. Each kernel reads each input once and writes each output
// once, a few dozen 64-bit multiplies a word. At the keyword cell (128
// queries x 31 pairs x 2 polynomials, L = 2, L_bsk = 3, N = 4096) the lift
// moves 7 words a coefficient of a polynomial, the MAC 4 M words a pair
// and 3 M a query (M = 2L + 1 = 5), the floor 3 (M + L) a query.
//
// The design is the simple one: every coefficient column is independent in
// the lift and the floor, and the MAC is a K-term multiply-add a
// coefficient. A block takes 512 columns of one batch entry (the MAC: of
// one row of one entry), a thread two consecutive columns with 16-byte
// loads and stores, so every warp access is one contiguous 512-byte run; a
// thread loads the L (or L + L_bsk, or 4 a pair) words of its columns and
// writes each output row once.
//
// Traps the kernels keep, each pinned by tests/test_torch_behz.py:
//  * the conversion is the approximate one, (x + a_x Q) mod m_j with a_x in
//    [0, L - 1]: exactly sum_i [x_i m~ (Q/q_i)^-1]_{q_i} (Q/q_i) mod m_j
//    (she_tpu's two products x m~ mod q_i and then (Q/q_i)^-1 fold into one
//    constant; both fully reduce to the same value). An exact CRT would
//    change bits;
//  * m~ is a power of two: its row reduces by mask, from a wrapping 64-bit
//    sum; r_m~ = (-Q^-1 r) mod m~ is centred as r_m~ + b_j - m~ where
//    r_m~ >= m~ / 2;
//  * in the floor, alpha and m_sk - alpha lie below m_sk, which exceeds q_i
//    at both widths: they are reduced inside their product (a Shoup
//    multiply takes any 64-bit operand);
//  * 16 products of residues below 2^62 can pass 2^128: the MAC reduces
//    every 7 pairs (p1 takes two products a pair); the conversions sum at
//    most 8 products;
//  * t may exceed 2^31: the scale is t mod m_j, a Shoup constant a row.

#include "modarith64.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kColumns = 2 * kThreads;  // columns a block
constexpr int kMaxL = 8;
constexpr int kMaxBsk = kMaxL + 1;
constexpr int kMaxExt = kMaxL + kMaxBsk;
constexpr int kLazyPairs = 7;  // 14 products of p1 and a reduced residue stay below 2^128

}  // namespace

// A modulus with its Barrett words (r = floor(2^128 / q)) and a constant
// with its Shoup word (floor(w 2^64 / q)).
struct LiftParams {
  Mod q[kMaxL];
  u64 w[kMaxL], ws[kMaxL];  // m~ (Q/q_i)^-1 mod q_i
  Mod b[kMaxBsk];
  u64 punct_b[kMaxBsk][kMaxL];  // (Q/q_i) mod b_j
  u64 punct_mt[kMaxL];          // (Q/q_i) mod m~
  u64 q_mod_b[kMaxBsk], q_mod_b_s[kMaxBsk];
  u64 inv_mt[kMaxBsk], inv_mt_s[kMaxBsk];  // m~^-1 mod b_j
  u64 neg_inv_q_mt;                        // -Q^-1 mod m~
  u64 m_tilde;
};

struct FloorParams {
  Mod q[kMaxL];
  Mod b[kMaxBsk];  // B (b_0 .. b_{L-1}), then m_sk
  u64 sq[kMaxL], sq_s[kMaxL];  // the scale mod q_i
  u64 sb[kMaxBsk], sb_s[kMaxBsk];  // the scale mod b_j
  u64 inv_punct_q[kMaxL], inv_punct_q_s[kMaxL];  // (Q/q_i)^-1 mod q_i
  u64 punct_q_b[kMaxBsk][kMaxL];                 // (Q/q_i) mod b_j
  u64 inv_q_b[kMaxBsk], inv_q_b_s[kMaxBsk];      // Q^-1 mod b_j
  u64 inv_punct_b[kMaxL], inv_punct_b_s[kMaxL];  // (B/b_j)^-1 mod b_j
  u64 punct_b_msk[kMaxL];                        // (B/b_j) mod m_sk
  u64 punct_b_q[kMaxL][kMaxL];                   // [i][j]: (B/b_j) mod q_i
  u64 inv_b_msk, inv_b_msk_s;                    // B^-1 mod m_sk
  u64 b_mod_q[kMaxL], b_mod_q_s[kMaxL];          // B mod q_i
  u64 neg_b_mod_q[kMaxL], neg_b_mod_q_s[kMaxL];  // -B mod q_i
  u64 scaled;                                    // 0: the scale is 1
};

struct MacParams {
  Mod m[kMaxExt];
  u64 s[kMaxExt], ss[kMaxExt];  // the scale mod m_i
};

namespace {

// The batch entry and first column of this block, of `chunks` blocks an entry.
__device__ __forceinline__ void block_place(i64 chunks, i64& entry, int& column) {
  entry = blockIdx.x / chunks;
  column = static_cast<int>(blockIdx.x % chunks) * kColumns + 2 * threadIdx.x;
}

// sum_i a[i] c[i] mod m over L products below 2^124 (L <= 8: below 2^127).
template <int L>
__device__ __forceinline__ u64 dot_mod(const u64 (&a)[L], const u64* c, const Mod& m) {
  u64 hi = 0, lo = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) mac128(hi, lo, a[i], c[i]);
  return reduce128(hi, lo, m);
}

// Entry m, columns k and k + 1: out[m, :L] = x[m], out[m, L + j] = the
// Montgomery-corrected conversion of x m~ to b_j.
template <int L>
__global__ void __launch_bounds__(kThreads) behz_lift_kernel(Operand x, u64* __restrict__ out, int n, i64 chunks,
                                                             const __grid_constant__ LiftParams p) {
  constexpr int LB = L + 1;
  i64 m;
  int k;
  block_place(chunks, m, k);
  if (k >= n) return;
  const u64* src = x.base + batch_offset(x, m);
  u64* dst = out + m * (L + LB) * n + k;
  u64 y[2][L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const ulonglong2 v = load2(src + i * x.lstride + k);
    store2(dst + static_cast<i64>(i) * n, v.x, v.y);
    y[0][i] = mul_shoup(v.x, p.w[i], p.ws[i], p.q[i].q);
    y[1][i] = mul_shoup(v.y, p.w[i], p.ws[i], p.q[i].q);
  }
  const u64 mask = p.m_tilde - 1, half = p.m_tilde >> 1;
  u64 r[2];
  bool less[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    u64 s = 0;  // mod 2^64, which m~ divides
#pragma unroll
    for (int i = 0; i < L; ++i) s += y[e][i] * p.punct_mt[i];
    r[e] = ((s & mask) * p.neg_inv_q_mt) & mask;
    less[e] = r[e] < half;
  }
#pragma unroll
  for (int j = 0; j < LB; ++j) {
    const Mod& bj = p.b[j];
    u64 o[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const u64 conv = dot_mod<L>(y[e], p.punct_b[j], bj);
      const u64 rm = less[e] ? r[e] : r[e] + bj.q - p.m_tilde;
      const u64 acc = add_mod(conv, mul_shoup(rm, p.q_mod_b[j], p.q_mod_b_s[j], bj.q), bj.q);
      o[e] = mul_shoup(acc, p.inv_mt[j], p.inv_mt_s[j], bj.q);
    }
    store2(dst + static_cast<i64>(L + j) * n, o[0], o[1]);
  }
}

// Entry m, columns k and k + 1 of y over [q, B_sk] (each row times the
// scale first, where there is one) -> floor(x / q) over q.
template <int L>
__global__ void __launch_bounds__(kThreads) behz_floor_kernel(Operand y, u64* __restrict__ out, int n, i64 chunks,
                                                              const __grid_constant__ FloorParams p) {
  constexpr int LB = L + 1;
  i64 m;
  int k;
  block_place(chunks, m, k);
  if (k >= n) return;
  const u64* src = y.base + batch_offset(y, m);
  u64 xq[2][L], xb[2][LB];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const ulonglong2 v = load2(src + i * y.lstride + k);
    xq[0][i] = v.x;
    xq[1][i] = v.y;
  }
#pragma unroll
  for (int j = 0; j < LB; ++j) {
    const ulonglong2 v = load2(src + (L + j) * y.lstride + k);
    xb[0][j] = v.x;
    xb[1][j] = v.y;
  }
  u64 res[2][L];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (p.scaled) {
#pragma unroll
      for (int i = 0; i < L; ++i) xq[e][i] = mul_shoup(xq[e][i], p.sq[i], p.sq_s[i], p.q[i].q);
#pragma unroll
      for (int j = 0; j < LB; ++j) xb[e][j] = mul_shoup(xb[e][j], p.sb[j], p.sb_s[j], p.b[j].q);
    }
    // approximate floor: (x_bsk - conv(x_q)) Q^-1 mod b_j = floor(x / q) + a_x over B_sk
    u64 z[L];
#pragma unroll
    for (int i = 0; i < L; ++i) z[i] = mul_shoup(xq[e][i], p.inv_punct_q[i], p.inv_punct_q_s[i], p.q[i].q);
    u64 fl[LB];
#pragma unroll
    for (int j = 0; j < LB; ++j) {
      const u64 conv = dot_mod<L>(z, p.punct_q_b[j], p.b[j]);
      fl[j] = mul_shoup(sub_mod(xb[e][j], conv, p.b[j].q), p.inv_q_b[j], p.inv_q_b_s[j], p.b[j].q);
    }
    // Shenoy-Kumaresan: B -> q, corrected by alpha from the m_sk row
    u64 zb[L];
#pragma unroll
    for (int j = 0; j < L; ++j) zb[j] = mul_shoup(fl[j], p.inv_punct_b[j], p.inv_punct_b_s[j], p.b[j].q);
    const Mod& msk = p.b[L];
    const u64 conv_msk = dot_mod<L>(zb, p.punct_b_msk, msk);
    const u64 alpha = mul_shoup(sub_mod(conv_msk, fl[L], msk.q), p.inv_b_msk, p.inv_b_msk_s, msk.q);
    const bool exceeds = alpha > (msk.q >> 1);
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const u64 conv = dot_mod<L>(zb, p.punct_b_q[i], p.q[i]);
      const u64 adj = exceeds ? mul_shoup(msk.q - alpha, p.b_mod_q[i], p.b_mod_q_s[i], p.q[i].q)
                              : mul_shoup(alpha, p.neg_b_mod_q[i], p.neg_b_mod_q_s[i], p.q[i].q);
      res[e][i] = add_mod(conv, adj, p.q[i].q);
    }
  }
  u64* dst = out + m * L * n + k;
#pragma unroll
  for (int i = 0; i < L; ++i) store2(dst + static_cast<i64>(i) * n, res[0][i], res[1][i]);
}

// Entry m, row i, columns k and k + 1: over the K pairs of la and lb
// [batch, K, 2, M, n], out[m, c, i] = scale * p_c mod m_i for p0 = sum a0 b0,
// p1 = sum a0 b1 + a1 b0, p2 = sum a1 b1, in 128-bit accumulators.
__global__ void __launch_bounds__(kThreads) behz_tensor_mac_kernel(const u64* __restrict__ la,
                                                                   const u64* __restrict__ lb, u64* __restrict__ out,
                                                                   int K, int M, int n, i64 chunks,
                                                                   const __grid_constant__ MacParams p) {
  i64 mi;
  int k;
  block_place(chunks, mi, k);
  if (k >= n) return;
  const int i = static_cast<int>(mi % M);
  const i64 m = mi / M;
  const Mod md = p.m[i];
  const i64 poly = static_cast<i64>(M) * n, pair = 2 * poly;
  const i64 base = m * K * pair + static_cast<i64>(i) * n + k;
  u64 hi[3][2] = {}, lo[3][2] = {};
  for (int kk = 0; kk < K; ++kk) {
    if (kk > 0 && kk % kLazyPairs == 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          lo[c][e] = reduce128(hi[c][e], lo[c][e], md);
          hi[c][e] = 0;
        }
      }
    }
    const i64 at = base + kk * pair;
    const ulonglong2 a0 = load2(la + at), a1 = load2(la + at + poly);
    const ulonglong2 b0 = load2(lb + at), b1 = load2(lb + at + poly);
    mac128(hi[0][0], lo[0][0], a0.x, b0.x);
    mac128(hi[0][1], lo[0][1], a0.y, b0.y);
    mac128(hi[1][0], lo[1][0], a0.x, b1.x);
    mac128(hi[1][1], lo[1][1], a0.y, b1.y);
    mac128(hi[1][0], lo[1][0], a1.x, b0.x);
    mac128(hi[1][1], lo[1][1], a1.y, b0.y);
    mac128(hi[2][0], lo[2][0], a1.x, b1.x);
    mac128(hi[2][1], lo[2][1], a1.y, b1.y);
  }
  const u64 s = p.s[i], ss = p.ss[i];
  u64* dst = out + (m * 3 * M + i) * n + k;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    store2(dst + c * poly, mul_shoup(reduce128(hi[c][0], lo[c][0], md), s, ss, md.q),
           mul_shoup(reduce128(hi[c][1], lo[c][1], md), s, ss, md.q));
}

i64 chunks_of(int n) { return (n + kColumns - 1) / kColumns; }

bool bad_columns(int n) { return n < 2 || n % 2 != 0; }

template <int L>
cudaError_t lift(const Operand& x, void* out, i64 m, int n, const LiftParams& p, cudaStream_t st) {
  const i64 chunks = chunks_of(n);
  behz_lift_kernel<L><<<static_cast<unsigned>(m * chunks), kThreads, 0, st>>>(x, static_cast<u64*>(out), n, chunks, p);
  return cudaGetLastError();
}

template <int L>
cudaError_t floor_q(const Operand& y, void* out, i64 m, int n, const FloorParams& p, cudaStream_t st) {
  const i64 chunks = chunks_of(n);
  behz_floor_kernel<L><<<static_cast<unsigned>(m * chunks), kThreads, 0, st>>>(y, static_cast<u64*>(out), n, chunks, p);
  return cudaGetLastError();
}

}  // namespace

// Sizes of the parameter structs, which the ctypes mirrors must match.
extern "C" long long she_behz_param_bytes(int which) {
  switch (which) {
    case 0: return sizeof(LiftParams);
    case 1: return sizeof(FloorParams);
    case 2: return sizeof(MacParams);
    case 3: return sizeof(Operand);
    default: return -1;
  }
}

extern "C" int she_behz_lift(const Operand* x, void* out, long long m, int l_count, int n, const LiftParams* p,
                             void* stream) {
  if (m <= 0) return 0;
  if (x == nullptr || p == nullptr || bad_columns(n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (l_count) {
    case 1: return static_cast<int>(lift<1>(*x, out, m, n, *p, st));
    case 2: return static_cast<int>(lift<2>(*x, out, m, n, *p, st));
    case 3: return static_cast<int>(lift<3>(*x, out, m, n, *p, st));
    case 4: return static_cast<int>(lift<4>(*x, out, m, n, *p, st));
    case 5: return static_cast<int>(lift<5>(*x, out, m, n, *p, st));
    case 6: return static_cast<int>(lift<6>(*x, out, m, n, *p, st));
    case 7: return static_cast<int>(lift<7>(*x, out, m, n, *p, st));
    case 8: return static_cast<int>(lift<8>(*x, out, m, n, *p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int she_behz_floor(const Operand* y, void* out, long long m, int l_count, int n, const FloorParams* p,
                              void* stream) {
  if (m <= 0) return 0;
  if (y == nullptr || p == nullptr || bad_columns(n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (l_count) {
    case 1: return static_cast<int>(floor_q<1>(*y, out, m, n, *p, st));
    case 2: return static_cast<int>(floor_q<2>(*y, out, m, n, *p, st));
    case 3: return static_cast<int>(floor_q<3>(*y, out, m, n, *p, st));
    case 4: return static_cast<int>(floor_q<4>(*y, out, m, n, *p, st));
    case 5: return static_cast<int>(floor_q<5>(*y, out, m, n, *p, st));
    case 6: return static_cast<int>(floor_q<6>(*y, out, m, n, *p, st));
    case 7: return static_cast<int>(floor_q<7>(*y, out, m, n, *p, st));
    case 8: return static_cast<int>(floor_q<8>(*y, out, m, n, *p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int she_behz_tensor_mac(const void* la, const void* lb, void* out, long long m, int k_count, int moduli,
                                   int n, const MacParams* p, void* stream) {
  if (m <= 0) return 0;
  if (p == nullptr || k_count < 1 || moduli < 1 || moduli > kMaxExt || bad_columns(n))
    return static_cast<int>(cudaErrorInvalidValue);
  const i64 chunks = chunks_of(n);
  behz_tensor_mac_kernel<<<static_cast<unsigned>(m * moduli * chunks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(la), static_cast<const u64*>(lb), static_cast<u64*>(out), k_count, moduli, n, chunks,
      *p);
  return static_cast<int>(cudaGetLastError());
}
