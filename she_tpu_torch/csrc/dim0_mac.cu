// The dim-0 MAC for Hopper (sm_90a): a sum over j of products of two
// operands, per RNS row and coefficient,
//
//   out[m1, m2, l, k] = sum_j A[m1, j, l, k] * B[j, m2, l, k]  mod q_l,
//
// fully reduced into [0, q_l). It replaces what she_tpu leaves to XLA to
// fuse (none of it is a Pallas kernel):
//   she_tpu/pir/serving.py:318 dim0_inner_products and :344
//     _dim0_inner_products_w64 (A the database chunk [C, d0, L, N], B the
//     query's dim-0 ciphertexts [d0, 2B, L, N]);
//   she_tpu/pnns/serving.py:52 bsgs_inner_products and :75
//     _bsgs_inner_products_w64 (A the diagonals [G, R, J, L, N], a view of
//     the packed [G, J, R, L, N]; B the baby-step rotations [J, B, 2, L, N]);
//   she_tpu/bfv/bfv.py:876 inner_product_ct_pt (A the plaintexts
//     [1, K, L, N], B one component of the ciphertexts [K, ..., L, N]).
// The plain version is she_tpu_torch/ops/dim0_mac.py's (the lazy stream of
// ops/modarith.sum_products_mod); both write the unique residue, so they
// agree bit for bit while each keeps its own lazy schedule.
//
// Data: int64 words holding residues in [0, q), moduli in [2, 2^62), any
// N. Both operands are read in place: element (batch..., j, l, k) lies at
// base + offset(batch) + j * jstride + l * lstride + k (Operand of
// csrc/modarith64.cuh for the batch axes), so the strided d0 slice of a
// database chunk and the permuted PNNS diagonals cost no copy.
//
// Bound: bytes, once B, the large operand, comes from device memory once.
// At the w64 cell (A [4, 11, 2, 8192], B [11, 256, 2, 8192], out [4, 256,
// 2, 8192]) B is 369.1 MB, out 134.2 MB and A 5.8 MB: 0.152 ms at 3.35 TB/s.
// A block owns one RNS row l, 32 coefficients (a warp's width: lane x of a
// row of threads takes coefficient k, so every access is one contiguous
// run), a group of MG rows of A (m1) and a run of m2, walked by `lanes`
// rows of threads that share the group's words of A: row y takes the m2 at
// y, y + lanes, ... MG covers all of M1 where it fits the registers (up to
// 16; more is split into as few groups as possible) and every accumulator
// of the group is live, so each word of B is loaded once a group. Each
// thread copies with cp.async: its rows' share of the group's words of A
// once (rows past M1 are zero, so the multiply-adds need no branch), then
// the J words of B of each of its m2 into its ring of D steps, D - 1 ahead
// of the one it multiplies.
//
// Three instances by word (the host picks one from the moduli, as
// ops/modarith picks a route). W = 32 where every modulus is below 2^32
// (the w32 sets, PNNS at both cells, ct x pt at w32): a product is one
// 32 x 32 -> 64-bit multiply-add (mad.wide.u32) into a u64 accumulator,
// reduced by floor(2^64 / q). Above 2^32 the exact 64 x 64 -> 128-bit
// multiply-add (__umul64hi, whose IMAD.HI issues at under half the rate of
// a 32-bit IMAD on the H100, and its carries) made the multiply-adds, not
// the bytes, the bound at the w64 cell (tools/mac_floor_turns.py --rates;
// PERF.md): each word is split at `shift` = ceil(log2 q_max / 2) bits into
// two limbs below 2^31, and the products are mad.wide.u32 (near the rate of
// a 32-bit IMAD) summed by limb into u64 sums with no carries, as few of
// them as the moduli allow. W = 60
// where every modulus is below 2^60 (the w64 sets): Karatsuba, three
// multiply-adds a product, s0 += a0 b0, s2 += a1 b1, sm += (a0 + a1)(b0 +
// b1), the middle sum s1 = sm - s0 - s2; W = 64 otherwise: four, s1 += a0
// b1 + a1 b0. The sums are folded into the 128-bit s0 + s1 2^shift + s2
// 2^(2 shift) and reduced by floor(2^128 / q). The host gives `cap`, the
// products a set of sums takes after a reduction (32: r + cap (q - 1)^2 <
// 2^64, 1 near 2^32; 60: cap 2^(2 shift + 2) + 2^(2 shift) <= 2^64, 63 at
// 55 bits; 64: 2 cap 2^(2 shift) <= 2^64, 1 near 2^62), and the kernel
// reduces after each `cap` products and once at the end.

#include "modarith64.cuh"

namespace {

constexpr int kColumns = 32;  // coefficients a block
constexpr int kMaxThreads = 256;

template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(BYTES) : "memory");
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc + a * b, one IMAD.WIDE.U32
__device__ __forceinline__ u64 mad_wide(unsigned a, unsigned b, u64 acc) {
  u64 d;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(acc));
  return d;
}

struct MacArgs {
  Operand a, b;
  i64 a_js, b_js;
  u64* out;
  i64 m1, m2, groups;
  int j_count, l_count, n, k_blocks, group, run, cap, shift;
  const u64* consts;
};

template <int W>
struct Word;

// Residues below 2^32: the low word of each int64, one multiply-add a product.
template <>
struct Word<32> {
  typedef unsigned A;  // a word of A as staged
  typedef unsigned B;  // a word of B as staged
  typedef unsigned Limbs;
  typedef u64 Acc;
  static constexpr int kBytes = 4;
  static __device__ __forceinline__ void prepare(A&, int) {}
  static __device__ __forceinline__ A load_a(const u64* p, int) { return __ldg(reinterpret_cast<const unsigned*>(p)); }
  static __device__ __forceinline__ B load_b(const u64* p) { return __ldg(reinterpret_cast<const unsigned*>(p)); }
  static __device__ __forceinline__ Limbs split(B b, int) { return b; }
  static __device__ __forceinline__ void zero(Acc& acc) { acc = 0; }
  static __device__ __forceinline__ void mac(Acc& acc, A a, Limbs b) { acc = mad_wide(a, b, acc); }
  static __device__ __forceinline__ u64 residue(const Acc& acc, const Mod& m, int) { return reduce64(acc, m); }
  static __device__ __forceinline__ void restart(Acc& acc, u64 r) { acc = r; }
};

// Residues below 2^62 as two limbs of `shift` bits: the staged word of A is
// split in place once, each word of B when it is read.
struct TwoLimbs {
  typedef uint2 A;  // (low limb, high limb) once prepared; the raw u64 as copied
  typedef u64 B;
  static constexpr int kBytes = 8;
  static __device__ __forceinline__ A limbs(u64 v, int shift) {
    return make_uint2(static_cast<unsigned>(v & ((1ULL << shift) - 1)), static_cast<unsigned>(v >> shift));
  }
  static __device__ __forceinline__ void prepare(A& a, int shift) { a = limbs((static_cast<u64>(a.y) << 32) | a.x, shift); }
  static __device__ __forceinline__ A load_a(const u64* p, int shift) { return limbs(__ldg(p), shift); }
  static __device__ __forceinline__ B load_b(const u64* p) { return __ldg(p); }
  // s0 + s1 2^shift + s2 2^(2 shift) (below 2^125) mod q
  static __device__ __forceinline__ u64 fold(u64 s0, u64 s1, u64 s2, const Mod& m, int shift) {
    u64 lo = s0, hi = 0;
    const u64 t = s1 << shift;
    lo += t;
    hi += (s1 >> (64 - shift)) + (lo < t);
    const u64 v = s2 << (2 * shift);
    lo += v;
    hi += (s2 >> (64 - 2 * shift)) + (lo < v);
    return reduce128(hi, lo, m);
  }
};

// Four products a product: s1 takes a0 b1 + a1 b0 (moduli below 2^62).
template <>
struct Word<64> : TwoLimbs {
  typedef uint2 Limbs;
  struct Acc {
    u64 s0, s1, s2;
  };
  static __device__ __forceinline__ Limbs split(B b, int shift) {
    return make_uint2(static_cast<unsigned>(b & ((1ULL << shift) - 1)), static_cast<unsigned>(b >> shift));
  }
  static __device__ __forceinline__ void zero(Acc& acc) { acc.s0 = acc.s1 = acc.s2 = 0; }
  static __device__ __forceinline__ void mac(Acc& acc, A a, Limbs b) {
    acc.s0 = mad_wide(a.x, b.x, acc.s0);
    acc.s1 = mad_wide(a.x, b.y, acc.s1);
    acc.s1 = mad_wide(a.y, b.x, acc.s1);
    acc.s2 = mad_wide(a.y, b.y, acc.s2);
  }
  static __device__ __forceinline__ u64 residue(const Acc& acc, const Mod& m, int shift) {
    return fold(acc.s0, acc.s1, acc.s2, m, shift);
  }
  static __device__ __forceinline__ void restart(Acc& acc, u64 r) {
    acc.s0 = r;
    acc.s1 = acc.s2 = 0;
  }
};

// Karatsuba, three products a product (moduli below 2^60, so limb sums stay
// below 2^31): sm takes (a0 + a1)(b0 + b1), and s1 = sm - s0 - s2.
template <>
struct Word<60> : TwoLimbs {
  typedef uint3 Limbs;  // b0, b1, b0 + b1
  struct Acc {
    u64 s0, sm, s2;
  };
  static __device__ __forceinline__ Limbs split(B b, int shift) {
    const unsigned b0 = static_cast<unsigned>(b & ((1ULL << shift) - 1)), b1 = static_cast<unsigned>(b >> shift);
    return make_uint3(b0, b1, b0 + b1);
  }
  static __device__ __forceinline__ void zero(Acc& acc) { acc.s0 = acc.sm = acc.s2 = 0; }
  static __device__ __forceinline__ void mac(Acc& acc, A a, Limbs b) {
    acc.s0 = mad_wide(a.x, b.x, acc.s0);
    acc.s2 = mad_wide(a.y, b.y, acc.s2);
    acc.sm = mad_wide(a.x + a.y, b.z, acc.sm);
  }
  static __device__ __forceinline__ u64 residue(const Acc& acc, const Mod& m, int shift) {
    return fold(acc.s0, acc.sm - acc.s0 - acc.s2, acc.s2, m, shift);
  }
  static __device__ __forceinline__ void restart(Acc& acc, u64 r) {
    acc.s0 = acc.sm = r;
    acc.s2 = 0;
  }
};

// Block (k block, l, m1 group, m2 run) of 32 x `lanes` threads: thread
// (x, y) owns coefficient k = k block * 32 + x and the m2 of the run at y,
// y + lanes, ... Dynamic shared memory: the batch offsets of the group's
// rows of A and of the run's rows of B (computed once, by the block's
// threads), the group's words of A [j][t < MG][32], then each row's ring of
// B, D steps of [j][32]. D = 0 is the direct instance, for a J too deep
// for the group's A and a ring to fit a block: every word of A and B is
// loaded where it lies for each product (A's from L1 or L2), rows past M1
// read row 0 and are not stored.
template <int W, int MG, int D>
__global__ void __launch_bounds__(kMaxThreads) dim0_mac_kernel(const __grid_constant__ MacArgs p) {
  typedef Word<W> Wd;
  extern __shared__ __align__(16) unsigned char smem[];
  i64* a_off = reinterpret_cast<i64*>(smem);
  i64* b_off = a_off + MG;
  i64 blk = blockIdx.x;
  const int kb = static_cast<int>(blk % p.k_blocks);
  blk /= p.k_blocks;
  const int l = static_cast<int>(blk % p.l_count);
  blk /= p.l_count;
  const i64 m1_0 = (blk % p.groups) * p.group, m2_0 = (blk / p.groups) * p.run;
  const int tn = static_cast<int>(min(static_cast<i64>(p.group), p.m1 - m1_0));
  const int sn = static_cast<int>(min(static_cast<i64>(p.run), p.m2 - m2_0));
  const int lanes = blockDim.y, col = threadIdx.x, lane = threadIdx.y;
  for (int i = lane * kColumns + col; i < tn + sn; i += kColumns * lanes) {
    if (i < tn)
      a_off[i] = batch_offset(p.a, m1_0 + i) + l * p.a.lstride;
    else
      b_off[i - tn] = batch_offset(p.b, m2_0 + i - tn) + l * p.b.lstride;
  }
  __syncthreads();
  const int k = kb * kColumns + col;
  const bool live = k < p.n;  // a thread past N still takes part in the barriers
  const int J = p.j_count;
  const int steps = lane < sn ? (sn - lane + lanes - 1) / lanes : 0;  // this row's m2: lane + lanes * step
  const Mod md = load_mod(p.consts, l);
  if (D == 0) {
    if (!live) return;
    const u64* ap[MG];
#pragma unroll
    for (int t = 0; t < MG; ++t) ap[t] = p.a.base + a_off[t < tn ? t : 0] + k;
    for (int step = 0; step < steps; ++step) {
      const i64 m2 = m2_0 + lane + lanes * step;
      const u64* bp = p.b.base + b_off[lane + lanes * step] + k;
      typename Wd::Acc acc[MG];
#pragma unroll
      for (int t = 0; t < MG; ++t) Wd::zero(acc[t]);
      for (int j0 = 0; j0 < J; j0 += p.cap) {
        if (j0 > 0) {
#pragma unroll
          for (int t = 0; t < MG; ++t) Wd::restart(acc[t], Wd::residue(acc[t], md, p.shift));
        }
        const int end = min(J, j0 + p.cap);
        for (int j = j0; j < end; ++j) {
          const typename Wd::Limbs bj = Wd::split(Wd::load_b(bp + j * p.b_js), p.shift);
#pragma unroll
          for (int t = 0; t < MG; ++t) Wd::mac(acc[t], Wd::load_a(ap[t] + j * p.a_js, p.shift), bj);
        }
      }
#pragma unroll
      for (int t = 0; t < MG; ++t) {
        if (t < tn)
          p.out[(((m1_0 + t) * p.m2 + m2) * p.l_count + l) * static_cast<i64>(p.n) + k] =
              Wd::residue(acc[t], md, p.shift);
      }
    }
    return;
  }
  constexpr int kDepth = D > 0 ? D : 1;
  typename Wd::A* sa = reinterpret_cast<typename Wd::A*>(b_off + p.run) + col;
  typename Wd::B* ring = reinterpret_cast<typename Wd::B*>(sa - col + MG * J * kColumns) + lane * kDepth * J * kColumns + col;
  if (live) {
    for (int i = lane; i < J * MG; i += lanes) {
      const int j = i / MG, t = i - j * MG;
      if (t < tn)
        copy_async<Wd::kBytes>(&sa[i * kColumns], p.a.base + a_off[t] + j * p.a_js + k);
      else
        sa[i * kColumns] = typename Wd::A{};
    }
  }
  copy_commit();
  auto issue = [&](int step) {
    typename Wd::B* dst = ring + (step % kDepth) * J * kColumns;
    const u64* src = p.b.base + b_off[lane + lanes * step] + k;
    for (int j = 0; j < J; ++j) copy_async<Wd::kBytes>(dst + j * kColumns, src + j * p.b_js);
  };
#pragma unroll
  for (int step = 0; step < kDepth - 1; ++step) {
    if (live && step < steps) issue(step);
    copy_commit();
  }
  copy_wait<kDepth - 1>();  // this thread's words of A have landed
  __syncthreads();
  if (live) {
    for (int i = lane; i < J * MG; i += lanes) Wd::prepare(sa[i * kColumns], p.shift);
  }
  __syncthreads();
  if (!live) return;
  for (int step = 0; step < steps; ++step) {
    if (step + kDepth - 1 < steps) issue(step + kDepth - 1);
    copy_commit();
    copy_wait<kDepth - 1>();  // the steps up to this one have landed
    const typename Wd::B* bv = ring + (step % kDepth) * J * kColumns;
    typename Wd::Acc acc[MG];
#pragma unroll
    for (int t = 0; t < MG; ++t) Wd::zero(acc[t]);
    for (int j0 = 0; j0 < J; j0 += p.cap) {
      if (j0 > 0) {
#pragma unroll
        for (int t = 0; t < MG; ++t) Wd::restart(acc[t], Wd::residue(acc[t], md, p.shift));
      }
      const int end = min(J, j0 + p.cap);
#pragma unroll 2
      for (int j = j0; j < end; ++j) {
        const typename Wd::Limbs bj = Wd::split(bv[j * kColumns], p.shift);
        const typename Wd::A* aj = sa + j * MG * kColumns;
#pragma unroll
        for (int t = 0; t < MG; ++t) Wd::mac(acc[t], aj[t * kColumns], bj);
      }
    }
    const i64 m2 = m2_0 + lane + lanes * step;
#pragma unroll
    for (int t = 0; t < MG; ++t) {
      if (t < tn)
        p.out[(((m1_0 + t) * p.m2 + m2) * p.l_count + l) * static_cast<i64>(p.n) + k] = Wd::residue(acc[t], md, p.shift);
    }
  }
}

size_t shared_bytes(int word_bits, int mg, int run, int depth, int lanes, int j_count) {
  if (depth == 0) return sizeof(i64) * (mg + run);
  return sizeof(i64) * (mg + run) +
         static_cast<size_t>(word_bits == 32 ? 4 : 8) * kColumns * j_count * (mg + static_cast<size_t>(lanes) * depth);
}

template <int W, int MG, int D>
cudaError_t launch(MacArgs& p, int lanes, cudaStream_t st) {
  p.k_blocks = (p.n + kColumns - 1) / kColumns;
  p.groups = (p.m1 + p.group - 1) / p.group;
  const i64 blocks = static_cast<i64>(p.k_blocks) * p.l_count * p.groups * ((p.m2 + p.run - 1) / p.run);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem = shared_bytes(W, MG, p.run, D, lanes, p.j_count);
  auto kernel = dim0_mac_kernel<W, MG, D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(blocks), dim3(kColumns, lanes), smem, st>>>(p);
  return cudaGetLastError();
}

template <int W, int MG>
cudaError_t launch_depth(int depth, MacArgs& p, int lanes, cudaStream_t st) {
  if (depth == 0) return launch<W, MG, 0>(p, lanes, st);
  if (depth == 1) return launch<W, MG, 1>(p, lanes, st);
  if (depth == 2) return launch<W, MG, 2>(p, lanes, st);
  return cudaErrorInvalidValue;
}

template <int W>
cudaError_t launch_word(int mg, int depth, MacArgs& p, int lanes, cudaStream_t st) {
  switch (mg) {
    case 1: return launch_depth<W, 1>(depth, p, lanes, st);
    case 2: return launch_depth<W, 2>(depth, p, lanes, st);
    case 4: return launch_depth<W, 4>(depth, p, lanes, st);
    case 8: return launch_depth<W, 8>(depth, p, lanes, st);
    case 12: return launch_depth<W, 12>(depth, p, lanes, st);
    case 16: return launch_depth<W, 16>(depth, p, lanes, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The launch plan (word_bits: 32, 60 or 64; group, lanes, run, depth: 0
// the direct instance) is the wrapper's (ops/dim0_mac_cuda.plan); the
// instance takes the least of
// 1, 2, 4, 8, 12 and 16 accumulators at or above `group`; `shift` is the
// limb width of the 60- and 64-bit instances.
extern "C" int she_dim0_mac(const Operand* a, long long a_js, const Operand* b, long long b_js, void* out,
                            long long m1, long long m2, int j_count, int l_count, int n, const void* consts, int cap,
                            int shift, int word_bits, int group, int lanes, int run, int depth, void* stream) {
  if (m1 <= 0 || m2 <= 0 || n <= 0) return 0;
  if (a == nullptr || b == nullptr || j_count < 1 || l_count < 1 || cap < 1 || a->nd > kMaxDims || b->nd > kMaxDims ||
      group < 1 || group > 16 || run < 1 || lanes < 1 || kColumns * lanes > kMaxThreads ||
      (word_bits != 32 && (shift < 1 || shift > (word_bits == 60 ? 30 : 31))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int mg = group <= 2 ? group : group <= 4 ? 4 : group <= 8 ? 8 : group <= 12 ? 12 : 16;
  if (shared_bytes(word_bits, mg, run, depth, lanes, j_count) > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  MacArgs p{*a, *b, a_js, b_js, static_cast<u64*>(out), m1, m2, 0, j_count, l_count, n, 0, group, run, cap, shift,
            static_cast<const u64*>(consts)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (word_bits == 32) return static_cast<int>(launch_word<32>(mg, depth, p, lanes, st));
  if (word_bits == 60) return static_cast<int>(launch_word<60>(mg, depth, p, lanes, st));
  if (word_bits == 64) return static_cast<int>(launch_word<64>(mg, depth, p, lanes, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
