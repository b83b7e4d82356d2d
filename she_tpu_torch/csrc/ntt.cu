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
// The device code of points 1-3 (butterflies, rounds, exchanges, twiddle
// loads, row tables) lives in csrc/ntt_device.cuh, which the key switch's
// fused route (csrc/key_switch.cu: ks_digits_ntt_mac, ks_intt_finish) also
// includes: on the 32-bit route at N <= 4096 the key switch runs its
// transforms there in registers, and these kernels serve every other NTT
// (the dim-0 stage's, BEHZ's, the plaintexts') and the key switch of every
// other shape (the split route).
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

#include "ntt_device.cuh"

namespace {

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
