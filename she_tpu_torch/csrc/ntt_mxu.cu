// The matrix NTT (she_tpu_torch/ops/ntt_mxu.py) as one fused launch a
// direction on Hopper's tensor cores (sm_90a): u8 x u8 -> s32 `wgmma` on
// base-2^7 digit tiles in shared memory.
//
// Replaces she_tpu/ops/ntt_mxu.py:310 _phase_row and :330 _phase_block,
// the jnp einsums (:319, :339) of she_tpu's opt-in NTT (SHE_TPU_NTT_MXU=1).
// Bit-identical to the port's plain versions (ntt_mxu.forward_factored_plain
// and inverse_factored_plain, and so to the butterfly NTT).
//
// Function. x int64 [batch, L, N] in [0, q_l), N = 64 A, viewed per
// polynomial-limb as X[a, b] = x[64 a + b] (A rows of 64). The last six
// forward stages of row a are one fixed 64 x 64 matrix times a twist:
// Rf[a] = R_f diag(s_f[a]), Ri[a] = diag(s_i[a]) R_i (ntt_mxu.py), so
//   forward: Z[a, v] = sum_b R_f[v, b] (s_f[a, b] Y[a, b]),  Y = Lf X;
//   inverse: out = Li W,  W[a, u] = s_i[a, u] sum_b R_i[u, b] X[a, b],
// every product mod q_l. Two GEMMs a direction, both by matrices shared by
// every polynomial of a modulus: the row GEMM (Lf or Li, [A, A], times the
// data's columns) and the block GEMM (the data's rows times R_f or R_i,
// [64, 64]). Each is D^2 digit-plane products (D = ceil(bits(q) / 7), digits
// in [0, 127]) summed in s32 by weight w = i + j (each weight below 2^31:
// K * 127^2 * D with K <= 128, D <= 9).
//
// Domain: N = 128 .. 8192 (A = 2 .. 128, a power of two), D <= 9, every
// q_l < 2^62, any batch, L * A <= 65535. The wrapper (ops/ntt_mxu_cuda.py)
// refuses anything else.
//
// Bound (H100 SXM: 3.35 TB/s, 1,979 dense int8 TOPS, 64 int32 lanes an SM):
// the larger of x read once and written once as int64 (the tables once),
// 2 D^2 (A + 64) int8 operations an output, and the integer instructions of
// the digit split, the recombination and the reductions on the CUDA cores.
// At the w32 cell's widest launch, [32, 128, 2, 3, 4096] (A = 64, D = 4),
// bytes bind (0.48 ms); at the w64 cell's [7, 128, 2, 3, 8192] (A = 128,
// D = 8) the int8 operations do (0.55 ms), with the integer work close.
//
// Design. A persistent block of four warpgroups (one block an SM) serves
// one modulus l (blockIdx.y) and walks its polynomial-limbs. Both matrices
// of the direction sit in shared memory for the whole launch, copied in
// once by cp.async.bulk on an mbarrier, as digit planes laid out by the host
// in wgmma's K-major no-swizzle layout (8-row x 16-byte core matrices, 128
// bytes apart along K, 8 K-bytes x 8 rows apart along the rows). A unit is
// one polynomial-limb and each warpgroup owns a 64 x 32 tile of its output:
// at A <= 64 two warpgroups share a unit (two units in flight a block), at
// A = 128 all four. For the forward at A <= 64 one bulk copy a unit stages
// the next unit's x in shared memory (one 8 N-byte copy); otherwise x comes
// from device memory, prefetched into L2 a unit ahead (at A = 128 there is
// no room; the inverse's reads of a staged row would meet bank conflicts). A unit's
// threads read x once, split every residue into D digits in registers and
// store them, 16 digits to a 16-byte store, in the layout the first GEMM
// reads:
// transposed (K = a) for the forward's row GEMM, as it is (K = b) for the
// inverse's block GEMM; 8-bit wgmma takes both operands K-major, so the
// transpose happens here and not in a pass of its own. A warpgroup computes
// its tile weight pair by weight pair, from the top: the wgmma m64n32k32 of
// weights 2g and 2g + 1 go to two s32 accumulator sets (the first product
// of each writes without reading, so the sets are dead between pairs), then
// the pair is added into a 64-bit running residue (see gemm): exactly at D
// <= 4 (the w32 cell), in 64-bit chunks of three pairs joined by a Shoup
// product above (two Shoup steps at the w64 cell's D = 8, not seven). So a
// thread holds two accumulator sets of 16 and the residues within 128
// registers. The first GEMM's epilogue folds the twist into its only
// reduction (a Shoup product of r by s), keeps the result lazy in [0, 2q)
// where 2q <= 2^7D (the w64 cell) and, once every warpgroup of the unit
// is done with x's digits, stores its digits over them in the layout the
// second GEMM reads; the second's epilogue reduces once (Barrett) and writes
// int64 straight to device memory. At D <= 4 (moduli below 2^28, the w32
// cell) the reductions run on 32-bit words: a float64 quotient estimate
// reduces the exact sum (reduce_small), a 32-bit Shoup product twists it,
// and the twist table holds 8 bytes an entry instead of 16; the forward
// then twists before the barrier and holds 32 bits a value across it. The
// layouts and the order of the phases follow measurements on the card
// (PERF.md, PR 13). Where both
// matrices and a unit do not fit 227 KB (A = 128 at D = 9), the matrices
// are copied in before each GEMM.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

typedef unsigned int u32;
typedef unsigned long long u64;

namespace {

constexpr int kWarpgroups = 4;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kSharedLimit = 232448;  // 227 KB of shared memory a block
constexpr int kMaxA = 128;
constexpr int kBlock = 64;             // the block GEMM's 64 x 64 matrix
constexpr int kBlockPlane = kBlock * kBlock;

__device__ __forceinline__ u32 shared_address(const void* p) {
  return static_cast<u32>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(u32 bar, u32 count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect_bytes(u32 bar, u32 bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ u64 global_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// waits for the phase of parity `parity`; a wait of more than 10 s (a lost
// copy: a whole launch takes milliseconds) traps, so a fault ends the launch
// with an error instead of holding the card
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

// bytes (a multiple of 16) from global to shared memory, counted on `bar`
__device__ __forceinline__ void bulk_load(u32 dst, const void* src, u32 bytes, u32 bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* src, u32 bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes) : "memory");
}

// the threads' shared-memory stores, made visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// a barrier of `count` threads (a multiple of 128) on named barrier `id`
__device__ __forceinline__ void unit_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// wgmma's descriptor of a K-major operand without swizzling at `address`:
// core matrices (8 rows x 16 bytes, 128 contiguous bytes) 128 bytes apart
// along K (the leading offset) and `rows8` bytes apart along the rows
__device__ __forceinline__ u64 descriptor(u32 address, u32 rows8) {
  return static_cast<u64>((address & 0x3FFFF) >> 4) | (static_cast<u64>(128 >> 4) << 16) |
         (static_cast<u64>(rows8 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

#define D4(o) "+r"(d[o]), "+r"(d[o + 1]), "+r"(d[o + 2]), "+r"(d[o + 3])
#define D8(o) D4(o), D4(o + 4)
#define D16(o) D8(o), D8(o + 8)
#define W4(o) "=r"(d[o]), "=r"(d[o + 1]), "=r"(d[o + 2]), "=r"(d[o + 3])
#define W16(o) W4(o), W4(o + 4), W4(o + 8), W4(o + 12)

// d (16 s32 sums a thread) += A (64 x 32 u8, descriptor a) . B (32 x 32
// u8, descriptor b)^T
__device__ __forceinline__ void wgmma32(int* d, u64 a, u64 b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : D16(0)
      : "l"(a), "l"(b));
}

// d = A . B^T: the first product of a sum, which reads nothing of d, so
// that the sums are dead between two weight pairs
__device__ __forceinline__ void wgmma32_first(int* d, u64 a, u64 b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : W16(0)
      : "l"(a), "l"(b));
}

#undef D4
#undef D8
#undef D16
#undef W4
#undef W16

// keeps the compiler from moving reads of the sums above the wait for the
// asynchronous wgmma
__device__ __forceinline__ void fence_sums(int* d) {
#pragma unroll
  for (int x = 0; x < 16; ++x) asm volatile("" : "+r"(d[x])::"memory");
}

// x mod q for x < 2^64, m = floor(2^64 / q): the estimate is floor(x / q)
// or one less, so one conditional subtraction finishes
__device__ __forceinline__ u64 barrett(u64 x, u64 q, u64 m) {
  u64 r = x - __umul64hi(x, m) * q;
  return r >= q ? r - q : r;
}

// r * w mod q in [0, 2q) for any r < 2^64, w < q < 2^63, ws = floor(w 2^64 / q)
__device__ __forceinline__ u64 shoup_lazy(u64 r, u64 w, u64 ws, u64 q) { return r * w - __umul64hi(r, ws) * q; }

// r mod q for r < 2^63 and q < 2^28 (D <= 4), inv_q = 1 / q in float64: the
// float64 quotient is within 2^-9 of r / q, so the estimate is floor(r / q)
// or one off either way, and the remainder, in (-q, 2q), fits 32 bits
__device__ __forceinline__ u32 reduce_small(u64 r, u32 q, double inv_q) {
  const u64 estimate = __double2ull_rz(__ull2double_rn(r) * inv_q);
  int rem = static_cast<int>(static_cast<u32>(r) - static_cast<u32>(estimate) * q);
  rem += rem < 0 ? static_cast<int>(q) : 0;
  rem -= rem >= static_cast<int>(q) ? static_cast<int>(q) : 0;
  return static_cast<u32>(rem);
}

// a * w mod q for a < 2^32, w < q < 2^31, ws = floor(w 2^32 / q), fully reduced
__device__ __forceinline__ u32 shoup32(u32 a, u32 w, u32 ws, u32 q) {
  const u32 v = a * w - __umulhi(a, ws) * q;
  return v >= q ? v - q : v;
}

// bits 7d .. 7d + 7 of v in the low byte (the digit is its low 7 bits)
__device__ __forceinline__ u32 digit_bits(u64 v, int d) {
  const u32 lo = static_cast<u32>(v), hi = static_cast<u32>(v >> 32);
  return 7 * d >= 32 ? hi >> (7 * d - 32) : __funnelshift_r(lo, hi, 7 * d);
}

// digit d of four residues, one byte each, in one word
__device__ __forceinline__ u32 digit_word(u64 v0, u64 v1, u64 v2, u64 v3, int d) {
  const u32 lo = __byte_perm(digit_bits(v0, d), digit_bits(v1, d), 0x0040);
  const u32 hi = __byte_perm(digit_bits(v2, d), digit_bits(v3, d), 0x0040);
  return __byte_perm(lo, hi, 0x5410) & 0x7F7F7F7Fu;
}

// digit d of sixteen residues, one byte each
__device__ __forceinline__ uint4 digit_chunk(const u64 (&v)[16], int d) {
  return make_uint4(digit_word(v[0], v[1], v[2], v[3], d), digit_word(v[4], v[5], v[6], v[7], d),
                    digit_word(v[8], v[9], v[10], v[11], d), digit_word(v[12], v[13], v[14], v[15], d));
}

// digit d of two residues in the low two bytes
__device__ __forceinline__ u32 digit_pair(u64 v0, u64 v1, int d) {
  return __byte_perm(digit_bits(v0, d), digit_bits(v1, d), 0x0040) & 0x7F7Fu;
}

struct Shape {
  const unsigned char* row_planes;  // [L, D, RR * KP]: Lf or Li, the row GEMM's A operand
  const unsigned char* block_planes;  // [L, D, 64 * 64]: R_f or R_i, the block GEMM's B operand
  const u64* twist;                 // [L, A, 64, 2]: (s, floor(s 2^64 / q)) of output (a, column);
                                    // at D <= 4 [L, A, 64]: s | floor(s 2^32 / q) << 32
  const u64* consts;                // [5, L]: q, floor(2^64 / q), 2^42 mod q, its Shoup constant, 1 / q (float64)
  const u64* x;
  u64* out;
  long long batch;
  int A, L;
  int RR, KP;     // rows of the row matrix's planes and of a unit's planes (max(A, 64)); K bytes (max(A, 32))
  int lazy;       // 2 max q <= 2^7D: the intermediate stays in [0, 2q)
  int resident;   // both matrices stay in shared memory for the launch
  int staged;     // a bulk copy stages each slot's next unit in shared memory
};

// the byte offset of (row, k) in a K-major no-swizzle operand of `kbytes`
// K bytes a row
__device__ __forceinline__ int tile_offset(int row, int k, int kbytes) {
  return (row >> 3) * (8 * kbytes) + (k >> 4) * 128 + (row & 7) * 16 + (k & 15);
}

// One GEMM of a unit: this warpgroup's 64 x 32 output tile, the residues
// r[k] of element k of the wgmma accumulator layout (row 16 warp + lane / 4 +
// 8 (k / 2 % 2), column 8 (k / 4) + 2 (lane % 4) + k % 2), below 2^64 and
// congruent to the product mod q. A operand planes at a_base + i a_plane
// (SBO a_rows8), B operand planes at b_base + j b_plane (SBO b_rows8), both
// 32 ksteps K bytes. The digit weights go in pairs, pair g = acc_2g + 2^7
// acc_2g+1 (below 2^32), and the pairs in chunks: a chunk's pairs add into r
// exactly, pair g shifted by 14 (g - first of the chunk). At D <= 4 one
// chunk holds every pair, since the exact sum fits 64 bits (K (q - 1)
// (2^7D - 1) < 2^64 for q < 2^28, K <= 128). Above, a chunk is three pairs
// (below 2^60), the chunks go from the top, and before each chunk but the
// first r <- r 2^42 mod q, a Shoup product (below 2q): r stays below 2q +
// 2^60 < 2^64, with two Shoup steps at D = 8 or 9.
template <int D>
__device__ __forceinline__ void gemm(u64 (&r)[16], int (&acc0)[16], int (&acc1)[16], u32 a_base, u32 a_plane,
                                     u32 a_rows8, u32 b_base, u32 b_plane, u32 b_rows8, int ksteps, u64 q, u64 c42,
                                     u64 c42s) {
  constexpr int kTop = 2 * D - 2;
  constexpr int kChunk = D <= 4 ? D : 3;  // pairs a chunk
  constexpr int kChunks = (D + kChunk - 1) / kChunk;
#pragma unroll
  for (int ci = kChunks - 1; ci >= 0; --ci) {
#pragma unroll
    for (int gc = 0; gc < kChunk; ++gc) {
      const int g = ci * kChunk + gc;
      if (g >= D) continue;
      const int w0 = 2 * g, w1 = 2 * g + 1;  // weight w1 exists below the top
      wgmma_fence();
      for (int ks = 0; ks < ksteps; ++ks) {
        const u32 step = ks * 256;  // 32 K bytes: two core matrices along K
#pragma unroll
        for (int i = 0; i < D; ++i) {
          const int j = w0 - i;
          if (j >= 0 && j < D) {
            const u64 a = descriptor(a_base + i * a_plane + step, a_rows8);
            const u64 b = descriptor(b_base + j * b_plane + step, b_rows8);
            if (ks == 0 && i == (w0 >= D ? w0 - D + 1 : 0)) wgmma32_first(acc0, a, b);
            else wgmma32(acc0, a, b);
          }
        }
        if (w1 <= kTop) {
#pragma unroll
          for (int i = 0; i < D; ++i) {
            const int j = w1 - i;
            if (j >= 0 && j < D) {
              const u64 a = descriptor(a_base + i * a_plane + step, a_rows8);
              const u64 b = descriptor(b_base + j * b_plane + step, b_rows8);
              if (ks == 0 && i == (w1 >= D ? w1 - D + 1 : 0)) wgmma32_first(acc1, a, b);
              else wgmma32(acc1, a, b);
            }
          }
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_sums(acc0);
      if (w1 <= kTop) fence_sums(acc1);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        // acc_w < 2^24.2 (D <= 9, K <= 128), so the pair fits 32 bits unsigned
        const u32 pair = w1 <= kTop ? static_cast<u32>(acc0[k]) + (static_cast<u32>(acc1[k]) << 7)
                                    : static_cast<u32>(acc0[k]);
        if (gc == 0) {
          if (ci == kChunks - 1) r[k] = pair;
          else r[k] = shoup_lazy(r[k], c42, c42s, q) + pair;
        } else {
          r[k] += static_cast<u64>(pair) << (14 * gc);
        }
      }
    }
  }
}

// the number of warpgroups that share a unit, each owning a 64 x 32 tile:
// all four at A = 128, two at A <= 64
__host__ __device__ constexpr int unit_warpgroups(int A) { return A > 64 ? 4 : 2; }

// The shared memory of a launch: the matrices (both resident, or the
// larger one at a time), each slot's digit planes (max(A, 64) x 64 bytes a
// digit) and, where `staged`, its staging of the next unit's x (8 N bytes),
// the mbarriers (one for the matrices, one a slot) and 1,024 bytes of
// slack to align the planes.
__host__ __device__ constexpr int row_plane_bytes(int A) { return (A > 64 ? A : 64) * (A > 32 ? A : 32); }
__host__ __device__ constexpr int matrix_bytes(int D, int A, bool resident) {
  return resident ? D * (row_plane_bytes(A) + kBlockPlane)
                  : D * (row_plane_bytes(A) > kBlockPlane ? row_plane_bytes(A) : kBlockPlane);
}
__host__ __device__ constexpr int slot_bytes(int D, int A, bool staged) {
  return D * (A > 64 ? A : 64) * 64 + (staged ? 8 * 64 * A : 0);
}
__host__ __device__ constexpr int shared_bytes(int D, int A, bool resident, bool staged) {
  return 1024 + matrix_bytes(D, A, resident) + (kWarpgroups / unit_warpgroups(A)) * slot_bytes(D, A, staged) +
         8 * (1 + kWarpgroups);
}

template <int D, bool kForward>
__global__ void __launch_bounds__(kThreads, 1) ntt_mxu_kernel(const Shape s) {
  constexpr bool kSmall = D <= 4;  // moduli below 2^28: 32-bit reductions
  // the forward at D <= 4 twists and reduces its first product before the
  // barrier and holds it in 32 bits; otherwise r waits and the twist follows
  constexpr bool kEarlyTwist = kSmall && kForward;
  using Held = typename std::conditional<kEarlyTwist, u32, u64>::type;
  extern __shared__ __align__(1024) unsigned char shared_raw[];
  unsigned char* smem = shared_raw + ((1024 - (shared_address(shared_raw) & 1023)) & 1023);
  const u32 base = shared_address(smem);
  const int A = s.A, L = s.L, N = 64 * A, RR = s.RR, KP = s.KP;
  const int row_plane = RR * KP, buf_plane = RR * 64;
  const int U = unit_warpgroups(A), slots = kWarpgroups / U;
  const int mbytes = matrix_bytes(D, A, s.resident), sbytes = slot_bytes(D, A, s.staged);
  const u32 bar = base + mbytes + slots * sbytes;  // the matrices' mbarrier; slot i's at bar + 8 (1 + i)
  const int l = blockIdx.y;
  // the warpgroup, read through a shuffle so that the compiler sees it uniform
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) >> 7, 0);
  const int slot = wg / U, hm = wg % U / 2, hn = wg % 2;  // this warpgroup's 64 rows and 32 columns
  const int unit_threads = 128 * U, tu = threadIdx.x - slot * unit_threads;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const u32 row_m = base;                                         // the row matrix's planes
  const u32 block_m = s.resident ? base + D * row_plane : base;  // the block matrix's planes
  unsigned char* buf = smem + mbytes + slot * sbytes;             // the unit's digit planes
  const u32 buf_a = shared_address(buf);
  const u64* stage = reinterpret_cast<const u64*>(buf + D * buf_plane);  // the unit's x, where staged
  const u32 stage_bar = bar + 8 * (1 + slot);
  const unsigned char* row_src = s.row_planes + static_cast<long long>(l) * D * row_plane;
  const unsigned char* block_src = s.block_planes + static_cast<long long>(l) * D * kBlockPlane;
  const u64 q = s.consts[l], bm = s.consts[L + l], c42 = s.consts[2 * L + l], c42s = s.consts[3 * L + l];
  const double inv_q = __longlong_as_double(static_cast<long long>(s.consts[4 * L + l]));
  const long long first = static_cast<long long>(blockIdx.x) * slots + slot;
  const long long stride = static_cast<long long>(gridDim.x) * slots;

  if (threadIdx.x == 0) {
    for (int i = 0; i <= slots; ++i) bar_init(bar + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  u32 copies = 0;  // matrix copies waited for: the mbarrier's phase
  auto copy_in = [&](bool row, bool block) {
    if (threadIdx.x == 0) {
      bar_expect_bytes(bar, (row ? D * row_plane : 0) + (block ? D * kBlockPlane : 0));
      if (row) bulk_load(row_m, row_src, D * row_plane, bar);
      if (block) bulk_load(block_m, block_src, D * kBlockPlane, bar);
    }
    bar_wait(bar, copies & 1);
    ++copies;
  };
  // unit p's x into this slot's staging, by one thread of the unit
  auto stage_in = [&](long long p) {
    fence_async_shared();
    bar_expect_bytes(stage_bar, 8 * N);
    bulk_load(shared_address(stage), s.x + (p * L + l) * N, 8 * N, stage_bar);
  };
  if (s.resident) copy_in(true, true);
  if (s.staged && tu == 0 && first < s.batch) stage_in(first);

  int acc0[16], acc1[16];
  u64 r[16];
  Held y[16];
  const int row_ksteps = KP / 32;
  const int m_warp = 16 * warp + (lane >> 2);  // and + 8: this thread's rows of a tile
  const int n_lane = 2 * (lane & 3);           // and + 1, + 8 j: its columns

  u32 units = 0;  // this slot's units so far: the staging mbarrier's phase
  for (long long p = first; p < s.batch; p += stride, ++units) {
    const long long offset = (p * L + l) * N;
    const u64* xg = s.x + offset;
    const u64* xp = s.staged ? stage : xg;
    u64* op = s.out + offset;
    unit_sync(1 + slot, unit_threads);  // the previous unit's GEMMs are done with buf
    if (s.staged) {
      bar_wait(stage_bar, units & 1);
    } else if (tu == 0 && p + stride < s.batch) {
      prefetch_l2(s.x + offset + stride * L * N, 8 * N);
    }
    // x -> digit planes, 16 residues a thread a step
    if constexpr (kForward) {
      // transposed (row b, K = a) for the row GEMM: 16 a of one b, each
      // load coalesced over the warp's consecutive b
      for (int item = tu; item < 64 * ((A + 15) / 16); item += unit_threads) {
        const int b = item & 63, a0 = 16 * (item >> 6);
        u64 v[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) v[i] = a0 + i < A ? xp[64 * (a0 + i) + b] : 0;
        unsigned char* dst = buf + tile_offset(b, a0, KP);
#pragma unroll
        for (int d = 0; d < D; ++d) *reinterpret_cast<uint4*>(dst + d * buf_plane) = digit_chunk(v, d);
      }
    } else {
      // as it is (row a, K = b) for the block GEMM: 16 b of one a
      for (int item = tu; item < 4 * A; item += unit_threads) {
        const int a = item % A, b0 = 16 * (item / A);
        u64 v[16];
        const ulonglong2* src = reinterpret_cast<const ulonglong2*>(xg + 64 * a + b0);  // never staged
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const ulonglong2 w = __ldg(src + i);
          v[2 * i] = w.x, v[2 * i + 1] = w.y;
        }
        unsigned char* dst = buf + tile_offset(a, b0, 64);
#pragma unroll
        for (int d = 0; d < D; ++d) *reinterpret_cast<uint4*>(dst + d * buf_plane) = digit_chunk(v, d);
      }
    }
    fence_async_shared();
    if (!s.resident) {
      unit_sync(1 + slot, unit_threads);
      copy_in(kForward, !kForward);
    }
    unit_sync(1 + slot, unit_threads);
    if (s.staged && tu == 0 && p + stride < s.batch) stage_in(p + stride);  // every thread has read the staging

    // the first GEMM; the forward at D <= 4 twists and reduces it at once,
    // held in 32 bits across the barrier (else the 64-bit residues r wait)
    if constexpr (kForward)  // Lf (rows 64 hm..) x X^T (rows b = 32 hn..)
      gemm<D>(r, acc0, acc1, row_m + hm * 64 * KP, row_plane, 8 * KP, buf_a + hn * 32 * KP, buf_plane, 8 * KP,
              row_ksteps, q, c42, c42s);
    else  // X (rows 64 hm..) x R_i^T (rows u = 32 hn..)
      gemm<D>(r, acc0, acc1, buf_a + hm * 64 * 64, buf_plane, 512, block_m + hn * 32 * 64, kBlockPlane, 512, 2,
              q, c42, c42s);
    if constexpr (kEarlyTwist) {
#pragma unroll
      for (int k = 0; k < 16; k += 2) {
        const int m = 64 * hm + m_warp + 8 * ((k >> 1) & 1), n = 32 * hn + 8 * (k >> 2) + n_lane;
        asm volatile("" ::: "memory");  // the twist loads wait for their outputs: fewer live registers
        if (m < A) {  // reduce, then a 32-bit Shoup product
          const ulonglong2 tw = __ldg(reinterpret_cast<const ulonglong2*>(s.twist + (static_cast<long long>(l) * A + m) * 64 + n));
          const u32 q32 = static_cast<u32>(q);
          y[k] = shoup32(reduce_small(r[k], q32, inv_q), static_cast<u32>(tw.x), static_cast<u32>(tw.x >> 32), q32);
          y[k + 1] =
              shoup32(reduce_small(r[k + 1], q32, inv_q), static_cast<u32>(tw.y), static_cast<u32>(tw.y >> 32), q32);
        }
      }
    }
    unit_sync(1 + slot, unit_threads);  // every warpgroup of the unit is done reading x's digits

    // the digits of the first product over x's, in the layout the second
    // reads; unless twisted already, its twist and reduction first
#pragma unroll
    for (int k = 0; k < 16; k += 2) {
      const int m = 64 * hm + m_warp + 8 * ((k >> 1) & 1), n = 32 * hn + 8 * (k >> 2) + n_lane;
      if constexpr (!kEarlyTwist) asm volatile("" ::: "memory");  // the twist loads wait for their outputs
      if (m < A) {
        if constexpr (!kEarlyTwist) {
          const long long e = (static_cast<long long>(l) * A + m) * 64 + n;  // the twist of (m, n)
          if constexpr (kSmall) {  // reduce, then a 32-bit Shoup product
            const ulonglong2 tw = __ldg(reinterpret_cast<const ulonglong2*>(s.twist + e));
            const u32 q32 = static_cast<u32>(q);
            y[k] = shoup32(reduce_small(r[k], q32, inv_q), static_cast<u32>(tw.x), static_cast<u32>(tw.x >> 32), q32);
            y[k + 1] =
                shoup32(reduce_small(r[k + 1], q32, inv_q), static_cast<u32>(tw.y), static_cast<u32>(tw.y >> 32), q32);
          } else {  // one Shoup product of the lazy sum
            const ulonglong2* tw = reinterpret_cast<const ulonglong2*>(s.twist) + e;
            const ulonglong2 t0 = __ldg(tw), t1 = __ldg(tw + 1);
            u64 y0 = shoup_lazy(r[k], t0.x, t0.y, q), y1 = shoup_lazy(r[k + 1], t1.x, t1.y, q);
            if (!s.lazy) {
              y0 = y0 >= q ? y0 - q : y0;
              y1 = y1 >= q ? y1 - q : y1;
            }
            y[k] = y0, y[k + 1] = y1;
          }
        }
        if constexpr (kForward) {  // as it is (row a, K = b) for the block GEMM
          unsigned char* dst = buf + tile_offset(m, n, 64);
#pragma unroll
          for (int d = 0; d < D; ++d)
            *reinterpret_cast<uint16_t*>(dst + d * buf_plane) =
                static_cast<uint16_t>(digit_pair(y[k], y[k + 1], d));
        } else {  // transposed (row u, K = a) for the row GEMM
          unsigned char* dst0 = buf + tile_offset(n, m, KP);
          unsigned char* dst1 = buf + tile_offset(n + 1, m, KP);
#pragma unroll
          for (int d = 0; d < D; ++d) {
            const u32 two = digit_pair(y[k], y[k + 1], d);
            dst0[d * buf_plane] = static_cast<unsigned char>(two);
            dst1[d * buf_plane] = static_cast<unsigned char>(two >> 8);
          }
        }
      }
    }
    fence_async_shared();
    if (!s.resident) {
      unit_sync(1 + slot, unit_threads);
      copy_in(!kForward, kForward);
    }
    unit_sync(1 + slot, unit_threads);

    // the second GEMM, reduced once and written: row m,
    // columns n, n + 1 (16 bytes)
    if constexpr (kForward)  // Y' (rows 64 hm..) x R_f^T (rows v = 32 hn..)
      gemm<D>(r, acc0, acc1, buf_a + hm * 64 * 64, buf_plane, 512, block_m + hn * 32 * 64, kBlockPlane, 512, 2,
              q, c42, c42s);
    else  // Li (rows 64 hm..) x W^T (rows u = 32 hn..)
      gemm<D>(r, acc0, acc1, row_m + hm * 64 * KP, row_plane, 8 * KP, buf_a + hn * 32 * KP, buf_plane, 8 * KP,
              row_ksteps, q, c42, c42s);
#pragma unroll
    for (int k = 0; k < 16; k += 2) {
      const int m = 64 * hm + m_warp + 8 * ((k >> 1) & 1), n = 32 * hn + 8 * (k >> 2) + n_lane;
      if (m < A) {
        ulonglong2 v;
        if constexpr (kSmall) {
          v.x = reduce_small(r[k], static_cast<u32>(q), inv_q);
          v.y = reduce_small(r[k + 1], static_cast<u32>(q), inv_q);
        } else {
          v.x = barrett(r[k], q, bm), v.y = barrett(r[k + 1], q, bm);
        }
        *reinterpret_cast<ulonglong2*>(op + 64 * m + n) = v;
      }
    }
  }
}

template <int D, bool kForward>
int launch(const Shape& s, int smem, dim3 grid, cudaStream_t stream) {
  auto kernel = ntt_mxu_kernel<D, kForward>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(s);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_direction(bool forward, const Shape& s, int smem, dim3 grid, cudaStream_t stream) {
  return forward ? launch<D, true>(s, smem, grid, stream) : launch<D, false>(s, smem, grid, stream);
}

}  // namespace

// Plain C interface for ctypes. Device pointers of contiguous tensors:
// row_planes int8 [L, D, max(A, 64) * max(A, 32)] (Lf forward, Li
// inverse) and block_planes int8 [L, D, 64 * 64] (R_f forward, R_i
// inverse), each plane the image of wgmma's K-major no-swizzle layout
// (ops/ntt_mxu_cuda.operand_image; rows and K past A are zero); twist
// int64 [L, A, 64, 2] (s_f or s_i and its Shoup constant), at D <= 4
// int64 [L, A, 64] (s | floor(s 2^32 / q) << 32); consts int64 [5, L] (q_l
// < 2^62, floor(2^64 / q_l), 2^42 mod q_l and its Shoup constant, the bits
// of 1 / q_l in float64); x and out int64 [batch, L, 64 A], 16-byte
// aligned. lazy: 2 max q <= 2^7D. `stream` is a cudaStream_t. The wrapper checks shapes, types
// and bounds. Returns a cudaError_t value (0 on success) covering the
// launch itself.
extern "C" int she_ntt_mxu(const void* row_planes, const void* block_planes, const void* twist, const void* consts,
                           const void* x, void* out, int D, int A, int L, int forward, int lazy, long long batch,
                           void* stream) {
  if (D < 1 || D > 9 || A < 2 || A > kMaxA || (A & (A - 1)) || L < 1 || batch < 1 ||
      static_cast<long long>(L) * A > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Shape s;
  s.row_planes = static_cast<const unsigned char*>(row_planes);
  s.block_planes = static_cast<const unsigned char*>(block_planes);
  s.twist = static_cast<const u64*>(twist);
  s.consts = static_cast<const u64*>(consts);
  s.x = static_cast<const u64*>(x);
  s.out = static_cast<u64*>(out);
  s.batch = batch;
  s.A = A, s.L = L;
  s.RR = A > 64 ? A : 64, s.KP = A > 32 ? A : 32;
  s.lazy = lazy != 0;
  s.resident = shared_bytes(D, A, true, false) <= kSharedLimit;
  // the inverse reads 16 residues of one row a thread, which a staged row
  // serves with 8-way bank conflicts: only the forward is staged
  s.staged = forward != 0 && s.resident && shared_bytes(D, A, true, true) <= kSharedLimit;
  const int smem = shared_bytes(D, A, s.resident, s.staged);
  if (smem > kSharedLimit) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one block an SM, each serving one modulus; no more blocks than units
  const long long slots = kWarpgroups / unit_warpgroups(A);
  long long per_l = (sms + L - 1) / L;
  const long long needed = (batch + slots - 1) / slots;
  if (per_l > needed) per_l = needed;
  if (per_l < 1) per_l = 1;
  const dim3 grid(static_cast<unsigned>(per_l), static_cast<unsigned>(L));
  auto st = static_cast<cudaStream_t>(stream);
  const bool fwd = forward != 0;
  switch (D) {
#define SHE_D(d) \
  case d:        \
    return launch_direction<d>(fwd, s, smem, grid, st);
    SHE_D(1) SHE_D(2) SHE_D(3) SHE_D(4) SHE_D(5) SHE_D(6) SHE_D(7) SHE_D(8) SHE_D(9)
#undef SHE_D
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
