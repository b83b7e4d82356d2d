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
// Bound: bytes. At the w64 cell (A [4, 11, 2, 8192], B [11, 256, 2, 8192],
// out [4, 256, 2, 8192]) B is 369.1 MB, out 134.2 MB and A 5.8 MB: 0.152 ms
// at 3.35 TB/s. A thread owns one coefficient k of one RNS row l for a tile
// of MT rows of A (m1) by M2T of B (m2), and keeps MT x M2T 128-bit
// accumulators in registers. Per j it loads its M2T words of B and MT words
// of A (__ldg; the same A words serve every m2 tile, so they come from L2)
// and runs MT x M2T exact 64 x 64 -> 128-bit multiply-adds. Neighbouring
// threads take neighbouring k, so every warp access is one contiguous
// 256-byte run. The kernel does not reach its byte bound: at the w64 cell
// it runs at a third of it, the 2 x 2 tile reading B twice, so the 64-bit
// multiplies and the loads' latency hold it, not the bytes. Wider tiles
// (up to 16 accumulators, 208 registers) and issuing the loads of 4 values
// of j before their multiply-adds were measured no faster and are not
// built (PERF.md). A product of
// residues below 2^62 is below 2^124, so a sum of 17 can pass 2^128: the
// host gives `cap`, the products the accumulator takes after a reduction
// (r + cap (q - 1)^2 < 2^128 for every modulus, 16 near 2^62, more for
// narrower moduli), and the kernel reduces every accumulator to its
// residue after each `cap` products and once at the end.

#include "modarith64.cuh"

namespace {

constexpr int kThreads = 256;

// Block (m1 tile, m2 tile, l, k block); thread k of the block's run of kThreads
// coefficients. The batch offsets of the block's MT rows of A and M2T rows of
// B are computed once, by the first threads, into shared memory.
template <int MT, int M2T>
__global__ void __launch_bounds__(kThreads) dim0_mac_kernel(Operand a, i64 a_js, Operand b, i64 b_js,
                                                             u64* __restrict__ out, i64 m1_count, i64 m2_count,
                                                             int j_count, int l_count, int n, int k_blocks,
                                                             i64 m2_tiles, const u64* __restrict__ consts, int cap) {
  __shared__ i64 a_off[MT], b_off[M2T];
  i64 blk = blockIdx.x;
  const int kb = static_cast<int>(blk % k_blocks);
  blk /= k_blocks;
  const int l = static_cast<int>(blk % l_count);
  blk /= l_count;
  const i64 m1_0 = (blk / m2_tiles) * MT, m2_0 = (blk % m2_tiles) * M2T;
  const int tn = static_cast<int>(min(static_cast<i64>(MT), m1_count - m1_0));
  const int sn = static_cast<int>(min(static_cast<i64>(M2T), m2_count - m2_0));
  if (threadIdx.x < MT) {
    const int t = threadIdx.x;
    a_off[t] = t < tn ? batch_offset(a, m1_0 + t) + l * a.lstride : 0;
  } else if (threadIdx.x < MT + M2T) {
    const int s = threadIdx.x - MT;
    b_off[s] = s < sn ? batch_offset(b, m2_0 + s) + l * b.lstride : 0;
  }
  __syncthreads();
  const int k = kb * kThreads + threadIdx.x;
  if (k >= n) return;
  const Mod md = load_mod(consts, l);
  u64 hi[MT][M2T], lo[MT][M2T];
#pragma unroll
  for (int t = 0; t < MT; ++t) {
#pragma unroll
    for (int s = 0; s < M2T; ++s) hi[t][s] = lo[t][s] = 0;
  }
  int count = 0;
  for (int j = 0; j < j_count; ++j) {
    if (count == cap) {
#pragma unroll
      for (int t = 0; t < MT; ++t) {
#pragma unroll
        for (int s = 0; s < M2T; ++s) {
          lo[t][s] = reduce128(hi[t][s], lo[t][s], md);
          hi[t][s] = 0;
        }
      }
      count = 0;
    }
    u64 av[MT], bv[M2T];
#pragma unroll
    for (int t = 0; t < MT; ++t) av[t] = t < tn ? __ldg(a.base + a_off[t] + j * a_js + k) : 0;
#pragma unroll
    for (int s = 0; s < M2T; ++s) bv[s] = s < sn ? __ldg(b.base + b_off[s] + j * b_js + k) : 0;
#pragma unroll
    for (int t = 0; t < MT; ++t) {
#pragma unroll
      for (int s = 0; s < M2T; ++s) mac128(hi[t][s], lo[t][s], av[t], bv[s]);
    }
    ++count;
  }
#pragma unroll
  for (int t = 0; t < MT; ++t) {
#pragma unroll
    for (int s = 0; s < M2T; ++s) {
      if (t < tn && s < sn)
        out[(((m1_0 + t) * m2_count + m2_0 + s) * l_count + l) * static_cast<i64>(n) + k] =
            reduce128(hi[t][s], lo[t][s], md);
    }
  }
}

template <int MT, int M2T>
cudaError_t launch(const Operand& a, i64 a_js, const Operand& b, i64 b_js, u64* out, i64 m1, i64 m2, int j_count,
                   int l_count, int n, const u64* consts, int cap, cudaStream_t st) {
  const int k_blocks = (n + kThreads - 1) / kThreads;
  const i64 m1_tiles = (m1 + MT - 1) / MT, m2_tiles = (m2 + M2T - 1) / M2T;
  const i64 blocks = m1_tiles * m2_tiles * l_count * k_blocks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  dim0_mac_kernel<MT, M2T><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      a, a_js, b, b_js, out, m1, m2, j_count, l_count, n, k_blocks, m2_tiles, consts, cap);
  return cudaGetLastError();
}

}  // namespace

// The tile (mt, m2t) is the wrapper's choice (ops/dim0_mac_cuda.tile), one
// of the five instances built here (ops/dim0_mac_cuda.TILES).
extern "C" int she_dim0_mac(const Operand* a, long long a_js, const Operand* b, long long b_js, void* out,
                            long long m1, long long m2, int j_count, int l_count, int n, const void* consts, int cap,
                            int mt, int m2t, void* stream) {
  if (m1 <= 0 || m2 <= 0 || n <= 0) return 0;
  if (a == nullptr || b == nullptr || j_count < 1 || l_count < 1 || cap < 1 || a->nd > kMaxDims || b->nd > kMaxDims)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  u64* o = static_cast<u64*>(out);
  const u64* c = static_cast<const u64*>(consts);
#define SHE_DIM0_MAC_TILE(MT, M2T) \
  if (mt == MT && m2t == M2T) return static_cast<int>(launch<MT, M2T>(*a, a_js, *b, b_js, o, m1, m2, j_count, l_count, n, c, cap, st));
  SHE_DIM0_MAC_TILE(1, 1) SHE_DIM0_MAC_TILE(1, 2) SHE_DIM0_MAC_TILE(1, 4) SHE_DIM0_MAC_TILE(2, 1)
  SHE_DIM0_MAC_TILE(2, 2)
#undef SHE_DIM0_MAC_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}
