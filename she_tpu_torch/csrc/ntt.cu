// Negacyclic NTT, forward and inverse, for Hopper (sm_90a).
//
// Replaces she_tpu/ops/ntt_pallas.py:_fwd_kernel and _inv_kernel (the fused
// Pallas TPU NTT) and the staged XLA NTT they are bit-identical to
// (she_tpu/ops/ntt.py:forward_ntt_arrays / inverse_ntt_arrays).
//
// Data: int64 words read as u64, [rows, N] row-major; row r is transformed
// modulo q[r % L] with its modulus' tables. Tables are [L, N] u64 (roots and
// inverse roots in the bit-reversed order of utils/refimpl.ntt_root_tables,
// each with its Shoup constant floor(w * 2^64 / q)) and per-modulus scalars
// q, n^-1, n^-1 * w^-1 with their Shoup constants.
//
// Arithmetic: Harvey lazy butterflies (arXiv:1205.2926) as in the staged
// NTT: the forward keeps values in [0, 4q) between stages, the inverse in
// [0, 2q), and both leave every output fully reduced into [0, q). 4q < 2^64
// holds for any q < 2^62, so the same code serves the w32 and w64 moduli.
// The Shoup product w*x - floor(x*ws / 2^64)*q lies in [0, 2q) for any
// x < 2^64 (one __umul64hi and two low multiplies). Lazy intermediates may
// differ from the 32-bit Shoup constants she_tpu uses for w32 moduli;
// fully reduced outputs cannot, because every stage is exact mod q.
//
// Bound: each transform reads N words and writes N words (2 * rows * N * 8
// bytes, plus tables that stay resident in the 50 MB L2), and spends about
// N/2 * log2(N) butterflies of three 64-bit multiplies each. At N = 4096 that
// is 16 bytes per coefficient against ~18 integer multiplies per
// coefficient: memory-bound on paper, integer-multiply-heavy in practice.
//
// Design (first, simple version): one CTA per (polynomial, RNS row). The row
// (32 KB at N = 4096, 64 KB at N = 8192) is loaded once into dynamic shared
// memory, every stage runs there with the butterflies striped over the
// threads and __syncthreads() between stages, and the row is written once.
// So device memory sees exactly one read and one write per coefficient,
// which is what the TPU kernel's VMEM residency buys, without its lane-roll
// layout. Twiddles are read from global memory (L2-resident). Radix-4
// stages, register tiling and several rows per CTA are later work.

#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned long long u64;

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ u64 mul_shoup_lazy(u64 x, u64 w, u64 ws, u64 q) {
  // w * x mod q in [0, 2q) for any x < 2^64, w < q, ws = floor(w * 2^64 / q).
  u64 hi = __umul64hi(x, ws);
  return w * x - hi * q;
}

__device__ __forceinline__ u64 sub_if_ge(u64 x, u64 bound) {
  return x >= bound ? x - bound : x;
}

__global__ void __launch_bounds__(kThreads)
ntt_forward_kernel(const u64* __restrict__ in, u64* __restrict__ out, int L,
                   int log2n, const u64* __restrict__ roots,
                   const u64* __restrict__ roots_shoup,
                   const u64* __restrict__ moduli) {
  extern __shared__ u64 s[];
  const int n = 1 << log2n;
  const long long row = blockIdx.x;
  const int l = static_cast<int>(row % L);
  const u64 q = moduli[l];
  const u64 q2 = q << 1;
  const u64* w = roots + static_cast<long long>(l) * n;
  const u64* ws = roots_shoup + static_cast<long long>(l) * n;
  const u64* src = in + row * n;
  u64* dst = out + row * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = src[i];
  __syncthreads();

  const int half = n >> 1;
  for (int log2m = 0; log2m < log2n; ++log2m) {
    const int m = 1 << log2m;
    const int shift = log2n - 1 - log2m;  // t = n >> (log2m + 1) = 1 << shift
    const int t = 1 << shift;
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int i = k >> shift;  // butterfly block
      const int j = k & (t - 1);
      const int a = (i << (shift + 1)) + j;
      const u64 x = sub_if_ge(s[a], q2);                          // [0, 2q)
      const u64 tt = mul_shoup_lazy(s[a + t], w[m + i], ws[m + i], q);  // [0, 2q)
      s[a] = x + tt;                                              // [0, 4q)
      s[a + t] = x - tt + q2;                                     // [0, 4q)
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x)
    dst[i] = sub_if_ge(sub_if_ge(s[i], q2), q);
}

__global__ void __launch_bounds__(kThreads)
ntt_inverse_kernel(const u64* __restrict__ in, u64* __restrict__ out, int L,
                   int log2n, const u64* __restrict__ inv_roots,
                   const u64* __restrict__ inv_roots_shoup,
                   const u64* __restrict__ moduli,
                   const u64* __restrict__ n_inv,
                   const u64* __restrict__ n_inv_shoup,
                   const u64* __restrict__ n_inv_w,
                   const u64* __restrict__ n_inv_w_shoup) {
  extern __shared__ u64 s[];
  const int n = 1 << log2n;
  const long long row = blockIdx.x;
  const int l = static_cast<int>(row % L);
  const u64 q = moduli[l];
  const u64 q2 = q << 1;
  const u64* w = inv_roots + static_cast<long long>(l) * n;
  const u64* ws = inv_roots_shoup + static_cast<long long>(l) * n;
  const u64* src = in + row * n;
  u64* dst = out + row * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = src[i];
  __syncthreads();

  const int half = n >> 1;
  for (int log2m = log2n - 1; log2m >= 1; --log2m) {
    const int m = 1 << log2m;
    const int shift = log2n - 1 - log2m;
    const int t = 1 << shift;
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int i = k >> shift;
      const int j = k & (t - 1);
      const int a = (i << (shift + 1)) + j;
      const u64 x = s[a];      // [0, 2q)
      const u64 y = s[a + t];  // [0, 2q)
      s[a] = sub_if_ge(x + y, q2);                                        // [0, 2q)
      s[a + t] = mul_shoup_lazy(x - y + q2, w[m + i], ws[m + i], q);      // [0, 2q)
    }
    __syncthreads();
  }

  // Final stage (m = 1): fold n^-1 into the x half and n^-1 * w^-1 into the
  // y half, then reduce fully into [0, q).
  const u64 ni = n_inv[l], nis = n_inv_shoup[l];
  const u64 nw = n_inv_w[l], nws = n_inv_w_shoup[l];
  for (int k = threadIdx.x; k < half; k += blockDim.x) {
    const u64 x = s[k];
    const u64 y = s[k + half];
    dst[k] = sub_if_ge(mul_shoup_lazy(x + y, ni, nis, q), q);
    dst[k + half] = sub_if_ge(mul_shoup_lazy(x - y + q2, nw, nws, q), q);
  }
}

int launch_config(const void* kernel, int log2n, long long rows, dim3* grid,
                  dim3* block, size_t* smem) {
  *smem = sizeof(u64) << log2n;
  if (*smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(*smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int half = 1 << (log2n - 1);
  *grid = dim3(static_cast<unsigned>(rows));
  *block = dim3(half < kThreads ? half : kThreads);
  return 0;
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers of contiguous
// int64 tensors; `stream` is a cudaStream_t. Returns a cudaError_t value
// (0 on success) covering the launch itself; faults during the run surface
// at the caller's next synchronisation.
extern "C" int she_ntt_forward(const void* in, void* out, long long rows,
                               int L, int log2n, const void* roots,
                               const void* roots_shoup, const void* moduli,
                               void* stream) {
  if (rows <= 0) return 0;
  if (log2n < 1 || log2n > 13 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid, block;
  size_t smem;
  int err = launch_config(reinterpret_cast<const void*>(ntt_forward_kernel),
                          log2n, rows, &grid, &block, &smem);
  if (err) return err;
  ntt_forward_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(in), static_cast<u64*>(out), L, log2n,
      static_cast<const u64*>(roots), static_cast<const u64*>(roots_shoup),
      static_cast<const u64*>(moduli));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int she_ntt_inverse(const void* in, void* out, long long rows,
                               int L, int log2n, const void* inv_roots,
                               const void* inv_roots_shoup, const void* moduli,
                               const void* n_inv, const void* n_inv_shoup,
                               const void* n_inv_w, const void* n_inv_w_shoup,
                               void* stream) {
  if (rows <= 0) return 0;
  if (log2n < 1 || log2n > 13 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid, block;
  size_t smem;
  int err = launch_config(reinterpret_cast<const void*>(ntt_inverse_kernel),
                          log2n, rows, &grid, &block, &smem);
  if (err) return err;
  ntt_inverse_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(in), static_cast<u64*>(out), L, log2n,
      static_cast<const u64*>(inv_roots),
      static_cast<const u64*>(inv_roots_shoup),
      static_cast<const u64*>(moduli), static_cast<const u64*>(n_inv),
      static_cast<const u64*>(n_inv_shoup), static_cast<const u64*>(n_inv_w),
      static_cast<const u64*>(n_inv_w_shoup));
  return static_cast<int>(cudaGetLastError());
}
