// Shared device code of the LATRD panel kernels (latrd.cu, latrd_v2.cu,
// latrd_v3.cu, latrd_v4.cu).
//
// One panel of blocked Householder tridiagonalization on a stack of K
// symmetric windows Aw (K, m, m), row-major, for window-relative columns
// c = off .. off+nb-1 (the contract of laplace_jax_torch/ops/tridiag.py).
// Every kernel is one persistent cooperative launch per panel that runs the
// panel's columns as phases:
//
//   1. the corrected column col = Aw[c, :] - U^T W[:, c] - W^T U[:, c]
//      (rows >= c) and partial sums of col^2 below c;
//   2. the reflector from the summed partials, with the JAX package's sign
//      and trivial-reflector rules (`house_from`), and v (`reflector_entry`);
//   3. y = Aw v over the trailing rows/columns > c, and s = U v, t = W v
//      for the j earlier rows (latrd.cu and latrd_v2.cu read full rows,
//      latrd_panel.cuh; latrd_v3.cu and latrd_v4.cu the lower triangle);
//   4. w = tau (y - U^T t - W^T s) - tau/2 (w.v) v with
//      w.v = tau (y.v - 2 s.t), written as row nb+j.
//
// latrd_v4.cu takes steps 1 and 4 for 64-row blocks from `col_block` and
// `w_block` below. The kernels share the grid barrier, the cp.async helpers
// and `sm_count` at the end of this file; latrd_v4.cu and latrd_v3.cu also
// share their tile ring (latrd_tiles.cuh), latrd.cu and latrd_v2.cu their
// kernel (latrd_panel.cuh). Rows and columns at or past nv = n_real -
// q_base are padding (zero). Each library exports the sizes of the scratch
// it indexes (`work_elems`, `part_elems`), and the caller allocates from
// them.

#pragma once

#include <cfloat>
#include <cstddef>
#include <cuda_runtime.h>

namespace latrd {

constexpr int kBlock = 256;               // threads of every kernel
constexpr int kWarps = kBlock / 32;
constexpr int kRows = 64;                 // rows per block in col_block / w_block
constexpr int kGroups = kBlock / kRows;   // threads sharing one row's q-loop

// row blocks of col_block / w_block, one partial sum of squares each per window
__host__ __device__ inline int row_blocks(int m) { return (m + kRows - 1) / kRows; }

template <typename T> struct Vec;         // 16-byte vector of T
template <> struct Vec<float> { using type = float4; static constexpr int n = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int n = 2; };

__device__ __forceinline__ float vdot(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ double vdot(double2 a, double2 b) {
  return a.x * b.x + a.y * b.y;
}

// Rounded products that nvcc may not fuse into an FMA: the trivial-reflector
// test compares sum(x^2) - alpha^2 with ~0, and an exact alpha^2 inside an
// FMA would leave the rounding error of sum(x^2) there instead of 0.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// threshold of the trivial-reflector test (the JAX package's)
template <typename T> __device__ __forceinline__ T tiny_threshold();
template <> __device__ __forceinline__ float tiny_threshold<float>() { return FLT_MIN * 1e4f; }
template <> __device__ __forceinline__ double tiny_threshold<double>() { return 1e-290; }

template <typename T>
struct Panel {
  const T* Aw;  // (K, m, m) window
  T* UW;        // (K, 2nb, m): rows [0, nb) reflectors v_j, [nb, 2nb) w_j
  T* det;       // (K, 3, nb): d, e, tau
  T* col;       // (K, m) corrected column
  T* part;      // (K, row_blocks(m)) partial sums of squares
  T* y;         // (K, m) trailing matvec
  T* st;        // (K, 2nb): U v in [0, nb), W v in [nb, 2nb)
  T* scal;      // (K, 4): tau
  T* work;      // kernel-specific scratch
  int K, m, nb, nrb;
  int q_base, n_real;
  int nv;       // valid rows/columns of the window
  int lend;     // nv rounded up to whole 16-byte vectors (<= m)
};

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;  // the total is in lane 0
}

// Sum over the block, returned to every thread; sh holds kWarps + 1 values.
template <typename T>
__device__ T block_sum(T x, T* sh) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    T s = 0;
    for (int w = 0; w < kWarps; ++w) s += sh[w];
    sh[kWarps] = s;
  }
  __syncthreads();
  const T r = sh[kWarps];
  __syncthreads();
  return r;
}

template <typename T>
__device__ __forceinline__ int vec_floor(int l) { return (l / Vec<T>::n) * Vec<T>::n; }

// Step 1 for column c, one block of kRows rows (blk) of window k:
// col[i] = row[i] - sum_{q < j} (U[q, i] W[q, c] + W[q, i] U[q, c])
// for rows i >= c, where row[i] (read at rr[r], r = i - blk * kRows) is
// window row c (== column c: the window is symmetric). The block's rows of U and
// W are read at ur[q * rs + r] and ur[(nb + q) * rs + r] (rows of UW, or
// latrd_v4.cu's copy of them), U[q, c] at cv[q * cs] and W[q, c] at
// cv[(nb + q) * cs]. Writes the block's partial sum of col^2 below c.
template <typename T>
__device__ __forceinline__ void col_block(const Panel<T>& p, int c, int j, const T* rr, int k,
                                           int blk, const T* ur, size_t rs, const T* cv,
                                          size_t cs, T (&red)[kGroups][kRows], T* sh) {
  const int r = threadIdx.x % kRows, g = threadIdx.x / kRows;
  const int i = blk * kRows + r;
  if ((blk + 1) * kRows <= c) {  // every row above the column
    if (threadIdx.x == 0) p.part[k * p.nrb + blk] = 0;
    return;
  }
  T corr = 0;
  if (i < p.m && i >= c && i < p.nv)
#pragma unroll 8
    for (int q = g; q < j; q += kGroups)
      corr += ur[q * rs + r] * cv[(p.nb + q) * cs] + ur[(p.nb + q) * rs + r] * cv[q * cs];
  red[g][r] = corr;
  __syncthreads();
  T sq = 0;
  if (g == 0 && i < p.m && i >= c) {
    T val = 0;
    if (i < p.nv) {
      for (int h = 1; h < kGroups; ++h) corr += red[h][r];
      val = rr[r] - corr;
    }
    p.col[(size_t)k * p.m + i] = val;
    if (i > c) sq = mul_rn(val, val);
  }
  sq = block_sum(sq, sh);
  if (threadIdx.x == 0) p.part[k * p.nrb + blk] = sq;
}

// The reflector of column c in window k, from sumsq = the sum of col^2
// over rows > c, alpha = col[c+1] and d = col[c]: the JAX package's sign
// and trivial-reflector rules. With `write`, thread 0 writes d, e, tau.
template <typename T>
struct Reflector {
  T tau, denom;
  T e;      // the subdiagonal entry: beta, or alpha for a trivial reflector
  bool ok;  // column c is not one of the last two (else an exact no-op)
};

template <typename T>
__device__ __forceinline__ Reflector<T> house_from(const Panel<T>& p, int c, int j, int k,
                                                   T sumsq, T alpha, T d, bool write) {
  const T a2 = mul_rn(alpha, alpha);
  const T xn = sumsq - a2;
  const T xnorm2 = xn < 0 ? T(0) : xn;  // keeps a NaN
  const T anorm = sqrt(a2 + xnorm2);
  const T beta = alpha >= 0 ? -anorm : anorm;
  const bool trivial = xnorm2 <= tiny_threshold<T>() * anorm * anorm;
  const T denom = trivial ? T(1) : alpha - beta;
  const bool ok = c + p.q_base < p.n_real - 2;
  const T tau = (trivial || !ok) ? T(0) : (beta - alpha) / beta;
  if (write && threadIdx.x == 0) {
    T* det = p.det + (size_t)k * 3 * p.nb;
    det[j] = d;
    det[p.nb + j] = trivial ? alpha : beta;
    det[2 * p.nb + j] = tau;
    p.scal[k * 4] = tau;
  }
  return {tau, denom, trivial ? alpha : beta, ok};
}

// Entry i of the reflector v of column c, from the corrected column's x = col[i]
template <typename T>
__device__ __forceinline__ T reflector_entry(T x, int i, int c, bool ok, T denom) {
  return (ok && i > c) ? (i == c + 1 ? T(1) : x / denom) : T(0);
}

// Step 4 for column c, one block of kRows rows (blk) of window k, given
// yv = y.v, tau, and st = (s, t) = (U v, W v) (window k's row of p.st, or a
// copy of it): w = tau (y - U^T t - W^T s) - tau/2 (w.v) v, written as row
// nb+j of UW (and at wr[r], when given). y on the block's rows is read at
// yr[r]; the rows of U and W, and v, at ur[q * rs + r], ur[(nb + q) * rs +
// r], ur[j * rs + r] as in col_block.
template <typename T>
__device__ __forceinline__ void w_block(const Panel<T>& p, int c, int j, int k, int blk, T yv,
                                        T tau, const T* st, const T* yr, const T* ur, size_t rs,
                                        T* wr, T (&red)[kGroups][kRows]) {
  const int r = threadIdx.x % kRows, g = threadIdx.x / kRows;
  const int i = blk * kRows + r;
  const T* s = st;         // U v
  const T* t = st + p.nb;  // W v
  T corr = 0;
  if (i < p.m && i > c && i < p.nv)
#pragma unroll 8
    for (int q = g; q < j; q += kGroups)
      corr += ur[q * rs + r] * t[q] + ur[(p.nb + q) * rs + r] * s[q];
  red[g][r] = corr;
  __syncthreads();
  if (g != 0 || i >= p.m) return;
  T wi = 0;
  if (i > c && i < p.nv) {
    for (int h = 1; h < kGroups; ++h) corr += red[h][r];
    T sdt = 0;
    for (int q = 0; q < j; ++q) sdt += s[q] * t[q];
    const T wv = tau * (yv - 2 * sdt);
    wi = tau * (yr[r] - corr) - T(0.5) * tau * wv * ur[j * rs + r];
  }
  p.UW[((size_t)k * 2 * p.nb + p.nb + j) * p.m + i] = wi;
  if (wr) wr[r] = wi;
}

template <typename T>
Panel<T> make_panel(const void* Aw, void* UW, void* det, void* col, void* part, void* y,
                    void* st, void* scal, void* work, int K, int m, int nb, int q_base,
                    int n_real) {
  Panel<T> p;
  p.Aw = static_cast<const T*>(Aw);
  p.UW = static_cast<T*>(UW);
  p.det = static_cast<T*>(det);
  p.col = static_cast<T*>(col);
  p.part = static_cast<T*>(part);
  p.y = static_cast<T*>(y);
  p.st = static_cast<T*>(st);
  p.scal = static_cast<T*>(scal);
  p.work = static_cast<T*>(work);
  p.K = K;
  p.m = m;
  p.nb = nb;
  p.nrb = row_blocks(m);
  p.q_base = q_base;
  p.n_real = n_real;
  p.nv = n_real - q_base < m ? n_real - q_base : m;
  p.lend = ((p.nv + Vec<T>::n - 1) / Vec<T>::n) * Vec<T>::n;
  if (p.lend > m) p.lend = m;
  return p;
}

// -- what the persistent (cooperative) launches share ----------------------

constexpr int kBarrierElems = 4;  // work[0, 4): the grid barrier's counter

// the SMs of the current device: one block each in a persistent launch
inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
// one 4- or 8-byte element
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(sizeof(T))
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// All blocks of the (cooperative, so co-resident) grid meet here; writes
// before it are visible to every block after it. A barrier still open after
// about ten seconds means a block never arrived: the kernel traps (the
// launch fails) rather than spinning on.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target) {
  target += gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    const long long start = clock64();
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(bar) : "memory");
      if (clock64() - start > 20000000000LL) __trap();
    } while (seen < target);
    __threadfence();
  }
  __syncthreads();
}

}  // namespace latrd
