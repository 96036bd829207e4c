// Shared device code of the LATRD panel kernels (latrd.cu, latrd_v2.cu,
// latrd_v3.cu, latrd_v4.cu).
//
// One panel of blocked Householder tridiagonalization on a stack of K
// symmetric windows Aw (K, m, m), row-major, for window-relative columns
// c = off .. off+nb-1 (the contract of laplace_jax_torch/ops/tridiag.py).
// In latrd_v2.cu and latrd_v3.cu each column runs four launches on the
// caller's stream (`run_columns`); latrd_v4.cu runs the same steps as
// phases of one persistent launch, from the device functions col_block,
// house_from and w_block that the kernels below wrap, and latrd.cu as
// phases of a persistent launch of its own. The persistent kernels share
// the grid barrier, the cp.async helpers and `sm_count` at the end of this
// file.
//
//   1. k_col    grid (m/64, K): corrected column
//                 col = Aw[c, :] - U^T W[:, c] - W^T U[:, c]
//               (rows >= c) and per-block partial sums of col^2 below c;
//   2. k_house  grid (K): reduce the partials, form the reflector with the
//               JAX package's sign and trivial-reflector rules, write
//               d, e, tau and v (row j of U), zero y;
//   3. matvec   y = Aw v over the trailing rows/columns > c, plus blocks
//               computing s = U v and t = W v for the j earlier rows
//               (kernel-specific: latrd_v2.cu reads full rows,
//               latrd_v3.cu and latrd_v4.cu the lower triangle);
//   4. k_w      grid (m/64, K): w = tau (y - U^T t - W^T s) - tau/2 (w.v) v
//               with w.v = tau (y.v - 2 s.t), written as row nb+j.
//
// Rows and columns at or past nv = n_real - q_base are padding (zero).
// latrd_v2.cu changes step 1 (see there). Each library exports the sizes
// of the scratch it indexes (`work_elems`, `part_elems`), and the caller
// allocates from them.

#pragma once

#include <cfloat>
#include <cstddef>
#include <cuda_runtime.h>

namespace latrd {

constexpr int kBlock = 256;               // threads of every kernel
constexpr int kWarps = kBlock / 32;
constexpr int kRows = 64;                 // rows per block in k_col / k_w
constexpr int kGroups = kBlock / kRows;   // threads sharing one row's q-loop

// row blocks of k_col / k_w, one partial sum of squares each per window
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
  T* work;      // kernel-specific scratch (latrd_v2.cu, latrd_v3.cu)
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

// Warp-wide dot product of a[l] and v[l] over l in [l0, lend), 16-byte
// loads (l0 and lend are multiples of the vector width); lane 0 has it.
template <typename T>
__device__ __forceinline__ T warp_dot(const T* a, const T* v, int l0, int lend) {
  using V = typename Vec<T>::type;
  constexpr int n = Vec<T>::n;
  T acc = 0;
  for (int l = l0 + (threadIdx.x & 31) * n; l < lend; l += 32 * n)
    acc += vdot(*reinterpret_cast<const V*>(a + l), *reinterpret_cast<const V*>(v + l));
  return warp_sum(acc);
}

template <typename T>
__device__ __forceinline__ int vec_floor(int l) { return (l / Vec<T>::n) * Vec<T>::n; }

// Step 1 for column c, one block of kRows rows (blk) of window k:
// col[i] = row[i] - sum_{q0 <= q < j} (U[q, i] W[q, c] + W[q, i] U[q, c])
// for rows i >= c, where row[i] (read at rr[r], r = i - blk * kRows) is
// window row c (== column c: the window is symmetric), q0 = 0; latrd_v2.cu
// passes that row already corrected for q < q0. The block's rows of U and
// W are read at ur[q * rs + r] and ur[(nb + q) * rs + r] (rows of UW, or
// latrd_v4.cu's copy of them), U[q, c] at cv[q * cs] and W[q, c] at
// cv[(nb + q) * cs]. Writes the block's partial sum of col^2 below c.
template <typename T>
__device__ __forceinline__ void col_block(const Panel<T>& p, int c, int j, const T* rr, int q0,
                                          int k, int blk, const T* ur, size_t rs, const T* cv,
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
    for (int q = q0 + g; q < j; q += kGroups)
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

template <typename T>
__global__ void __launch_bounds__(kBlock)
k_col(Panel<T> p, int c, int j, const T* row, size_t row_kstride, int q0) {
  __shared__ T red[kGroups][kRows];
  __shared__ T sh[kWarps + 1];
  const int k = blockIdx.y, b = blockIdx.x;
  const T* UWk = p.UW + (size_t)k * 2 * p.nb * p.m;
  col_block(p, c, j, row + k * row_kstride + b * kRows, q0, k, b, UWk + b * kRows, p.m,
            UWk + c, p.m, red, sh);
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

template <typename T>
__global__ void __launch_bounds__(kBlock) k_house(Panel<T> p, int c, int j) {
  __shared__ T sh[kWarps + 1];
  const int k = blockIdx.x;
  const size_t mm = p.m;
  const T* col = p.col + k * mm;
  T acc = 0;
  for (int b = threadIdx.x; b < p.nrb; b += kBlock) acc += p.part[k * p.nrb + b];
  const T sumsq = block_sum(acc, sh);  // sum of col^2 over rows > c
  const Reflector<T> rf = house_from(p, c, j, k, sumsq, c + 1 < p.m ? col[c + 1] : T(0),
                                     col[c], true);
  T* v = p.UW + ((size_t)k * 2 * p.nb + j) * mm;
  T* y = p.y + k * mm;
  for (int i = threadIdx.x; i < p.m; i += kBlock) {
    v[i] = reflector_entry(col[i], i, c, rf.ok, rf.denom);
    y[i] = 0;
  }
}

// One warp per earlier panel row r (the blk-th group of kWarps of the 2j):
// st[r] = UW[r] . v.
template <typename T>
__device__ __forceinline__ void dots_block(const Panel<T>& p, int c, int j, int blk) {
  const int q = blk * kWarps + (threadIdx.x >> 5);
  if (q >= 2 * j) return;
  const int k = blockIdx.y, r = q < j ? q : p.nb + (q - j);
  const size_t mm = p.m;
  const T* base = p.UW + (size_t)k * 2 * p.nb * mm;
  const T s = warp_dot(base + (size_t)r * mm, base + (size_t)j * mm,
                       vec_floor<T>(c + 1), p.lend);
  if ((threadIdx.x & 31) == 0) p.st[k * 2 * p.nb + r] = s;
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
__global__ void __launch_bounds__(kBlock) k_w(Panel<T> p, int c, int j) {
  __shared__ T red[kGroups][kRows];
  __shared__ T sh[kWarps + 1];
  const int k = blockIdx.y, b = blockIdx.x;
  const size_t mm = p.m;
  const T* UWk = p.UW + (size_t)k * 2 * p.nb * mm;
  const T* v = UWk + (size_t)j * mm;
  const T* y = p.y + k * mm;
  const T tau = p.scal[k * 4];
  T acc = 0;
  for (int l = c + 1 + threadIdx.x; l < p.nv; l += kBlock) acc += y[l] * v[l];
  const T yv = block_sum(acc, sh);
  w_block(p, c, j, k, b, yv, tau, p.st + k * 2 * p.nb, y + b * kRows, UWk + b * kRows, mm,
          static_cast<T*>(nullptr), red);
}

// Full-row trailing matvec (latrd_v2.cu): one warp per trailing
// row i > c reads the row's columns > c with 16-byte loads (v is zero at
// and above c, so the read starts at the vector holding c+1) and writes
// y[i]; blocks past the rows compute the 2j dot products U v and W v.
template <typename T>
__global__ void __launch_bounds__(kBlock)
k_matvec_rows(Panel<T> p, int c, int j, int nrow) {
  if ((int)blockIdx.x >= nrow) {
    dots_block(p, c, j, blockIdx.x - nrow);
    return;
  }
  const int i = c + 1 + blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= p.nv) return;
  const int k = blockIdx.y;
  const size_t mm = p.m;
  const T* v = p.UW + ((size_t)k * 2 * p.nb + j) * mm;
  const T s = warp_dot(p.Aw + ((size_t)k * mm + i) * mm, v, vec_floor<T>(c + 1), p.lend);
  if ((threadIdx.x & 31) == 0) p.y[k * mm + i] = s;
}

template <typename T>
cudaError_t matvec_rows(const Panel<T>& p, int c, int j, cudaStream_t s) {
  const int nrow = p.nv > c + 1 ? (p.nv - c - 1 + kWarps - 1) / kWarps : 0;
  const int ndot = (2 * j + kWarps - 1) / kWarps;
  if (nrow + ndot == 0) return cudaSuccess;
  k_matvec_rows<T><<<dim3(nrow + ndot, p.K), kBlock, 0, s>>>(p, c, j, nrow);
  return cudaGetLastError();
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

template <typename T>
using MatvecLauncher = cudaError_t (*)(const Panel<T>&, int c, int j, cudaStream_t);

// The whole panel as latrd_v3.cu runs it: nb columns of k_col, k_house,
// the kernel's matvec and k_w.
template <typename T>
cudaError_t run_columns(const Panel<T>& p, int off, cudaStream_t s, MatvecLauncher<T> matvec) {
  const dim3 rows(p.nrb, p.K);
  const size_t mm = p.m;
  cudaError_t err;
  for (int j = 0; j < p.nb; ++j) {
    const int c = off + j;
    k_col<T><<<rows, kBlock, 0, s>>>(p, c, j, p.Aw + c * mm, mm * mm, 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    k_house<T><<<p.K, kBlock, 0, s>>>(p, c, j);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = matvec(p, c, j, s)) != cudaSuccess) return err;
    k_w<T><<<rows, kBlock, 0, s>>>(p, c, j);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// -- the persistent (cooperative) panel kernels: latrd.cu, latrd_v4.cu ------

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

// The C interface of each library (one per kernel source): RUN<T>(panel,
// off, stream) runs the whole panel; WORK(K, m, nb) is the length of its
// `work` scratch and part_elems(K, m) that of `part`, in elements.
#define LATRD_EXPORTS(RUN, WORK)                                                    \
  extern "C" int panel_f32(const void* Aw, void* UW, void* det, void* col,        \
                           void* part, void* y, void* st, void* scal, void* work,   \
                           int K, int m, int nb, int off, int q_base, int n_real,   \
                           void* stream) {                                          \
    return (int)RUN<float>(latrd::make_panel<float>(Aw, UW, det, col, part, y, st,  \
                                                    scal, work, K, m, nb, q_base,   \
                                                    n_real),                        \
                           off, static_cast<cudaStream_t>(stream));                 \
  }                                                                                 \
  extern "C" int panel_f64(const void* Aw, void* UW, void* det, void* col,        \
                           void* part, void* y, void* st, void* scal, void* work,   \
                           int K, int m, int nb, int off, int q_base, int n_real,   \
                           void* stream) {                                          \
    return (int)RUN<double>(latrd::make_panel<double>(Aw, UW, det, col, part, y,    \
                                                      st, scal, work, K, m, nb,     \
                                                      q_base, n_real),              \
                            off, static_cast<cudaStream_t>(stream));                \
  }                                                                                 \
  extern "C" size_t work_elems(int K, int m, int nb) { return WORK(K, m, nb); }     \
  extern "C" size_t part_elems(int K, int m) {                                      \
    return (size_t)K * latrd::row_blocks(m);                                        \
  }                                                                                 \
  extern "C" const char* error_string(int e) {                                     \
    return cudaGetErrorString(static_cast<cudaError_t>(e));                         \
  }
