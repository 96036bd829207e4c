// Symmetric-half LATRD panel kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel laplace_jax/ops/latrd_pallas_v4.py,
// `latrd_panel_v4` (body `_panel_kernel`): the same panel contract as
// latrd.cu, used by stage 1 for n >= 2304 (ResNet-18 KFAC classes
// n = 2304 (K=4), 4608 (K=3)).
//
// Design. The per-column sequence is shared with latrd.cu
// (latrd_common.cuh, four launches a column). The trailing matvec reads only
// the lower triangle of each window, as 64x64 tiles (r, s), r >= s, of the
// trailing block: one block per tile stages it in shared memory, adds
// A[R,S] v[S] to y[R] and, off the diagonal, A[R,S]^T v[R] to y[S], four
// threads per row/column and atomicAdd into y (zeroed by k_house). The TPU
// kernel streams the triangle as column strips of a col-tile-major copy; a
// GPU reads tiles of the row-major window directly, so no copy is made.
// Blocks past the tiles compute the 2j dot products U v and W v.
//
// Numbers. The atomics add in an order that changes from run to run, so
// results agree with the plain version to float32 rounding, not bitwise.
//
// Bound. Per column the matvec reads about half the trailing block,
// K (m-c)^2 / 2 * 4 bytes: memory-bound at 4 flops per 4 bytes. At the 4608
// class (K=3) a window is 85 MB per factor, far above the 50 MB L2, so every
// column streams from HBM; at 2304 (K=4, 85 MB in all) the trailing block
// drops under L2 size part-way through. Left for later work: cp.async/TMA
// double-buffered tile staging, strips of tiles per block to cut atomics,
// one persistent cooperative kernel per panel, and fusing columns.

#include "latrd_common.cuh"

namespace {

using latrd::kBlock;
using latrd::kWarps;
constexpr int kTile = 64;

template <typename T>
__global__ void __launch_bounds__(kBlock)
k_matvec_sym(latrd::Panel<T> p, int c, int j, int t0, int ntile) {
  if ((int)blockIdx.x >= ntile) {
    latrd::dots_block(p, c, j, blockIdx.x - ntile);
    return;
  }
  __shared__ T tile[kTile][kTile + 1];
  __shared__ T vs[kTile], vr[kTile];
  // blockIdx.x -> lower-triangle tile (rr, ss), rr >= ss, row-major order
  const int idx = blockIdx.x;
  int rr = (int)((sqrt(8.0 * idx + 1.0) - 1.0) * 0.5);
  while ((rr + 1) * (rr + 2) / 2 <= idx) ++rr;
  while (rr * (rr + 1) / 2 > idx) --rr;
  const int ss = idx - rr * (rr + 1) / 2;
  const int R = (t0 + rr) * kTile, S = (t0 + ss) * kTile;
  const int k = blockIdx.y;
  const size_t mm = p.m;
  const T* A = p.Aw + (size_t)k * mm * mm;
  const T* v = p.UW + ((size_t)k * 2 * p.nb + j) * mm;
  T* y = p.y + k * mm;

  using V = typename latrd::Vec<T>::type;
  constexpr int n = latrd::Vec<T>::n;
  constexpr int per_row = kTile / n;
  for (int e = threadIdx.x; e < kTile * per_row; e += kBlock) {
    const int r = e / per_row, cv = (e % per_row) * n;
    const V x = *reinterpret_cast<const V*>(A + (size_t)(R + r) * mm + S + cv);
    const T* xs = reinterpret_cast<const T*>(&x);
#pragma unroll
    for (int u = 0; u < n; ++u) tile[r][cv + u] = xs[u];
  }
  if (threadIdx.x < kTile) vs[threadIdx.x] = v[S + threadIdx.x];
  else if (threadIdx.x < 2 * kTile) vr[threadIdx.x - kTile] = v[R + threadIdx.x - kTile];
  __syncthreads();

  const int line = threadIdx.x >> 2, part = threadIdx.x & 3;
  constexpr int span = kTile / 4;
  T a = 0;  // y[R + line] += A[R + line, S:S+64] . v[S:S+64]
#pragma unroll 4
  for (int q = part * span; q < (part + 1) * span; ++q) a += tile[line][q] * vs[q];
  a += __shfl_xor_sync(0xffffffffu, a, 1);
  a += __shfl_xor_sync(0xffffffffu, a, 2);
  if (part == 0) atomicAdd(y + R + line, a);
  if (R == S) return;  // the diagonal tile is read whole: no mirror term
  T b = 0;  // y[S + line] += A[R:R+64, S + line] . v[R:R+64]
#pragma unroll 4
  for (int q = part * span; q < (part + 1) * span; ++q) b += tile[q][line] * vr[q];
  b += __shfl_xor_sync(0xffffffffu, b, 1);
  b += __shfl_xor_sync(0xffffffffu, b, 2);
  if (part == 0) atomicAdd(y + S + line, b);
}

template <typename T>
cudaError_t launch_matvec(const latrd::Panel<T>& p, int c, int j, cudaStream_t s) {
  const int t0 = (c + 1) / kTile;                 // first tile row/col touching c+1
  const int t1 = (p.nv + kTile - 1) / kTile;      // tiles past nv are padding
  const int nt = t1 > t0 ? t1 - t0 : 0;
  const int ntile = nt * (nt + 1) / 2;
  const int ndot = (2 * j + kWarps - 1) / kWarps;
  if (ntile + ndot == 0) return cudaSuccess;
  k_matvec_sym<T><<<dim3(ntile + ndot, p.K), kBlock, 0, s>>>(p, c, j, t0, ntile);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const latrd::Panel<T>& p, int off, cudaStream_t s) {
  return latrd::run_columns<T>(p, off, s, launch_matvec<T>);
}

}  // namespace

LATRD_EXPORTS(run, latrd::no_work)
