// Symmetric-half LATRD panel kernel with a fixed-order sum, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel laplace_jax/ops/latrd_pallas_v3.py,
// `latrd_panel_v3` (body `_panel_kernel`): the panel contract of latrd.cu,
// with the trailing matvec from the lower triangle of each window in square
// tiles. Stage 1 takes it when asked for (`eigh_stack_ts(stage1=
// "latrd_v3")`); the automatic choice never does, as in the JAX package.
//
// Design. The per-column sequence is shared with latrd.cu
// (latrd_common.cuh). What sets the TPU v3 apart from v4 is the order of its
// sum: it visits the lower-triangle tile pairs as one flattened loop and
// adds each product into y in that fixed order. latrd_v4.cu adds every
// tile's two products into y with atomicAdd, whose order changes from run to
// run. Here the matvec is two launches with no atomics:
//
//   1. k_tile_pairs: one block per lower-triangle 64x64 tile pair (r, s),
//      r >= s, of the trailing block. It stages the tile in shared memory
//      and writes A[R,S] v[S] and, off the diagonal, A[R,S]^T v[R] (four
//      threads per row/column, a fixed shuffle tree) into its own slot of
//      the `work` scratch, (K, P, 2, 64) with P the pairs of the whole
//      window. Blocks past the tiles compute the 2j dot products U v, W v.
//   2. k_reduce: one 64-thread block per tile row t sums, per row, the row
//      products of pairs (t, s), s = t0..t, then the column products of
//      pairs (r, t), r = t+1.., in that order, into y.
//
// Every sum of the panel then has one order, so two launches on the same
// window give bitwise the same output. The TPU kernel's tile T (384 or 128)
// sets only the class granularity of the driver (ops/latrd_v3.py); the card
// kernel takes 64-wide tiles. Rows and columns at or past nv are skipped as
// in latrd_v4.cu.
//
// Bound. Per column the matvec reads about half the trailing block,
// K (m-c)^2 / 2 * 4 bytes, as v4 does, plus the partial products,
// K P * 128 * 4 bytes written and read back (4 MB at the 4608 class, K=3,
// against 42 MB of triangle at c = 0): memory-bound. Left for later work:
// strips of tiles per block to shrink the scratch, cp.async/TMA staging,
// one persistent kernel per panel.

#include "latrd_common.cuh"

namespace {

using latrd::kBlock;
using latrd::kWarps;
constexpr int kTile = 64;

// `work` elements per window: every lower-triangle tile pair of an m-wide
// window, two 64-vectors each
__host__ __device__ inline size_t pair_stride(int m) {
  const size_t nt = m / kTile;
  return nt * (nt + 1) / 2 * 2 * kTile;
}

size_t work(int K, int m, int) { return K * pair_stride(m); }

template <typename T>
__global__ void __launch_bounds__(kBlock)
k_tile_pairs(latrd::Panel<T> p, int c, int j, int t0, int npair) {
  if ((int)blockIdx.x >= npair) {
    latrd::dots_block(p, c, j, blockIdx.x - npair);
    return;
  }
  __shared__ T tile[kTile][kTile + 1];
  __shared__ T vs[kTile], vr[kTile];
  // blockIdx.x -> lower-triangle pair (rr, ss), rr >= ss, row-major order
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

  // this pair's slot: [0, 64) row products, [64, 128) column products
  T* out = p.work + (size_t)k * pair_stride(p.m) + (size_t)idx * 2 * kTile;
  const int line = threadIdx.x >> 2, part = threadIdx.x & 3;
  constexpr int span = kTile / 4;
  T a = 0;  // A[R + line, S:S+64] . v[S:S+64]
#pragma unroll 4
  for (int q = part * span; q < (part + 1) * span; ++q) a += tile[line][q] * vs[q];
  a += __shfl_xor_sync(0xffffffffu, a, 1);
  a += __shfl_xor_sync(0xffffffffu, a, 2);
  if (part == 0) out[line] = a;
  if (R == S) return;  // the diagonal tile is read whole: no mirror term
  T b = 0;  // A[R:R+64, S + line] . v[R:R+64]
#pragma unroll 4
  for (int q = part * span; q < (part + 1) * span; ++q) b += tile[q][line] * vr[q];
  b += __shfl_xor_sync(0xffffffffu, b, 1);
  b += __shfl_xor_sync(0xffffffffu, b, 2);
  if (part == 0) out[kTile + line] = b;
}

// y over tile rows t0 .. t0+nt-1, each row's partial products in one order
template <typename T>
__global__ void __launch_bounds__(kTile) k_reduce(latrd::Panel<T> p, int t0, int nt) {
  const int k = blockIdx.y, tt = blockIdx.x, line = threadIdx.x;
  const T* w = p.work + (size_t)k * pair_stride(p.m);
  const size_t first = (size_t)tt * (tt + 1) / 2;  // pair (tt, 0)
  T acc = 0;
  for (int ss = 0; ss <= tt; ++ss) acc += w[(first + ss) * 2 * kTile + line];
  for (int rr = tt + 1; rr < nt; ++rr)
    acc += w[((size_t)rr * (rr + 1) / 2 + tt) * 2 * kTile + kTile + line];
  p.y[(size_t)k * p.m + (t0 + tt) * kTile + line] = acc;
}

template <typename T>
cudaError_t launch_matvec(const latrd::Panel<T>& p, int c, int j, cudaStream_t s) {
  const int t0 = (c + 1) / kTile;             // first tile row/col touching c+1
  const int t1 = (p.nv + kTile - 1) / kTile;  // tiles past nv are padding
  const int nt = t1 > t0 ? t1 - t0 : 0;
  const int npair = nt * (nt + 1) / 2;
  const int ndot = (2 * j + kWarps - 1) / kWarps;
  if (npair + ndot > 0) {
    k_tile_pairs<T><<<dim3(npair + ndot, p.K), kBlock, 0, s>>>(p, c, j, t0, npair);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (nt == 0) return cudaSuccess;
  k_reduce<T><<<dim3(nt, p.K), kTile, 0, s>>>(p, t0, nt);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const latrd::Panel<T>& p, int off, cudaStream_t s) {
  if (p.m % kTile) return cudaErrorInvalidValue;
  return latrd::run_columns<T>(p, off, s, launch_matvec<T>);
}

}  // namespace

LATRD_EXPORTS(run, work)
