// LATRD panel kernel with the per-column work grouped by 8 columns, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel laplace_jax/ops/latrd_pallas_v2.py,
// `_latrd_panel_v2` (body `_panel_kernel_v2`): the panel contract of
// latrd.cu with its full-row trailing matvec. Stage 1 takes it when asked
// for (`eigh_stack_ts(stage1="latrd_v2")`); the automatic choice never
// does, as in the JAX package. It needs nb and off to be multiples of 8.
//
// The TPU v2 made three changes to v1; on the card:
//
//   - Taken, changes 1 and 3 together (segment corrections as small
//     products; the 8-row block fetched once per 8 columns). At the start of
//     each group of 8 columns c8 .. c8+7 (panel rows j8 .. j8+7), `k_rows8`
//     reads window rows c8 .. c8+7 once and subtracts, in one pass over
//     U/W[0, j8), the corrections of every earlier group's reflectors: per
//     row i a (2 j8) x 8 product, sum_q U[q,i] W[q,c] + W[q,i] U[q,c] for
//     the 8 columns at once. The result, (K, 8, m), is the `work` scratch.
//     Each column's k_col then starts from its corrected row and adds only
//     the in-group terms q = j8 .. j-1 (at most 7). latrd.cu's k_col reads
//     2j rows of U/W for every column; this one reads 2 j8 rows once per
//     group, 8 times less U/W traffic in step 1.
//   - Not taken, change 2 (v and w of the current 8 columns kept in a small
//     (16, K m) buffer and flushed into the U/W panel every 8 columns). On
//     the TPU it replaced a masked select over the whole (2nb, K m) panel in
//     every column. On the card k_house and k_w store v and w straight into
//     their own UW rows, one coalesced row each: there is nothing to defer.
//   - The w update and the dots U v, W v depend on the current column's v,
//     so they cannot be grouped and stay per column as in latrd.cu.
//
// The TPU v2 could not compile at n >= 2304 (scoped VMEM); the card has no
// such limit, and this kernel takes every class.
//
// Bound. As latrd.cu: the matvec streams the trailing (m-c) x m rows of
// every window per column, memory-bound at 2 flops per 4 bytes. Left for
// later work as there.

#include "latrd_common.cuh"

namespace {

using latrd::kBlock;
using latrd::kGroups;
using latrd::kRows;
constexpr int kGroup = 8;  // columns per group

size_t work(int K, int m, int) { return (size_t)K * kGroup * m; }  // (K, 8, m) rows

// work[k, h, i] = Aw[c8 + h, i] - sum_{q < j8} (U[q, i] W[q, c8 + h]
// + W[q, i] U[q, c8 + h]) for rows i >= c8 (zero at and past nv).
template <typename T>
__global__ void __launch_bounds__(kBlock) k_rows8(latrd::Panel<T> p, int c8, int j8) {
  __shared__ T red[kGroups][kGroup][kRows];
  if ((blockIdx.x + 1) * kRows <= c8) return;  // rows above the group: never read
  const int k = blockIdx.y, r = threadIdx.x % kRows, g = threadIdx.x / kRows;
  const int i = blockIdx.x * kRows + r;
  const size_t mm = p.m;
  const T* U = p.UW + (size_t)k * 2 * p.nb * mm;
  const T* W = U + (size_t)p.nb * mm;
  T acc[kGroup];
#pragma unroll
  for (int h = 0; h < kGroup; ++h) acc[h] = 0;
  if (i < p.m && i < p.nv)
    for (int q = g; q < j8; q += kGroups) {
      const T u = U[q * mm + i], w = W[q * mm + i];
      const T* Wc = W + q * mm + c8;
      const T* Uc = U + q * mm + c8;
#pragma unroll
      for (int h = 0; h < kGroup; ++h) acc[h] += u * Wc[h] + w * Uc[h];
    }
#pragma unroll
  for (int h = 0; h < kGroup; ++h) red[g][h][r] = acc[h];
  __syncthreads();
  for (int e = threadIdx.x; e < kGroup * kRows; e += kBlock) {
    const int h = e / kRows, rr = e % kRows, ii = blockIdx.x * kRows + rr;
    if (ii >= p.m) continue;
    T val = 0;
    if (ii < p.nv) {
      T corr = red[0][h][rr];
      for (int g2 = 1; g2 < kGroups; ++g2) corr += red[g2][h][rr];
      val = p.Aw[((size_t)k * mm + c8 + h) * mm + ii] - corr;
    }
    p.work[((size_t)k * kGroup + h) * mm + ii] = val;
  }
}

template <typename T>
cudaError_t run(const latrd::Panel<T>& p, int off, cudaStream_t s) {
  if (p.nb % kGroup || off % kGroup) return cudaErrorInvalidValue;
  const dim3 rows(p.nrb, p.K);
  const size_t mm = p.m;
  cudaError_t err;
  for (int j = 0; j < p.nb; ++j) {
    const int c = off + j, j8 = j - j % kGroup;
    if (j == j8) {
      k_rows8<T><<<rows, kBlock, 0, s>>>(p, c, j8);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    latrd::k_col<T><<<rows, kBlock, 0, s>>>(p, c, j, p.work + (j - j8) * mm,
                                            kGroup * mm, j8);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    latrd::k_house<T><<<p.K, kBlock, 0, s>>>(p, c, j);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = latrd::matvec_rows<T>(p, c, j, s)) != cudaSuccess) return err;
    latrd::k_w<T><<<rows, kBlock, 0, s>>>(p, c, j);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

LATRD_EXPORTS(run, work)
