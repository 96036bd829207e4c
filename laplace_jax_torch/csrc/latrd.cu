// LATRD panel kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel laplace_jax/ops/latrd_pallas.py, `latrd_panel`
// (body `_panel_kernel`): one panel of blocked Householder
// tridiagonalization on K symmetric windows, used by stage 1 of the
// two-stage eigensolver for 512 <= n < 2304 (ResNet-18 KFAC classes
// n = 512 (K=6), 576 (K=5), 1152 (K=4)).
//
// Design. The per-column sequence (corrected column, reflector, matvec,
// w update) is shared with latrd_v4.cu (latrd_common.cuh, four launches a
// column, so nb*4 launches a panel, issued from C without Python). This
// file holds the trailing matvec: one warp per trailing row i > c reads the
// row's columns > c with 16-byte loads (v is zero at and above c, so the
// read starts at the vector holding c+1) and writes y[i]; blocks past the
// rows compute the 2j dot products U v and W v, one warp each. Rows and
// columns past the unpadded size are skipped. The U/W products of the TPU
// kernel's body all run inside these kernels.
//
// Bound. Per column the matvec streams the trailing (m-c)^2 block of every
// window once, K (m-c)^2 * 4 bytes in float32: it is memory-bound at
// 2 flops per 4 bytes. The K=4 windows of the 1152 class (21 MB) fit in the
// 50 MB L2, so from the second column on they are read from L2; the small
// per-column kernels then dominate (launch latency and the 2j-row U/W
// passes). Left for later work: cp.async/TMA staging of the row stream,
// fusing the four launches per column into one persistent cooperative
// kernel, and fusing columns.

#include "latrd_common.cuh"

namespace {

using latrd::kBlock;
using latrd::kWarps;

template <typename T>
__global__ void __launch_bounds__(kBlock)
k_matvec(latrd::Panel<T> p, int c, int j, int nrow) {
  if ((int)blockIdx.x >= nrow) {
    latrd::dots_block(p, c, j, blockIdx.x - nrow);
    return;
  }
  const int i = c + 1 + blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= p.nv) return;
  const int k = blockIdx.y;
  const size_t mm = p.m;
  const T* v = p.UW + ((size_t)k * 2 * p.nb + j) * mm;
  const T s = latrd::warp_dot(p.Aw + ((size_t)k * mm + i) * mm, v,
                              latrd::vec_floor<T>(c + 1), p.lend);
  if ((threadIdx.x & 31) == 0) p.y[k * mm + i] = s;
}

template <typename T>
cudaError_t launch_matvec(const latrd::Panel<T>& p, int c, int j, cudaStream_t s) {
  const int nrow = p.nv > c + 1 ? (p.nv - c - 1 + kWarps - 1) / kWarps : 0;
  const int ndot = (2 * j + kWarps - 1) / kWarps;
  if (nrow + ndot == 0) return cudaSuccess;
  k_matvec<T><<<dim3(nrow + ndot, p.K), kBlock, 0, s>>>(p, c, j, nrow);
  return cudaGetLastError();
}

}  // namespace

LATRD_EXPORTS(launch_matvec)
