// LATRD panel kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel laplace_jax/ops/latrd_pallas.py, `latrd_panel`
// (body `_panel_kernel`): one panel of blocked Householder
// tridiagonalization on K symmetric windows, used by stage 1 of the
// two-stage eigensolver for 512 <= n < 2304 (ResNet-18 KFAC classes
// n = 512 (K=6), 576 (K=5), 1152 (K=4)).
//
// Design. The per-column sequence (corrected column, reflector, matvec,
// w update) is shared with the other panel kernels (latrd_common.cuh, four
// launches a column, so nb*4 launches a panel, issued from C without
// Python), and so is this kernel's trailing matvec, `matvec_rows`: one warp
// per trailing row i > c reads the row's columns > c with 16-byte loads and
// writes y[i]; blocks past the rows compute the 2j dot products U v and
// W v, one warp each. Rows and columns past the unpadded size are skipped.
// The U/W products of the TPU kernel's body all run inside these kernels.
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

template <typename T>
cudaError_t run(const latrd::Panel<T>& p, int off, cudaStream_t s) {
  return latrd::run_columns<T>(p, off, s, latrd::matvec_rows<T>);
}

}  // namespace

LATRD_EXPORTS(run, latrd::no_work)
