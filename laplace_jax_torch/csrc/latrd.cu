// LATRD panel kernel for Hopper (sm_90a): one persistent cooperative launch
// per panel, each block's rows of the window resident in shared memory.
//
// Replaces the TPU kernel laplace_jax/ops/latrd_pallas.py, `latrd_panel`
// (body `_panel_kernel`): one panel of blocked Householder
// tridiagonalization on K symmetric windows, used by stage 1 of the
// two-stage eigensolver for 512 <= n < 2304 (ResNet-18 KFAC classes
// n = 512 (K=6), 576 (K=5), 1152 (K=4)), with the full trailing matvec.
//
// Design. The TPU kernel keeps the U/W panel in VMEM for the whole panel.
// Here the panel is latrd_panel.cuh's persistent kernel, k_panel<T, 1>: G
// blocks (one per SM, fewer for small windows: ops/latrd.py `panel_plan`)
// run all nb columns in one launch, each owning a run of live rows whose
// window rows (columns from the panel on), rows of U and W and entries of
// the panel's window rows stay in its shared memory, so after the first
// touch the matvec reads no window bytes from L2 or HBM. Each column is
// three phases and two grid barriers: (a) the corrected column on the
// block's rows, the whole correction over the j earlier reflectors; (b)
// every block forms its windows' reflectors, v, U v and W v (one warp an
// entry) and y on its rows (one warp a row); (c) w on its rows, and w at row
// c+1 formed by every block, so that the next (a) needs no third barrier.
// With blocks of its own for each window, no block does a second window's
// staging and sums while the others wait at a barrier. All loads of a phase
// are in flight before the first is used: a column's time is its barriers
// and its chain of dependent L2 round trips, not its arithmetic.
//
// Numbers. No atomics: every sum has one order (warp shuffle trees, loops
// in a fixed order, cross-block sums in block order), so two launches on
// the same window agree bit for bit. The reflector test keeps `mul_rn`.
//
// Where the rows do not fit (float64 at (4, 1152), 322 KB a block), each
// block streams its own window rows from L2 every column; where even its
// rows of U and W do not, it reads them from UW. A window whose per-window
// vectors do not fit raises.
//
// Bound. The matvec is 2 K (m-c)^2 flops a column, 0.011 ms a panel at
// (4, 1152) in float32 at the card's float32 rate; with the window on chip
// the panel is bound by its 2 nb grid barriers and the L2 round trips of
// each column (two in (b), one in (c)).

#include "latrd_panel.cuh"

namespace {

// the plan's two switches: every own row resident (cache_window) or none
template <typename T>
cudaError_t run(const latrd::Panel<T>& p, int off, int n_cta, int cache_window, int cache_rows,
                cudaStream_t s) {
  if (n_cta < 1) return cudaErrorInvalidValue;
  const int n_res = cache_window ? latrd::rows_per_block(p.K, p.m - off, n_cta) : 0;
  return latrd::launch_rows_panel<T, 1>(p, off, n_cta, n_res, cache_rows, s);
}

template <typename T>
size_t smem(int K, int m, int off, int nb, int n_cta, int cache_window, int cache_rows) {
  const int n_res = cache_window ? latrd::rows_per_block(K, m - off, n_cta) : 0;
  return latrd::layout<T, 1>(K, m, off, nb, n_cta, n_res, cache_rows).total * sizeof(T);
}

}  // namespace

// The C interface (latrd_panel.cuh's LATRD_ROWS_EXPORTS): the block count and
// the two caching switches of ops/latrd.py `panel_plan` before the stream;
// smem_bytes(K, m, off, nb, n_cta, cache_window, cache_rows, itemsize).
LATRD_ROWS_EXPORTS(run, smem)
