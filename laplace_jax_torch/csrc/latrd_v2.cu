// LATRD panel kernel with the row corrections grouped by 8 columns, for
// Hopper (sm_90a): one persistent cooperative launch per panel.
//
// Replaces the TPU kernel laplace_jax/ops/latrd_pallas_v2.py:262,
// `_latrd_panel_v2` (body `_panel_kernel_v2`): the panel contract of
// latrd.cu with its full-row trailing matvec. Stage 1 takes it when asked
// for (`eigh_stack_ts(stage1="latrd_v2")`); the automatic choice never
// does, as in the JAX package. It needs nb and off to be multiples of 8.
//
// Design. latrd_panel.cuh's kernel with NG = 8, k_panel<T, 8>: v1's
// persistent panel (blocks owning runs of live rows, their window rows,
// rows of U and W kept in shared memory, two grid barriers a column), with
// the TPU v2's changes where they apply on the card:
//
//   - Kept, changes 1 and 3 (segment corrections as small products; the
//     8-row block fetched once per 8 columns). At the first column c8 of
//     each group (panel rows j8 .. j8+7), each block fetches window rows
//     c8 .. c8+7 on its own rows once (cp.async, issued in the previous
//     column) and subtracts from them, as one (2 j8) x 8 product per row,
//     the corrections of every earlier group's reflectors,
//     sum_{q < j8} U[q,i] W[q,c8+h] + W[q,i] U[q,c8+h]. Each column then
//     subtracts at most 7 in-group terms. U and W at rows c8 .. c8+7 come
//     in with the last column of the previous group (as v1 fetches row c+1),
//     and each block forms v and w there for the group's later columns
//     itself, with the owners' compiled code and inputs.
//   - Kept, the full-row matvec: each y[i] is formed whole by the owner of
//     row i (one warp, a fixed lane order), so no cross-block sum of y.
//   - Not taken, change 2 (v and w of the current 8 columns kept in a small
//     buffer, flushed into the U/W panel every 8 columns). On the TPU it
//     replaced a masked select over the whole (2nb, K m) panel in every
//     column. Here each block stores v and w straight into its own rows of
//     U and W: there is nothing to defer.
//
// The TPU v2 could not compile at n >= 2304 (scoped VMEM). Here a window
// larger than the chip keeps each block's first n_res rows resident (as
// many as fit, ops/latrd_v2.py `panel_plan`) and its warps stream the
// others through cp.async rings of row chunks (latrd_panel.cuh), reversed on
// odd columns.
//
// Bound. The operations: 2 K (m-c)^2 flops a column for y, 0.011 ms a panel
// at (4, 1152) in float32; there the window fits in shared memory and the
// panel is bound by its 2 nb grid barriers and L2 round trips, as v1. The
// stream: where the window does not fit (the 2304 and 4608 classes; at
// (3, 4608) 255 MB against 30 MB of shared memory and 50 MB of L2), each
// column must read every live row's columns > c that no block keeps, twice
// the lower triangle's bytes (chip_smoke.py `row_stream_bound_ms`, about
// 4.5 ms a panel at (3, 4608) at 3.35 TB/s). Each warp streams its rows
// through a ring of its own that no barrier paces, and the reversed order
// lets L2 serve the tail of the previous column's stream; the column's chain
// of barriers and L2 round trips comes on top, as in v1.
//
// Numbers. No atomics on data: y.v from per-block slots in block order,
// U v and W v each whole by one warp, y whole by one warp a row (a streamed
// row's chunks in the order fixed by the column's parity), the group
// correction in one loop order. Two launches on the same window agree bit
// for bit.

#include "latrd_panel.cuh"

namespace {

constexpr int kGroup = 8;  // columns per group

// the plan: n_cta blocks, the first n_res rows of each resident, rows of U
// and W in shared memory with cache_rows
template <typename T>
cudaError_t run(const latrd::Panel<T>& p, int off, int n_cta, int n_res, int cache_rows,
                cudaStream_t s) {
  if (p.nb % kGroup || off % kGroup) return cudaErrorInvalidValue;
  return latrd::launch_rows_panel<T, kGroup>(p, off, n_cta, n_res, cache_rows, s);
}

template <typename T>
size_t smem(int K, int m, int off, int nb, int n_cta, int n_res, int cache_rows) {
  return latrd::layout<T, kGroup>(K, m, off, nb, n_cta, n_res, cache_rows).total * sizeof(T);
}

}  // namespace

// The C interface (latrd_panel.cuh's LATRD_ROWS_EXPORTS): the block count,
// the resident rows a block and the row cache switch of ops/latrd_v2.py
// `panel_plan` before the stream; smem_bytes(K, m, off, nb, n_cta, n_res,
// cache_rows, itemsize).
LATRD_ROWS_EXPORTS(run, smem)
