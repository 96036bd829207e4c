"""LATRD panel kernel with the row corrections grouped by 8 columns, for
CUDA (replaces `laplace_jax/ops/latrd_pallas_v2.py`, `_latrd_panel_v2` /
`_panel_kernel_v2`). Stage 1 runs it when asked for
(`eigh_stack_ts(stage1="latrd_v2")`); the automatic choice never does, as
in the JAX package.

Same panel contract as `ops/latrd.py`, with its full-row trailing matvec.
On the card a panel is one cooperative launch of `csrc/latrd_v2.cu` (the
kernel of `csrc/latrd_panel.cuh` that v1 runs too, with 8 columns a group):
each block owns a run of live rows, corrects the 8 window rows of each group
of 8 columns for every earlier group's reflectors at once, and forms y on
its rows whole. Which rows each block owns, how many of them it keeps in
shared memory (the others stream through a ring of row chunks every column)
and whether its rows of U and W stay there too is decided here
(`panel_plan`) and handed to the kernel. The kernel needs `nb` and `off` to
be multiples of 8.

`latrd_panel_v2.launches` counts the panels launched on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from laplace_jax_torch.ops import _build
from laplace_jax_torch.ops.latrd import (
    SMEM_BYTES,
    STATIC_BYTES,
    _rows_and_windows,
    block_count,
    check_window,
    launch_panel,
    tridiagonalize_latrd,
)
from laplace_jax_torch.ops.tridiag import _cdiv, panel_plain, tridiagonalize_windows

__all__ = ["latrd_panel_v2", "latrd_panel_v2_plain", "tridiagonalize_latrd_v2", "panel_plan"]

GROUP = 8  # columns per group: nb and off are multiples of it
# each warp's ring of streamed row chunks (`kRingSlots`, `kChunkBytes` in
# csrc/latrd_panel.cuh): 8 warps of 2 chunks of 2048 bytes
WARPS, RING_SLOTS, CHUNK_BYTES = 8, 2, 2048


class PanelPlan(NamedTuple):
    """One v2 panel launch: `n_cta` blocks, each owning `rows` live rows at
    most and keeping its first `n_res` of them in shared memory (the others
    stream every column); whether its rows of U and W stay there too
    (`cache_rows`); and the dynamic shared memory in bytes."""

    n_cta: int
    rows: int
    n_res: int
    cache_rows: bool
    smem: int


def smem_bytes(K: int, m: int, off: int, nb: int, n_cta: int, n_res: int, cache_rows: bool,
               itemsize: int) -> int:
    """The kernel's dynamic shared memory (`layout` in csrc/latrd_panel.cuh,
    NG = 8): the warps' rings of row chunks when a block streams rows, its
    first n_res window rows from column cb = vec_floor(off + 1) on (n_res x
    LW), the staged column of each window it touches (NW x LW), its rows of
    U and W (2nb x R) with `cache_rows`, its entries of the group's 8 window
    rows and its rows' corrected column and y (10 x R), and per window U and
    W at the group's 8 rows (16 nb), U v, W v, y.v (2nb + 1) and 11
    scalars."""
    R, NW = _rows_and_windows(K, m - off, n_cta)
    vec = 16 // itemsize
    LW = m - (off + 1) // vec * vec
    ring = WARPS * RING_SLOTS * CHUNK_BYTES // itemsize if n_res < R else 0
    elems = (ring + n_res * LW + NW * LW + 2 * nb * R * cache_rows + (GROUP + 2) * R
             + NW * (GROUP * 2 * nb + 2 * nb + 1 + 3 + GROUP))
    return elems * itemsize


def panel_plan(K: int, m: int, off: int, nb: int, itemsize: int, n_sm: int) -> PanelPlan:
    """The launch of one panel on a card with `n_sm` SMs: v1's blocks
    (`ops/latrd.block_count`). Each block keeps all its window rows and its
    rows of U and W in shared memory when they fit; else its rows of U and
    W and as many window rows as fit beside the ring; else as many window
    rows as fit beside the ring alone. Raises for a window whose ring and
    vectors alone do not fit."""
    L = m - off
    n_cta = block_count(K, L, n_sm)
    R = _rows_and_windows(K, L, n_cta)[0]
    row_bytes = (m - (off + 1) // (16 // itemsize) * (16 // itemsize)) * itemsize

    def free(n_res, cache_rows):
        return SMEM_BYTES - STATIC_BYTES - smem_bytes(K, m, off, nb, n_cta, n_res, cache_rows,
                                                      itemsize)

    if free(R, True) >= 0:
        return PanelPlan(n_cta, R, R, True, smem_bytes(K, m, off, nb, n_cta, R, True, itemsize))
    for cache_rows in (True, False):
        if free(0, cache_rows) >= 0:
            n_res = min(R - 1, free(0, cache_rows) // row_bytes)
            return PanelPlan(n_cta, R, n_res, cache_rows,
                             smem_bytes(K, m, off, nb, n_cta, n_res, cache_rows, itemsize))
    raise ValueError(f"the v2 panel kernel does not take K={K}, m={m}, off={off}, nb={nb} "
                     f"in {itemsize}-byte floats: its ring and vectors need "
                     f"{SMEM_BYTES - free(0, False)} bytes of shared memory a block")


_plans: dict = {}


def _plan_args(Aw, off: int, nb: int) -> tuple:
    """The kernel's plan arguments for this panel (n_cta, n_res, cache_rows),
    cached by (K, m, off, nb, dtype, device); the first use checks the
    plan's shared memory against the kernel's own reckoning."""
    K, m, _ = Aw.shape
    key = (K, m, off, nb, Aw.dtype, Aw.device)
    if key not in _plans:
        size = Aw.element_size()
        n_sm = torch.cuda.get_device_properties(Aw.device).multi_processor_count
        plan = panel_plan(K, m, off, nb, size, n_sm)
        args = (plan.n_cta, plan.n_res, int(plan.cache_rows))
        lib_smem = _build.load("latrd_v2").smem_bytes(K, m, off, nb, *args, size)
        if lib_smem != plan.smem:
            raise RuntimeError(f"csrc/latrd_v2.cu reckons {lib_smem} bytes of shared memory, "
                               f"ops/latrd_v2.py {plan.smem}")
        _plans[key] = args
    return _plans[key]


def latrd_panel_v2_plain(Aw, off: int, q_base: int, n_real: int, nb: int):
    """The panel in plain PyTorch: full trailing matvec."""
    return panel_plain(Aw, off, q_base, n_real, nb)


def latrd_panel_v2(Aw, off: int, q_base: int, n_real: int, nb: int):
    """One grouped LATRD panel: the CUDA kernel for a CUDA window, the
    plain version for a CPU window."""
    if Aw.device.type == "cpu":
        return latrd_panel_v2_plain(Aw, off, q_base, n_real, nb)
    if nb % GROUP or off % GROUP:
        raise ValueError(f"latrd_v2 panel needs nb and off multiples of {GROUP} "
                         f"(nb={nb}, off={off})")
    check_window(Aw, off, nb)
    out = launch_panel("latrd_v2", Aw, off, q_base, n_real, nb, _plan_args(Aw, off, nb))
    latrd_panel_v2.launches += 1
    return out


latrd_panel_v2.launches = 0


def tridiagonalize_latrd_v2(A: torch.Tensor, nb: int = 64, n_classes: int = 4):
    """Stage 1 with the v2 kernel (the JAX package's
    `tridiagonalize_pallas_v2`): n <= 2, or an `nb` that is not a multiple
    of 8, delegates to `tridiagonalize_latrd`; otherwise window classes of
    ~n/n_classes rows rounded up to 128, and `nb` as given (not
    normalized)."""
    K, n, _ = A.shape
    if n <= 2 or max(8, min(nb, n)) % GROUP:
        return tridiagonalize_latrd(A, nb=nb, n_classes=n_classes)
    nb = max(8, min(nb, n))
    S = max(nb, 128, _cdiv(_cdiv(n, n_classes), 128) * 128)
    return tridiagonalize_windows(A, nb, S, latrd_panel_v2)
