"""Symmetric-half LATRD panel kernel with a fixed-order sum, for CUDA
(replaces `laplace_jax/ops/latrd_pallas_v3.py`, `latrd_panel_v3` /
`_panel_kernel`). Stage 1 runs it when asked for
(`eigh_stack_ts(stage1="latrd_v3")`); the automatic choice never does, as
in the JAX package.

Same panel contract as `ops/latrd.py`; the trailing matvec reads only the
lower triangle of each window, in square tiles. The TPU kernel adds the tile
pairs' products in one fixed order; `csrc/latrd_v3.cu` keeps one order for
every sum of the panel on the card with no atomics, so its results are
bitwise reproducible from run to run, where `latrd_v4`'s atomics are not.

On the card a panel is one cooperative launch, one block per SM, with v4's
tile schedule (`ops/latrd_v4.panel_schedule`): each block's tiles in a
contiguous row-major run, its first `n_res` resident in shared memory. Each
strip of a block's tiles (a run sharing a tile row) writes its row products,
and each tile its column products, into slots of their own, and the owner of
each 64-row block of y gathers them in one fixed order. `panel_plan` decides
what each block keeps in shared memory.

`latrd_panel_v3.launches` counts the panels launched on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from laplace_jax_torch.ops import _build
from laplace_jax_torch.ops.latrd import check_window, launch_panel
from laplace_jax_torch.ops.latrd_v4 import (
    MAX_RES,
    RING,
    SMEM_BYTES,
    TILE,
    panel_schedule,
    slot_bytes,
)
from laplace_jax_torch.ops.tridiag import (
    _cdiv,
    _tridiag_small,
    lower_half_matvec,
    panel_plain,
    tridiagonalize_windows,
)

__all__ = ["latrd_panel_v3", "latrd_panel_v3_plain", "tridiagonalize_latrd_v3", "panel_plan"]

STATIC_BYTES = 12288  # the kernel's static shared memory (11,392 bytes in float64), rounded up


class PanelPlan(NamedTuple):
    """One v3 panel launch: the resident tiles per block (`n_res`), the row
    blocks whose rows of U and W each block keeps (`n_cache`: all it owns,
    or 0), the tile table of `panel_schedule`, and the dynamic shared memory
    in bytes."""

    n_res: int
    n_cache: int
    table: torch.Tensor
    smem: int


def dynamic_smem(K: int, nb: int, n_res: int, n_cache: int, n_units: int, itemsize: int) -> int:
    """The kernel's dynamic shared memory (`dynamic_smem` in the source):
    the resident and ring slots, the 2nb rows of U and W on `n_cache` row
    blocks, a 64-row vector per owned row block, 4nb + 10 values per window."""
    tail = -(-K * (4 * nb + 10) * itemsize // 16) * 16
    return ((n_res + RING[itemsize]) * slot_bytes(itemsize)
            + (n_cache * 2 * nb + n_units) * TILE * itemsize + tail)


def panel_plan(K: int, m: int, off: int, nb: int, itemsize: int, n_cta: int) -> PanelPlan:
    """The launch of one panel on `n_cta` blocks. Each block owns the row
    blocks u = block, block + n_cta, ... of the K m/64 and keeps their rows
    of U and W in shared memory when they fit beside the ring, else reads
    them from UW; then as many resident tiles as fit, at most MAX_RES and no
    more than a block's share. Raises for a window whose ring and per-window
    vectors alone do not fit."""
    nt, s0 = m // TILE, (off + 1) // TILE
    n_tiles = K * (nt - s0) * (nt - s0 + 1) // 2
    n_units = _cdiv(K * nt, n_cta)

    def free(n_cache):
        return SMEM_BYTES - STATIC_BYTES - dynamic_smem(K, nb, 0, n_cache, n_units, itemsize)

    n_cache = n_units if free(n_units) >= 0 else 0
    if free(n_cache) < 0:
        raise ValueError(f"the v3 panel kernel does not take K={K}, m={m}, nb={nb} in "
                         f"{itemsize}-byte floats: its ring and vectors need "
                         f"{SMEM_BYTES - free(0)} bytes of shared memory a block")
    n_res = min(free(n_cache) // slot_bytes(itemsize), MAX_RES, _cdiv(n_tiles, n_cta))
    return PanelPlan(n_res, n_cache, panel_schedule(K, m, off, n_cta),
                     dynamic_smem(K, nb, n_res, n_cache, n_units, itemsize))


_plans: dict = {}


def _schedule_args(Aw, off: int, nb: int):
    """The kernel's schedule arguments for this panel, the table cached on
    the card by (K, m, off, nb, dtype, device); the first use checks the
    plan's ring and shared memory against the library's own reckoning."""
    K, m, _ = Aw.shape
    key = (K, m, off, nb, Aw.dtype, Aw.device)
    if key not in _plans:
        lib = _build.load("latrd_v3")
        size = Aw.element_size()
        n_cta = torch.cuda.get_device_properties(Aw.device).multi_processor_count
        plan = panel_plan(K, m, off, nb, size, n_cta)
        lib_smem = lib.smem_bytes(K, nb, plan.n_res, plan.n_cache, _cdiv(K * m // TILE, n_cta),
                                  size)
        if lib.ring_slots(size) != RING[size] or lib_smem != plan.smem:
            raise RuntimeError(f"csrc/latrd_v3.cu has {lib.ring_slots(size)} ring slots and "
                               f"reckons {lib_smem} bytes of shared memory, ops/latrd_v3.py "
                               f"{RING[size]} and {plan.smem}")
        _plans[key] = (plan.table.to(Aw.device), n_cta, plan.n_res, plan.n_cache)
    table, *args = _plans[key]
    return (table.data_ptr(), *args)


def latrd_panel_v3_plain(Aw, off: int, q_base: int, n_real: int, nb: int):
    """The panel in plain PyTorch, its matvec from the lower triangle."""
    return panel_plain(Aw, off, q_base, n_real, nb, lower_half_matvec(Aw))


def latrd_panel_v3(Aw, off: int, q_base: int, n_real: int, nb: int):
    """One fixed-order symmetric-half LATRD panel: the CUDA kernel for a
    CUDA window, the plain version for a CPU window."""
    if Aw.device.type == "cpu":
        return latrd_panel_v3_plain(Aw, off, q_base, n_real, nb)
    check_window(Aw, off, nb)
    out = launch_panel("latrd_v3", Aw, off, q_base, n_real, nb, _schedule_args(Aw, off, nb))
    latrd_panel_v3.launches += 1
    return out


latrd_panel_v3.launches = 0


def tridiagonalize_latrd_v3(A: torch.Tensor, nb: int = 64, n_classes: int = 4,
                            T: int | None = None):
    """Stage 1 with the v3 kernel (the JAX package's
    `tridiagonalize_pallas_v3`): window classes rounded to the TPU tile `T`
    (384 from n >= 1536, else 128), `nb` a multiple of 8 dividing them. `T`
    sets only the class granularity; the card kernel picks its own tile."""
    K, n, _ = A.shape
    if n <= 2:
        return _tridiag_small(A)
    if T is None:
        T = 384 if n >= 1536 else 128
    nb = max(8, min(nb, n))
    nb -= nb % 8
    S = max(_cdiv(nb, T) * T, T, _cdiv(_cdiv(n, n_classes), T) * T)
    while S % nb:
        nb -= 8
    return tridiagonalize_windows(A, nb, S, latrd_panel_v3)
