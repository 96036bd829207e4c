"""Symmetric-half LATRD panel kernel for CUDA (replaces
`laplace_jax/ops/latrd_pallas_v4.py`, `latrd_panel_v4` / `_panel_kernel`),
used by stage 1 for n >= 2304.

Same panel contract as `ops/latrd.py`; the trailing matvec reads only the
lower triangle of each window, and each tile serves both `y[R] += A[R,S] v[S]`
and `y[S] += A[R,S]^T v[R]`. The TPU kernel reads the triangle as column
strips of a col-tile-major copy of the window; the CUDA kernel reads tiles
of the row-major window directly, so no copy is made.

On the card a panel is one cooperative launch of `csrc/latrd_v4.cu`, one
block per SM. Which block multiplies which 64x64 tile, and which tiles stay
in its shared memory for the whole panel, is decided here
(`panel_schedule`, `panel_plan`) and handed to the kernel as a table.

`latrd_panel_v4.launches` counts the panels launched on the card.
"""

from __future__ import annotations

import torch

from laplace_jax_torch.ops import _build
from laplace_jax_torch.ops.latrd import check_window, launch_panel
from laplace_jax_torch.ops.tridiag import (
    _cdiv,
    _tridiag_small,
    lower_half_matvec,
    panel_plain,
    tridiagonalize_windows,
)

__all__ = ["latrd_panel_v4", "latrd_panel_v4_plain", "tridiagonalize_latrd_v4",
           "panel_schedule", "panel_plan"]

TILE = 64            # the kernel's tile width (and rows of a row block)
RING = {4: 3, 8: 2}  # its streamed-tile slots by item size (`kRing` in csrc/latrd_tiles.cuh)
MAX_RES = 16         # resident tiles per block, at most (`kMaxRes` there)
SMEM_BYTES = 232448  # shared memory one block may use on the H100 (227 KB)
STATIC_BYTES = 8192  # the kernel's static shared memory, rounded up


def slot_bytes(itemsize: int) -> int:
    """One slot of shared memory (`kSlot` in the source): a tile in rows
    padded by 16 bytes, and two 64-long column segments."""
    return (TILE * (TILE + 16 // itemsize) + 2 * TILE) * itemsize


def dynamic_smem(K: int, nb: int, n_res: int, n_cache: int, n_units: int, itemsize: int) -> int:
    """The kernel's dynamic shared memory (`dynamic_smem` in the source):
    the resident and ring slots, the 2nb rows of U and W on `n_cache` row
    blocks, a 64-row vector per owned row block, 2nb + 7 values per window."""
    tail = -(-K * (2 * nb + 7) * itemsize // 16) * 16
    return ((n_res + RING[itemsize]) * slot_bytes(itemsize)
            + (n_cache * 2 * nb + n_units) * TILE * itemsize + tail)


def panel_schedule(K: int, m: int, off: int, n_cta: int) -> torch.Tensor:
    """The tile table of one panel: every lower-triangle 64x64 tile (r, s),
    r >= s >= (off+1)//64, of each of the K windows (the panel's trailing
    block; tiles left of it are dead for the whole panel), in row-major
    order per window, cut into `n_cta` contiguous runs whose lengths differ
    by at most one. A run is a strip of tiles sharing a tile row, or a few.
    The kernel keeps each block's first `n_res` tiles (`panel_plan`) in
    shared memory.

    Returns an int32 tensor: `n_cta + 1` offsets into the codes, then the
    codes `k << 20 | r << 10 | s` (so m <= 65536 and K <= 2048)."""
    nt, s0 = m // TILE, (off + 1) // TILE
    if nt > 1024 or K > 2048:
        raise ValueError(f"the v4 panel kernel takes m <= 65536 and K <= 2048, got K={K}, m={m}")
    r, s = torch.tril_indices(nt - s0, nt - s0)
    per_window = (r + s0) << 10 | (s + s0)
    codes = (torch.arange(K)[:, None] << 20 | per_window[None]).reshape(-1)
    base, extra = divmod(codes.numel(), n_cta)
    counts = torch.full((n_cta,), base, dtype=torch.int64)
    counts[:extra] += 1
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64), counts.cumsum(0)])
    return torch.cat([offsets, codes]).to(torch.int32)


def panel_plan(K: int, m: int, off: int, nb: int, itemsize: int, n_cta: int):
    """(n_res, n_cache, schedule table) for one panel. Each block owns the
    row blocks u = block, block + n_cta, ... of the K m/64 and keeps their
    rows of U and W in shared memory (n_cache = how many it owns) when they
    fit beside the ring; then as many resident tiles as fit, at most
    MAX_RES and no more than a block's share."""
    nt, s0 = m // TILE, (off + 1) // TILE
    n_tiles = K * (nt - s0) * (nt - s0 + 1) // 2
    n_units = -(-K * nt // n_cta)

    def free(n_cache):
        return SMEM_BYTES - STATIC_BYTES - dynamic_smem(K, nb, 0, n_cache, n_units, itemsize)

    n_cache = n_units if free(n_units) >= 0 else 0
    n_res = min(max(free(n_cache), 0) // slot_bytes(itemsize), MAX_RES, -(-n_tiles // n_cta))
    return n_res, n_cache, panel_schedule(K, m, off, n_cta)


_plans: dict = {}


def _schedule_args(Aw, off: int, nb: int):
    """The kernel's schedule arguments for this panel, the table cached on
    the card by (K, m, off, nb, dtype, device)."""
    K, m, _ = Aw.shape
    key = (K, m, off, nb, Aw.dtype, Aw.device)
    if key not in _plans:
        lib = _build.load("latrd_v4")
        size = Aw.element_size()
        if lib.ring_slots(size) != RING[size]:
            raise RuntimeError(f"csrc/latrd_v4.cu has {lib.ring_slots(size)} ring slots, "
                               f"ops/latrd_v4.py plans for {RING[size]}")
        n_cta = torch.cuda.get_device_properties(Aw.device).multi_processor_count
        n_res, n_cache, table = panel_plan(K, m, off, nb, size, n_cta)
        _plans[key] = (table.to(Aw.device), n_cta, n_res, n_cache)
    table, *args = _plans[key]
    return (table.data_ptr(), *args)


def latrd_panel_v4_plain(Aw, off: int, q_base: int, n_real: int, nb: int):
    """The panel in plain PyTorch, its matvec from the lower triangle."""
    return panel_plain(Aw, off, q_base, n_real, nb, lower_half_matvec(Aw))


def latrd_panel_v4(Aw, off: int, q_base: int, n_real: int, nb: int):
    """One symmetric-half LATRD panel: the CUDA kernel for a CUDA window,
    the plain version for a CPU window."""
    if Aw.device.type == "cpu":
        return latrd_panel_v4_plain(Aw, off, q_base, n_real, nb)
    check_window(Aw, off, nb)
    out = launch_panel("latrd_v4", Aw, off, q_base, n_real, nb, _schedule_args(Aw, off, nb))
    latrd_panel_v4.launches += 1
    return out


latrd_panel_v4.launches = 0


def tridiagonalize_latrd_v4(A: torch.Tensor, nb: int = 64, n_classes: int = 4):
    """Stage 1 with the symmetric-half kernel (the JAX package's
    `tridiagonalize_pallas_v4`): window classes rounded to the tile width
    `T` (384 from n >= 1536, else 128), `nb` a multiple of 8 dividing them."""
    K, n, _ = A.shape
    if n <= 2:
        return _tridiag_small(A)
    T = 384 if n >= 1536 else 128
    nb = max(8, min(nb, n))
    nb -= nb % 8
    S = max(_cdiv(nb, T) * T, T, _cdiv(_cdiv(n, n_classes), T) * T)
    while S % nb:
        nb -= 8
    return tridiagonalize_windows(A, nb, S, latrd_panel_v4)
