"""Symmetric-half LATRD panel kernel for CUDA (replaces
`laplace_jax/ops/latrd_pallas_v4.py`, `latrd_panel_v4` / `_panel_kernel`),
used by stage 1 for n >= 2304.

Same panel contract as `ops/latrd.py`; the trailing matvec reads only the
lower triangle of each window, and each tile serves both `y[R] += A[R,S] v[S]`
and `y[S] += A[R,S]^T v[R]`. The TPU kernel reads the triangle as column
strips of a col-tile-major copy of the window; the CUDA kernel reads tiles
of the row-major window directly, so no copy is made.

`latrd_panel_v4.launches` counts the panels launched on the card.
"""

from __future__ import annotations

import torch

from laplace_jax_torch.ops.latrd import launch_panel
from laplace_jax_torch.ops.tridiag import (
    _cdiv,
    _tridiag_small,
    lower_half_matvec,
    panel_plain,
    tridiagonalize_windows,
)

__all__ = ["latrd_panel_v4", "latrd_panel_v4_plain", "tridiagonalize_latrd_v4"]


def latrd_panel_v4_plain(Aw, off: int, q_base: int, n_real: int, nb: int):
    """The panel in plain PyTorch, its matvec from the lower triangle."""
    return panel_plain(Aw, off, q_base, n_real, nb, lower_half_matvec(Aw))


def latrd_panel_v4(Aw, off: int, q_base: int, n_real: int, nb: int):
    """One symmetric-half LATRD panel: the CUDA kernel for a CUDA window,
    the plain version for a CPU window."""
    if Aw.device.type == "cpu":
        return latrd_panel_v4_plain(Aw, off, q_base, n_real, nb)
    out = launch_panel("latrd_v4", Aw, off, q_base, n_real, nb)
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
