"""Symmetric-half LATRD panel kernel with a fixed-order sum, for CUDA
(replaces `laplace_jax/ops/latrd_pallas_v3.py`, `latrd_panel_v3` /
`_panel_kernel`). Stage 1 runs it when asked for
(`eigh_stack_ts(stage1="latrd_v3")`); the automatic choice never does, as
in the JAX package.

Same panel contract as `ops/latrd.py`; the trailing matvec reads only the
lower triangle of each window, in square tiles. The TPU kernel adds the tile
pairs' products in one fixed order; `csrc/latrd_v3.cu` does the same on the
card with no atomics (each tile pair writes its two partial products into a
slot of its own, and one reduction adds them in a fixed order), so its
results are bitwise reproducible from run to run, where `latrd_v4`'s atomics
are not.

`latrd_panel_v3.launches` counts the panels launched on the card.
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

__all__ = ["latrd_panel_v3", "latrd_panel_v3_plain", "tridiagonalize_latrd_v3"]

def latrd_panel_v3_plain(Aw, off: int, q_base: int, n_real: int, nb: int):
    """The panel in plain PyTorch, its matvec from the lower triangle."""
    return panel_plain(Aw, off, q_base, n_real, nb, lower_half_matvec(Aw))


def latrd_panel_v3(Aw, off: int, q_base: int, n_real: int, nb: int):
    """One fixed-order symmetric-half LATRD panel: the CUDA kernel for a
    CUDA window, the plain version for a CPU window."""
    if Aw.device.type == "cpu":
        return latrd_panel_v3_plain(Aw, off, q_base, n_real, nb)
    out = launch_panel("latrd_v3", Aw, off, q_base, n_real, nb)
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
