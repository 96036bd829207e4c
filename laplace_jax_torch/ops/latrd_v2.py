"""LATRD panel kernel with the per-column work grouped by 8 columns, for
CUDA (replaces `laplace_jax/ops/latrd_pallas_v2.py`, `_latrd_panel_v2` /
`_panel_kernel_v2`). Stage 1 runs it when asked for
(`eigh_stack_ts(stage1="latrd_v2")`); the automatic choice never does, as
in the JAX package.

Same panel contract as `ops/latrd.py`, with its full-row trailing matvec.
`csrc/latrd_v2.cu` reads the 8 window rows of each group of 8 columns once
and corrects them for the earlier groups' reflectors in one pass; its
header says which of the TPU v2's changes apply on the card. The kernel
needs `nb` and `off` to be multiples of 8.

`latrd_panel_v2.launches` counts the panels launched on the card.
"""

from __future__ import annotations

import torch

from laplace_jax_torch.ops.latrd import launch_panel, tridiagonalize_latrd
from laplace_jax_torch.ops.tridiag import _cdiv, panel_plain, tridiagonalize_windows

__all__ = ["latrd_panel_v2", "latrd_panel_v2_plain", "tridiagonalize_latrd_v2"]

GROUP = 8  # columns per group: nb and off are multiples of it


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
    out = launch_panel("latrd_v2", Aw, off, q_base, n_real, nb)
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
