"""Dense linear-algebra helpers (port of `laplace_jax/utils/linalg.py`)."""

from __future__ import annotations

import torch


def symeig(M: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric eigendecomposition with non-negative clamped eigenvalues.

    Returns (eigenvalues, eigenvectors). If the decomposition produces NaNs,
    retries once with unit jitter on the diagonal (`W (L + I) W^T`), as the
    JAX package and the reference do.
    """
    M = (M + M.mT) / 2
    L, W = torch.linalg.eigh(M)
    if bool(torch.isnan(L).any()) or bool(torch.isnan(W).any()):
        eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
        L, W = torch.linalg.eigh(M + eye)
        L = L - 1.0
    return torch.nan_to_num(L.clamp(min=0.0)), torch.nan_to_num(W)
