"""Dense linear-algebra helpers (port of `laplace_jax/utils/linalg.py`)."""

from __future__ import annotations

import numpy as np
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


def invsqrt_precision(M: torch.Tensor) -> torch.Tensor:
    """Lower-triangular scale `S` with `S S^T = M^{-1}` for a precision
    matrix `M`: Cholesky of the flipped precision, then a triangular
    solve."""
    Lf = torch.linalg.cholesky(torch.flip(M, (-2, -1)))
    L_inv = torch.flip(Lf, (-2, -1)).mT  # lower triangular
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return torch.linalg.solve_triangular(L_inv, eye, upper=False)


def kron(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Kronecker product."""
    return torch.kron(A, B)


def block_diag(blocks) -> torch.Tensor:
    """Block-diagonal matrix from square blocks."""
    return torch.block_diag(*blocks)


def diagonal_add_scalar(X: torch.Tensor, value) -> torch.Tensor:
    """`X` plus `value` on its diagonal."""
    return X + value * torch.eye(X.shape[0], dtype=X.dtype, device=X.device)


def is_valid_scalar(scalar) -> bool:
    """True for Python and numpy real scalars and for 0-dim or one-element
    1-dim arrays and tensors."""
    if isinstance(scalar, (int, float)) or (
            isinstance(scalar, np.generic) and np.isreal(scalar)):
        return True
    if isinstance(scalar, (torch.Tensor, np.ndarray)):
        return scalar.ndim == 0 or (scalar.ndim == 1 and scalar.shape[0] == 1)
    return False


def normal_samples_from(mean: torch.Tensor, var: torch.Tensor,
                        randn: torch.Tensor) -> torch.Tensor:
    """`normal_samples` with its standard-normal draws given: `randn` is
    (dim, n_samples), shared by every row of the batch."""
    if mean.ndim != 2:
        raise ValueError("Invalid input shape of mean, should be 2-dimensional.")
    if mean.shape == var.shape:  # diagonal covariance
        scaled = var.sqrt()[..., None] * randn[None]
    elif var.ndim == 3 and var.shape[:2] == mean.shape and var.shape[-1] == mean.shape[1]:
        scaled = torch.linalg.cholesky(var) @ randn[None]
    else:
        raise ValueError("Invalid input shapes.")
    return (mean[..., None] + scaled).permute(2, 0, 1)


def normal_samples(mean: torch.Tensor, var: torch.Tensor, n_samples: int,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """Samples (n_samples, batch, dim) from a batch of Normals with diagonal
    (batch, dim) or full (batch, dim, dim) covariance."""
    randn = torch.randn(mean.shape[-1], n_samples, generator=generator,
                        dtype=mean.dtype, device=mean.device)
    return normal_samples_from(mean, var, randn)
