"""The curvature backend (port of `laplace_jax/curvature/`): GGN, MC Fisher,
empirical Fisher and exact Hessian as full, diagonal and KFAC curvature, and
the low-rank eigendecomposition by Lanczos."""

from laplace_jax_torch.curvature.backend import (
    CurvatureBackend,
    EFBackend,
    GGNBackend,
    HessianBackend,
    cross_entropy_sum,
    mse_sum,
)
from laplace_jax_torch.curvature.kfac import conv_patches, kfac_factors
from laplace_jax_torch.curvature.lanczos import lanczos_eig_curvature

__all__ = [
    "CurvatureBackend",
    "EFBackend",
    "GGNBackend",
    "HessianBackend",
    "cross_entropy_sum",
    "mse_sum",
    "conv_patches",
    "kfac_factors",
    "lanczos_eig_curvature",
]
