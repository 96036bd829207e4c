"""`Laplace()` factory (port of `laplace_jax/laplace.py`), for the flavor
this package has: all weights with a KFAC Hessian."""

from __future__ import annotations

from laplace_jax_torch.baselaplace import BaseLaplace, KronLaplace
from laplace_jax_torch.enums import HessianStructure, SubsetOfWeights


def Laplace(model, likelihood, subset_of_weights=SubsetOfWeights.LAST_LAYER,
            hessian_structure=HessianStructure.KRON, *args, **kwargs) -> BaseLaplace:
    """Simplified Laplace access using strings instead of classes."""
    key = (subset_of_weights, hessian_structure)
    if key != KronLaplace._key:
        raise ValueError(f"{key} is not ported; only ('all', 'kron') is.")
    return KronLaplace(model, likelihood, *args, **kwargs)
