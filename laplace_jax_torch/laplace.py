"""`Laplace()` factory (port of `laplace_jax/laplace.py`): dispatch on each
ported class's `_key`, `(subset_of_weights, hessian_structure)`."""

from __future__ import annotations

from laplace_jax_torch.baselaplace import BaseLaplace
from laplace_jax_torch.enums import HessianStructure, SubsetOfWeights


def _all_subclasses(cls) -> set:
    return set(cls.__subclasses__()).union(
        s for c in cls.__subclasses__() for s in _all_subclasses(c))


def Laplace(model, likelihood, subset_of_weights=SubsetOfWeights.LAST_LAYER,
            hessian_structure=HessianStructure.KRON, *args, **kwargs) -> BaseLaplace:
    """Simplified Laplace access using strings instead of classes; the
    default is last-layer KFAC, as in the reference. (The package's
    `__init__` imports every flavor module, so every `_key` is registered.)"""
    laplace_map = {c._key: c for c in _all_subclasses(BaseLaplace) if hasattr(c, "_key")}
    key = tuple(getattr(k, "value", k) for k in (subset_of_weights, hessian_structure))
    if key not in laplace_map:
        raise ValueError(f"{key} is not ported; the ported flavors are {sorted(laplace_map)}.")
    return laplace_map[key](model, likelihood, *args, **kwargs)
