"""laplace-jax-torch: the PyTorch/CUDA port of laplace-jax.

Mirrors the JAX package's module names. Its entry points run on a CUDA
device unless the caller passes `device="cpu"`. It imports nothing of JAX
or of the JAX package.
"""

from laplace_jax_torch.baselaplace import BaseLaplace, KronLaplace, ParametricLaplace
from laplace_jax_torch.enums import (
    HessianStructure,
    Likelihood,
    LinkApprox,
    PredType,
    PriorStructure,
    SubsetOfWeights,
    TuningMethod,
)
from laplace_jax_torch.laplace import Laplace
from laplace_jax_torch.nnmodel import NNModel

__all__ = [
    "BaseLaplace",
    "ParametricLaplace",
    "KronLaplace",
    "Laplace",
    "NNModel",
    "HessianStructure",
    "Likelihood",
    "LinkApprox",
    "PredType",
    "PriorStructure",
    "SubsetOfWeights",
    "TuningMethod",
]
