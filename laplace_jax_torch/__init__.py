"""laplace-jax-torch: the PyTorch/CUDA port of laplace-jax.

Mirrors the JAX package's module names. Its entry points run on a CUDA
device unless the caller passes `device="cpu"`. It imports nothing of JAX
or of the JAX package.
"""

from laplace_jax_torch.baselaplace import (
    BaseLaplace,
    DiagLaplace,
    FullLaplace,
    KronLaplace,
    LowRankLaplace,
    ParametricLaplace,
)
from laplace_jax_torch.enums import (
    FeatureReduction,
    HessianStructure,
    Likelihood,
    LinkApprox,
    PredType,
    PriorStructure,
    SubsetOfWeights,
    TuningMethod,
)
from laplace_jax_torch.functional_laplace import FunctionalLaplace, FunctionalLLLaplace
from laplace_jax_torch.laplace import Laplace
from laplace_jax_torch.lllaplace import DiagLLLaplace, FullLLLaplace, KronLLLaplace, LLLaplace
from laplace_jax_torch.marglik_training import marglik_training
from laplace_jax_torch.nnmodel import NNModel
from laplace_jax_torch.subnetlaplace import DiagSubnetLaplace, FullSubnetLaplace, SubnetLaplace
from laplace_jax_torch.utils import (
    ArrayLoader,
    RunningMSEMetric,
    RunningNLLMetric,
    expected_calibration_error,
    get_nll,
    load_state_dict,
    save_state_dict,
    validate,
)

__all__ = [
    "BaseLaplace",
    "ParametricLaplace",
    "KronLaplace",
    "FullLaplace",
    "DiagLaplace",
    "LowRankLaplace",
    "LLLaplace",
    "KronLLLaplace",
    "FullLLLaplace",
    "DiagLLLaplace",
    "SubnetLaplace",
    "FullSubnetLaplace",
    "DiagSubnetLaplace",
    "FunctionalLaplace",
    "FunctionalLLLaplace",
    "Laplace",
    "marglik_training",
    "NNModel",
    "ArrayLoader",
    "RunningMSEMetric",
    "RunningNLLMetric",
    "expected_calibration_error",
    "get_nll",
    "validate",
    "save_state_dict",
    "load_state_dict",
    "FeatureReduction",
    "HessianStructure",
    "Likelihood",
    "LinkApprox",
    "PredType",
    "PriorStructure",
    "SubsetOfWeights",
    "TuningMethod",
]
