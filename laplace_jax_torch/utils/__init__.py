"""Utilities of the PyTorch port (see the package docstring)."""

from laplace_jax_torch.utils.data import ArrayLoader, dataset_size, loader_batches
from laplace_jax_torch.utils.flatten import LeafSpec, leaf_specs
from laplace_jax_torch.utils.linalg import (
    block_diag,
    diagonal_add_scalar,
    invsqrt_precision,
    is_valid_scalar,
    kron,
    normal_samples,
    symeig,
)
from laplace_jax_torch.utils.matrix import Kron, KronDecomposed
from laplace_jax_torch.utils.metrics import (
    RunningMSEMetric,
    RunningNLLMetric,
    expected_calibration_error,
    get_nll,
)
from laplace_jax_torch.utils.prior import expand_prior_precision_sizes, fix_prior_prec_structure
from laplace_jax_torch.utils.serialization import load_state_dict, save_state_dict
from laplace_jax_torch.utils.validate import validate

__all__ = [
    "ArrayLoader",
    "dataset_size",
    "loader_batches",
    "LeafSpec",
    "leaf_specs",
    "block_diag",
    "diagonal_add_scalar",
    "invsqrt_precision",
    "is_valid_scalar",
    "kron",
    "normal_samples",
    "symeig",
    "Kron",
    "KronDecomposed",
    "RunningMSEMetric",
    "RunningNLLMetric",
    "expected_calibration_error",
    "get_nll",
    "expand_prior_precision_sizes",
    "fix_prior_prec_structure",
    "validate",
    "save_state_dict",
    "load_state_dict",
]
