"""Utilities of the PyTorch port (see the package docstring).

Exports the counterpart of every name `laplace_jax.utils` exports, for an
`nn.Module` where the JAX package takes a parameter tree. Its four
pytree-only helpers have no shim here; their counterparts are:

- `tree_to_vector`: `utils.flatten.parameters_to_vector(module)` (the flat
  vector in the same canonical order and flax layout);
- `make_unflatten`: `utils.flatten.vector_to_parameters(theta, specs)` (a
  flat vector back to the module's parameters, for
  `torch.func.functional_call`);
- `partition` and `merge`: the trainable set of `subnetlaplace.py`, a mask
  over the module's parameters (`requires_grad` and the subnetwork
  indices), which `leaf_specs(module, trainable=...)` reads.
"""

from laplace_jax_torch.utils.data import ArrayLoader, dataset_size, loader_batches
from laplace_jax_torch.utils.flatten import LeafSpec, leaf_specs, num_params, params_per_leaf
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
from laplace_jax_torch.utils.prior import (
    expand_prior_precision,
    expand_prior_precision_sizes,
    fix_prior_prec_structure,
)
from laplace_jax_torch.utils.serialization import load_state_dict, save_state_dict
from laplace_jax_torch.utils.sod import sod_indices
from laplace_jax_torch.utils.validate import validate

# the subnet masks and SWAG build on `nnmodel`, which imports this package's
# modules: they load at first access
_LAZY = {name: "subnetmask" for name in (
    "SubnetMask", "RandomSubnetMask", "LargestMagnitudeSubnetMask",
    "LargestVarianceDiagLaplaceSubnetMask", "LargestVarianceSWAGSubnetMask",
    "ParamNameSubnetMask", "ModuleNameSubnetMask", "LastLayerSubnetMask")}
_LAZY["fit_diagonal_swag_var"] = "swag"


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "ArrayLoader",
    "dataset_size",
    "loader_batches",
    "LeafSpec",
    "leaf_specs",
    "num_params",
    "params_per_leaf",
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
    "expand_prior_precision",
    "expand_prior_precision_sizes",
    "fix_prior_prec_structure",
    "sod_indices",
    "save_state_dict",
    "load_state_dict",
    "SubnetMask",
    "RandomSubnetMask",
    "LargestMagnitudeSubnetMask",
    "LargestVarianceDiagLaplaceSubnetMask",
    "LargestVarianceSWAGSubnetMask",
    "ParamNameSubnetMask",
    "ModuleNameSubnetMask",
    "LastLayerSubnetMask",
    "fit_diagonal_swag_var",
    "validate",
]
