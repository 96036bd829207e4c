"""Prior-precision structure (port of `laplace_jax/utils/prior.py`)."""

from __future__ import annotations

import torch

from laplace_jax_torch.enums import PriorStructure


def fix_prior_prec_structure(prior_prec_init: float, prior_structure,
                             n_layers: int, n_params: int,
                             dtype=torch.float32, device=None) -> torch.Tensor:
    """An initial prior-precision vector with the requested structure."""
    if prior_structure == PriorStructure.SCALAR:
        n = 1
    elif prior_structure == PriorStructure.LAYERWISE:
        n = n_layers
    elif prior_structure == PriorStructure.DIAG:
        n = n_params
    else:
        raise ValueError(f"Invalid prior structure {prior_structure}.")
    return torch.full((n,), float(prior_prec_init), dtype=dtype, device=device)
