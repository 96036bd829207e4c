"""Prior-precision structure (port of `laplace_jax/utils/prior.py`)."""

from __future__ import annotations

import torch
from torch import nn

from laplace_jax_torch.enums import PriorStructure
from laplace_jax_torch.utils.flatten import params_per_leaf


def expand_prior_precision(prior_prec, model: nn.Module) -> torch.Tensor:
    """A scalar, per-leaf or diagonal prior precision as a (P,) diagonal in
    canonical flatten order over the trainable leaves of `model`, in their
    dtype and on their device."""
    p0 = next(p for p in model.parameters() if p.requires_grad)
    sizes = params_per_leaf(model)
    P = sum(sizes)
    if not torch.is_tensor(prior_prec):
        prior_prec = torch.as_tensor(prior_prec, dtype=p0.dtype)
    prior_prec = torch.atleast_1d(prior_prec.to(p0.device))
    if prior_prec.ndim != 1:
        raise ValueError("Prior precision must be at most 1-dimensional.")
    if prior_prec.shape[0] == 1:
        return prior_prec.expand(P).to(p0.dtype)
    if prior_prec.shape[0] == P:
        return prior_prec
    if prior_prec.shape[0] == len(sizes):
        return prior_prec.to(p0.dtype).repeat_interleave(
            torch.as_tensor(sizes, device=p0.device), output_size=P)
    raise ValueError("Mismatch of prior and model. Diagonal, scalar, or per-layer prior.")


def expand_prior_precision_sizes(prior_prec: torch.Tensor, leaf_sizes) -> torch.Tensor:
    """A scalar, per-leaf or diagonal prior precision as a (P,) diagonal over
    leaves of `leaf_sizes` in canonical order; differentiable in
    `prior_prec` (the marglik hyperparameter steps rely on it)."""
    P = sum(leaf_sizes)
    prior_prec = torch.atleast_1d(prior_prec)
    if prior_prec.shape[0] == 1:
        return prior_prec.expand(P)
    if prior_prec.shape[0] == P:
        return prior_prec
    if prior_prec.shape[0] == len(leaf_sizes):
        return torch.cat([prior_prec[i].expand(n) for i, n in enumerate(leaf_sizes)])
    raise ValueError("Mismatch of prior and model. Diagonal, scalar, or per-layer prior.")


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
