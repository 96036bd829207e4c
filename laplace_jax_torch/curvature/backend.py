"""Curvature backend (port of `laplace_jax/curvature/backend.py`: the KFAC
path and the full per-sample Jacobians of the GLM predictive, for
classification with the summed cross-entropy loss)."""

from __future__ import annotations

import torch

from laplace_jax_torch.curvature.kfac import kfac_factors
from laplace_jax_torch.utils.flatten import to_flax_layout


def cross_entropy_sum(f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(f, dim=-1)
    return -torch.gather(logp, -1, y[..., None].long()).sum()


class CurvatureBackend:
    """Exact-Fisher KFAC and Jacobians for one `NNModel`."""

    def __init__(self, model):
        self.model = model

    def kron(self, x, y, N: int):
        """KFAC factors of one batch as a `Kron`, with the batch loss; the
        activation factor carries 1/N, so batches add."""
        return kfac_factors(self.model, x, y, N, cross_entropy_sum)

    def jacobians(self, x):
        """Per-sample Jacobians J (batch, outputs, n_params), columns in the
        canonical flat order, and f (batch, outputs).

        One backward pass per sample, each batched over the C outputs.
        """
        params = self.model.params_in_order()
        rows = []
        with torch.enable_grad():
            for b in range(x.shape[0]):
                fb = self.model.apply(x[b : b + 1])[0]
                C = fb.shape[0]
                eye = torch.eye(C, dtype=fb.dtype, device=fb.device)
                gs = torch.autograd.grad(fb, params, grad_outputs=eye,
                                         is_grads_batched=True)
                rows.append(torch.cat(
                    [to_flax_layout(g, lead=1).reshape(C, -1) for g in gs], 1))
        with torch.no_grad():
            f = self.model.apply(x)
        return torch.stack(rows), f
