"""Curvature backend (port of `laplace_jax/curvature/backend.py`: the exact
GGN as a full matrix, its diagonal and its KFAC factors, and the per-sample
Jacobians of the GLM predictive).

Loss conventions, as in the JAX package: regression uses the summed
squared error with factor 1/2, classification the summed cross-entropy with
factor 1. So the regression GGN is JᵀJ (the Hessian of ½·SSE in f is I),
its KFAC cotangent is √2·I with the factors then scaled by 1/2, and its
diagonal carries no Λ.

With `last_layer_path` set, the model's trainable leaves are the last
layer's and KFAC taps that layer alone; the Jacobians are the closed-form
φ⊗I when that layer is a Dense (`last_layer_dense`), else the per-sample
Jacobians over its leaves (the JAX package's `use_phi`,
`laplace_jax/curvature/backend.py:240-258`). With `subnetwork_indices` set, the Jacobians
hold only those columns of the canonical flat vector, in index order, so
the dense GGN and its diagonal are the subnetwork's.
"""

from __future__ import annotations

import torch

from laplace_jax_torch.curvature.kfac import _sqrt_hessian_cotangents, kfac_factors
from laplace_jax_torch.enums import Likelihood
from laplace_jax_torch.nnmodel import batch_len, batch_slice
from laplace_jax_torch.ops.syrk import syrk
from laplace_jax_torch.utils.flatten import to_flax_layout


def mse_sum(f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return ((f - y) ** 2).sum()


def cross_entropy_sum(f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(f, dim=-1)
    return -torch.gather(logp, -1, y[..., None].long()).sum()


class CurvatureBackend:
    """Exact-Fisher (GGN) curvature and Jacobians for one `NNModel` and a
    likelihood, 'classification' or 'regression'."""

    def __init__(self, model, likelihood=Likelihood.CLASSIFICATION, last_layer_path=None,
                 feature_reduction=None, subnetwork_indices=None, last_layer_dense: bool = True):
        if likelihood not in (Likelihood.REGRESSION, Likelihood.CLASSIFICATION):
            raise ValueError("Backend likelihood must be regression or classification.")
        self.model = model
        self.likelihood = likelihood
        self.last_layer_path = last_layer_path
        self.feature_reduction = feature_reduction
        self.last_layer_dense = last_layer_dense
        self.subnetwork_indices = subnetwork_indices  # a long tensor, or None
        if likelihood == Likelihood.REGRESSION:
            self.lossfunc, self.factor = mse_sum, 0.5
        else:
            self.lossfunc, self.factor = cross_entropy_sum, 1.0

    def kron(self, x, y, N: int):
        """KFAC factors of one batch as a `Kron`, with the batch loss; the
        activation factor carries 1/N, so batches add."""
        loss, kron = kfac_factors(self.model, x, y, N, self.lossfunc, self.last_layer_path,
                                  self.likelihood)
        return self.factor * loss, kron * self.factor

    def full(self, x, y, N: int = 1):
        """The batch's dense GGN `H = MᵀM` (P, P) by the `syrk` kernel, with
        M (B*C, P) the Jacobian rows, weighted by Λ^{1/2} for
        classification; and the batch loss (reference `backend.py:366-403`)."""
        Js, f = self._jacobians_dispatch(x)
        B, C, P = Js.shape
        if self.likelihood == Likelihood.REGRESSION:
            M = Js.reshape(B * C, P)
        else:
            S = _sqrt_hessian_cotangents(f)  # (C, B, C)
            M = torch.einsum("cbk,bkp->bcp", S, Js).reshape(B * C, P)
        return self.factor * self.lossfunc(f, y), syrk(M.contiguous())

    def diag(self, x, y, N: int = 1):
        """The batch's GGN diagonal (P,) from the Jacobians, and the batch
        loss (reference `backend.py:451-463`)."""
        Js, f = self._jacobians_dispatch(x)
        if self.likelihood == Likelihood.REGRESSION:
            H = torch.einsum("bcp,bcp->p", Js, Js)
        else:
            p = torch.softmax(f, dim=-1)
            lam = torch.diag_embed(p) - p[:, :, None] * p[:, None, :]
            H = torch.einsum("bcp,bck,bkp->p", Js, lam, Js)
        return self.factor * self.lossfunc(f, y), H

    def _jacobians_dispatch(self, x, create_graph: bool = False):
        """The closed-form last-layer Jacobians when the last layer is a
        Dense, else the per-sample Jacobians over the trainable leaves; with
        `create_graph` both stay differentiable (in the input, for
        `enable_backprop`)."""
        if self.last_layer_path is not None and self.last_layer_dense:
            return self.last_layer_jacobians(x, create_graph)
        return self.jacobians(x, create_graph)

    def last_layer_jacobians(self, x, create_graph: bool = False):
        """Closed-form Jacobians (batch, outputs, P_ll) of the Dense last
        layer from its features φ: the bias block `I` first, then the
        input-major kernel block `J[b, c, i*C + o] = φ[b, i] δ_co`
        (reference `backend.py:209-238`); and f (batch, outputs)."""
        with torch.set_grad_enabled(create_graph):
            f, phi = self.model.apply_with_features(x, self.last_layer_path,
                                                    self.feature_reduction)
        B, C = f.shape
        eye = torch.eye(C, dtype=f.dtype, device=f.device)
        Js = torch.einsum("bi,co->bcio", phi, eye).reshape(B, C, -1)
        if any(s.path[-1] == "bias" for s in self.model.leaf_specs):
            Js = torch.cat([eye.expand(B, C, C), Js], dim=2)
        return Js, f

    def jacobians(self, x, create_graph: bool = False):
        """Per-sample Jacobians J (batch, outputs, n_params), columns in the
        canonical flat order, and f (batch, outputs); with
        `subnetwork_indices`, J (batch, outputs, n_indices), the columns at
        those indices.

        One backward pass per sample, each batched over the C outputs. A
        sample's (C, n_params) rows are cut to the subnetwork before the
        next, so no (batch, outputs, n_params) array exists then.
        """
        params = self.model.params_in_order()
        idx = self.subnetwork_indices
        rows = []
        with torch.enable_grad():
            for b in range(batch_len(x)):
                fb = self.model.apply(batch_slice(x, slice(b, b + 1)))[0]
                C = fb.shape[0]
                eye = torch.eye(C, dtype=fb.dtype, device=fb.device)
                gs = torch.autograd.grad(fb, params, grad_outputs=eye,
                                         is_grads_batched=True, create_graph=create_graph)
                row = torch.cat([to_flax_layout(g, s.layout, lead=1).reshape(C, -1)
                                 for s, g in zip(self.model.leaf_specs, gs)], 1)
                rows.append(row if idx is None else row[:, idx])
        with torch.set_grad_enabled(create_graph):
            f = self.model.apply(x)
        return torch.stack(rows), f
