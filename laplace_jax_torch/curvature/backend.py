"""Curvature backend (port of `laplace_jax/curvature/backend.py`: the exact
GGN as a full matrix, its diagonal and its KFAC factors, and the per-sample
Jacobians of the GLM predictive, for classification with the summed
cross-entropy loss).

With `last_layer_path` set, the model's trainable leaves are the last
Dense layer's, the Jacobians are the closed-form φ⊗I of that layer, and
KFAC taps that layer alone.
"""

from __future__ import annotations

import torch

from laplace_jax_torch.curvature.kfac import _sqrt_hessian_cotangents, kfac_factors
from laplace_jax_torch.ops.syrk import syrk
from laplace_jax_torch.utils.flatten import to_flax_layout


def cross_entropy_sum(f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(f, dim=-1)
    return -torch.gather(logp, -1, y[..., None].long()).sum()


class CurvatureBackend:
    """Exact-Fisher (GGN) curvature and Jacobians for one `NNModel`."""

    def __init__(self, model, last_layer_path=None, feature_reduction=None):
        self.model = model
        self.last_layer_path = last_layer_path
        self.feature_reduction = feature_reduction

    def kron(self, x, y, N: int):
        """KFAC factors of one batch as a `Kron`, with the batch loss; the
        activation factor carries 1/N, so batches add."""
        return kfac_factors(self.model, x, y, N, cross_entropy_sum, self.last_layer_path)

    def full(self, x, y, N: int = 1):
        """The batch's dense GGN `H = MᵀM` (P, P), M = Λ^{1/2} J the
        square-root-Hessian-weighted Jacobian rows (B*C, P), by the `syrk`
        kernel; and the batch loss (reference `backend.py:366-403`)."""
        Js, f = self._jacobians_dispatch(x)
        B, C, P = Js.shape
        S = _sqrt_hessian_cotangents(f)  # (C, B, C)
        M = torch.einsum("cbk,bkp->bcp", S, Js).reshape(B * C, P).contiguous()
        return cross_entropy_sum(f, y), syrk(M)

    def diag(self, x, y, N: int = 1):
        """The batch's GGN diagonal (P,) from the Jacobians, and the batch
        loss (reference `backend.py:451-463`)."""
        Js, f = self._jacobians_dispatch(x)
        p = torch.softmax(f, dim=-1)
        lam = torch.diag_embed(p) - p[:, :, None] * p[:, None, :]
        return cross_entropy_sum(f, y), torch.einsum("bcp,bck,bkp->p", Js, lam, Js)

    def _jacobians_dispatch(self, x):
        """The closed-form last-layer Jacobians when a last layer is set,
        else the full per-sample Jacobians."""
        if self.last_layer_path is not None:
            return self.last_layer_jacobians(x)
        return self.jacobians(x)

    def last_layer_jacobians(self, x):
        """Closed-form Jacobians (batch, outputs, P_ll) of the Dense last
        layer from its features φ: the bias block `I` first, then the
        input-major kernel block `J[b, c, i*C + o] = φ[b, i] δ_co`
        (reference `backend.py:209-238`); and f (batch, outputs)."""
        with torch.no_grad():
            f, phi = self.model.apply_with_features(x, self.last_layer_path,
                                                    self.feature_reduction)
        B, C = f.shape
        eye = torch.eye(C, dtype=f.dtype, device=f.device)
        Js = torch.einsum("bi,co->bcio", phi, eye).reshape(B, C, -1)
        if any(s.path[-1] == "bias" for s in self.model.leaf_specs):
            Js = torch.cat([eye.expand(B, C, C), Js], dim=2)
        return Js, f

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
