"""Subnetwork Laplace: a posterior over an index set of the flat parameters
(port of `laplace_jax/subnetlaplace.py`).

The indices address the canonical flat vector (`utils/flatten.py`). The
backend's Jacobians hold only those columns, so `FullSubnetLaplace`'s GGN
is the `syrk` kernel's product of the subnetwork's (B·C, P_sub) rows, and
`DiagSubnetLaplace`'s its diagonal. Samples are the MAP vector with the
subnetwork's entries drawn from the posterior (`assemble_full_samples`).
The backend is the GGN or the EF (its gradients taken in the subvector);
`backend="hessian"` is refused, as in the JAX package. The state carries
`subnetwork_indices`, checked on load.
"""

from __future__ import annotations

import numpy as np
import torch

from laplace_jax_torch.baselaplace import DiagLaplace, FullLaplace, ParametricLaplace

__all__ = ["SubnetLaplace", "FullSubnetLaplace", "DiagSubnetLaplace"]


class SubnetLaplace(ParametricLaplace):
    """Laplace over a subnetwork (reference `subnetlaplace.py:15`).

    `subnetwork_indices` is a non-empty vector of unique integers in
    [0, n_params) indexing the canonical flat parameter vector (a
    `utils.subnetmask` selection). The prior precision is a scalar or one
    value an index.
    """

    def __init__(self, model, likelihood, subnetwork_indices, sigma_noise=1.0,
                 prior_precision=1.0, prior_mean=0.0, temperature: float = 1.0,
                 backend=None, backend_kwargs: dict | None = None,
                 dict_key_x: str = "input_ids", dict_key_y: str = "labels", device=None,
                 parallel=None):
        super().__init__(model, likelihood, sigma_noise=sigma_noise,
                         prior_precision=prior_precision, prior_mean=prior_mean,
                         temperature=temperature, dict_key_x=dict_key_x,
                         dict_key_y=dict_key_y, backend=backend,
                         backend_kwargs=backend_kwargs, device=device, parallel=parallel)
        if isinstance(self._backend_arg, str) and self._backend_arg == "hessian":
            raise ValueError("SubnetLaplace can only be used with GGN and EF.")
        self._check_subnetwork_indices(subnetwork_indices)
        self.subnetwork_indices = torch.as_tensor(np.asarray(subnetwork_indices),
                                                  dtype=torch.long, device=self.device)
        self.n_params_subnet = int(self.subnetwork_indices.shape[0])
        self.prior_precision = self._prior_precision  # validated against the subnetwork
        self._backend_kwargs["subnetwork_indices"] = self.subnetwork_indices

    def _check_subnetwork_indices(self, idx) -> None:
        """Index validation (reference `subnetlaplace.py:113-137`)."""
        if idx is None:
            raise ValueError("Subnetwork indices cannot be None.")
        idx = idx.cpu().numpy() if torch.is_tensor(idx) else np.asarray(idx)
        if idx.size == 0 or idx.ndim != 1 or not np.issubdtype(idx.dtype, np.integer):
            raise ValueError("Subnetwork indices must be non-empty 1-dimensional integer array.")
        if (idx < 0).any() or (idx >= self.n_params).any():
            raise ValueError(f"Subnetwork indices must lie between 0 and "
                             f"n_params={self.n_params}.")
        if len(np.unique(idx)) != len(idx):
            raise ValueError("Subnetwork indices must not contain duplicate entries.")

    def _prior_precision_diag(self, prior_precision) -> torch.Tensor:
        """A scalar or subnetwork-diagonal prior (reference
        `subnetlaplace.py:139-157`)."""
        pp = torch.atleast_1d(prior_precision)
        if pp.shape[0] == 1:
            return pp.expand(self.n_params_subnet)
        if pp.shape[0] == self.n_params_subnet:
            return pp
        raise ValueError("Mismatch of prior and model. Diagonal or scalar prior.")

    @ParametricLaplace.prior_precision.setter
    def prior_precision(self, prior_precision):
        self._posterior_scale = None
        pp = torch.atleast_1d(self._float(prior_precision))
        if pp.ndim > 1:
            raise ValueError("Prior precision needs to be at most one-dimensional.")
        n_sub = getattr(self, "n_params_subnet", None)
        if n_sub is not None and pp.shape[0] not in (1, n_sub):
            raise ValueError("Length of prior precision does not align with subnetwork.")
        self._prior_precision = pp

    @property
    def mean_subnet(self) -> torch.Tensor:
        return self.mean[self.subnetwork_indices]

    def _scatter(self, prior_precision) -> torch.Tensor:
        delta = self.mean_subnet - self.prior_mean
        return (delta * self._prior_precision_diag(prior_precision)) @ delta

    def square_norm(self, value) -> torch.Tensor:
        """Δᵀ P Δ over the subnetwork, of a full or a subnetwork-sized vector."""
        value = self._float(value)
        if value.shape[-1] == self.n_params:
            value = value[..., self.subnetwork_indices]
        delta = value - self.mean_subnet
        self._check_fitted()
        P = self.posterior_precision
        if P.ndim == 1:
            return delta @ (delta * P)
        return delta @ P @ delta

    def assemble_full_samples(self, subnet_samples) -> torch.Tensor:
        """Subnetwork samples (n, P_sub) scattered into copies of the full
        MAP vector (reference `subnetlaplace.py:168-171`)."""
        full = self.mean[None, :].expand(subnet_samples.shape[0], self.n_params).clone()
        full[:, self.subnetwork_indices] = subnet_samples
        return full

    def state_dict(self) -> dict:
        return dict(super().state_dict(), subnetwork_indices=self.subnetwork_indices)

    def load_state_dict(self, state_dict: dict) -> None:
        """Load a state fitted on the same index set (the JAX package's
        `subnetlaplace.py:126-148`)."""
        idx = state_dict.get("subnetwork_indices")
        if idx is None:
            raise ValueError("Loading a wrong Laplace type. Make sure `subset_of_weights` "
                             "and `hessian_structure` are correct!")
        idx = idx.cpu().numpy() if torch.is_tensor(idx) else np.asarray(idx)
        mine = self.subnetwork_indices.cpu().numpy()
        if idx.shape != mine.shape or not np.array_equal(idx, mine):
            raise ValueError("Different `subnetwork_indices` detected! The posterior is "
                             "only valid for the index set it was fitted with.")
        super().load_state_dict({k: v for k, v in state_dict.items()
                                 if k != "subnetwork_indices"})

    def sample(self, n_samples: int = 100, generator: torch.Generator | None = None):
        """Full parameter samples (n_samples, n_params): the MAP vector with
        the subnetwork drawn from its posterior."""
        eps = torch.randn(n_samples, self.n_params_subnet, generator=self._rng(generator),
                          dtype=self._dtype, device=self.device)
        return self._samples_from(eps)


class FullSubnetLaplace(SubnetLaplace, FullLaplace):
    """Dense subnetwork posterior (reference `subnetlaplace.py:174-204`)."""

    _key = ("subnetwork", "full")

    def _samples_from(self, eps):
        return self.assemble_full_samples(self.mean_subnet[None, :]
                                          + eps @ self.posterior_scale.mT)


class DiagSubnetLaplace(SubnetLaplace, DiagLaplace):
    """Diagonal subnetwork posterior (reference `subnetlaplace.py:207-241`)."""

    _key = ("subnetwork", "diag")

    def _samples_from(self, eps):
        return self.assemble_full_samples(self.mean_subnet[None, :]
                                          + eps * self.posterior_scale[None, :])
