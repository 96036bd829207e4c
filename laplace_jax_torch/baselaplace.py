"""Laplace classes of the main path: BaseLaplace, ParametricLaplace and
KronLaplace (port of `laplace_jax/baselaplace.py`).

- `fit` accumulates per-batch KFAC factors in a Python loop (the JAX
  package's `lax.scan`), merges online fits with the N-rescaled activation
  factor, and eigendecomposes the factors.
- `log_marginal_likelihood` is differentiable in the prior precision and
  the noise; `optimize_prior_precision` runs `torch.optim.Adam` on the log
  prior precision (the same update as optax's Adam).
- The GLM predictive uses the full per-sample Jacobians and the probit link.

The likelihood is classification (regression is not ported yet).
Everything runs on `device`: CUDA unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import math
import time

import torch

from laplace_jax_torch.curvature.backend import CurvatureBackend
from laplace_jax_torch.enums import Likelihood, PriorStructure, TuningMethod
from laplace_jax_torch.nnmodel import NNModel
from laplace_jax_torch.utils.data import dataset_size
from laplace_jax_torch.utils.device import full_f32_matmuls, resolve_device
from laplace_jax_torch.utils.matrix import Kron, KronDecomposed, broadcast_groups
from laplace_jax_torch.utils.prior import fix_prior_prec_structure

__all__ = ["BaseLaplace", "ParametricLaplace", "KronLaplace"]


class BaseLaplace:
    """Base class (reference `baselaplace.py:77`). `model` is an `nn.Module`
    taking the public input layout; it is moved to `device`."""

    def __init__(self, model, likelihood, sigma_noise=1.0, prior_precision=1.0,
                 prior_mean=0.0, temperature: float = 1.0, device=None):
        if likelihood != Likelihood.CLASSIFICATION:
            raise ValueError(f"Likelihood {likelihood!r} is not ported; only "
                             "'classification' is.")
        self.device = resolve_device(device)
        full_f32_matmuls()
        self.model = NNModel(model.to(self.device))
        self.likelihood = likelihood
        self.n_params = self.model.n_params
        self.n_layers = self.model.n_layers
        self.prior_precision = prior_precision
        self.prior_mean = prior_mean
        if sigma_noise != 1:
            raise ValueError("Sigma noise != 1 only available for regression.")
        self.sigma_noise = sigma_noise
        self.temperature = temperature
        self.loss = 0.0
        self.n_data = 0
        self.backend = CurvatureBackend(self.model)

    @property
    def _dtype(self):
        return self.model.params_in_order()[0].dtype

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=self._dtype, device=self.device)

    # ---- priors
    @property
    def prior_precision(self):
        return self._prior_precision

    @prior_precision.setter
    def prior_precision(self, prior_precision):
        pp = torch.atleast_1d(self._tensor(prior_precision))
        if pp.ndim > 1:
            raise ValueError("Prior precision needs to be at most one-dimensional.")
        if pp.shape[0] not in (1, self.n_layers, self.n_params):
            raise ValueError("Length of prior precision does not align with architecture.")
        self._prior_precision = pp

    @property
    def prior_mean(self):
        return self._prior_mean

    @prior_mean.setter
    def prior_mean(self, prior_mean):
        pm = torch.atleast_1d(self._tensor(prior_mean))
        if pm.ndim > 1 or pm.shape[0] not in (1, self.n_params):
            raise ValueError("Invalid length of prior mean.")
        self._prior_mean = pm

    @property
    def sigma_noise(self):
        return self._sigma_noise

    @sigma_noise.setter
    def sigma_noise(self, sigma_noise):
        sn = self._tensor(sigma_noise)
        if sn.ndim > 1 or sn.numel() != 1:
            raise ValueError("Sigma noise needs to be a scalar.")
        self._sigma_noise = sn.reshape(())

    def _prior_precision_diag(self, prior_precision) -> torch.Tensor:
        pp = torch.atleast_1d(prior_precision)
        if pp.shape[0] == 1:
            return pp.expand(self.n_params)
        if pp.shape[0] == self.n_params:
            return pp
        if pp.shape[0] == self.n_layers:
            return broadcast_groups(pp, [s.size for s in self.model.leaf_specs])
        raise ValueError("Mismatch of prior and model. Diagonal, scalar, or per-layer prior.")

    def _log_likelihood(self, sigma_noise) -> torch.Tensor:
        return -1.0 / (sigma_noise ** 2) / self.temperature * self.loss

    # ---- prior tuning
    def optimize_prior_precision(self, method=TuningMethod.MARGLIK, n_steps: int = 100,
                                 lr: float = 1e-1, init_prior_prec=1.0,
                                 prior_structure=PriorStructure.SCALAR) -> None:
        """Post-hoc prior-precision tuning by marglik gradient steps
        (reference `baselaplace.py:479`); gridsearch is not ported."""
        if method != TuningMethod.MARGLIK:
            raise ValueError("Only the marglik method is ported.")
        self.prior_precision = init_prior_prec
        if self.prior_precision.shape[0] == 1 and prior_structure != PriorStructure.SCALAR:
            self.prior_precision = fix_prior_prec_structure(
                float(self.prior_precision[0]), prior_structure, self.n_layers,
                self.n_params, dtype=self._dtype, device=self.device)
        log_pp = self.prior_precision.log().clone().requires_grad_(True)
        opt = torch.optim.Adam([log_pp], lr=lr)
        for _ in range(n_steps):
            opt.zero_grad()
            neg = -self._log_marglik(log_pp.exp(), self.sigma_noise)
            neg.backward()
            opt.step()
        self.prior_precision = log_pp.detach().exp()


class ParametricLaplace(BaseLaplace):
    """Weight-space posterior skeleton (reference `baselaplace.py:667`)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.H = None
        self.mean = self.prior_mean
        self.fit_seconds: dict = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(self, train_loader, override: bool = True) -> None:
        """Accumulate batch curvature over the loader (reference
        `baselaplace.py:709`, `_scan_accumulate` at `:814`); `fit_seconds["accumulate"]` records the
        loop's wall time."""
        if iter(train_loader) is train_loader:
            raise ValueError("train_loader must be re-iterable (not a one-shot iterator).")
        if override:
            self.loss = 0.0
            self.n_data = 0
        self.mean = self.model.mean_vector.detach()
        N = dataset_size(train_loader)
        self._sync()
        t0 = time.perf_counter()
        H = None
        for data in train_loader:
            X, y = data
            X = self._tensor(X)
            y = torch.as_tensor(y, device=self.device)
            loss_b, H_b = self._curv_closure(X, y, N)
            self.loss = self.loss + loss_b
            H = H_b if H is None else H + H_b
        if H is None:
            raise RuntimeError("train_loader yielded no batches.")
        self._sync()
        self.fit_seconds["accumulate"] = time.perf_counter() - t0
        self.H = H
        self.n_data += N

    def _curv_closure(self, x, y, N):
        raise NotImplementedError

    # ---- marglik
    def _scatter(self, prior_precision) -> torch.Tensor:
        delta = self.mean - self.prior_mean
        return (delta * self._prior_precision_diag(prior_precision)) @ delta

    def _log_det_posterior_precision(self, prior_precision, sigma_noise):
        raise NotImplementedError

    def _log_det_ratio(self, prior_precision, sigma_noise):
        return (self._log_det_posterior_precision(prior_precision, sigma_noise)
                - torch.log(self._prior_precision_diag(prior_precision)).sum())

    def _log_marglik(self, prior_precision, sigma_noise):
        return self._log_likelihood(sigma_noise) - 0.5 * (
            self._log_det_ratio(prior_precision, sigma_noise)
            + self._scatter(prior_precision))

    def log_marginal_likelihood(self, prior_precision=None, sigma_noise=None):
        """Laplace approximation to the log marginal likelihood, differentiable
        in its arguments (reference `baselaplace.py:892`)."""
        if prior_precision is not None and not (
                torch.is_tensor(prior_precision) and prior_precision.requires_grad):
            self.prior_precision = prior_precision
        if sigma_noise is not None:
            raise ValueError("Can only change sigma_noise for regression.")
        pp = (self.prior_precision if prior_precision is None
              else torch.atleast_1d(self._tensor(prior_precision)))
        return self._log_marglik(pp, self.sigma_noise)

    # ---- predictive
    def __call__(self, x):
        """GLM predictive with the probit link (reference
        `baselaplace.py:913`, `:989`, link at `:307`): class probabilities (batch, classes)."""
        Js, f_mu = self.backend.jacobians(self._tensor(x))
        with torch.no_grad():
            f_var = self.functional_variance(Js)
        kappa = 1.0 / torch.sqrt(1.0 + math.pi / 8 * torch.diagonal(f_var, dim1=1, dim2=2))
        return torch.softmax(kappa * f_mu, dim=-1)

    def functional_variance(self, Js) -> torch.Tensor:
        raise NotImplementedError


class KronLaplace(ParametricLaplace):
    """KFAC posterior precision (reference `baselaplace.py:1200`).

    `H_facs` keeps the undecomposed factors for online fits; `H` holds the
    eigendecomposed `KronDecomposed` after `fit`. Prior precision is scalar
    or per-layer.
    """

    _key = ("all", "kron")

    def __init__(self, model, likelihood, sigma_noise=1.0, prior_precision=1.0,
                 prior_mean=0.0, temperature: float = 1.0, damping: bool = False,
                 device=None):
        self.damping = damping
        self.H_facs = None
        super().__init__(model, likelihood, sigma_noise, prior_precision,
                         prior_mean, temperature, device)

    def _curv_closure(self, x, y, N):
        return self.backend.kron(x, y, N)

    @staticmethod
    def _rescale_factors(kron: Kron, factor) -> Kron:
        """Rescale the 1/N-carrying activation factor A = F[0]."""
        return Kron([(F[0] * factor, F[1]) if len(F) == 2 else F for F in kron.kfacs])

    def fit(self, train_loader, override: bool = True) -> None:
        """Fit, then eigendecompose the factors; `fit_seconds["decompose"]`
        records the decomposition's wall time."""
        if override:
            self.H_facs = None
        if self.H_facs is not None:
            n_old, n_new = self.n_data, dataset_size(train_loader)
            self.H_facs = self._rescale_factors(self.H_facs, n_old / (n_old + n_new))
        super().fit(train_loader, override=override)
        if self.H_facs is None:
            self.H_facs = self.H
        else:
            self.H_facs = self.H_facs + self._rescale_factors(self.H, n_new / (n_new + n_old))
        t0 = time.perf_counter()
        self.H = self.H_facs.decompose(damping=self.damping)
        self._sync()
        self.fit_seconds["decompose"] = time.perf_counter() - t0

    def _check_fitted(self):
        if not isinstance(self.H, KronDecomposed):
            raise AttributeError("Laplace not fitted. Run fit() first.")

    def _posterior_precision(self, prior_precision, sigma_noise) -> KronDecomposed:
        h_factor = 1.0 / (sigma_noise ** 2) / self.temperature
        return self.H * h_factor + prior_precision

    @property
    def posterior_precision(self) -> KronDecomposed:
        self._check_fitted()
        return self._posterior_precision(self.prior_precision, self.sigma_noise)

    def _log_det_posterior_precision(self, prior_precision, sigma_noise):
        if self.H is None:  # not fitted: the prior alone
            return torch.log(self._prior_precision_diag(prior_precision)).sum()
        if self.damping:
            return self._posterior_precision(prior_precision, sigma_noise).logdet()
        # logdet(f H + delta) = sum log(f lam + delta) over the cached flat
        # Kronecker eigenvalues of H
        h_factor = 1.0 / (sigma_noise ** 2) / self.temperature
        dflat = broadcast_groups(self.H._check_deltas(prior_precision), self.H.group_sizes)
        return torch.log(h_factor * self.H._flat_eigs + dflat).sum()

    def functional_variance(self, Js) -> torch.Tensor:
        return self.posterior_precision.inv_square_form(Js)

    @BaseLaplace.prior_precision.setter
    def prior_precision(self, prior_precision):
        BaseLaplace.prior_precision.fset(self, prior_precision)
        if self._prior_precision.shape[0] not in (1, self.n_layers):
            raise ValueError("Prior precision for Kron either scalar or per-layer.")
