"""Weight-space Laplace classes: BaseLaplace, ParametricLaplace and the
Kron, Full and Diag posteriors (port of `laplace_jax/baselaplace.py`).

- `fit` accumulates per-batch curvature in a Python loop (the JAX
  package's `lax.scan`): KFAC factors, merged across online fits with the
  N-rescaled activation factor and then eigendecomposed (Kron); the dense
  GGN through the `syrk` kernel (Full); the GGN diagonal (Diag).
- `log_marginal_likelihood` is differentiable in the prior precision and
  the noise; `optimize_prior_precision` runs `torch.optim.Adam` on the log
  prior precision (the same update as optax's Adam).
- The GLM predictive uses the per-sample Jacobians (`_jacobians_dispatch`)
  and the probit link; `predictive_samples` draws GLM samples through the
  softmax.

The likelihood is classification (regression is not ported yet).
Everything runs on `device`: CUDA unless the caller passes `device="cpu"`.
Fits, marglik and the predictives run in full float32 (`utils/device.full_f32`);
the caller's TF32 settings are left as they were.
"""

from __future__ import annotations

import math
import time

import torch

from laplace_jax_torch.curvature.backend import CurvatureBackend
from laplace_jax_torch.enums import Likelihood, PredType, PriorStructure, TuningMethod
from laplace_jax_torch.nnmodel import NNModel
from laplace_jax_torch.utils.data import dataset_size
from laplace_jax_torch.utils.device import full_f32, resolve_device
from laplace_jax_torch.utils.linalg import invsqrt_precision, normal_samples
from laplace_jax_torch.utils.matrix import Kron, KronDecomposed, broadcast_groups
from laplace_jax_torch.utils.prior import fix_prior_prec_structure

__all__ = ["BaseLaplace", "ParametricLaplace", "KronLaplace", "FullLaplace", "DiagLaplace"]


class BaseLaplace:
    """Base class (reference `baselaplace.py:77`). `model` is an `nn.Module`
    taking the public input layout; it is moved to `device`."""

    def __init__(self, model, likelihood, sigma_noise=1.0, prior_precision=1.0,
                 prior_mean=0.0, temperature: float = 1.0, device=None):
        if likelihood != Likelihood.CLASSIFICATION:
            raise ValueError(f"Likelihood {likelihood!r} is not ported; only "
                             "'classification' is.")
        self.device = resolve_device(device)
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
        self._posterior_scale = None
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

    @property
    def prior_precision_diag(self) -> torch.Tensor:
        """The prior precision as a (n_params,) diagonal."""
        return self._prior_precision_diag(self.prior_precision)

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
    @full_f32()
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

    @full_f32()
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
        self.H = H if override or self.H is None else self.H + H
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
        if self.H is None:  # not fitted: the posterior is the prior
            return torch.zeros((), dtype=self._dtype, device=self.device)
        return (self._log_det_posterior_precision(prior_precision, sigma_noise)
                - torch.log(self._prior_precision_diag(prior_precision)).sum())

    def _log_marglik(self, prior_precision, sigma_noise):
        return self._log_likelihood(sigma_noise) - 0.5 * (
            self._log_det_ratio(prior_precision, sigma_noise)
            + self._scatter(prior_precision))

    @full_f32()
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
    @full_f32()
    def __call__(self, x):
        """GLM predictive with the probit link (reference
        `baselaplace.py:913`, `:989`, link at `:307`): class probabilities (batch, classes)."""
        f_mu, f_var = self._glm_predictive_distribution(x)
        kappa = 1.0 / torch.sqrt(1.0 + math.pi / 8 * torch.diagonal(f_var, dim1=1, dim2=2))
        return torch.softmax(kappa * f_mu, dim=-1)

    @full_f32()
    def predictive_samples(self, x, pred_type=PredType.GLM, n_samples: int = 100,
                           diagonal_output: bool = False,
                           generator: torch.Generator | None = None) -> torch.Tensor:
        """Class-probability samples (n_samples, batch, classes): GLM
        function samples through the softmax (reference
        `baselaplace.py:969`, `:355-373`). The draws come from `generator`
        (on this Laplace's device), or from torch's default one."""
        if pred_type != PredType.GLM:
            raise ValueError("Only the 'glm' predictive samples are ported.")
        f_mu, f_var = self._glm_predictive_distribution(x, diagonal_output=diagonal_output)
        return torch.softmax(normal_samples(f_mu, f_var, n_samples, generator), dim=-1)

    def _glm_predictive_distribution(self, x, diagonal_output: bool = False):
        """GLM predictive mean f (batch, classes) and variance (batch,
        classes, classes), or its diagonal (reference `baselaplace.py:989`)."""
        Js, f_mu = self.backend._jacobians_dispatch(self._tensor(x))
        with torch.no_grad():
            f_var = self.functional_variance(Js)
        if diagonal_output:
            f_var = torch.diagonal(f_var, dim1=-2, dim2=-1)
        return f_mu, f_var

    def functional_variance(self, Js) -> torch.Tensor:
        raise NotImplementedError

    def sample(self, n_samples: int = 100, generator: torch.Generator | None = None):
        """Parameter samples (n_samples, n_params) from the posterior."""
        raise NotImplementedError

    def _randn(self, *shape, generator=None) -> torch.Tensor:
        return torch.randn(*shape, generator=generator, dtype=self._dtype, device=self.device)

    def _check_fitted(self):
        if self.H is None:
            raise AttributeError("Laplace not fitted. Run fit() first.")

    def _h_factor(self, sigma_noise):
        return 1.0 / (sigma_noise ** 2) / self.temperature


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

    @full_f32()
    def fit(self, train_loader, override: bool = True) -> None:
        """Fit, then eigendecompose the factors; `fit_seconds["decompose"]`
        records the decomposition's wall time."""
        if override:
            self.H_facs = None
        if self.H_facs is not None:
            n_old, n_new = self.n_data, dataset_size(train_loader)
            self.H_facs = self._rescale_factors(self.H_facs, n_old / (n_old + n_new))
        self.H = None  # the base fit leaves this fit's factors in H
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
        return self.H * self._h_factor(sigma_noise) + prior_precision

    @property
    def posterior_precision(self) -> KronDecomposed:
        self._check_fitted()
        return self._posterior_precision(self.prior_precision, self.sigma_noise)

    def _log_det_posterior_precision(self, prior_precision, sigma_noise):
        if self.damping:
            return self._posterior_precision(prior_precision, sigma_noise).logdet()
        # logdet(f H + delta) = sum log(f lam + delta) over the cached flat
        # Kronecker eigenvalues of H
        dflat = broadcast_groups(self.H._check_deltas(prior_precision), self.H.group_sizes)
        return torch.log(self._h_factor(sigma_noise) * self.H._flat_eigs + dflat).sum()

    def functional_variance(self, Js) -> torch.Tensor:
        return self.posterior_precision.inv_square_form(Js)

    @BaseLaplace.prior_precision.setter
    def prior_precision(self, prior_precision):
        BaseLaplace.prior_precision.fset(self, prior_precision)
        if self._prior_precision.shape[0] not in (1, self.n_layers):
            raise ValueError("Prior precision for Kron either scalar or per-layer.")


class FullLaplace(ParametricLaplace):
    """Dense P x P posterior precision (reference `baselaplace.py:1091`).

    `H` is the summed GGN, built per batch by the `syrk` kernel on the card.
    The posterior scale (a Cholesky-based inverse square root) is cached
    until the next fit or prior change.
    """

    _key = ("all", "full")

    def _curv_closure(self, x, y, N):
        return self.backend.full(x, y, N)

    def fit(self, train_loader, override: bool = True) -> None:
        self._posterior_scale = None
        super().fit(train_loader, override=override)

    @property
    def posterior_scale(self) -> torch.Tensor:
        """Lower-triangular `S` with `S S^T` the posterior covariance."""
        if self._posterior_scale is None:
            self._posterior_scale = invsqrt_precision(self.posterior_precision)
        return self._posterior_scale

    @property
    def posterior_covariance(self) -> torch.Tensor:
        scale = self.posterior_scale
        return scale @ scale.mT

    @property
    def posterior_precision(self) -> torch.Tensor:
        self._check_fitted()
        return self._posterior_precision(self.prior_precision, self.sigma_noise)

    def _posterior_precision(self, prior_precision, sigma_noise):
        return (self._h_factor(sigma_noise) * self.H
                + torch.diag(self._prior_precision_diag(prior_precision)))

    def _log_det_posterior_precision(self, prior_precision, sigma_noise):
        return torch.linalg.slogdet(self._posterior_precision(prior_precision, sigma_noise))[1]

    def functional_variance(self, Js) -> torch.Tensor:
        return torch.einsum("ncp,pq,nkq->nck", Js, self.posterior_covariance, Js)

    def sample(self, n_samples: int = 100, generator: torch.Generator | None = None):
        eps = self._randn(n_samples, self.n_params, generator=generator)
        return self.mean[None, :] + eps @ self.posterior_scale.mT


class DiagLaplace(ParametricLaplace):
    """Diagonal posterior precision (reference `baselaplace.py:1370`)."""

    _key = ("all", "diag")

    def _curv_closure(self, x, y, N):
        return self.backend.diag(x, y, N)

    @property
    def posterior_precision(self) -> torch.Tensor:
        self._check_fitted()
        return self._posterior_precision(self.prior_precision, self.sigma_noise)

    def _posterior_precision(self, prior_precision, sigma_noise):
        return self._h_factor(sigma_noise) * self.H + self._prior_precision_diag(prior_precision)

    @property
    def posterior_scale(self) -> torch.Tensor:
        return 1.0 / torch.sqrt(self.posterior_precision)

    @property
    def posterior_variance(self) -> torch.Tensor:
        return 1.0 / self.posterior_precision

    def _log_det_posterior_precision(self, prior_precision, sigma_noise):
        return torch.log(self._posterior_precision(prior_precision, sigma_noise)).sum()

    def functional_variance(self, Js) -> torch.Tensor:
        return torch.einsum("ncp,p,nkp->nck", Js, self.posterior_variance, Js)

    def sample(self, n_samples: int = 100, generator: torch.Generator | None = None):
        eps = self._randn(n_samples, self.n_params, generator=generator)
        return self.mean[None, :] + eps * self.posterior_scale[None, :]
