"""Weight-space Laplace classes: BaseLaplace, ParametricLaplace and the
Kron, Full, Diag and LowRank posteriors (port of `laplace_jax/baselaplace.py`).

- `fit` accumulates per-batch curvature in a Python loop (the JAX
  package's `lax.scan`): KFAC factors, merged across online fits with the
  N-rescaled activation factor and then eigendecomposed (Kron); the dense
  curvature (Full; the GGN through the `syrk` kernel); its diagonal (Diag;
  the GGN's and EF's from the layer taps); or, for LowRank, the whole
  loader's top eigenpairs by matrix-free Lanczos (`curvature/lanczos.py`).
  The curvature is the `backend`:
  the GGN, its MC estimate, the empirical Fisher or the exact Hessian
  (`curvature/backend.py`). Batches are `(X, y)` pairs or dicts
  (`dict_key_y` names the targets; the forward gets the whole dict).
- The likelihood is 'classification', 'regression' (½·SSE loss, noise
  `sigma_noise`) or 'reward_modeling' (fitted as classification, predicted
  as regression unless `fitting=True`).
- `log_marginal_likelihood` is differentiable in the prior precision and
  `sigma_noise`; `optimize_prior_precision` runs `torch.optim.Adam` on the
  log prior precision (the same update as optax's Adam) or a gridsearch
  against a validation metric (`utils/validate.py`).
- The predictive: GLM (per-sample Jacobians, `_jacobians_dispatch`) with
  the probit, bridge, bridge_norm or MC link, `joint` covariances for
  regression; or NN (posterior weight samples through the network).
  Random draws come from the caller's `generator`, else from a
  per-instance generator seeded 0 that advances with every use.
- With `enable_backprop`, the predictive and the fitted mean keep their
  autograd graph.
- `save`/`load` write and read the fitted state (`state_dict`) as one
  pickle-free `.npz` archive in the JAX package's layout
  (`utils/serialization.py`): an archive of either package loads in the
  other. Loading a `KronLaplace` decomposes its factors again.

Everything runs on `device`: CUDA unless the caller passes `device="cpu"`.
Fits, marglik and the predictives run in full float32 (`utils/device.full_f32`);
the caller's TF32 settings are left as they were.
"""

from __future__ import annotations

import functools
import math
import warnings

import numpy as np
import torch

from laplace_jax_torch.curvature.backend import CurvatureBackend
from laplace_jax_torch.enums import Likelihood, LinkApprox, PredType, PriorStructure, TuningMethod
from laplace_jax_torch.nnmodel import NNModel, unpack_batch
from laplace_jax_torch.parallel.sharding import ensure_group, full_tensor, shard_rows
from laplace_jax_torch.utils import spans
from laplace_jax_torch.utils.data import dataset_size
from laplace_jax_torch.utils.device import full_f32, resolve_device, to_device
from laplace_jax_torch.utils.flatten import parameters_to_vector
from laplace_jax_torch.utils.linalg import invsqrt_precision, normal_samples
from laplace_jax_torch.utils.matrix import Kron, KronDecomposed, broadcast_groups
from laplace_jax_torch.utils.prior import fix_prior_prec_structure
from laplace_jax_torch.utils.serialization import load_state_dict, save_state_dict

__all__ = ["BaseLaplace", "ParametricLaplace", "KronLaplace", "FullLaplace", "DiagLaplace",
           "LowRankLaplace"]

# backend name -> (CurvatureBackend curv_type, stochastic)
BACKENDS = {"ggn": ("ggn", False), "mc": ("ggn", True), "ef": ("ef", False),
            "hessian": ("hessian", False)}


def _requires_grad(x) -> bool:
    return torch.is_tensor(x) and x.requires_grad


def _collected(method):
    """`method` (a fit, or a load that decomposes) with the instance's
    per-fit collector open (`utils/spans.collect`): every span inside it
    adds its seconds to `fit_seconds`."""
    @functools.wraps(method)
    def collected(self, *args, **kwargs):
        with spans.collect(self.fit_seconds, self.device):
            return method(self, *args, **kwargs)

    return collected


class BaseLaplace:
    """Base class (reference `baselaplace.py:77`). `model` is an `nn.Module`
    taking the public input layout; it is moved to `device`.

    `backend` is the curvature: 'ggn' (the default), 'mc' (the GGN's MC
    estimate), 'ef' (the empirical Fisher), 'hessian', or a factory
    `f(model, likelihood, **backend_kwargs)` returning a `CurvatureBackend`;
    `backend_kwargs` go to `CurvatureBackend` (`stochastic`, `num_samples`,
    `kron_unsupported`, `kron_block_max_params`, `ef_chunk_size`). The
    backend is built at its first use (`self.backend`).

    `parallel` is an optional `laplace_jax_torch.parallel.DataParallel`:
    each rank fits its rows of every batch and the curvature is summed over
    the ranks, and the GLM predictive spreads its batch over them (every
    rank holds the same data and gets the same results).
    """

    def __init__(self, model, likelihood, sigma_noise=1.0, prior_precision=1.0,
                 prior_mean=0.0, temperature: float = 1.0, enable_backprop: bool = False,
                 dict_key_x: str = "input_ids", dict_key_y: str = "labels", backend=None,
                 backend_kwargs: dict | None = None, device=None, parallel=None):
        if likelihood not in [lik.value for lik in Likelihood]:
            raise ValueError(f"Invalid likelihood type {likelihood}")
        self.device = resolve_device(device)
        self.model = NNModel(model.to(self.device))
        self.likelihood = likelihood
        self.n_params = self.model.n_params
        self.n_layers = self.model.n_layers
        self.prior_precision = prior_precision
        self.prior_mean = prior_mean
        if sigma_noise != 1 and likelihood != Likelihood.REGRESSION:
            raise ValueError("Sigma noise != 1 only available for regression.")
        self.sigma_noise = sigma_noise
        self.temperature = temperature
        self.enable_backprop = enable_backprop
        self.dict_key_x = dict_key_x
        self.dict_key_y = dict_key_y
        self.loss = 0.0
        self.n_outputs = 0
        self.n_data = 0
        self._generator = None
        self._backend = None
        self._backend_arg = backend
        self._backend_kwargs = dict(backend_kwargs or {})
        self.parallel = parallel

    @property
    def backend(self) -> CurvatureBackend:
        """The curvature backend, built at first use from `backend` and
        `backend_kwargs` (the JAX package's `baselaplace.py:157-186`); code
        that changes what it depends on sets `_backend` to None."""
        if self._backend is None:
            arg = "ggn" if self._backend_arg is None else self._backend_arg
            likelihood = self._backend_likelihood
            if isinstance(arg, str):
                if arg not in BACKENDS:
                    raise KeyError(f"Unknown backend {arg!r}; use one of {sorted(BACKENDS)} "
                                   "or a factory.")
                curv_type, stochastic = BACKENDS[arg]
                kw = dict(self._backend_kwargs)
                stochastic = kw.pop("stochastic", stochastic)
                self._backend = CurvatureBackend(self.model, likelihood, curv_type=curv_type,
                                                 stochastic=stochastic, **kw)
            elif callable(arg):
                self._backend = arg(self.model, likelihood, **self._backend_kwargs)
            else:
                raise ValueError(f"Invalid backend {arg}.")
        return self._backend

    @property
    def _backend_likelihood(self):
        """Reward modeling fits as classification."""
        if self.likelihood == Likelihood.REWARD_MODELING:
            return Likelihood.CLASSIFICATION
        return self.likelihood

    @property
    def _dtype(self):
        return self.model.params_in_order()[0].dtype

    def _tensor(self, x):
        """An input on this Laplace's device (`utils/device.to_device`)."""
        return to_device(x, self.device, self._dtype)

    def _float(self, x) -> torch.Tensor:
        """A hyperparameter or parameter vector as a tensor of the
        parameters' dtype on this Laplace's device (keeps its graph)."""
        return torch.as_tensor(x, dtype=self._dtype, device=self.device)

    def _rng(self, generator=None) -> torch.Generator:
        """`generator`, or this instance's own generator (seeded 0 on first
        use, on this Laplace's device), which advances with every draw."""
        if generator is not None:
            return generator
        if self._generator is None:
            self._generator = torch.Generator(device=self.device).manual_seed(0)
        return self._generator

    def _unpack_batch(self, data):
        """(X, y) from a pair or from a dict batch."""
        return unpack_batch(data, self.dict_key_y)

    @staticmethod
    def _check_loader(train_loader) -> None:
        """Reject one-shot iterators: the fit probes one batch and then
        iterates the loader again."""
        try:
            is_one_shot = iter(train_loader) is train_loader
        except TypeError:
            raise ValueError("train_loader must be an iterable of batches.")
        if is_one_shot:
            raise ValueError("train_loader must be re-iterable (not a one-shot iterator); "
                             "pass an ArrayLoader or a list of batches.")

    # ---- persistence
    def save(self, path: str) -> None:
        """Write the fitted state to a pickle-free `.npz` archive (the
        JAX package's `baselaplace.py:651-657`)."""
        save_state_dict(self.state_dict(), path)

    def load(self, path: str) -> "BaseLaplace":
        """Load state saved by `save`, by either package, into this
        compatible instance."""
        self.load_state_dict(load_state_dict(path))
        return self

    def _check_state_type(self, state_dict: dict) -> None:
        if self.__class__.__name__ != state_dict["cls_name"]:
            raise ValueError("Loading a wrong Laplace type. Make sure `subset_of_weights` and"
                             " `hessian_structure` are correct!")

    def _state_value(self, v):
        """A loaded entry on this Laplace's device and in its dtype: arrays
        and tensors as tensors, `Kron` / `KronDecomposed` leaf by leaf;
        anything else (None, a number) as it is."""
        if isinstance(v, (np.ndarray, torch.Tensor)):
            return self._float(v)
        if isinstance(v, Kron):
            return Kron([tuple(self._float(H) for H in F) for F in v.kfacs])
        if isinstance(v, KronDecomposed):
            return KronDecomposed([tuple(self._float(Q) for Q in Qs) for Qs in v.eigenvectors],
                                  [tuple(self._float(lam) for lam in ls) for ls in v.eigenvalues],
                                  self._float(v.deltas), damping=v.damping)
        if isinstance(v, (list, tuple)):  # LowRank's (U, eigenvalues)
            return tuple(self._float(a) for a in v)
        return v

    # ---- priors
    @property
    def prior_precision(self):
        return self._prior_precision

    @prior_precision.setter
    def prior_precision(self, prior_precision):
        self._posterior_scale = None
        pp = torch.atleast_1d(self._float(prior_precision))
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
        pm = torch.atleast_1d(self._float(prior_mean))
        if pm.ndim > 1 or pm.shape[0] not in (1, self.n_params):
            raise ValueError("Invalid length of prior mean.")
        self._prior_mean = pm

    @property
    def sigma_noise(self):
        return self._sigma_noise

    @sigma_noise.setter
    def sigma_noise(self, sigma_noise):
        self._posterior_scale = None
        sn = self._float(sigma_noise)
        if sn.ndim > 1 or sn.numel() != 1:
            raise ValueError("Only homoscedastic output noise supported: sigma_noise "
                             "must be a scalar.")
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

    def _h_factor(self, sigma_noise):
        return 1.0 / (sigma_noise ** 2) / self.temperature

    # ---- likelihood
    @property
    def log_likelihood(self) -> torch.Tensor:
        """The training log likelihood from the fitted loss, differentiable
        in `sigma_noise` (reference `baselaplace.py:261-276`)."""
        return self._log_likelihood(self.sigma_noise)

    def _log_likelihood(self, sigma_noise) -> torch.Tensor:
        factor = -self._h_factor(sigma_noise)
        if self.likelihood == Likelihood.REGRESSION:
            c = self.n_data * self.n_outputs * torch.log(sigma_noise * math.sqrt(2 * math.pi))
            return factor * self.loss - c
        return factor * self.loss

    # ---- prior tuning
    @full_f32()
    def optimize_prior_precision(self, pred_type=PredType.GLM, method=TuningMethod.MARGLIK,
                                 n_steps: int = 100, lr: float = 1e-1, init_prior_prec=1.0,
                                 prior_structure=PriorStructure.SCALAR, val_loader=None,
                                 loss=None, log_prior_prec_min: float = -4,
                                 log_prior_prec_max: float = 4, grid_size: int = 100,
                                 link_approx=LinkApprox.PROBIT, n_samples: int = 100) -> None:
        """Post-hoc prior-precision tuning (reference `baselaplace.py:479-612`):
        `n_steps` Adam steps on the log marglik, or a gridsearch over
        `grid_size` log-spaced values in [10^min, 10^max] for the lowest
        validation `loss` (default `RunningMSEMetric` for regression, else
        `RunningNLLMetric`) of the predictive on `val_loader`."""
        likelihood = (Likelihood.CLASSIFICATION if self.likelihood == Likelihood.REWARD_MODELING
                      else self.likelihood)
        if method == TuningMethod.MARGLIK:
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
        elif method == TuningMethod.GRIDSEARCH:
            if val_loader is None:
                raise ValueError("gridsearch requires a validation set loader")
            from laplace_jax_torch.utils.metrics import RunningMSEMetric, RunningNLLMetric

            if loss is None:
                loss = (RunningMSEMetric() if likelihood == Likelihood.REGRESSION
                        else RunningNLLMetric())
            interval = np.logspace(log_prior_prec_min, log_prior_prec_max, grid_size)
            self.prior_precision = self._gridsearch(loss, interval, val_loader, pred_type,
                                                    link_approx, n_samples)
        else:
            raise ValueError("For now only marglik and gridsearch is implemented.")

    def _gridsearch(self, loss, interval, val_loader, pred_type, link_approx=LinkApprox.PROBIT,
                    n_samples: int = 100):
        """The grid value with the lowest validation loss; a predictive that
        fails to factor its covariance, or a non-finite loss, scores inf
        (reference `baselaplace.py:585-612`)."""
        from laplace_jax_torch.utils.validate import validate

        results = []
        for prior_prec in interval:
            self.prior_precision = float(prior_prec)
            try:
                result = validate(self, val_loader, loss, pred_type=pred_type,
                                  link_approx=link_approx, n_samples=n_samples,
                                  dict_key_y=self.dict_key_y)
                if not np.isfinite(result):
                    result = np.inf
            except (FloatingPointError, torch.linalg.LinAlgError):
                result = np.inf
            results.append(result)
        return float(interval[int(np.argmin(results))])

    def predictive(self, x, pred_type, link_approx, n_samples):
        return self(x, pred_type=pred_type, link_approx=link_approx, n_samples=n_samples)

    @full_f32()
    def log_marginal_likelihood(self, prior_precision=None, sigma_noise=None):
        """Laplace approximation to the log marginal likelihood, differentiable
        in its arguments (reference `baselaplace.py:892`): an argument that
        requires grad is used as it is, any other is also stored."""
        if prior_precision is not None and not _requires_grad(prior_precision):
            self.prior_precision = prior_precision
        if sigma_noise is not None:
            if self.likelihood != Likelihood.REGRESSION:
                raise ValueError("Can only change sigma_noise for regression.")
            if not _requires_grad(sigma_noise):
                self.sigma_noise = sigma_noise
        pp = (self.prior_precision if prior_precision is None
              else torch.atleast_1d(self._float(prior_precision)))
        sn = self.sigma_noise if sigma_noise is None else self._float(sigma_noise).reshape(())
        return self._log_marglik(pp, sn)

    def _log_marglik(self, prior_precision, sigma_noise):
        raise NotImplementedError

    @spans.span("predict.link")
    def _glm_link_output(self, f_mu, f_var, likelihood, joint, link_approx, n_samples,
                         diagonal_output, generator):
        """The link applied to the GLM predictive (reference
        `baselaplace.py:307-352`)."""
        if likelihood == Likelihood.REGRESSION:
            if diagonal_output and not joint and f_var.ndim == 3:
                f_var = torch.diagonal(f_var, dim1=-2, dim2=-1)
            return f_mu, f_var
        if link_approx == LinkApprox.MC:
            return self._glm_predictive_samples(f_mu, f_var, n_samples, diagonal_output,
                                                generator).mean(0)
        if link_approx == LinkApprox.PROBIT:
            kappa = 1.0 / torch.sqrt(1.0 + math.pi / 8 * torch.diagonal(f_var, dim1=1, dim2=2))
            return torch.softmax(kappa * f_mu, dim=-1)
        if "bridge" in link_approx:
            # zero-mean correction, then the Laplace bridge
            total = f_var.sum(dim=(1, 2))
            f_mu = f_mu - f_var.sum(-1) * f_mu.sum(-1)[:, None] / total[:, None]
            f_var = f_var - (torch.einsum("bi,bj->bij", f_var.sum(-1), f_var.sum(-2))
                             / total[:, None, None])
            K = f_mu.shape[-1]
            f_var_diag = torch.diagonal(f_var, dim1=1, dim2=2)
            if link_approx == LinkApprox.BRIDGE_NORM:
                f_var_diag_mean = f_var_diag.mean(1) / math.sqrt(K / 2.0)
                f_mu = f_mu / torch.sqrt(f_var_diag_mean)[:, None]
                f_var_diag = f_var_diag / f_var_diag_mean[:, None]
            sum_exp = torch.exp(-f_mu).sum(1)[:, None]
            alpha = (1.0 - 2.0 / K + torch.exp(f_mu) / K ** 2 * sum_exp) / f_var_diag
            return torch.nan_to_num(alpha / alpha.sum(1)[:, None], nan=1.0)
        raise ValueError("Prediction path invalid. Check the likelihood, pred_type, "
                         "link_approx combination!")

    def _glm_functional_samples(self, f_mu, f_var, n_samples, diagonal_output=False,
                                generator=None):
        """Gaussian function samples (n_samples, batch, outputs) from the GLM
        predictive."""
        if f_var.ndim == 3 and diagonal_output:
            f_var = torch.diagonal(f_var, dim1=1, dim2=2)
        return normal_samples(f_mu, f_var, n_samples, self._rng(generator))

    def _glm_predictive_samples(self, f_mu, f_var, n_samples, diagonal_output=False,
                                generator=None):
        """The function samples through the inverse link (the softmax unless
        the likelihood is regression)."""
        fs = self._glm_functional_samples(f_mu, f_var, n_samples, diagonal_output, generator)
        if self.likelihood == Likelihood.REGRESSION:
            return fs
        return torch.softmax(fs, dim=-1)

    def _over_ranks(self, x, fn):
        """`fn(x)`, spread over the ranks by `parallel.shard_batch` when there
        is one (the JAX package's `baselaplace.py:992-993`); with
        `enable_backprop` the whole batch runs on every rank, which keeps the
        graph."""
        if self.parallel is None or self.enable_backprop:
            return fn(x)
        return self.parallel.shard_batch(x, fn)

    def _glm_predictive_distribution(self, x, joint: bool = False,
                                     diagonal_output: bool = False):
        """GLM predictive mean f (batch, outputs) and variance (batch,
        outputs, outputs) or its diagonal; with `joint`, f flattened and
        the (batch·outputs)² covariance (reference `baselaplace.py:989`).
        Under `parallel` each rank takes the Jacobians of its rows; the
        variance is taken on the rows too, the joint covariance, which
        couples the rows, from the gathered Jacobians."""
        def jacobians(xs):
            return self.backend._jacobians_dispatch(xs, create_graph=self.enable_backprop)

        def mean_variance(xs):
            Js, f_mu = jacobians(xs)
            return f_mu, self.functional_variance(Js)

        x = self._tensor(x)
        if joint:
            Js, f_mu = self._over_ranks(x, jacobians)
            f_mu = f_mu.reshape(-1)
            f_var = self.functional_covariance(Js)
        else:
            f_mu, f_var = self._over_ranks(x, mean_variance)
            if diagonal_output:
                f_var = torch.diagonal(f_var, dim1=-2, dim2=-1)
        if not self.enable_backprop:
            f_mu, f_var = f_mu.detach(), f_var.detach()
        return f_mu, f_var


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

    @_collected
    @full_f32()
    def fit(self, train_loader, override: bool = True,
            generator: torch.Generator | None = None) -> None:
        """Accumulate batch curvature over the loader (reference
        `baselaplace.py:709`, `_scan_accumulate` at `:814`); `n_outputs` comes
        from a forward of the first batch's first input. An MC backend
        draws from `generator`, else from this instance's generator. Under
        `parallel` each batch goes through `parallel.wrap` (each rank's
        rows, summed over the ranks).
        `fit_seconds["accumulate"]` records the loop's wall time, and the
        spans inside it their seconds (`utils/spans.py`)."""
        self._check_loader(train_loader)
        if override:
            self.loss = 0.0
            self.n_data = 0
        self.mean = parameters_to_vector(self.model.module, self.model.leaf_specs,
                                         detach=not self.enable_backprop)
        X, y = self._unpack_batch(next(iter(train_loader)))
        out = self.model.output_probe(self._tensor(X))
        self.n_outputs = out.shape[-1]
        y_ndim = y.ndim if hasattr(y, "ndim") else np.ndim(y)
        if self.likelihood == Likelihood.REGRESSION and y_ndim != out.ndim:
            raise ValueError(f"The model's output has {out.ndim} dims but the target has "
                             f"{y_ndim} dims.")
        N = dataset_size(train_loader)
        closure = (self._curv_closure if self.parallel is None
                   else self.parallel.wrap(self._curv_closure))
        self._sync()
        with spans.span("accumulate", host_clock=True):
            H = None
            generator = self._rng(generator)
            for data in train_loader:
                X, y = self._unpack_batch(data)
                loss_b, H_b = closure(self._tensor(X), self._tensor(y), N, generator)
                self.loss = self.loss + loss_b
                H = H_b if H is None else H + H_b
            if H is None:
                raise RuntimeError("train_loader yielded no batches.")
            self._sync()
        self.H = H if override or self.H is None else self.H + H
        self.n_data += N

    def _curv_closure(self, x, y, N, generator=None):
        raise NotImplementedError

    # ---- marglik
    @property
    def scatter(self) -> torch.Tensor:
        """(θ_MAP − μ₀)ᵀ P₀ (θ_MAP − μ₀)."""
        return self._scatter(self.prior_precision)

    def _scatter(self, prior_precision) -> torch.Tensor:
        delta = self.mean - self.prior_mean
        return (delta * self._prior_precision_diag(prior_precision)) @ delta

    @property
    def log_det_prior_precision(self) -> torch.Tensor:
        return torch.log(self.prior_precision_diag).sum()

    @property
    def log_det_posterior_precision(self) -> torch.Tensor:
        return self._log_det_posterior_precision(self.prior_precision, self.sigma_noise)

    def _log_det_posterior_precision(self, prior_precision, sigma_noise):
        raise NotImplementedError

    @property
    def log_det_ratio(self) -> torch.Tensor:
        """log det P − log det P₀."""
        return self._log_det_ratio(self.prior_precision, self.sigma_noise)

    def _log_det_ratio(self, prior_precision, sigma_noise):
        if self.H is None:  # not fitted: the posterior is the prior
            return torch.zeros((), dtype=self._dtype, device=self.device)
        return (self._log_det_posterior_precision(prior_precision, sigma_noise)
                - torch.log(self._prior_precision_diag(prior_precision)).sum())

    def _log_marglik(self, prior_precision, sigma_noise):
        return self._log_likelihood(sigma_noise) - 0.5 * (
            self._log_det_ratio(prior_precision, sigma_noise)
            + self._scatter(prior_precision))

    def square_norm(self, value) -> torch.Tensor:
        raise NotImplementedError

    @full_f32()
    def log_prob(self, value, normalized: bool = True) -> torch.Tensor:
        """Log density of `value` (n_params,) under the Gaussian posterior
        (reference `baselaplace.py:881-890`)."""
        value = self._float(value)
        if not normalized:
            return -self.square_norm(value) / 2
        log_prob = (-self.n_params / 2 * math.log(2 * math.pi)
                    + self.log_det_posterior_precision / 2)
        return log_prob - self.square_norm(value) / 2

    # ---- predictive
    @full_f32()
    def __call__(self, x, pred_type=PredType.GLM, joint: bool = False,
                 link_approx=LinkApprox.PROBIT, n_samples: int = 100,
                 diagonal_output: bool = False, generator: torch.Generator | None = None,
                 fitting: bool = False):
        """The posterior predictive (reference `baselaplace.py:913-947`):
        class probabilities (batch, classes), or for regression `(f_mu,
        f_var)` with f_var (batch, outputs, outputs), its diagonal with
        `diagonal_output`, or with `joint` the (batch·outputs,)² covariance.
        Reward modeling predicts as regression unless `fitting`."""
        if pred_type not in [p for p in PredType]:
            raise ValueError("Only glm and nn supported as prediction types.")
        if link_approx not in [la for la in LinkApprox]:
            raise ValueError(f"Unsupported link approximation {link_approx}.")
        if pred_type == PredType.NN and link_approx != LinkApprox.MC:
            raise ValueError("Only mc link approximation is supported for nn prediction type.")
        likelihood = self.likelihood
        if likelihood == Likelihood.REWARD_MODELING:
            likelihood = Likelihood.CLASSIFICATION if fitting else Likelihood.REGRESSION
        generator = self._rng(generator)
        with spans.span("predict.call", device=self.device):
            if pred_type == PredType.GLM:
                f_mu, f_var = self._glm_predictive_distribution(
                    x, joint=joint and likelihood == Likelihood.REGRESSION)
                return self._glm_link_output(f_mu, f_var, likelihood, joint, link_approx,
                                             n_samples, diagonal_output, generator)
            samples = self._nn_predictive_samples(x, n_samples, generator)
            if likelihood == Likelihood.REGRESSION:
                return samples.mean(0), samples.var(0, unbiased=False)
            return samples.mean(0)

    @full_f32()
    def functional_samples(self, x, pred_type=PredType.GLM, n_samples: int = 100,
                           diagonal_output: bool = False,
                           generator: torch.Generator | None = None) -> torch.Tensor:
        """Function-space samples (n_samples, batch, outputs) (reference
        `baselaplace.py:949-967`)."""
        if pred_type not in [p for p in PredType]:
            raise ValueError("Only glm and nn supported as prediction types.")
        generator = self._rng(generator)
        if pred_type == PredType.GLM:
            f_mu, f_var = self._glm_predictive_distribution(x)
            return self._glm_functional_samples(f_mu, f_var, n_samples, diagonal_output,
                                                generator)
        return self._nn_functional_samples(x, n_samples, generator)

    @full_f32()
    def predictive_samples(self, x, pred_type=PredType.GLM, n_samples: int = 100,
                           diagonal_output: bool = False,
                           generator: torch.Generator | None = None) -> torch.Tensor:
        """Samples (n_samples, batch, outputs) through the inverse link: GLM
        function samples, or the network under posterior weight samples
        (reference `baselaplace.py:969-987`)."""
        if pred_type not in [p for p in PredType]:
            raise ValueError("Only glm and nn supported as prediction types.")
        generator = self._rng(generator)
        if pred_type == PredType.GLM:
            f_mu, f_var = self._glm_predictive_distribution(x)
            return self._glm_predictive_samples(f_mu, f_var, n_samples, diagonal_output,
                                                generator)
        return self._nn_predictive_samples(x, n_samples, generator)

    def _nn_functional_samples(self, x, n_samples: int = 100, generator=None):
        """The network's outputs (n_samples, batch, outputs) under posterior
        weight samples (reference `baselaplace.py:1006-1020`)."""
        samples = self.sample(n_samples, generator=generator)
        x = self._tensor(x)
        with torch.set_grad_enabled(self.enable_backprop):
            fs = torch.stack([self.model.apply_vec(theta, x) for theta in samples])
        return fs if self.enable_backprop else fs.detach()

    def _nn_predictive_samples(self, x, n_samples: int = 100, generator=None):
        fs = self._nn_functional_samples(x, n_samples, generator)
        if self.likelihood == Likelihood.CLASSIFICATION:
            fs = torch.softmax(fs, dim=-1)
        return fs

    def functional_variance(self, Js) -> torch.Tensor:
        raise NotImplementedError

    def functional_covariance(self, Js) -> torch.Tensor:
        raise NotImplementedError

    def sample(self, n_samples: int = 100, generator: torch.Generator | None = None):
        """Parameter samples (n_samples, n_params) from the posterior."""
        eps = torch.randn(n_samples, self.n_params, generator=self._rng(generator),
                          dtype=self._dtype, device=self.device)
        return self._samples_from(eps)

    def _samples_from(self, eps: torch.Tensor) -> torch.Tensor:
        """Posterior samples from standard-normal draws `eps` (n, n_params)."""
        raise NotImplementedError

    def _check_fitted(self):
        if self.H is None:
            raise AttributeError("Laplace not fitted. Run fit() first.")

    # ---- serialization
    def state_dict(self) -> dict:
        """The fitted state under the JAX package's keys
        (`baselaplace.py:1043-1057`)."""
        if self.H is None:
            raise AttributeError("Laplace not fitted. Run fit() first.")
        return {
            "mean": self.mean,
            "H": self.H,
            "loss": self.loss,
            "prior_mean": self.prior_mean,
            "prior_precision": self.prior_precision,
            "sigma_noise": self.sigma_noise,
            "n_data": int(self.n_data),
            "n_outputs": int(self.n_outputs),
            "likelihood": str(self.likelihood),
            "temperature": self.temperature,
            "enable_backprop": self.enable_backprop,
            "cls_name": self.__class__.__name__,
        }

    def load_state_dict(self, state_dict: dict) -> None:
        """Load a `state_dict`, checked as the JAX package checks it
        (`baselaplace.py:1059-1088`); arrays move to this device and dtype."""
        self._check_state_type(state_dict)
        if self.n_params is not None and len(state_dict["mean"]) != self.n_params:
            raise ValueError("Attempting to load Laplace with different number of parameters "
                             "than the model.")
        if self.likelihood != state_dict["likelihood"]:
            raise ValueError("Different likelihoods detected!")
        if self.temperature != state_dict["temperature"]:
            warnings.warn("Different `temperature` parameters detected.")
        if self.enable_backprop != state_dict["enable_backprop"]:
            warnings.warn("Different `enable_backprop` values.")
        self.mean = self._state_value(state_dict["mean"])
        self.H = self._state_value(state_dict["H"])
        self.loss = self._state_value(state_dict["loss"])
        self.prior_mean = state_dict["prior_mean"]
        self.prior_precision = state_dict["prior_precision"]
        self.sigma_noise = state_dict["sigma_noise"]
        self.n_data = int(state_dict["n_data"])
        self.n_outputs = int(state_dict["n_outputs"])
        self.likelihood = state_dict["likelihood"]
        self.temperature = state_dict["temperature"]
        self.enable_backprop = state_dict["enable_backprop"]


class KronLaplace(ParametricLaplace):
    """KFAC posterior precision (reference `baselaplace.py:1200`).

    `H_facs` keeps the undecomposed factors for online fits; `H` holds the
    eigendecomposed `KronDecomposed` after `fit`. Prior precision is scalar
    or per-layer.
    """

    _key = ("all", "kron")

    def __init__(self, model, likelihood, sigma_noise=1.0, prior_precision=1.0,
                 prior_mean=0.0, temperature: float = 1.0, enable_backprop: bool = False,
                 dict_key_x: str = "input_ids", dict_key_y: str = "labels",
                 damping: bool = False, backend=None, backend_kwargs: dict | None = None,
                 device=None, parallel=None):
        self.damping = damping
        self.H_facs = None
        super().__init__(model, likelihood, sigma_noise, prior_precision, prior_mean,
                         temperature, enable_backprop, dict_key_x, dict_key_y, backend,
                         backend_kwargs, device=device, parallel=parallel)

    def _curv_closure(self, x, y, N, generator=None):
        return self.backend.kron(x, y, N, generator)

    @staticmethod
    def _rescale_factors(kron: Kron, factor) -> Kron:
        """Rescale the 1/N-carrying activation factor A = F[0]."""
        return Kron([(F[0] * factor, F[1]) if len(F) == 2 else F for F in kron.kfacs])

    @_collected
    @spans.span("fit")
    @full_f32()
    def fit(self, train_loader, override: bool = True,
            generator: torch.Generator | None = None) -> None:
        """Fit, then eigendecompose the factors, under `parallel` with its
        mesh as `devices` (each rank decomposes every factor on its own
        device) and then the first rank's eigenpairs broadcast, so every
        rank holds the same posterior even where a solver's bits do not
        repeat; `fit_seconds["decompose"]` records the decomposition's wall
        time, broadcast included."""
        if override:
            self.H_facs = None
        if self.H_facs is not None:
            n_old, n_new = self.n_data, dataset_size(train_loader)
            self.H_facs = self._rescale_factors(self.H_facs, n_old / (n_old + n_new))
        self.H = None  # the base fit leaves this fit's factors in H
        super().fit(train_loader, override=override, generator=generator)
        if self.H_facs is None:
            self.H_facs = self.H
        else:
            self.H_facs = self.H_facs + self._rescale_factors(self.H, n_new / (n_new + n_old))
        with spans.span("decompose", host_clock=True):
            devices = None if self.parallel is None else self.parallel.mesh
            H = self.H_facs.decompose(damping=self.damping, devices=devices)
            if self.parallel is not None:
                vecs, vals = self.parallel.broadcast((H.eigenvectors, H.eigenvalues))
                H = KronDecomposed(vecs, vals, damping=self.damping)
            self.H = H
            self._sync()

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

    def square_norm(self, value) -> torch.Tensor:
        """(θ − mean)ᵀ P (θ − mean); before the decomposition P is the prior
        alone, as in the JAX package (`baselaplace.py:1310-1314`)."""
        delta = value - self.mean
        if not isinstance(self.H, KronDecomposed):
            return (delta * self.prior_precision_diag) @ delta
        return delta @ self.posterior_precision.bmm(delta, exponent=1)

    def functional_variance(self, Js) -> torch.Tensor:
        return self.posterior_precision.inv_square_form(Js)

    def functional_covariance(self, Js) -> torch.Tensor:
        B, C, P = Js.shape
        return self.posterior_precision.inv_square_form(Js.reshape(1, B * C, P))[0]

    def _samples_from(self, eps):
        n = eps.shape[0]
        return self.mean[None, :] + self.posterior_precision.bmm(eps, exponent=-0.5).reshape(
            n, self.n_params)

    @BaseLaplace.prior_precision.setter
    def prior_precision(self, prior_precision):
        BaseLaplace.prior_precision.fset(self, prior_precision)
        if self._prior_precision.shape[0] not in (1, self.n_layers):
            raise ValueError("Prior precision for Kron either scalar or per-layer.")

    def state_dict(self) -> dict:
        """The state with the undecomposed factors `H_facs` as `H`."""
        if self.H_facs is None:
            raise AttributeError("Laplace not fitted. Run fit() first.")
        return dict(super().state_dict(), H=self.H_facs)

    @_collected
    @full_f32()
    def load_state_dict(self, state_dict: dict) -> None:
        """Load the factors and decompose them again, as `fit` does (the
        JAX package's `baselaplace.py:1364-1367`); `fit_seconds["decompose"]`
        records the decomposition's wall time."""
        super().load_state_dict(state_dict)
        self.H_facs = self.H
        with spans.span("decompose", host_clock=True):
            self.H = self.H_facs.decompose(damping=self.damping)
            self._sync()


class FullLaplace(ParametricLaplace):
    """Dense P x P posterior precision (reference `baselaplace.py:1091`).

    `H` is the summed GGN, built per batch by the `syrk` kernel on the card.
    The posterior scale (a Cholesky-based inverse square root) is cached
    until the next fit, prior or noise change. After `shard_posterior`, H
    is a DTensor laid out by rows, and the posterior precision gathers it
    (`parallel.sharding.full_tensor`, a collective every rank joins) at
    every use: the layout saves no peak memory or compute.
    """

    _key = ("all", "full")

    def _curv_closure(self, x, y, N, generator=None):
        return self.backend.full(x, y, N, generator)

    def fit(self, train_loader, override: bool = True,
            generator: torch.Generator | None = None) -> None:
        self._posterior_scale = None
        if self.H is not None:
            self.H = full_tensor(self.H)
        super().fit(train_loader, override=override, generator=generator)

    def shard_posterior(self, mesh=None, axis_name: str = "model") -> "FullLaplace":
        """Lay H out by rows over `mesh`'s `axis_name` as a DTensor
        (`Shard(0)`, replicated over any other dim; the JAX package's
        `baselaplace.py:1164-1197`), each rank keeping its rows. With no
        mesh, a 1-D mesh over the first k ranks, k the largest group size
        that divides P (a warning when k is below the world size; a rank
        outside it keeps H whole). A mesh whose axis does not divide P
        raises. Every rank calls it, and every later use of the posterior
        precision, which gathers H; results equal the replicated
        posterior's."""
        from torch.distributed.device_mesh import DeviceMesh

        self._check_fitted()
        H = full_tensor(self.H)
        P = H.shape[0]
        if mesh is None:
            world = ensure_group()
            k = max(d for d in range(1, world + 1) if P % d == 0)
            if k < world:
                warnings.warn(f"n_params={P} not divisible by {world} ranks; sharding the "
                              f"posterior over {k} rank(s).")
            mesh = DeviceMesh(H.device.type, list(range(k)), mesh_dim_names=(axis_name,))
        elif P % mesh.size(mesh.mesh_dim_names.index(axis_name)) != 0:
            raise ValueError(f"n_params={P} must be divisible by the mesh '{axis_name}' axis "
                             f"size {mesh.size(mesh.mesh_dim_names.index(axis_name))}.")
        self.H = shard_rows(H, mesh, axis_name)
        self._posterior_scale = None
        return self

    def state_dict(self) -> dict:
        return dict(super().state_dict(), H=full_tensor(self.H))

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
        return (self._h_factor(sigma_noise) * full_tensor(self.H)
                + torch.diag(self._prior_precision_diag(prior_precision)))

    def _log_det_posterior_precision(self, prior_precision, sigma_noise):
        return torch.linalg.slogdet(self._posterior_precision(prior_precision, sigma_noise))[1]

    def square_norm(self, value) -> torch.Tensor:
        delta = value - self.mean
        return delta @ self.posterior_precision @ delta

    def functional_variance(self, Js) -> torch.Tensor:
        return torch.einsum("ncp,pq,nkq->nck", Js, self.posterior_covariance, Js)

    def functional_covariance(self, Js) -> torch.Tensor:
        Jf = Js.reshape(-1, Js.shape[-1])
        return torch.einsum("np,pq,mq->nm", Jf, self.posterior_covariance, Jf)

    def _samples_from(self, eps):
        return self.mean[None, :] + eps @ self.posterior_scale.mT


class DiagLaplace(ParametricLaplace):
    """Diagonal posterior precision (reference `baselaplace.py:1370`)."""

    _key = ("all", "diag")

    def _curv_closure(self, x, y, N, generator=None):
        return self.backend.diag(x, y, N, generator)

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

    def square_norm(self, value) -> torch.Tensor:
        delta = value - self.mean
        return delta @ (delta * self.posterior_precision)

    def functional_variance(self, Js) -> torch.Tensor:
        return torch.einsum("ncp,p,nkp->nck", Js, self.posterior_variance, Js)

    def functional_covariance(self, Js) -> torch.Tensor:
        Jf = Js.reshape(-1, Js.shape[-1])
        return torch.einsum("np,p,mp->nm", Jf, self.posterior_variance, Jf)

    def _samples_from(self, eps):
        return self.mean[None, :] + eps * self.posterior_scale[None, :]


class LowRankLaplace(ParametricLaplace):
    """Low-rank posterior precision `P = U diag(λ) Uᵀ + P₀` from the top
    `low_rank` eigenpairs of the whole loader's curvature by matrix-free
    Lanczos (reference `baselaplace.py:1882-2045`, the JAX package's
    `baselaplace.py:1437-1548`), with Woodbury inference at k x k cost.
    The default backend is the exact Hessian; `H` is `(U, eigenvalues)`.
    """

    _key = ("all", "lowrank")

    def __init__(self, model, likelihood, backend="hessian", sigma_noise=1.0,
                 prior_precision=1.0, prior_mean=0.0, temperature: float = 1.0,
                 enable_backprop: bool = False, dict_key_x: str = "input_ids",
                 dict_key_y: str = "labels", backend_kwargs: dict | None = None,
                 low_rank: int = 10, device=None, parallel=None):
        self.low_rank = low_rank
        super().__init__(model, likelihood, sigma_noise, prior_precision, prior_mean,
                         temperature, enable_backprop, dict_key_x, dict_key_y, backend,
                         backend_kwargs, device=device, parallel=parallel)

    @property
    def V(self) -> torch.Tensor:
        """U scaled by the prior covariance, P₀⁻¹ U."""
        (U, _), prior_prec_diag = self.posterior_precision
        return U / prior_prec_diag[:, None]

    @property
    def Kinv(self) -> torch.Tensor:
        """(diag(1/λ) + Uᵀ P₀⁻¹ U)⁻¹."""
        (U, eigvals), _ = self.posterior_precision
        return torch.linalg.inv(torch.diag(1.0 / eigvals) + U.T @ self.V)

    @_collected
    @full_f32()
    def fit(self, train_loader, override: bool = True,
            generator: torch.Generator | None = None) -> None:
        """The whole loader's eigendecomposition, not batch-additive
        (reference `baselaplace.py:1950-1987`); `n_outputs` and the
        regression target check come from a forward of the first batch's
        first input. The Lanczos start vector is drawn from `generator`
        (a fresh one seeded 0 when None); under `parallel` each matvec sums
        each rank's rows over the ranks. `fit_seconds["lanczos"]` records
        the run's wall time."""
        if not override:
            raise ValueError("LowRank LA does not support updating.")
        self._check_loader(train_loader)
        self.mean = parameters_to_vector(self.model.module, self.model.leaf_specs,
                                         detach=not self.enable_backprop)
        X, y = self._unpack_batch(next(iter(train_loader)))
        out = self.model.output_probe(self._tensor(X))
        y_ndim = y.ndim if hasattr(y, "ndim") else np.ndim(y)
        if self.likelihood == Likelihood.REGRESSION and y_ndim != out.ndim:
            raise ValueError(f"The model's output has {out.ndim} dims but the target has "
                             f"{y_ndim} dims.")
        self.n_outputs = out.shape[-1]
        self._sync()
        with spans.span("lanczos", host_clock=True):
            U, eigvals, loss = self.backend.eig_lowrank(train_loader, self.low_rank, generator,
                                                        unpack=self._unpack_batch,
                                                        parallel=self.parallel)
            self._sync()
        self.H = (U, eigvals)
        self.loss = loss
        self.n_data = dataset_size(train_loader)

    @property
    def posterior_precision(self):
        """((U, λ scaled by 1/σ²/T), the prior precision diagonal)."""
        self._check_fitted()
        U, eigvals = self.H
        return (U, self._h_factor(self.sigma_noise) * eigvals), self.prior_precision_diag

    def functional_variance(self, Js) -> torch.Tensor:
        prior_var = torch.einsum("ncp,nkp->nck", Js / self.prior_precision_diag, Js)
        Js_V = torch.einsum("ncp,pl->ncl", Js, self.V)
        info_gain = torch.einsum("ncl,nkl->nck", Js_V @ self.Kinv, Js_V)
        return prior_var - info_gain

    def functional_covariance(self, Js) -> torch.Tensor:
        Jf = Js.reshape(-1, Js.shape[-1])
        prior_cov = torch.einsum("np,mp->nm", Jf / self.prior_precision_diag, Jf)
        Js_V = Jf @ self.V
        return prior_cov - (Js_V @ self.Kinv) @ Js_V.T

    def _samples_from(self, eps):
        """Low-rank plus diagonal Gaussian samples by the double-Cholesky
        trick (reference `baselaplace.py:2022-2038`), from `eps` (n, P)."""
        d = self.prior_precision_diag
        Vs = self.V * torch.sqrt(d)[:, None]
        VtV = Vs.T @ Vs
        Ik = torch.eye(VtV.shape[0], dtype=VtV.dtype, device=VtV.device)
        A = torch.linalg.cholesky(VtV)
        B = torch.linalg.cholesky(VtV + Ik)
        A_inv = torch.linalg.inv(A)
        C = torch.linalg.inv(A_inv.T @ (B - Ik) @ A_inv)
        Kern_inv = torch.linalg.inv(torch.linalg.inv(C) + VtV)
        dinv_sqrt = torch.sqrt(d)[:, None]
        eps = eps.T
        gain = (Vs / dinv_sqrt) @ Kern_inv @ (Vs.T @ eps)
        return self.mean + (eps / dinv_sqrt - gain).T

    def _log_det_posterior_precision(self, prior_precision, sigma_noise):
        """log det(U diag(λ) Uᵀ + P₀) by the determinant lemma, differentiable
        in both arguments."""
        U, eigvals = self.H
        lam = self._h_factor(sigma_noise) * eigvals
        d = self._prior_precision_diag(prior_precision)
        Kinv = torch.linalg.inv(torch.diag(1.0 / lam) + U.T @ (U / d[:, None]))
        return torch.log(lam).sum() + torch.log(d).sum() - torch.linalg.slogdet(Kinv)[1]
