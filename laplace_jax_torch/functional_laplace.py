"""FunctionalLaplace: GP inference through the GLM <-> GP duality (port of
`laplace_jax/functional_laplace.py`).

The GGN-linearized network is a GP with the NTK kernel `K = J Jᵀ` on a
subset of the data (SoD) of size M; the predictive is
`k** − K*M (K_MM + Λ⁻¹)⁻¹ K_M*`, and the marginal likelihood follows R&W
(2006) eq. 3.44 with the likelihood Hessian's diagonal.

By default the SoD Jacobians are computed once a batch and cached as one
(M, C, P) tensor, so K_MM and every predictive are one contraction. When
that cache would exceed `_STREAMING_THRESHOLD_BYTES` (or with
`streaming=True`) the fit builds K_MM from pairs of SoD batches with
transient Jacobians, and the predictive recomputes them a batch at a time.
K_MM, the Cholesky factors and the triangular solves are library calls:
the JAX package runs no Pallas kernel on this path either.

The state (`state_dict`, `save`/`load`) holds K_MM, Σ's Cholesky, the
cached Jacobians and a streamed fit's SoD inputs under the JAX package's
keys, so a loaded GP predicts without refitting.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from laplace_jax_torch.baselaplace import BaseLaplace
from laplace_jax_torch.enums import (
    FeatureReduction,
    Likelihood,
    LinkApprox,
    PredType,
    PriorStructure,
    TuningMethod,
)
from laplace_jax_torch.nnmodel import NNModel, batch_slice, flax_module_name
from laplace_jax_torch.utils.data import ArrayLoader, dataset_size
from laplace_jax_torch.utils.device import full_f32
from laplace_jax_torch.utils.sod import sod_indices

__all__ = ["FunctionalLaplace", "FunctionalLLLaplace"]

# auto-streaming when the (M, C, P) SoD Jacobian cache would exceed this
# many bytes (1 GiB), as in the JAX package
_STREAMING_THRESHOLD_BYTES = 1 << 30


def _solve_lower(L, B):
    return torch.linalg.solve_triangular(L, B, upper=False)


class FunctionalLaplace(BaseLaplace):
    """GP equivalent of a GGN Laplace approximation (reference
    `baselaplace.py:2138`).

    Beyond `BaseLaplace`: `n_subset` (the SoD size M), `independent_outputs`
    (C kernels of M×M in place of one of MC×MC), `seed` (the SoD draw) and
    `streaming` (None: stream when the Jacobian cache would pass 1 GiB).
    The GP takes the backend's Jacobians, loss and factor; `backend`
    defaults to 'ggn', as in the JAX package.
    """

    _key = ("all", "gp")

    def __init__(self, model, likelihood, n_subset: int, sigma_noise=1.0,
                 prior_precision=1.0, prior_mean=0.0, temperature: float = 1.0,
                 enable_backprop: bool = False, dict_key_x: str = "input_ids",
                 dict_key_y: str = "labels", independent_outputs: bool = False,
                 seed: int = 0, streaming: bool | None = None, backend="ggn",
                 backend_kwargs: dict | None = None, device=None, parallel=None):
        self._check_prior_precision(prior_precision)
        super().__init__(model, likelihood, sigma_noise, prior_precision, prior_mean,
                         temperature, enable_backprop, dict_key_x, dict_key_y, backend,
                         backend_kwargs, device=device, parallel=parallel)
        self.n_subset = n_subset
        self.independent_outputs = independent_outputs
        self.seed = seed
        self.streaming = streaming
        self.K_MM = None
        self.Sigma_chol = None  # Cholesky of gp_var K_MM + Λ⁻¹
        self.L = None  # the likelihood Hessian's diagonal at the SoD points (M, C)
        self.mu = None  # the mean term of the marglik scatter
        self.Js_M = None  # cached SoD Jacobians (M, C, P)
        self._sod_x = None  # SoD input batches, for the streamed cross-kernel
        self._prior_factor_sod = None
        self.mean = self.model.mean_vector
        self._fitted = False
        self._recompute_Sigma = True

    @staticmethod
    def _check_prior_precision(prior_precision):
        """Only isotropic priors fit the GP view (reference `:2263-2274`)."""
        pp = np.atleast_1d(np.asarray(prior_precision))
        if pp.ndim > 1 or pp.shape[0] != 1:
            raise ValueError("Only isotropic priors supported in FunctionalLaplace")

    # ---- fitting
    def _jacobians(self, x):
        """The Jacobians and outputs of a batch; under `parallel` each rank
        takes its rows and the results are gathered (the JAX package's
        `functional_laplace.py:95-104`)."""
        Js, f = self._over_ranks(x, self.backend._jacobians_dispatch)
        return Js.detach(), f.detach()

    @full_f32()
    def fit(self, train_loader) -> None:
        """K_MM, Λ and the Cholesky of (K_MM + Λ⁻¹) on an SoD subset
        (reference `baselaplace.py:2420-2534`)."""
        self._check_loader(train_loader)
        X_probe, _ = self._unpack_batch(next(iter(train_loader)))
        out = self.model.output_probe(self._tensor(X_probe))
        self.n_outputs = out.shape[-1]
        if (self.likelihood == Likelihood.REGRESSION and self.n_outputs > 1
                and self.independent_outputs):
            warnings.warn("Using FunctionalLaplace with the diagonal approximation of a GP "
                          "kernel is not recommended in the case of multivariate regression.")
        N = dataset_size(train_loader)
        self.n_data = N
        if self.n_subset > N:
            raise AssertionError("`n_subset` must be less than or equal to the original "
                                 "number of data points.")
        sod_loader = self._subset_loader(train_loader, sod_indices(N, self.n_subset, self.seed))
        self._prior_factor_sod = self.n_subset / self.n_data
        self.mean = self.model.mean_vector

        use_streaming = self.streaming
        if use_streaming is None:
            itemsize = torch.empty(0, dtype=self._dtype).element_size()
            use_streaming = (self.n_subset * self.n_outputs * self.n_params * itemsize
                             > _STREAMING_THRESHOLD_BYTES)

        self.loss = 0.0
        Js_list, lambdas, mus, xs = [], [], [], []
        for data in sod_loader:
            X, y = self._unpack_batch(data)
            Xd, yd = self._tensor(X), self._tensor(y)
            if self.likelihood == Likelihood.REGRESSION and yd.ndim != out.ndim:
                raise ValueError(f"The model's output has {out.ndim} dims but the target has "
                                 f"{yd.ndim} dims.")
            if use_streaming:
                # no Jacobian here: f from one forward, μ's shift from one jvp
                with torch.no_grad():
                    f_b = self.model.apply(Xd)
                mus.append(self._mean_scatter_term_batch_streaming(Xd, f_b, yd))
            else:
                Js_b, f_b = self._jacobians(Xd)
                Js_list.append(Js_b)
                mus.append(self._mean_scatter_term_batch(Js_b, f_b, yd))
            self.loss = self.loss + self.backend.factor * self.backend.lossfunc(f_b, yd)
            if self.likelihood == Likelihood.REGRESSION:
                C = f_b.shape[-1]
                lam = torch.eye(C, dtype=f_b.dtype, device=f_b.device).expand(f_b.shape[0], C, C)
            else:
                p = torch.softmax(f_b, dim=-1)
                lam = torch.diag_embed(p) - torch.einsum("mk,mc->mck", p, p)
            lambdas.append(lam)
            xs.append(Xd)

        self._sod_x = xs
        self.mu = torch.cat(mus, dim=0)
        self.L = torch.diagonal(torch.cat(lambdas, dim=0), dim1=-2, dim2=-1)  # (M, C)
        if use_streaming:
            self.Js_M = None
            self.K_MM = self._kernel_streaming(xs)
        else:
            self.Js_M = torch.cat(Js_list, dim=0)  # (M, C, P)
            M, C, P = self.Js_M.shape
            if self.independent_outputs:
                self.K_MM = torch.einsum("mcp,ncp->cmn", self.Js_M, self.Js_M)  # (C, M, M)
            else:
                Jflat = self.Js_M.reshape(M * C, P)
                self.K_MM = Jflat @ Jflat.T
        self._build_Sigma_inv()
        self._fitted = True
        self._recompute_Sigma = False

    def _mean_scatter_term_batch_streaming(self, Xd, f, y):
        """`_mean_scatter_term_batch` without a Jacobian: the shift
        `J (μ₀ − θ)` is one forward-mode product."""
        theta = self.model.mean_vector
        v = self.prior_mean.expand(theta.shape) - theta
        _, shift = torch.func.jvp(lambda t: self.model.apply_vec(t, Xd), (theta,), (v,))
        shift = shift.detach()
        if self.likelihood == Likelihood.REGRESSION:
            return y - (f + shift)
        return -shift

    def _kernel_streaming(self, batches) -> torch.Tensor:
        """K_MM from the pairs of SoD batches (j ≥ i) with transient
        per-batch Jacobians (reference `baselaplace.py:2420-2534`); the
        strictly lower blocks are the upper ones mirrored."""
        C = self.n_outputs
        row_blocks = []
        for i, X_i in enumerate(batches):
            Js_i, _ = self._jacobians(X_i)
            blocks = [None] * i
            for j in range(i, len(batches)):
                Js_j = Js_i if j == i else self._jacobians(batches[j])[0]
                if self.independent_outputs:
                    blocks.append(torch.einsum("mcp,ncp->cmn", Js_i, Js_j))
                else:
                    blocks.append(torch.einsum("mcp,nep->mcne", Js_i, Js_j).reshape(
                        Js_i.shape[0] * C, Js_j.shape[0] * C))
            row_blocks.append(blocks)
        for i in range(len(batches)):
            for j in range(i):
                row_blocks[i][j] = row_blocks[j][i].transpose(-1, -2)
        # blocks are (C, m_i, m_j) when independent, (m_i·C, m_j·C) otherwise
        return torch.cat([torch.cat(row, dim=-1) for row in row_blocks], dim=-2)

    def _subset_loader(self, train_loader, idx):
        if hasattr(train_loader, "subset"):
            return train_loader.subset(idx)
        xs, ys = [], []  # a generic loader: materialize, then subset
        for data in train_loader:
            X, y = self._unpack_batch(data)
            xs.append(np.asarray(X))
            ys.append(np.asarray(y))
        bs = getattr(train_loader, "batch_size", len(idx))
        return ArrayLoader(np.concatenate(xs)[idx], np.concatenate(ys)[idx], batch_size=bs)

    def _mean_scatter_term_batch(self, Js, f, y):
        """The scatter term's mean for one batch (reference
        `baselaplace.py:3133-3165`)."""
        shift = torch.einsum("bcp,p->bc", Js, self.prior_mean - self.mean)
        if self.likelihood == Likelihood.REGRESSION:
            return y - (f + shift)
        return -shift

    # ---- Σ
    @property
    def gp_kernel_prior_variance(self):
        """(M/N) / prior_precision (reference `baselaplace.py:2731-2733`)."""
        return self._gp_kernel_prior_variance(self.prior_precision)

    def _gp_kernel_prior_variance(self, prior_precision):
        return self._prior_factor_sod / torch.atleast_1d(prior_precision)[0]

    def _build_Sigma_inv(self) -> None:
        """Cholesky of `gp_var K_MM + Λ⁻¹` (reference `baselaplace.py:2376-2407`),
        one a class with `independent_outputs`."""
        gp_var = self.gp_kernel_prior_variance
        h = self._h_factor(self.sigma_noise)
        if self.independent_outputs:
            self.Sigma_chol = torch.stack([
                torch.linalg.cholesky(gp_var * self.K_MM[c] + torch.diag(
                    torch.nan_to_num(1.0 / (h * self.L[:, c]), posinf=10.0)))
                for c in range(self.n_outputs)])
        else:
            diag = torch.nan_to_num(1.0 / (h * self.L.reshape(-1)), posinf=10.0)
            self.Sigma_chol = torch.linalg.cholesky(gp_var * self.K_MM + torch.diag(diag))
        self._recompute_Sigma = False

    # ---- predictive
    @full_f32()
    def __call__(self, x, pred_type=PredType.GP, joint: bool = False,
                 link_approx=LinkApprox.PROBIT, n_samples: int = 100,
                 diagonal_output: bool = False, generator: torch.Generator | None = None,
                 fitting: bool = False):
        """The GP posterior predictive (reference `baselaplace.py:2552-2646`);
        outputs as `ParametricLaplace.__call__`'s GLM predictive."""
        if not self._fitted:
            raise RuntimeError("Functional Laplace has not been fitted to any training "
                               "dataset. Please call .fit method.")
        if self._recompute_Sigma:
            warnings.warn("The prior precision has been changed since fit. "
                          "Re-computing its value...")
            self._build_Sigma_inv()
        if pred_type != PredType.GP:
            raise ValueError("Only gp supported as prediction types.")
        if link_approx not in [la for la in LinkApprox]:
            raise ValueError(f"Unsupported link approximation {link_approx}.")
        likelihood = self.likelihood
        if likelihood == Likelihood.REWARD_MODELING:
            likelihood = Likelihood.CLASSIFICATION if fitting else Likelihood.REGRESSION
        f_mu, f_var = self._glm_predictive_distribution(
            x, joint=joint and likelihood == Likelihood.REGRESSION)
        return self._glm_link_output(f_mu, f_var, likelihood, joint, link_approx, n_samples,
                                     diagonal_output, self._rng(generator))

    @full_f32()
    def functional_samples(self, x, pred_type=PredType.GP, n_samples: int = 100,
                           diagonal_output: bool = False,
                           generator: torch.Generator | None = None) -> torch.Tensor:
        f_mu, f_var = self._glm_predictive_distribution(x)
        return self._glm_functional_samples(f_mu, f_var, n_samples, diagonal_output, generator)

    @full_f32()
    def predictive_samples(self, x, pred_type=PredType.GP, n_samples: int = 100,
                           diagonal_output: bool = False,
                           generator: torch.Generator | None = None) -> torch.Tensor:
        f_mu, f_var = self._glm_predictive_distribution(x)
        return self._glm_predictive_samples(f_mu, f_var, n_samples, diagonal_output, generator)

    def _K_M_star(self, Js_star) -> torch.Tensor:
        """The cross-kernel J* J_Mᵀ: one contraction with the cached SoD
        Jacobians, or a loop over the SoD batches with transient ones
        (reference `baselaplace.py:2747-2753`). (b, M, C) with
        `independent_outputs`, else (b, M·C, C)."""
        b, C = Js_star.shape[0], self.n_outputs
        if self.Js_M is not None:
            if self.independent_outputs:
                return torch.einsum("bcp,mcp->bmc", Js_star, self.Js_M)
            return torch.einsum("mcp,bep->bmce", self.Js_M, Js_star).reshape(
                b, self.Js_M.shape[0] * C, C)
        if self._sod_x is None:
            raise RuntimeError("Streaming FunctionalLaplace predictive needs the SoD inputs; "
                               "refit.")
        parts = []
        for X_b in self._sod_x:
            J_b, _ = self._jacobians(X_b)
            if self.independent_outputs:
                parts.append(torch.einsum("bcp,mcp->bmc", Js_star, J_b))
            else:
                parts.append(torch.einsum("mcp,bep->bmce", J_b, Js_star))
        K = torch.cat(parts, dim=1)
        return K if self.independent_outputs else K.reshape(b, K.shape[1] * C, C)

    def _independent_solves(self, K_M_star, other=None):
        """Per class c, `v_c = L_c⁻¹ K_M*[:, :, c]ᵀ` and the products
        `v_cᵀ v_c` (b,) (or (b, b) against `other`'s batch, the joint)."""
        prods = []
        for c in range(self.n_outputs):
            v = _solve_lower(self.Sigma_chol[c], K_M_star[:, :, c].T).T  # (b, M)
            prods.append(torch.einsum("bm,bm->b", v, v) if other is None
                         else torch.einsum("bm,am->ba", v, v))
        return torch.stack(prods, dim=-1)

    def functional_variance(self, Js_star) -> torch.Tensor:
        """`k** − K*M Σ⁻¹ K_M*` (reference `baselaplace.py:2735-2772`), (b, C, C)."""
        gp_var = self.gp_kernel_prior_variance
        K_M_star = gp_var * self._K_M_star(Js_star)
        if self.independent_outputs:
            K_star = gp_var * torch.einsum("bcp,bcp->bc", Js_star, Js_star)
            return torch.diag_embed(K_star - self._independent_solves(K_M_star))
        K_star = gp_var * torch.einsum("bcp,bep->bce", Js_star, Js_star)
        v = _solve_lower(self.Sigma_chol, K_M_star)  # (b, MC, C)
        return K_star - torch.einsum("bkm,bkn->bmn", v, v)

    def functional_covariance(self, Js_star) -> torch.Tensor:
        """The joint covariance (bC, bC) over the test batch (reference
        `baselaplace.py:2774-2814`)."""
        gp_var = self.gp_kernel_prior_variance
        b, C, _ = Js_star.shape
        K_M_star = gp_var * self._K_M_star(Js_star)
        if self.independent_outputs:
            K_star = gp_var * torch.einsum("acp,bcp->abc", Js_star, Js_star)
            f_var = torch.diag_embed(K_star - self._independent_solves(K_M_star, other=True))
        else:
            K_star = gp_var * torch.einsum("acp,bep->abce", Js_star, Js_star)
            v = _solve_lower(self.Sigma_chol, K_M_star)
            f_var = K_star - torch.einsum("akm,bkn->abmn", v, v)
        return f_var.permute(0, 2, 1, 3).reshape(b * C, b * C)

    # ---- marglik
    @property
    def log_det_ratio(self) -> torch.Tensor:
        return self._log_det_ratio(self.prior_precision, self.sigma_noise)

    def _log_det_ratio(self, prior_precision, sigma_noise) -> torch.Tensor:
        """The GP marglik's log-det term (reference `baselaplace.py:2865-2927`):
        regression `log|K + σ²I|`, classification `log|I + W K W|` with
        W = (h Λ)^{1/2}."""
        gp_var = self._gp_kernel_prior_variance(prior_precision)
        kernels = list(self.K_MM) if self.independent_outputs else [self.K_MM]
        lams = ([self.L[:, c] for c in range(self.n_outputs)] if self.independent_outputs
                else [self.L.reshape(-1)])
        ld = 0.0
        for K, lam in zip(kernels, lams):
            eye = torch.eye(K.shape[0], dtype=self._dtype, device=self.device)
            if self.likelihood == Likelihood.REGRESSION:
                ld = ld + torch.linalg.slogdet(gp_var * K + sigma_noise ** 2 * eye)[1]
            else:
                W = torch.sqrt(self._h_factor(sigma_noise) * lam)
                ld = ld + torch.linalg.slogdet(W[:, None] * gp_var * K * W[None, :] + eye)[1]
        return ld

    @property
    def scatter(self) -> torch.Tensor:
        return self._scatter(self.prior_precision, self.sigma_noise)

    def _scatter(self, prior_precision, sigma_noise, eps: float = 1e-5):
        """The GP marglik's scatter `μᵀ (K + noise I)⁻¹ μ` (reference
        `baselaplace.py:2929-2978`); the noise is σ² for regression, `eps`
        otherwise."""
        gp_var = self._gp_kernel_prior_variance(prior_precision)
        noise = sigma_noise ** 2 if self.likelihood == Likelihood.REGRESSION else eps
        kernels = list(self.K_MM) if self.independent_outputs else [self.K_MM]
        mus = ([self.mu[:, c] for c in range(self.n_outputs)] if self.independent_outputs
               else [self.mu.reshape(-1)])
        scatter = 0.0
        for K, mu in zip(kernels, mus):
            eye = torch.eye(K.shape[0], dtype=self._dtype, device=self.device)
            chol = torch.linalg.cholesky(gp_var * K + noise * eye)
            mu_term = _solve_lower(chol, mu[:, None])[:, 0]
            scatter = scatter + mu_term @ mu_term
        return scatter

    def _log_marglik(self, prior_precision, sigma_noise):
        return self._log_likelihood(sigma_noise) - 0.5 * (
            self._log_det_ratio(prior_precision, sigma_noise)
            + self._scatter(prior_precision, sigma_noise))

    # ---- serialization
    def state_dict(self) -> dict:
        """The fitted GP under the JAX package's keys
        (`functional_laplace.py:592-627`); SoD inputs as arrays, no loader."""
        sod_x = self._sod_x
        if sod_x is not None and not all(torch.is_tensor(x) for x in sod_x):
            sod_x = None
        return {
            "mean": self.mean,
            "num_data": self.n_subset,
            "diagonal_kernel": self.independent_outputs,
            "seed": self.seed,
            "K_MM": self.K_MM,
            "Sigma_chol": self.Sigma_chol,
            "Js_M": self.Js_M,
            "_sod_x": sod_x,
            "_prior_factor_sod": self._prior_factor_sod,
            "_fitted": self._fitted,
            "_recompute_Sigma": self._recompute_Sigma,
            "mu": self.mu,
            "L": self.L,
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
        """Load a `state_dict` (the JAX package's `functional_laplace.py:629-661`)."""
        self._check_state_type(state_dict)
        if self.likelihood != state_dict["likelihood"]:
            raise ValueError("Different likelihoods detected!")
        value = self._state_value
        self.mean = value(state_dict["mean"])
        self.n_subset = int(state_dict["num_data"])
        self.independent_outputs = state_dict["diagonal_kernel"]
        self.seed = state_dict["seed"]
        self.K_MM = value(state_dict["K_MM"])
        self.Sigma_chol = value(state_dict["Sigma_chol"])
        self.Js_M = value(state_dict["Js_M"])
        sod_x = state_dict.get("_sod_x")
        self._sod_x = None if sod_x is None else [self._tensor(x) for x in sod_x]
        self._prior_factor_sod = state_dict["_prior_factor_sod"]
        self._fitted = state_dict["_fitted"]
        self.mu = value(state_dict["mu"])
        self.L = value(state_dict["L"])
        self.loss = value(state_dict["loss"])
        self.prior_mean = state_dict["prior_mean"]
        self.prior_precision = state_dict["prior_precision"]
        # after the prior: its setter asks for a new Cholesky, which would
        # throw the saved one away
        self._recompute_Sigma = state_dict["_recompute_Sigma"]
        self.sigma_noise = state_dict["sigma_noise"]
        self.n_data = int(state_dict["n_data"])
        self.n_outputs = int(state_dict["n_outputs"])
        self.likelihood = state_dict["likelihood"]
        self.temperature = state_dict["temperature"]
        self.enable_backprop = state_dict["enable_backprop"]

    @BaseLaplace.prior_precision.setter
    def prior_precision(self, prior_precision):
        """Changing the prior invalidates the Cholesky factor (reference
        `baselaplace.py:3209-3230`)."""
        BaseLaplace.prior_precision.fset(self, prior_precision)
        self._recompute_Sigma = True

    def optimize_prior_precision(self, pred_type=PredType.GP, method=TuningMethod.MARGLIK,
                                 n_steps: int = 100, lr: float = 1e-1, init_prior_prec=1.0,
                                 prior_structure=PriorStructure.SCALAR, val_loader=None,
                                 loss=None, log_prior_prec_min: float = -4,
                                 log_prior_prec_max: float = 4, grid_size: int = 100,
                                 link_approx=LinkApprox.PROBIT, n_samples: int = 100) -> None:
        """`BaseLaplace.optimize_prior_precision` for the GP predictive and a
        scalar prior; Σ is rebuilt after (reference `baselaplace.py:2980-3024`)."""
        if pred_type != PredType.GP:
            raise AssertionError("Only gp supported as prediction type.")
        if prior_structure != PriorStructure.SCALAR:
            raise AssertionError("Only isotropic gaussian prior supported.")
        if method == TuningMethod.MARGLIK:
            warnings.warn("Use of method='marglik' in case of FunctionalLaplace is "
                          "discouraged, rather use method='gridsearch'.")
        super().optimize_prior_precision(pred_type, method, n_steps, lr, init_prior_prec,
                                         prior_structure, val_loader, loss, log_prior_prec_min,
                                         log_prior_prec_max, grid_size, link_approx, n_samples)
        with full_f32():
            self._build_Sigma_inv()


class FunctionalLLLaplace(FunctionalLaplace):
    """GP inference on the last layer's Jacobians (reference
    `lllaplace.py:509-641`). `last_layer_name` is the head's torch module
    name; None finds the head on the first fit batch as `LLLaplace` does.
    The head's kind comes from a probe of that batch's first input
    (`data`): a Dense head has the closed-form φ⊗I Jacobians, with the
    features as GP inputs; any other takes the per-sample Jacobians over
    its leaves. (The JAX package's `FunctionalLLLaplace` takes φ⊗I on every
    head.)"""

    _key = ("last_layer", "gp")

    def __init__(self, model, likelihood, n_subset: int, sigma_noise=1.0,
                 prior_precision=1.0, prior_mean=0.0, temperature: float = 1.0,
                 enable_backprop: bool = False,
                 feature_reduction: FeatureReduction | str | None = None,
                 dict_key_x: str = "input_ids", dict_key_y: str = "labels",
                 last_layer_name: str | None = None, independent_outputs: bool = False,
                 seed: int = 0, backend="ggn", backend_kwargs: dict | None = None, device=None,
                 parallel=None):
        super().__init__(model, likelihood, n_subset, sigma_noise, prior_precision, prior_mean,
                         temperature, enable_backprop, dict_key_x, dict_key_y,
                         independent_outputs, seed, backend=backend,
                         backend_kwargs=backend_kwargs, device=device, parallel=parallel)
        self._full_model = self.model
        self.feature_reduction = feature_reduction
        self._last_layer_name = last_layer_name
        self.last_layer_path = None
        self.data = None  # the probe: the first fit batch's first input
        if last_layer_name is not None:
            self._set_last_layer(tuple(last_layer_name.split(".")))

    def _set_last_layer(self, path: tuple) -> None:
        """Restrict the model to the last layer's leaves, take its kind from
        the probe (`dense` until there is one) and give the backend the head
        (built again at its next use)."""
        trainable = self._full_model.split_last_layer(path)
        self.last_layer_path = path
        self.model = NNModel(self._full_model.module, trainable=trainable)
        self.n_params = self.model.n_params
        self.n_layers = self.model.n_layers
        self.mean = self.model.mean_vector
        self._head_kind = self._full_model.head_kind(path, self.data)
        self._backend = None
        self._backend_kwargs.update(last_layer=True, last_layer_path=path,
                                    last_layer_dense=self._head_kind == "dense",
                                    feature_reduction=self.feature_reduction)

    def fit(self, train_loader) -> None:
        """Probe the first batch, if there is no probe yet, to find the head
        and its kind, then fit."""
        if self.data is None:
            X, _ = self._unpack_batch(next(iter(train_loader)))
            self.data = batch_slice(self._tensor(X), slice(0, 1))
            self._set_last_layer(self.last_layer_path
                                 or self._full_model.find_last_layer(self.data))
        super().fit(train_loader)

    def state_dict(self) -> dict:
        """The GP state with the probe `data` and `_last_layer_name` (the JAX
        package's `functional_laplace.py:718-722`)."""
        return dict(super().state_dict(), data=self.data,
                    _last_layer_name=flax_module_name(self._last_layer_name))

    def load_state_dict(self, state_dict: dict) -> None:
        if flax_module_name(self._last_layer_name) != state_dict["_last_layer_name"]:
            raise ValueError("Different `last_layer_name` detected!")
        data = state_dict["data"]
        if data is not None and self.data is None:
            self.data = self._tensor(data)
            self._set_last_layer(self.last_layer_path
                                 or self._full_model.find_last_layer(self.data))
        super().load_state_dict(state_dict)
