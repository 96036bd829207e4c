"""Curvature backend (port of `laplace_jax/curvature/backend.py`): the GGN
(exact, or its MC estimate with `stochastic`), the empirical Fisher and the
exact Hessian, each as a full matrix, a diagonal or KFAC factors; and the
per-sample Jacobians and loss gradients they are built from.

Loss conventions, as in the JAX package: regression uses the summed
squared error with factor 1/2, classification the summed cross-entropy with
factor 1. So the regression GGN is JᵀJ (the Hessian of ½·SSE in f is I),
its KFAC cotangent is √2·I with the factors then scaled by 1/2, and its
diagonal carries no Λ. The EF and the Hessian are those of the summed loss,
scaled by the factor (the regression EF is 2 Σ (f − y)² JᵀJ).

With `last_layer` and `last_layer_path` set, the model's trainable leaves
are the last layer's and KFAC taps that layer alone; the Jacobians are the
closed-form φ⊗I when that layer is a Dense (`last_layer_dense`), else the
per-sample Jacobians over its leaves (the JAX package's `use_phi`,
`laplace_jax/curvature/backend.py:240-258`). With `subnetwork_indices` set,
the Jacobians, gradients and Hessian hold only those entries of the
canonical flat vector, in index order.

The full GGN runs through the `syrk` kernel; the all-weights diagonal of the
GGN and EF through the layer taps (`diag_taps.py`), with no (B, C, P) array;
the low-rank eigendecomposition of the GGN or the Hessian by matrix-free
Lanczos (`lanczos.py`).
MC draws come from the caller's `torch.Generator` (`kfac.mc_draws`).
"""

from __future__ import annotations

import warnings

import torch
from torch.func import functional_call, grad, hessian, vmap

from laplace_jax_torch.curvature import kfac
from laplace_jax_torch.curvature.diag_taps import TapUnsupported, diag_curvature_taps
from laplace_jax_torch.curvature.kfac import _sqrt_hessian_cotangents, kfac_factors
from laplace_jax_torch.enums import Likelihood
from laplace_jax_torch.nnmodel import batch_len, batch_slice, shape_error
from laplace_jax_torch.ops.syrk import syrk
from laplace_jax_torch.utils import spans
from laplace_jax_torch.utils.flatten import to_flax_layout, vector_to_parameters

__all__ = ["CurvatureBackend", "GGNBackend", "EFBackend", "HessianBackend", "mse_sum",
           "cross_entropy_sum"]


def mse_sum(f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return ((f - y) ** 2).sum()


def cross_entropy_sum(f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The summed cross-entropy; labels broadcast against the outputs' rows,
    as `jnp.take_along_axis` broadcasts them in the JAX package."""
    logp = torch.log_softmax(f, dim=-1)
    idx = y[..., None].long()
    return -torch.gather(logp, -1, idx.expand(*torch.broadcast_shapes(
        idx.shape[:-1], logp.shape[:-1]), 1)).sum()


class CurvatureBackend:
    """Curvature for one `NNModel` and a likelihood, 'classification' or
    'regression'.

    `curv_type` is 'ggn', 'ef' or 'hessian'; `stochastic` takes the GGN's
    MC estimate with `num_samples` draws a sample; `kron_unsupported`
    ('skip', 'block', 'raise') and `kron_block_max_params` set KFAC's policy
    for leaves outside Dense and Conv layers (`kfac.py`); `ef_chunk_size`
    is the samples per empirical-Fisher chunk (peak extra memory chunk·P;
    None: about 64 MiB of gradients, clamped to [4, 128]).
    """

    def __init__(self, model, likelihood=Likelihood.CLASSIFICATION, curv_type: str = "ggn",
                 stochastic: bool = False, num_samples: int = 1, last_layer: bool = False,
                 last_layer_path=None, last_layer_dense: bool = True, feature_reduction=None,
                 subnetwork_indices=None, kron_unsupported: str = "skip",
                 kron_block_max_params: int = 8192, ef_chunk_size: int | None = None):
        if likelihood not in (Likelihood.REGRESSION, Likelihood.CLASSIFICATION):
            raise ValueError("Backend likelihood must be regression or classification.")
        if curv_type not in ("ggn", "ef", "hessian"):
            raise ValueError(f"Unknown curv_type {curv_type}.")
        if kron_unsupported not in ("skip", "block", "raise"):
            raise ValueError(f"kron_unsupported must be 'skip', 'block', or 'raise', got "
                             f"{kron_unsupported!r}.")
        if kron_block_max_params < 1:
            raise ValueError(f"kron_block_max_params must be >= 1, got {kron_block_max_params}.")
        if ef_chunk_size is not None and ef_chunk_size < 1:
            raise ValueError(f"ef_chunk_size must be >= 1, got {ef_chunk_size}.")
        self.model = model
        self.likelihood = likelihood
        self.curv_type = curv_type
        self.stochastic = stochastic
        self.num_samples = num_samples
        self.last_layer = last_layer
        self.last_layer_path = last_layer_path
        self.last_layer_dense = last_layer_dense
        self.feature_reduction = feature_reduction
        self.subnetwork_indices = subnetwork_indices  # a long tensor, or None
        self.kron_unsupported = kron_unsupported
        self.kron_block_max_params = kron_block_max_params
        self.ef_chunk_size = ef_chunk_size
        if likelihood == Likelihood.REGRESSION:
            self.lossfunc, self.factor = mse_sum, 0.5
        else:
            self.lossfunc, self.factor = cross_entropy_sum, 1.0

    # ---- Jacobians
    def _jacobians_dispatch(self, x, create_graph: bool = False):
        """The closed-form last-layer Jacobians when the last layer is a
        Dense, else the per-sample Jacobians over the trainable leaves; with
        `create_graph` both stay differentiable (in the input, for
        `enable_backprop`)."""
        if self.last_layer and self.last_layer_dense:
            return self.last_layer_jacobians(x, create_graph)
        return self.jacobians(x, create_graph)

    @spans.span("predict.features_jacobians")
    def last_layer_jacobians(self, x, create_graph: bool = False):
        """Closed-form Jacobians (batch, outputs, P_ll) of the Dense last
        layer from its features φ: the bias block `I` first, then the
        input-major kernel block `J[b, c, i*C + o] = φ[b, i] δ_co`
        (reference `backend.py:209-238`); and f (batch, outputs)."""
        if self.last_layer_path is None:
            raise ValueError("last_layer_path not set on backend.")
        with torch.set_grad_enabled(create_graph), spans.span("predict.forward"):
            f, phi = self.model.apply_with_features(x, self.last_layer_path,
                                                    self.feature_reduction)
        with spans.span("predict.jacobians"):
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

        A model whose parameters are shape-coupled to the batch (a
        `DenseGeneral` with `batch_dims`) cannot run one sample: when the
        one-sample forward or its backward fails with a shape error, a
        `RuntimeWarning` says so and the Jacobian of the whole batch's
        forward is taken, whose memory is quadratic in the batch size (the
        JAX package's fallback, `laplace_jax/curvature/backend.py:30-48`).
        An error that fails the whole batch too, or any other, propagates.
        """
        idx = self.subnetwork_indices
        rows = []
        try:
            with torch.enable_grad():
                for b in range(batch_len(x)):
                    fb = self.model.apply(batch_slice(x, slice(b, b + 1)))
                    rows.append(self._jacobian_rows(fb, create_graph)[0])
        except (RuntimeError, TypeError, ValueError) as exc:
            if not shape_error(exc):
                raise
            _warn_batch_fallback(exc)
            # the whole batch's forward: a shape bug fails it too, and raises
            with torch.enable_grad():
                f = self.model.apply(x)
                Js = self._jacobian_rows(f, create_graph)
            return Js, (f if create_graph else f.detach())
        with torch.set_grad_enabled(create_graph):
            f = self.model.apply(x)
        return torch.stack(rows), f

    def _jacobian_rows(self, f: torch.Tensor, create_graph: bool) -> torch.Tensor:
        """(B, C, P) derivatives of the outputs f (B, C) of one forward in
        the trainable leaves, columns in the canonical flat order (or the
        subnetwork's): one backward pass batched over the B·C outputs, every
        sample's against the whole batch's graph."""
        B, C = f.shape
        eye = torch.eye(B * C, dtype=f.dtype, device=f.device).reshape(B * C, B, C)
        gs = torch.autograd.grad(f, self.model.params_in_order(), grad_outputs=eye,
                                 is_grads_batched=True, create_graph=create_graph)
        J = torch.cat([to_flax_layout(g, s.layout, lead=1).reshape(B * C, -1)
                       for s, g in zip(self.model.leaf_specs, gs)], 1)
        idx = self.subnetwork_indices
        return (J if idx is None else J[:, idx]).reshape(B, C, -1)

    # ---- gradients
    def _loss_of_vector(self):
        """(loss(t, x, y) of the flat vector or subvector t, t0): the summed
        loss of a batch with the trainable leaves from t; with
        `subnetwork_indices`, t is those entries and the rest stay at the
        MAP (the JAX package's `_per_sample_grad_fn`)."""
        theta = self.model.mean_vector
        specs, idx = self.model.leaf_specs, self.subnetwork_indices
        module = self.model.module

        def loss(t, x, y):
            full = t if idx is None else theta.index_copy(0, idx, t)
            f = functional_call(module, vector_to_parameters(full, specs), (x,))
            return self.lossfunc(f, y)

        return loss, (theta if idx is None else theta[idx])

    @torch.no_grad()
    def _per_sample_grads(self, loss, t0, x, y) -> torch.Tensor:
        """(batch, len(t0)) gradients by `torch.func`, whose transforms
        differentiate under `no_grad` too; outside them nothing is recorded
        (the frozen leaves still require grad)."""

        def one(xi, yi):
            return grad(loss)(t0, _expand(xi), _expand(yi))

        return vmap(one)(x, y)

    def gradients(self, x, y):
        """Per-sample loss gradients (batch, n_params or n_indices) and the
        batch loss (reference `curvature/curvature.py:169-210`)."""
        loss, t0 = self._loss_of_vector()
        Gs = self._per_sample_grads(loss, t0, x, y)
        with torch.no_grad():
            return Gs, self.lossfunc(self.model.apply(x), y)

    def _ef_accumulate(self, x, y, mode: str):
        """The empirical Fisher Σ GᵀG (full) or Σ G² (diag) of the per-sample
        gradients, `ef_chunk_size` samples at a time, so peak memory is
        chunk·P (plus P² for full); and the batch loss."""
        loss, t0 = self._loss_of_vector()
        P, B = t0.shape[0], batch_len(x)
        chunk = self.ef_chunk_size or _default_ef_chunk(P, t0.element_size())
        H = (torch.zeros(P, P, dtype=t0.dtype, device=t0.device) if mode == "full"
             else torch.zeros(P, dtype=t0.dtype, device=t0.device))
        for b0 in range(0, B, chunk):
            sl = slice(b0, min(B, b0 + chunk))
            G = self._per_sample_grads(loss, t0, batch_slice(x, sl), y[sl])
            H += G.T @ G if mode == "full" else (G * G).sum(0)
        with torch.no_grad():
            return H, self.lossfunc(self.model.apply(x), y)

    # ---- likelihood middles
    def _functional_hessian(self, f):
        """Λ = ∂²(−log lik)/∂f²: None (≡ I) for regression, diag(p) − ppᵀ
        for classification (reference `curvature/curvature.py:366-373`)."""
        if self.likelihood == Likelihood.REGRESSION:
            return None
        p = torch.softmax(f, dim=-1)
        return torch.diag_embed(p) - p[:, :, None] * p[:, None, :]

    def _mc_functional_fisher(self, f, generator):
        """MC estimate (B, C, C) of E[∇f ∇fᵀ] under labels drawn from the
        model (reference `curvature/curvature.py:341-364`)."""
        draws = kfac.mc_draws(f, self.likelihood, self.num_samples, generator)
        F = torch.zeros(f.shape[0], f.shape[-1], f.shape[-1], dtype=f.dtype, device=f.device)
        p = torch.softmax(f, dim=-1)
        for d in draws:
            if self.likelihood == Likelihood.REGRESSION:
                g = f - (f + d)
            else:
                g = p - torch.nn.functional.one_hot(d, f.shape[-1]).to(f.dtype)
            F = F + g[:, :, None] * g[:, None, :] / self.num_samples
        return F

    # ---- full
    def full(self, x, y, N: int = 1, generator: torch.Generator | None = None):
        """Dense P x P curvature and the batch loss (reference
        `curvature.py:375-411`, `:467-493`): the GGN `H = MᵀM` by the `syrk`
        kernel, with M (B*C, P) the Jacobian rows weighted by Λ^{1/2} for
        classification; its MC estimate; the EF; or the exact Hessian."""
        if self.curv_type == "ef":
            H, loss = self._ef_accumulate(x, y, "full")
            return self.factor * loss, self.factor * H
        if self.curv_type == "hessian":
            return self._hessian(x, y)
        Js, f = self._jacobians_dispatch(x)
        if self.stochastic:
            lam = self._mc_functional_fisher(f, generator)
            H = torch.einsum("bcp,bck,bkq->pq", Js, lam, Js)
        else:
            B, C, P = Js.shape
            if self.likelihood == Likelihood.REGRESSION:
                M = Js.reshape(B * C, P)
            else:
                S = _sqrt_hessian_cotangents(f)  # (C, B, C)
                M = torch.einsum("cbk,bkp->bcp", S, Js).reshape(B * C, P)
            H = syrk(M.contiguous())
        return self.factor * self.lossfunc(f, y), H

    def _hessian(self, x, y):
        """The exact Hessian of the summed loss in the flat vector (its
        subnetwork block with `subnetwork_indices`), scaled by the factor."""
        theta = self.model.mean_vector
        specs, module = self.model.leaf_specs, self.model.module

        def total_loss(t):
            return self.lossfunc(functional_call(module, vector_to_parameters(t, specs), (x,)), y)

        with torch.no_grad():  # the transforms differentiate all the same
            H = hessian(total_loss)(theta)
            loss = total_loss(theta)
        if self.subnetwork_indices is not None:
            H = H[self.subnetwork_indices][:, self.subnetwork_indices]
        return self.factor * loss, self.factor * H

    # ---- diag
    def _can_use_taps(self) -> bool:
        """The layer-tap diagonal needs the whole model (no subnetwork) and
        every leaf named as a tapped layer's (the JAX package's rule;
        `diag_taps` itself raises `TapUnsupported` for the rest)."""
        if self.subnetwork_indices is not None:
            return False
        return all(s.path[-1] in ("kernel", "bias", "scale", "embedding")
                   for s in self.model.leaf_specs)

    def diag(self, x, y, N: int = 1, generator: torch.Generator | None = None):
        """Diagonal curvature and the batch loss (reference
        `curvature.py:413-433`, `:495-505`). The all-weights GGN and EF
        diagonals come from the layer taps (`diag_taps.py`), with no
        (B, C, P) Jacobian; otherwise from the Jacobians, the chunked
        per-sample gradients (EF) or the Hessian."""
        if (not self.stochastic and self.curv_type in ("ggn", "ef") and not self.last_layer
                and self._can_use_taps()):
            try:
                loss, d = diag_curvature_taps(self.model, x, y, self.likelihood,
                                              self.lossfunc, curv_type=self.curv_type)
            except TapUnsupported:
                pass  # a leaf outside the tapped layers: the exact paths below
            else:
                if self.curv_type == "ef":  # EF scales H; the GGN does not
                    d = self.factor * d
                return self.factor * loss, d
        if self.curv_type == "ef":
            d, loss = self._ef_accumulate(x, y, "diag")
            return self.factor * loss, self.factor * d
        if self.curv_type == "hessian":
            loss, H = self.full(x, y, N)
            return loss, torch.diagonal(H)
        Js, f = self._jacobians_dispatch(x)
        if self.stochastic:
            lam = self._mc_functional_fisher(f, generator)
        else:
            lam = self._functional_hessian(f)
        if lam is None:
            H = torch.einsum("bcp,bcp->p", Js, Js)
        else:
            H = torch.einsum("bcp,bck,bkp->p", Js, lam, Js)
        return self.factor * self.lossfunc(f, y), H

    # ---- kron
    @spans.span("accumulate.batch")
    def kron(self, x, y, N: int, generator: torch.Generator | None = None):
        """KFAC factors of one batch as a `Kron`, with the batch loss; the
        activation factor carries 1/N, so batches add (reference
        `curvature/curvlinops.py:77-108`)."""
        if self.curv_type == "hessian":
            raise ValueError(
                "KFAC with the exact Hessian is undefined; use a GGN/EF/MC backend (the "
                "reference's Hessian backend has no kron either, "
                "`curvature/curvlinops.py:183-188`).")
        if self.curv_type == "ef":
            fisher_type = "empirical"
        elif self.stochastic:
            fisher_type = "mc"
        else:
            fisher_type = "exact"
        loss, kron = kfac_factors(
            self.model, x, y, N, self.likelihood, self.lossfunc, fisher_type=fisher_type,
            num_samples=self.num_samples, generator=generator,
            last_layer_path=self.last_layer_path if self.last_layer else None,
            unsupported=self.kron_unsupported, block_max_params=self.kron_block_max_params)
        return self.factor * loss, kron * self.factor

    # ---- lowrank
    def eig_lowrank(self, loader, low_rank: int = 10, generator: torch.Generator | None = None,
                    unpack=None, parallel=None):
        """The top `low_rank` eigenpairs (eigenvalues above 1e-6) of the
        whole loader's curvature by matrix-free Lanczos, and the total loss
        (`lanczos.py`; the JAX package's `backend.py:504-509`), spread over
        `parallel`'s ranks when given."""
        from laplace_jax_torch.curvature.lanczos import lanczos_eig_curvature

        return lanczos_eig_curvature(self, loader, low_rank, generator, unpack, parallel)


def _warn_batch_fallback(exc: Exception) -> None:
    warnings.warn(
        "Per-sample Jacobians failed (model parameters appear shape-coupled to the batch); "
        "falling back to the whole-batch Jacobian, whose memory is QUADRATIC in batch size. "
        f"Cause: {exc}", RuntimeWarning, stacklevel=4)


def _default_ef_chunk(P: int, itemsize: int = 4) -> int:
    """Samples per EF chunk: about 64 MiB of per-sample gradients
    (chunk · P · itemsize), clamped to [4, 128]."""
    return max(4, min(128, (64 << 20) // max(P * itemsize, 1)))


def _expand(v):
    """Add back the batch dim that vmap removes (a tensor or a dict batch)."""
    if isinstance(v, dict):
        return {k: a[None] for k, a in v.items()}
    return v[None]


# -- the reference's named backends ---------------------------------------------


def GGNBackend(model, likelihood, stochastic: bool = False, num_samples: int = 1,
               **kw) -> CurvatureBackend:
    return CurvatureBackend(model, likelihood, "ggn", stochastic=stochastic,
                            num_samples=num_samples, **kw)


def EFBackend(model, likelihood, **kw) -> CurvatureBackend:
    return CurvatureBackend(model, likelihood, "ef", **kw)


def HessianBackend(model, likelihood, **kw) -> CurvatureBackend:
    return CurvatureBackend(model, likelihood, "hessian", **kw)
