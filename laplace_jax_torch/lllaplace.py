"""Last-layer Laplace approximations (port of `laplace_jax/lllaplace.py`),
with the predictive surface of `baselaplace` (regression, links, joint,
samples) and `save`/`load`.

The last layer is a parameter subset: the model keeps every weight in its
forward, but only the head's leaves are trainable
(`NNModel(module, trainable=...)`), and KFAC taps that layer alone. With no
`last_layer_name`, the head is found on the first fit batch, as in the
reference (`lllaplace.py:142-160`): the last executed Dense, else the last
executed conv, DenseGeneral or norm layer (`NNModel.find_last_layer`);
until then `n_params` is None and the prior waits. The head's kind
(`_head_kind`) comes from a probe of that batch's first input (`data`),
also when `last_layer_name` is given. A Dense head has the closed-form φ⊗I
Jacobians and the fast diagonal predictive; any other head takes the
per-sample Jacobians over its leaves and the sampled forward of the whole
network. `backend` and `backend_kwargs` are those of `BaseLaplace`; the
head's path, kind and `feature_reduction` join the backend's arguments
(the JAX package's `lllaplace.py:110-115`). KFAC covers a Dense, a conv
(1-, 2- or 3-d, grouped, circular or masked), a DenseGeneral, an Einsum
and an Embed head (the port's taps). `KronLLLaplace` on a norm head, which
KFAC cannot factor, raises `NoKFACHead`, a `ValueError` as the JAX
package's.
"""

from __future__ import annotations

import torch

from laplace_jax_torch.baselaplace import DiagLaplace, FullLaplace, KronLaplace, ParametricLaplace
from laplace_jax_torch.enums import FeatureReduction
from laplace_jax_torch.nnmodel import NNModel, batch_slice, flax_module_name
from laplace_jax_torch.utils.flatten import layer_kind

__all__ = ["LLLaplace", "FullLLLaplace", "KronLLLaplace", "DiagLLLaplace", "NoKFACHead"]


class NoKFACHead(NotImplementedError, ValueError):
    """KronLLLaplace on a head KFAC cannot factor (a norm layer): a
    `ValueError`, the class the JAX package raises there, and a
    `NotImplementedError`, so callers that catch either see it."""


class LLLaplace(ParametricLaplace):
    """Base class of last-layer Laplace (reference `lllaplace.py:34`).

    `last_layer_name` is the head's torch module name (`"Dense_0"`,
    `"head.fc"`); None finds it on the first fit batch.
    `backend`, `backend_kwargs` and `parallel` are `BaseLaplace`'s. Further keyword
    arguments go to the posterior class (`damping` for Kron).
    """

    def __init__(self, model, likelihood, sigma_noise=1.0, prior_precision=1.0,
                 prior_mean=0.0, temperature: float = 1.0, enable_backprop: bool = False,
                 feature_reduction: FeatureReduction | str | None = None,
                 dict_key_x: str = "input_ids", dict_key_y: str = "labels",
                 last_layer_name: str | None = None, backend=None,
                 backend_kwargs: dict | None = None, device=None, parallel=None, **kwargs):
        if feature_reduction is not None and feature_reduction not in [
                fr.value for fr in FeatureReduction]:
            raise ValueError("`feature_reduction` must take value in the `FeatureReduction "
                             "enum` or one of `{'pick_first', 'pick_last', 'average'}`!")
        super().__init__(model, likelihood, sigma_noise, 1.0, 0.0, temperature,
                         enable_backprop, dict_key_x, dict_key_y, backend=backend,
                         backend_kwargs=backend_kwargs, device=device, parallel=parallel,
                         **kwargs)
        self._full_model = self.model
        self.feature_reduction = feature_reduction
        self._last_layer_name = last_layer_name
        self.last_layer_path = None
        self.data = None  # the probe: the first fit batch's first input
        self._head_kind = "dense"
        self._deferred_prior = (prior_precision, prior_mean)
        self.mean = None
        self.n_params = self.n_layers = None
        if last_layer_name is not None:
            self._set_last_layer(tuple(last_layer_name.split(".")))

    def _set_last_layer(self, path: tuple) -> None:
        """Restrict the model to the last layer's leaves, take its kind from
        the probe (`dense` until there is one), give the backend the head
        (built again at its next use), and apply the prior given at
        construction."""
        trainable = self._full_model.split_last_layer(path)
        self.last_layer_path = path
        self.model = NNModel(self._full_model.module, trainable=trainable)
        self.n_params = self.model.n_params
        self.n_layers = self.model.n_layers
        self._head_kind = self._full_model.head_kind(path, self.data)
        self._backend = None
        self._backend_kwargs.update(last_layer=True, last_layer_path=path,
                                    last_layer_dense=self._head_kind == "dense",
                                    feature_reduction=self.feature_reduction)
        self.prior_precision, self.prior_mean = self._deferred_prior
        self.mean = self.prior_mean

    def fit(self, train_loader, override: bool = True,
            generator: torch.Generator | None = None) -> None:
        """Find the last layer on the first batch if needed, resolve the
        head's kind from a probe of that batch, then fit (reference
        `lllaplace.py:162-210`; the JAX package's `lllaplace.py:118-160`)."""
        if not override:
            raise ValueError("Last-layer Laplace approximations do not support "
                             "`override=False`.")
        if self.last_layer_path is None:
            X, _ = self._unpack_batch(next(iter(train_loader)))
            self.data = batch_slice(self._tensor(X), slice(0, 1))
            self._set_last_layer(self._full_model.find_last_layer(self.data))
        elif self.data is None:
            X, _ = self._unpack_batch(next(iter(train_loader)))
            self.data = batch_slice(self._tensor(X), slice(0, 1))
            if self._full_model.head_kind(self.last_layer_path, self.data) != self._head_kind:
                pp, pm = self.prior_precision, self.prior_mean
                self._set_last_layer(self.last_layer_path)
                self.prior_precision, self.prior_mean = pp, pm
        super().fit(train_loader, override=True, generator=generator)

    def _features(self, x):
        with torch.set_grad_enabled(self.enable_backprop):
            return self.model.apply_with_features(self._tensor(x), self.last_layer_path,
                                                  self.feature_reduction)

    def _has_bias(self) -> bool:
        return any(s.path[-1] == "bias" for s in self.model.leaf_specs)

    def _glm_predictive_distribution(self, x, joint: bool = False,
                                     diagonal_output: bool = False):
        """The GLM predictive; without `joint`, the diagonal comes from
        `functional_variance_fast` (reference `lllaplace.py:212-237`)."""
        if diagonal_output and not joint:
            f_mu, f_var = self.functional_variance_fast(x)
            if not self.enable_backprop:
                f_mu, f_var = f_mu.detach(), f_var.detach()
            return f_mu, f_var
        return super()._glm_predictive_distribution(x, joint=joint)

    def functional_variance_fast(self, x):
        """f (batch, classes) and the diagonal output variance (batch,
        classes); the flavors below compute it without the Jacobians on a
        Dense head."""
        f_mu, f_var = super()._glm_predictive_distribution(x)
        return f_mu, torch.diagonal(f_var, dim1=-2, dim2=-1)

    def _nn_functional_samples(self, x, n_samples: int = 100, generator=None):
        """Sampled last-layer outputs (n_samples, batch, outputs): the
        features once, then the Dense head under each posterior sample of
        its (bias, input-major kernel) leaves (reference `lllaplace.py:179-208`);
        any other head runs the whole network under each sample."""
        if self._head_kind != "dense":
            return ParametricLaplace._nn_functional_samples(self, x, n_samples, generator)
        _, phi = self._features(x)
        samples = self.sample(n_samples, generator=generator)
        d, k = next(s.shape for s in self.model.leaf_specs if s.path[-1] == "kernel")
        bias, W = ((samples[:, :k], samples[:, k:]) if self._has_bias()
                   else (None, samples))
        fs = torch.einsum("...d,sdk->s...k", phi, W.reshape(-1, d, k))
        if bias is not None:
            fs = fs + bias.reshape((-1,) + (1,) * (fs.ndim - 2) + (k,))
        return fs if self.enable_backprop else fs.detach()

    # ---- serialization
    def state_dict(self) -> dict:
        """The parametric state with the probe `data` and `_last_layer_name`
        (the JAX package's `lllaplace.py:222-226`)."""
        return dict(super().state_dict(), data=self.data,
                    _last_layer_name=flax_module_name(self._last_layer_name))

    def load_state_dict(self, state_dict: dict) -> None:
        """Load the state. With no probe yet, take the saved one: it finds
        the head when there is none, and gives the head its kind (the JAX
        package's `lllaplace.py:228-245`, which restores the probe only to
        find a head)."""
        if "_last_layer_name" not in state_dict:
            raise ValueError("Loading a wrong Laplace type. Make sure `subset_of_weights` "
                             "and `hessian_structure` are correct!")
        if flax_module_name(self._last_layer_name) != state_dict["_last_layer_name"]:
            raise ValueError("Different `last_layer_name` detected!")
        data = state_dict["data"]
        if data is not None and self.data is None:
            self.data = self._tensor(data)
            self._set_last_layer(self.last_layer_path
                                 or self._full_model.find_last_layer(self.data))
        super().load_state_dict(state_dict)
        self.n_params = self.model.n_params
        self.n_layers = self.model.n_layers


class FullLLLaplace(LLLaplace, FullLaplace):
    """Dense last-layer posterior (reference `lllaplace.py:371-380`)."""

    _key = ("last_layer", "full")


class KronLLLaplace(LLLaplace, KronLaplace):
    """KFAC last-layer posterior (reference `lllaplace.py:383-476`)."""

    _key = ("last_layer", "kron")

    def _set_last_layer(self, path: tuple) -> None:
        """As `LLLaplace._set_last_layer`, for a head the KFAC taps cover: a
        Dense, a conv (1-, 2- or 3-d, grouped, circular or masked), a
        DenseGeneral, an Einsum or an Embed. A norm head raises
        `NoKFACHead`."""
        head = self._full_model.module.get_submodule(".".join(path))
        if layer_kind(head) == "norm":
            raise NoKFACHead(
                f"KronLLLaplace on a {type(head).__name__} head {path}: no Dense/Conv layer "
                "is intercepted for KFAC there, and the JAX package refuses this head too, "
                "under every kron_unsupported policy (ROADMAP.md §1 item 3). Use "
                "FullLLLaplace or DiagLLLaplace.")
        super()._set_last_layer(path)

    def functional_variance_fast(self, x):
        """Diagonal output variance in the Kron eigenbasis, without the
        Jacobians (the JAX package's `lllaplace.py:286-322`; the reference
        stubs it). With the kernel group's posterior precision
        `(QA⊗QB) D (QA⊗QB)ᵀ`:

        ``var[b, c] = Σ_ij (QAᵀφ_b)_i² QB[c, j]² / D_ij + var_bias[c]``

        A non-Dense head takes the Jacobian route.
        """
        if self._head_kind != "dense":
            return LLLaplace.functional_variance_fast(self, x)
        f_mu, phi = self._features(x)
        pp = self.posterior_precision
        has_bias = self._has_bias()
        gi = 1 if has_bias else 0  # the bias group comes first
        (QA, QB), (lA, lB) = pp.eigenvectors[gi], pp.eigenvalues[gi]
        Dinv = 1.0 / pp._group_eig((lA, lB), pp.deltas[gi], 1.0)
        f_var = torch.einsum("bi,cj,ij->bc", (phi @ QA) ** 2, QB ** 2, Dinv)
        if has_bias:
            Qb, lb = pp.eigenvectors[0][0], pp.eigenvalues[0][0]
            f_var = f_var + torch.einsum("cj,j->c", Qb ** 2, 1.0 / (lb + pp.deltas[0]))[None]
        return f_mu, f_var


class DiagLLLaplace(LLLaplace, DiagLaplace):
    """Diagonal last-layer posterior (reference `lllaplace.py:479-506`)."""

    _key = ("last_layer", "diag")

    def functional_variance_fast(self, x):
        """Diagonal output variance φ²·σ²_W + σ²_b, without the Jacobians
        (reference `lllaplace.py:489-506`); the kernel leaf is input-major
        (d, k) after the bias. A non-Dense head takes the Jacobian route."""
        if self._head_kind != "dense":
            return LLLaplace.functional_variance_fast(self, x)
        f_mu, phi = self._features(x)
        k = f_mu.shape[-1]
        d = phi.shape[-1]
        var = self.posterior_variance
        offset = k if self._has_bias() else 0
        f_var = torch.einsum("bd,dk,bd->bk", phi, var[offset:offset + d * k].reshape(d, k), phi)
        if offset:
            f_var = f_var + var[:k][None]
        return f_mu, f_var
