"""Last-layer Laplace on heads that are not Dense, and last-layer discovery,
in the port against `laplace_jax` in float64.

- Discovery on the four models of `tests/test_ll_edge_cases.py` (no Dense,
  a 1-D conv head; nothing tapped; a nested head; a Dense followed by
  post-processing): the same head as the JAX package's, or the same error.
- FullLL and DiagLL on a 1-D conv head, a 2-D conv head and a LayerNorm
  head, and KronLL on the two conv heads: H (or the Kron factors), the log
  marginal likelihood and the probit predictive against the JAX package's,
  and the NN predictive's sampled forward on the same posterior samples.
- KronLL on a LayerNorm head, which KFAC cannot factor, raises
  `NoKFACHead` (a `NotImplementedError`); on a DenseGeneral head it fits,
  with the JAX package's Kron factors, marglik and probit.
- FunctionalLL on the same three heads, found or named, takes the
  per-sample Jacobians over the head's leaves. The JAX package's
  FunctionalLL takes φ⊗I on every head, so it is not the reference here:
  in regression with the subset of data equal to all N inputs, the GP's
  predictive covariance equals FullLL's (Woodbury), which is held against
  the JAX package above.

Tolerances: curvature 1e-9 relative to its largest entry, the log marginal
likelihood 1e-9 relative, predictives 1e-9 absolute, sampled forwards 1e-10.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from laplace_jax import DiagLLLaplace as JaxDiagLL
from laplace_jax import FullLLLaplace as JaxFullLL
from laplace_jax import KronLLLaplace as JaxKronLL
from laplace_jax.nnmodel import NNModel as JaxNNModel
from laplace_jax.utils.data import ArrayLoader as JaxLoader
from laplace_jax_torch import (
    DiagLLLaplace,
    FullLLLaplace,
    FunctionalLLLaplace,
    KronLLLaplace,
    Laplace,
)
from laplace_jax_torch.models.flax_layers import DenseGeneral, LayerNorm
from laplace_jax_torch.models.resnet import state_dict_from_flax
from laplace_jax_torch.nnmodel import NNModel
from laplace_jax_torch.utils.data import ArrayLoader

from .test_ll_edge_cases import DenseNotLast, Nested, NoDense, NoTappedLayers

torch.set_num_threads(1)

REL, PRED, SAMPLES = 1e-9, 1e-9, 1e-10
FLAVORS = {"full": (JaxFullLL, FullLLLaplace), "diag": (JaxDiagLL, DiagLLLaplace),
           "kron": (JaxKronLL, KronLLLaplace)}


def _close(got, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=rel * np.abs(ref).max())


# ---- torch twins of the flax models ------------------------------------------
class TNoDense(nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv_0 = nn.Conv1d(3, 4, 2, padding="same")

    def forward(self, x):  # (B, L, C)
        return self.Conv_0(x.transpose(1, 2)).mean(dim=2)


class TNoTapped(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.ones(3, 2, dtype=torch.float64))

    def forward(self, x):
        return (x @ self.w).mean(dim=1)


class TNested(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(3, 8)
        self.Head_0 = nn.Module()
        self.Head_0.Dense_0 = nn.Linear(8, 6)
        self.Head_0.Inner_0 = nn.Module()
        self.Head_0.Inner_0.Dense_0 = nn.Linear(6, 2)

    def forward(self, x):
        h = torch.tanh(self.Head_0.Dense_0(torch.tanh(self.Dense_0(x))))
        return self.Head_0.Inner_0.Dense_0(h)


class TDenseNotLast(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(3, 5)
        self.Dense_1 = nn.Linear(5, 2)

    def forward(self, x):
        return F.log_softmax(self.Dense_1(torch.tanh(self.Dense_0(x))), dim=-1)


class FConvHead(fnn.Module):
    """A 2-D conv head: conv, tanh, a stride-2 conv, the spatial mean."""

    @fnn.compact
    def __call__(self, x):  # (B, 6, 6, 2)
        x = jnp.tanh(fnn.Conv(4, (3, 3))(x))
        return fnn.Conv(3, (2, 2), strides=(2, 2))(x).mean(axis=(1, 2))


class TConvHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv_0 = nn.Conv2d(2, 4, 3, padding=1)
        self.Conv_1 = nn.Conv2d(4, 3, 2, stride=2)

    def forward(self, x):  # NHWC
        h = torch.tanh(self.Conv_0(x.permute(0, 3, 1, 2)))
        return self.Conv_1(h).mean(dim=(2, 3))


class FNormHead(fnn.Module):
    """A LayerNorm head after a 1-D conv and a mean over the sequence."""

    @fnn.compact
    def __call__(self, x):  # (B, L, 3)
        return fnn.LayerNorm()(fnn.Conv(4, (2,))(x).mean(axis=1))


class TNormHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv_0 = nn.Conv1d(3, 4, 2, padding="same")
        self.LayerNorm_0 = LayerNorm(4)

    def forward(self, x):
        return self.LayerNorm_0(self.Conv_0(x.transpose(1, 2)).mean(dim=2))


def _pair(fm, tm, x_shape, n_classes, seed, n=12, noise=0.3):
    """Inputs, labels, float64 flax parameters (with noise, so no leaf is 0
    or 1) and the torch twin loaded with them."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n,) + x_shape)
    y = rng.integers(0, n_classes, size=n)
    params = fm.init(jax.random.key(seed), jnp.asarray(X[:1]))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) + noise * rng.standard_normal(a.shape), params)
    tm = tm.double()
    tm.load_state_dict(state_dict_from_flax(params, tm))
    return X, y, params


HEADS = {  # name: (flax model, torch twin, input shape, classes, head path, head kind)
    "conv1d": (NoDense, TNoDense, (6, 3), 4, ("Conv_0",), "conv"),
    "conv2d": (FConvHead, TConvHead, (6, 6, 2), 3, ("Conv_1",), "conv"),
    "norm": (FNormHead, TNormHead, (6, 3), 4, ("LayerNorm_0",), "norm"),
}


def _head(name):
    fcls, tcls, shape, C, path, kind = HEADS[name]
    fm, tm = fcls(), tcls()
    X, y, params = _pair(fm, tm, shape, C, seed=len(name))
    return dict(name=name, fm=fm, tm=tm, X=X, y=y, params=params, path=path, kind=kind)


@pytest.fixture(scope="module", params=sorted(HEADS))
def head(request):
    return _head(request.param)


def _fit(head, flavor):
    jcls, tcls = FLAVORS[flavor]
    jla = jcls(JaxNNModel.from_flax(head["fm"], head["params"]), "classification")
    jla.fit(JaxLoader(head["X"], head["y"], batch_size=6))
    tla = tcls(head["tm"], "classification", device="cpu")
    tla.fit(ArrayLoader(head["X"], head["y"], batch_size=6))
    return jla, tla


@pytest.mark.parametrize("flavor", ["full", "diag", "kron"])
def test_non_dense_head_against_jax(head, flavor):
    if flavor == "kron" and head["name"] == "norm":
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            KronLLLaplace(head["tm"], "classification", device="cpu").fit(
                ArrayLoader(head["X"], head["y"], batch_size=6))
        return
    jla, tla = _fit(head, flavor)
    assert tla.last_layer_path == jla.last_layer_path == head["path"]
    assert tla._head_kind == jla._head_kind == head["kind"]
    assert not tla.backend.last_layer_dense
    assert tla.n_params == jla.n_params
    if flavor == "kron":
        for Fj, Ft in zip(jla.H_facs.kfacs, tla.H_facs.kfacs):
            for a, b in zip(Fj, Ft):
                _close(b, a, REL)
    else:
        _close(tla.H, jla.H, REL)
    lml_j = float(jla.log_marginal_likelihood())
    assert abs(float(tla.log_marginal_likelihood()) - lml_j) <= REL * abs(lml_j)
    X = head["X"][:5]
    np.testing.assert_allclose(tla(X).numpy(), np.asarray(jla(jnp.asarray(X))), rtol=0, atol=PRED)
    fv_j = jla.functional_variance_fast(jnp.asarray(X))[1]
    _close(tla.functional_variance_fast(X)[1], fv_j, REL)


def test_non_dense_head_nn_samples(head, monkeypatch):
    """The sampled forward of a non-Dense head runs the whole network under
    each posterior sample of the head's leaves: the same samples give the
    JAX package's outputs."""
    jla, tla = _fit(head, "diag")
    S = np.random.default_rng(7).standard_normal((3, tla.n_params))
    monkeypatch.setattr(jla, "sample", lambda n, key=None: jnp.asarray(S))
    monkeypatch.setattr(tla, "sample", lambda n, generator=None: torch.as_tensor(S))
    X = head["X"][:4]
    ref = jla._nn_functional_samples(jnp.asarray(X), 3)
    _close(tla._nn_functional_samples(X, 3), ref, SAMPLES)


@pytest.mark.parametrize("named", [False, True], ids=["found", "named"])
def test_functional_ll_non_dense_head(head, named):
    X = head["X"]
    C = HEADS[head["name"]][3]
    y = np.random.default_rng(1).standard_normal((len(X), C))
    kw = dict(prior_precision=2.0, sigma_noise=0.7, device="cpu")
    if named:
        kw["last_layer_name"] = ".".join(head["path"])
    full = FullLLLaplace(head["tm"], "regression", **kw)
    full.fit(ArrayLoader(X, y, batch_size=6))
    gp = FunctionalLLLaplace(head["tm"], "regression", n_subset=len(X), **kw)
    gp.fit(ArrayLoader(X, y, batch_size=6))
    assert gp.last_layer_path == head["path"] and gp._head_kind == head["kind"]
    assert not gp.backend.last_layer_dense and gp.n_params == full.n_params
    _close(gp._glm_predictive_distribution(X[:5])[1],
           full._glm_predictive_distribution(X[:5])[1], REL)


EDGE = {  # name: (flax model, torch twin, inputs of 10 x (3,) or (6, 3))
    "no_dense": (NoDense, TNoDense, (6, 3)),
    "no_tapped": (NoTappedLayers, TNoTapped, (6, 3)),
    "nested": (Nested, TNested, (3,)),
    "dense_not_last": (DenseNotLast, TDenseNotLast, (3,)),
}


@pytest.mark.parametrize("name", sorted(EDGE))
def test_discovery_matches_jax(name):
    fcls, tcls, shape = EDGE[name]
    fm, tm = fcls(), tcls()
    X, _, params = _pair(fm, tm, shape, 2, seed=3, n=4)
    jnn, tnn = JaxNNModel.from_flax(fm, params), NNModel(tm)
    if name == "no_tapped":
        with pytest.raises(ValueError, match="No Dense layer"):
            jnn.find_last_layer(jnp.asarray(X))
        with pytest.raises(ValueError, match="No Dense layer"):
            tnn.find_last_layer(torch.as_tensor(X))
        with pytest.raises(ValueError, match="No Dense layer"):
            FullLLLaplace(tm, "classification", device="cpu").fit(
                ArrayLoader(X, np.zeros(4, dtype=int), batch_size=2))
        return
    path = jnn.find_last_layer(jnp.asarray(X))
    assert tnn.find_last_layer(torch.as_tensor(X)) == path
    assert tnn.tap_kind(path, torch.as_tensor(X)) == jnn.tap_kind(path, jnp.asarray(X))


@pytest.mark.parametrize("name,flavor,n_params", [("nested", "full", 14),
                                                  ("dense_not_last", "diag", 12)])
def test_dense_edge_models_against_jax(name, flavor, n_params):
    """The nested head and the Dense before post-processing: the same fit
    as the JAX package's, with the closed-form Dense Jacobians."""
    fcls, tcls, shape = EDGE[name]
    fm, tm = fcls(), tcls()
    X, y, params = _pair(fm, tm, shape, 2, seed=5, n=10)
    jla, tla = _fit(dict(fm=fm, tm=tm, X=X, y=y, params=params), flavor)
    assert tla.last_layer_path == jla.last_layer_path and tla.n_params == n_params
    assert tla._head_kind == "dense" and tla.backend.last_layer_dense
    _close(tla.H, jla.H, REL)
    np.testing.assert_allclose(tla(X).numpy(), np.asarray(jla(jnp.asarray(X))), rtol=0, atol=PRED)


@pytest.mark.parametrize("name", ["conv2d", "norm"])
def test_explicit_name_resolves_head_kind(name):
    """With `last_layer_name`, the head's kind comes from the first fit
    batch's probe, kept as `data`."""
    head = _head(name)
    tla = DiagLLLaplace(head["tm"], "classification", last_layer_name=".".join(head["path"]),
                        prior_precision=2.0, device="cpu")
    assert tla._head_kind == "dense" and tla.data is None
    tla.fit(ArrayLoader(head["X"], head["y"], batch_size=6))
    assert tla._head_kind == head["kind"] and not tla.backend.last_layer_dense
    assert tla.data.shape == (1,) + head["X"].shape[1:]
    assert float(tla.prior_precision[0]) == 2.0


class _DGHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.DenseGeneral_0 = DenseGeneral((3,), (2,))

    def forward(self, x):
        return self.DenseGeneral_0(torch.tanh(x))


class _FlaxDGHead(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return fnn.DenseGeneral(2)(jnp.tanh(x))


def test_kron_ll_on_dense_general_head_raises():
    """KronLL on a DenseGeneral head, named and found, fits as the JAX
    package's does: the head's Kron factors, marglik and probit."""
    X = np.random.default_rng(0).standard_normal((4, 3))
    y = np.array([0, 1, 1, 0])
    params = _FlaxDGHead().init(jax.random.key(0), jnp.asarray(X[:1]))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
    net = _DGHead().double()
    net.load_state_dict(state_dict_from_flax(params, net))
    loader = ArrayLoader(X, y, batch_size=2)
    assert NNModel(net).find_last_layer(torch.as_tensor(X)) == ("DenseGeneral_0",)
    jla = JaxKronLL(JaxNNModel.from_flax(_FlaxDGHead(), params), "classification",
                    last_layer_name="DenseGeneral_0")
    jla.fit(JaxLoader(X, y, batch_size=2))
    for la in (KronLLLaplace(net, "classification", last_layer_name="DenseGeneral_0",
                             device="cpu"),
               Laplace(net, "classification", device="cpu")):
        la.fit(loader)
        assert la._head_kind == jla._head_kind == "dense_general" and la.n_params == 8
        for Fj, Ft in zip(jla.H_facs.kfacs, la.H_facs.kfacs):
            for a, b in zip(Ft, Fj):
                _close(a, b, REL)
        np.testing.assert_allclose(float(la.log_marginal_likelihood()),
                                   float(jla.log_marginal_likelihood()), rtol=REL)
        _close(la(X), jla(jnp.asarray(X)), PRED)
    la = Laplace(net, "classification", "last_layer", "full", device="cpu")
    la.fit(loader)
    assert la._head_kind == "dense_general" and la.n_params == 8
    assert torch.isfinite(la(X)).all()
