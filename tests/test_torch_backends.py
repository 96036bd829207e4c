"""The port's curvature backends against the JAX package's, in float64 on
the CPU: the GGN, its MC estimate, the empirical Fisher and the exact
Hessian, as `full`, `diag` and `kron`, on an MLP and a two-conv net, in
classification and regression; then the `backend=` / `backend_kwargs=`
arguments of every flavor, `Laplace(...)` and `marglik_training`.

The models and data come from `tests/torch_twins.py` (weights carried over
from flax). MC draws are the JAX package's own, from the same keys, fed to
the port through `kfac.mc_draws` (`torch_twins.JaxDraws`).

Oracles mirrored: `tests/test_curvature.py:62` (gradients and EF), `:85`
(full GGN), `:105` (Hessian), `:118` (MC against exact), `:175` (EF KFAC on
one point), `:338` (KFAC with the Hessian raises), and
`tests/test_fit_data_hardening.py:67-115` (the EF chunk size).

Tolerances: H, diagonals and Kron factors 1e-9 relative to their largest
entry; losses 1e-12 relative; log marginal likelihoods 1e-8 relative;
predictives 1e-8 absolute.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_jax import Laplace as JaxLaplace
from laplace_jax.curvature.backend import CurvatureBackend as JaxBackend
from laplace_jax.utils.data import ArrayLoader as JaxLoader
from laplace_jax_torch import FunctionalLaplace, Laplace, marglik_training
from laplace_jax_torch.curvature import kfac
from laplace_jax_torch.curvature.backend import (
    CurvatureBackend,
    EFBackend,
    GGNBackend,
    HessianBackend,
    _default_ef_chunk,
)
from laplace_jax_torch.nnmodel import NNModel
from laplace_jax_torch.utils.data import ArrayLoader

from .torch_twins import (
    JaxDraws,
    classification,
    close,
    conv_pair,
    fit_keys,
    kron_close,
    mlp_pair,
    regression,
)

torch.set_num_threads(1)

MODELS = {"mlp": (mlp_pair, (3,), 2), "conv": (conv_pair, (6, 6, 2), 3)}
CURVS = {"ggn": ("ggn", False), "mc": ("ggn", True), "ef": ("ef", False),
         "hessian": ("hessian", False)}
S = 3  # MC samples a sample


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    make, shape, C = MODELS[request.param]
    jm, tm = make()
    return dict(name=request.param, jm=jm, tm=tm, nnm=NNModel(tm), shape=shape, C=C)


def _data(model, likelihood, n=8, seed=3):
    make = classification if likelihood == "classification" else regression
    return make(n, model["shape"], model["C"], seed)


def _backends(model, likelihood, curv, **kw):
    ct, stoch = CURVS[curv]
    return (JaxBackend(model["jm"], likelihood, ct, stochastic=stoch, num_samples=S, **kw),
            CurvatureBackend(model["nnm"], likelihood, ct, stochastic=stoch, num_samples=S,
                             **kw))


@pytest.mark.parametrize("curv", sorted(CURVS))
@pytest.mark.parametrize("likelihood", ["classification", "regression"])
@pytest.mark.parametrize("structure", ["full", "diag", "kron"])
def test_backend_matches_jax(model, likelihood, curv, structure, monkeypatch):
    """Each curvature type's full, diag and kron against the JAX package's
    on one batch; KFAC with the exact Hessian raises `ValueError` in both."""
    X, y = _data(model, likelihood)
    jb, tb = _backends(model, likelihood, curv)
    key = jax.random.key(5)
    monkeypatch.setattr(kfac, "mc_draws", JaxDraws([key]))
    if structure == "kron" and curv == "hessian":
        with pytest.raises(ValueError, match="KFAC with the exact Hessian"):
            jb.kron(jnp.asarray(X), jnp.asarray(y), N=8)
        with pytest.raises(ValueError, match="KFAC with the exact Hessian"):
            tb.kron(torch.as_tensor(X), torch.as_tensor(y), N=8)
        return
    lj, Hj = jax.jit(lambda a, b: getattr(jb, structure)(a, b, N=8, key=key))(
        jnp.asarray(X), jnp.asarray(y))
    lt, Ht = getattr(tb, structure)(torch.as_tensor(X), torch.as_tensor(y), N=8)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-12)
    if structure == "kron":
        kron_close(Ht, Hj)
    else:
        close(Ht, Hj, 1e-9)


def test_gradients_and_ef_identities(model):
    """`tests/test_curvature.py:62`: the per-sample gradients sum to the
    batch gradient and match the JAX package's; the EF is GᵀG, its diagonal
    the EF diagonal."""
    X, y = _data(model, "classification")
    jb, tb = _backends(model, "classification", "ef")
    Gj, _ = jax.jit(jb.gradients)(jnp.asarray(X), jnp.asarray(y))
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    Gt, loss = tb.gradients(Xt, yt)
    close(Gt, Gj, 1e-9)
    theta = model["nnm"].mean_vector.requires_grad_(True)
    total = tb.lossfunc(model["nnm"].apply_vec(theta, Xt), yt)
    close(Gt.sum(0), torch.autograd.grad(total, theta)[0].numpy(), 1e-9)
    _, H = tb.full(Xt, yt)
    close(H, (Gt.T @ Gt).numpy(), 1e-12)
    _, d = tb.diag(Xt, yt)
    close(d, torch.diagonal(H).numpy(), 1e-12)


@pytest.mark.parametrize("likelihood", ["classification", "regression"])
def test_hessian_is_the_autograd_hessian(model, likelihood):
    """`tests/test_curvature.py:105`: the Hessian backend's H is the factor
    times the Hessian of the summed loss in the flat vector."""
    X, y = _data(model, likelihood)
    _, tb = _backends(model, likelihood, "hessian")
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    _, H = tb.full(Xt, yt)
    nnm = model["nnm"]
    ref = torch.autograd.functional.hessian(
        lambda t: tb.lossfunc(nnm.apply_vec(t, Xt), yt), nnm.mean_vector)
    close(H, (tb.factor * ref).numpy(), 1e-12)
    close(H, H.T.numpy(), 1e-12)


def test_mc_fisher_close_to_exact():
    """`tests/test_curvature.py:118`, with the port's own draws (its
    generator): 600 samples a point put the MC GGN within 25% of the
    exact one."""
    jm, tm = mlp_pair()
    nnm = NNModel(tm)
    X, y = classification(30, (3,), 2, 711)
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    _, H = CurvatureBackend(nnm, "classification").full(Xt, yt)
    _, H_mc = CurvatureBackend(nnm, "classification", stochastic=True, num_samples=600).full(
        Xt, yt, generator=torch.Generator().manual_seed(1))
    assert float(torch.linalg.norm(H - H_mc) / torch.linalg.norm(H)) < 0.25


def test_ef_kfac_single_point_exact(model):
    """`tests/test_curvature.py:175`: the EF KFAC of one point on a Dense
    layer is its EF diagonal."""
    X, y = _data(model, "classification")
    _, tb = _backends(model, "classification", "ef")
    Xt, yt = torch.as_tensor(X[:1]), torch.as_tensor(y[:1])
    _, d = tb.diag(Xt, yt)
    _, kron = tb.kron(Xt, yt, N=1)
    for s in model["nnm"].leaf_specs:
        if s.path[0].startswith("Dense"):
            sl = slice(s.offset, s.offset + s.size)
            close(kron.diag()[sl], d[sl].numpy(), 1e-10)


@pytest.mark.parametrize("mode", ["full", "diag"])
def test_ef_chunk_size_invariance(model, mode):
    """`tests/test_fit_data_hardening.py:67`: the EF does not depend on the
    chunk size (11 inputs: chunks of 1, 3, 11 and the default)."""
    X, y = _data(model, "classification", n=11)
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    out = []
    for chunk in (1, 3, 11, None):
        be = CurvatureBackend(model["nnm"], "classification", "ef", ef_chunk_size=chunk,
                              subnetwork_indices=torch.arange(7) * 3)  # the chunked path
        out.append(getattr(be, mode)(Xt, yt))
    for loss, H in out[1:]:
        np.testing.assert_allclose(float(loss), float(out[0][0]), rtol=1e-12)
        close(H, out[0][1].numpy(), 1e-12)


def test_ef_chunk_kwarg_via_laplace():
    """`tests/test_fit_data_hardening.py:96`: `ef_chunk_size` reaches the
    backend through `backend_kwargs` and leaves H as it is."""
    _, tm = mlp_pair()
    X, y = classification(9, (3,), 2, 711)
    la = Laplace(tm, "classification", "all", "full", backend="ef",
                 backend_kwargs={"ef_chunk_size": 2}, device="cpu")
    la.fit(ArrayLoader(X, y, batch_size=9))
    assert la.backend.ef_chunk_size == 2
    la2 = Laplace(tm, "classification", "all", "full", backend="ef", device="cpu")
    la2.fit(ArrayLoader(X, y, batch_size=9))
    close(la.H, la2.H.numpy(), 1e-12)


def test_backend_argument_validation():
    """`tests/test_fit_data_hardening.py:110` and the JAX constructor's
    checks: the same exception classes and messages."""
    _, tm = mlp_pair()
    nnm = NNModel(tm)
    for kw, match in (({"ef_chunk_size": 0}, "ef_chunk_size"),
                      ({"kron_unsupported": "drop"}, "kron_unsupported"),
                      ({"kron_block_max_params": 0}, "kron_block_max_params"),
                      ({"curv_type": "fisher"}, "curv_type")):
        with pytest.raises(ValueError, match=match):
            CurvatureBackend(nnm, "classification", **kw)
    with pytest.raises(ValueError, match="likelihood"):
        CurvatureBackend(nnm, "reward_modeling")


def test_default_ef_chunk_memory_aware():
    """`tests/test_fit_data_hardening.py:115`."""
    assert _default_ef_chunk(100) == 128
    assert _default_ef_chunk(10**9) == 4
    assert 4 <= _default_ef_chunk(10**6, itemsize=4) <= 128
    assert _default_ef_chunk(10**5) >= _default_ef_chunk(10**7)


# -- the flavors' backend= and backend_kwargs= ------------------------------------

FLAVORS = [("all", "kron"), ("all", "full"), ("all", "diag"), ("last_layer", "kron"),
           ("last_layer", "full"), ("last_layer", "diag")]


def _fit_pair(subset, structure, likelihood, backend, monkeypatch, **kw):
    jm, tm = mlp_pair()
    make = classification if likelihood == "classification" else regression
    X, y = make(12, (3,), 2, 4)
    jla = JaxLaplace(jm, likelihood, subset, structure, backend=backend, **kw)
    tla = Laplace(tm, likelihood, subset, structure, backend=backend, device="cpu", **kw)
    jla.fit(JaxLoader(X, y, batch_size=6))
    monkeypatch.setattr(kfac, "mc_draws", JaxDraws(fit_keys(2)))
    tla.fit(ArrayLoader(X, y, batch_size=6))
    return X, jla, tla


@pytest.mark.parametrize("backend", ["ggn", "mc", "ef", "hessian"])
@pytest.mark.parametrize("subset,structure", FLAVORS)
def test_flavor_backend_matches_jax(subset, structure, backend, monkeypatch):
    """Every parametric flavor with each backend string: H (or the Kron
    factors), the log marginal likelihood and the probit predictive against
    the JAX package's; KFAC with the Hessian raises `ValueError` in both."""
    if structure == "kron" and backend == "hessian":
        jm, tm = mlp_pair()
        X, y = classification(12, (3,), 2, 4)
        for la, loader in ((JaxLaplace(jm, "classification", subset, structure,
                                       backend=backend), JaxLoader(X, y, batch_size=6)),
                           (Laplace(tm, "classification", subset, structure, backend=backend,
                                    device="cpu"), ArrayLoader(X, y, batch_size=6))):
            with pytest.raises(ValueError, match="KFAC with the exact Hessian"):
                la.fit(loader)
        return
    # a prior of 10 keeps the posterior precision positive definite under the
    # (indefinite) Hessian, so the probit's Cholesky exists in both packages
    X, jla, tla = _fit_pair(subset, structure, "classification", backend, monkeypatch,
                            prior_precision=10.0)
    assert tla.backend.curv_type == jla.backend.curv_type
    assert tla.backend.stochastic == jla.backend.stochastic
    if structure == "kron":
        kron_close(tla.H_facs, jla.H_facs)
    else:
        close(tla.H, jla.H, 1e-9)
    np.testing.assert_allclose(float(tla.log_marginal_likelihood()),
                               float(jla.log_marginal_likelihood()), rtol=1e-8)
    close(tla(X[:4]), np.asarray(jla(jnp.asarray(X[:4]))), 1e-8)


@pytest.mark.parametrize("backend", ["mc", "ef", "hessian"])
def test_regression_backend_matches_jax(backend, monkeypatch):
    """FullLaplace in regression: the EF from the summed loss's gradients
    (the reference's factor 2), the MC noise draws, the Hessian; and the
    GLM predictive's mean and variance."""
    # the regression Hessian's residual term reaches -10.9 in its spectrum:
    # a prior of 20 keeps the posterior precision positive definite
    X, jla, tla = _fit_pair("all", "full", "regression", backend, monkeypatch,
                            prior_precision=20.0)
    close(tla.H, jla.H, 1e-9)
    np.testing.assert_allclose(float(tla.log_marginal_likelihood()),
                               float(jla.log_marginal_likelihood()), rtol=1e-8)
    for got, ref in zip(tla(X[:4]), jla(jnp.asarray(X[:4]))):
        close(got, np.asarray(ref), 1e-8)


def test_stochastic_through_backend_kwargs(monkeypatch):
    """`backend_kwargs={"stochastic": True}` turns 'ggn' into the MC
    estimate, and `False` turns 'mc' back, as in the JAX package."""
    _, tla = _fit_pair("all", "full", "classification", "ggn", monkeypatch,
                       backend_kwargs={"stochastic": True, "num_samples": 2})[1:]
    assert tla.backend.stochastic and tla.backend.num_samples == 2
    _, ref = _fit_pair("all", "full", "classification", "mc", monkeypatch,
                       backend_kwargs={"num_samples": 2})[1:]
    close(tla.H, ref.H.numpy(), 0.0)
    _, back = _fit_pair("all", "full", "classification", "mc", monkeypatch,
                        backend_kwargs={"stochastic": False})[1:]
    _, ggn = _fit_pair("all", "full", "classification", "ggn", monkeypatch)[1:]
    assert not back.backend.stochastic
    close(back.H, ggn.H.numpy(), 0.0)


@pytest.mark.parametrize("factory", [GGNBackend, EFBackend, HessianBackend])
def test_factory_backend(factory):
    """A factory `f(model, likelihood, **backend_kwargs)` builds the
    backend; the named factories give the string backends' H."""
    name = {GGNBackend: "ggn", EFBackend: "ef", HessianBackend: "hessian"}[factory]
    _, tm = mlp_pair()
    X, y = classification(12, (3,), 2, 4)
    seen = {}

    def make(model, likelihood, **kw):
        seen.update(kw, likelihood=likelihood)
        return factory(model, likelihood, **kw)

    la = Laplace(tm, "classification", "all", "full", backend=make,
                 backend_kwargs={"ef_chunk_size": 5}, device="cpu")
    la.fit(ArrayLoader(X, y, batch_size=6))
    assert seen == {"ef_chunk_size": 5, "likelihood": "classification"}
    ref = Laplace(tm, "classification", "all", "full", backend=name, device="cpu")
    ref.fit(ArrayLoader(X, y, batch_size=6))
    close(la.H, ref.H.numpy(), 1e-12)


def test_invalid_backend_raises():
    """An unknown string raises `KeyError` and anything else that is not a
    factory `ValueError`, at the backend's first use, as in the JAX
    package; reward modeling builds a classification backend."""
    jm, tm = mlp_pair()
    for bad, exc in (("fisher", KeyError), (3, ValueError)):
        with pytest.raises(exc):
            JaxLaplace(jm, "classification", "all", "diag", backend=bad).backend
        with pytest.raises(exc):
            Laplace(tm, "classification", "all", "diag", backend=bad, device="cpu").backend
    la = Laplace(tm, "reward_modeling", "all", "diag", backend="ef", device="cpu")
    assert la.backend.likelihood == "classification" and la.backend.curv_type == "ef"


def test_last_layer_kwargs_join_the_backend():
    """The head's path, kind and feature reduction join `backend_kwargs`
    (the JAX package's `lllaplace.py:110-115`), and a factory sees them."""
    _, tm = mlp_pair()
    X, y = classification(12, (3,), 2, 4)
    seen = {}

    def make(model, likelihood, **kw):
        seen.update(kw)
        return EFBackend(model, likelihood, **kw)

    la = Laplace(tm, "classification", "last_layer", "kron", backend=make, device="cpu")
    la.fit(ArrayLoader(X, y, batch_size=6))
    assert seen == dict(last_layer=True, last_layer_path=("Dense_1",), last_layer_dense=True,
                        feature_reduction=None)
    assert la.backend.curv_type == "ef" and la.backend.last_layer


@pytest.mark.parametrize("backend", ["ggn", "ef", "mc"])
def test_subnetwork_backends_match_jax(backend, monkeypatch):
    """`FullSubnetLaplace` with the GGN, the EF (gradients in the
    subvector) and the MC GGN against the JAX package's."""
    from laplace_jax.subnetlaplace import FullSubnetLaplace as JaxSubnet
    from laplace_jax_torch import FullSubnetLaplace

    jm, tm = mlp_pair()
    X, y = classification(12, (3,), 2, 4)
    idx = np.array([0, 3, 7, 20, 50, 81])
    jla = JaxSubnet(jm, "classification", idx, backend=backend)
    jla.fit(JaxLoader(X, y, batch_size=6))
    tla = FullSubnetLaplace(tm, "classification", idx, backend=backend, device="cpu")
    monkeypatch.setattr(kfac, "mc_draws", JaxDraws(fit_keys(2)))
    tla.fit(ArrayLoader(X, y, batch_size=6))
    close(tla.H, jla.H, 1e-9)
    np.testing.assert_allclose(float(tla.log_marginal_likelihood()),
                               float(jla.log_marginal_likelihood()), rtol=1e-8)


def test_subnetwork_refuses_the_hessian():
    """`laplace_jax/subnetlaplace.py:40`: `ValueError` in both."""
    from laplace_jax.subnetlaplace import FullSubnetLaplace as JaxSubnet
    from laplace_jax_torch import FullSubnetLaplace

    jm, tm = mlp_pair()
    with pytest.raises(ValueError, match="GGN and EF"):
        JaxSubnet(jm, "classification", np.arange(4), backend="hessian")
    with pytest.raises(ValueError, match="GGN and EF"):
        FullSubnetLaplace(tm, "classification", np.arange(4), backend="hessian", device="cpu")


def test_functional_laplace_takes_the_backend():
    """`FunctionalLaplace` defaults to 'ggn' as the JAX package's and takes
    `backend_kwargs`; the GP reads only its Jacobians, loss and factor."""
    _, tm = mlp_pair()
    X, y = classification(12, (3,), 2, 4)
    gp = FunctionalLaplace(tm, "classification", n_subset=6, backend="ef",
                           backend_kwargs={"ef_chunk_size": 3}, device="cpu")
    assert gp.backend.curv_type == "ef" and gp.backend.ef_chunk_size == 3
    gp.fit(ArrayLoader(X, y, batch_size=6))
    ref = FunctionalLaplace(tm, "classification", n_subset=6, device="cpu")
    assert ref.backend.curv_type == "ggn"
    ref.fit(ArrayLoader(X, y, batch_size=6))
    close(gp(X[:3]), ref(X[:3]).numpy(), 1e-12)


def test_marglik_training_takes_the_backend():
    """`marglik_training(..., backend="ef", backend_kwargs=...)` fits its
    Laplace with that backend."""
    _, tm = mlp_pair()
    X, y = classification(12, (3,), 2, 4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        la, _, margliks, _ = marglik_training(tm, ArrayLoader(X, y, batch_size=6),
                                              "classification", "diag", n_epochs=2,
                                              backend="ef", backend_kwargs={"ef_chunk_size": 2},
                                              device="cpu")
    assert la.backend.curv_type == "ef" and la.backend.ef_chunk_size == 2
    assert all(np.isfinite(margliks))
