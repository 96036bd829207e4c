"""The port's `FunctionalLaplace` and `FunctionalLLLaplace` against the JAX
package in float64 on the CPU.

Models: the MLP twin (4 -> 8 -> C, tanh) and the LeNet twin on 12x12x1
inputs (P = 30,391 at C = 3), weights carried over from flax with
`state_dict_from_flax`. Data: N = 64 inputs from a seeded numpy draw, batch
16, an SoD of M = 24 (a batch of 16 and one of 8), C = 3 classes or 2
regression outputs.

Checked against the JAX package: the SoD indices; K_MM, L, mu and
`Sigma_chol`, with and without `independent_outputs`, on the cached and on
the streamed path; the loss; the GP predictive (probit and bridge links,
regression mean and variance, `diagonal_output`, `joint`) and the joint
covariance; the log marginal likelihood at the fitted and a second prior
precision, and its gradient; classification, regression and reward
modeling; the gridsearch's choice and the marglik-tuned prior; function
samples from the same draws; and the error paths of the JAX package's own
tests (`tests/test_functional_laplace.py`, `test_functional_streaming.py`,
`test_functional_unit.py`). The port's streamed fit is also held against
its cached fit.

Tolerance: 1e-9 relative to the largest entry of the JAX value (1e-12 for
the LeNet twin's forward).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import laplace_jax_torch.baselaplace as tbase
import laplace_jax_torch.functional_laplace as tfun
from laplace_jax import Laplace as JaxLaplace
from laplace_jax.models.lenet import LeNet as JaxLeNet
from laplace_jax.models.mlp import MLP as JaxMLP
from laplace_jax.nnmodel import NNModel as JaxNNModel
from laplace_jax.utils.data import ArrayLoader as JaxLoader
from laplace_jax.utils.sod import sod_indices as jax_sod_indices
from laplace_jax_torch import FunctionalLaplace, FunctionalLLLaplace, Laplace
from laplace_jax_torch.models.lenet import LeNet
from laplace_jax_torch.models.mlp import MLP
from laplace_jax_torch.models.resnet import state_dict_from_flax
from laplace_jax_torch.utils.data import ArrayLoader
from laplace_jax_torch.utils.linalg import normal_samples_from
from laplace_jax_torch.utils.sod import sod_indices

torch.set_num_threads(1)

N, BATCH, M = 64, 16, 24
REL = 1e-9
S = 5  # function samples


def _np(x):
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, ref, rel=REL):
    got, ref = _np(got), _np(ref)
    if isinstance(ref, tuple):
        assert isinstance(got, tuple) and len(got) == len(ref)
        for g, r in zip(got, ref):
            _close(g, r, rel)
        return
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-300))


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, 4))
    Xi = rng.standard_normal((N, 12, 12, 1))
    y_cls, y_reg = rng.integers(0, 3, N), rng.standard_normal((N, 2))
    out = {}
    for name, C in (("mlp3", 3), ("mlp2", 2)):
        jm = JaxMLP(hidden=(8,), out_dim=C, dtype=jnp.float64)
        params = _f64(jm.init(jax.random.key(C), jnp.asarray(X[:1])))
        tm = MLP(4, (8,), C).double()
        tm.load_state_dict(state_dict_from_flax(params, tm))
        out[name] = dict(jm=jm, params=params, tm=tm, X=X)
    jm = JaxLeNet(num_classes=3, dtype=jnp.float64)
    params = _f64(jm.init(jax.random.key(5), jnp.asarray(Xi[:1])))
    tm = LeNet(3, 1, 12).double()
    tm.load_state_dict(state_dict_from_flax(params, tm))
    out["lenet"] = dict(jm=jm, params=params, tm=tm, X=Xi)
    out["y"] = {"classification": y_cls, "reward_modeling": y_cls, "regression": y_reg}
    return out


# name: (model, likelihood, subset_of_weights, keyword arguments of both classes)
CONFIGS = {
    "mlp-cls": ("mlp3", "classification", "all", {}),
    "mlp-cls-ind": ("mlp3", "classification", "all", dict(independent_outputs=True)),
    "mlp-cls-stream": ("mlp3", "classification", "all", dict(streaming=True)),
    "mlp-cls-ind-stream": ("mlp3", "classification", "all",
                           dict(independent_outputs=True, streaming=True)),
    "mlp-reg": ("mlp2", "regression", "all", dict(sigma_noise=0.7, prior_mean=0.05)),
    "mlp-reg-stream": ("mlp2", "regression", "all",
                       dict(sigma_noise=0.7, prior_mean=0.05, streaming=True)),
    "mlp-reg-ind": ("mlp2", "regression", "all", dict(sigma_noise=0.7, independent_outputs=True)),
    "mlp-reward": ("mlp3", "reward_modeling", "all", {}),
    "mlp-ll-cls": ("mlp3", "classification", "last_layer", {}),
    "mlp-ll-reg-ind": ("mlp2", "regression", "last_layer",
                       dict(sigma_noise=0.7, independent_outputs=True)),
    "lenet-cls": ("lenet", "classification", "all", {}),
    "lenet-cls-stream": ("lenet", "classification", "all", dict(streaming=True)),
    "lenet-ll-cls-ind": ("lenet", "classification", "last_layer",
                         dict(independent_outputs=True)),
}
# streamed fits held against the cached fit of the same configuration
STREAM_PAIRS = [("mlp-cls-stream", "mlp-cls"), ("mlp-cls-ind-stream", "mlp-cls-ind"),
                ("mlp-reg-stream", "mlp-reg"), ("lenet-cls-stream", "lenet-cls")]


def _pair(models, name, **extra):
    model, lik, sub, kw = CONFIGS[name]
    kw = dict(kw, n_subset=M, **extra)
    m, y = models[model], models["y"][lik]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # multi-output regression, independent
        jla = JaxLaplace(JaxNNModel.from_flax(m["jm"], m["params"]), lik,
                         subset_of_weights=sub, hessian_structure="gp", **kw)
        tla = Laplace(m["tm"], lik, sub, "gp", device="cpu", **kw)
        jla.fit(JaxLoader(m["X"], y, batch_size=BATCH))
        tla.fit(ArrayLoader(m["X"], y, batch_size=BATCH))
    return jla, tla, m["X"][-6:]


@pytest.fixture(scope="module", params=list(CONFIGS))
def fitted(request, models):
    jla, tla, Xt = _pair(models, request.param)
    lik = CONFIGS[request.param][1]
    out = {k: (getattr(jla, k), getattr(tla, k)) for k in ("K_MM", "L", "mu", "Sigma_chol")}
    out["loss"] = (float(jla.loss), float(tla.loss))
    out["pred"] = (jla(jnp.asarray(Xt)), tla(Xt))
    if lik == "classification":
        out["pred_other"] = (jla(jnp.asarray(Xt), link_approx="bridge"),
                             tla(Xt, link_approx="bridge"))
    else:
        out["pred_other"] = (jla(jnp.asarray(Xt), joint=True), tla(Xt, joint=True))
        out["pred_diag"] = (jla(jnp.asarray(Xt), diagonal_output=True),
                            tla(Xt, diagonal_output=True))
    out["fcov"] = (jla.functional_covariance(jla._jacobians(jnp.asarray(Xt))[0]),
                   tla.functional_covariance(tla._jacobians(tla._tensor(Xt))[0]))
    out["lml"] = (float(jla.log_marginal_likelihood()), float(tla.log_marginal_likelihood()))
    pp0, sn0 = np.array([0.8]), np.array(0.9)
    if lik == "regression":
        j_g = jax.grad(lambda p, s: jla.log_marginal_likelihood(p, s), argnums=(0, 1))(
            jnp.asarray(pp0), jnp.asarray(sn0))
        pp, sn = torch.tensor(pp0, requires_grad=True), torch.tensor(sn0, requires_grad=True)
        tla.log_marginal_likelihood(pp, sn).backward()
        out["lml_grad"] = ([np.asarray(g) for g in j_g], [pp.grad.numpy(), sn.grad.numpy()])
    else:
        j_g = jax.grad(lambda p: jla.log_marginal_likelihood(p))(jnp.asarray(pp0))
        pp = torch.tensor(pp0, requires_grad=True)
        tla.log_marginal_likelihood(pp).backward()
        out["lml_grad"] = ([np.asarray(j_g)], [pp.grad.numpy()])
    out["lml_pp3"] = (float(jla.log_marginal_likelihood(3.0)),
                      float(tla.log_marginal_likelihood(3.0)))
    with pytest.warns(UserWarning, match="prior precision has been changed"):
        out["pred_pp3"] = (jla(jnp.asarray(Xt)), tla(Xt))
    out["Sigma_chol_pp3"] = (jla.Sigma_chol, tla.Sigma_chol)
    out["_la"] = (jla, tla)
    return out


QUANTITIES = ["K_MM", "L", "mu", "Sigma_chol", "loss", "pred", "pred_other", "pred_diag",
              "fcov", "lml", "lml_grad", "lml_pp3", "pred_pp3", "Sigma_chol_pp3"]


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_matches_jax(fitted, quantity):
    if quantity not in fitted:
        assert quantity == "pred_diag"  # classification: no diagonal variant of the probit
        return
    ref, got = fitted[quantity]
    if quantity == "lml_grad":
        for g, r in zip(got, ref):
            _close(g, r)
        return
    _close(got, ref)


def test_predictive_shapes_and_paths(fitted):
    jla, tla = fitted["_la"]
    assert (tla.Js_M is None) == (jla.Js_M is None) == bool(tla.streaming)
    C = tla.n_outputs
    K = tla.K_MM
    assert K.shape == ((C, M, M) if tla.independent_outputs else (M * C, M * C))
    _close(K, K.mT, rel=1e-12)
    if tla.likelihood == "classification":
        probs = fitted["pred"][1]
        _close(probs.sum(-1), np.ones(6), rel=1e-12)


@pytest.fixture(scope="module")
def fit_cache():
    return {}


@pytest.mark.parametrize("stream,cached", STREAM_PAIRS, ids=lambda p: str(p))
@pytest.mark.parametrize("quantity", ["K_MM", "mu", "Sigma_chol", "pred", "lml"])
def test_streamed_fit_matches_cached_fit(models, fit_cache, stream, cached, quantity):
    """In both packages, the streamed fit against the cached one."""
    cache = fit_cache
    for name in (stream, cached):
        if name not in cache:
            jla, tla, Xt = _pair(models, name)
            cache[name] = {"K_MM": (jla.K_MM, tla.K_MM), "mu": (jla.mu, tla.mu),
                           "Sigma_chol": (jla.Sigma_chol, tla.Sigma_chol),
                           "pred": (jla(jnp.asarray(Xt)), tla(Xt)),
                           "lml": (float(jla.log_marginal_likelihood()),
                                   float(tla.log_marginal_likelihood()))}
    (j_s, t_s), (j_c, t_c) = cache[stream][quantity], cache[cached][quantity]
    _close(t_s, t_c)
    _close(j_s, j_c)
    _close(t_s, j_c)


@pytest.mark.parametrize("n,m,seed", [(64, 24, 0), (2048, 512, 0), (100, 100, 3), (10, 1, 7)])
def test_sod_indices_equal_jax(n, m, seed):
    np.testing.assert_array_equal(sod_indices(n, m, seed), jax_sod_indices(n, m, seed))


@pytest.mark.parametrize("size,classes", [(12, 3), (28, 10)])
def test_lenet_forward_matches_flax(size, classes):
    X = np.random.default_rng(size).standard_normal((3, size, size, 1))
    jm = JaxLeNet(num_classes=classes, dtype=jnp.float64)
    params = _f64(jm.init(jax.random.key(1), jnp.asarray(X[:1])))
    tm = LeNet(classes, 1, size).double()
    tm.load_state_dict(state_dict_from_flax(params, tm))
    assert [n for n, _ in tm.named_parameters()] == [
        f"{m}.{p}" for m in ("Conv_0", "Conv_1", "Dense_0", "Dense_1", "Dense_2")
        for p in ("weight", "bias")]
    assert sum(p.numel() for p in tm.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(params))
    _close(tm(torch.as_tensor(X)), jm.apply(params, jnp.asarray(X)), rel=1e-12)


def test_bench_shape_takes_the_streamed_path():
    """`bench.py`'s GP phase (LeNet on 28x28x1, M = 512, C = 10, float32):
    the Jacobian cache would be 2.21 GB, above the 1 GiB threshold."""
    P = sum(p.numel() for p in LeNet().parameters())
    assert P == 107786
    assert 512 * 10 * P * 4 > tfun._STREAMING_THRESHOLD_BYTES


def test_auto_streaming_follows_the_threshold(models, monkeypatch):
    """streaming=None streams when the (M, C, P) cache would pass the
    threshold (`tests/test_functional_streaming.py:99`)."""
    m = models["mlp3"]
    loader = ArrayLoader(m["X"], models["y"]["classification"], batch_size=BATCH)
    for threshold, streams in ((1 << 30, False), (1, True)):
        monkeypatch.setattr(tfun, "_STREAMING_THRESHOLD_BYTES", threshold)
        la = FunctionalLaplace(m["tm"], "classification", n_subset=M, device="cpu")
        la.fit(loader)
        assert (la.Js_M is None) == streams


def test_gridsearch_choice_matches_jax(models):
    jla, tla, _ = _pair(models, "mlp-cls")
    rng = np.random.default_rng(11)
    Xv, yv = rng.standard_normal((16, 4)), rng.integers(0, 3, 16)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # each grid value rebuilds Σ
        jla.optimize_prior_precision(method="gridsearch", val_loader=JaxLoader(Xv, yv, 8),
                                     grid_size=9)
        tla.optimize_prior_precision(method="gridsearch", val_loader=ArrayLoader(Xv, yv, 8),
                                     grid_size=9)
    _close(tla.prior_precision, jla.prior_precision, rel=1e-12)
    assert not tla._recompute_Sigma
    _close(tla.Sigma_chol, jla.Sigma_chol)


def test_marglik_tuning_matches_jax(models):
    jla, tla, _ = _pair(models, "mlp-reg")
    for la in (jla, tla):
        with pytest.warns(UserWarning, match="discouraged"):
            la.optimize_prior_precision(method="marglik", n_steps=10)
    _close(tla.prior_precision, jla.prior_precision)
    _close(tla.Sigma_chol, jla.Sigma_chol)


def test_function_samples_from_the_same_draws(models, monkeypatch):
    jla, tla, Xt = _pair(models, "mlp-cls")
    key = jax.random.key(3)
    randn = torch.as_tensor(np.array(jax.random.normal(key, (3, S), dtype=jnp.float64)))
    monkeypatch.setattr(tbase, "normal_samples",
                        lambda mean, var, n, generator=None: normal_samples_from(mean, var, randn))
    _close(tla.functional_samples(Xt, n_samples=S),
           jla.functional_samples(jnp.asarray(Xt), n_samples=S, key=key))
    _close(tla.predictive_samples(Xt, n_samples=S),
           jla.predictive_samples(jnp.asarray(Xt), n_samples=S, key=key))
    _close(tla(Xt, link_approx="mc", n_samples=S),
           jla(jnp.asarray(Xt), link_approx="mc", n_samples=S, key=key))


def _error_case(case, models, pkg):
    """One error path of the JAX package's tests, in `pkg` ('jax' or
    'torch')."""
    m = models["mlp3"]
    X, y = m["X"], models["y"]["classification"]
    if pkg == "jax":
        make = lambda **kw: JaxLaplace(JaxNNModel.from_flax(m["jm"], m["params"]),  # noqa: E731
                                       kw.pop("lik", "classification"), "all", "gp", **kw)
        loader, Xt = JaxLoader(X, y, batch_size=BATCH), jnp.asarray(X[:4])
    else:
        make = lambda **kw: Laplace(m["tm"], kw.pop("lik", "classification"),  # noqa: E731
                                    "all", "gp", device="cpu", **kw)
        loader, Xt = ArrayLoader(X, y, batch_size=BATCH), X[:4]
    if case == "anisotropic_prior":
        make(n_subset=M, prior_precision=np.ones(2))
    elif case == "n_subset_above_n":
        make(n_subset=N + 1).fit(loader)
    elif case == "unfitted_call":
        make(n_subset=M)(Xt)
    else:
        la = make(n_subset=M)
        la.fit(loader)
        if case == "pred_type_glm":
            la(Xt, pred_type="glm")
        elif case == "bad_link":
            la(Xt, link_approx="foo")
        elif case == "tune_pred_type_glm":
            la.optimize_prior_precision(pred_type="glm")
        elif case == "tune_layerwise":
            la.optimize_prior_precision(prior_structure="layerwise")
        elif case == "sigma_noise_classification":
            la.log_marginal_likelihood(sigma_noise=0.5)


ERRORS = {"anisotropic_prior": (ValueError, "isotropic"),
          "n_subset_above_n": (AssertionError, "n_subset"),
          "unfitted_call": (RuntimeError, "not been fitted"),
          "pred_type_glm": (ValueError, "Only gp"),
          "bad_link": (ValueError, "link approximation"),
          "tune_pred_type_glm": (AssertionError, "Only gp"),
          "tune_layerwise": (AssertionError, "isotropic"),
          "sigma_noise_classification": (ValueError, "sigma_noise")}


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("case", list(ERRORS))
def test_error_paths_match_jax(models, case, pkg):
    exc, match = ERRORS[case]
    with pytest.raises(exc, match=match):
        _error_case(case, models, pkg)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_regression_target_dims_checked(models, pkg):
    m = models["mlp2"]
    y = models["y"]["regression"][:, 0]  # (N,) against a (N, 2) output
    if pkg == "jax":
        la = JaxLaplace(JaxNNModel.from_flax(m["jm"], m["params"]), "regression", "all", "gp",
                        n_subset=M)
        loader = JaxLoader(m["X"], y, batch_size=BATCH)
    else:
        la = FunctionalLaplace(m["tm"], "regression", n_subset=M, device="cpu")
        loader = ArrayLoader(m["X"], y, batch_size=BATCH)
    with pytest.raises(ValueError, match="dims"):
        la.fit(loader)


def test_last_layer_found_and_named(models):
    m = models["lenet"]
    la = FunctionalLLLaplace(m["tm"], "classification", n_subset=M, device="cpu")
    assert la.last_layer_path is None
    la.fit(ArrayLoader(m["X"], models["y"]["classification"], batch_size=BATCH))
    assert la.last_layer_path == ("Dense_2",) and la.n_params == 84 * 3 + 3
    named = FunctionalLLLaplace(m["tm"], "classification", n_subset=M,
                                last_layer_name="Dense_2", device="cpu")
    assert named.n_params == la.n_params
