"""The port's links, sampling and backprop against the JAX package in
float64 on the MLP twin (3 -> 8 -> C, tanh; N = 16, batch 8).

- The bridge and bridge_norm links, and the MC link from the same
  standard-normal draws (the JAX draws are fed into the port's sampling
  code in place of its own generator, as `tests/test_torch_lllaplace.py`
  does for the GLM samples), for Kron, Full and Diag, all-weights and
  last-layer.
- `functional_samples` and `predictive_samples`, GLM and NN, and
  `sample` (for Kron the posterior's `bmm` with exponent -1/2) from the
  same draws.
- The generator semantics of `tests/test_prng.py`: calls without a
  generator advance the instance's own (seeded 0), a given generator
  reproduces.
- `enable_backprop`: the gradients of the GLM predictive in the input
  against JAX's (`tests/test_backprop_predictive.py`).

Tolerance: 1e-9 relative to the largest entry of the JAX value; class
probabilities 1e-9 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import laplace_jax_torch.baselaplace as tbase
from laplace_jax import Laplace as JaxLaplace
from laplace_jax.models.mlp import MLP as JaxMLP
from laplace_jax.nnmodel import NNModel as JaxNNModel
from laplace_jax.utils.data import ArrayLoader as JaxLoader
from laplace_jax_torch import Laplace
from laplace_jax_torch.models.mlp import MLP
from laplace_jax_torch.models.resnet import state_dict_from_flax
from laplace_jax_torch.utils.data import ArrayLoader
from laplace_jax_torch.utils.linalg import normal_samples_from

torch.set_num_threads(1)

N, BATCH, S = 16, 8, 5
REL = 1e-9
FLAVORS = [(sub, hs) for sub in ("all", "last_layer") for hs in ("kron", "full", "diag")]


def _close(got, ref, rel=REL):
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-300))


def _models(out_dim, seed):
    jm = JaxMLP(hidden=(8,), out_dim=out_dim, dtype=jnp.float64)
    params = jm.init(jax.random.key(seed), jnp.ones((1, 3)))
    tm = MLP(3, (8,), out_dim).double()
    tm.load_state_dict(state_dict_from_flax(params, tm))
    return jm, params, tm


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return dict(X=rng.standard_normal((N, 3)), yc=rng.integers(0, 3, N),
                yr=rng.standard_normal((N, 2)))


def _fit(data, likelihood, sub, hs, **kw):
    out_dim = 3 if likelihood == "classification" else 2
    jm, params, tm = _models(out_dim, 1)
    y = data["yc"] if likelihood == "classification" else data["yr"]
    jla = JaxLaplace(JaxNNModel.from_flax(jm, params), likelihood, subset_of_weights=sub,
                     hessian_structure=hs, **kw)
    tla = Laplace(tm, likelihood, sub, hs, device="cpu", **kw)
    jla.fit(JaxLoader(data["X"], y, batch_size=BATCH))
    tla.fit(ArrayLoader(data["X"], y, batch_size=BATCH))
    return jla, tla


@pytest.fixture(scope="module", params=FLAVORS, ids=lambda p: "-".join(p))
def cls(request, data):
    return _fit(data, "classification", *request.param, prior_precision=0.5)


@pytest.mark.parametrize("link", ["bridge", "bridge_norm"])
def test_bridge_links_match(cls, data, link):
    jla, tla = cls
    X = data["X"][:4]
    ref = jla(jnp.asarray(X), link_approx=link)
    got = tla(X, link_approx=link)
    _close(got, ref)
    torch.testing.assert_close(got.sum(-1), torch.ones(4, dtype=got.dtype), rtol=0, atol=1e-12)


def _jax_draws(key, shape):
    return torch.as_tensor(np.array(jax.random.normal(key, shape, dtype=jnp.float64)))


@pytest.fixture
def feed_draws(monkeypatch):
    """Make the port's `normal_samples` use the given (dim, n) draws."""
    def feed(randn):
        monkeypatch.setattr(tbase, "normal_samples",
                            lambda mean, var, n, generator=None: normal_samples_from(mean, var, randn))
    return feed


@pytest.mark.parametrize("diagonal_output", [False, True])
def test_mc_link_from_the_same_draws(cls, data, feed_draws, diagonal_output):
    jla, tla = cls
    X, key = data["X"][:4], jax.random.key(7)
    ref = jla(jnp.asarray(X), link_approx="mc", n_samples=S, key=key,
              diagonal_output=diagonal_output)
    feed_draws(_jax_draws(key, (3, S)))
    got = tla(X, link_approx="mc", n_samples=S, diagonal_output=diagonal_output)
    _close(got, ref)


def test_glm_functional_and_predictive_samples_from_the_same_draws(cls, data, feed_draws):
    jla, tla = cls
    X, key = data["X"][:4], jax.random.key(8)
    feed_draws(_jax_draws(key, (3, S)))
    _close(tla.functional_samples(X, n_samples=S),
           jla.functional_samples(jnp.asarray(X), n_samples=S, key=key))
    _close(tla.predictive_samples(X, n_samples=S),
           jla.predictive_samples(jnp.asarray(X), n_samples=S, key=key))


@pytest.fixture
def feed_eps(monkeypatch):
    """Make `tla.sample` return the posterior samples of the given draws."""
    def feed(tla, eps):
        monkeypatch.setattr(tla, "sample",
                            lambda n_samples=100, generator=None: tla._samples_from(eps))
    return feed


def test_sample_from_the_same_eps(cls):
    """`sample` is mean + (posterior precision)^{-1/2} eps: for Kron the
    decomposed posterior's `bmm` with exponent -1/2."""
    jla, tla = cls
    key = jax.random.key(9)
    eps = _jax_draws(key, (S, jla.n_params))
    _close(tla._samples_from(eps), jla.sample(S, key=key))


@pytest.mark.parametrize("kind", ["functional", "predictive", "call"])
def test_nn_samples_from_the_same_eps(cls, data, feed_eps, kind):
    jla, tla = cls
    X, key = data["X"][:4], jax.random.key(10)
    feed_eps(tla, _jax_draws(key, (S, jla.n_params)))
    if kind == "functional":
        ref = jla.functional_samples(jnp.asarray(X), pred_type="nn", n_samples=S, key=key)
        got = tla.functional_samples(X, pred_type="nn", n_samples=S)
    elif kind == "predictive":
        ref = jla.predictive_samples(jnp.asarray(X), pred_type="nn", n_samples=S, key=key)
        got = tla.predictive_samples(X, pred_type="nn", n_samples=S)
    else:
        ref = jla(jnp.asarray(X), pred_type="nn", link_approx="mc", n_samples=S, key=key)
        got = tla(X, pred_type="nn", link_approx="mc", n_samples=S)
    _close(got, ref)


def test_regression_nn_predictive_from_the_same_eps(data, feed_eps):
    jla, tla = _fit(data, "regression", "all", "kron", sigma_noise=0.5)
    X, key = data["X"][:4], jax.random.key(11)
    feed_eps(tla, _jax_draws(key, (S, jla.n_params)))
    (m_j, v_j), (m_t, v_t) = (jla(jnp.asarray(X), pred_type="nn", link_approx="mc", n_samples=S,
                                  key=key),
                              tla(X, pred_type="nn", link_approx="mc", n_samples=S))
    _close(m_t, m_j)
    _close(v_t, v_j)


def test_invalid_options_raise(cls, data):
    _, tla = cls
    X = data["X"][:2]
    with pytest.raises(ValueError, match="glm and nn"):
        tla(X, pred_type="bogus")
    with pytest.raises(ValueError, match="link approximation"):
        tla(X, link_approx="bogus")
    with pytest.raises(ValueError, match="mc link"):
        tla(X, pred_type="nn", link_approx="probit")


# ---- generator semantics (tests/test_prng.py)

@pytest.fixture(scope="module", params=["kron", "full", "diag"])
def fitted_all(request, data):
    return _fit(data, "classification", "all", request.param)[1]


def test_sample_without_generator_advances(fitted_all):
    s1, s2 = fitted_all.sample(5), fitted_all.sample(5)
    assert not torch.allclose(s1, s2)


def test_given_generator_reproduces(fitted_all):
    g = lambda: torch.Generator().manual_seed(42)  # noqa: E731
    torch.testing.assert_close(fitted_all.sample(5, generator=g()), fitted_all.sample(5, generator=g()),
                               rtol=0, atol=0)


def test_instance_generator_is_seeded_zero(data):
    """Two fresh instances draw the same first samples, and the same as
    a generator seeded 0 given explicitly."""
    a = _fit(data, "classification", "all", "diag")[1]
    b = _fit(data, "classification", "all", "diag")[1]
    torch.testing.assert_close(a.sample(4), b.sample(4), rtol=0, atol=0)
    torch.testing.assert_close(b.sample(4, generator=torch.Generator().manual_seed(0)),
                               a.sample(4, generator=torch.Generator().manual_seed(0)))
    c = _fit(data, "classification", "all", "diag")[1]
    torch.testing.assert_close(c.sample(4), a.sample(4, generator=torch.Generator().manual_seed(0)),
                               rtol=0, atol=0)
    torch.testing.assert_close(a.H, b.H, rtol=0, atol=0)  # the fit draws nothing


@pytest.mark.parametrize("call", ["predictive_samples", "mc", "nn", "functional_samples"])
def test_calls_without_generator_advance(fitted_all, data, call):
    X = data["X"][:4]
    run = {"predictive_samples": lambda **k: fitted_all.predictive_samples(X, n_samples=7, **k),
           "mc": lambda **k: fitted_all(X, link_approx="mc", n_samples=11, **k),
           "nn": lambda **k: fitted_all(X, pred_type="nn", link_approx="mc", n_samples=5, **k),
           "functional_samples": lambda **k: fitted_all.functional_samples(X, n_samples=9, **k)}[call]
    assert not torch.allclose(run(), run())
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    torch.testing.assert_close(run(generator=g()), run(generator=g()), rtol=0, atol=0)


def test_last_layer_nn_samples_advance(cls, data):
    _, tla = cls
    X = data["X"][:4]
    a = tla.predictive_samples(X, pred_type="nn", n_samples=5)
    b = tla.predictive_samples(X, pred_type="nn", n_samples=5)
    assert not torch.allclose(a, b)


# ---- enable_backprop (tests/test_backprop_predictive.py)

@pytest.fixture(scope="module", params=[("all", "full"), ("all", "kron"), ("all", "diag"),
                                        ("last_layer", "full")], ids=lambda p: "-".join(p))
def backprop(request, data):
    return _fit(data, "regression", *request.param, enable_backprop=True, sigma_noise=0.8)


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("joint", [False, True])
def test_glm_predictive_gradient_in_the_input_matches(backprop, data, which, joint):
    jla, tla = backprop
    X = data["X"][:3]
    ref = jax.grad(lambda x: jnp.sum(jla(x, pred_type="glm", joint=joint)[which]))(jnp.asarray(X))
    x = torch.tensor(X, requires_grad=True)
    tla(x, pred_type="glm", joint=joint)[which].sum().backward()
    assert float(x.grad.abs().max()) > 0
    _close(x.grad, ref)


def test_without_enable_backprop_the_predictive_is_detached(data):
    _, tla = _fit(data, "regression", "all", "full")
    f_mu, f_var = tla(torch.tensor(data["X"][:3], requires_grad=True))
    assert not f_mu.requires_grad and not f_var.requires_grad
    assert not tla.mean.requires_grad
