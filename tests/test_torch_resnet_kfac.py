"""The port's ResNet-18, im2col, KFAC factors and `KronLaplace` against the
JAX package, end to end on a narrow ResNet-18 (width 8) in float64.

Weights are carried over from the flax model (`state_dict_from_flax`); the
same numpy inputs go to both packages. Tolerances: forward 1e-10 and
patches 1e-12 (the same arithmetic up to summation order); every KFAC
factor 1e-9 relative to its largest entry; eigenvalues 1e-9 relative to the
largest; log marginal likelihood 1e-8 relative; the prior precision after
20 marglik Adam steps 1e-6 relative (optax and torch Adam round their
updates differently); the GLM probit predictive 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_jax import KronLaplace as JaxKronLaplace
from laplace_jax.models import ResNet18 as JaxResNet18
from laplace_jax.nnmodel import NNModel as JaxNNModel
from laplace_jax.ops.im2col import im2col as jax_im2col
from laplace_jax.utils.data import ArrayLoader as JaxLoader
from laplace_jax.utils.flatten import tree_to_vector
from laplace_jax_torch import KronLaplace, Laplace, LowRankLaplace
from laplace_jax_torch.models.resnet import ResNet18, state_dict_from_flax
from laplace_jax_torch.ops.im2col import im2col
from laplace_jax_torch.utils.data import ArrayLoader
from laplace_jax_torch.utils.flatten import leaf_specs, parameters_to_vector

# several test workers share the CPU: one intra-op thread each
torch.set_num_threads(1)

N, BATCH = 16, 8


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, 16, 16, 3))
    y = rng.integers(0, 10, N)
    jm = JaxResNet18(width=8, dtype=jnp.float64)
    params = jm.init(jax.random.key(0), jnp.asarray(X[:1]))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
    tm = ResNet18(width=8).double()
    tm.load_state_dict(state_dict_from_flax(params, tm))
    return dict(X=X, y=y, jm=jm, params=params, tm=tm)


@pytest.fixture(scope="module")
def fitted(pair):
    """Both packages' KronLaplace, fitted, tuned 20 marglik steps, and
    their predictives, each stage recorded as it goes."""
    X, y = pair["X"], pair["y"]
    jla = JaxKronLaplace(JaxNNModel.from_flax(pair["jm"], pair["params"]), "classification")
    jla.fit(JaxLoader(X, y, batch_size=BATCH))
    tla = KronLaplace(pair["tm"], "classification", device="cpu")
    tla.fit(ArrayLoader(X, y, batch_size=BATCH))
    out = dict(jla=jla, tla=tla,
               lml=(float(jla.log_marginal_likelihood()), float(tla.log_marginal_likelihood())))
    jla.optimize_prior_precision(n_steps=20)
    tla.optimize_prior_precision(n_steps=20)
    out["pp"] = (np.asarray(jla.prior_precision), tla.prior_precision.numpy())
    out["pred"] = (np.asarray(jla(jnp.asarray(X[:4]))), tla(X[:4]).numpy())
    return out


def test_forward_matches_flax(pair):
    f_j = np.asarray(pair["jm"].apply(pair["params"], jnp.asarray(pair["X"])))
    f_t = pair["tm"](torch.as_tensor(pair["X"])).detach().numpy()
    np.testing.assert_allclose(f_t, f_j, rtol=0, atol=1e-10)


def test_flatten_order_and_mean_vector_match(pair):
    specs = leaf_specs(pair["tm"])
    paths = [s.path for s in specs]
    assert paths == sorted(paths) and paths[:3] == [
        ("Conv_0", "kernel"), ("Dense_0", "bias"), ("Dense_0", "kernel")]
    np.testing.assert_array_equal(parameters_to_vector(pair["tm"]).numpy(),
                                  np.asarray(tree_to_vector(pair["params"])))


@pytest.mark.parametrize("ksize,stride,hw", [(3, 1, 8), (3, 2, 8), (1, 2, 8), (3, 2, 7)])
def test_im2col_matches_jax(ksize, stride, hw):
    x = np.random.default_rng(1).standard_normal((2, hw, hw, 5))
    ref = np.asarray(jax_im2col(jnp.asarray(x), (ksize, ksize), (stride, stride), "SAME"))
    got = im2col(torch.as_tensor(x), (ksize, ksize), (stride, stride), "SAME").numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def test_kfac_factors_match(fitted):
    jf, tf = fitted["jla"].H_facs.kfacs, fitted["tla"].H_facs.kfacs
    assert [len(F) for F in jf] == [len(F) for F in tf]
    for Fj, Ft in zip(jf, tf):
        for a, b in zip(Fj, Ft):
            a = np.asarray(a)
            np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-9 * np.abs(a).max())


def test_eigenvalues_match(fitted):
    lj = np.asarray(fitted["jla"].H._flat_eigs)
    lt = fitted["tla"].H._flat_eigs.numpy()
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-9 * np.abs(lj).max())


def test_log_marginal_likelihood_matches(fitted):
    ref, got = fitted["lml"]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, ref, rtol=1e-8)


def test_marglik_prior_tuning_matches(fitted):
    ref, got = fitted["pp"]
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_glm_probit_predictive_matches(fitted):
    ref, got = fitted["pred"]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-12)


def test_layerwise_prior_marglik_matches(fitted):
    """A per-layer prior (one value per leaf, flax leaf order) gives the
    same marglik in both packages."""
    jla, tla = fitted["jla"], fitted["tla"]
    pp = np.linspace(0.5, 2.0, tla.n_layers)
    ref = float(jla.log_marginal_likelihood(jnp.asarray(pp)))
    got = float(tla.log_marginal_likelihood(pp))
    np.testing.assert_allclose(got, ref, rtol=1e-8)


def test_layerwise_prior_tuning_matches(fitted):
    jla, tla = fitted["jla"], fitted["tla"]
    jla.optimize_prior_precision(n_steps=5, prior_structure="layerwise")
    tla.optimize_prior_precision(n_steps=5, prior_structure="layerwise")
    np.testing.assert_allclose(tla.prior_precision.numpy(), np.asarray(jla.prior_precision),
                               rtol=1e-6)


@pytest.mark.parametrize("exponent", [-1, -0.5])
def test_posterior_bmm_matches(fitted, exponent):
    jla, tla = fitted["jla"], fitted["tla"]
    W = np.random.default_rng(3).standard_normal((1, 2, tla.n_params))
    ref = np.asarray(jla.posterior_precision.bmm(jnp.asarray(W), exponent=exponent))
    got = tla.posterior_precision.bmm(torch.as_tensor(W), exponent=exponent).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9 * np.abs(ref).max())


def test_damped_marglik_matches(fitted):
    jla, tla = fitted["jla"], fitted["tla"]
    jla.damping = jla.H.damping = True
    tla.damping = tla.H.damping = True
    ref, got = float(jla.log_marginal_likelihood()), float(tla.log_marginal_likelihood())
    np.testing.assert_allclose(got, ref, rtol=1e-8)


def test_online_fit_rescales_activation_factor(pair):
    """Two fits on the halves merge to the one fit on the whole (the A
    factors carry 1/N and are N-rescaled; B factors add)."""
    X, y = pair["X"], pair["y"]
    whole = KronLaplace(pair["tm"], "classification", device="cpu")
    whole.fit(ArrayLoader(X, y, batch_size=BATCH))
    online = KronLaplace(pair["tm"], "classification", device="cpu")
    online.fit(ArrayLoader(X[:8], y[:8], batch_size=BATCH))
    online.fit(ArrayLoader(X[8:], y[8:], batch_size=BATCH), override=False)
    assert online.n_data == N
    for Fw, Fo in zip(whole.H_facs.kfacs, online.H_facs.kfacs):
        for a, b in zip(Fw, Fo):
            torch.testing.assert_close(b, a, atol=1e-10 * float(a.abs().max()), rtol=0)
    torch.testing.assert_close(online.log_marginal_likelihood(),
                               whole.log_marginal_likelihood(), rtol=1e-10, atol=0)


def test_factory_and_device_rule(pair):
    la = Laplace(pair["tm"], "classification", "all", "kron", device="cpu")
    assert isinstance(la, KronLaplace)
    assert isinstance(Laplace(pair["tm"], "classification", "all", "lowrank", device="cpu"),
                      LowRankLaplace)
    with pytest.raises(ValueError, match="not ported"):
        Laplace(pair["tm"], "classification", "subnetwork", "kron", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            KronLaplace(pair["tm"], "classification")
