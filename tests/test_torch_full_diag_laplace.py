"""The port's all-weights `FullLaplace` and `DiagLaplace` against the JAX
package on ResNet-18 at width 1 (P = 2841, so the dense H is 65 MB in
float64), 16x16 inputs, N = 16, batch 8, float64.

Weights are carried over from the flax model (`state_dict_from_flax`).
Tolerances as in `test_torch_lllaplace.py`: curvature 1e-9 relative to its
largest entry, eigenvalues and the posterior covariance 1e-9 relative, log
marginal likelihood 1e-8 relative, the prior precision after 10 marglik
Adam steps 1e-6 relative (10, not 20: each step is a float64 slogdet of
the 2841 x 2841 precision and its gradient on one CPU thread), the probit
predictive 1e-8, GLM predictive samples from the same draws 1e-10.

The JAX `DiagLaplace` takes its layer-tap diagonal here
(`curvature/diag_taps.py`); the port takes the diagonal of the Jacobian
GGN. The two compute the same diagonal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_jax import DiagLaplace as JaxDiagLaplace
from laplace_jax import FullLaplace as JaxFullLaplace
from laplace_jax.models import ResNet18 as JaxResNet18
from laplace_jax.nnmodel import NNModel as JaxNNModel
from laplace_jax.utils.data import ArrayLoader as JaxLoader
from laplace_jax_torch import DiagLaplace, FullLaplace
from laplace_jax_torch.models.resnet import ResNet18, state_dict_from_flax
from laplace_jax_torch.utils.data import ArrayLoader
from laplace_jax_torch.utils.linalg import normal_samples_from

# several test workers share the CPU: one intra-op thread each
torch.set_num_threads(1)

N, BATCH, P = 16, 8, 2841
FLAVORS = {"full": (JaxFullLaplace, FullLaplace), "diag": (JaxDiagLaplace, DiagLaplace)}


def _close(got, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=rel * np.abs(ref).max())


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(1)
    X = rng.standard_normal((N, 16, 16, 3))
    y = rng.integers(0, 10, N)
    jm = JaxResNet18(width=1, dtype=jnp.float64)
    params = jm.init(jax.random.key(1), jnp.asarray(X[:1]))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
    tm = ResNet18(width=1).double()
    tm.load_state_dict(state_dict_from_flax(params, tm))
    return dict(X=X, y=y, jm=jm, params=params, tm=tm)


@pytest.fixture(scope="module", params=sorted(FLAVORS))
def fitted(request, pair):
    X, y = pair["X"], pair["y"]
    jcls, tcls = FLAVORS[request.param]
    jla = jcls(JaxNNModel.from_flax(pair["jm"], pair["params"]), "classification")
    tla = tcls(pair["tm"], "classification", device="cpu")
    jla.fit(JaxLoader(X, y, batch_size=BATCH))
    tla.fit(ArrayLoader(X, y, batch_size=BATCH))
    out = dict(kind=request.param, jla=jla, tla=tla,
               lml=(float(jla.log_marginal_likelihood()), float(tla.log_marginal_likelihood())),
               pred=(np.asarray(jla(jnp.asarray(X[:4]))), tla(X[:4]).numpy()))
    jla.optimize_prior_precision(n_steps=10)
    tla.optimize_prior_precision(n_steps=10)
    out["pp"] = (np.asarray(jla.prior_precision), tla.prior_precision.numpy())
    return out


def test_curvature_matches(fitted):
    jla, tla = fitted["jla"], fitted["tla"]
    assert tla.n_params == P == jla.n_params
    assert tuple(tla.H.shape) == tuple(jla.H.shape)
    _close(tla.H.numpy(), jla.H, 1e-9)


def test_posterior_matches(fitted):
    """Full: the spectrum of the posterior precision and the posterior
    covariance (Cholesky-based `invsqrt_precision`); Diag: the variances."""
    jla, tla = fitted["jla"], fitted["tla"]
    if fitted["kind"] == "full":
        _close(torch.linalg.eigvalsh(tla.posterior_precision).numpy(),
               np.linalg.eigvalsh(np.asarray(jla.posterior_precision)), 1e-9)
        _close(tla.posterior_covariance.numpy(), jla.posterior_covariance, 1e-9)
    else:
        _close(tla.posterior_variance.numpy(), jla.posterior_variance, 1e-9)


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


def test_glm_predictive_samples_from_same_draws(fitted, pair):
    jla, tla = fitted["jla"], fitted["tla"]
    X, S = pair["X"][:3], 6
    key = jax.random.key(2)
    ref = np.asarray(jla.predictive_samples(jnp.asarray(X), n_samples=S, key=key))
    randn = torch.as_tensor(np.array(jax.random.normal(key, (10, S), dtype=jnp.float64)))
    f_mu, f_var = tla._glm_predictive_distribution(X)
    got = torch.softmax(normal_samples_from(f_mu, f_var, randn), dim=-1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-10)


def test_sample_draws_from_the_posterior_scale(fitted):
    """`sample` is mean + eps S^T (Full) or mean + eps * sigma (Diag) with
    eps from the given generator."""
    tla = fitted["tla"]
    got = tla.sample(3, generator=torch.Generator().manual_seed(4))
    eps = torch.randn(3, P, generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    scale = tla.posterior_scale
    ref = tla.mean + (eps @ scale.mT if scale.ndim == 2 else eps * scale)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-12)


def test_diag_is_the_diagonal_of_full(pair):
    X, y = pair["X"], pair["y"]
    full = FullLaplace(pair["tm"], "classification", device="cpu")
    diag = DiagLaplace(pair["tm"], "classification", device="cpu")
    for la in (full, diag):
        la.fit(ArrayLoader(X, y, batch_size=BATCH))
    _close(diag.H.numpy(), torch.diagonal(full.H).numpy(), 1e-12)


def test_online_fit_adds_curvature(pair):
    """Two fits with `override=False` sum to the one fit on the whole."""
    X, y = pair["X"], pair["y"]
    whole = DiagLaplace(pair["tm"], "classification", device="cpu")
    whole.fit(ArrayLoader(X, y, batch_size=BATCH))
    online = DiagLaplace(pair["tm"], "classification", device="cpu")
    online.fit(ArrayLoader(X[:8], y[:8], batch_size=BATCH))
    online.fit(ArrayLoader(X[8:], y[8:], batch_size=BATCH), override=False)
    assert online.n_data == N
    torch.testing.assert_close(online.H, whole.H, rtol=0, atol=1e-12 * float(whole.H.max()))
    torch.testing.assert_close(online.log_marginal_likelihood(), whole.log_marginal_likelihood(),
                               rtol=1e-10, atol=0)
