"""The port's regression likelihood against the JAX package in float64, on
the MLP twin (3 -> 8 -> 2, tanh; N = 16, batch 8) and a narrow, shallow
ResNet (two stages of one residual block, width 2, one output, P = 355; 8x8
inputs, N = 16, batch 8), for Kron, Full and Diag, all-weights and
last-layer; and reward modeling on the MLP.

Weights are carried over from the flax models (`state_dict_from_flax`); the
same numpy inputs go to both packages. Checked: the curvature (KFAC factors
or H), the loss, `log_likelihood`, the log marginal likelihood and its
gradient in the prior precision and `sigma_noise`, the GLM predictive
`(f_mu, f_var)` plain, `joint` and `diagonal_output`, `square_norm` and
`log_prob`. Tolerance: 1e-9 relative to the largest entry of the JAX value
(as `tests/test_torch_resnet_kfac.py:97`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_jax import Laplace as JaxLaplace
from laplace_jax.models.resnet import ResNet as JaxResNet
from laplace_jax.models.mlp import MLP as JaxMLP
from laplace_jax.nnmodel import NNModel as JaxNNModel
from laplace_jax.utils.data import ArrayLoader as JaxLoader
from laplace_jax_torch import Laplace
from laplace_jax_torch.models.mlp import MLP
from laplace_jax_torch.models.resnet import ResNet, state_dict_from_flax
from laplace_jax_torch.utils.data import ArrayLoader

# several test workers share the CPU: one intra-op thread each
torch.set_num_threads(1)

N, BATCH = 16, 8
REL = 1e-9
SIGMA, PRIOR = 0.7, 0.5
FLAVORS = [(sub, hs) for sub in ("all", "last_layer") for hs in ("kron", "full", "diag")]


def _close(got, ref, rel=REL):
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-300))


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    out = {}
    X, y = rng.standard_normal((N, 3)), rng.standard_normal((N, 2))
    jm = JaxMLP(hidden=(8,), out_dim=2, dtype=jnp.float64)
    params = jm.init(jax.random.key(0), jnp.asarray(X[:1]))
    tm = MLP(3, (8,), 2).double()
    tm.load_state_dict(state_dict_from_flax(params, tm))
    out["mlp"] = dict(X=X, y=y, jm=jm, params=params, tm=tm)
    X, y = rng.standard_normal((N, 8, 8, 3)), rng.standard_normal((N, 1))
    jm = JaxResNet(stage_sizes=(1, 1), num_classes=1, width=2, dtype=jnp.float64)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                    jm.init(jax.random.key(1), jnp.asarray(X[:1])))
    tm = ResNet((1, 1), num_classes=1, width=2).double()
    tm.load_state_dict(state_dict_from_flax(params, tm))
    out["resnet"] = dict(X=X, y=y, jm=jm, params=params, tm=tm)
    return out


def _pair(m, likelihood, sub, hs, **kw):
    jla = JaxLaplace(JaxNNModel.from_flax(m["jm"], m["params"]), likelihood,
                     subset_of_weights=sub, hessian_structure=hs, **kw)
    tla = Laplace(m["tm"], likelihood, sub, hs, device="cpu", **kw)
    jla.fit(JaxLoader(m["X"], m["y"], batch_size=BATCH))
    tla.fit(ArrayLoader(m["X"], m["y"], batch_size=BATCH))
    return jla, tla


def _curvature(la, kind):
    if kind == "kron":
        return [np.asarray(H) if not torch.is_tensor(H) else H.numpy()
                for F in la.H_facs.kfacs for H in F]
    return [np.asarray(la.H) if not torch.is_tensor(la.H) else la.H.numpy()]


@pytest.fixture(scope="module", params=[(m, *f) for m in ("mlp", "resnet") for f in FLAVORS],
                ids=lambda p: "-".join(p))
def fitted(request, models):
    name, sub, hs = request.param
    m = models[name]
    jla, tla = _pair(m, "regression", sub, hs, sigma_noise=SIGMA, prior_precision=PRIOR)
    Xt = m["X"][:4]
    value = np.asarray(jla.mean) + 0.01 * np.random.default_rng(2).standard_normal(jla.n_params)

    def jgrad(pp, sn):
        return jla.log_marginal_likelihood(pp, sn)

    pp0, sn0 = np.array([0.8]), np.array(0.9)
    j_lml, j_grads = jax.value_and_grad(jgrad, argnums=(0, 1))(jnp.asarray(pp0), jnp.asarray(sn0))
    pp = torch.tensor(pp0, requires_grad=True)
    sn = torch.tensor(sn0, requires_grad=True)
    t_lml = tla.log_marginal_likelihood(pp, sn)
    t_lml.backward()
    out = dict(
        kind=hs, jla=jla, tla=tla,
        curv=(_curvature(jla, hs), _curvature(tla, hs)),
        loss=(float(jla.loss), float(tla.loss)),
        loglik=(float(jla.log_likelihood), float(tla.log_likelihood)),
        lml=(float(jla.log_marginal_likelihood()), float(tla.log_marginal_likelihood())),
        lml_at=(float(j_lml), float(t_lml.detach())),
        grads=([np.asarray(g) for g in j_grads], [pp.grad.numpy(), sn.grad.numpy()]),
        pred=(jla(jnp.asarray(Xt)), tla(Xt)),
        joint=(jla(jnp.asarray(Xt), joint=True), tla(Xt, joint=True)),
        diag=(jla(jnp.asarray(Xt), diagonal_output=True), tla(Xt, diagonal_output=True)),
        square_norm=(float(jla.square_norm(jnp.asarray(value))),
                     float(tla.square_norm(torch.as_tensor(value)))),
        log_prob=([float(jla.log_prob(jnp.asarray(value), normalized=nz)) for nz in (True, False)],
                  [float(tla.log_prob(value, normalized=nz)) for nz in (True, False)]),
    )
    return out


def test_curvature_matches(fitted):
    ref, got = fitted["curv"]
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        _close(g, r)


def test_loss_and_log_likelihood_match(fitted):
    """The ½·SSE loss and the Gaussian log likelihood with its constant."""
    for key in ("loss", "loglik"):
        ref, got = fitted[key]
        np.testing.assert_allclose(got, ref, rtol=REL)
    assert fitted["tla"].n_outputs == fitted["jla"].n_outputs


def test_log_marginal_likelihood_matches(fitted):
    for key in ("lml", "lml_at"):
        ref, got = fitted[key]
        assert np.isfinite(got)
        np.testing.assert_allclose(got, ref, rtol=REL)


def test_marglik_gradient_in_prior_and_noise_matches(fitted):
    (g_pp, g_sn), (t_pp, t_sn) = fitted["grads"]
    _close(t_pp, g_pp)
    _close(t_sn, g_sn)
    # the differentiated arguments were not stored
    assert float(fitted["tla"].sigma_noise) == pytest.approx(SIGMA)


@pytest.mark.parametrize("mode", ["pred", "joint", "diag"])
def test_glm_predictive_matches(fitted, mode):
    (f_j, v_j), (f_t, v_t) = fitted[mode]
    _close(f_t, f_j, 1e-12)
    _close(v_t, v_j)


def test_square_norm_and_log_prob_match(fitted):
    ref, got = fitted["square_norm"]
    np.testing.assert_allclose(got, ref, rtol=REL)
    ref, got = fitted["log_prob"]
    np.testing.assert_allclose(got, ref, rtol=REL)


def test_target_dims_must_match_the_output(models):
    m = models["mlp"]
    la = Laplace(m["tm"], "regression", "all", "diag", device="cpu")
    with pytest.raises(ValueError, match="dims"):
        la.fit(ArrayLoader(m["X"], m["y"][:, 0], batch_size=BATCH))
    with pytest.raises(ValueError, match="regression"):
        Laplace(m["tm"], "classification", "all", "diag", sigma_noise=0.5, device="cpu")


@pytest.fixture(scope="module", params=FLAVORS, ids=lambda p: "-".join(p))
def reward(request, models):
    """Reward modeling on the MLP: fitted as classification (labels 0/1),
    predicted as regression unless `fitting=True`."""
    sub, hs = request.param
    m = dict(models["mlp"], y=np.random.default_rng(3).integers(0, 2, N))
    jla, tla = _pair(m, "reward_modeling", sub, hs)
    jcl, _ = _pair(m, "classification", sub, hs)
    Xt = m["X"][:4]
    return dict(kind=hs, jla=jla, tla=tla, jcl=jcl, Xt=Xt,
                pred=(jla(jnp.asarray(Xt)), tla(Xt)),
                fitting=(np.asarray(jla(jnp.asarray(Xt), fitting=True)), tla(Xt, fitting=True)))


def test_reward_modeling_fits_as_classification(reward):
    for r, j, g in zip(_curvature(reward["jcl"], reward["kind"]),
                       _curvature(reward["jla"], reward["kind"]),
                       _curvature(reward["tla"], reward["kind"])):
        _close(g, j)
        _close(g, r)
    np.testing.assert_allclose(float(reward["tla"].log_marginal_likelihood()),
                               float(reward["jla"].log_marginal_likelihood()), rtol=REL)


def test_reward_modeling_predicts_as_regression(reward):
    (f_j, v_j), (f_t, v_t) = reward["pred"]
    _close(f_t, f_j, 1e-12)
    _close(v_t, v_j)
    ref, got = reward["fitting"]
    _close(got, ref)
    torch.testing.assert_close(got.sum(-1), torch.ones(4, dtype=got.dtype), rtol=0, atol=1e-12)


def test_reward_modeling_nn_samples_skip_the_softmax(reward):
    """`_nn_predictive_samples` applies the softmax only for classification
    (`laplace_jax/baselaplace.py:1024-1027`)."""
    tla, Xt = reward["tla"], reward["Xt"]
    g = torch.Generator().manual_seed(0)
    fs = tla._nn_functional_samples(Xt, 3, g)
    ps = tla._nn_predictive_samples(Xt, 3, torch.Generator().manual_seed(0))
    torch.testing.assert_close(ps, fs, rtol=0, atol=0)
    mean, var = tla(Xt, pred_type="nn", link_approx="mc", n_samples=3,
                    generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(mean, fs.mean(0), rtol=0, atol=1e-15)
    torch.testing.assert_close(var, fs.var(0, unbiased=False), rtol=0, atol=1e-15)
