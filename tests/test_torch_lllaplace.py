"""The port's last-layer Laplace (`FullLLLaplace`, `KronLLLaplace`,
`DiagLLLaplace`) against `laplace_jax.lllaplace` on a narrow ResNet-18
(width 8, 16x16 inputs, N = 16, batch 8) in float64.

Weights are carried over from the flax model (`state_dict_from_flax`); the
same numpy inputs go to both packages. Tolerances: curvature (matrix,
factors or vector) 1e-9 relative to its largest entry; eigenvalues 1e-9
relative to the largest; log marginal likelihood 1e-8 relative; the prior
precision after 20 marglik Adam steps 1e-6 relative (optax and torch Adam
round their updates differently); the probit predictive 1e-8;
`functional_variance_fast` 1e-9 relative; GLM predictive samples from the
same standard-normal draws 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_jax import DiagLLLaplace as JaxDiagLL
from laplace_jax import FullLLLaplace as JaxFullLL
from laplace_jax import KronLLLaplace as JaxKronLL
from laplace_jax.models import ResNet18 as JaxResNet18
from laplace_jax.nnmodel import NNModel as JaxNNModel
from laplace_jax.utils.data import ArrayLoader as JaxLoader
from laplace_jax_torch import (
    DiagLaplace,
    DiagLLLaplace,
    DiagSubnetLaplace,
    FullLaplace,
    FullLLLaplace,
    FullSubnetLaplace,
    FunctionalLaplace,
    FunctionalLLLaplace,
    KronLaplace,
    KronLLLaplace,
    Laplace,
    LLLaplace,
    LowRankLaplace,
)
from laplace_jax_torch.models.resnet import ResNet18, state_dict_from_flax
from laplace_jax_torch.nnmodel import NNModel
from laplace_jax_torch.utils.data import ArrayLoader
from laplace_jax_torch.utils.linalg import normal_samples_from

# several test workers share the CPU: one intra-op thread each
torch.set_num_threads(1)

N, BATCH = 16, 8
FLAVORS = {"full": (JaxFullLL, FullLLLaplace), "kron": (JaxKronLL, KronLLLaplace),
           "diag": (JaxDiagLL, DiagLLLaplace)}


def _close(got, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=rel * np.abs(ref).max())


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


@pytest.fixture(scope="module", params=sorted(FLAVORS))
def fitted(request, pair):
    """Both packages' flavor, fitted; marglik and predictives recorded,
    then 20 marglik prior steps."""
    X, y = pair["X"], pair["y"]
    jcls, tcls = FLAVORS[request.param]
    jla = jcls(JaxNNModel.from_flax(pair["jm"], pair["params"]), "classification")
    tla = tcls(pair["tm"], "classification", device="cpu")
    n_before = tla.n_params
    jla.fit(JaxLoader(X, y, batch_size=BATCH))
    tla.fit(ArrayLoader(X, y, batch_size=BATCH))
    out = dict(kind=request.param, jla=jla, tla=tla, n_before=n_before,
               lml=(float(jla.log_marginal_likelihood()), float(tla.log_marginal_likelihood())),
               pred=(np.asarray(jla(jnp.asarray(X[:4]))), tla(X[:4]).numpy()),
               fvf=(jla.functional_variance_fast(jnp.asarray(X[:4])),
                    tla.functional_variance_fast(X[:4])))
    jla.optimize_prior_precision(n_steps=20)
    tla.optimize_prior_precision(n_steps=20)
    out["pp"] = (np.asarray(jla.prior_precision), tla.prior_precision.numpy())
    return out


def test_last_layer_is_discovered_on_fit(fitted):
    tla = fitted["tla"]
    assert fitted["n_before"] is None
    assert tla.last_layer_path == ("Dense_0",) == fitted["jla"].last_layer_path
    assert tla.n_params == 650 == fitted["jla"].n_params
    assert [s.path for s in tla.model.leaf_specs] == [("Dense_0", "bias"), ("Dense_0", "kernel")]
    _close(tla.mean.numpy(), fitted["jla"].mean, 1e-15)


def test_curvature_matches(fitted):
    jla, tla = fitted["jla"], fitted["tla"]
    if fitted["kind"] == "kron":
        for Fj, Ft in zip(jla.H_facs.kfacs, tla.H_facs.kfacs, strict=True):
            for a, b in zip(Fj, Ft, strict=True):
                _close(b.numpy(), a, 1e-9)
    else:
        assert tuple(tla.H.shape) == tuple(jla.H.shape)
        _close(tla.H.numpy(), jla.H, 1e-9)


def test_eigenvalues_match(fitted):
    """Kron: the flat Kronecker eigenvalues; Full and Diag: the spectrum of
    the posterior precision."""
    jla, tla = fitted["jla"], fitted["tla"]
    if fitted["kind"] == "kron":
        ref, got = np.asarray(jla.H._flat_eigs), tla.H._flat_eigs.numpy()
    elif fitted["kind"] == "full":
        ref = np.linalg.eigvalsh(np.asarray(jla.posterior_precision))
        got = torch.linalg.eigvalsh(tla.posterior_precision).numpy()
    else:
        ref = np.sort(np.asarray(jla.posterior_precision))
        got = np.sort(tla.posterior_precision.numpy())
    _close(got, ref, 1e-9)


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


def test_functional_variance_fast_matches(fitted, pair):
    (f_j, v_j), (f_t, v_t) = fitted["fvf"]
    _close(f_t.numpy(), f_j, 1e-12)
    _close(v_t.numpy(), v_j, 1e-9)
    # and against the port's own Jacobian path (the generic LL method)
    tla, X = fitted["tla"], pair["X"][:4]
    fast = tla.functional_variance_fast(X)[1]
    slow = LLLaplace.functional_variance_fast(tla, X)[1]
    _close(fast.numpy(), slow.numpy(), 1e-10)


@pytest.mark.parametrize("diagonal_output", [False, True])
def test_glm_predictive_samples_from_same_draws(fitted, pair, diagonal_output):
    jla, tla = fitted["jla"], fitted["tla"]
    X, S = pair["X"][:4], 7
    key = jax.random.key(5)
    ref = np.asarray(jla.predictive_samples(jnp.asarray(X), n_samples=S, key=key,
                                            diagonal_output=diagonal_output))
    randn = np.array(jax.random.normal(key, (10, S), dtype=jnp.float64))
    f_mu, f_var = tla._glm_predictive_distribution(X, diagonal_output=diagonal_output)
    got = torch.softmax(normal_samples_from(f_mu, f_var, torch.as_tensor(randn)), dim=-1)
    assert got.shape == (S, 4, 10)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-10)


def test_predictive_samples_use_the_generator(fitted, pair):
    tla = fitted["tla"]
    X = pair["X"][:3]
    a = tla.predictive_samples(X, n_samples=5, generator=torch.Generator().manual_seed(1))
    b = tla.predictive_samples(X, n_samples=5, generator=torch.Generator().manual_seed(1))
    assert a.shape == (5, 3, 10)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a.sum(-1), torch.ones(5, 3, dtype=a.dtype), rtol=0, atol=1e-12)
    nn = tla.predictive_samples(X, pred_type="nn", n_samples=5,
                                generator=torch.Generator().manual_seed(1))
    assert nn.shape == (5, 3, 10)
    torch.testing.assert_close(nn.sum(-1), torch.ones(5, 3, dtype=nn.dtype), rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="glm"):
        tla.predictive_samples(X, pred_type="bogus")


def test_ll_equals_full_laplace_on_frozen_backbone(pair):
    """FullLL (closed-form Jacobians) == all-weights FullLaplace (autograd
    Jacobians) on a model whose only trainable leaves are the head's
    (the JAX oracle `tests/test_lllaplace.py:56`)."""
    X, y = pair["X"], pair["y"]
    ll = FullLLLaplace(pair["tm"], "classification", device="cpu")
    ll.fit(ArrayLoader(X, y, batch_size=BATCH))
    frozen = ResNet18(width=8).double()
    frozen.load_state_dict(pair["tm"].state_dict())
    for name, p in frozen.named_parameters():
        p.requires_grad_(name.startswith("Dense_0."))
    full = FullLaplace(frozen, "classification", device="cpu")
    full.fit(ArrayLoader(X, y, batch_size=BATCH))
    torch.testing.assert_close(ll.H, full.H, rtol=0, atol=1e-10)
    torch.testing.assert_close(ll(X[:4]), full(X[:4]), rtol=0, atol=1e-10)
    torch.testing.assert_close(ll.log_marginal_likelihood(), full.log_marginal_likelihood(),
                               rtol=1e-10, atol=0)


def test_explicit_last_layer_name(pair):
    la = DiagLLLaplace(pair["tm"], "classification", last_layer_name="Dense_0",
                       prior_precision=0.5, device="cpu")
    assert la.n_params == 650 and la.last_layer_path == ("Dense_0",)
    assert float(la.prior_precision[0]) == 0.5
    la.fit(ArrayLoader(pair["X"], pair["y"], batch_size=BATCH))
    assert la.H.shape == (650,)
    with pytest.raises(ValueError, match="No parameters"):
        FullLLLaplace(pair["tm"], "classification", last_layer_name="Dense_7", device="cpu")
    # a conv head is a last layer too (its Jacobians over its leaves): the
    # stem conv's 3x3x3x8 kernel, no bias
    conv = FullLLLaplace(pair["tm"], "classification", last_layer_name="Conv_0", device="cpu")
    assert conv.last_layer_path == ("Conv_0",) and conv.n_params == 216
    with pytest.raises(ValueError, match="override=False"):
        la.fit(ArrayLoader(pair["X"], pair["y"], batch_size=BATCH), override=False)


def test_kron_ll_keeps_damping(pair):
    la = KronLLLaplace(pair["tm"], "classification", damping=True, device="cpu")
    la.fit(ArrayLoader(pair["X"], pair["y"], batch_size=BATCH))
    assert la.damping and la.H.damping


def test_laplace_defaults_and_keys(pair):
    tm = pair["tm"]
    assert type(Laplace(tm, "classification", device="cpu")) is KronLLLaplace
    for key, cls in [(("last_layer", "kron"), KronLLLaplace),
                     (("last_layer", "full"), FullLLLaplace),
                     (("last_layer", "diag"), DiagLLLaplace),
                     (("all", "kron"), KronLaplace), (("all", "full"), FullLaplace),
                     (("all", "diag"), DiagLaplace), (("all", "lowrank"), LowRankLaplace)]:
        assert type(Laplace(tm, "classification", *key, device="cpu")) is cls
    for key, cls, kw in [(("subnetwork", "full"), FullSubnetLaplace, dict(subnetwork_indices=[0])),
                         (("subnetwork", "diag"), DiagSubnetLaplace, dict(subnetwork_indices=[0])),
                         (("all", "gp"), FunctionalLaplace, dict(n_subset=4)),
                         (("last_layer", "gp"), FunctionalLLLaplace, dict(n_subset=4))]:
        assert type(Laplace(tm, "classification", *key, device="cpu", **kw)) is cls
    for key in [("subnetwork", "kron"), ("last_layer", "lowrank")]:
        with pytest.raises(ValueError, match="not ported"):
            Laplace(tm, "classification", *key, device="cpu")


class _TwoDense(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = torch.nn.Linear(3, 4)
        self.Dense_1 = torch.nn.Linear(4, 2)

    def forward(self, x):
        return self.Dense_1(torch.tanh(self.Dense_0(x)))


@pytest.mark.parametrize("reduction", ["pick_first", "pick_last", "average"])
def test_features_of_a_sequence_head_are_reduced(reduction):
    """`apply_with_features` reduces (batch, T, d) features to (batch, d)
    as `laplace_jax/nnmodel.py:461-471` does."""
    net = _TwoDense().double()
    x = torch.as_tensor(np.random.default_rng(8).standard_normal((2, 5, 3)))
    model = NNModel(net)
    assert model.find_last_layer(x) == ("Dense_1",)
    f, phi = model.apply_with_features(x, ("Dense_1",), reduction)
    h = torch.tanh(net.Dense_0(x)).detach()
    ref = {"pick_first": h[:, 0], "pick_last": h[:, -1], "average": h.mean(1)}[reduction]
    torch.testing.assert_close(phi.detach(), ref, rtol=0, atol=1e-15)
    assert f.shape == (2, 5, 2)
    with pytest.raises(ValueError, match="feature_reduction"):
        FullLLLaplace(net, "classification", feature_reduction="median", device="cpu")
