"""The port's matrix-free Lanczos (`curvature/lanczos.py`) and
`LowRankLaplace` against the JAX package in float64 on the CPU.

Both start from the JAX package's start vector, `jax.random.normal(key(0),
(P,))` normalized, which `lanczos.start_vector` is patched to return (the
port's own draw comes from a `torch.Generator`).

- `eig_lowrank` under "hessian" and "ggn", classification and regression,
  on the toy MLP (3 -> 20 -> 2, tanh; `tests/test_curvature.py:245-262`)
  and on the narrow reward transformer: the eigenvalues within 1e-9
  relative, the Ritz vectors sign-aligned within 1e-7 (inside a cluster
  whose gap is under 1e-6, the cluster's projector instead), the loss
  within 1e-12 relative; one loader against both of the JAX package's
  routes (stacked batches, and the host loop it takes for batches of
  uneven sizes) and a one-shot loader (`:349`); "ef" raises (`:335`); a
  run to rank P ends at breakdown, as the JAX package's does.
- `LowRankLaplace` (`tests/test_baselaplace.py:235-267`): `posterior_precision`,
  `V`, `Kinv`, `functional_variance` and `functional_covariance` on the
  same Jacobians, the log det, the marglik at two priors and its gradient
  in the prior precision, 10 steps of prior tuning, the probit (the GLM
  mean and variance in regression), `sample` from the JAX package's
  `eps`, within 1e-9 relative (1e-6 for the tuned prior, as
  `tests/test_torch_full_diag_laplace.py`); at full rank against the
  port's `FullLaplace` with the JAX test's own tolerances (probit 2e-3,
  marglik 1e-2 relative: the eigenvalues below 1e-6 are dropped).
- Save and load: an archive of the port loads in both packages, one of the
  JAX package in the port, and each predicts what the saved object does
  (`tests/test_serialization_breadth.py:136`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_jax import LowRankLaplace as JaxLowRank
from laplace_jax.curvature.backend import CurvatureBackend as JaxBackend
from laplace_jax.utils.data import ArrayLoader as JaxLoader
from laplace_jax_torch import FullLaplace, Laplace, LowRankLaplace
from laplace_jax_torch.curvature import lanczos
from laplace_jax_torch.curvature.backend import CurvatureBackend
from laplace_jax_torch.nnmodel import NNModel
from laplace_jax_torch.utils.data import ArrayLoader

from .torch_reward import reward_pair
from .torch_twins import classification, close, mlp_pair, regression

torch.set_num_threads(1)

EIG, VEC, LOSS, REL = 1e-9, 1e-7, 1e-12, 1e-9
CLUSTER_GAP = 1e-6


def jax_v0(P):
    v0 = jax.random.normal(jax.random.key(0), (P,), dtype=jnp.float64)
    return np.array(v0 / jnp.linalg.norm(v0))


@pytest.fixture
def jax_start(monkeypatch):
    """Patch the port's start vector to the JAX package's draw."""
    monkeypatch.setattr(lanczos, "start_vector",
                        lambda P, dtype, device, gen: torch.as_tensor(jax_v0(P), dtype=dtype,
                                                                      device=device))


def _data(likelihood, n=10, seed=711):
    make = classification if likelihood == "classification" else regression
    return make(n, (3,), 2, seed)


def assert_eigenpairs(Ut, lt, Uj, lj):
    """Eigenvalues within EIG relative; vectors sign-aligned within VEC, or
    inside a cluster (gap < CLUSTER_GAP relative) its projector."""
    lj, Uj = np.asarray(lj), np.asarray(Uj)
    lt, Ut = lt.numpy(), Ut.numpy()
    assert lt.shape == lj.shape
    np.testing.assert_allclose(lt, lj, rtol=0, atol=EIG * np.abs(lj).max())
    i = 0
    while i < len(lj):
        j = i + 1
        while j < len(lj) and abs(lj[j - 1] - lj[j]) < CLUSTER_GAP * abs(lj[0]):
            j += 1
        if j - i == 1:
            s = np.sign(Ut[:, i] @ Uj[:, i])
            np.testing.assert_allclose(s * Ut[:, i], Uj[:, i], rtol=0, atol=VEC)
        else:
            np.testing.assert_allclose(Ut[:, i:j] @ Ut[:, i:j].T, Uj[:, i:j] @ Uj[:, i:j].T,
                                       rtol=0, atol=VEC)
        i = j


@pytest.mark.parametrize("likelihood", ["classification", "regression"])
@pytest.mark.parametrize("curv", ["hessian", "ggn"])
def test_eig_lowrank_mlp_against_jax(jax_start, curv, likelihood):
    jm, tm = mlp_pair()
    X, y = _data(likelihood)
    Uj, lj, Lj = JaxBackend(jm, likelihood, curv_type=curv).eig_lowrank(
        JaxLoader(X, y, batch_size=5), low_rank=6)
    Ut, lt, Lt = CurvatureBackend(NNModel(tm), likelihood, curv_type=curv).eig_lowrank(
        ArrayLoader(X, y, batch_size=5), low_rank=6)
    assert_eigenpairs(Ut, lt, Uj, lj)
    np.testing.assert_allclose(float(Lt), float(Lj), rtol=LOSS)


@pytest.mark.parametrize("curv", ["hessian", "ggn"])
def test_eig_lowrank_reward_transformer_against_jax(jax_start, curv):
    """Through the attention, tanh-gelu, the written-out LayerNorm variance
    and the Embed's indexing, forward over reverse (Hessian) and jvp then
    vjp (GGN)."""
    ids, y, fm, params, tm = reward_pair(n=8, seq=8)
    from laplace_jax.nnmodel import NNModel as JaxNNModel

    jm = JaxNNModel.from_flax(fm, params)
    Uj, lj, Lj = JaxBackend(jm, "classification", curv_type=curv).eig_lowrank(
        JaxLoader(ids, y, batch_size=4), low_rank=5)
    Ut, lt, Lt = CurvatureBackend(NNModel(tm), "classification", curv_type=curv).eig_lowrank(
        ArrayLoader(ids, y, batch_size=4), low_rank=5)
    assert_eigenpairs(Ut, lt, Uj, lj)
    np.testing.assert_allclose(float(Lt), float(Lj), rtol=LOSS)


class OneShot:
    """A loader that may be iterated once."""

    def __init__(self, batches):
        self.batches, self.used = batches, False

    def __iter__(self):
        assert not self.used, "loader iterated twice"
        self.used = True
        yield from self.batches


def test_one_loader_against_both_jax_routes(jax_start):
    """Batches of 4, 3 and 3: the JAX package stacks even batches on the
    device and loops over uneven ones on the host; the port reads any
    loader once (a one-shot loader too) and loops on the device."""
    jm, tm = mlp_pair()
    X, y = _data("classification")
    even = JaxBackend(jm, "classification", curv_type="ggn").eig_lowrank(
        JaxLoader(X, y, batch_size=5), low_rank=4)
    cuts = [(X[:4], y[:4]), (X[4:7], y[4:7]), (X[7:], y[7:])]
    uneven = JaxBackend(jm, "classification", curv_type="ggn").eig_lowrank(cuts, low_rank=4)
    be = CurvatureBackend(NNModel(tm), "classification", curv_type="ggn")
    for loader in (ArrayLoader(X, y, batch_size=5), OneShot(cuts), cuts):
        Ut, lt, Lt = be.eig_lowrank(loader, low_rank=4)
        for Uj, lj, Lj in (even, uneven):
            assert_eigenpairs(Ut, lt, Uj, lj)
            np.testing.assert_allclose(float(Lt), float(Lj), rtol=LOSS)


def test_ef_raises():
    _, tm = mlp_pair()
    X, y = _data("classification")
    with pytest.raises(ValueError, match="not 'ef'"):
        CurvatureBackend(NNModel(tm), "classification", curv_type="ef").eig_lowrank(
            ArrayLoader(X, y, batch_size=5), low_rank=3)


def test_breakdown_at_full_rank(jax_start):
    """low_rank = P: m = P steps, the last of which leaves nothing (β <
    1e-12); both packages keep the same eigenpairs above 1e-6."""
    jm, tm = mlp_pair()
    X, y = _data("classification")
    P = jm.n_params
    Uj, lj, _ = JaxBackend(jm, "classification", curv_type="ggn").eig_lowrank(
        JaxLoader(X, y, batch_size=5), low_rank=P)
    Ut, lt, _ = CurvatureBackend(NNModel(tm), "classification", curv_type="ggn").eig_lowrank(
        ArrayLoader(X, y, batch_size=5), low_rank=P)
    assert 0 < len(lt) < P
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=EIG * float(np.abs(lj).max()))
    # the kept subspace is the same
    np.testing.assert_allclose(Ut.numpy() @ Ut.numpy().T, np.asarray(Uj) @ np.asarray(Uj).T,
                               rtol=0, atol=VEC)


# ---- LowRankLaplace ---------------------------------------------------------
@pytest.fixture(scope="module", params=[("classification", "hessian"),
                                        ("classification", "ggn"),
                                        ("regression", "hessian")])
def fitted(request):
    likelihood, backend = request.param
    jm, tm = mlp_pair()
    X, y = _data(likelihood)
    P = jm.n_params
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lanczos, "start_vector",
                   lambda P, dtype, device, gen: torch.as_tensor(jax_v0(P)))
        jla = JaxLowRank(jm, likelihood, backend=backend, low_rank=8)
        jla.fit(JaxLoader(X, y, batch_size=5))
        tla = LowRankLaplace(tm, likelihood, backend=backend, low_rank=8, device="cpu")
        tla.fit(ArrayLoader(X, y, batch_size=5))
    return dict(jla=jla, tla=tla, X=X, y=y, P=P, likelihood=likelihood, tm=tm, jm=jm)


def test_fit_state(fitted):
    jla, tla = fitted["jla"], fitted["tla"]
    assert tla.n_outputs == jla.n_outputs == 2
    assert tla.n_data == jla.n_data == 10
    np.testing.assert_allclose(float(tla.loss), float(jla.loss), rtol=LOSS)
    (Ut, lt), dt = tla.posterior_precision
    (Uj, lj), dj = jla.posterior_precision
    assert_eigenpairs(Ut, lt, Uj, lj)
    close(dt, dj, 0)
    s = np.sign((Ut.numpy() * np.asarray(Uj)).sum(0))
    close(tla.V * torch.as_tensor(s), jla.V, REL)
    close(tla.Kinv * torch.as_tensor(s[:, None] * s[None]), jla.Kinv, REL)


def test_functional_variance_and_covariance(fitted):
    jla, tla = fitted["jla"], fitted["tla"]
    Js, _ = tla.backend.jacobians(torch.as_tensor(fitted["X"][:4]))
    close(tla.functional_variance(Js), jla.functional_variance(jnp.asarray(Js.numpy())), REL)
    close(tla.functional_covariance(Js), jla.functional_covariance(jnp.asarray(Js.numpy())), REL)


def test_log_det_and_marglik(fitted):
    jla, tla = fitted["jla"], fitted["tla"]
    for pp in (1.0, 0.3):
        np.testing.assert_allclose(float(tla.log_marginal_likelihood(pp)),
                                   float(jla.log_marginal_likelihood(pp)), rtol=REL)
        np.testing.assert_allclose(float(tla.log_det_posterior_precision),
                                   float(jla.log_det_posterior_precision), rtol=REL)
    pp = torch.tensor([0.7], dtype=torch.float64, requires_grad=True)
    tla.log_marginal_likelihood(pp).backward()
    gj = jax.grad(lambda p: jla.log_marginal_likelihood(p))(jnp.asarray([0.7]))
    close(pp.grad, gj, REL)


def test_predictive(fitted):
    jla, tla = fitted["jla"], fitted["tla"]
    X = fitted["X"][:4]
    got, ref = tla(X), jla(jnp.asarray(X))
    for g, r in zip(got if isinstance(got, tuple) else [got],
                    ref if isinstance(ref, tuple) else [ref]):
        close(g, r, REL)


def test_sample_from_jax_eps(fitted):
    jla, tla = fitted["jla"], fitted["tla"]
    key = jax.random.key(3)
    ref = jla.sample(5, key=key)
    eps = jax.random.normal(key, (fitted["P"], 5), dtype=jnp.float64)
    close(tla._samples_from(torch.as_tensor(np.array(eps)).T), ref, REL)
    assert tla.sample(5).shape == (5, fitted["P"])


def test_prior_tuning(fitted):
    jla, tla = fitted["jla"], fitted["tla"]
    jla.optimize_prior_precision(n_steps=10)
    tla.optimize_prior_precision(n_steps=10)
    np.testing.assert_allclose(tla.prior_precision.numpy(), np.asarray(jla.prior_precision),
                               rtol=1e-6)


def test_override_false_raises_and_factory():
    _, tm = mlp_pair()
    X, y = _data("classification")
    la = Laplace(tm, "classification", "all", "lowrank", device="cpu")
    assert type(la) is LowRankLaplace and la.low_rank == 10
    assert la.backend.curv_type == "hessian"
    with pytest.raises(ValueError, match="does not support updating"):
        la.fit(ArrayLoader(X, y, batch_size=5), override=False)
    with pytest.raises(ValueError, match="target has"):
        LowRankLaplace(tm, "regression", device="cpu").fit(ArrayLoader(X, y, batch_size=5))


def test_full_rank_matches_full_laplace():
    """Rank P with the GGN: LowRank is FullLaplace but for the dropped
    eigenvalues below 1e-6 (the JAX test's tolerances)."""
    _, tm = mlp_pair()
    X, y = _data("classification")
    loader = ArrayLoader(X, y, batch_size=5)
    lr = LowRankLaplace(tm, "classification", backend="ggn", low_rank=NNModel(tm).n_params,
                        device="cpu")
    lr.fit(loader)
    full = FullLaplace(tm, "classification", backend="ggn", device="cpu")
    full.fit(loader)
    np.testing.assert_allclose(lr(X).numpy(), full(X).numpy(), atol=2e-3)
    np.testing.assert_allclose(float(lr.log_marginal_likelihood()),
                               float(full.log_marginal_likelihood()), rtol=1e-2)


def test_save_load_across_packages(fitted, tmp_path):
    jla, tla = fitted["jla"], fitted["tla"]
    likelihood, backend = fitted["likelihood"], tla._backend_arg
    X = fitted["X"][:4]
    path = str(tmp_path / "t.npz")
    tla.save(path)
    t2 = LowRankLaplace(fitted["tm"], likelihood, backend=backend, device="cpu").load(path)
    j2 = JaxLowRank(fitted["jm"], likelihood, backend=backend).load(path)
    ref = tla(X)
    for got in (t2(X), j2(jnp.asarray(X))):
        for g, r in zip(got if isinstance(got, tuple) else [got],
                        ref if isinstance(ref, tuple) else [ref]):
            close(g, r, 0 if isinstance(g, torch.Tensor) else REL)
    assert float(t2.log_marginal_likelihood()) == float(tla.log_marginal_likelihood())
    jpath = str(tmp_path / "j.npz")
    jla.save(jpath)
    t3 = LowRankLaplace(fitted["tm"], likelihood, backend=backend, device="cpu").load(jpath)
    ref = jla(jnp.asarray(X))
    got = t3(X)
    for g, r in zip(got if isinstance(got, tuple) else [got],
                    ref if isinstance(ref, tuple) else [ref]):
        close(g, r, REL)
    assert isinstance(t3.H, tuple) and len(t3.H) == 2
