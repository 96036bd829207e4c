"""All-weights Laplace on `bench.py`'s reward-model transformer, the slice
as a whole: the port against `laplace_jax` in float64 on the narrow twin of
`tests/torch_reward.py` (vocab 64, d 16, 2 heads, MLP 32, 2 blocks, 12
sequences of 8 tokens, batch 6), likelihood `"reward_modeling"`.

- `KronLaplace` under `kron_unsupported="skip"` (the warning names only
  the LayerNorm leaves) and `"block"` (no warning): every factor, the Embed
  factor diagonal, the marglik at two priors, the probit (`fitting=True`)
  and the regression-mode predictive.
- `DiagLaplace` through the taps (the Jacobian path is patched to raise):
  the diagonal, the marglik at two priors, the probit.
- `LowRankLaplace(low_rank=6)`, Hessian and GGN, from the JAX package's
  start vector: the eigenvalues, the marglik at two priors, the probit.

Tolerances: factors and diagonals 1e-10 relative to their largest entry,
eigenvalues 1e-9 relative, margliks 1e-9 relative, predictives 1e-9
relative to their largest entry.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_jax import DiagLaplace as JaxDiag
from laplace_jax import KronLaplace as JaxKron
from laplace_jax import LowRankLaplace as JaxLowRank
from laplace_jax.nnmodel import NNModel as JaxNNModel
from laplace_jax.utils.data import ArrayLoader as JaxLoader
from laplace_jax_torch import DiagLaplace, KronLaplace, LowRankLaplace
from laplace_jax_torch.curvature import lanczos
from laplace_jax_torch.curvature.backend import CurvatureBackend
from laplace_jax_torch.utils.data import ArrayLoader

from .torch_reward import reward_pair
from .torch_twins import close

torch.set_num_threads(1)

FAC, EIG, LML, PRED = 1e-10, 1e-9, 1e-9, 1e-9
PRIORS = (1.0, 0.25)


@pytest.fixture(scope="module")
def pair():
    ids, y, fm, params, tm = reward_pair(seed=1, n=12, seq=8)
    return dict(ids=ids, y=y, jm=JaxNNModel.from_flax(fm, params), tm=tm)


def _fit(pair, jcls, tcls, **kw):
    jla = jcls(pair["jm"], "reward_modeling", **kw)
    tla = tcls(pair["tm"], "reward_modeling", device="cpu", **kw)
    caught = {}
    for name, la, loader in (("jax", jla, JaxLoader(pair["ids"], pair["y"], batch_size=6)),
                             ("port", tla, ArrayLoader(pair["ids"], pair["y"], batch_size=6))):
        with warnings.catch_warnings(record=True) as ws:
            warnings.simplefilter("always")
            la.fit(loader)
        caught[name] = [str(w.message).replace("params/", "") for w in ws
                        if "zero curvature" in str(w.message)]
    return jla, tla, caught


def _common(pair, jla, tla):
    for pp in PRIORS:
        np.testing.assert_allclose(float(tla.log_marginal_likelihood(pp)),
                                   float(jla.log_marginal_likelihood(pp)), rtol=LML)
    x = pair["ids"][:4]
    close(tla(x, fitting=True), jla(jnp.asarray(x), fitting=True), PRED)
    for g, r in zip(tla(x), jla(jnp.asarray(x))):
        close(g, r, PRED)


@pytest.mark.parametrize("policy", ["skip", "block"])
def test_kron(pair, policy):
    jla, tla, caught = _fit(pair, JaxKron, KronLaplace,
                            backend_kwargs={"kron_unsupported": policy})
    assert caught["port"] == caught["jax"]
    if policy == "skip":
        (msg,) = set(caught["port"])  # one warning a batch
        listed = msg[msg.index("[") + 1:msg.index("]")].replace("'", "").split(", ")
        assert listed and all(p.startswith("LayerNorm_") for p in listed)
    else:
        assert not caught["port"]
    for Ft, Fj in zip(tla.H_facs.kfacs, jla.H_facs.kfacs):
        for a, b in zip(Ft, Fj):
            close(a, b, FAC)
    specs = tla.model.leaf_specs
    embed = tla.H_facs.kfacs[[s.path for s in specs].index(("Embed_0", "embedding"))][0]
    counts = np.bincount(pair["ids"].ravel(), minlength=64)
    np.testing.assert_array_equal(embed.numpy(), np.diag(counts) / pair["ids"].size)
    for s, F in zip(specs, tla.H_facs.kfacs):  # only the skipped norm leaves are zero
        zero = all(float(H.abs().max()) == 0 for H in F)
        assert zero == (policy == "skip" and "LayerNorm" in s.path[0]), s.path
    _common(pair, jla, tla)


def test_diag_through_the_taps(pair):
    def no_jacobians(*a, **k):
        raise AssertionError("the fit took the Jacobian path")

    with pytest.MonkeyPatch.context() as mp:  # the fit only: the predictive takes Jacobians
        mp.setattr(CurvatureBackend, "jacobians", no_jacobians)
        jla, tla, _ = _fit(pair, JaxDiag, DiagLaplace)
    close(tla.H, jla.H, FAC)
    _common(pair, jla, tla)


@pytest.mark.parametrize("backend", ["hessian", "ggn"])
def test_lowrank(pair, backend, monkeypatch):
    def v0(P, dtype, device, gen):
        v = jax.random.normal(jax.random.key(0), (P,), dtype=jnp.float64)
        return torch.as_tensor(np.array(v / jnp.linalg.norm(v)))

    monkeypatch.setattr(lanczos, "start_vector", v0)
    jla, tla, _ = _fit(pair, JaxLowRank, LowRankLaplace, backend=backend, low_rank=6)
    lj = np.asarray(jla.H[1])
    np.testing.assert_allclose(tla.H[1].numpy(), lj, rtol=0, atol=EIG * np.abs(lj).max())
    _common(pair, jla, tla)
