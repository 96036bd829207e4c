"""`bench.py`'s reward-model transformer under last-layer Laplace with
`"reward_modeling"`, in the port against `laplace_jax` in float64, on the
narrow twin of `tests/torch_reward.py` (vocab 64, d 16, 2 heads, MLP 32,
2 blocks, 16 sequences of 8 tokens, batch 8).

For KronLL, FullLL and DiagLL: the head both packages find (`Dense_4`), the
Kron factors or H, the log marginal likelihood, and the predictive mean and
variance (reward modeling predicts as regression), and the fitting-mode
probit. Tolerances: curvature 1e-9 relative to its largest entry, the log
marginal likelihood 1e-9 relative, the predictive 1e-9 relative to its
largest entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_jax import Laplace as JaxLaplace
from laplace_jax.nnmodel import NNModel as JaxNNModel
from laplace_jax.utils.data import ArrayLoader as JaxLoader
from laplace_jax_torch import DiagLLLaplace, FullLLLaplace, KronLLLaplace, Laplace
from laplace_jax_torch.utils.data import ArrayLoader

from .torch_reward import NARROW, reward_pair

torch.set_num_threads(1)

REL = 1e-9
CLASSES = {"kron": KronLLLaplace, "full": FullLLLaplace, "diag": DiagLLLaplace}


def _close(got, ref, rel=REL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=rel * np.abs(ref).max())


@pytest.fixture(scope="module")
def pair():
    ids, y, fm, params, tm = reward_pair(seed=0, n=16, seq=8)
    return dict(ids=ids, y=y, fm=fm, params=params, tm=tm)


@pytest.fixture(scope="module", params=sorted(CLASSES))
def fitted(request, pair):
    structure = request.param
    jla = JaxLaplace(JaxNNModel.from_flax(pair["fm"], pair["params"]), "reward_modeling",
                     subset_of_weights="last_layer", hessian_structure=structure)
    jla.fit(JaxLoader(pair["ids"], pair["y"], batch_size=8))
    tla = Laplace(pair["tm"], "reward_modeling", subset_of_weights="last_layer",
                  hessian_structure=structure, device="cpu")
    tla.fit(ArrayLoader(pair["ids"], pair["y"], batch_size=8))
    return structure, jla, tla


def test_head_and_curvature(fitted):
    structure, jla, tla = fitted
    assert isinstance(tla, CLASSES[structure])
    head = f"Dense_{2 * NARROW['blocks']}"
    assert tla.last_layer_path == jla.last_layer_path == (head,)
    assert tla._head_kind == "dense" and tla.n_params == jla.n_params == NARROW["d"] * 2 + 2
    if structure == "kron":
        for Fj, Ft in zip(jla.H_facs.kfacs, tla.H_facs.kfacs):
            for a, b in zip(Fj, Ft):
                _close(b, a)
        for lj, lt in zip(jla.H.eigenvalues, tla.H.eigenvalues):
            for a, b in zip(lj, lt):
                _close(b, a)
    else:
        _close(tla.H, jla.H)


def test_log_marginal_likelihood(fitted):
    _, jla, tla = fitted
    ref = float(jla.log_marginal_likelihood())
    assert abs(float(tla.log_marginal_likelihood()) - ref) <= REL * abs(ref)


def test_predictive(fitted, pair):
    """Reward modeling predicts as regression: `(f_mu, f_var)`; with
    `fitting=True`, as classification."""
    _, jla, tla = fitted
    x = pair["ids"][:5]
    mu_j, var_j = jla(jnp.asarray(x))
    mu_t, var_t = tla(x)
    assert tuple(var_t.shape) == (5, 2, 2)
    _close(mu_t, mu_j)
    _close(var_t, var_j)
    _close(tla(x, fitting=True), jla(jnp.asarray(x), fitting=True))
