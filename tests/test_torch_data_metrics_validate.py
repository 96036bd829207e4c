"""The port's `utils/data.py`, `utils/metrics.py`, `utils/validate.py`,
dict batches and the gridsearch against the JAX package (float64).

- `ArrayLoader`: the shuffled batch order is identical to the JAX loader's
  for several epochs (array, dict and `y=None` inputs), `subset`,
  `loader_batches`.
- Dict batches (integer ids and labels in one dict) through `fit` and the
  predictive, on a one-hot MLP twin: curvature and probit predictive
  within 1e-9 relative of the JAX package's.
- The metrics on the same inputs (1e-12 relative), and `validate`'s arity
  cases of `tests/test_metrics_validate.py`, also the legacy 3-then-2 probe
  for a metric whose signature cannot be inspected.
- The gridsearch's chosen prior precision equal to JAX's (1e-12 relative).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_jax import Laplace as JaxLaplace
from laplace_jax.models.mlp import MLP as JaxMLP
from laplace_jax.nnmodel import NNModel as JaxNNModel
from laplace_jax.utils import data as jdata
from laplace_jax.utils import metrics as jmetrics
from laplace_jax.utils.validate import validate as jvalidate
from laplace_jax_torch import Laplace
from laplace_jax_torch.models.mlp import MLP
from laplace_jax_torch.models.resnet import state_dict_from_flax
from laplace_jax_torch.utils import data as tdata
from laplace_jax_torch.utils import metrics as tmetrics
from laplace_jax_torch.utils.validate import validate as tvalidate

torch.set_num_threads(1)

REL = 1e-9


def _close(got, ref, rel=REL):
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-300))


def _flat(batches):
    """Batches as nested lists of numpy arrays, dicts as sorted items."""
    def flat(b):
        if isinstance(b, dict):
            return [(k, flat(b[k])) for k in sorted(b)]
        if isinstance(b, (tuple, list)):
            return [flat(v) for v in b]
        return None if b is None else np.asarray(b)
    return [flat(b) for b in batches]


def _same(a, b):
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, tuple):  # a dict item
        assert a[0] == b[0]
        _same(a[1], b[1])
    elif a is None:
        assert b is None
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["array", "dict", "dict_no_y"])
@pytest.mark.parametrize("seed", [0, 5])
def test_shuffled_batches_match_jax_for_several_epochs(kind, seed):
    rng = np.random.default_rng(1)
    X, y = rng.standard_normal((23, 3)), rng.integers(0, 4, 23)
    if kind == "array":
        args = (X, y)
    elif kind == "dict":
        args = ({"x": X, "ids": y}, y)
    else:
        args = ({"x": X, "labels": y},)
    jl = jdata.ArrayLoader(*args, batch_size=5, shuffle=True, seed=seed)
    tl = tdata.ArrayLoader(*args, batch_size=5, shuffle=True, seed=seed)
    assert len(tl) == len(jl) == 5 and tl.n_data == jl.n_data == 23
    for _ in range(4):  # epochs: each draws a new order from seed + epoch
        _same(_flat(tl), _flat(jl))
    # an unshuffled loader keeps the order
    _same(_flat(tdata.ArrayLoader(*args, batch_size=5)),
          _flat(jdata.ArrayLoader(*args, batch_size=5)))


def test_subset_and_loader_batches_match_jax():
    rng = np.random.default_rng(2)
    X, y = rng.standard_normal((20, 2)), rng.standard_normal((20, 1))
    idx = rng.permutation(20)[:7]
    jl = jdata.ArrayLoader(X, y, batch_size=3, shuffle=True).subset(idx)
    tl = tdata.ArrayLoader(X, y, batch_size=3, shuffle=True).subset(idx)
    assert tl.n_data == 7 and not tl.shuffle
    _same(_flat(tl), _flat(jl))
    _same(_flat(tdata.loader_batches(tl)), _flat(jdata.loader_batches(jl)))
    d = tdata.ArrayLoader({"x": X, "labels": y}, batch_size=8)
    assert all(b[1] is None for b in tdata.loader_batches(d))
    assert tdata.dataset_size(d) == 20


# ---- dict batches

VOCAB, T = 8, 6


class JaxDictNet(fnn.Module):
    @fnn.compact
    def __call__(self, batch):
        x = jax.nn.one_hot(batch["input_ids"], VOCAB, dtype=jnp.float64).mean(axis=1)
        x = jnp.tanh(fnn.Dense(5, param_dtype=jnp.float64)(x))
        return fnn.Dense(3, param_dtype=jnp.float64)(x)


class DictNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = torch.nn.Linear(VOCAB, 5)
        self.Dense_1 = torch.nn.Linear(5, 3)

    def forward(self, batch):
        ids = batch["input_ids"]
        x = torch.nn.functional.one_hot(ids, VOCAB).to(self.Dense_0.weight.dtype).mean(1)
        return self.Dense_1(torch.tanh(self.Dense_0(x)))


@pytest.fixture(scope="module")
def dict_pair():
    rng = np.random.default_rng(3)
    data = {"input_ids": rng.integers(0, VOCAB, (20, T)), "labels": rng.integers(0, 3, 20)}
    jm = JaxDictNet()
    params = jm.init(jax.random.key(0), {k: jnp.asarray(v[:1]) for k, v in data.items()})
    tm = DictNet().double()
    tm.load_state_dict(state_dict_from_flax(params, tm))
    return data, jm, params, tm


@pytest.mark.parametrize("sub,hs", [("all", "diag"), ("all", "kron"), ("last_layer", "full")])
def test_dict_batches_fit_and_predict_like_jax(dict_pair, sub, hs):
    data, jm, params, tm = dict_pair
    jla = JaxLaplace(JaxNNModel.from_flax(jm, params), "classification", subset_of_weights=sub,
                     hessian_structure=hs)
    tla = Laplace(tm, "classification", sub, hs, device="cpu")
    jla.fit(jdata.ArrayLoader(data, batch_size=10))
    tla.fit(tdata.ArrayLoader(data, batch_size=10))
    assert tla.n_data == 20
    if hs == "kron":
        for Fj, Ft in zip(jla.H_facs.kfacs, tla.H_facs.kfacs, strict=True):
            for a, b in zip(Fj, Ft, strict=True):
                _close(b, a)
    else:
        _close(tla.H, jla.H)
    test = {k: v[:5] for k, v in data.items()}
    ref = jla({k: jnp.asarray(v) for k, v in test.items()})
    got = tla(test)
    _close(got, ref)
    assert test["input_ids"].dtype.kind == "i"  # ids reach the forward as integers
    np.testing.assert_allclose(float(tla.log_marginal_likelihood()),
                               float(jla.log_marginal_likelihood()), rtol=1e-9)


# ---- metrics

def test_running_metrics_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 10, 4))
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    y = rng.integers(0, 4, (2, 10))
    y[0, 3] = y[1, 7] = -100
    jn, tn = jmetrics.RunningNLLMetric(), tmetrics.RunningNLLMetric()
    for b in range(2):
        jn.update(jnp.asarray(probs[b]), jnp.asarray(y[b]))
        tn.update(torch.as_tensor(probs[b]), torch.as_tensor(y[b]))
    assert tn.n_valid == jn.n_valid == 18
    np.testing.assert_allclose(tn.compute(), jn.compute(), rtol=1e-12)
    mu, t = rng.standard_normal((10, 3)), rng.standard_normal((10, 3))
    jm, tm = jmetrics.RunningMSEMetric(), tmetrics.RunningMSEMetric()
    for sl in (slice(0, 4), slice(4, 10)):
        jm.update(jnp.asarray(mu[sl]), jnp.asarray(t[sl]))
        tm.update(torch.as_tensor(mu[sl]), torch.as_tensor(t[sl]))
    np.testing.assert_allclose(tm.compute(), jm.compute(), rtol=1e-12)
    tm.reset()
    assert tm.compute() == 0.0


def test_ece_and_nll_match_jax():
    rng = np.random.default_rng(5)
    logits = 3 * rng.standard_normal((50, 4))
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    y = rng.integers(0, 4, 50)
    np.testing.assert_allclose(tmetrics.expected_calibration_error(torch.as_tensor(probs), y),
                               jmetrics.expected_calibration_error(probs, y), rtol=1e-12)
    np.testing.assert_allclose(float(tmetrics.get_nll(torch.as_tensor(probs), torch.as_tensor(y))),
                               float(jmetrics.get_nll(jnp.asarray(probs), jnp.asarray(y))),
                               rtol=1e-12)


# ---- validate

@pytest.fixture(scope="module")
def reg_pair():
    rng = np.random.default_rng(6)
    X, y = rng.standard_normal((24, 3)), rng.standard_normal((24, 2))
    jm = JaxMLP(hidden=(8,), out_dim=2, dtype=jnp.float64)
    params = jm.init(jax.random.key(0), jnp.asarray(X[:1]))
    tm = MLP(3, (8,), 2).double()
    tm.load_state_dict(state_dict_from_flax(params, tm))
    jla = JaxLaplace(JaxNNModel.from_flax(jm, params), "regression", "all", "full")
    tla = Laplace(tm, "regression", "all", "full", device="cpu")
    jla.fit(jdata.ArrayLoader(X, y, batch_size=8))
    tla.fit(tdata.ArrayLoader(X, y, batch_size=8))
    return jla, tla, X, y


def _metric(arity, raise_inside=False, inspectable=True):
    class Update:
        def __init__(self, owner):
            self.owner = owner

        def __call__(self, *args):
            if len(args) != arity:
                raise TypeError(f"update takes {arity} arguments")
            if raise_inside:
                raise TypeError("bug inside the metric")
            self.owner.calls.append(len(args))
            self.owner.total += float(np.sum(np.asarray(args[0])))

    class Metric:
        def __init__(self):
            self.calls, self.total = [], 0.0
            if inspectable:
                self.update = (self._update3 if arity == 3 else self._update2)
            else:
                self.update = Update(self)

        def _update3(self, mean, var, target):
            Update(self)(mean, var, target)

        def _update2(self, mean, target):
            Update(self)(mean, target)

        def reset(self):
            self.calls, self.total = [], 0.0

        def compute(self):
            return self.total

    if not inspectable:  # inspect.signature raises TypeError on this object
        Update.__signature__ = "not a signature"
    return Metric()


@pytest.mark.parametrize("arity", [2, 3])
@pytest.mark.parametrize("inspectable", [True, False])
def test_validate_arity_matches_jax(reg_pair, arity, inspectable):
    jla, tla, X, y = reg_pair
    jm_, tm_ = _metric(arity, inspectable=inspectable), _metric(arity, inspectable=inspectable)
    ref = jvalidate(jla, jdata.ArrayLoader(X, y, batch_size=8), jm_)
    got = tvalidate(tla, tdata.ArrayLoader(X, y, batch_size=8), tm_)
    assert tm_.calls == jm_.calls == [arity] * 3
    np.testing.assert_allclose(got, ref, rtol=1e-9)


def test_validate_internal_typeerror_surfaces(reg_pair):
    _, tla, X, y = reg_pair
    with pytest.raises(TypeError, match="bug inside the metric"):
        tvalidate(tla, tdata.ArrayLoader(X, y, batch_size=8), _metric(3, raise_inside=True))


def test_validate_online_equals_offline_and_jax(reg_pair):
    jla, tla, X, y = reg_pair
    loader = tdata.ArrayLoader(X, y, batch_size=8)
    online = tvalidate(tla, loader, tmetrics.RunningMSEMetric())
    offline = tvalidate(tla, loader, lambda m, v, t: float(((m - t) ** 2).sum()) / len(t))
    ref = jvalidate(jla, jdata.ArrayLoader(X, y, batch_size=8), jmetrics.RunningMSEMetric())
    np.testing.assert_allclose(online, offline, rtol=1e-12)
    np.testing.assert_allclose(online, ref, rtol=1e-9)


# ---- gridsearch

@pytest.mark.parametrize("likelihood,sub,hs", [("regression", "all", "kron"),
                                               ("classification", "last_layer", "full"),
                                               ("classification", "all", "diag")])
def test_gridsearch_chooses_the_prior_jax_chooses(likelihood, sub, hs):
    rng = np.random.default_rng(7)
    X = rng.standard_normal((24, 3))
    y = rng.standard_normal((24, 2)) if likelihood == "regression" else rng.integers(0, 2, 24)
    jm = JaxMLP(hidden=(8,), out_dim=2, dtype=jnp.float64)
    params = jm.init(jax.random.key(1), jnp.asarray(X[:1]))
    tm = MLP(3, (8,), 2).double()
    tm.load_state_dict(state_dict_from_flax(params, tm))
    jla = JaxLaplace(JaxNNModel.from_flax(jm, params), likelihood, sub, hs)
    tla = Laplace(tm, likelihood, sub, hs, device="cpu")
    jla.fit(jdata.ArrayLoader(X[:16], y[:16], batch_size=8))
    tla.fit(tdata.ArrayLoader(X[:16], y[:16], batch_size=8))
    kw = dict(method="gridsearch", grid_size=25, log_prior_prec_min=-3, log_prior_prec_max=3)
    jla.optimize_prior_precision(val_loader=jdata.ArrayLoader(X[16:], y[16:], batch_size=8), **kw)
    tla.optimize_prior_precision(val_loader=tdata.ArrayLoader(X[16:], y[16:], batch_size=8), **kw)
    grid = np.logspace(-3, 3, 25)
    got = float(tla.prior_precision[0])
    assert np.isclose(grid, got, rtol=1e-12, atol=0).any()
    np.testing.assert_allclose(got, float(jla.prior_precision[0]), rtol=1e-12)
    with pytest.raises(ValueError, match="validation"):
        tla.optimize_prior_precision(method="gridsearch")
