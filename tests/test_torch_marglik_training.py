"""The port's `marglik_training` against `laplace_jax.marglik_training` in
float64, from the same weights and data:

- MLP twin (2 -> 8 -> 1, tanh) regression, N = 32, batch 16: the three
  prior structures (scalar and layerwise on Kron, diagonal on Diag),
  `fix_sigma_noise`, burn-in and `marglik_frequency`, and the restored
  best snapshot;
- a narrow BenchCNN twin (the `bench.py` config 3a network at convs
  4/8/8/8 with biases and 3 classes, 8x8x3 inputs, N = 32, batch 16) with
  Kron classification and a layerwise prior.

`losses`, `margliks`, the final prior precision and noise, the final
parameters and the returned Laplace's marglik match within 1e-7 relative
(each against the largest entry of the JAX value). The two packages' Adam
updates round differently (optax against `torch.optim.Adam`), so the
trajectories drift apart by rounding; the largest difference measured over
these cases was 1.3e-14 relative (the BenchCNN's final prior precision; on
the CPU, float64).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from laplace_jax import marglik_training as jax_marglik_training
from laplace_jax.nnmodel import NNModel as JaxNNModel
from laplace_jax.utils.data import ArrayLoader as JaxLoader
from laplace_jax_torch import marglik_training
from laplace_jax_torch.models.mlp import MLP
from laplace_jax_torch.models.resnet import Conv, state_dict_from_flax
from laplace_jax_torch.utils.data import ArrayLoader
from laplace_jax_torch.utils.flatten import parameters_to_vector

torch.set_num_threads(1)

REL = 1e-7
N, BATCH = 32, 16


class JaxMLP(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        x = jnp.tanh(fnn.Dense(8, param_dtype=jnp.float64)(x))
        return fnn.Dense(1, param_dtype=jnp.float64)(x)


class JaxBenchCNN(fnn.Module):
    """`bench.py`'s BenchCNN at narrow widths, in float64."""

    @fnn.compact
    def __call__(self, x):
        conv = lambda c, s: fnn.Conv(c, (3, 3), strides=(s, s), param_dtype=jnp.float64)  # noqa: E731
        x = jax.nn.relu(conv(4, 1)(x))
        x = jax.nn.relu(conv(8, 2)(x))
        x = jax.nn.relu(conv(8, 1)(x))
        x = jax.nn.relu(conv(8, 2)(x))
        return fnn.Dense(3, param_dtype=jnp.float64)(x.mean(axis=(1, 2)))


class BenchCNN(nn.Module):
    """The BenchCNN twin on the port's `Conv` (flax `'SAME'` padding, bias)."""

    def __init__(self, widths=(4, 8, 8, 8), n_classes=3):
        super().__init__()
        c_in = 3
        for i, (w, s) in enumerate(zip(widths, (1, 2, 1, 2))):
            self.add_module(f"Conv_{i}", Conv(c_in, w, 3, s, use_bias=True))
            c_in = w
        self.Dense_0 = nn.Linear(c_in, n_classes)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for i in range(4):
            x = torch.relu(getattr(self, f"Conv_{i}")(x))
        return self.Dense_0(x.mean(dim=(2, 3)))


def _run(jm, tm_cls, X, y, seed, **kw):
    params = jm.init(jax.random.key(seed), jnp.asarray(X[:1]))
    tm = tm_cls().double()
    tm.load_state_dict(state_dict_from_flax(params, tm))
    j_la, j_nnm, j_ml, j_lo = jax_marglik_training(
        JaxNNModel.from_flax(jm, params), JaxLoader(X, y, batch_size=BATCH), **kw)
    t_la, t_m, t_ml, t_lo = marglik_training(tm, ArrayLoader(X, y, batch_size=BATCH),
                                             device="cpu", **kw)
    return dict(jla=j_la, tla=t_la, theta=(np.asarray(j_nnm.mean_vector),
                                           parameters_to_vector(t_m).numpy()),
                margliks=(np.asarray(j_ml), np.asarray(t_ml)),
                losses=(np.asarray(j_lo), np.asarray(t_lo)))


def _close(got, ref, rel=REL):
    ref, got = np.asarray(ref, dtype=np.float64), np.asarray(got, dtype=np.float64)
    assert got.shape == ref.shape
    if ref.size == 0:
        return
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-300))


def _reg_data():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, 2))
    return X, X[:, :1] * 0.7 + 0.1 * rng.standard_normal((N, 1))


CASES = {
    "scalar": dict(prior_structure="scalar", hessian_structure="kron", n_epochs=4,
                   n_hypersteps=3, marglik_frequency=2),
    "layerwise": dict(prior_structure="layerwise", hessian_structure="kron", n_epochs=4,
                      n_hypersteps=3, marglik_frequency=2),
    "diag": dict(prior_structure="diag", hessian_structure="diag", n_epochs=4,
                 n_hypersteps=3, marglik_frequency=2),
    "fix_sigma_noise": dict(n_epochs=3, n_hypersteps=3, sigma_noise_init=0.37,
                            fix_sigma_noise=True, temperature=0.5),
    "burn_in": dict(n_epochs=5, n_hypersteps=2, n_epochs_burnin=3, prior_prec_init=2.5,
                    sigma_noise_init=0.5),
    "burn_in_beyond_horizon": dict(n_epochs=3, n_epochs_burnin=100, prior_prec_init=2.5),
    "benchcnn": dict(hessian_structure="kron", n_epochs=2, n_hypersteps=3, marglik_frequency=1),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request):
    if request.param == "benchcnn":
        rng = np.random.default_rng(1)
        X, y = rng.standard_normal((N, 8, 8, 3)), rng.integers(0, 3, N)
        out = _run(JaxBenchCNN(), BenchCNN, X, y, 2, likelihood="classification",
                   **CASES["benchcnn"])
    else:
        X, y = _reg_data()
        out = _run(JaxMLP(), lambda: MLP(2, (8,), 1), X, y, 1, likelihood="regression",
                   **CASES[request.param])
    out["case"] = request.param
    return out


def test_losses_and_margliks_match(run):
    for key in ("losses", "margliks"):
        ref, got = run[key]
        _close(got, ref)
    assert np.isfinite(run["margliks"][1]).all()


def test_final_parameters_and_hyperparameters_match(run):
    ref, got = run["theta"]
    _close(got, ref)
    jla, tla = run["jla"], run["tla"]
    _close(tla.prior_precision.numpy(), jla.prior_precision)
    _close(float(tla.sigma_noise), float(jla.sigma_noise))
    _close(tla.mean.numpy(), jla.mean)
    np.testing.assert_allclose(float(tla.log_marginal_likelihood()),
                               float(jla.log_marginal_likelihood()), rtol=REL)
    assert type(tla).__name__ == type(jla).__name__


def test_bookkeeping(run):
    """Rounds, hyperparameter shapes and the fixed noise, as
    `tests/test_marglik_training_breadth.py` pins them."""
    case, tla = run["case"], run["tla"]
    kw = CASES[case]
    margliks, losses = run["margliks"][1], run["losses"][1]
    assert len(losses) == kw["n_epochs"]
    freq, burn = kw.get("marglik_frequency", 1), kw.get("n_epochs_burnin", 0)
    rounds = sum(1 for e in range(1, kw["n_epochs"] + 1) if e % freq == 0 and e >= burn)
    assert len(margliks) == rounds * kw.get("n_hypersteps", 10)
    n = {"scalar": 1, "diag": tla.n_params}.get(kw.get("prior_structure"), tla.n_layers)
    assert tla.prior_precision.shape == (n,)
    if case == "burn_in_beyond_horizon":
        torch.testing.assert_close(tla.prior_precision, torch.full((n,), 2.5, dtype=torch.float64))
    if kw.get("fix_sigma_noise"):
        assert float(tla.sigma_noise) == pytest.approx(0.37, rel=1e-12)


def test_best_snapshot_is_restored(run):
    """The returned Laplace is fitted at the restored weights, those of the
    round with the lowest negative marglik."""
    margliks = run["margliks"][1]
    if len(margliks):
        assert min(margliks) <= margliks[0]
    ref, got = run["theta"]
    _close(run["tla"].mean.numpy(), got, 0)
    _close(got, ref)


def test_predictive_of_the_result(run):
    tla = run["tla"]
    if run["case"] == "benchcnn":
        p = tla(np.random.default_rng(3).standard_normal((4, 8, 8, 3)))
        torch.testing.assert_close(p.sum(-1), torch.ones(4, dtype=p.dtype), rtol=0, atol=1e-12)
        assert float(tla.sigma_noise) == 1.0
    else:
        f_mu, f_var = tla(np.random.default_rng(3).standard_normal((4, 2)))
        assert f_mu.shape == (4, 1) and f_var.shape == (4, 1, 1)
        assert bool((f_var > 0).all())
