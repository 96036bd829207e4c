"""The seven `examples_torch/*.py` scripts on the CPU, and the Laplace part of
two of them against the JAX package's examples.

Smoke: each script's `main(device="cpu")` at reduced epochs and steps (the
sizes are passed in; the scripts keep the JAX examples' own as defaults),
every returned number finite, probit rows summing to 1 within 1e-5, and the
regression example's joint-vs-marginal asserts (inside its `main`).

Parity, float64, training skipped: the flax model initialized from a seed
and carried into the torch twin (`state_dict_from_flax`), then the
example's Laplace calls on both sides. Regression: `FullLaplace`, 5 steps
of the example's hyperparameter tuning, the log marglik and the GLM
`(f_mu, f_var)` within 1e-8 relative, and the joint predictive's diagonal
against `f_var`. Hugging Face style: the last layer found, the `FullLL` fit
with 5 marglik tuning steps and a `KronLL` fit, the probit and the log
marglik of each within 1e-8.
"""

import importlib
import importlib.util
import math
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from laplace_jax import Laplace as JaxLaplace
from laplace_jax.nnmodel import NNModel as JaxNNModel
from laplace_jax.utils.data import ArrayLoader as JaxLoader
from laplace_jax_torch import Laplace
from laplace_jax_torch.models.resnet import state_dict_from_flax
from laplace_jax_torch.utils.data import ArrayLoader

# several test workers share the CPU: one intra-op thread each
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PARITY_TOL = 1e-8  # float64, relative

# each example's sizes cut for the CPU; the scripts' defaults are the JAX examples'
SMOKE = {
    "regression_example": dict(n_epochs=3, n_epochs_online=1),
    "calibration_example": dict(n_train=64, n_test=64, n_val=64, n_epochs=1, grid_size=3),
    "calibration_gp_example": dict(n_train=64, n_test=32, n_epochs=1, n_subsets=(16, 32)),
    "huggingface_example": dict(n_steps=2),
    "reward_modeling_example": dict(N=64, n_epochs=1, n_steps=2),
    "bayesopt_example": dict(n_iters=2, n_epochs=3, n_steps=2, acq_steps=3),
    "expectation_example": dict(n_epochs=3, n_steps=2, n_samples=8),
}


def example(name):
    return importlib.import_module(f"examples_torch.{name}")


def test_every_jax_example_has_a_torch_script():
    assert set(SMOKE) == {p.stem for p in (ROOT / "examples").glob("*.py")}
    assert set(SMOKE) == {p.stem for p in (ROOT / "examples_torch").glob("*.py")}
    assert set(SMOKE) == set(chip_smoke.EXAMPLES)


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_example_runs_on_the_cpu(name):
    """The checks of `chip_smoke.py`'s `examples` phase."""
    out = example(name).main(device="cpu", **SMOKE[name])
    vals = chip_smoke.result_numbers(out)
    assert vals and all(math.isfinite(v) for v in vals)
    errs = chip_smoke.row_sum_errors(out)
    assert all(e <= chip_smoke.ROW_TOL for e in errs)
    if name in ("huggingface_example", "calibration_example", "calibration_gp_example"):
        assert errs


def test_examples_want_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="No CUDA device"):
        example("expectation_example").main(n_epochs=1)


class FlaxRegressionMLP(fnn.Module):
    """`examples/regression_example.py`'s MLP."""

    @fnn.compact
    def __call__(self, x):
        x = jnp.tanh(fnn.Dense(50, param_dtype=jnp.float64)(x))
        return fnn.Dense(1, param_dtype=jnp.float64)(x)


def _close(got, want, tol=PARITY_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-300))


def test_regression_laplace_matches_jax():
    reg = example("regression_example")
    X_train, y_train, X_test = reg.make_data()
    model = FlaxRegressionMLP()
    params = model.init(jax.random.key(711), jnp.ones((1, 1)))
    net = reg.make_model("cpu")
    net.load_state_dict(state_dict_from_flax(params, net))

    la_j = JaxLaplace(JaxNNModel.from_flax(model, params), "regression",
                      subset_of_weights="all", hessian_structure="full")
    la_j.fit(JaxLoader(X_train, y_train, batch_size=150))
    la = Laplace(net, "regression", subset_of_weights="all", hessian_structure="full",
                 device="cpu")
    la.fit(ArrayLoader(X_train, y_train, batch_size=150))

    # the example's tuning: Adam (1e-1) on log (prior precision, sigma)
    log_hyper, opt = jnp.zeros(2), optax.adam(1e-1)
    state = opt.init(log_hyper)
    grad = jax.jit(jax.value_and_grad(
        lambda h: -la_j.log_marginal_likelihood(jnp.exp(h[0:1]), jnp.exp(h[1]))))
    for _ in range(5):
        neg, g = grad(log_hyper)
        updates, state = opt.update(g, state)
        log_hyper = optax.apply_updates(log_hyper, updates)
    la_j.prior_precision = jnp.exp(log_hyper[0:1])
    la_j.sigma_noise = jnp.exp(log_hyper[1])
    marglik = reg.tune_hyperparameters(la, 5, "cpu")
    _close(marglik, -float(neg))
    _close(la.prior_precision.numpy(), np.asarray(la_j.prior_precision))
    _close(float(la.sigma_noise), float(la_j.sigma_noise))
    _close(float(la.log_marginal_likelihood()), float(la_j.log_marginal_likelihood()))

    f_mu, f_var = la(X_test)
    f_mu_j, f_var_j = la_j(jnp.asarray(X_test))
    _close(f_mu.numpy(), np.asarray(f_mu_j))
    _close(f_var.numpy(), np.asarray(f_var_j))
    f_mu_joint, f_cov = la(X_test, joint=True)
    _close(f_mu_joint.numpy(), f_mu.numpy().ravel())
    _close(torch.diagonal(f_cov).numpy(), f_var.numpy().ravel())


def _jax_huggingface():
    """`examples/huggingface_example.py` loaded by path (its `main` is guarded)."""
    spec = importlib.util.spec_from_file_location("jax_huggingface_example",
                                                  ROOT / "examples" / "huggingface_example.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_huggingface_laplace_matches_jax():
    hf = example("huggingface_example")
    data = hf.make_data()
    flax_model = _jax_huggingface().TinyTransformerClassifier()
    variables = flax_model.init(jax.random.key(0),
                                {k: jnp.asarray(v[:1]) for k, v in data.items()})
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
    net = hf.TinyTransformerClassifier().double()
    net.load_state_dict(state_dict_from_flax(variables, net))
    nnm = JaxNNModel.from_flax(flax_model, variables)
    test = {k: v[:8] for k, v in data.items()}
    kw = dict(subset_of_weights="last_layer", dict_key_x="input_ids", dict_key_y="labels")

    for hessian, n_steps in (("full", 5), ("kron", 0)):
        la_j = JaxLaplace(nnm, "classification", hessian_structure=hessian, **kw)
        la_j.fit(JaxLoader(data, batch_size=16))
        la = Laplace(net, "classification", hessian_structure=hessian, device="cpu", **kw)
        la.fit(ArrayLoader(data, batch_size=16))
        assert tuple(la.last_layer_path) == tuple(la_j.last_layer_path) == ("Dense_2",)
        if n_steps:
            la_j.optimize_prior_precision(method="marglik", n_steps=n_steps)
            la.optimize_prior_precision(method="marglik", n_steps=n_steps)
            _close(la.prior_precision.numpy(), np.asarray(la_j.prior_precision))
        _close(float(la.log_marginal_likelihood()), float(la_j.log_marginal_likelihood()))
        probs = la(test, link_approx="probit")
        _close(probs.numpy(), np.asarray(la_j({k: jnp.asarray(v) for k, v in test.items()},
                                              link_approx="probit")))
        assert float((probs.sum(-1) - 1).abs().max()) <= chip_smoke.ROW_TOL
