"""The plain reference against the port on the CPU, in float64, at tiny
widths: KFAC factors, eigenvalues, the log marginal likelihood and the
last-layer probit predictive."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import tiny  # noqa: E402
from benchmark import harness  # noqa: E402
from benchmark.reference import kfac, posterior  # noqa: E402
from benchmark.reference.layers import Ops, same_pad  # noqa: E402
from benchmark.weights import build_model, make_inputs, make_weights  # noqa: E402

CPU = torch.device("cpu")


def tiny_config(cell: str) -> dict:
    name = cell.split(".")[0]
    return harness.merge(harness.load_config(name), tiny.TINY[cell][0])


def f64(config: dict, seed: int):
    w = {k: v.double() for k, v in make_weights(config, seed, CPU).items()}
    return w, build_model(config, w, CPU).double()


@pytest.mark.parametrize("n, k, s, out, pads", [(32, 3, 1, 32, (1, 1)), (32, 3, 2, 16, (0, 1)),
                                                 (32, 1, 2, 16, (0, 0)), (7, 3, 2, 4, (1, 1))])
def test_same_pad_is_flax_same(n, k, s, out, pads):
    assert same_pad(n, k, s) == (out, pads)


@pytest.mark.parametrize("cell", sorted(tiny.TINY))
def test_forward_matches_port(cell):
    config = tiny_config(cell)
    w, net = f64(config, 3)
    X, _ = make_inputs(config, 5, 3, "fit_inputs", CPU)
    f, _ = harness.reference_forward(config)(Ops(w, config["layers"]), X.double())
    torch.testing.assert_close(f, net(X.double()), rtol=1e-12, atol=1e-12)


def test_kfac_eig_marglik_match_port():
    from laplace_jax_torch import Laplace
    from laplace_jax_torch.utils.data import ArrayLoader

    cell = "resnet18-cifar10.kron-fit-n512"
    config = tiny_config(cell)
    w, net = f64(config, 5)
    X, y = make_inputs(config, 12, 5, "fit_inputs", CPU)
    la = Laplace(net, "classification", subset_of_weights="all", hessian_structure="kron",
                 device="cpu")
    la.fit(ArrayLoader(X.double(), y, batch_size=4))
    factors, loss = kfac.kfac_factors(harness.reference_forward(config), w, config["layers"],
                                      X, y, batch_size=4)
    groups = kfac.groups(factors, config["layers"])
    names = [s.name for s in la.model.leaf_specs]
    assert sorted(names) == sorted(groups)
    for name, F in zip(names, la.H_facs.kfacs):
        for a, b in zip(F, groups[name], strict=True):
            torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)
    vals = posterior.eigvals(groups)
    for name, ls in zip(names, la.H.eigenvalues):
        for a, b in zip(ls, vals[name], strict=True):
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-11)
    theta_sq = sum((w[k] ** 2).sum() for k in groups)
    for delta in (1.0, 0.3):
        ref = posterior.log_marglik(loss, vals, theta_sq, delta)
        assert float(la.log_marginal_likelihood(prior_precision=delta)) == pytest.approx(
            float(ref), rel=1e-10)


def test_ll_posterior_tuning_probit_match_port():
    from laplace_jax_torch import Laplace
    from laplace_jax_torch.utils.data import ArrayLoader

    cell = "wrn16-4-cifar10.ll-probit-b512"
    config = tiny_config(cell)
    w, net = f64(config, 9)
    X, y = make_inputs(config, 24, 9, "fit_inputs", CPU)
    Xt, _ = make_inputs(config, 6, 9, "test_inputs", CPU)
    la = Laplace(net, "classification", device="cpu")
    la.fit(ArrayLoader(X.double(), y, batch_size=8))
    la.optimize_prior_precision(method="marglik", n_steps=30, lr=0.1)
    forward, head = harness.reference_forward(config), config["layers"][-1]
    f, phi = forward(Ops(w, config["layers"]), X.double())
    fac = kfac.last_layer_factors(phi, f)
    groups = kfac.groups({head["name"]: fac}, [head])
    for name, F in zip([s.name for s in la.model.leaf_specs], la.H_facs.kfacs):
        for a, b in zip(F, groups[name], strict=True):
            torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)
    vals = posterior.eigvals(groups)
    theta_sq = sum((w[k] ** 2).sum() for k in groups)
    delta = posterior.tune_prior(kfac.cross_entropy_sum(f, y), vals, theta_sq, 30, 0.1)
    assert float(la.prior_precision[0]) == pytest.approx(float(delta), rel=1e-8)
    ft, phit = forward(Ops(w, config["layers"]), Xt.double())
    eig = {k: tuple(torch.linalg.eigh(F) for F in fs) for k, fs in groups.items()}
    Sigma = posterior.ll_covariance(eig, head["name"], delta, torch.float64)
    H = torch.block_diag(fac["B"], torch.kron(fac["A"], fac["B"]))
    torch.testing.assert_close(Sigma, torch.linalg.inv(H + delta * torch.eye(H.shape[0],
                                                                             dtype=H.dtype)),
                               rtol=1e-8, atol=1e-10)
    probs = posterior.ll_probit(ft, phit, Sigma, bias=True)
    torch.testing.assert_close(la(Xt.double(), pred_type="glm", link_approx="probit"), probs,
                               rtol=1e-9, atol=1e-12)
