"""Sinusoid regression with a full Laplace posterior and post-hoc marglik tuning.

The PyTorch counterpart of `examples/regression_example.py`: train a 1-50-1
tanh MLP to its MAP, fit an all-weights `FullLaplace`, tune (prior
precision, observation noise) by differentiating the log marginal
likelihood, check that the joint and the marginal predictive agree, then do
the same end to end with `marglik_training`. Float64 throughout, as there.

Run: python examples_torch/regression_example.py [--device cpu]
(on the CUDA card by default; without one, pass `--device cpu`).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from laplace_jax_torch import Laplace, marglik_training
from laplace_jax_torch.models.flax_layers import init_dense
from laplace_jax_torch.models.mlp import MLP
from laplace_jax_torch.utils.data import ArrayLoader
from laplace_jax_torch.utils.device import resolve_device


def make_data():
    """The toy sinusoid: 150 noisy training points on [0, 8], 200 test
    inputs on [-4, 12]."""
    rng = np.random.default_rng(711)
    X_train = rng.uniform(0, 8, size=(150, 1))
    y_train = np.sin(X_train) + rng.standard_normal((150, 1)) * 0.3
    X_test = np.linspace(-4, 12, 200).reshape(-1, 1)
    return X_train, y_train, X_test


def make_model(device):
    """The example's flax MLP (`Dense_0` 1 -> 50, tanh, `Dense_1` 50 -> 1),
    float64, with flax's initializers drawn from seed 711."""
    net = MLP(1, (50,), 1, "tanh").double()
    gen = torch.Generator().manual_seed(711)
    for i in range(net.n_dense):
        init_dense(getattr(net, f"Dense_{i}"), gen)
    return net.to(device)


def train_map(net, loader, n_epochs, device):
    """Adam (lr 1e-2) on the mean squared error; returns the last loss."""
    opt = torch.optim.Adam(net.parameters(), lr=1e-2)
    for _ in range(n_epochs):
        for x, y in loader:
            x, y = torch.as_tensor(x, device=device), torch.as_tensor(y, device=device)
            opt.zero_grad()
            loss = ((net(x) - y) ** 2).mean()
            loss.backward()
            opt.step()
    return float(loss.detach())


def tune_hyperparameters(la, n_steps, device):
    """Adam (lr 1e-1) on (log prior precision, log sigma) against the
    negative log marginal likelihood; sets the tuned values on `la` and
    returns the last marglik."""
    log_hyper = torch.zeros(2, dtype=torch.float64, device=device, requires_grad=True)
    opt = torch.optim.Adam([log_hyper], lr=1e-1)
    for _ in range(n_steps):
        opt.zero_grad()
        neg_marglik = -la.log_marginal_likelihood(log_hyper[0:1].exp(), log_hyper[1].exp())
        neg_marglik.backward()
        opt.step()
    with torch.no_grad():
        la.prior_precision = log_hyper[0:1].exp()
        la.sigma_noise = log_hyper[1].exp()
    return -float(neg_marglik.detach())


def main(device=None, n_epochs=500, n_epochs_online=100):
    device = resolve_device(device)
    X_train, y_train, X_test = make_data()
    train_loader = ArrayLoader(X_train, y_train, batch_size=150)

    net = make_model(device)
    final_loss = train_map(net, train_loader, n_epochs, device)
    print(f"MAP training loss: {final_loss:.4f}")

    la = Laplace(net, "regression", subset_of_weights="all", hessian_structure="full",
                 device=device)
    la.fit(train_loader)
    marglik = tune_hyperparameters(la, n_epochs, device)
    sigma, prior_prec = float(la.sigma_noise), float(la.prior_precision[0])
    print(f"sigma={sigma:.2f}", f"prior precision={prior_prec:.2f}", f"marglik={marglik:.2f}")

    f_mu, f_var = (t.cpu().numpy() for t in la(X_test))
    f_mu_joint, f_cov = (t.cpu().numpy() for t in la(X_test, joint=True))
    assert np.allclose(f_mu.ravel(), f_mu_joint)
    assert np.allclose(f_var.ravel(), np.diag(f_cov), atol=1e-8)
    joint_err = (float(np.abs(f_mu.ravel() - f_mu_joint).max()),
                 float(np.abs(f_var.ravel() - np.diag(f_cov)).max()))
    pred_std = np.sqrt(f_var.squeeze() + sigma**2)
    print("predictive mean/std on 5 test points:")
    for i in range(0, 200, 50):
        print(f"  x={X_test[i, 0]:+.2f}  f={f_mu[i, 0]:+.3f} ± {pred_std[i]:.3f}")

    # alternatively: online marglik training
    la2, _, margliks, _ = marglik_training(
        make_model(device), train_loader, likelihood="regression", hessian_structure="full",
        n_epochs=n_epochs_online, optimizer_kwargs={"lr": 1e-2}, prior_structure="scalar",
        device=device)
    online_prior = la2.prior_precision.detach().cpu().numpy()
    print(f"online: sigma={float(la2.sigma_noise):.2f}", f"prior precision={online_prior}",
          f"final marglik={margliks[-1]:.2f}")
    return {"map_loss": final_loss, "sigma_noise": sigma, "prior_precision": prior_prec,
            "marglik": marglik, "joint_mu_max_diff": joint_err[0],
            "joint_var_max_diff": joint_err[1], "test_x": X_test[::50, 0].tolist(),
            "f_mu": f_mu[::50, 0].tolist(), "pred_std": pred_std[::50].tolist(),
            "online_sigma_noise": float(la2.sigma_noise),
            "online_prior_precision": online_prior.tolist(),
            "online_final_marglik": float(margliks[-1])}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    main(ap.parse_args().device)
