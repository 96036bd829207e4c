"""Laplace approximation as a Bayesian-optimization surrogate.

The PyTorch counterpart of `examples/bayesopt_example.py`: a last-layer
KFAC Laplace with `enable_backprop=True` is the surrogate of a 1-D
objective, and the acquisition (UCB, mean plus two standard deviations of
the GLM predictive) is maximized by gradient ascent through the predictive
in the input. Five rounds of fit, acquire and query.

Run: python examples_torch/bayesopt_example.py [--device cpu]
(on the CUDA card by default; without one, pass `--device cpu`).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from laplace_jax_torch import Laplace
from laplace_jax_torch.models.flax_layers import init_dense
from laplace_jax_torch.models.mlp import MLP
from laplace_jax_torch.utils.data import ArrayLoader
from laplace_jax_torch.utils.device import resolve_device


def objective(x):
    """1-D test function (maximize)."""
    return np.sin(3 * x) - 0.1 * x**2


def fit_surrogate(X, y, device, n_epochs=500, n_steps=50):
    net = MLP(1, (32, 32), 1, "tanh")
    gen = torch.Generator().manual_seed(0)
    for i in range(net.n_dense):
        init_dense(getattr(net, f"Dense_{i}"), gen)
    net = net.to(device)
    loader = ArrayLoader(X.astype(np.float32), y.astype(np.float32), batch_size=len(X))

    opt = torch.optim.Adam(net.parameters(), lr=1e-2)
    for _ in range(n_epochs):
        for xb, yb in loader:
            xb, yb = torch.as_tensor(xb, device=device), torch.as_tensor(yb, device=device)
            opt.zero_grad()
            ((net(xb) - yb) ** 2).mean().backward()
            opt.step()

    la = Laplace(net, "regression", subset_of_weights="last_layer", hessian_structure="kron",
                 enable_backprop=True, device=device)
    la.fit(loader)
    la.optimize_prior_precision(method="marglik", n_steps=n_steps)
    return la


def optimize_acquisition(la, x0, device, steps=100, lr=0.05):
    """Maximize UCB = mu(x) + 2 sigma(x) by gradient ascent through the
    predictive."""
    x = torch.tensor(x0, dtype=torch.float32, device=device)
    for _ in range(steps):
        x.requires_grad_(True)
        f_mu, f_var = la(x.reshape(1, 1), pred_type="glm")
        neg_ucb = -(f_mu[0, 0] + 2.0 * torch.sqrt(f_var[0, 0, 0]))
        (grad,) = torch.autograd.grad(neg_ucb, x)
        x = (x.detach() - lr * grad).clamp(-3.0, 3.0)
    return float(x)


def main(device=None, n_iters=5, n_epochs=500, n_steps=50, acq_steps=100):
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    X = rng.uniform(-3, 3, size=(8, 1))
    y = objective(X) + 0.05 * rng.standard_normal(X.shape)

    queries = []
    for it in range(n_iters):
        la = fit_surrogate(X, y, device, n_epochs, n_steps)
        x_next = optimize_acquisition(la, float(rng.uniform(-3, 3)), device, steps=acq_steps)
        y_next = objective(np.asarray([[x_next]]))
        print(f"iter {it}: query x={x_next:+.3f}, f(x)={float(y_next[0, 0]):+.3f}")
        queries.append([x_next, float(y_next[0, 0])])
        X = np.concatenate([X, [[x_next]]])
        y = np.concatenate([y, y_next])

    best = float(X[np.argmax(y), 0])
    print(f"best x found: {best:+.3f} (f={float(y.max()):+.3f})")
    return {"queries": queries, "best_x": best, "best_f": float(y.max())}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    main(ap.parse_args().device)
