"""Functional samples for Thompson sampling and Monte-Carlo expectations.

The PyTorch counterpart of `examples/expectation_example.py`:
`functional_samples` draws from the function-space posterior (GLM or NN
predictive) of an all-weights KFAC Laplace to estimate expectations, here
the Monte-Carlo expected improvement, and one draw's argmax for Thompson
sampling.

Run: python examples_torch/expectation_example.py [--device cpu]
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


def main(device=None, n_epochs=300, n_steps=50, n_samples=256):
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, size=(64, 1)).astype(np.float32)
    y = (np.sin(2 * X) + 0.1 * rng.standard_normal(X.shape)).astype(np.float32)
    loader = ArrayLoader(X, y, batch_size=64)

    net = MLP(1, (32,), 1, "tanh")
    gen = torch.Generator().manual_seed(0)
    for i in range(net.n_dense):
        init_dense(getattr(net, f"Dense_{i}"), gen)
    net = net.to(device)
    opt = torch.optim.Adam(net.parameters(), lr=1e-2)
    for _ in range(n_epochs):
        for xb, yb in loader:
            xb, yb = torch.as_tensor(xb, device=device), torch.as_tensor(yb, device=device)
            opt.zero_grad()
            ((net(xb) - yb) ** 2).mean().backward()
            opt.step()

    la = Laplace(net, "regression", subset_of_weights="all", hessian_structure="kron",
                 device=device)
    la.fit(loader)
    la.optimize_prior_precision(method="marglik", n_steps=n_steps)

    x_cand = torch.linspace(-2, 2, 50, device=device).reshape(-1, 1)
    best_y = float(y.max())
    out = {}
    for pred_type in ("glm", "nn"):
        fs = la.functional_samples(x_cand, pred_type=pred_type, n_samples=n_samples,
                                   generator=torch.Generator(device).manual_seed(0))  # (S, 50, 1)
        # Monte-Carlo expected improvement over the incumbent
        ei = (fs[..., 0] - best_y).clamp(min=0.0).mean(0)
        x_star = float(x_cand[int(ei.argmax()), 0])
        # Thompson sampling: argmax of one posterior function draw
        x_ts = float(x_cand[int(fs[0, :, 0].argmax()), 0])
        print(f"[{pred_type}] MC-EI argmax x={x_star:+.2f}; "
              f"Thompson draw argmax x={x_ts:+.2f}; max EI={float(ei.max()):.4f}")
        out[pred_type] = {"ei_argmax_x": x_star, "thompson_argmax_x": x_ts,
                          "max_ei": float(ei.max())}
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    main(ap.parse_args().device)
