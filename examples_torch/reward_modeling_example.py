"""Bayesian reward modeling with a Bradley-Terry likelihood.

The PyTorch counterpart of `examples/reward_modeling_example.py`: train a
reward model on preference pairs `(B, 2, D)` (2-way cross-entropy on the
pair's rewards), fit an all-weights diagonal Laplace with
`likelihood="reward_modeling"` (classification over which of the two is
preferred), then predict rewards with uncertainty as regression on
`(B, D)`.

Run: python examples_torch/reward_modeling_example.py [--device cpu]
(on the CUDA card by default; without one, pass `--device cpu`).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
from torch import nn

from laplace_jax_torch import Laplace
from laplace_jax_torch.models.flax_layers import init_dense
from laplace_jax_torch.utils.data import ArrayLoader
from laplace_jax_torch.utils.device import resolve_device


class RewardModel(nn.Module):
    """The example's flax reward head (`Dense_0` to 32, tanh, `Dense_1` to
    1): per-pair preference logits (B, 2) on paired inputs (B, 2, D), a
    reward (B, 1) on single inputs (B, D)."""

    def __init__(self, in_dim, generator=None):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, 32)
        self.Dense_1 = nn.Linear(32, 1)
        init_dense(self.Dense_0, generator)
        init_dense(self.Dense_1, generator)

    def forward(self, x):
        out = self.Dense_1(torch.tanh(self.Dense_0(x)))
        return out[..., 0] if x.ndim == 3 else out


def main(device=None, D=8, N=512, n_epochs=100, n_steps=50):
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    true_w = rng.standard_normal(D)

    # preference pairs: y = 1 if the second item has the higher true reward
    X_pairs = rng.standard_normal((N, 2, D)).astype(np.float32)
    rewards = X_pairs @ true_w
    y = (rewards[:, 1] > rewards[:, 0]).astype(np.int64)
    loader = ArrayLoader(X_pairs, y, batch_size=64, shuffle=True)

    net = RewardModel(D, generator=torch.Generator().manual_seed(0)).to(device)
    # train with Bradley-Terry (= 2-way cross entropy on the pair logits)
    opt = torch.optim.Adam(net.parameters(), lr=1e-2)
    for _ in range(n_epochs):
        for x, yb in loader:
            x, yb = torch.as_tensor(x, device=device), torch.as_tensor(yb, device=device)
            opt.zero_grad()
            loss = torch.nn.functional.cross_entropy(net(x), yb)
            loss.backward()
            opt.step()
    print(f"BT training loss: {float(loss.detach()):.4f}")

    # reward-modeling Laplace: classification during the fit, regression at eval
    la = Laplace(net, "reward_modeling", subset_of_weights="all", hessian_structure="diag",
                 device=device)
    la.fit(loader)
    la.optimize_prior_precision(method="marglik", n_steps=n_steps)

    X_eval = rng.standard_normal((5, D)).astype(np.float32)
    r_mu, r_var = (t.cpu().numpy() for t in la(X_eval, pred_type="glm"))
    true_r = X_eval @ true_w
    print("reward predictions (mean ± std | true):")
    for i in range(5):
        print(f"  {r_mu[i, 0]:+.2f} ± {np.sqrt(r_var[i, 0, 0]):.2f} | {true_r[i]:+.2f}")
    return {"bt_loss": float(loss.detach()), "reward_mean": r_mu[:, 0].tolist(),
            "reward_std": np.sqrt(r_var[:, 0, 0]).tolist(), "true_reward": true_r.tolist(),
            "prior_precision": float(la.prior_precision[0])}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    main(ap.parse_args().device)
