"""Diagonal SWAG variances (port of `laplace_jax/utils/swag.py`).

SGD with a large learning rate from the MAP; the running first and second
moments of the flat parameter vector over snapshots (one every
`snapshot_freq` epochs) give clipped marginal variances.

The JAX package's optimizer is optax's
`chain(add_decayed_weights(wd), sgd(lr, momentum))`: `g + wd θ` into a
momentum trace `t = g + momentum t` that starts at zero (so its first value
is g), and the step `θ − lr t`. That is `torch.optim.SGD(lr=lr,
momentum=momentum, weight_decay=wd)` with its defaults (dampening 0, no
Nesterov), whose buffer starts as the first gradient; the port uses it.
"""

from __future__ import annotations

from typing import Iterator

import torch
from torch import nn

from laplace_jax_torch.enums import Likelihood
from laplace_jax_torch.nnmodel import NNModel
from laplace_jax_torch.utils.data import loader_batches
from laplace_jax_torch.utils.device import resolve_device, to_device

__all__ = ["fit_diagonal_swag_var", "swag_iterates"]


def swag_iterates(model: nn.Module | NNModel, train_loader,
                  likelihood=Likelihood.CLASSIFICATION, lr: float = 0.01,
                  momentum: float = 0.9, weight_decay: float = 3e-4,
                  device=None) -> Iterator[torch.Tensor]:
    """The flat parameter vector (canonical order) after each epoch of SGD
    on the mean loss from the model's current weights, without end; the
    module's own weights are left as they are."""
    device = resolve_device(device)
    nnm = model if isinstance(model, NNModel) else NNModel(model)
    nnm.module.to(device)
    theta = nnm.mean_vector.clone().requires_grad_(True)
    opt = torch.optim.SGD([theta], lr=lr, momentum=momentum, weight_decay=weight_decay)

    def criterion(f, y):
        if likelihood == Likelihood.REGRESSION:
            return ((f - y) ** 2).mean()
        return -torch.gather(torch.log_softmax(f, dim=-1), -1, y[..., None].long()).mean()

    while True:
        for x, y in loader_batches(train_loader):
            x, y = to_device(x, device, theta.dtype), to_device(y, device, theta.dtype)
            opt.zero_grad()
            criterion(nnm.apply_vec(theta, x), y).backward()
            opt.step()
        yield theta.detach().clone()


def fit_diagonal_swag_var(model: nn.Module | NNModel, train_loader,
                          likelihood=Likelihood.CLASSIFICATION, n_snapshots_total: int = 40,
                          snapshot_freq: int = 1, lr: float = 0.01, momentum: float = 0.9,
                          weight_decay: float = 3e-4, min_var: float = 1e-30,
                          device=None) -> torch.Tensor:
    """Marginal parameter variances (n_params,) from diagonal SWAG over
    `snapshot_freq * n_snapshots_total` epochs, on `device` (CUDA unless
    the caller passes `device="cpu"`)."""
    device = resolve_device(device)
    nnm = model if isinstance(model, NNModel) else NNModel(model)
    nnm.module.to(device)
    mean = torch.zeros_like(nnm.mean_vector)
    sq_mean = torch.zeros_like(mean)
    n_snapshots = 0
    iterates = swag_iterates(nnm, train_loader, likelihood, lr, momentum, weight_decay, device)
    for epoch in range(snapshot_freq * n_snapshots_total):
        theta = next(iterates)
        if epoch % snapshot_freq == 0:
            old_fac, new_fac = n_snapshots / (n_snapshots + 1), 1.0 / (n_snapshots + 1)
            mean = mean * old_fac + theta * new_fac
            sq_mean = sq_mean * old_fac + theta ** 2 * new_fac
            n_snapshots += 1
    return torch.clamp(sq_mean - mean ** 2, min=min_var)
