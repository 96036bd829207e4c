"""Online marginal-likelihood training (Immer et al. 2021, Alg. 1; port of
`laplace_jax/marglik_training.py`).

The network trains with `torch.optim.Adam` on the mean loss plus the prior term. Every `marglik_frequency` epochs (from epoch
`n_epochs_burnin` on) one all-weights Laplace is refit at the current
weights, and `n_hypersteps` Adam steps on `(log_prior_prec,
log_sigma_noise)` follow against the negative log marginal likelihood of
that cached curvature. The weights and hyperparameters of the best
(lowest) negative marglik are restored at the end, and the Laplace is refit
there.

The training forward runs in the caller's precision settings; only the
port's own Laplace calls (fit, marglik) scope TF32 off (`utils/device.full_f32`).
The hyperparameter steps are a Python loop (the JAX package runs them as
one `lax.scan`).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from laplace_jax_torch.enums import HessianStructure, Likelihood, PriorStructure
from laplace_jax_torch.laplace import Laplace
from laplace_jax_torch.nnmodel import NNModel, unpack_batch
from laplace_jax_torch.utils.data import dataset_size
from laplace_jax_torch.utils.device import resolve_device, to_device
from laplace_jax_torch.utils.flatten import parameters_to_vector
from laplace_jax_torch.utils.prior import expand_prior_precision_sizes, fix_prior_prec_structure

__all__ = ["marglik_training"]


def marglik_training(
    model: torch.nn.Module,
    train_loader,
    likelihood: Likelihood | str = Likelihood.CLASSIFICATION,
    hessian_structure: HessianStructure | str = HessianStructure.KRON,
    optimizer_kwargs: dict | None = None,
    n_epochs: int = 300,
    lr_hyp: float = 1e-1,
    prior_structure: PriorStructure | str = PriorStructure.LAYERWISE,
    n_epochs_burnin: int = 0,
    n_hypersteps: int = 10,
    marglik_frequency: int = 1,
    prior_prec_init: float = 1.0,
    sigma_noise_init: float = 1.0,
    temperature: float = 1.0,
    fix_sigma_noise: bool = False,
    enable_backprop: bool = False,
    dict_key_x: str = "input_ids",
    dict_key_y: str = "labels",
    backend="ggn",
    backend_kwargs: dict | None = None,
    device=None,
):
    """Train `model` and tune its prior precision (and, for regression, the
    noise) by the marginal likelihood. Returns `(la, model, margliks,
    losses)`: the all-weights Laplace fitted at the best weights, the
    trained module, the negative log marglik before each hyperparameter
    step, and each epoch's mean training loss (with the prior term).

    `optimizer_kwargs` are the network's `torch.optim.Adam` arguments
    (default `{"lr": 1e-3}`); `backend` and `backend_kwargs` choose the
    curvature, as for `Laplace` (default the GGN).
    """
    device = resolve_device(device)
    model = model.to(device)
    nnm = NNModel(model)
    specs = nnm.leaf_specs
    leaf_sizes = [s.size for s in specs]
    params = nnm.params_in_order()
    dtype = params[0].dtype
    N = dataset_size(train_loader)
    regression = likelihood == Likelihood.REGRESSION

    log_prior_prec = fix_prior_prec_structure(temperature * prior_prec_init, prior_structure,
                                              nnm.n_layers, nnm.n_params, dtype=dtype,
                                              device=device).log()
    log_sigma_noise = (torch.full((1,), sigma_noise_init, dtype=dtype, device=device).log()
                       if regression else None)

    optimizer = torch.optim.Adam(params, **(optimizer_kwargs or {"lr": 1e-3}))

    def criterion(f, y):
        """The mean loss (reference `marglik_training.py:185-190`)."""
        if regression:
            return ((f - y) ** 2).mean()
        return -torch.gather(torch.log_softmax(f, -1), -1, y[..., None].long()).mean()

    def sigma_noise():
        if not regression:
            return 1.0
        return sigma_noise_init if fix_sigma_noise else float(log_sigma_noise[0].exp())

    losses, margliks = [], []
    best_marglik, best = np.inf, None
    lap = None

    def make_lap():
        return Laplace(model, likelihood, subset_of_weights="all",
                       hessian_structure=hessian_structure,
                       sigma_noise=sigma_noise_init if regression else 1.0,
                       prior_precision=log_prior_prec.exp(), temperature=temperature,
                       dict_key_x=dict_key_x, dict_key_y=dict_key_y, backend=backend,
                       backend_kwargs=backend_kwargs, device=device)

    for epoch in range(1, n_epochs + 1):
        epoch_loss, epoch_count = 0.0, 0
        delta = expand_prior_precision_sizes(log_prior_prec.exp(), leaf_sizes)
        if regression:
            crit_factor = temperature / (2.0 * float(log_sigma_noise[0].exp()) ** 2)
        else:
            crit_factor = temperature
        for data in train_loader:
            x, y = unpack_batch(data, dict_key_y)
            x, y = to_device(x, device, dtype), to_device(y, device, dtype)
            optimizer.zero_grad()
            theta = parameters_to_vector(model, specs, detach=False)
            loss = criterion(model(x), y) + 0.5 * ((delta * theta) @ theta) / N / crit_factor
            loss.backward()
            optimizer.step()
            epoch_loss += float(loss.detach()) * y.shape[0]
            epoch_count += y.shape[0]
        losses.append(epoch_loss / epoch_count)
        logging.info(f"MARGLIK[epoch={epoch}]: network training. Loss={losses[-1]:.3f}.")

        if (epoch % marglik_frequency) != 0 or epoch < n_epochs_burnin:
            continue

        # 1. refit the one all-weights Laplace at the current weights
        if lap is None:
            lap = make_lap()
        if regression:
            lap.sigma_noise = sigma_noise()
        lap.fit(train_loader)

        # 2. Adam steps on the hyperparameters against the cached curvature
        log_pp = log_prior_prec.clone().requires_grad_(True)
        hyper = [log_pp]
        log_sn = None
        if regression and not fix_sigma_noise:
            log_sn = log_sigma_noise.clone().requires_grad_(True)
            hyper.append(log_sn)
        hyper_opt = torch.optim.Adam(hyper, lr=lr_hyp)
        for _ in range(n_hypersteps):
            hyper_opt.zero_grad()
            sn = (log_sn[0].exp() if log_sn is not None
                  else sigma_noise_init if regression else None)
            neg = -lap.log_marginal_likelihood(log_pp.exp(), sn)
            neg.backward()
            hyper_opt.step()
            margliks.append(float(neg.detach()))
        log_prior_prec = log_pp.detach()
        if log_sn is not None:
            log_sigma_noise = log_sn.detach()

        # the best snapshot (reference `marglik_training.py:316-337`)
        if margliks[-1] < best_marglik:
            best_marglik = margliks[-1]
            best = ({k: v.detach().clone() for k, v in model.state_dict().items()},
                    log_prior_prec.exp(), sigma_noise())
            logging.info(f"MARGLIK[epoch={epoch}]: MargLik={best_marglik:.2f}. Saving new best.")

    logging.info("MARGLIK: finished training. Recover best model and fit Laplace.")
    if best is not None:
        state, prior_prec, sn = best
        model.load_state_dict(state)
    else:
        prior_prec, sn = log_prior_prec.exp(), sigma_noise()
    if lap is None:  # no tuning round ran (burn-in >= n_epochs)
        lap = make_lap()
    lap.enable_backprop = enable_backprop
    lap.prior_precision = prior_prec
    if regression:
        lap.sigma_noise = sn
    lap.fit(train_loader)
    return lap, model, margliks, losses
