"""Running metrics of the validation loop and the gridsearch (port of
`laplace_jax/utils/metrics.py`)."""

from __future__ import annotations

import numpy as np
import torch


def _as_tensor(x, like=None) -> torch.Tensor:
    return torch.as_tensor(x, device=None if like is None else like.device)


class RunningNLLMetric:
    """Accumulates the NLL of predicted class probabilities, leaving out
    targets equal to `ignore_index`."""

    def __init__(self, ignore_index: int = -100):
        self.ignore_index = ignore_index
        self.reset()

    def reset(self) -> None:
        self.nll_sum = 0.0
        self.n_valid = 0

    def update(self, probs, targets) -> None:
        probs = _as_tensor(probs)
        probs = probs.reshape(-1, probs.shape[-1])
        targets = _as_tensor(targets, probs).reshape(-1).long()
        valid = targets != self.ignore_index
        safe = torch.where(valid, targets, torch.zeros_like(targets))
        logp = torch.log(probs)[torch.arange(targets.shape[0], device=probs.device), safe]
        self.nll_sum += float(torch.where(valid, -logp, torch.zeros_like(logp)).sum())
        self.n_valid += int(valid.sum())

    def compute(self) -> float:
        return self.nll_sum / max(self.n_valid, 1)


class RunningMSEMetric:
    """Running mean squared error, summed over the output dims."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.sq_sum = 0.0
        self.n = 0

    def update(self, mean, targets) -> None:
        mean = _as_tensor(mean)
        self.sq_sum += float(((mean - _as_tensor(targets, mean)) ** 2).sum())
        self.n += int(mean.shape[0])

    def compute(self) -> float:
        return self.sq_sum / max(self.n, 1)


def expected_calibration_error(probs, targets, n_bins: int = 15) -> float:
    """Binned ECE over the max-probability confidence."""
    probs = np.asarray(torch.as_tensor(probs).detach().cpu())
    targets = np.asarray(torch.as_tensor(targets).cpu())
    conf = probs.max(-1)
    acc = (probs.argmax(-1) == targets).astype(np.float64)
    bins = np.linspace(0.0, 1.0, n_bins + 1)
    ece = 0.0
    for lo, hi in zip(bins[:-1], bins[1:]):
        sel = (conf > lo) & (conf <= hi)
        if sel.sum() == 0:
            continue
        ece += sel.mean() * abs(acc[sel].mean() - conf[sel].mean())
    return float(ece)


def get_nll(out_dist, targets) -> torch.Tensor:
    """Mean NLL of class-probability predictions."""
    out_dist = _as_tensor(out_dist)
    targets = _as_tensor(targets, out_dist).long()
    return -torch.log(out_dist)[torch.arange(targets.shape[0], device=out_dist.device),
                                targets].mean()
