"""The check sees each fault a cell's timed path can have: a whole run on
the CPU at the cell's tiny size, past the look for a card, with the
program broken underneath, must come out not correct; the same run
unbroken, correct. One cell runs on one chip, so no exchange between
chips can be left out."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import tiny  # noqa: E402

FIT = "resnet18-cifar10.kron-fit-n512"
PREDICT = "wrn16-4-cifar10.ll-probit-b512"


def stale_fit(monkeypatch):
    """Every fit after the first returns the first one's posterior."""
    from laplace_jax_torch.baselaplace import KronLaplace

    orig, first = KronLaplace.fit, []

    def fit(self, loader, *args, **kwargs):
        if first:
            src = first[0]
            for k in ("H_facs", "H", "loss", "n_data", "n_outputs", "mean", "fit_seconds"):
                setattr(self, k, getattr(src, k))
            return
        orig(self, loader, *args, **kwargs)
        first.append(self)

    monkeypatch.setattr(KronLaplace, "fit", fit)


def half_batch_fit(monkeypatch):
    """Each batch's curvature from its first half, scaled up to the batch."""
    from laplace_jax_torch.curvature.backend import CurvatureBackend

    orig = CurvatureBackend.kron

    def kron(self, x, y, N, generator=None):
        h = x.shape[0] // 2
        loss, H = orig(self, x[:h], y[:h], N, generator)
        return 2 * loss, H * 2.0

    monkeypatch.setattr(CurvatureBackend, "kron", kron)


def altered_factor(monkeypatch):
    """One factor of each batch's curvature off by 1%."""
    from laplace_jax_torch.curvature.backend import CurvatureBackend
    from laplace_jax_torch.utils.matrix import Kron

    orig = CurvatureBackend.kron

    def kron(self, x, y, N, generator=None):
        loss, H = orig(self, x, y, N, generator)
        groups = list(H.kfacs)
        groups[-1] = (groups[-1][0] * 1.01,) + tuple(groups[-1][1:])
        return loss, Kron(groups)

    monkeypatch.setattr(CurvatureBackend, "kron", kron)


def predict_fault(kind):
    def install(monkeypatch):
        from laplace_jax_torch.baselaplace import ParametricLaplace

        orig, last = ParametricLaplace.__call__, {}

        def call(self, x, *args, **kwargs):
            n = x.shape[0]
            if kind == "stale" and n in last:
                return last[n]
            if kind == "half":
                p = orig(self, x[:n // 2], *args, **kwargs)
                return torch.cat([p, p.mean(0, keepdim=True).expand(n - n // 2, -1)])
            p = orig(self, x, *args, **kwargs)
            if kind == "altered":
                p = p.clone()
                p[0, 0] += 0.01
            last[n] = p
            return p

        monkeypatch.setattr(ParametricLaplace, "__call__", call)

    return install


def skipped_tuning(monkeypatch):
    """The prior precision left at its starting value, untuned."""
    from laplace_jax_torch.baselaplace import BaseLaplace

    monkeypatch.setattr(BaseLaplace, "optimize_prior_precision", lambda self, *a, **k: None)


@pytest.mark.parametrize("cell", [FIT, PREDICT])
def test_sound_run_is_correct(cell):
    assert tiny.run_tiny(cell, seconds=0.3)["correct"]


@pytest.mark.parametrize("cell, fault", [
    (FIT, stale_fit), (FIT, half_batch_fit), (FIT, altered_factor),
    (PREDICT, predict_fault("stale")), (PREDICT, predict_fault("half")),
    (PREDICT, predict_fault("altered")), (PREDICT, skipped_tuning),
], ids=["fit-state-unchanged", "fit-half-batch", "fit-altered-factor",
        "predict-answer-unchanged", "predict-half-batch", "predict-altered-answer",
        "predict-prior-untuned"])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result = tiny.run_tiny(cell, seconds=0.3)
    assert not result["correct"], result["checks"]
