"""The numbers the check compares, program against reference.

Each takes what the program (or the control, in its place) produced and
what the float64 reference worked out from the same weights and inputs,
keyed by parameter name, and returns one number that the cell's limit
holds (`limits/<cell>.json`). Every number is a worst case over the
factors or answers compared.
"""

from __future__ import annotations

import math

import torch


def worse(a: float, b: float) -> float:
    """The larger of two readings; NaN if either is (a NaN is never hidden)."""
    return math.nan if math.isnan(a) or math.isnan(b) else max(a, b)


def _f64(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.to(device=like.device, dtype=torch.float64)


def factor_err(prog: dict, ref: dict) -> float:
    """Worst relative Frobenius gap of a KFAC factor: ||F - F_ref|| /
    ||F_ref||, over every factor of every group."""
    worst = 0.0
    for name, fr in ref.items():
        for Fp, Fr in zip(prog[name], fr, strict=True):
            worst = worse(worst, float(torch.linalg.norm(_f64(Fp, Fr) - Fr)
                                        / torch.linalg.norm(Fr)))
    return worst


def eig_err(prog_eig: dict, ref_vals: dict) -> float:
    """Worst gap of a factor's ascending eigenvalues, relative to the
    reference's largest: max |l - l_ref| / max l_ref."""
    worst = 0.0
    for name, lr in ref_vals.items():
        for (lp, _), Lr in zip(prog_eig[name], lr, strict=True):
            gap = (_f64(lp, Lr) - Lr).abs().max() / Lr.abs().max().clamp(min=1e-300)
            worst = worse(worst, float(gap))
    return worst


def eig_resid(prog_eig: dict, ref_factors: dict) -> float:
    """Worst residual of the program's eigenpairs on the reference's
    factor: ||F_ref Q - Q diag(l)|| / ||F_ref||. It holds the vectors, which
    the eigenvalues alone do not, and needs no eigenvectors of the
    reference (they are not unique where eigenvalues cluster)."""
    worst = 0.0
    for name, fr in ref_factors.items():
        for (lp, Qp), Fr in zip(prog_eig[name], fr, strict=True):
            Q, lam = _f64(Qp, Fr), _f64(lp, Fr)
            worst = worse(worst, float(torch.linalg.norm(Fr @ Q - Q * lam)
                                        / torch.linalg.norm(Fr)))
    return worst


def rel_err(prog: float, ref: float) -> float:
    return abs(prog - ref) / abs(ref)


def band_gap(prog: list, bands: list) -> float:
    """Worst amount by which an entry lies outside the reference's range
    `(lo, hi)` for it, over paired tensors."""
    worst = 0.0
    for p, (lo, hi) in zip(prog, bands, strict=True):
        p = _f64(p, lo)
        worst = worse(worst, float(torch.maximum(p - hi, lo - p).clamp(min=0.0).max()))
    return worst
