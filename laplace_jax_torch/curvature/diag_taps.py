"""The exact GGN or empirical-Fisher diagonal from layer taps, with no
(batch, outputs, params) Jacobian (port of `laplace_jax/curvature/diag_taps.py`).

The Jacobian path builds B·C·P floats a batch: 57 GB for ResNet-18 at
batch 128 in float32. From the same taps and one batched backward pass as
KFAC (K output cotangents: the C square-root Hessian columns for the GGN,
the label gradient for the EF), each layer's diagonal is

- Dense on a 2-D input: ``d_W[i, o] = Σ_{k,b} a[b, i]² g[k, b, o]²`` (one
  einsum), ``d_b[o] = Σ_{k,b} g[k, b, o]²``;
- a conv, or a Dense shared over positions t:
  ``d_W[i, o] = Σ_{k,b} (Σ_t a[b, t, i] g[k, b, t, o])²``, the per-sample
  kernel gradients formed for a chunk of samples at a time, so a chunk
  holds at most about `chunk_bytes` of them; ``d_b[o] = Σ_{k,b} (Σ_t
  g[k, b, t, o])²``;
- a norm twin: its per-sample `bias` and `scale` gradients Σ_pos g and
  Σ_pos g ∘ x̂, squared and summed.

A leaf outside those layers (a DenseGeneral, an Embed, an untapped conv,
a bare parameter), or a layer run twice, raises `TapUnsupported`, and the
backend takes the Jacobian path, which is exact too.
"""

from __future__ import annotations

import torch

from laplace_jax_torch.curvature.kfac import (
    _sqrt_hessian_cotangents,
    conv_patches,
    label_cotangents,
    norm_sample_grads,
)
from laplace_jax_torch.enums import Likelihood

__all__ = ["diag_curvature_taps", "TapUnsupported", "CHUNK_BYTES"]

CHUNK_BYTES = 512 << 20  # per-sample kernel gradients held at once, per layer


class TapUnsupported(ValueError):
    """Some trainable leaf is outside the tapped layers: the tap diagonal is
    unavailable, and callers take the Jacobian path."""


def diag_curvature_taps(model, x, y, likelihood, lossfunc, curv_type: str = "ggn",
                        chunk_bytes: int = CHUNK_BYTES):
    """(loss, diagonal (n_params,)) in the canonical flat order: the exact
    GGN diagonal (regression's Λ = I, as the Jacobian path) or the
    empirical Fisher's (the summed loss's gradients, unscaled; the backend
    applies its factor), and the unscaled batch loss."""
    with torch.enable_grad():
        f, taps = model.apply_with_taps(x, norm=True)
        _check_covered(model, taps)
        if curv_type == "ggn":
            if likelihood == Likelihood.REGRESSION:
                C = f.shape[-1]
                eye = torch.eye(C, dtype=f.dtype, device=f.device)
                cot = eye[:, None, :].expand(C, f.shape[0], C)
            else:
                cot = _sqrt_hessian_cotangents(f.detach(), likelihood)
        elif curv_type == "ef":
            cot = label_cotangents(f.detach(), y, likelihood)
        else:
            raise ValueError(f"Unsupported curv_type {curv_type} for diag taps.")
        grads = torch.autograd.grad(f, [t.offset for t in taps], grad_outputs=cot,
                                    is_grads_batched=True)

    diags = {}
    for t, g in zip(taps, grads):
        if t.kind == "norm":
            gb, gs = norm_sample_grads(t, g)
            diags[(t.path, "bias")] = (gb * gb).sum((0, 1))
            diags[(t.path, "scale")] = (gs * gs).sum((0, 1))
            continue
        if t.kind == "dense" and t.inputs.ndim == 2:
            a = t.inputs.detach()
            diags[(t.path, "kernel")] = torch.einsum("bi,kbo->io", a * a, g * g)
            diags[(t.path, "bias")] = (g * g).sum((0, 1))
            continue
        if t.kind == "conv":  # (K, B, out, H, W) -> (K, B, T, out)
            g = g.movedim(2, -1).reshape(g.shape[0], g.shape[1], -1, g.shape[2])
        else:  # Dense shared over the positions between batch and feature
            g = g.reshape(g.shape[0], g.shape[1], -1, g.shape[-1])
        dK, dB = _shared_weight_diag(t, g, chunk_bytes)
        diags[(t.path, "kernel")], diags[(t.path, "bias")] = dK, dB

    parts = [diags[(s.path[:-1], s.path[-1])].reshape(-1) for s in model.leaf_specs]
    return lossfunc(f.detach(), y), torch.cat(parts)


def _shared_weight_diag(t, g: torch.Tensor, chunk_bytes: int):
    """Kernel (in, out) and bias (out,) diagonals of a layer that shares its
    weight over positions, from g (K, B, T, out): the per-sample kernel
    gradients Σ_t a gᵀ of a chunk of samples at a time."""
    K, B, T, O = g.shape
    inputs = t.inputs.detach()
    I = (t.spec["kernel_size"][0] * t.spec["kernel_size"][1] * inputs.shape[1]
         if t.kind == "conv" else inputs.shape[-1])
    per_sample = (K * I * O + T * I) * g.element_size()
    chunk = max(1, min(B, chunk_bytes // per_sample))
    dK = torch.zeros(I, O, dtype=g.dtype, device=g.device)
    for b0 in range(0, B, chunk):
        sl = slice(b0, min(B, b0 + chunk))
        if t.kind == "conv":
            a = conv_patches(inputs[sl], t.spec)  # (b, T, I)
        else:
            a = inputs[sl].reshape(-1, T, I)
        M = torch.einsum("bti,kbto->kbio", a, g[:, sl])
        dK += (M * M).sum((0, 1))
    gb = g.sum(2)
    return dK, (gb * gb).sum((0, 1))


def _check_covered(model, taps) -> None:
    """Raise `TapUnsupported` unless each layer is tapped once and every
    leaf belongs to a tapped Dense, conv or norm layer."""
    paths = [t.path for t in taps]
    if len(set(paths)) != len(paths):
        raise TapUnsupported("A tapped layer runs more than once in the forward.")
    kinds = dict(zip(paths, (t.kind for t in taps)))
    roles = {"dense": ("kernel", "bias"), "conv": ("kernel", "bias"), "norm": ("scale", "bias")}
    for s in model.leaf_specs:
        if s.path[-1] not in roles.get(kinds.get(s.path[:-1]), ()):
            raise TapUnsupported(
                f"Trainable parameter {s.path} does not belong to a tapped Dense/Conv/norm "
                "layer; use the Jacobian-based diag path.")
