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
  g[k, b, t, o])²``. A conv of G groups pairs each output channel (group
  major) with its group's patches only, per (group, i, o within the
  group); a masked conv's kernel diagonal carries mask², as its gradient
  carries the mask (`laplace_jax/curvature/diag_taps.py:190-241`);
- a DenseGeneral or Einsum: as a shared Dense, from the tap's activation
  rows (B, T, K) and its cotangent rows in kernel (and bias) flatten order;
  a feature-major ("ok") kernel's diagonal transposed;
- an Embed: the per-sample gradient scatter-adds the output gradients of a
  sample's positions into the rows of their ids,
  ``d_E[v, :] = Σ_{k,b} (Σ_{t: id[b,t] = v} g[k, b, t, :])²``;
- a norm twin: its per-sample `bias` and `scale` gradients Σ_pos g and
  Σ_pos g ∘ x̂, squared and summed;
- an `unfactored` Einsum: the exact diagonal of each of its leaves from
  per-sample backward passes through the leaf (`kfac.exact_leaf_accumulate`).

A leaf outside those layers (a DenseGeneral with `batch_dims`, a bare
parameter, a conv padded by reflection), or a layer run twice, raises
`TapUnsupported`, and the backend takes the Jacobian path, which is exact
too.
"""

from __future__ import annotations

import math

import torch

from laplace_jax_torch.curvature.kfac import (
    _sqrt_hessian_cotangents,
    conv_patches,
    dg_grad_rows,
    exact_leaf_accumulate,
    group_patches,
    label_cotangents,
    norm_sample_grads,
)
from laplace_jax_torch.utils.flatten import CONV, to_flax_layout
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
        swept = [t for t in taps if t.offset is not None]
        grads = (torch.autograd.grad(f, [t.offset for t in swept], grad_outputs=cot,
                                     is_grads_batched=True) if swept else ())

    diags = {}
    for t, g in zip(swept, grads):
        if t.kind == "embed":
            diags[(t.path, "embedding")] = _embed_diag(t, g)
            continue
        if t.kind == "dense_general":
            dK, dB = _shared_weight_diag(t, dg_grad_rows(g, t.spec), chunk_bytes)
            if t.spec["g_perm_bias"] != t.spec["g_perm"]:
                gb = dg_grad_rows(g, t.spec, for_bias=True).sum(2)
                dB = (gb * gb).sum((0, 1))
            ok = t.spec["kernel_layout"] == "ok"  # a feature-major kernel flattens O-major
            diags[(t.path, "kernel")], diags[(t.path, "bias")] = (dK.T if ok else dK), dB
            continue
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

    unfactored = [s for s in model.leaf_specs
                  if any(t.kind == "unfactored" and t.path == s.path[:-1] for t in taps)]
    if unfactored:
        for path, d in exact_leaf_accumulate(model, x, 1.0, cot, unfactored,
                                             diagonal=True).items():
            diags[(path[:-1], path[-1])] = d
    parts = [diags[(s.path[:-1], s.path[-1])].reshape(-1) for s in model.leaf_specs]
    return lossfunc(f.detach(), y), torch.cat(parts)


def _embed_diag(t, g: torch.Tensor) -> torch.Tensor:
    """An Embed's (num_embeddings, features) diagonal from g (K, B, *ids,
    D): each sample's output gradients summed over its positions with the
    same id (one sum a distinct (sample, id) pair), squared, and summed
    into the rows of the ids."""
    V, B = t.spec["num_embeddings"], g.shape[1]
    ids = t.inputs.reshape(B, -1)
    g = g.reshape(g.shape[0], B * ids.shape[1], g.shape[-1])
    key = (torch.arange(B, device=ids.device)[:, None] * V + ids).reshape(-1)
    pairs, inverse = torch.unique(key, return_inverse=True)
    G = torch.zeros(g.shape[0], pairs.numel(), g.shape[-1], dtype=g.dtype,
                    device=g.device).index_add_(1, inverse, g)
    return torch.zeros(V, g.shape[-1], dtype=g.dtype, device=g.device).index_add_(
        0, pairs % V, (G * G).sum(0))


def _shared_weight_diag(t, g: torch.Tensor, chunk_bytes: int):
    """Kernel (in, out) and bias (out,) diagonals of a layer that shares its
    weight over positions, from g (K, B, T, out): the per-sample kernel
    gradients Σ_t a gᵀ of a chunk of samples at a time; for a conv of G
    groups, per group, (in / G, out) in the kernel's flatten order."""
    K, B, T, O = g.shape
    inputs = t.inputs.detach()
    G = t.spec["groups"] if t.kind == "conv" else 1
    if t.kind == "conv":
        I = math.prod(t.spec["kernel_size"]) * inputs.shape[1]
    else:
        I = t.patches.shape[-1] if t.kind == "dense_general" else inputs.shape[-1]
    per_sample = (K * I * O // G + T * I) * g.element_size()
    chunk = max(1, min(B, chunk_bytes // per_sample))
    dK = torch.zeros(G, I // G, O // G, dtype=g.dtype, device=g.device)
    for b0 in range(0, B, chunk):
        sl = slice(b0, min(B, b0 + chunk))
        if t.kind == "conv":
            a = conv_patches(inputs[sl], t.spec)  # (b, T, I)
        elif t.kind == "dense_general":
            a = t.patches[sl]
        else:
            a = inputs[sl].reshape(-1, T, I)
        gs = g[:, sl].reshape(K, -1, T, G, O // G)
        M = torch.einsum("btgi,kbtgo->kbgio", group_patches(a, t.spec["kernel_size"], G)
                         if G > 1 else a[:, :, None], gs)
        dK += (M * M).sum((0, 1))
    dK = dK.movedim(0, 1).reshape(I // G, O)  # output channels group-major
    mask = t.spec["mask"] if t.kind == "conv" else None
    if mask is not None:
        m = to_flax_layout(mask, CONV).reshape(-1, O)
        dK = dK * (m * m)
    gb = g.sum(2)
    return dK, (gb * gb).sum((0, 1))


def _check_covered(model, taps) -> None:
    """Raise `TapUnsupported` unless each layer is tapped once, no Dense is
    fed rows gathered by a router, and every leaf belongs to a tapped Dense,
    conv, DenseGeneral, Einsum, Embed or norm layer."""
    paths = [t.path for t in taps]
    if len(set(paths)) != len(paths):
        raise TapUnsupported("A tapped layer runs more than once in the forward.")
    if any(t.kind == "dense" and t.spec is not None for t in taps):
        raise TapUnsupported("A routed expert's rows mix the batch's samples: no per-sample "
                             "gradient from its tap.")
    kinds = dict(zip(paths, (t.kind for t in taps)))
    linear = ("kernel", "bias")
    roles = {"dense": linear, "conv": linear, "dense_general": linear, "unfactored": linear,
             "embed": ("embedding",), "norm": ("scale", "bias")}
    for s in model.leaf_specs:
        if s.path[-1] not in roles.get(kinds.get(s.path[:-1]), ()):
            raise TapUnsupported(
                f"Trainable parameter {s.path} does not belong to a tapped Dense/Conv/norm "
                "layer; use the Jacobian-based diag path.")
