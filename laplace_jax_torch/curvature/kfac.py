"""KFAC factors from layer taps (port of `laplace_jax/curvature/kfac.py`,
exact Fisher of a classifier, Dense and Conv layers).

Normalization contract, as in the JAX package:

- activation factor ``A = (1/(N*T)) sum_{n,t} a a^T`` (T = spatial positions
  of a conv's output; T = 1 for Dense);
- gradient factor ``B = sum_{c} sum_{n,t} g g^T`` over the C square-root
  Hessian cotangent sweeps, a per-batch sum;
- a kernel leaf is the group ``(A, B)`` (input-major ``A kron B`` under the
  flax flatten), a bias leaf the group ``(B,)``.
"""

from __future__ import annotations

import warnings

import torch

from laplace_jax_torch.ops.im2col import im2col
from laplace_jax_torch.utils.matrix import Kron

__all__ = ["kfac_factors", "conv_patches"]


def conv_patches(inputs: torch.Tensor, spec: dict) -> torch.Tensor:
    """Patches of an NCHW conv input as (B, T, kh*kw*c_in), feature order
    (kh, kw, c_in) like the flax kernel flatten."""
    p = im2col(inputs, spec["kernel_size"], spec["strides"], spec["padding"],
               channels_last=False)
    return p.reshape(p.shape[0], -1, p.shape[-1])


def _sqrt_hessian_cotangents(f: torch.Tensor) -> torch.Tensor:
    """Columns of S with S S^T = d^2(cross-entropy)/df^2 per sample,
    shaped (C, B, C): diag(p) - p p^T = sum_c p_c (e_c - p)(e_c - p)^T, so
    S[c, b, :] = sqrt(p[b, c]) (e_c - p[b])."""
    eye = torch.eye(f.shape[1], dtype=f.dtype, device=f.device)
    p = torch.softmax(f, dim=-1)
    return p.T.sqrt()[:, :, None] * (eye[:, None, :] - p[None, :, :])


def kfac_factors(model, x, y, N: int, lossfunc):
    """Per-batch exact-Fisher KFAC `Kron` of a classifier, and the batch
    loss."""
    with torch.enable_grad():
        f, taps = model.apply_with_taps(x)
        if not taps:
            raise ValueError("No Dense/Conv layers intercepted for KFAC.")
        cot = _sqrt_hessian_cotangents(f.detach())
        # all C sweeps in one batched backward pass w.r.t. the zero offsets
        grads = torch.autograd.grad(
            f, [t.offset for t in taps], grad_outputs=cot, is_grads_batched=True
        )

    B_facs, A_facs = {}, {}
    for t, g in zip(taps, grads):
        if t.path in A_facs:  # a layer run twice keeps its first tap
            continue
        if t.kind == "conv":  # (C, B, out, H, W) -> rows of `out`
            g = g.movedim(2, -1)
            patches = conv_patches(t.inputs.detach(), t.spec)
            a = patches.reshape(-1, patches.shape[-1])
            A_facs[t.path] = a.T @ a / (N * patches.shape[1])
        else:
            a = t.inputs.detach()
            A_facs[t.path] = a.T @ a / N
        g2 = g.reshape(-1, g.shape[-1])
        B_facs[t.path] = g2.T @ g2

    kfacs, skipped = [], []
    for spec in model.leaf_specs:
        mod, role = spec.path[:-1], spec.path[-1]
        if mod in A_facs and role == "kernel":
            kfacs.append((A_facs[mod], B_facs[mod]))
        elif mod in A_facs and role == "bias":
            kfacs.append((B_facs[mod],))
        else:
            # zero curvature: the posterior falls back to the prior here
            skipped.append("/".join(spec.path))
            kfacs.append(_zero_group(spec, f.dtype, f.device))
    if skipped:
        warnings.warn(
            f"Parameters not supported by KFAC get zero curvature (posterior "
            f"falls back to the prior): {skipped}."
        )
    return lossfunc(f.detach(), y), Kron(kfacs)


def _zero_group(spec, dtype, device):
    if len(spec.shape) <= 1:
        P = max(spec.size, 1)
        return (torch.zeros(P, P, dtype=dtype, device=device),)
    p_out = spec.shape[-1]
    p_in = spec.size // p_out
    return (torch.zeros(p_in, p_in, dtype=dtype, device=device),
            torch.zeros(p_out, p_out, dtype=dtype, device=device))
