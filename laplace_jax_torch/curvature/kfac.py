"""KFAC factors from layer taps (port of `laplace_jax/curvature/kfac.py`:
Dense, Conv, DenseGeneral, Einsum and Embed layers, the exact, MC and
empirical Fisher, and the `unsupported` policies for leaves outside them).

Normalization contract, as in the JAX package:

- activation factor ``A = (1/(N*T)) sum_{n,t} a a^T`` (T = spatial positions
  of a conv's output; a conv of G groups averages its groups' patch Grams,
  ``1/(N*T*G)``, each group's patches in its kernel's `(*k, in / G)` order;
  for Dense the positions between batch and feature
  axes, 1 on a 2-d input: "expand" KFAC; for a routed expert's Dense, fed
  the `(rows, in)` tokens its router sent it, the positions per sample of
  the batch they were gathered from, which the tap learns from the layer
  that gathered them (`spec["positions"]`, `nnmodel.apply_with_taps`): a
  token not routed there is a zero row, so A and B sum over the routed
  rows and A keeps the ``1/(N*T)`` of the other projections on that
  batch; for a DenseGeneral or Einsum the
  tap's activation rows, in the kernel's contracted order; for an Embed the
  one-hot rows, so ``A = diag(token counts) / (N*T)``);
- gradient factor ``B = sum_s w_s sum_{n,t} g g^T`` over the cotangent
  sweeps s: the C square-root Hessian columns (exact, w = 1), sampled labels
  (MC, w = 1/num_samples) or the labels themselves (empirical, one sweep);
  a DenseGeneral's cotangent rows have its feature axes last, in the
  kernel's flatten order (`dg_grad_rows`), and a bias whose flatten order
  differs from the kernel's gets its own B;
- a kernel (or `embedding`) leaf is the group ``(A, B)`` (input-major ``A
  kron B`` under the flax flatten; a feature-major Einsum kernel, layout
  "ok", the group ``(B, A)``), a bias leaf the group ``(B,)``.

A masked conv (the flax `Conv` twin's `mask`) gets the unmasked layer's
``(A, B)`` factors, as the JAX package documents
(`laplace_jax/curvature/kfac.py:24-33`): a Kronecker product cannot zero
the frozen entries, which the forward multiplies out; the tap diagonal
carries the mask exactly.

A leaf of an `unfactored` Einsum (no two-factor structure) takes the exact
dense block of its leaves, under every policy, when it has at most
`block_max_params` entries. Any other leaf outside the tapped layers
follows `unsupported`: ``"skip"`` gives it a zero group and warns (the
posterior keeps the prior there); ``"block"`` gives it the exact dense
1-factor block, from the same sweeps through the norm taps for a norm
twin's `scale` and `bias`, else from per-sample backward passes through the
leaf when it has at most `block_max_params` entries; ``"raise"`` raises
`ValueError`.
"""

from __future__ import annotations

import math
import warnings

import torch

from laplace_jax_torch.enums import Likelihood
from laplace_jax_torch.nnmodel import batch_len, batch_slice
from laplace_jax_torch.ops.im2col import im2col
from laplace_jax_torch.utils import spans
from laplace_jax_torch.utils.flatten import to_flax_layout
from laplace_jax_torch.utils.matrix import Kron

__all__ = ["kfac_factors", "conv_patches", "group_patches", "mc_draws", "dg_grad_rows"]

TAPPED = ("dense", "conv", "dense_general", "embed", "unfactored")

def conv_patches(inputs: torch.Tensor, spec: dict) -> torch.Tensor:
    """Patches of a (B, C, *S) conv input as (B, T, prod(k)*c_in), feature
    order (*k, c_in) like the flax kernel flatten."""
    p = im2col(inputs, spec["kernel_size"], spec["strides"], spec["padding"],
               channels_last=False, dilation=spec["dilation"],
               input_dilation=spec["input_dilation"], wrap=spec["wrap"])
    return p.reshape(p.shape[0], -1, p.shape[-1])


def group_patches(patches: torch.Tensor, ksize, groups: int) -> torch.Tensor:
    """A (..., prod(k)*c_in) patch axis, c_in in consecutive groups, as
    (..., groups, prod(k)*c_in/groups), each group in its kernel's flatten
    order (*k, c_in/groups) (the JAX package's `group_patches`)."""
    kprod = math.prod(ksize)
    lead = patches.shape[:-1]
    p = patches.reshape(*lead, kprod, groups, -1)
    return p.movedim(-2, len(lead)).reshape(*lead, groups, -1)


def _sqrt_hessian_cotangents(f: torch.Tensor, likelihood=Likelihood.CLASSIFICATION) -> torch.Tensor:
    """Columns of S with S S^T = d^2(sum loss)/df^2 per sample, shaped
    (C, B, C). Classification: diag(p) - p p^T = sum_c p_c (e_c - p)(e_c -
    p)^T, so S[c, b, :] = sqrt(p[b, c]) (e_c - p[b]). Regression: the summed
    squared error's Hessian is 2 I, so S = sqrt(2) I (the backend then
    scales the factors by its 1/2)."""
    C = f.shape[1]
    eye = torch.eye(C, dtype=f.dtype, device=f.device)
    if likelihood == Likelihood.REGRESSION:
        return (math.sqrt(2.0) * eye)[:, None, :].expand(C, f.shape[0], C).contiguous()
    p = torch.softmax(f, dim=-1)
    return p.T.sqrt()[:, :, None] * (eye[:, None, :] - p[None, :, :])


def mc_draws(f: torch.Tensor, likelihood, num_samples: int,
             generator: torch.Generator | None) -> torch.Tensor:
    """The MC Fisher's draws from the model's predictive at outputs f (B,
    C): (num_samples, B) classes from the softmax (classification), or
    (num_samples, B, C) standard normal noise (regression). Every MC draw
    of the port's curvature goes through here (the JAX package's
    `jax.random.categorical` / `jax.random.normal` per sample)."""
    if generator is None:
        generator = torch.Generator(device=f.device).manual_seed(0)
    if likelihood == Likelihood.REGRESSION:
        return torch.randn((num_samples,) + tuple(f.shape), generator=generator,
                           dtype=f.dtype, device=f.device)
    p = torch.softmax(f.detach(), dim=-1)
    return torch.multinomial(p, num_samples, replacement=True, generator=generator).T


def mc_cotangents(f: torch.Tensor, likelihood, num_samples: int, generator) -> torch.Tensor:
    """The MC sweeps' output cotangents (num_samples, B, C): sqrt(2) times
    the noise (regression, the summed squared error), or p - onehot(class)
    (classification), as `laplace_jax/curvature/kfac.py:231-247`."""
    draws = mc_draws(f, likelihood, num_samples, generator)
    if likelihood == Likelihood.REGRESSION:
        return math.sqrt(2.0) * draws
    p = torch.softmax(f, dim=-1)
    return p[None] - torch.nn.functional.one_hot(draws, f.shape[-1]).to(f.dtype)


def label_cotangents(f: torch.Tensor, y: torch.Tensor, likelihood) -> torch.Tensor:
    """The empirical Fisher's output cotangents (1, B, C): the summed loss's
    gradient in f at the labels, 2 (f - y) or p - onehot(y)."""
    if likelihood == Likelihood.REGRESSION:
        return (2.0 * (f - y))[None]
    p = torch.softmax(f, dim=-1)
    return (p - torch.nn.functional.one_hot(y.long(), f.shape[-1]).to(f.dtype))[None]


def sweep_cotangents(f, y, likelihood, fisher_type, num_samples=1, generator=None):
    """(weight, cotangents (K, B, C)) of one Fisher type's sweeps."""
    f = f.detach()
    if fisher_type == "exact":
        return 1.0, _sqrt_hessian_cotangents(f, likelihood)
    if fisher_type == "mc":
        return 1.0 / num_samples, mc_cotangents(f, likelihood, num_samples, generator)
    if fisher_type == "empirical":
        return 1.0, label_cotangents(f, y, likelihood)
    raise ValueError(f"Unknown fisher_type {fisher_type}.")


def norm_xhat(tap) -> torch.Tensor:
    """x̂ of a norm tap with its feature axis last: out = scale ∘ x̂ + bias,
    so x̂ = (out − bias) / scale, zero scales guarded (the JAX package's
    `_norm_xhat`)."""
    mod = tap.module
    out = tap.outputs.movedim(mod.axis, -1)
    if mod.bias is not None:
        out = out - mod.bias.detach()
    scale = mod.scale.detach()
    return out / torch.where(scale == 0, torch.ones_like(scale), scale)


def norm_sample_grads(tap, g: torch.Tensor):
    """Per-sample gradients (K, B, F) of a norm layer's `bias` and `scale`
    from its output cotangents g (K, B, *out): Σ_pos g and Σ_pos g ∘ x̂."""
    axis = tap.module.axis
    g = g.movedim(axis + 1 if axis >= 0 else axis, -1)
    red = tuple(range(2, g.ndim - 1))  # torch sums every dim over an empty tuple
    gs = g * norm_xhat(tap)[None]
    return (g.sum(red), gs.sum(red)) if red else (g, gs)


def dg_grad_rows(g: torch.Tensor, spec: dict, for_bias: bool = False) -> torch.Tensor:
    """A `dense_general` tap's output cotangents (K, *out) as rows (K, B,
    T, O): the batch axis first and the feature axes last, in the kernel's
    (or with `for_bias`, the bias's) flatten order (the JAX package's
    `_dg_grad_rows`)."""
    perm = spec["g_perm_bias"] if for_bias else spec["g_perm"]
    if perm is not None:
        g = g.permute((0,) + tuple(1 + p for p in perm))
    O = math.prod(g.shape[g.ndim - spec["n_feat"]:])
    return g.reshape(g.shape[0], g.shape[1], -1, O)


def _gram(rows: torch.Tensor) -> torch.Tensor:
    r = rows.reshape(-1, rows.shape[-1])
    return r.T @ r


def kfac_factors(model, x, y, N: int, likelihood, lossfunc, fisher_type: str = "exact",
                 num_samples: int = 1, generator: torch.Generator | None = None,
                 last_layer_path=None, unsupported: str = "skip", block_max_params: int = 8192):
    """Per-batch KFAC `Kron` and the (unscaled) batch loss. With
    `last_layer_path`, only that layer is tapped (the model's trainable
    leaves are then that layer's). MC draws come from `generator`."""
    paths = None if last_layer_path is None else {tuple(last_layer_path)}
    with torch.enable_grad():
        with spans.span("accumulate.forward"):
            f, taps = model.apply_with_taps(x, paths, norm=unsupported == "block")
        if not any(t.kind in TAPPED for t in taps):
            raise ValueError("No Dense/Conv layers intercepted for KFAC.")
        with spans.span("accumulate.sweeps"):
            w, cot = sweep_cotangents(f, y, likelihood, fisher_type, num_samples, generator)
            # every sweep in one batched backward pass w.r.t. the zero offsets
            swept = [t for t in taps if t.offset is not None]
            grads = (torch.autograd.grad(f, [t.offset for t in swept], grad_outputs=cot,
                                         is_grads_batched=True) if swept else ())

    A_facs, B_facs, B_bias, norm_blocks = _grams(swept, grads, w, N, f.dtype)

    first_tap = {}
    for t in taps:
        first_tap.setdefault(t.path, t)
    kfacs, skipped, block_wanted = [], [], []
    for spec in model.leaf_specs:
        mod, role = spec.path[:-1], spec.path[-1]
        tap = first_tap.get(mod)
        if mod in A_facs and role in ("kernel", "embedding"):
            A, B = A_facs[mod], B_facs[mod]
            ok = tap.kind == "dense_general" and tap.spec["kernel_layout"] == "ok"
            kfacs.append((B, A) if ok else (A, B))
            continue
        if mod in A_facs and role == "bias":
            kfacs.append((B_bias.get(mod, B_facs[mod]),))
            continue
        if (mod, role) in norm_blocks:
            kfacs.append((norm_blocks[(mod, role)],))
            continue
        unfactored = tap is not None and tap.kind == "unfactored"
        if (unsupported == "block" or unfactored) and spec.size <= block_max_params:
            block_wanted.append((len(kfacs), spec))
        elif unsupported == "raise":
            raise ValueError(
                f"Trainable parameter {spec.path} does not belong to an intercepted Dense/Conv "
                "layer; KFAC is undefined for it. Freeze it via the trainable mask or use a "
                "diag/full Hessian structure.")
        else:
            skipped.append("/".join(spec.path))
        kfacs.append(_zero_group(spec, f.dtype, f.device))

    if block_wanted:
        blocks = exact_leaf_accumulate(model, x, w, cot, [s for _, s in block_wanted])
        for i, spec in block_wanted:
            kfacs[i] = (blocks[spec.path],)
    if skipped:
        warnings.warn(
            f"Parameters not supported by KFAC get zero curvature (posterior falls back to "
            f"the prior): {skipped}. Pass kron_unsupported='block' for exact dense blocks "
            "(raise block_max_params if these leaves exceed it), or freeze them via the "
            "trainable mask.")
    return lossfunc(f.detach(), y), Kron(kfacs)


@spans.span("accumulate.grams")
def _grams(swept, grads, w, N: int, dtype) -> tuple:
    """The A and B Grams of every swept tap (im2col included): ({path: A},
    {path: B}, {path: a bias's own B}, {(path, role): a norm leaf's block}).
    The routed experts' Grams come last, in the span
    `accumulate.grams.experts`, which counts their products."""
    B_facs, B_bias, A_facs, norm_blocks = {}, {}, {}, {}
    pairs = list(zip(swept, grads))
    routed = [(t, g) for t, g in pairs if t.kind == "dense" and t.spec is not None]
    _tap_grams([p for p in pairs if p[0].kind != "dense" or p[0].spec is None], w, N, dtype,
               A_facs, B_facs, B_bias, norm_blocks)
    if routed:
        with spans.span("accumulate.grams.experts"):
            _tap_grams(routed, w, N, dtype, A_facs, B_facs, B_bias, norm_blocks)
        spans.count("accumulate.grams.experts.products", 2 * len(routed))
    return A_facs, B_facs, B_bias, norm_blocks


def _tap_grams(pairs, w, N: int, dtype, A_facs, B_facs, B_bias, norm_blocks) -> None:
    for t, g in pairs:
        if t.path in A_facs or (t.path, "bias") in norm_blocks:  # a layer run twice keeps its first tap
            continue
        if t.kind == "norm":
            gb, gs = norm_sample_grads(t, g)
            norm_blocks[(t.path, "bias")] = w * torch.einsum("kbc,kbd->cd", gb, gb)
            norm_blocks[(t.path, "scale")] = w * torch.einsum("kbc,kbd->cd", gs, gs)
            continue
        if t.kind == "dense_general":
            A_facs[t.path] = _gram(t.patches) / (N * t.patches.shape[1])
            B_facs[t.path] = w * _gram(dg_grad_rows(g, t.spec))
            if t.spec["g_perm"] != t.spec["g_perm_bias"]:
                B_bias[t.path] = w * _gram(dg_grad_rows(g, t.spec, for_bias=True))
            continue
        if t.kind == "embed":  # one-hot rows: a diagonal Gram of the token counts
            ids = t.inputs.reshape(-1)
            counts = torch.zeros(t.spec["num_embeddings"], dtype=dtype, device=ids.device)
            counts.index_add_(0, ids, torch.ones(ids.shape, dtype=dtype, device=ids.device))
            A_facs[t.path] = torch.diag(counts) / (N * max(ids.numel() // t.inputs.shape[0], 1))
        elif t.kind == "conv":  # (K, B, out, *S) -> rows of `out`
            g = g.movedim(2, -1)
            patches = conv_patches(t.inputs.detach(), t.spec)
            G = t.spec["groups"]
            if G > 1:  # (group, position) is the weight-sharing axis
                patches = group_patches(patches, t.spec["kernel_size"], G)
            a = patches.reshape(-1, patches.shape[-1])
            A_facs[t.path] = a.T @ a / (N * patches.shape[1] * G)
        else:  # (B, ..., in): every position between batch and feature is a row
            a = t.inputs.detach().reshape(-1, t.inputs.shape[-1])
            T = t.spec["positions"] if t.spec else a.shape[0] // t.inputs.shape[0]
            A_facs[t.path] = a.T @ a / (N * T)
        B_facs[t.path] = w * _gram(g)


def exact_leaf_accumulate(model, x, w, cot, specs, diagonal: bool = False) -> dict:
    """Exact curvature of the leaves `specs` from per-sample gradients: w
    Σ_{b,k} g gᵀ (dense blocks) or, with `diagonal`, w Σ_{b,k} g², with g
    the gradient of f_b·cot[k, b] in the leaf (flax layout): one backward a
    sample, batched over the K cotangents (the JAX package's
    `_exact_leaf_blocks` and `_exact_leaf_diags`). Memory: the results and
    one sample's graph."""
    params = dict(model.module.named_parameters())
    leaves = [params[s.name] for s in specs]
    out = {s.path: torch.zeros((s.size,) if diagonal else (s.size, s.size), dtype=cot.dtype,
                               device=cot.device) for s in specs}
    with torch.enable_grad():
        for b in range(batch_len(x)):
            fb = model.apply(batch_slice(x, slice(b, b + 1)))[0]
            gs = torch.autograd.grad(fb, leaves, grad_outputs=cot[:, b], is_grads_batched=True)
            for s, g in zip(specs, gs):
                G = to_flax_layout(g, s.layout, lead=1).reshape(g.shape[0], -1)
                out[s.path] += w * ((G * G).sum(0) if diagonal else G.T @ G)
    return out


def _zero_group(spec, dtype, device):
    if len(spec.shape) <= 1:
        P = max(spec.size, 1)
        return (torch.zeros(P, P, dtype=dtype, device=device),)
    p_out = spec.shape[-1]
    p_in = spec.size // p_out
    return (torch.zeros(p_in, p_in, dtype=dtype, device=device),
            torch.zeros(p_out, p_out, dtype=dtype, device=device))
