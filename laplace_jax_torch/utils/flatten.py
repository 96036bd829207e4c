"""Module <-> flat-vector plumbing in the JAX package's canonical order.

The JAX package flattens parameters in `jax.flatten_util.ravel_pytree`
order: sorted flax path strings (`Conv_0` < `Dense_0` < `ResidualBlock_0`
< `ResidualBlock_1` ...; a string sort puts `_10` before `_2`), each leaf
raveled in flax layout (conv kernels `(kh, kw, in, out)`, dense kernels
`(in, out)`). The port uses the same order and layout for its flat
parameter vector, per-layer prior slices, Kron groups and Jacobian columns,
so every one of them compares one-to-one with the JAX package.

A torch parameter named `ResidualBlock_0.Conv_0.weight` is the flax leaf
`ResidualBlock_0/Conv_0/kernel`; `bias` keeps its name.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn


@dataclass(frozen=True)
class LeafSpec:
    """One leaf of the canonical flattening."""

    path: tuple  # flax-style path: module names, then "kernel" / "bias"
    name: str  # torch parameter name
    shape: tuple  # flax layout
    size: int
    offset: int  # start index in the flat vector


def flax_path(name: str) -> tuple:
    """Torch parameter name -> flax leaf path."""
    *mods, leaf = name.split(".")
    return tuple(mods) + ("kernel" if leaf == "weight" else leaf,)


def to_flax_layout(t: torch.Tensor, lead: int = 0) -> torch.Tensor:
    """Torch weight layout -> flax layout, after `lead` leading batch dims:
    conv `(out, in, kh, kw)` -> `(kh, kw, in, out)`, dense `(out, in)` ->
    `(in, out)`; 1-dim leaves are unchanged."""
    nd = t.ndim - lead
    dims = list(range(lead))
    if nd == 4:
        return t.permute(*dims, lead + 2, lead + 3, lead + 1, lead)
    if nd == 2:
        return t.transpose(lead, lead + 1)
    return t


def leaf_specs(module: nn.Module) -> list[LeafSpec]:
    """Trainable parameters in canonical (sorted flax path) order."""
    named = sorted(
        ((flax_path(n), n, p) for n, p in module.named_parameters()
         if p.requires_grad),
        key=lambda t: t[0],
    )
    specs, offset = [], 0
    for path, name, p in named:
        shape = tuple(to_flax_layout(p.detach()).shape)
        specs.append(LeafSpec(path, name, shape, p.numel(), offset))
        offset += p.numel()
    return specs


def parameters_to_vector(module: nn.Module, specs=None) -> torch.Tensor:
    """The flat parameter vector in canonical order and flax layout."""
    specs = leaf_specs(module) if specs is None else specs
    params = dict(module.named_parameters())
    return torch.cat(
        [to_flax_layout(params[s.name].detach()).reshape(-1) for s in specs]
    )
