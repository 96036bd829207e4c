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

A leaf's layout comes from the kind of the module that owns it
(`layer_kind`, the one classification of layers that the flattening, the
KFAC taps and last-layer discovery all read): a Dense (`nn.Linear`) weight
`(out, in)` is transposed, a conv weight `(out, in, *k)` becomes
`(*k, in, out)` (for every rank; `in` is `in / groups` for a grouped conv,
as in flax), and every other leaf is already in flax layout (the twins
of `models/flax_layers.py`: an embedding, attention kernels and biases,
norm scales).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn


LINEAR, CONV, FLAX = "linear", "conv", "flax"


@dataclass(frozen=True)
class LeafSpec:
    """One leaf of the canonical flattening."""

    path: tuple  # flax-style path: module names, then "kernel" / "bias"
    name: str  # torch parameter name
    shape: tuple  # flax layout
    size: int
    offset: int  # start index in the flat vector
    layout: str = FLAX  # LINEAR | CONV | FLAX: how the torch tensor maps to `shape`


def flax_path(name: str) -> tuple:
    """Torch parameter name -> flax leaf path."""
    *mods, leaf = name.split(".")
    return tuple(mods) + ("kernel" if leaf == "weight" else leaf,)


_TORCH_NORMS = (nn.LayerNorm, nn.GroupNorm, nn.modules.batchnorm._BatchNorm, nn.RMSNorm)


def layer_kind(module: nn.Module) -> str | None:
    """The JAX package's tap kind of a layer ('dense' | 'conv' |
    'dense_general' | 'norm' | 'embed'), or None for a layer it does not
    tap. The port's own layers name their kind in a `tap_kind` class
    attribute (`models.resnet.Conv`, the twins of `models/flax_layers.py`)."""
    if isinstance(module, nn.Linear):
        return "dense"
    if isinstance(module, (nn.Conv1d, nn.Conv2d, nn.Conv3d)):
        return "conv"
    if isinstance(module, _TORCH_NORMS):
        return "norm"
    if isinstance(module, nn.Embedding):
        return "embed"
    return getattr(module, "tap_kind", None)


def weight_layout(module: nn.Module, leaf: str) -> str:
    """The layout of the parameter `leaf` of `module`: LINEAR for a Dense
    weight, CONV for a conv weight, FLAX (as it is) otherwise."""
    if leaf != "weight":
        return FLAX
    return {"dense": LINEAR, "conv": CONV}.get(layer_kind(module), FLAX)


def to_flax_layout(t: torch.Tensor, layout: str, lead: int = 0) -> torch.Tensor:
    """Torch layout -> flax layout, after `lead` leading batch dims: LINEAR
    `(out, in)` -> `(in, out)`, CONV `(out, in, *k)` -> `(*k, in, out)`,
    FLAX unchanged."""
    if layout == LINEAR:
        return t.transpose(lead, lead + 1)
    if layout == CONV:
        nd = t.ndim - lead
        return t.permute(*range(lead), *range(lead + 2, lead + nd), lead + 1, lead)
    return t


def from_flax_layout(t: torch.Tensor, layout: str) -> torch.Tensor:
    """Flax layout -> torch layout (the inverse of `to_flax_layout`)."""
    if layout == LINEAR:
        return t.T
    if layout == CONV:
        return t.permute(t.ndim - 1, t.ndim - 2, *range(t.ndim - 2))
    return t


def leaf_specs(module: nn.Module, trainable=None) -> list[LeafSpec]:
    """Trainable parameters in canonical (sorted flax path) order; with
    `trainable` (a set of torch parameter names), only those."""
    named = sorted(
        ((flax_path(n), n, p) for n, p in module.named_parameters()
         if p.requires_grad and (trainable is None or n in trainable)),
        key=lambda t: t[0],
    )
    specs, offset = [], 0
    for path, name, p in named:
        owner, _, leaf = name.rpartition(".")
        layout = weight_layout(module.get_submodule(owner), leaf)
        shape = tuple(to_flax_layout(p.detach(), layout).shape)
        specs.append(LeafSpec(path, name, shape, p.numel(), offset, layout))
        offset += p.numel()
    return specs


def params_per_leaf(module: nn.Module) -> list[int]:
    """The size of each trainable leaf in canonical order (the JAX
    package's `params_per_leaf` over a parameter tree)."""
    return [s.size for s in leaf_specs(module)]


def num_params(module: nn.Module) -> int:
    """The number of trainable parameters (the flat vector's length)."""
    return sum(params_per_leaf(module))


def parameters_to_vector(module: nn.Module, specs=None, detach: bool = True) -> torch.Tensor:
    """The flat parameter vector in canonical order and flax layout; with
    `detach=False` it stays in the parameters' graph."""
    specs = leaf_specs(module) if specs is None else specs
    params = dict(module.named_parameters())
    return torch.cat([to_flax_layout(params[s.name].detach() if detach else params[s.name],
                                     s.layout).reshape(-1) for s in specs])


def vector_to_parameters(theta: torch.Tensor, specs) -> dict:
    """A flat vector in canonical order as {torch parameter name: tensor in
    torch layout} over the leaves of `specs` (for `torch.func.functional_call`)."""
    return {s.name: from_flax_layout(theta[s.offset : s.offset + s.size].reshape(s.shape),
                                     s.layout)
            for s in specs}
