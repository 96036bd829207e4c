"""Model adapter with layer taps (port of `laplace_jax/nnmodel.py`, Dense
and Conv taps only).

`apply_with_taps` plants a forward hook on every `Conv` and `nn.Linear`.
The hook records the layer's input and adds a zero tensor that requires
grad to the layer's output: the gradient with respect to that zero
offset is the layer's output gradient, which KFAC needs for its B factor
(the JAX package differentiates the same zero offsets through a flax
interceptor, `laplace_jax/nnmodel.py:205-212`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from laplace_jax_torch.models.resnet import Conv
from laplace_jax_torch.utils.flatten import leaf_specs, parameters_to_vector


@dataclass
class LayerTap:
    """One executed Dense / Conv layer."""

    path: tuple  # module path, e.g. ("ResidualBlock_0", "Conv_0")
    kind: str  # "dense" | "conv"
    inputs: torch.Tensor  # layer input (NCHW for convs)
    offset: torch.Tensor  # zero added to the output, requiring grad
    spec: Optional[dict] = None  # conv: kernel_size, strides, padding


class NNModel:
    """An `nn.Module` with its canonical parameter flattening and taps."""

    def __init__(self, module: nn.Module):
        self.module = module
        self.leaf_specs = leaf_specs(module)
        self.n_params = sum(s.size for s in self.leaf_specs)
        self.n_layers = len(self.leaf_specs)
        self._params = dict(module.named_parameters())

    @property
    def mean_vector(self) -> torch.Tensor:
        return parameters_to_vector(self.module, self.leaf_specs)

    def params_in_order(self) -> list:
        """Torch parameters in canonical leaf order."""
        return [self._params[s.name] for s in self.leaf_specs]

    def apply(self, x):
        return self.module(x)

    def apply_with_taps(self, x):
        """Forward pass returning `(f, taps)`, taps in execution order; each
        tapped output gets `+ zeros` requiring grad."""
        taps: list[LayerTap] = []

        def make_hook(path, kind, spec):
            def hook(mod, args, out):
                off = torch.zeros_like(out).requires_grad_(True)
                taps.append(LayerTap(path, kind, args[0], off, spec))
                return out + off

            return hook

        handles = []
        for name, mod in self.module.named_modules():
            path = tuple(name.split(".")) if name else ()
            if isinstance(mod, Conv):
                spec = dict(kernel_size=mod.kernel_size, strides=mod.strides,
                            padding=mod.padding)
                handles.append(mod.register_forward_hook(make_hook(path, "conv", spec)))
            elif isinstance(mod, nn.Linear):
                handles.append(mod.register_forward_hook(make_hook(path, "dense", None)))
        try:
            f = self.module(x)
        finally:
            for h in handles:
                h.remove()
        return f, taps
