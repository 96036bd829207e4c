"""CIFAR-style norm-free ResNet, the twin of `laplace_jax/models/resnet.py`.

Submodules carry the flax names (`Conv_0`, `ResidualBlock_3`, `Dense_0`), so
torch parameter names map one-to-one onto flax leaf paths
(`utils/flatten.py`). Inputs are NHWC at the public boundary, as in the JAX
package; the network runs NCHW inside. `Conv` pads like flax (`'SAME'` is
`(0, 1)` for a stride-2 3x3 conv on an even input) and then convolves with
no padding of its own.

`state_dict_from_flax` carries JAX parameters over: conv kernels
`(kh, kw, in, out)` -> `(out, in, kh, kw)`, dense kernels `(in, out)` ->
`(out, in)`; each leaf takes the layout of the torch module that owns it
(`utils/flatten.weight_layout`), so 1-D convs and the flax-layout twins of
`models/flax_layers.py` load too, and flax's `batch_stats` fill the
`BatchNorm` twins' buffers.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from laplace_jax_torch.models.flax_layers import Conv as FlaxConv, _trunc_normal, init_dense
from laplace_jax_torch.utils.flatten import from_flax_layout, weight_layout

__all__ = ["Conv", "ResidualBlock", "ResNet", "ResNet18", "init_conv", "state_dict_from_flax"]


class Conv(FlaxConv):
    """flax `nn.Conv(features, (k, k), strides, padding='SAME', use_bias=...)`
    on NCHW tensors (no bias by default, as the ResNet's convs): the flax
    `Conv` twin with one group and no dilation, whose kernel `init_conv`
    draws with `init_scale`. A bias is the flax leaf `bias`, zero at
    initialization, and its own KFAC group `(B,)`."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, strides: int = 1,
                 init_scale: float = 1.0, use_bias: bool = False):
        self.init_scale = init_scale  # variance_scaling(scale, fan_in, truncated)
        super().__init__(c_in, c_out, (kernel_size, kernel_size), strides, use_bias=use_bias)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Left to `init_conv`, which the networks call with their generator."""


class ResidualBlock(nn.Module):
    def __init__(self, c_in: int, channels: int, strides: int = 1):
        super().__init__()
        self.Conv_0 = Conv(c_in, channels, 3, strides, init_scale=2.0)
        self.Conv_1 = Conv(channels, channels, 3, 1, init_scale=0.1)
        # flax builds the projection when the residual's shape differs
        if strides != 1 or c_in != channels:
            self.Conv_2 = Conv(c_in, channels, 1, strides)

    def forward(self, x):
        y = self.Conv_1(F.relu(self.Conv_0(x)))
        residual = self.Conv_2(x) if hasattr(self, "Conv_2") else x
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet-{18,34}-style CIFAR classifier (3x3 stem, 4 stages)."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 num_classes: int = 10, width: int = 64,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.Conv_0 = Conv(3, width, 3, init_scale=2.0)
        c_in, b = width, 0
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                strides = 2 if (i > 0 and j == 0) else 1
                ch = width * 2**i
                self.add_module(f"ResidualBlock_{b}", ResidualBlock(c_in, ch, strides))
                c_in, b = ch, b + 1
        self.n_blocks = b
        self.Dense_0 = nn.Linear(c_in, num_classes)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's initializers: truncated-normal variance scaling on fan-in
        for the kernels (he_normal is scale 2), zero dense bias."""
        for m in self.modules():
            if isinstance(m, Conv):
                init_conv(m, generator)
        init_dense(self.Dense_0, generator)

    def forward(self, x):
        x = F.relu(self.Conv_0(x.permute(0, 3, 1, 2)))  # NHWC -> NCHW
        for b in range(self.n_blocks):
            x = getattr(self, f"ResidualBlock_{b}")(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


def ResNet18(num_classes: int = 10, width: int = 64,
             generator: torch.Generator | None = None) -> ResNet:
    return ResNet((2, 2, 2, 2), num_classes, width, generator)


def init_conv(m: Conv, generator: torch.Generator | None = None) -> None:
    """flax's initializers for a `Conv`: truncated-normal variance scaling
    on fan-in for the kernel (`init_scale` 1 is lecun_normal, 2 he_normal),
    a zero bias."""
    with torch.no_grad():
        _trunc_normal(m.weight, math.sqrt(m.init_scale / m.weight[0].numel()), generator)
        if m.bias is not None:
            m.bias.zero_()


def state_dict_from_flax(params: Mapping, module: nn.Module) -> dict:
    """A JAX parameter tree (nested dict of arrays, with or without the
    top-level `'params'`) as a `state_dict` of its twin torch `module`; each
    kernel takes the layout of the submodule that owns it. A `batch_stats`
    collection beside `'params'` fills the `BatchNorm` twins' `mean` and
    `var` buffers."""
    trees = [params]
    if "params" in params:
        trees = [params["params"]] + ([params["batch_stats"]] if "batch_stats" in params else [])
    out = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, prefix + (key,))
                continue
            a = torch.as_tensor(np.array(val))
            if key == "kernel":
                owner = module.get_submodule(".".join(prefix))
                a = from_flax_layout(a, weight_layout(owner, "weight"))
                key = "weight"
            out[".".join(prefix + (key,))] = a.contiguous()

    for tree in trees:
        walk(tree, ())
    return out
