"""WideResNet-16-4, the twin of `laplace_jax/models/wideresnet.py` (the
reference's calibration model family, `examples/helper/wideresnet.py`).

`norm=None` is the norm-free variant, every leaf under a conv or the Dense
head; `norm="batch" | "group" | "layer"` puts the twins of flax's
`BatchNorm` (inference mode: running statistics, frozen), `GroupNorm(8)`
or `LayerNorm` after the stem and after each block conv. Their `scale`
and `bias` are the leaves KFAC cannot factor: `kron_unsupported` decides
what they get (`curvature/kfac.py`).

Submodules carry flax's names (`Conv_0`, `BatchNorm_1`, `WideBlock_3`,
`Dense_0`), so the flat vector and the Kron groups line up with the JAX
package's. Inputs are NHWC at the boundary, as there; the network runs
NCHW inside, and the norms act on axis 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from laplace_jax_torch.models.flax_layers import BatchNorm, GroupNorm, LayerNorm, init_dense
from laplace_jax_torch.models.resnet import Conv, init_conv

__all__ = ["WideBlock", "WideResNet16x4"]

_NORMS = {"batch": ("BatchNorm", BatchNorm, {}), "group": ("GroupNorm", GroupNorm,
                                                          {"num_groups": 8}),
          "layer": ("LayerNorm", LayerNorm, {})}


def _norm_factory(norm: str | None):
    """(flax class name, constructor of one norm on `features` channels), or
    None without a norm."""
    if norm is None:
        return None
    if norm not in _NORMS:
        raise ValueError(f"Unknown norm {norm!r}; use None, 'batch', 'group', 'layer'.")
    name, cls, kw = _NORMS[norm]
    return name, lambda features: cls(features, axis=1, **kw)


class WideBlock(nn.Module):
    """Two 3x3 convs with biases (he-normal, then variance scaling 0.1),
    each followed by the norm; a 1x1 projection `Conv_2` when the shape
    changes."""

    def __init__(self, c_in: int, channels: int, strides: int = 1, norm: str | None = None):
        super().__init__()
        self.Conv_0 = Conv(c_in, channels, 3, strides, init_scale=2.0, use_bias=True)
        self.Conv_1 = Conv(channels, channels, 3, 1, init_scale=0.1, use_bias=True)
        self.norms = []
        made = _norm_factory(norm)
        if made is not None:
            name, make = made
            self.norms = [f"{name}_0", f"{name}_1"]
            for n in self.norms:
                self.add_module(n, make(channels))
        if strides != 1 or c_in != channels:
            self.Conv_2 = Conv(c_in, channels, 1, strides)

    def _norm(self, i, x):
        return getattr(self, self.norms[i])(x) if self.norms else x

    def forward(self, x):
        y = self._norm(1, self.Conv_1(F.relu(self._norm(0, self.Conv_0(x)))))
        residual = self.Conv_2(x) if hasattr(self, "Conv_2") else x
        return F.relu(residual + y)


class WideResNet16x4(nn.Module):
    """3x3 stem of 16 channels (no bias), three stages of two `WideBlock`s
    at 16k, 32k and 64k channels (k = `widen_factor`, stride 2 entering
    stages 2 and 3), global average pooling, `Dense_0`."""

    def __init__(self, num_classes: int = 10, widen_factor: int = 4, norm: str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.Conv_0 = Conv(3, 16, 3)
        made = _norm_factory(norm)
        self.stem_norm = None
        if made is not None:
            self.stem_norm = f"{made[0]}_0"
            self.add_module(self.stem_norm, made[1](16))
        c_in, b = 16, 0
        for i, ch in enumerate((16 * widen_factor, 32 * widen_factor, 64 * widen_factor)):
            for j in range(2):
                strides = 2 if (i > 0 and j == 0) else 1
                self.add_module(f"WideBlock_{b}", WideBlock(c_in, ch, strides, norm))
                c_in, b = ch, b + 1
        self.n_blocks = b
        self.Dense_0 = nn.Linear(c_in, num_classes)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's initializers: truncated-normal variance scaling on fan-in
        for every kernel, zero biases, unit norm scales."""
        for m in self.modules():
            if isinstance(m, Conv):
                init_conv(m, generator)
        init_dense(self.Dense_0, generator)

    def forward(self, x):
        x = self.Conv_0(x.permute(0, 3, 1, 2))  # NHWC -> NCHW
        if self.stem_norm is not None:
            x = getattr(self, self.stem_norm)(x)
        x = F.relu(x)
        for b in range(self.n_blocks):
            x = getattr(self, f"WideBlock_{b}")(x)
        return self.Dense_0(x.mean(dim=(2, 3)))
