"""LeNet-style CNN, the twin of `laplace_jax/models/lenet.py`.

Two 5x5 convs (6 and 16 channels, biases, flax's `'SAME'` padding), each
followed by ReLU and a 2x2 average pool with stride 2 (`'VALID'`), then
Dense 120 -> 84 -> `num_classes`. Submodules carry the flax names
(`Conv_0`, `Conv_1`, `Dense_0`..`Dense_2`), so weights carry over with
`models.resnet.state_dict_from_flax`. Inputs are NHWC; the features are
flattened in NHWC order, as flax flattens them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from laplace_jax_torch.models.flax_layers import init_dense
from laplace_jax_torch.models.resnet import Conv, init_conv

__all__ = ["LeNet"]


class LeNet(nn.Module):
    """LeNet on (B, `image_size`, `image_size`, `in_channels`) inputs (flax
    infers the first Dense layer's width; here it is set from the image
    size). Weights take flax's initializers (lecun normal kernels, zero
    biases), drawn from `generator`."""

    def __init__(self, num_classes: int = 10, in_channels: int = 1, image_size: int = 28,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.Conv_0 = Conv(in_channels, 6, 5, use_bias=True)
        self.Conv_1 = Conv(6, 16, 5, use_bias=True)
        side = image_size // 2 // 2
        self.Dense_0 = nn.Linear(16 * side * side, 120)
        self.Dense_1 = nn.Linear(120, 84)
        self.Dense_2 = nn.Linear(84, num_classes)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        for conv in (self.Conv_0, self.Conv_1):
            init_conv(conv, generator)
        for dense in (self.Dense_0, self.Dense_1, self.Dense_2):
            init_dense(dense, generator)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.avg_pool2d(F.relu(self.Conv_0(x)), 2, 2)
        x = F.avg_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's (h, w, c) order
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)
