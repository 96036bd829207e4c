"""Three nets of conv variants at full width: a 2-D net of masked,
input-dilated, circular, grouped and depthwise flax `Conv` twins at
ResNet-18's stage widths, a 1-D `nn.Conv1d` net with a conv head, and a 3-D
`nn.Conv3d` net with the `InstanceNorm` twin. `chip_smoke.py`'s
`conv_variants` phase drives them at full width and the card tests at a
fraction of it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from laplace_jax_torch.models.flax_layers import Conv, InstanceNorm, _trunc_normal

__all__ = ["conv_variant_nets", "pixelcnn_mask"]


def pixelcnn_mask(k, cin, cout):
    """A PixelCNN "B" mask in flax's kernel layout (k, k, cin, cout): the
    rows above the centre, and the centre row up to the centre."""
    m = torch.zeros(k, k, cin, cout)
    m[:k // 2] = 1.0
    m[k // 2, :k // 2 + 1] = 1.0
    return m


def conv_variant_nets(seed, dtype, div=1):
    """{name: net} of the three nets, flax's initializers drawn from `seed`,
    channel widths divided by `div`, in `dtype`:

    - `conv2d` (32x32x3 inputs, channels last): flax `Conv` twins at
      ResNet-18's stage widths, each followed by a relu: a SAME stem 3 -> 64;
      a PixelCNN "B"-masked 64 -> 128 of stride 2; 128 -> 128 of stride 2
      with `input_dilation=2` and pads ((1, 1), (1, 1)); CIRCULAR 128 -> 256
      of stride 2; CIRCULAR 256 -> 512 of stride 2 in 2 groups; 512 -> 512
      in 2 groups; a masked depthwise 512 (512 groups); the spatial mean
      into `Dense_0` (10 outputs). Its A factors 27, 576, 1152 (three),
      2304, 9 and 512;
    - `conv1d` (128 positions of 64 channels): `nn.Conv1d` 64 -> 256 and
      256 -> 256 (k 3, relu), the head `nn.Conv1d` 256 -> 10 (k 3), the
      mean over positions; A factors 192, 768 and 768;
    - `conv3d` (16^3 voxels of 4 channels): `nn.Conv3d` 4 -> 32 (k 3), the
      `InstanceNorm` twin (scales drawn near 1), relu, `nn.Conv3d` 32 -> 32
      (k 3, stride 2), relu, the mean into `Dense_0`; A factors 108, 864
      and 32."""
    gen = torch.Generator().manual_seed(seed)
    c0, c1, c2, c3 = (c // div for c in (64, 128, 256, 512))

    class Conv2dNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.Conv_0 = Conv(3, c0, (3, 3), generator=gen)
            self.Conv_1 = Conv(c0, c1, (3, 3), strides=2, mask=pixelcnn_mask(3, c0, c1),
                               generator=gen)
            self.Conv_2 = Conv(c1, c1, (3, 3), strides=2, padding=((1, 1), (1, 1)),
                               input_dilation=2, generator=gen)
            self.Conv_3 = Conv(c1, c2, (3, 3), strides=2, padding="CIRCULAR", generator=gen)
            self.Conv_4 = Conv(c2, c3, (3, 3), strides=2, padding="CIRCULAR",
                               feature_group_count=2, generator=gen)
            self.Conv_5 = Conv(c3, c3, (3, 3), feature_group_count=2, generator=gen)
            self.Conv_6 = Conv(c3, c3, (3, 3), feature_group_count=c3,
                               mask=pixelcnn_mask(3, 1, c3), generator=gen)
            self.Dense_0 = nn.Linear(c3, 10)

        def forward(self, x):
            x = x.permute(0, 3, 1, 2)
            for i in range(7):
                x = F.relu(getattr(self, f"Conv_{i}")(x))
            return self.Dense_0(x.mean((2, 3)))

    class Conv1dNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.Conv_0 = nn.Conv1d(64 // div, c2, 3, padding=1)
            self.Conv_1 = nn.Conv1d(c2, c2, 3, padding=1)
            self.Conv_2 = nn.Conv1d(c2, 10, 3, padding=1)

        def forward(self, x):
            x = F.relu(self.Conv_1(F.relu(self.Conv_0(x.transpose(1, 2)))))
            return self.Conv_2(x).mean(2)

    class Conv3dNet(nn.Module):
        def __init__(self):
            super().__init__()
            c = 32 // div
            self.Conv_0 = nn.Conv3d(4, c, 3, padding=1)
            self.InstanceNorm_0 = InstanceNorm(c, axis=1)
            self.Conv_1 = nn.Conv3d(c, c, 3, stride=2, padding=1)
            self.Dense_0 = nn.Linear(c, 10)

        def forward(self, x):
            x = F.relu(self.InstanceNorm_0(self.Conv_0(x.permute(0, 4, 1, 2, 3))))
            return self.Dense_0(F.relu(self.Conv_1(x)).mean((2, 3, 4)))

    nets = {"conv2d": Conv2dNet(), "conv1d": Conv1dNet(), "conv3d": Conv3dNet()}
    with torch.no_grad():  # flax's initializers for torch's own layers: lecun normal, zero bias
        for net in nets.values():
            for m in net.modules():
                if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv3d)):
                    _trunc_normal(m.weight, m.weight[0].numel() ** -0.5, gen)
                    m.bias.zero_()
        scale = nets["conv3d"].InstanceNorm_0.scale
        scale.add_(0.1 * torch.randn(scale.shape, generator=gen))
    return {k: v.to(dtype) for k, v in nets.items()}
