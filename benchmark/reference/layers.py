"""The layers a configuration's plain forward is written in.

A configuration's reference (`configs/<name>.py`) defines
`forward(ops, x)` in these calls, by the names of the layers in its table
(`configs/<name>.json`, `layers`). Weights are looked up by the names the
benchmark made them under: `<layer>.weight`, `<layer>.bias`, and for a
batch norm `<layer>.scale`, `.bias`, `.mean`, `.var`.

Conventions, from the published models as the configuration states them:

- inputs arrive NHWC, as CIFAR arrays do, and run NCHW inside;
- a conv pads as flax's 'SAME' does: out = ceil(n / stride), the total pad
  `max((out - 1) * stride + k - n, 0)` split low-first (a stride-2 3x3
  conv on an even input pads (0, 1));
- a batch norm is in inference mode: `(x - mean) / sqrt(var + eps) * scale
  + bias` over the channel axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def same_pad(n: int, k: int, stride: int) -> tuple:
    """(output size, (low pad, high pad)) of a 'SAME' conv along one axis."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return out, (total // 2, total - total // 2)


class Ops:
    """The layers of one forward pass. `weights` maps names to tensors,
    `layers` is the configuration's layer table. With `record`, each conv
    and dense layer keeps `taps[name] = (input as the layer reads it,
    output)`: a conv's input already padded."""

    def __init__(self, weights: dict, layers: list, record: bool = False):
        self.w = weights
        self.layers = {entry["name"]: entry for entry in layers}
        self.record = record
        self.taps: dict = {}

    def _bias(self, name):
        return self.w.get(f"{name}.bias")

    def conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        entry = self.layers[name]
        k, s = entry["k"], entry["stride"]
        _, (hl, hh) = same_pad(x.shape[2], k, s)
        _, (wl, wh) = same_pad(x.shape[3], k, s)
        xp = F.pad(x, (wl, wh, hl, hh))
        out = F.conv2d(xp, self.w[f"{name}.weight"], self._bias(name), stride=s)
        if self.record:
            self.taps[name] = (xp, out)
        return out

    def dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        out = F.linear(x, self.w[f"{name}.weight"], self._bias(name))
        if self.record:
            self.taps[name] = (x, out)
        return out

    def batchnorm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        entry = self.layers[name]
        shape = (1, -1) + (1,) * (x.ndim - 2)
        w = {k: self.w[f"{name}.{k}"].reshape(shape) for k in ("scale", "bias", "mean", "var")}
        return (x - w["mean"]) / torch.sqrt(w["var"] + entry["eps"]) * w["scale"] + w["bias"]

    @staticmethod
    def relu(x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x)

    @staticmethod
    def nchw(x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, 3, 1, 2)

    @staticmethod
    def global_mean(x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(2, 3))


class tf32:
    """Scope in which float32 products and convolutions may round to TF32
    (`on`) or may not; the previous settings come back on exit. The
    reference runs with `on` False; the control, the reference one
    precision below the configuration's float32, with `on` True."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.on
        torch.backends.cudnn.allow_tf32 = self.on
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        return False
