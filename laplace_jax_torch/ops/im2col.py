"""Convolution patches in the JAX package's feature order.

Port of `laplace_jax/ops/im2col.py`: patches are `F.unfold` columns, whose
feature axis is `(c_in, kh, kw)`, permuted to the `(kh, kw, c_in)` order of
the flax kernel flatten `(kh, kw, in, out) -> (kh*kw*in, out)`, so the
KFAC activation factors match the JAX package element for element.
Padding follows flax/lax semantics: `'SAME'`, `'VALID'`, or explicit
per-dim `(lo, hi)` pairs (an int pads every side alike). `'SAME'` is
asymmetric for a stride-2 3x3 conv on an even input (`(0, 1)`), which
`nn.Conv2d(padding=1)` does not reproduce. `dilation` is flax's
`kernel_dilation`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

__all__ = ["im2col", "resolve_padding", "pad_input"]


def resolve_padding(padding, in_shape: Sequence[int], ksize: Sequence[int],
                    strides: Sequence[int], dilation: Sequence[int] | None = None) -> list:
    """Per-spatial-dim (lo, hi) padding from 'SAME', 'VALID' or explicit
    pairs, matching `lax.conv_general_dilated`."""
    n = len(ksize)
    dilation = (1,) * n if dilation is None else tuple(dilation)
    if isinstance(padding, int):
        return [(padding, padding)] * n
    if not isinstance(padding, str):
        return [(p, p) if isinstance(p, int) else (int(p[0]), int(p[1])) for p in padding]
    p = padding.upper()
    if p == "VALID":
        return [(0, 0)] * n
    if p != "SAME":
        raise ValueError(f"Unsupported padding {padding}.")
    pads = []
    for size, k, s, d in zip(in_shape, ksize, strides, dilation):
        out = -(-size // s)  # ceil
        total = max((out - 1) * s + d * (k - 1) + 1 - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def pad_input(x: torch.Tensor, ksize, strides, padding, dilation=None) -> torch.Tensor:
    """Pad an NCHW input the way flax/lax pads it for this conv."""
    pads = resolve_padding(padding, x.shape[2:], ksize, strides, dilation)
    flat = []
    for lo, hi in reversed(pads):  # F.pad takes the last dim first
        flat += [lo, hi]
    return F.pad(x, flat)


def im2col(x: torch.Tensor, ksize, strides, padding,
           channels_last: bool = True, dilation=None) -> torch.Tensor:
    """Conv patches of a 2-d input.

    `x` is `(B, H, W, C)` (or `(B, C, H, W)` with `channels_last=False`).
    Returns `(B, H_out, W_out, kh*kw*C)` with the feature axis ordered
    `(kh, kw, C)` row-major, as `laplace_jax.ops.im2col.im2col` does.
    """
    if channels_last:
        x = x.permute(0, 3, 1, 2)
    ksize, strides = tuple(ksize), tuple(strides)
    dilation = (1,) * len(ksize) if dilation is None else tuple(dilation)
    xp = pad_input(x, ksize, strides, padding, dilation)
    B, C = x.shape[:2]
    h_out = (xp.shape[2] - dilation[0] * (ksize[0] - 1) - 1) // strides[0] + 1
    w_out = (xp.shape[3] - dilation[1] * (ksize[1] - 1) - 1) // strides[1] + 1
    cols = F.unfold(xp, ksize, dilation=dilation, stride=strides)  # (B, C*kh*kw, L)
    cols = cols.reshape(B, C, ksize[0] * ksize[1], h_out * w_out)
    return cols.permute(0, 3, 2, 1).reshape(B, h_out, w_out, -1)
