"""Convolution patches in the JAX package's feature order.

Port of `laplace_jax/ops/im2col.py`: patches are `F.unfold` columns, whose
feature axis is `(c_in, kh, kw)`, permuted to the `(kh, kw, c_in)` order of
the flax kernel flatten `(kh, kw, in, out) -> (kh*kw*in, out)`, so the
KFAC activation factors match the JAX package element for element.
Padding follows flax/lax string semantics: `'SAME'` is asymmetric for a
stride-2 3x3 conv on an even input (`(0, 1)`), which `nn.Conv2d(padding=1)`
does not reproduce.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

__all__ = ["im2col", "resolve_padding", "pad_input"]


def resolve_padding(padding, in_shape: Sequence[int], ksize: Sequence[int],
                    strides: Sequence[int]) -> list:
    """Per-spatial-dim (lo, hi) padding for 'SAME' or 'VALID', matching
    `lax.conv_general_dilated`."""
    p = padding.upper()
    if p == "VALID":
        return [(0, 0)] * len(ksize)
    if p != "SAME":
        raise ValueError(f"Unsupported padding {padding}.")
    pads = []
    for size, k, s in zip(in_shape, ksize, strides):
        out = -(-size // s)  # ceil
        total = max((out - 1) * s + k - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def pad_input(x: torch.Tensor, ksize, strides, padding) -> torch.Tensor:
    """Pad an NCHW input the way flax/lax pads it for this conv."""
    pads = resolve_padding(padding, x.shape[2:], ksize, strides)
    flat = []
    for lo, hi in reversed(pads):  # F.pad takes the last dim first
        flat += [lo, hi]
    return F.pad(x, flat)


def im2col(x: torch.Tensor, ksize, strides, padding,
           channels_last: bool = True) -> torch.Tensor:
    """Conv patches of a 2-d input.

    `x` is `(B, H, W, C)` (or `(B, C, H, W)` with `channels_last=False`).
    Returns `(B, H_out, W_out, kh*kw*C)` with the feature axis ordered
    `(kh, kw, C)` row-major, as `laplace_jax.ops.im2col.im2col` does.
    """
    if channels_last:
        x = x.permute(0, 3, 1, 2)
    ksize, strides = tuple(ksize), tuple(strides)
    xp = pad_input(x, ksize, strides, padding)
    B, C = x.shape[:2]
    h_out = (xp.shape[2] - ksize[0]) // strides[0] + 1
    w_out = (xp.shape[3] - ksize[1]) // strides[1] + 1
    cols = F.unfold(xp, ksize, stride=strides)  # (B, C*kh*kw, L)
    cols = cols.reshape(B, C, ksize[0] * ksize[1], h_out * w_out)
    return cols.permute(0, 3, 2, 1).reshape(B, h_out, w_out, -1)
