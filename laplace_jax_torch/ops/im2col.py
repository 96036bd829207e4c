"""Convolution patches in the JAX package's feature order, for 1, 2 and 3
spatial dims.

Port of `laplace_jax/ops/im2col.py` (the slice-based im2col): each kernel
offset is one strided slice of the padded input, and the slices are laid
side by side so that the patch feature axis runs `(k_0, ..., k_{n-1},
c_in)` row-major, the flax kernel flatten `(*k, in, out) -> (prod(k)*in,
out)`; so the KFAC activation factors match the JAX package element for
element, for every rank.

Padding follows flax/lax semantics: `'SAME'`, `'VALID'`, or explicit
per-dim `(lo, hi)` pairs (an int pads every side alike); `'SAME'` is
asymmetric for a stride-2 3x3 conv on an even input (`(0, 1)`), which
`nn.Conv2d(padding=1)` does not reproduce. `'CIRCULAR'` is flax's: a wrap
pad of `((e - 1) // 2, e // 2)`, e the dilated kernel extent, then VALID;
`wrap=True` wraps explicit pairs instead (torch's `padding_mode='circular'`,
which pads its `padding` on both sides). `dilation` is flax's
`kernel_dilation`; `input_dilation` inserts `d - 1` zeros between input
elements before the padding, as `lax.pad` does in the JAX package. Explicit
pads may be negative (a crop), as lax allows.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import torch
import torch.nn.functional as F

__all__ = ["im2col", "resolve_padding", "pad_input", "dilate_input", "as_tuple"]


def as_tuple(v, n: int) -> tuple:
    """An int (or None: 1) as an n-tuple; a sequence as a tuple of ints."""
    if v is None:
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(a) for a in v)


def is_circular(padding) -> bool:
    return isinstance(padding, str) and padding.upper() == "CIRCULAR"


def resolve_padding(padding, in_shape: Sequence[int], ksize: Sequence[int],
                    strides: Sequence[int], dilation: Sequence[int] | None = None) -> list:
    """Per-spatial-dim (lo, hi) padding from 'SAME', 'VALID', 'CIRCULAR' or
    explicit pairs, matching `lax.conv_general_dilated` (and flax's
    CIRCULAR, whose pads wrap)."""
    n = len(ksize)
    dilation = as_tuple(dilation, n)
    if isinstance(padding, int):
        return [(padding, padding)] * n
    if not isinstance(padding, str):
        return [(p, p) if isinstance(p, int) else (int(p[0]), int(p[1])) for p in padding]
    p = padding.upper()
    if p == "VALID":
        return [(0, 0)] * n
    extents = [d * (k - 1) + 1 for k, d in zip(ksize, dilation)]
    if p == "CIRCULAR":
        return [((e - 1) // 2, e // 2) for e in extents]
    if p != "SAME":
        raise ValueError(f"Unsupported padding {padding}.")
    pads = []
    for size, e, s in zip(in_shape, extents, strides):
        out = -(-size // s)  # ceil
        total = max((out - 1) * s + e - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def dilate_input(x: torch.Tensor, input_dilation) -> torch.Tensor:
    """`d - 1` zeros between neighbours along each spatial dim of a (B, C,
    *S) input (lax's lhs dilation)."""
    n = x.ndim - 2
    d = as_tuple(input_dilation, n)
    if all(a == 1 for a in d):
        return x
    shape = x.shape[:2] + tuple((s - 1) * a + 1 for s, a in zip(x.shape[2:], d))
    out = x.new_zeros(shape)
    out[(slice(None), slice(None)) + tuple(slice(None, None, a) for a in d)] = x
    return out


def _wrap_pad(x: torch.Tensor, pads) -> torch.Tensor:
    """`jnp.pad(mode='wrap')` on the spatial dims of (B, C, *S): index
    arithmetic modulo each size, so a pad may exceed the size."""
    for i, (lo, hi) in enumerate(pads):
        size = x.shape[2 + i]
        idx = torch.arange(-lo, size + hi, device=x.device) % size
        x = x.index_select(2 + i, idx)
    return x


def pad_input(x: torch.Tensor, ksize, strides, padding, dilation=None,
              wrap: bool = False) -> torch.Tensor:
    """Pad a (B, C, *S) input the way flax/lax pads it for this conv: with
    zeros, or wrapped for 'CIRCULAR' padding or `wrap`."""
    pads = resolve_padding(padding, x.shape[2:], ksize, strides, dilation)
    if wrap or is_circular(padding):
        return _wrap_pad(x, pads)
    flat = []
    for lo, hi in reversed(pads):  # F.pad takes the last dim first
        flat += [lo, hi]
    return F.pad(x, flat)


def im2col(x: torch.Tensor, ksize, strides, padding, channels_last: bool = True,
           dilation=None, input_dilation=None, wrap: bool = False) -> torch.Tensor:
    """Conv patches of a 1-, 2- or 3-d input.

    `x` is `(B, *S, C)` (or `(B, C, *S)` with `channels_last=False`).
    Returns `(B, *S_out, prod(ksize)*C)` with the feature axis ordered
    `(k_0, ..., k_{n-1}, C)` row-major, as `laplace_jax.ops.im2col.im2col`
    does. CIRCULAR (or wrapped) padding with input dilation raises
    `ValueError`, as the JAX package's `conv_patches` does: flax rejects
    that conv.
    """
    if channels_last:
        x = x.movedim(-1, 1)
    n = x.ndim - 2
    ksize, strides = tuple(ksize), as_tuple(strides, n)
    dilation = as_tuple(dilation, n)
    dilated = any(d != 1 for d in as_tuple(input_dilation, n))
    if dilated and (wrap or is_circular(padding)):
        raise ValueError("CIRCULAR padding with input_dilation has no defined conv semantics "
                         "(flax rejects it); cannot extract patches.")
    xp = pad_input(dilate_input(x, input_dilation), ksize, strides, padding, dilation, wrap)
    out = [(xp.shape[2 + i] - dilation[i] * (ksize[i] - 1) - 1) // strides[i] + 1
           for i in range(n)]
    cols = []
    for offs in itertools.product(*(range(k) for k in ksize)):
        sl = tuple(slice(o * d, o * d + (m - 1) * s + 1, s)
                   for o, d, m, s in zip(offs, dilation, out, strides))
        cols.append(xp[(slice(None), slice(None)) + sl])
    p = torch.stack(cols, dim=-1)  # (B, C, *S_out, prod(k))
    return p.movedim(1, -1).reshape(*p.shape[:1], *out, -1)
