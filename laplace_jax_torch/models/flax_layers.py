"""Torch twins of flax.linen layers (flax 0.12): those of `bench.py`'s
reward-model transformer (`Embed`, `DenseGeneral`,
`MultiHeadDotProductAttention`, `LayerNorm`), the norms of
`laplace_jax/models/wideresnet.py` (`BatchNorm` in inference mode,
`GroupNorm`), and `Einsum`, `RMSNorm`, `InstanceNorm` and `Conv` (1-, 2-
or 3-d, grouped, circular, input-dilated, masked).

Every parameter is kept in flax layout and under flax's leaf name
(`embedding`, `kernel` as the torch `weight`, `bias`, `scale`), so the
flat vector (`utils/flatten.py`) and `models.resnet.state_dict_from_flax`
take them as they are; the `Conv` kernel alone is kept in torch's conv
layout `(out, in / groups, *k)`, as `nn.Conv2d` keeps it. None of them is an `nn.Linear`: the JAX package
taps a `DenseGeneral` or an `Einsum` as the kind `dense_general`, not as a
Dense, and so do the port's taps and discovery (`tap_kind`).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from laplace_jax_torch.ops.im2col import as_tuple, dilate_input, pad_input
from laplace_jax_torch.utils.flatten import CONV, from_flax_layout

__all__ = ["Embed", "DenseGeneral", "Einsum", "MultiHeadDotProductAttention", "LayerNorm",
           "RMSNorm", "BatchNorm", "GroupNorm", "InstanceNorm", "Conv", "init_dense"]


def _trunc_normal(t, std, generator):
    # flax's truncated normal: unit-variance after truncation at +-2 sigma
    s = std / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, s, -2 * s, 2 * s, generator=generator)


@torch.no_grad()
def init_dense(m: nn.Linear, generator: torch.Generator | None = None) -> None:
    """flax `nn.Dense`'s initializers on an `nn.Linear`: a lecun-normal
    kernel (truncated normal, variance 1 / fan-in), a zero bias."""
    _trunc_normal(m.weight, math.sqrt(1.0 / m.in_features), generator)
    if m.bias is not None:
        m.bias.zero_()


def _shape(n) -> tuple:
    return tuple(n) if isinstance(n, Sequence) else (int(n),)


class Embed(nn.Module):
    """flax `nn.Embed(num_embeddings, features)`: the leaf `embedding`
    (num_embeddings, features), initialized normal with variance
    1/features; the forward is an index lookup."""

    tap_kind = "embed"

    def __init__(self, num_embeddings: int, features: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))
        with torch.no_grad():
            self.embedding.normal_(0.0, 1.0 / math.sqrt(features), generator=generator)

    def forward(self, ids):
        return self.embedding[ids]


class DenseGeneral(nn.Module):
    """flax `nn.DenseGeneral(features, axis, batch_dims)`: kernel `weight`
    in flax layout `(*batch_shape, *in_shape, *features)`, bias
    `(*batch_shape, *features)`; lecun-normal kernel on the contracted
    size, zero bias. `axis` are the input axes contracted against
    `in_shape` (None: the last `len(in_shape)` axes); `batch_dims` are
    leading input axes shared with the kernel, of sizes `batch_shape`. As
    flax's `dot_general`, the output holds the batch axes, then the other
    input axes in order, then `features`."""

    tap_kind = "dense_general"

    def __init__(self, in_shape, features, use_bias: bool = True, axis=None,
                 batch_dims=(), batch_shape=(), generator: torch.Generator | None = None):
        super().__init__()
        self.in_shape, self.features = _shape(in_shape), _shape(features)
        self.axis = None if axis is None else _shape(axis)
        self.batch_dims, self.batch_shape = tuple(batch_dims), tuple(batch_shape)
        if len(self.batch_dims) != len(self.batch_shape):
            raise ValueError("batch_shape must give the size of each of batch_dims.")
        if self.axis is not None and len(self.axis) != len(self.in_shape):
            raise ValueError(f"axis {self.axis} does not match in_shape {self.in_shape}.")
        self.weight = nn.Parameter(torch.empty(self.batch_shape + self.in_shape
                                               + self.features))
        self.bias = (nn.Parameter(torch.zeros(self.batch_shape + self.features)) if use_bias
                     else None)
        with torch.no_grad():
            fan_in = math.prod(self.batch_shape) * math.prod(self.in_shape)
            _trunc_normal(self.weight, math.sqrt(1.0 / fan_in), generator)

    def contracted_axes(self, ndim: int) -> tuple:
        """The input axes contracted with the kernel, non-negative."""
        axis = self.axis or tuple(range(-len(self.in_shape), 0))
        return tuple(a % ndim for a in axis)

    def forward(self, x):
        axis = self.contracted_axes(x.ndim)
        letters = iter("abcdefghijklmnopqrstuvwxyz")
        xs = [next(letters) for _ in range(x.ndim)]
        feats = "".join(next(letters) for _ in self.features)
        bdims = tuple(d % x.ndim for d in self.batch_dims)
        if tuple(x.shape[d] for d in bdims) != self.batch_shape:
            raise ValueError(f"batch axes {tuple(x.shape[d] for d in bdims)} of the input do not "
                             f"match the kernel's {self.batch_shape}.")
        ks = "".join(xs[d] for d in bdims) + "".join(xs[a] for a in axis) + feats
        free = [c for i, c in enumerate(xs) if i not in axis and i not in bdims]
        out = "".join(xs[d] for d in bdims) + "".join(free) + feats
        y = torch.einsum(f"{''.join(xs)},{ks}->{out}", x, self.weight)
        if self.bias is None:
            return y
        # the bias's batch axes on the output's, 1 on its other free axes
        shape = self.batch_shape + (1,) * len(free) + self.features
        return y + self.bias.reshape(shape)


class Einsum(nn.Module):
    """flax `nn.Einsum(shape, einsum_str)`: the kernel `weight` of `shape`
    (flax layout), lecun-normal on its contracted size, and a zero bias over
    the kernel's axes that reach the output, in the output's order. The
    equation comes from the constructor, or from the call when the
    constructor's is None (flax's `merge_param`; the taps then see no
    equation, as the JAX package's interceptor does not)."""

    tap_kind = "dense_general"

    def __init__(self, shape, einsum_str: str | None = None, use_bias: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.shape = _shape(shape)
        self.einsum_str = None if einsum_str is None else einsum_str.replace(" ", "")
        self.weight = nn.Parameter(torch.empty(self.shape))
        self.bias = None
        if use_bias:
            if self.einsum_str is None:
                raise ValueError("A biased Einsum twin needs its einsum_str at construction.")
            rhs, out = self._operands(self.einsum_str)[1:]
            self.bias = nn.Parameter(torch.zeros(
                tuple(self.shape[rhs.index(c)] for c in out if c in rhs)))
        with torch.no_grad():
            # flax's lecun_normal on an n-d kernel: fan in = size / last axis
            _trunc_normal(self.weight, math.sqrt(self.shape[-1] / math.prod(self.shape)),
                          generator)

    @staticmethod
    def _operands(einsum_str: str) -> tuple:
        if "->" not in einsum_str or einsum_str.count(",") != 1:
            raise ValueError(f"einsum_str {einsum_str!r} must be explicit with two operands.")
        lhs_rhs, out = einsum_str.split("->")
        lhs, rhs = lhs_rhs.split(",")
        return lhs, rhs, out

    def forward(self, x, einsum_str: str | None = None):
        if (self.einsum_str is None) == (einsum_str is None):
            raise ValueError("Give einsum_str to exactly one of the constructor and the call.")
        es = self.einsum_str or einsum_str.replace(" ", "")
        y = torch.einsum(es, x, self.weight)
        if self.bias is None:
            return y
        rhs, out = self._operands(es)[1:]
        out = out.replace("...", "." * (y.ndim - len(out.replace("...", ""))))
        shape = [self.shape[rhs.index(c)] if c in rhs else 1 for c in out]
        return y + self.bias.reshape(shape)


class MultiHeadDotProductAttention(nn.Module):
    """flax `nn.MultiHeadDotProductAttention(num_heads, qkv_features)` in
    self-attention, without dropout (inference): `query`, `key` and
    `value` are `DenseGeneral(d -> (heads, head_dim))`, `out` is
    `DenseGeneral((heads, head_dim) -> out_features)`. As flax's
    `dot_product_attention`, the query is divided by sqrt(head_dim) before
    the logits einsum and the softmax runs over the keys; where a boolean
    `mask` (broadcast to (..., heads, queries, keys)) is False, the logit
    is the dtype's least value first."""

    def __init__(self, features: int, num_heads: int, qkv_features: int | None = None,
                 out_features: int | None = None, generator: torch.Generator | None = None):
        super().__init__()
        qkv = qkv_features or features
        if qkv % num_heads:
            raise ValueError(f"qkv_features {qkv} must be divisible by num_heads {num_heads}.")
        heads = (num_heads, qkv // num_heads)
        self.query = DenseGeneral(features, heads, generator=generator)
        self.key = DenseGeneral(features, heads, generator=generator)
        self.value = DenseGeneral(features, heads, generator=generator)
        self.out = DenseGeneral(heads, out_features or features, generator=generator)

    def forward(self, x, mask=None):
        q, k, v = self.query(x), self.key(x), self.value(x)  # (..., T, heads, head_dim)
        q = q / math.sqrt(q.shape[-1])
        logits = torch.einsum("...qhd,...khd->...hqk", q, k)
        if mask is not None:
            logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
        w = torch.softmax(logits, dim=-1)
        return self.out(torch.einsum("...hqk,...khd->...qhd", w, v))


class _Norm(nn.Module):
    """A flax norm's affine part on the feature axis `axis` (-1, or 1 for
    an NCHW tensor): `(x - mean) * (scale * rsqrt(var + epsilon)) + bias`,
    as flax's `_normalize` computes it. The KFAC and diagonal taps read
    `scale`, `bias` and `axis` (`nnmodel.apply_with_taps(norm=True)`)."""

    tap_kind = "norm"

    def __init__(self, features: int, epsilon: float, axis: int, use_bias: bool = True):
        super().__init__()
        self.epsilon, self.axis = epsilon, axis
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def _feature(self, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """A (features,) tensor shaped to broadcast along `axis`."""
        shape = [1] * ndim
        shape[self.axis] = -1
        return t.reshape(shape)

    def _affine(self, x, mean, var):
        mul = torch.rsqrt(var + self.epsilon) * self._feature(self.scale, x.ndim)
        y = (x - mean) * mul
        return y if self.bias is None else y + self._feature(self.bias, x.ndim)


class LayerNorm(_Norm):
    """flax `nn.LayerNorm()` over the feature axis: epsilon 1e-6, leaves
    `scale` and `bias`, and flax's fast variance `max(0, E[x²] − E[x]²)`
    (not torch's two-pass `layer_norm`), so float32 tracks flax."""

    def __init__(self, features: int, epsilon: float = 1e-6, axis: int = -1):
        super().__init__(features, epsilon, axis)

    def forward(self, x):
        mean = x.mean(self.axis, keepdim=True)
        var = ((x * x).mean(self.axis, keepdim=True) - mean * mean).clamp(min=0.0)
        return self._affine(x, mean, var)


class RMSNorm(_Norm):
    """flax `nn.RMSNorm()` over the feature axis: `x * rsqrt(E[x²] +
    epsilon) * scale`, epsilon 1e-6, the leaf `scale` and no bias."""

    def __init__(self, features: int, epsilon: float = 1e-6, axis: int = -1):
        super().__init__(features, epsilon, axis, use_bias=False)

    def forward(self, x):
        var = (x * x).mean(self.axis, keepdim=True)
        return self._affine(x, 0.0, var)


class BatchNorm(_Norm):
    """flax `nn.BatchNorm(use_running_average=True)`: the running `mean` and
    `var` are buffers (flax's `batch_stats`, frozen, never in the flat
    vector), epsilon 1e-5."""

    def __init__(self, features: int, epsilon: float = 1e-5, axis: int = -1):
        super().__init__(features, epsilon, axis)
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x):
        return self._affine(x, self._feature(self.mean, x.ndim), self._feature(self.var, x.ndim))


class GroupNorm(_Norm):
    """flax `nn.GroupNorm(num_groups)`: the features split into
    `num_groups` consecutive groups, each normalized over itself and every
    axis but the batch one, with flax's fast variance; epsilon 1e-6."""

    def __init__(self, features: int, num_groups: int = 32, epsilon: float = 1e-6,
                 axis: int = -1):
        super().__init__(features, epsilon, axis)
        if features % num_groups:
            raise ValueError(f"{features} features do not split into {num_groups} groups.")
        self.num_groups = num_groups

    def forward(self, x):
        xg = x.movedim(self.axis, -1)
        xg = xg.reshape(*xg.shape[:-1], self.num_groups, -1)
        red = tuple(range(1, xg.ndim - 2)) + (xg.ndim - 1,)
        mean = xg.mean(red, keepdim=True)
        var = ((xg * xg).mean(red, keepdim=True) - mean * mean).clamp(min=0.0)
        shape = x.movedim(self.axis, -1).shape
        mean, var = (t.expand_as(xg).reshape(shape).movedim(-1, self.axis) for t in (mean, var))
        return self._affine(x, mean, var)


class InstanceNorm(_Norm):
    """flax `nn.InstanceNorm()`: statistics per sample and feature, over
    every axis but the batch and the feature `axis`, with flax's fast
    variance; epsilon 1e-6, leaves `scale` and `bias`."""

    def __init__(self, features: int, epsilon: float = 1e-6, axis: int = -1):
        super().__init__(features, epsilon, axis)

    def forward(self, x):
        red = tuple(i for i in range(1, x.ndim) if i != self.axis % x.ndim)
        mean = x.mean(red, keepdim=True)
        var = ((x * x).mean(red, keepdim=True) - mean * mean).clamp(min=0.0)
        return self._affine(x, mean, var)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


class Conv(nn.Module):
    """flax `nn.Conv(features, kernel_size, strides, padding,
    input_dilation, kernel_dilation, feature_group_count, use_bias, mask)`
    on `(B, C, *S)` tensors with 1, 2 or 3 spatial dims, the layout of
    `nn.Conv1d/2d/3d` (`models.resnet.Conv` is its ResNet case).

    `padding` is 'SAME', 'VALID', 'CIRCULAR' (flax's wrap pad by the
    dilated kernel extent, then VALID) or explicit `(lo, hi)` pairs (an int
    pads every side alike); string padding with input dilation raises
    `ValueError`, as flax does. The kernel `weight` is `(out, in / groups,
    *k)` (flax's `(*k, in / groups, out)` in the flat vector), lecun-normal
    on its fan in; the bias is zero. `mask`, in flax's kernel layout, is a
    buffer (never a leaf): the forward convolves with `weight * mask`,
    as flax does."""

    tap_kind = "conv"

    def __init__(self, in_features: int, features: int, kernel_size, strides=1,
                 padding="SAME", input_dilation=1, kernel_dilation=1,
                 feature_group_count: int = 1, use_bias: bool = True, mask=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.kernel_size = _shape(kernel_size)
        n = len(self.kernel_size)
        if n not in _CONV:
            raise ValueError(f"Conv twin takes 1, 2 or 3 spatial dims, not {n}.")
        if in_features % feature_group_count or features % feature_group_count:
            raise ValueError(f"{in_features} -> {features} features do not split into "
                             f"{feature_group_count} groups.")
        self.strides = as_tuple(strides, n)
        self.padding = padding.upper() if isinstance(padding, str) else padding
        self.input_dilation = as_tuple(input_dilation, n)
        self.kernel_dilation = as_tuple(kernel_dilation, n)
        self.feature_group_count = feature_group_count
        if isinstance(self.padding, str) and any(d != 1 for d in self.input_dilation):
            raise ValueError("String padding is not implemented for a conv with "
                             "input_dilation (flax and lax reject it); give (lo, hi) pairs.")
        shape = (features, in_features // feature_group_count) + self.kernel_size
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        if mask is not None:
            mask = from_flax_layout(torch.as_tensor(mask, dtype=torch.get_default_dtype()), CONV)
            if tuple(mask.shape) != shape:
                raise ValueError(f"mask of shape {tuple(mask.shape)} for a kernel {shape}.")
            mask = mask.contiguous()
        self.register_buffer("mask", mask, persistent=False)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's lecun-normal kernel on its fan in."""
        _trunc_normal(self.weight, math.sqrt(1.0 / self.weight[0].numel()), generator)

    def kernel(self) -> torch.Tensor:
        """The kernel the forward convolves with: `weight * mask`."""
        return self.weight if self.mask is None else self.weight * self.mask

    def forward(self, x):
        x = pad_input(dilate_input(x, self.input_dilation), self.kernel_size, self.strides,
                      self.padding, self.kernel_dilation)
        return _CONV[len(self.kernel_size)](x, self.kernel(), self.bias, stride=self.strides,
                                            dilation=self.kernel_dilation,
                                            groups=self.feature_group_count)
