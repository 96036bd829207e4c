"""Torch twins of flax.linen layers (flax 0.12): those of `bench.py`'s
reward-model transformer (`Embed`, `DenseGeneral`,
`MultiHeadDotProductAttention`, `LayerNorm`) and the norms of
`laplace_jax/models/wideresnet.py` (`BatchNorm` in inference mode,
`GroupNorm`).

Every parameter is kept in flax layout and under flax's leaf name
(`embedding`, `kernel` as the torch `weight`, `bias`, `scale`), so the
flat vector (`utils/flatten.py`) and `models.resnet.state_dict_from_flax`
take them as they are. None of them is an `nn.Linear`: the JAX package
taps a `DenseGeneral` as the kind `dense_general`, not as a Dense, and so
does the port's discovery (`tap_kind`).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from laplace_jax_torch.models.resnet import _trunc_normal

__all__ = ["Embed", "DenseGeneral", "MultiHeadDotProductAttention", "LayerNorm", "BatchNorm",
           "GroupNorm"]


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
    """flax `nn.DenseGeneral(features, axis)` contracting the last
    `len(in_shape)` axes: kernel `weight` in flax layout `(*in_shape,
    *features)`, bias `(*features,)`; lecun-normal kernel on the contracted
    size, zero bias."""

    tap_kind = "dense_general"

    def __init__(self, in_shape, features, use_bias: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.in_shape, self.features = _shape(in_shape), _shape(features)
        self.weight = nn.Parameter(torch.empty(self.in_shape + self.features))
        self.bias = nn.Parameter(torch.zeros(self.features)) if use_bias else None
        with torch.no_grad():
            _trunc_normal(self.weight, math.sqrt(1.0 / math.prod(self.in_shape)), generator)

    def forward(self, x):
        y = torch.tensordot(x, self.weight, dims=len(self.in_shape))
        return y if self.bias is None else y + self.bias


class MultiHeadDotProductAttention(nn.Module):
    """flax `nn.MultiHeadDotProductAttention(num_heads, qkv_features)` in
    self-attention, without mask or dropout (inference): `query`, `key` and
    `value` are `DenseGeneral(d -> (heads, head_dim))`, `out` is
    `DenseGeneral((heads, head_dim) -> out_features)`. As flax's
    `dot_product_attention`, the query is divided by sqrt(head_dim) before
    the logits einsum and the softmax runs over the keys."""

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

    def forward(self, x):
        q, k, v = self.query(x), self.key(x), self.value(x)  # (..., T, heads, head_dim)
        q = q / math.sqrt(q.shape[-1])
        w = torch.softmax(torch.einsum("...qhd,...khd->...hqk", q, k), dim=-1)
        return self.out(torch.einsum("...hqk,...khd->...qhd", w, v))


class _Norm(nn.Module):
    """A flax norm's affine part on the feature axis `axis` (-1, or 1 for
    an NCHW tensor): `(x - mean) * (scale * rsqrt(var + epsilon)) + bias`,
    as flax's `_normalize` computes it. The KFAC and diagonal taps read
    `scale`, `bias` and `axis` (`nnmodel.apply_with_taps(norm=True)`)."""

    tap_kind = "norm"

    def __init__(self, features: int, epsilon: float, axis: int):
        super().__init__()
        self.epsilon, self.axis = epsilon, axis
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def _feature(self, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """A (features,) tensor shaped to broadcast along `axis`."""
        shape = [1] * ndim
        shape[self.axis] = -1
        return t.reshape(shape)

    def _affine(self, x, mean, var):
        mul = torch.rsqrt(var + self.epsilon) * self._feature(self.scale, x.ndim)
        return (x - mean) * mul + self._feature(self.bias, x.ndim)


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
