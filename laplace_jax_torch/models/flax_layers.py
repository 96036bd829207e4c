"""Torch twins of the flax.linen layers of `bench.py`'s reward-model
transformer: `Embed`, `DenseGeneral`, `MultiHeadDotProductAttention` and
`LayerNorm` (flax 0.12).

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

__all__ = ["Embed", "DenseGeneral", "MultiHeadDotProductAttention", "LayerNorm"]


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


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm()` over the last axis: epsilon 1e-6, leaves
    `scale` and `bias`, and flax's fast variance `max(0, E[x²] − E[x]²)`
    (not torch's two-pass `layer_norm`), so float32 tracks flax."""

    tap_kind = "norm"

    def __init__(self, features: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp(min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.epsilon) * self.scale) + self.bias
