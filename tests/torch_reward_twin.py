"""The torch twin of `bench.py`'s reward-model transformer
(`bench.py:396-410`) from `laplace_jax_torch.models.flax_layers`, at any
width. It imports no JAX, so the card tests build it too.
"""

import torch
import torch.nn.functional as F
from torch import nn

from laplace_jax_torch.models.flax_layers import Embed, LayerNorm, MultiHeadDotProductAttention
from laplace_jax_torch.models.resnet import _trunc_normal


class RewardTransformer(nn.Module):
    """The torch twin: `Embed_0`, then per block `MultiHeadDotProductAttention_i`,
    `LayerNorm_{2i}`, `Dense_{2i}`, tanh-gelu, `Dense_{2i+1}`,
    `LayerNorm_{2i+1}`; the mean over the sequence into the head
    `Dense_{2 blocks}` (2 outputs)."""

    def __init__(self, vocab=4096, d=256, heads=8, mlp=1024, blocks=4, generator=None):
        super().__init__()
        self.blocks = blocks
        self.Embed_0 = Embed(vocab, d, generator=generator)
        for i in range(blocks):
            self.add_module(f"MultiHeadDotProductAttention_{i}",
                            MultiHeadDotProductAttention(d, heads, qkv_features=d,
                                                         generator=generator))
            self.add_module(f"LayerNorm_{2 * i}", LayerNorm(d))
            self.add_module(f"Dense_{2 * i}", nn.Linear(d, mlp))
            self.add_module(f"Dense_{2 * i + 1}", nn.Linear(mlp, d))
            self.add_module(f"LayerNorm_{2 * i + 1}", LayerNorm(d))
        self.add_module(f"Dense_{2 * blocks}", nn.Linear(d, 2))
        with torch.no_grad():  # flax's Dense initializers: lecun normal, zero bias
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    _trunc_normal(m.weight, m.in_features ** -0.5, generator)
                    m.bias.zero_()

    def forward(self, ids):
        x = self.Embed_0(ids)
        for i in range(self.blocks):
            x = getattr(self, f"LayerNorm_{2 * i}")(
                x + getattr(self, f"MultiHeadDotProductAttention_{i}")(x))
            h = F.gelu(getattr(self, f"Dense_{2 * i}")(x), approximate="tanh")
            x = getattr(self, f"LayerNorm_{2 * i + 1}")(x + getattr(self, f"Dense_{2 * i + 1}")(h))
        return getattr(self, f"Dense_{2 * self.blocks}")(x.mean(dim=1))
