"""MLP, the twin of `laplace_jax/models/mlp.py`: Dense layers named
`Dense_0`, `Dense_1`, ... so that the flatten order matches the flax one
(`utils/flatten.py`); weights carry over with
`models.resnet.state_dict_from_flax`."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["MLP"]

_ACTIVATIONS = {"tanh": torch.tanh, "relu": F.relu,
                "gelu": lambda x: F.gelu(x, approximate="tanh")}  # flax's gelu is the tanh form


class MLP(nn.Module):
    """`in_dim` -> `hidden` widths with `activation` -> `out_dim`."""

    def __init__(self, in_dim: int, hidden: Sequence[int] = (50,), out_dim: int = 1,
                 activation: str = "tanh"):
        super().__init__()
        self.activation = activation
        self._act = _ACTIVATIONS[activation]
        widths = [in_dim, *hidden, out_dim]
        self.n_dense = len(widths) - 1
        for i in range(self.n_dense):
            self.add_module(f"Dense_{i}", nn.Linear(widths[i], widths[i + 1]))

    def forward(self, x):
        for i in range(self.n_dense):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n_dense - 1:
                x = self._act(x)
        return x
