"""The flax-layer twins (`laplace_jax_torch.models.flax_layers`) and the
layout of each flat-vector leaf by the module that owns it
(`utils/flatten.py`), against flax in float64.

- The narrow reward transformer (vocab 64, d 16, 2 heads, MLP 32, 2 blocks,
  sequences of 8; `tests/torch_reward.py`) forward against flax's within
  1e-12 relative, and its flat vector against `ravel_pytree` of the flax
  parameters exactly.
- `Embed`, `DenseGeneral` (both attention shapes), `MultiHeadDotProductAttention`
  and `LayerNorm` one at a time, the same two checks each.
- A 1-D conv (`nn.Conv1d`, flax kernel `(k, in, out)`): its leaf's layout,
  forward and flat vector against flax's.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from laplace_jax_torch.models.flax_layers import (
    DenseGeneral,
    Embed,
    LayerNorm,
    MultiHeadDotProductAttention,
)
from laplace_jax_torch.models.resnet import state_dict_from_flax
from laplace_jax_torch.utils.flatten import CONV, FLAX, LINEAR, leaf_specs, parameters_to_vector

from .torch_reward import NARROW, RewardTransformer, n_weights, reward_pair

torch.set_num_threads(1)

FWD_TOL = 1e-12


def _f64(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)


def _noisy(params, seed):
    """The parameters plus N(0, 0.3²) noise, so that no leaf is 0 or 1."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: a + 0.3 * rng.standard_normal(a.shape), params)


def _check_pair(fm, params, tm, x_np):
    tm.load_state_dict(state_dict_from_flax(params, tm))
    ref = np.asarray(fm.apply(params, jnp.asarray(x_np)))
    got = tm(torch.as_tensor(x_np)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=FWD_TOL * np.abs(ref).max())
    assert np.array_equal(parameters_to_vector(tm).numpy(), np.asarray(ravel_pytree(params)[0]))


def test_reward_transformer_forward_and_flat_vector():
    ids, _, fm, params, tm = reward_pair()
    ref = np.asarray(fm.apply(params, jnp.asarray(ids)))
    got = tm(torch.as_tensor(ids)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=FWD_TOL * np.abs(ref).max())
    flat = parameters_to_vector(tm).numpy()
    assert flat.shape == (n_weights(**NARROW),)
    assert np.array_equal(flat, np.asarray(ravel_pytree(params)[0]))


def test_reward_transformer_names_and_layouts():
    """flax's auto-names, and each leaf's layout from its owner: Dense
    kernels transposed, everything else (embedding, attention kernels and
    biases, norm scales) as it is."""
    _, _, _, params, tm = reward_pair()
    specs = leaf_specs(tm)
    flax_paths = [tuple(str(k.key) for k in p)[1:]
                  for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    assert [s.path for s in specs] == flax_paths
    for s in specs:
        want = LINEAR if s.path[0].startswith("Dense") and s.path[-1] == "kernel" else FLAX
        assert s.layout == want, s
    mha = {s.path[1:]: s.shape for s in specs if s.path[0] == "MultiHeadDotProductAttention_1"}
    d, heads = NARROW["d"], NARROW["heads"]
    assert mha[("query", "kernel")] == (d, heads, d // heads)
    assert mha[("query", "bias")] == (heads, d // heads)
    assert mha[("out", "kernel")] == (heads, d // heads, d)
    assert next(s.shape for s in specs if s.path == ("Embed_0", "embedding")) == (
        NARROW["vocab"], d)
    assert n_weights(4096, 256, 8, 1024, 4) == 4_208_130  # bench.py's sizes


def test_embed():
    ids = np.random.default_rng(0).integers(0, 11, size=(3, 5))
    fm = fnn.Embed(11, 4)
    params = _f64(fm.init(jax.random.key(0), jnp.asarray(ids)))
    _check_pair(fm, params, Embed(11, 4).double(), ids)


@pytest.mark.parametrize("in_shape,features", [((6,), (2, 3)), ((2, 3), (5,))])
def test_dense_general(in_shape, features):
    axis = tuple(range(-len(in_shape), 0))
    x = np.random.default_rng(1).standard_normal((3, 4) + in_shape)
    fm = fnn.DenseGeneral(features, axis=axis if len(axis) > 1 else axis[0])
    params = _noisy(_f64(fm.init(jax.random.key(1), jnp.asarray(x))), 1)
    tm = DenseGeneral(in_shape, features).double()
    assert not isinstance(tm, torch.nn.Linear)
    _check_pair(fm, params, tm, x)


def test_multi_head_attention():
    x = np.random.default_rng(2).standard_normal((3, 5, 8))
    fm = fnn.MultiHeadDotProductAttention(num_heads=2, qkv_features=8, deterministic=True)
    params = _noisy(_f64(fm.init(jax.random.key(2), jnp.asarray(x))), 2)
    _check_pair(fm, params, MultiHeadDotProductAttention(8, 2, qkv_features=8).double(), x)


def test_layer_norm():
    """float64 against flax on inputs of mean 3, and float32 against flax's
    float32 on zero-mean inputs within 1e-6 (a few float32 roundings: the
    two sum E[x] and E[x²] in different orders)."""
    x = 3.0 + np.random.default_rng(3).standard_normal((4, 7, 6))
    fm = fnn.LayerNorm()
    params = _noisy(_f64(fm.init(jax.random.key(3), jnp.asarray(x))), 3)
    tm = LayerNorm(6).double()
    _check_pair(fm, params, tm, x)
    x0 = x - 3.0
    p32 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    ref32 = np.asarray(fm.apply(p32, jnp.asarray(x0, jnp.float32)))
    got32 = tm.float()(torch.as_tensor(x0, dtype=torch.float32)).detach().numpy()
    np.testing.assert_allclose(got32, ref32, rtol=0, atol=1e-6)


class _FlaxConv1d(fnn.Module):
    @fnn.compact
    def __call__(self, x):  # (B, L, C)
        return fnn.Conv(4, (2,))(x).mean(axis=1)


class _Conv1d(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv_0 = torch.nn.Conv1d(3, 4, 2, padding="same")

    def forward(self, x):  # (B, L, C), flax's layout
        return self.Conv_0(x.transpose(1, 2)).mean(dim=2)


def test_conv1d_layout():
    """A `Conv1d` weight (out, in, k) is flax's (k, in, out) in the flat
    vector; `state_dict_from_flax` with the module maps it back."""
    x = np.random.default_rng(4).standard_normal((3, 6, 3))
    fm = _FlaxConv1d()
    params = _noisy(_f64(fm.init(jax.random.key(4), jnp.asarray(x))), 4)
    tm = _Conv1d().double()
    _check_pair(fm, params, tm, x)
    spec = next(s for s in leaf_specs(tm) if s.path[-1] == "kernel")
    assert spec.layout == CONV and spec.shape == (2, 3, 4)
    assert tuple(tm.Conv_0.weight.shape) == (4, 3, 2)


def test_twin_init_is_seeded():
    """The twin's own initialization (flax's initializers, from a torch
    generator) is the same for the same seed."""
    a = RewardTransformer(**NARROW, generator=torch.Generator().manual_seed(5))
    b = RewardTransformer(**NARROW, generator=torch.Generator().manual_seed(5))
    assert torch.equal(parameters_to_vector(a), parameters_to_vector(b))
