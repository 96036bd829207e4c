"""Small flax models and their torch twins for the curvature parity tests
(`test_torch_backends.py`, `test_torch_diag_taps.py`,
`test_torch_kron_norm.py`), and the JAX package's MC draws for the port.

Each `*_pair` initializes the flax model from a seed, casts its variables
to float64 (randomizing `batch_stats` where there are some, so BatchNorm is
no identity), and loads them into the twin with `state_dict_from_flax`.
The larger pairs are built once a process: no test changes their weights.
`JaxDraws` stands in for `laplace_jax_torch.curvature.kfac.mc_draws`: the
k-th call returns the draws the JAX package makes from the k-th key it
derives (`fold_in(key, s)` per sample s, as its `kfac.py:236` and
`backend.py:352` do).
"""

import functools
import warnings

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from laplace_jax.models import ResNet18 as FlaxResNet18
from laplace_jax.models import WideResNet16x4 as FlaxWRN
from laplace_jax.nnmodel import NNModel as JaxNNModel
from laplace_jax_torch.models.flax_layers import BatchNorm, GroupNorm, InstanceNorm, LayerNorm
from laplace_jax_torch.models.resnet import Conv, ResNet18, state_dict_from_flax
from laplace_jax_torch.models.wideresnet import WideResNet16x4


class FlaxMLP(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        h = jnp.tanh(fnn.Dense(20)(x))
        return fnn.Dense(2)(h)


class MLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0, self.Dense_1 = nn.Linear(3, 20), nn.Linear(20, 2)

    def forward(self, x):
        return self.Dense_1(torch.tanh(self.Dense_0(x)))


class FlaxTwoConv(fnn.Module):
    """Two SAME convs with biases (the first of stride 2) and a Dense head,
    on (B, 6, 6, 2) inputs."""

    @fnn.compact
    def __call__(self, x):
        x = jax.nn.relu(fnn.Conv(4, (3, 3), strides=(2, 2))(x))
        x = jnp.tanh(fnn.Conv(3, (3, 3))(x))
        return fnn.Dense(3)(x.reshape(x.shape[0], -1))


class TwoConv(nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv_0 = Conv(2, 4, 3, 2, use_bias=True)
        self.Conv_1 = Conv(4, 3, 3, 1, use_bias=True)
        self.Dense_0 = nn.Linear(27, 3)

    def forward(self, x):
        x = torch.tanh(self.Conv_1(F.relu(self.Conv_0(x.permute(0, 3, 1, 2)))))
        return self.Dense_0(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


class FlaxBNCNN(fnn.Module):
    """`tests/test_kron_norm.py`'s BNCNN: a stride-2 conv, a norm (batch,
    group, layer or instance), a Dense, a LayerNorm when `norm == "layer"`,
    the head."""

    norm: str = "batch"

    @fnn.compact
    def __call__(self, x):
        x = fnn.Conv(4, (3, 3), strides=(2, 2))(x)
        if self.norm == "batch":
            x = fnn.BatchNorm(use_running_average=True)(x)
        elif self.norm == "group":
            x = fnn.GroupNorm(num_groups=2)(x)
        elif self.norm == "instance":
            x = fnn.InstanceNorm()(x)
        else:
            x = fnn.LayerNorm()(x)
        x = fnn.Dense(6)(jax.nn.relu(x).reshape(x.shape[0], -1))
        if self.norm == "layer":
            x = fnn.LayerNorm()(x)
        return fnn.Dense(3)(jnp.tanh(x))


class BNCNN(nn.Module):
    def __init__(self, norm="batch"):
        super().__init__()
        self.norm = norm
        self.Conv_0 = Conv(2, 4, 3, 2, use_bias=True)
        if norm == "batch":
            self.BatchNorm_0 = BatchNorm(4, axis=1)
        elif norm == "group":
            self.GroupNorm_0 = GroupNorm(4, num_groups=2, axis=1)
        elif norm == "instance":
            self.InstanceNorm_0 = InstanceNorm(4, axis=1)
        else:
            self.LayerNorm_0 = LayerNorm(4, axis=1)
            self.LayerNorm_1 = LayerNorm(6)
        self.Dense_0, self.Dense_1 = nn.Linear(36, 6), nn.Linear(6, 3)

    def forward(self, x):
        name = {"batch": "BatchNorm_0", "group": "GroupNorm_0", "instance": "InstanceNorm_0",
                "layer": "LayerNorm_0"}
        x = getattr(self, name[self.norm])(self.Conv_0(x.permute(0, 3, 1, 2)))
        x = self.Dense_0(F.relu(x).permute(0, 2, 3, 1).reshape(x.shape[0], -1))
        if self.norm == "layer":
            x = self.LayerNorm_1(x)
        return self.Dense_1(torch.tanh(x))


class FlaxScaled(fnn.Module):
    """A Dense, then a module with a bare parameter `w` (3, 5) mixing the
    features, then the head: `w` is under no tapped layer."""

    @fnn.compact
    def __call__(self, x):
        h = jnp.tanh(fnn.Dense(5)(x))
        w = self.param("w", fnn.initializers.normal(0.5), (3, 5))
        return fnn.Dense(3)(jnp.tanh(h @ w.T))


class Scaled(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0, self.Dense_1 = nn.Linear(4, 5), nn.Linear(3, 3)
        self.w = nn.Parameter(torch.zeros(3, 5))

    def forward(self, x):
        return self.Dense_1(torch.tanh(torch.tanh(self.Dense_0(x)) @ self.w.T))


def _load(fm, tm, X, seed, stats=False):
    variables = jax.jit(fm.init)(jax.random.key(seed), jnp.asarray(X[:1]))
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
    if stats and "batch_stats" in variables:
        rng = np.random.default_rng(seed + 1)
        variables = dict(variables)
        variables["batch_stats"] = jax.tree_util.tree_map(
            lambda a: a + 0.1 * np.abs(rng.standard_normal(a.shape)), variables["batch_stats"])
    tm = tm.double()
    tm.load_state_dict(state_dict_from_flax(variables, tm))
    return JaxNNModel.from_flax(fm, variables), tm


def mlp_pair(seed=711):
    X = np.random.default_rng(seed).standard_normal((10, 3))
    return _load(FlaxMLP(), MLP(), X, seed)


def conv_pair(seed=0):
    X = np.random.default_rng(seed).standard_normal((6, 6, 6, 2))
    return _load(FlaxTwoConv(), TwoConv(), X, seed)


@functools.cache
def resnet_pair(width=8, seed=0, size=8):
    X = np.zeros((1, size, size, 3))
    return _load(FlaxResNet18(width=width, dtype=jnp.float64), ResNet18(width=width), X, seed)


@functools.cache
def wrn_pair(norm, seed=0, classes=4):
    X = np.zeros((1, 8, 8, 3))
    return _load(FlaxWRN(num_classes=classes, widen_factor=1, norm=norm, dtype=jnp.float64),
                 WideResNet16x4(classes, 1, norm), X, seed, stats=True)


@functools.cache
def bncnn_pair(norm, seed=0):
    X = np.zeros((1, 6, 6, 2))
    return _load(FlaxBNCNN(norm=norm), BNCNN(norm), X, seed, stats=True)


def scaled_pair(seed=0):
    X = np.zeros((1, 4))
    return _load(FlaxScaled(), Scaled(), X, seed)


def classification(n, shape, classes, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) + tuple(shape)), rng.integers(0, classes, n)


def regression(n, shape, outputs, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) + tuple(shape)), rng.standard_normal((n, outputs))


def jax_draws(f, likelihood, num_samples, key):
    """The JAX package's MC draws at outputs f from `key`: per sample s,
    `categorical(fold_in(key, s), f)` or `normal(fold_in(key, s), f.shape)`."""
    f = jnp.asarray(f)
    out = []
    for s in range(num_samples):
        k = jax.random.fold_in(key, s)
        if likelihood == "regression":
            out.append(jax.random.normal(k, f.shape, dtype=f.dtype))
        else:
            out.append(jax.random.categorical(k, f, axis=-1))
    return np.asarray(jnp.stack(out))


class JaxDraws:
    """`mc_draws` for the port: call k draws from `keys[k]`, the key the
    JAX side used for the same batch."""

    def __init__(self, keys):
        self.keys, self.calls = list(keys), 0

    def __call__(self, f, likelihood, num_samples, generator):
        key = self.keys[self.calls]
        self.calls += 1
        return torch.as_tensor(np.array(jax_draws(f.detach().cpu().numpy(), likelihood,
                                                  num_samples, key)),
                               device=f.device)


def fit_keys(n_batches, key=None):
    """The keys the JAX package's `fit` gives its batches: fold_in(key, i)."""
    key = jax.random.key(0) if key is None else key
    return [jax.random.fold_in(key, i) for i in range(n_batches)]


def close(got, ref, rel):
    """|got - ref| <= rel * max |ref|, elementwise."""
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-300))


def kron_close(kt, kj, rel=1e-9):
    """Every factor of a port `Kron` against the JAX package's."""
    assert len(kt.kfacs) == len(kj.kfacs)
    for Ft, Fj in zip(kt.kfacs, kj.kfacs):
        assert len(Ft) == len(Fj)
        for a, b in zip(Ft, Fj):
            close(a, b, rel)


def outcome(fn):
    """(value, "zero curvature" warnings) of fn(), or the exception's class;
    the warnings with the JAX leaf paths' leading `params/` dropped."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            value = fn()
        except Exception as exc:  # noqa: BLE001 - the class is compared
            return type(exc)
    return value, [str(c.message).replace("params/", "") for c in caught
                   if "zero curvature" in str(c.message)]
