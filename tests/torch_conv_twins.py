"""The conv-variant models of `tests/test_torch_conv_variants*.py`, each a
layer list that builds a flax model and its torch twin (the flax `Conv`
twin of `models/flax_layers.py`, or torch's own conv module of the same
padding), with the flax weights carried over by `state_dict_from_flax` and
the inputs made from a numpy seed: grouped and depthwise convs, CIRCULAR
padding, input dilation, masked convs (PixelCNN masks, with and without
groups), 1-D and 3-D convs (the 3-D one with the `InstanceNorm` twin), and
torch's `nn.Conv1d`, grouped and circular `nn.Conv2d` and `nn.Conv3d`.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch import nn

from laplace_jax.nnmodel import NNModel as JaxNNModel
from laplace_jax_torch.models.flax_layers import Conv, InstanceNorm
from laplace_jax_torch.models.resnet import state_dict_from_flax

REL = 1e-10
F64 = jnp.float64
N, C = 6, 3


def pixelcnn_mask(k, cin, cout, include_center=False):
    """`tests/test_masked_conv.py`'s raster-order mask, flax layout."""
    m = np.zeros((k, k, cin, cout))
    m[:k // 2] = 1.0
    m[k // 2, :k // 2] = 1.0
    if include_center:
        m[k // 2, k // 2] = 1.0
    return m


class FlaxNet(fnn.Module):
    """A layer list: ("conv", kwargs), ("instnorm",), ("tanh",), ("flat",),
    ("mean",), ("dense", n); channels last."""

    layers: tuple

    @fnn.compact
    def __call__(self, x):
        for op, *a in self.layers:
            if op == "conv":
                kw = dict(a[0])
                if "mask" in kw:
                    kw["mask"] = jnp.asarray(kw["mask"])
                x = fnn.Conv(dtype=F64, param_dtype=F64, **kw)(x)
            elif op == "instnorm":
                x = fnn.InstanceNorm(param_dtype=F64)(x)
            elif op == "dense":
                x = fnn.Dense(a[0], param_dtype=F64)(x)
            elif op == "tanh":
                x = jnp.tanh(x)
            elif op == "flat":
                x = x.reshape(x.shape[0], -1)
            else:  # mean over the spatial axes
                x = x.mean(axis=tuple(range(1, x.ndim - 1)))
        return x


def _torch_conv(kw, c_in):
    """A torch module for a flax conv's kwargs: the flax `Conv` twin, or
    (with "torch") torch's own `nn.ConvNd` of the same padding."""
    kw = dict(kw)
    module = kw.pop("torch", None)
    k = kw.pop("kernel_size")
    if module is None:
        return Conv(c_in, kw.pop("features"), k, **kw)
    cls = {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}[len(k)]
    return cls(c_in, kw["features"], k, stride=kw.get("strides", 1), padding=module[0],
               padding_mode=module[1], groups=kw.get("feature_group_count", 1))


class TorchNet(nn.Module):
    """The twin of a `FlaxNet` on channels-last inputs, channels first
    inside, each layer named as flax names it."""

    def __init__(self, layers, c_in):
        super().__init__()
        self.ops, counts = [], {}
        for op, *a in layers:
            cls = {"conv": "Conv", "instnorm": "InstanceNorm", "dense": "Dense"}.get(op)
            if cls is None:
                self.ops.append((op, None))
                continue
            name = f"{cls}_{counts.get(cls, 0)}"
            counts[cls] = counts.get(cls, 0) + 1
            if op == "conv":
                mod = _torch_conv(a[0], c_in)
                c_in = dict(a[0])["features"]
            elif op == "instnorm":
                mod = InstanceNorm(c_in, axis=1)
            else:
                mod = nn.LazyLinear(a[0])
            self.add_module(name, mod)
            self.ops.append((op, name))

    def forward(self, x):
        x = x.movedim(-1, 1)
        for op, name in self.ops:
            if op == "tanh":
                x = torch.tanh(x)
            elif op == "flat":
                x = x.movedim(1, -1).reshape(x.shape[0], -1)
            elif op == "mean":
                x = x.mean(tuple(range(2, x.ndim)))
            else:
                x = getattr(self, name)(x)
        return x


def _conv(**kw):
    return ("conv", tuple(kw.items()))


def _head(*conv):
    return conv + (("tanh",), ("flat",), ("dense", C))


MASK_A, MASK_B = pixelcnn_mask(3, 4, 4), pixelcnn_mask(3, 4, 4, include_center=True)
MODELS = {  # name: (layers, input shape)
    **{f"g{g}_s{s}_{p.lower()}": (_head(_conv(features=8, kernel_size=(3, 3), strides=s,
                                              padding=p, feature_group_count=g)), (6, 6, 4))
       for g in (1, 2, 4) for s, p in ((1, "SAME"), (2, "VALID"))},
    "depthwise": (_head(_conv(features=4, kernel_size=(3, 3), feature_group_count=4)),
                  (6, 6, 4)),
    "depthwise_s2_valid": (_head(_conv(features=4, kernel_size=(3, 3), strides=2,
                                       padding="VALID", feature_group_count=4)), (7, 7, 4)),
    **{f"circular_g{g}": (_head(_conv(features=6, kernel_size=(3, 3), padding="CIRCULAR",
                                      feature_group_count=g)), (6, 6, 4)) for g in (1, 2)},
    "circular_k2_dilated": (_head(_conv(features=6, kernel_size=(2, 3), padding="CIRCULAR",
                                        kernel_dilation=(2, 1))), (5, 6, 4)),
    "input_dilation": (_head(_conv(features=5, kernel_size=(3, 3), padding=((1, 1), (1, 1)),
                                   input_dilation=2)), (6, 6, 4)),
    "masked": (_head(_conv(features=4, kernel_size=(3, 3), mask=pixelcnn_mask(3, 3, 4)),
                     ("tanh",),
                     _conv(features=4, kernel_size=(3, 3), strides=2, mask=MASK_B)),
               (6, 6, 3)),
    "masked_grouped": (_head(_conv(features=6, kernel_size=(3, 3), feature_group_count=2,
                                   mask=pixelcnn_mask(3, 2, 6))), (5, 5, 4)),
    "conv1d": (_head(_conv(features=5, kernel_size=(3,)), ("tanh",),
                     _conv(features=4, kernel_size=(2,), strides=2, padding="VALID")), (7, 3)),
    "conv3d": ((_conv(features=4, kernel_size=(3, 3, 3)), ("instnorm",), ("tanh",),
                _conv(features=4, kernel_size=(2, 2, 2), strides=2), ("tanh",), ("mean",),
                ("dense", C)), (4, 4, 4, 2)),
    # torch's own conv modules, held to the flax conv of the same padding
    "torch_conv1d": (_head(_conv(features=5, kernel_size=(3,), padding=((1, 1),),
                                 torch=(1, "zeros"))), (7, 3)),
    "torch_conv2d_grouped": (_head(_conv(features=8, kernel_size=(3, 3), strides=2,
                                         padding=((1, 1), (1, 1)), feature_group_count=2,
                                         torch=(1, "zeros"))), (6, 6, 4)),
    "torch_conv2d_circular": (_head(_conv(features=6, kernel_size=(3, 3), padding="CIRCULAR",
                                          torch=(1, "circular"))), (6, 6, 4)),
    "torch_conv3d": ((_conv(features=3, kernel_size=(2, 2, 2), padding="VALID",
                            torch=("valid", "zeros")), ("tanh",), ("mean",), ("dense", C)),
                     (3, 4, 3, 2)),
}


def _flax_layers(layers):
    """The flax model's layer list: the torch-only key dropped."""
    return tuple(("conv", tuple((k, v) for k, v in a[0] if k != "torch")) if op == "conv"
                 else (op, *a) for op, *a in layers)


def pair(name, seed=0):
    """(JAX NNModel, torch twin, X, y) with the flax model's float64 weights
    (plus noise, so no norm is the identity) in both."""
    layers, shape = MODELS[name]
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N,) + shape)
    y = rng.integers(0, C, N)
    fm = FlaxNet(_flax_layers(layers))
    variables = fm.init(jax.random.key(seed), jnp.asarray(X))
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) + 0.1 * rng.standard_normal(np.shape(a)), variables)
    tm = TorchNet(layers, shape[-1]).double()
    with torch.no_grad():
        tm(torch.as_tensor(X))  # sizes the lazy Dense
    tm.load_state_dict(state_dict_from_flax(variables, tm))
    return JaxNNModel.from_flax(fm, variables), tm, X, y
