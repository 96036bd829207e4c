"""Weights and inputs from the seed, made on the device in a few large calls.

Each purpose draws from a stream of its own (`stream_seed`), so the fit
inputs do not move when the weights' count changes. The same seed gives
the same weights and inputs on the same device type.
"""

from __future__ import annotations

import importlib
import math
import zlib

import numpy as np
import torch


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one purpose, from the run's seed (any whole
    number) and the purpose's name."""
    ss = np.random.SeedSequence([seed % 2**64, zlib.crc32(stream.encode())])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def weight_specs(config: dict) -> list:
    """(name, shape, how) of every tensor of the model, from the layer
    table; `how` is ("normal", std), ("one_plus", std) or ("exp", std)."""
    draw = config["weight_draw"]
    out = []
    for e in config["layers"]:
        n = e["name"]
        if e["kind"] == "conv":
            fan_in = e["c_in"] * e["k"] ** 2
            out.append((f"{n}.weight", (e["c_out"], e["c_in"], e["k"], e["k"]),
                        ("normal", math.sqrt(e["init"] / fan_in))))
        elif e["kind"] == "dense":
            out.append((f"{n}.weight", (e["c_out"], e["c_in"]),
                        ("normal", math.sqrt(e["init"] / e["c_in"]))))
        elif e["kind"] == "batchnorm":
            f = (e["features"],)
            out += [(f"{n}.scale", f, ("one_plus", draw["norm_scale_std"])),
                    (f"{n}.bias", f, ("normal", draw["norm_bias_std"])),
                    (f"{n}.mean", f, ("normal", draw["norm_mean_std"])),
                    (f"{n}.var", f, ("exp", draw["norm_log_var_std"]))]
            continue
        else:
            raise ValueError(f"Unknown layer kind {e['kind']!r} in {n}.")
        if e.get("bias"):
            out.append((f"{n}.bias", (e["c_out"],), ("normal", draw["bias_std"])))
    return out


def make_weights(config: dict, seed: int, device, dtype=torch.float32) -> dict:
    """{name: tensor}: one standard normal draw for every entry, shaped
    and scaled per tensor."""
    specs = weight_specs(config)
    total = sum(math.prod(shape) for _, shape, _ in specs)
    z = torch.randn(total, generator=generator(seed, "weights", device), device=device,
                    dtype=dtype)
    out, at = {}, 0
    for name, shape, (how, std) in specs:
        n = math.prod(shape)
        t = z[at:at + n].reshape(shape) * std
        out[name] = t.add_(1.0) if how == "one_plus" else t.exp_() if how == "exp" else t
        at += n
    return out


def make_inputs(config: dict, n: int, seed: int, stream: str, device):
    """n CIFAR-shaped standard normal images (n, *input_shape) and uniform
    labels (n,), drawn on `device`."""
    g = generator(seed, stream, device)
    X = torch.randn((n, *config["input_shape"]), generator=g, device=device)
    y = torch.randint(0, config["num_classes"], (n,), generator=g, device=device)
    return X, y


def build_model(config: dict, weights: dict, device) -> torch.nn.Module:
    """The program's model class named by the configuration, built without
    drawing its own weights, holding `weights`."""
    module, cls = config["model"].rsplit(".", 1)
    make = getattr(importlib.import_module(module), cls)
    with torch.device("meta"):
        net = make(**config["model_kwargs"])
    net = net.to_empty(device=device)
    net.load_state_dict(weights, strict=True)
    return net.eval() if config.get("eval") else net
