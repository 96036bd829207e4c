"""Layer tables of the two model families at any width and input size,
and the overrides that rehearse a cell on the CPU at a tiny size."""

from __future__ import annotations


def resnet_layers(width: int = 64, hw: int = 32, classes: int = 10, blocks=(2, 2, 2, 2)) -> list:
    """The layer table of `models.resnet.ResNet` (CIFAR stem, basic blocks)."""
    layers = [dict(name="Conv_0", kind="conv", c_in=3, c_out=width, k=3, stride=1, hw=hw,
                   bias=False, init=2.0)]
    c_in, b = width, 0
    for i, n in enumerate(blocks):
        for j in range(n):
            s = 2 if (i > 0 and j == 0) else 1
            ch, p, hw2 = width * 2 ** i, f"ResidualBlock_{b}", -(-hw // s)
            layers += [dict(name=f"{p}.Conv_0", kind="conv", c_in=c_in, c_out=ch, k=3, stride=s,
                            hw=hw, bias=False, init=2.0),
                       dict(name=f"{p}.Conv_1", kind="conv", c_in=ch, c_out=ch, k=3, stride=1,
                            hw=hw2, bias=False, init=0.1)]
            if s != 1 or c_in != ch:
                layers.append(dict(name=f"{p}.Conv_2", kind="conv", c_in=c_in, c_out=ch, k=1,
                                   stride=s, hw=hw, bias=False, init=1.0))
            c_in, hw, b = ch, hw2, b + 1
    layers.append(dict(name="Dense_0", kind="dense", c_in=c_in, c_out=classes, bias=True,
                       init=1.0))
    return layers


def wrn_layers(widen: int = 4, hw: int = 32, classes: int = 10) -> list:
    """The layer table of `models.wideresnet.WideResNet16x4(norm="batch")`."""
    layers = [dict(name="Conv_0", kind="conv", c_in=3, c_out=16, k=3, stride=1, hw=hw,
                   bias=False, init=1.0),
              dict(name="BatchNorm_0", kind="batchnorm", features=16, hw=hw, eps=1e-5)]
    c_in, b = 16, 0
    for i, ch in enumerate((16 * widen, 32 * widen, 64 * widen)):
        for j in range(2):
            s = 2 if (i > 0 and j == 0) else 1
            p, hw2 = f"WideBlock_{b}", -(-hw // s)
            layers += [dict(name=f"{p}.Conv_0", kind="conv", c_in=c_in, c_out=ch, k=3, stride=s,
                            hw=hw, bias=True, init=2.0),
                       dict(name=f"{p}.BatchNorm_0", kind="batchnorm", features=ch, hw=hw2,
                            eps=1e-5),
                       dict(name=f"{p}.Conv_1", kind="conv", c_in=ch, c_out=ch, k=3, stride=1,
                            hw=hw2, bias=True, init=0.1),
                       dict(name=f"{p}.BatchNorm_1", kind="batchnorm", features=ch, hw=hw2,
                            eps=1e-5)]
            if s != 1 or c_in != ch:
                layers.append(dict(name=f"{p}.Conv_2", kind="conv", c_in=c_in, c_out=ch, k=1,
                                   stride=s, hw=hw, bias=False, init=1.0))
            c_in, hw, b = ch, hw2, b + 1
    layers.append(dict(name="Dense_0", kind="dense", c_in=c_in, c_out=classes, bias=True,
                       init=1.0))
    return layers


# the cells at a size a CPU test holds: (config, traffic) overrides; the
# limits are the cells' own
TINY = {
    "resnet18-cifar10.kron-fit-n512": (
        {"model_kwargs": {"num_classes": 10, "width": 4}, "input_shape": [8, 8, 3],
         "layers": resnet_layers(4, 8)},
        {"n_per_fit": 16, "batch_size": 8, "input_sets": 3, "check_fits": 2,
         "reference_batch": 8, "trace_fits": 1}),
    "wrn16-4-cifar10.ll-probit-b512": (
        {"model_kwargs": {"num_classes": 10, "widen_factor": 1, "norm": "batch"},
         "input_shape": [8, 8, 3], "layers": wrn_layers(1, 8)},
        {"fit_n": 32, "fit_batch": 8, "tune": {"method": "marglik", "n_steps": 20, "lr": 0.1},
         "test_n": 20, "batch_size": 8, "check_calls": 3, "reference_batch": 8,
         "trace_sweeps": 1}),
}


def run_tiny(cell: str, seed: int = 7, seconds: float = 0.0, trace: bool = False,
             device="cpu", **kw):
    """One run of `cell` at its tiny size (float32, as timed), by default on
    the CPU."""
    from benchmark import harness

    config, traffic = TINY[cell]
    return harness.run_cell(cell, seed, seconds, trace, device=device, config_override=config,
                            traffic_override=traffic, **kw)
