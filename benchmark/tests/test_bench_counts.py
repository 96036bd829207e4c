"""The frozen counts worked by hand on single layers and small stacks."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import counts, harness  # noqa: E402

RESNET = harness.load_config("resnet18-cifar10")


def layer(name):
    return next(e for e in RESNET["layers"] if e["name"] == name)


def test_one_conv_by_hand():
    """ResidualBlock_2.Conv_0: 3x3, 64 -> 128, stride 2 on 32x32, so 16x16
    outputs: 256 positions, patches of 9 * 64 = 576."""
    e = layer("ResidualBlock_2.Conv_0")
    assert counts.positions(e) == 256 and counts.a_dim(e) == 576
    config = {"layers": [e], "num_classes": 10}
    assert counts.forward_flops(config) == 2 * 576 * 128 * 256 == 37_748_736
    # the only layer reads the input: its sweep needs no input gradient
    assert counts.sweep_flops(config) == 0
    # one fit of 4 inputs: forward, A Gram over 4 * 256 rows of 576, ten B
    # Grams over 4 * 256 rows of 128, the two factors' eigendecompositions
    want = (4 * 37_748_736 + 1024 * 576 * 577 + 10 * 1024 * 128 * 129
            + (4 / 3 + 2) * (576 ** 3 + 128 ** 3))
    assert counts.kfac_fit_flops(config, 4) == pytest.approx(want, rel=1e-12)


def test_dense_head_by_hand():
    e = layer("Dense_0")
    assert counts.positions(e) == 1 and counts.a_dim(e) == 512
    config = {"layers": [layer("Conv_0"), e], "num_classes": 10}
    assert counts.sweep_flops(config) == 2 * 512 * 10
    assert counts.ll_variance_flops(config) == 2 * 512 * 512 + 2 * 512 * 10 + 2 * 10 * 10


def test_resnet18_totals():
    assert counts.forward_flops(RESNET) == pytest.approx(1.11084544e9, rel=1e-9)
    assert counts.factor_classes(RESNET) == {10: 2, 27: 1, 64: 6, 128: 6, 256: 6, 512: 6,
                                             576: 5, 1152: 4, 2304: 4, 4608: 3}


def test_stage1_least_time_by_hand():
    """(K, n) = (2, 4): columns 0 and 1 multiply 3x3 and 2x2 trailing
    matrices, 2 * (9 + 4) FLOPs a matrix; bytes: 16 read, 6 + 12 written."""
    t, bound = counts.stage1_least_seconds(2, 4)
    flops, nbytes = 2 * 2 * (9 + 4), 2 * 4 * (16 + 6 + 12)
    assert t == pytest.approx(max(flops / 67e12, nbytes / 3.35e12), rel=1e-12)
    assert bound == "bytes"
    t, bound = counts.stage1_least_seconds(3, 4608)
    assert bound == "operations"
    assert t == pytest.approx(3 * 2 / 3 * 4608 ** 3 / 67e12, rel=1e-3)
