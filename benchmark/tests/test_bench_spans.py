"""The per-layer metrics that read the program's own spans and counters
(`benchmark/program_spans.py`): each cell run traced at its tiny size on
the CPU reads a finite number for each, or nothing exactly where the CPU
has no such work (no stack takes the two-stage solver, no card to wait
for)."""

from __future__ import annotations

import math
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import tiny  # noqa: E402

# metric -> whether a CPU run reads it
READ_ON_CPU = {
    "resnet18-cifar10.kron-fit-n512": {
        "sweeps_s": True, "grams_s": True, "eigh_small_s": True, "symeig_retries": True,
        "stage1_s": False, "stage2_s": False, "stage2_merges_s": False,
        "back_transform_s": False, "decompose_syncs": False},
    "wrn16-4-cifar10.ll-probit-b512": {"forward_ms": True, "posterior_ms": True},
}


@pytest.mark.parametrize("cell", sorted(READ_ON_CPU))
def test_span_metrics_read_where_the_work_is(cell):
    from laplace_jax_torch.utils import spans

    spans.reset()
    r = tiny.run_tiny(cell, seconds=0.2, trace=True)
    assert r["correct"]
    for name, read in READ_ON_CPU[cell].items():
        if read:
            value = r["metrics"][name]["value"]
            assert math.isfinite(value) and value >= 0, (name, value)
        else:
            assert name not in r["metrics"], name
    if cell.startswith("resnet18"):
        assert r["metrics"]["symeig_retries"]["value"] == 0
        parts = sum(r["metrics"][k]["value"] for k in ("sweeps_s", "grams_s"))
        assert parts <= r["metrics"]["accumulate_s"]["value"]
    spans.reset()
