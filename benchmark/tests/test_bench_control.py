"""The control: the plain reference put in the program's place one
precision below the configurations' float32, TF32 on, at a size a test
holds. It must fail at least one of a cell's limits, where the program at
the same size passes them all. TF32 exists only on the card, so these
tests skip without one.

    python -m pytest benchmark/tests -m cuda -q
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import tiny  # noqa: E402


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's TF32 products exist only there")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(tiny.TINY))
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_fails_where_program_passes(card, cell, seed):
    result = tiny.run_tiny(cell, seed=seed, seconds=0.3, device=card, control=True)
    assert result["correct"], result["checks"]
    limits = {k: c["limit"] for k, c in result["checks"].items()}
    failed = [k for k, v in result["control_checks"].items() if not v <= limits[k]]
    assert failed, (result["control_checks"], limits)
