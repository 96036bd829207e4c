"""Subset-of-data sampling for `FunctionalLaplace` (a copy of
`laplace_jax/utils/sod.py`): the same seeded numpy draw, so both packages
pick the same points."""

from __future__ import annotations

import numpy as np


def sod_indices(N: int, M: int, seed: int = 0) -> np.ndarray:
    """M indices sampled uniformly without replacement from range(N)."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.arange(N), size=M, replace=False)
