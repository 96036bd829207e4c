"""In-memory batch loader (port of `laplace_jax/utils/data.py`).

Batches are numpy arrays (or dicts of them); the Laplace classes move each
one to their device. With `shuffle`, epoch e draws its order from
`np.random.default_rng(seed + e)`, as the JAX package's loader does, so both
packages see the same batches in the same order.
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping, Sequence

import numpy as np


class ArrayLoader:
    """Re-iterable batches of in-memory arrays (or dicts of arrays).

    `x` is an array (N, ...) or a mapping of such arrays; `y` an array, or
    None when `x` is a mapping that holds the labels (batches are then the
    dicts alone). With `shuffle`, every pass re-shuffles with the seed
    `seed + epoch`.
    """

    def __init__(self, x, y=None, batch_size: int = 128, shuffle: bool = False,
                 seed: int = 0):
        self.x = x
        self.y = y
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0
        self.n_data = len(next(iter(x.values()))) if isinstance(x, Mapping) else len(x)

    def __len__(self) -> int:
        return (self.n_data + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator:
        idx = np.arange(self.n_data)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
            self._epoch += 1
        for start in range(0, self.n_data, self.batch_size):
            sel = idx[start : start + self.batch_size]
            xb = self._take(self.x, sel)
            if self.y is None:
                yield xb
            else:
                yield xb, self.y[sel]

    @staticmethod
    def _take(x, sel):
        if isinstance(x, Mapping):
            return {k: v[sel] for k, v in x.items()}
        return x[sel]

    def subset(self, indices: np.ndarray) -> "ArrayLoader":
        """An unshuffled loader over a fixed index subset."""
        x = self._take(self.x, indices)
        y = None if self.y is None else self.y[indices]
        return ArrayLoader(x, y, batch_size=self.batch_size, shuffle=False)


def loader_batches(loader) -> Iterator[tuple[Any, Any]]:
    """A loader's batches as (x, y) pairs; a batch that is not a pair (a
    dict batch) comes as (batch, None)."""
    for data in loader:
        if isinstance(data, Sequence) and not isinstance(data, Mapping) and len(data) == 2:
            yield data[0], data[1]
        else:
            yield data, None


def dataset_size(loader) -> int:
    """`len(loader.dataset)` parity for generic loaders."""
    if hasattr(loader, "n_data"):
        return int(loader.n_data)
    if hasattr(loader, "dataset"):
        return len(loader.dataset)
    raise ValueError(
        "Loader must expose `.n_data` (ArrayLoader) or `.dataset` to determine N."
    )
