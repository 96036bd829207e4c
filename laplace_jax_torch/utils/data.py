"""In-memory batch loader (port of `laplace_jax/utils/data.py`).

Batches are numpy arrays; the Laplace classes move each one to their device.
"""

from __future__ import annotations

from typing import Iterator


class ArrayLoader:
    """Re-iterable batches `(x[i:i+b], y[i:i+b])` of in-memory arrays."""

    def __init__(self, x, y, batch_size: int = 128):
        self.x = x
        self.y = y
        self.batch_size = int(batch_size)
        self.n_data = len(x)

    def __len__(self) -> int:
        return (self.n_data + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator:
        for start in range(0, self.n_data, self.batch_size):
            stop = start + self.batch_size
            yield self.x[start:stop], self.y[start:stop]


def dataset_size(loader) -> int:
    """`len(loader.dataset)` parity for generic loaders."""
    if hasattr(loader, "n_data"):
        return int(loader.n_data)
    if hasattr(loader, "dataset"):
        return len(loader.dataset)
    raise ValueError(
        "Loader must expose `.n_data` (ArrayLoader) or `.dataset` to determine N."
    )
