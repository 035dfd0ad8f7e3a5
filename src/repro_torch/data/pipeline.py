"""Minimal deterministic batch pipeline (host-side numpy, device-fed): the
JAX package's ``data/pipeline.py``, the same batches for the same seed."""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

__all__ = ["batch_iterator", "epoch_batches"]


def epoch_batches(
    xs: np.ndarray, ys: np.ndarray, batch_size: int, rng: np.random.Generator
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """One shuffled pass; drops the ragged tail (every batch one shape)."""
    order = rng.permutation(len(xs))
    for start in range(0, len(xs) - batch_size + 1, batch_size):
        sel = order[start : start + batch_size]
        yield xs[sel], ys[sel]


def batch_iterator(
    xs: np.ndarray, ys: np.ndarray, batch_size: int, seed: int = 0
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless shuffled batches (re-shuffled every epoch)."""
    rng = np.random.default_rng(seed)
    while True:
        yield from epoch_batches(xs, ys, batch_size, rng)
