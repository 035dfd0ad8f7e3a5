"""Non-IID partitioner (paper §4 protocol) — the port's own copy of
``repro/data/partition.py`` (``skewness_partition`` and its helpers),
verbatim, so that the same seed gives the same shards.

``skewness_partition`` implements the paper's ξ protocol exactly:

* ξ = 1   — every sample of a client belongs to one (dominant) class;
* ξ = 0.8 — 80% dominant class, 20% uniformly from the other classes;
* ξ = 0.5 — 50% / 50%;
* ξ = 'H' — evenly split between exactly two classes.

Clients have uniform dataset sizes (paper: "clients' local datasets are of a
uniform size").  Dominant classes rotate round-robin so the global
distribution stays balanced.
"""

from __future__ import annotations

from typing import List, Union

import numpy as np

__all__ = ["skewness_partition"]


def _pools(ys: np.ndarray, num_classes: int, rng: np.random.Generator) -> List[np.ndarray]:
    pools = []
    for j in range(num_classes):
        idx = np.nonzero(ys == j)[0]
        rng.shuffle(idx)
        pools.append(list(idx))
    return pools


def _draw(pools, cls, count, rng, num_classes):
    """Draw ``count`` sample indices of class ``cls`` (with refill fallback)."""
    out = []
    for _ in range(count):
        if not pools[cls]:
            # pool exhausted -> steal from the globally largest pool
            cls = int(np.argmax([len(p) for p in pools]))
        out.append(pools[cls].pop())
    return out


def skewness_partition(
    ys: np.ndarray,
    num_clients: int,
    xi: Union[float, str],
    num_classes: int,
    samples_per_client: int | None = None,
    seed: int = 0,
) -> List[np.ndarray]:
    """Partition sample indices into ``num_clients`` ξ-skewed shards."""
    rng = np.random.default_rng(seed)
    n = len(ys)
    spc = samples_per_client or n // num_clients
    pools = _pools(ys, num_classes, rng)
    shards = []
    for c in range(num_clients):
        dom = c % num_classes
        if xi == "H" or xi == "h":
            second = (dom + 1 + c // num_classes) % num_classes
            idx = _draw(pools, dom, spc // 2, rng, num_classes) + _draw(
                pools, second, spc - spc // 2, rng, num_classes
            )
        else:
            xi_f = float(xi)
            n_dom = int(round(xi_f * spc))
            idx = _draw(pools, dom, n_dom, rng, num_classes)
            others = [j for j in range(num_classes) if j != dom]
            for i in range(spc - n_dom):
                idx += _draw(pools, others[i % len(others)], 1, rng, num_classes)
        arr = np.asarray(idx, np.int64)
        rng.shuffle(arr)
        shards.append(arr)
    return shards
