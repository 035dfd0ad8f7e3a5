"""Client data profiling (paper §3.1, Theorem 1).

Each client summarises its local dataset by the *mean vector of the FC-1
outputs* of the (shared, freshly initialised) global model — eq. (11):
``f_c = [u_1^c, …, u_Q^c]``, a distribution fingerprint uploaded once.

Models plug in via ``feature_fn(params, x) -> (logits, feats)`` where
``feats`` is the designated profile layer output (the paper CNN's FC-1
pre-activations).
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import numpy as np
import torch

__all__ = ["fc1_profile", "profile_all_clients"]

FeatureFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


@torch.no_grad()
def fc1_profile(
    feature_fn: FeatureFn, params, xs: torch.Tensor, batch_size: int = 256
) -> torch.Tensor:
    """Mean FC-1 output over a client's local dataset (eq. 11), streamed in
    fixed-size batches.

    A client with an **empty** local dataset (n = 0) gets the zero profile of
    width Q — probed with an empty forward batch so the width matches every
    populated client's row.  (Zero is the neutral element of the eq.-(14)
    pipeline and keeps the kernel finite.)
    """
    n = xs.shape[0]
    if n == 0:
        _, feats = feature_fn(params, xs[:0])
        width = int(np.prod(feats.shape[1:]))
        return torch.zeros((width,), dtype=feats.dtype, device=feats.device)
    total = None
    for start in range(0, n, batch_size):
        _, feats = feature_fn(params, xs[start : start + batch_size])
        s = torch.sum(feats.reshape(feats.shape[0], -1), dim=0)
        total = s if total is None else total + s
    return total / n


def profile_all_clients(
    feature_fn: FeatureFn, params, client_data: Iterable[torch.Tensor], batch_size: int = 256
) -> torch.Tensor:
    """Stack eq.-(11) profiles for every client: -> (C, Q)."""
    rows = [fc1_profile(feature_fn, params, xs, batch_size=batch_size) for xs in client_data]
    return torch.stack(rows, dim=0)
