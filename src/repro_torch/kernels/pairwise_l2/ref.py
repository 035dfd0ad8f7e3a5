"""Plain PyTorch version of K1 (``ops.pairwise_dists_stats``)."""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["pairwise_dists_stats_ref"]


def pairwise_dists_stats_ref(f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """F (C, Q) -> (S0 (C, C), lo, hi), all fp32: expansion distances,
    clamped at 0, diagonal pinned to 0, square root, and the extrema of S0."""
    f = f.float()
    sq = torch.sum(f * f, dim=-1)
    d2 = torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * (f @ f.T), 0.0)
    eye = torch.eye(f.shape[0], dtype=torch.bool, device=f.device)
    s0 = torch.sqrt(torch.where(eye, 0.0, d2))
    return s0, torch.amin(s0), torch.amax(s0)
