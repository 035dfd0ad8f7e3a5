"""Plain PyTorch versions of K1 (``ops.pairwise_dists_stats``) and K3
(``ops.pairwise_sq_dists``)."""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["pairwise_dists_stats_ref", "pairwise_sq_dists_ref"]


def pairwise_sq_dists_ref(f: torch.Tensor) -> torch.Tensor:
    """F (C, Q) -> D2 (C, C) fp32: expansion distances ``‖a‖² + ‖b‖² − 2a·b``
    in fp32, clamped at 0, diagonal pinned to 0."""
    f = f.float()
    sq = torch.sum(f * f, dim=-1)
    d2 = torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * (f @ f.T), 0.0)
    eye = torch.eye(f.shape[0], dtype=torch.bool, device=f.device)
    return torch.where(eye, 0.0, d2)


def pairwise_dists_stats_ref(f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """F (C, Q) -> (S0 (C, C), lo, hi), all fp32: the square root of
    :func:`pairwise_sq_dists_ref`, and the extrema of S0."""
    s0 = torch.sqrt(pairwise_sq_dists_ref(f))
    return s0, torch.amin(s0), torch.amax(s0)
