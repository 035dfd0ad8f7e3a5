"""Plain PyTorch versions of K4, K2 and the two-launch pipeline."""

from __future__ import annotations

import torch

from repro_torch.kernels.pairwise_l2.ref import pairwise_dists_stats_ref

__all__ = ["gram_ref", "normalized_gram_ref", "kernel_from_profiles_ref"]


def gram_ref(x: torch.Tensor) -> torch.Tensor:
    """X (M, N) -> ``XᵀX`` (N, N), upcast to fp32 and multiplied in fp32."""
    x = x.float()
    return x.T @ x


def normalized_gram_ref(
    s0: torch.Tensor,
    lo: torch.Tensor,
    rng: torch.Tensor,
    c: int,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """S0 (P, P), P >= c -> L = SᵀS (c, c) fp32 with S = 1 − (S0 − lo)/rng
    over the leading c x c block; S is rounded to ``compute_dtype`` before
    the product, which is taken in fp32."""
    s = 1.0 - (s0[:c, :c] - lo) / rng
    s = s.to(compute_dtype).float()
    return s.T @ s


def kernel_from_profiles_ref(f: torch.Tensor) -> torch.Tensor:
    """The eq.-(14) chain as plain ops: distances → clamp → zero diagonal →
    sqrt → min-max normalise → ``L = SᵀS``."""
    s0, lo, hi = pairwise_dists_stats_ref(f)
    return normalized_gram_ref(s0, lo, torch.clamp_min(hi - lo, 1e-30), f.shape[0])
