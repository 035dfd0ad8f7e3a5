"""Diversity / heterogeneity metrics.

GEMD (group earth mover's distance, paper eq. 15) quantifies how far the
label distribution of the selected cohort's *union* dataset is from the global
label distribution; lower = more diverse/representative cohort.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "safe_div",
    "finite_mean",
    "gemd",
    "label_distribution",
    "cohort_label_distribution",
]


def safe_div(num: torch.Tensor, den: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """``num / max(den, eps)`` — the weighted-sum denominator guard: an
    all-zero weight vector yields 0, never inf/NaN."""
    return num / torch.clamp_min(den, eps)


def finite_mean(x: torch.Tensor, where: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over the finite (optionally ``where``-masked) entries of ``x``;
    NaN (not 0) when nothing qualifies, so a dead round never reads as
    perfect convergence."""
    ok = torch.isfinite(x)
    if where is not None:
        ok = ok & where
    tot = torch.sum(torch.where(ok, x, torch.zeros((), dtype=x.dtype, device=x.device)))
    cnt = torch.sum(ok.float())
    return torch.where(cnt > 0, tot / torch.clamp_min(cnt, 1.0), torch.nan)


def label_distribution(ys: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Empirical label distribution P(y = j) of one dataset."""
    counts = torch.bincount(ys.long(), minlength=num_classes)
    return counts / torch.clamp_min(torch.sum(counts), 1)


def cohort_label_distribution(
    client_dists: torch.Tensor, client_sizes: torch.Tensor, selected: torch.Tensor
) -> torch.Tensor:
    """Size-weighted label distribution of the union of selected clients.

    ``client_dists``: (C, N) per-client label distributions P_c(y = j);
    ``client_sizes``: (C,) n_c; ``selected``: (k,) int indices.
    """
    n = client_sizes[selected].float()
    d = client_dists[selected]
    return safe_div((n[:, None] * d).sum(0), n.sum())


def gemd(
    client_dists: torch.Tensor,
    client_sizes: torch.Tensor,
    selected: torch.Tensor,
    global_dist: torch.Tensor,
) -> torch.Tensor:
    """Group earth mover's distance of a cohort (paper eq. 15).

    ``G(C_t) = Σ_j | Σ_c n_c P_c(j) / Σ_c n_c − P_g(j) |``
    """
    mix = cohort_label_distribution(client_dists, client_sizes, selected)
    return torch.sum(torch.abs(mix - global_dist))
