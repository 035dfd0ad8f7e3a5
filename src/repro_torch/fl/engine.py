"""The federation protocol's configuration and the per-round batch plan.

``FLConfig`` keeps every field of the JAX package's config, so a config
reads the same in both packages.  One default differs: ``use_pallas_kernel``
is True here, so a config left as it is builds the eq.-(14) kernel through
the port's K1 + K2 on the card.  ``__post_init__`` refuses the fields whose
features this package does not run yet (mesh slots, staleness, scenarios,
the funnel, faults and robust aggregation, checkpoints, non-FedAvg local
algorithms, telemetry).  The scanned engine itself is not ported: the
rounds run in ``FLTrainer``'s host loop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = [
    "FLConfig",
    "batch_indices_from_keys",
    "batches_from_indices",
    "make_client_batches",
]


@dataclasses.dataclass
class FLConfig:
    """Federation protocol configuration (field names as in the JAX package)."""

    num_clients: int = 100
    clients_per_round: int = 10
    local_epochs: int = 2  # E in eq. (3)
    local_batch_size: Optional[int] = None  # None = full-batch GD (paper eq. 4)
    lr: float = 0.05
    rounds: int = 100
    eval_every: int = 5
    num_classes: int = 10
    seed: int = 0
    reprofile_every: Optional[int] = None  # beyond-paper: refresh profiles
    # eq.-(14) kernel through K1 + K2 (their plain versions for CPU tensors);
    # False builds it with the stage-wise op chain instead
    use_pallas_kernel: bool = True
    grad_clip: Optional[float] = None  # stabilises late-round full-batch SGD
    local_steps: Optional[int] = None  # explicit steps/round (token workloads)
    sample_with_replacement: bool = False  # iid batch draws instead of perms
    cohort_cap: Optional[int] = None
    staleness_bound: Optional[int] = None
    staleness_decay: str = "polynomial"
    staleness_alpha: float = 0.5
    scenario: Optional[str] = None
    candidate_frac: Optional[float] = None
    faults: Optional[str] = None
    aggregator: str = "mean"
    robust_norm_mult: float = 3.0
    min_survivors: int = 1
    quarantine_rounds: int = 5
    ckpt_every: Optional[int] = None
    local_algo: str = "fedavg"
    prox_mu: Optional[float] = None
    feddyn_alpha: Optional[float] = None
    telemetry: bool = False

    def __post_init__(self):
        not_ported = {
            "cohort_cap": self.cohort_cap is not None,
            "staleness_bound": self.staleness_bound is not None,
            "scenario": self.scenario is not None,
            "candidate_frac": self.candidate_frac is not None,
            "faults": self.faults is not None,
            "aggregator": self.aggregator != "mean",
            "ckpt_every": self.ckpt_every is not None,
            "local_algo": self.local_algo != "fedavg",
            "prox_mu": self.prox_mu is not None,
            "feddyn_alpha": self.feddyn_alpha is not None,
            "telemetry": self.telemetry,
        }
        fields = [name for name, used in not_ported.items() if used]
        if fields:
            raise NotImplementedError(
                f"FLConfig fields {fields} select features that are not yet ported"
            )
        if self.local_batch_size is not None and self.local_batch_size < 1:
            raise ValueError(f"local_batch_size={self.local_batch_size} must be >= 1")


# ----------------------------------------------------------------- batches


def _num_batches(n_c: int, batch_size: int) -> int:
    """Minibatches per local epoch: ``max(1, n_c // b)`` (drop-remainder, at
    least one batch).  The one definition shared by :func:`_steps_per_round`
    and :func:`batches_from_indices`."""
    return max(1, n_c // batch_size)


def _steps_per_round(cfg: FLConfig, n_c: int) -> int:
    if cfg.local_steps is not None:
        return cfg.local_steps
    if cfg.local_batch_size is None:
        return cfg.local_epochs  # E full-batch passes (paper eq. 4)
    return cfg.local_epochs * _num_batches(n_c, cfg.local_batch_size)


def batch_indices_from_keys(
    cfg: FLConfig, generator: torch.Generator, m: int, n_c: int
) -> Optional[torch.Tensor]:
    """Per-client random *index plans* for ``m`` clients, drawn from
    ``generator``: ``None`` for full-batch mode (no randomness), the
    (m, steps, B) replacement draws, or the (m, n_c) epoch permutations."""
    if cfg.local_batch_size is None:
        return None
    device = generator.device
    if cfg.sample_with_replacement:
        steps = _steps_per_round(cfg, n_c)
        return torch.randint(
            0, n_c, (m, steps, cfg.local_batch_size), generator=generator, device=device
        )
    return torch.stack(
        [torch.randperm(n_c, generator=generator, device=device) for _ in range(m)]
    )


def batches_from_indices(cfg: FLConfig, ids: Optional[torch.Tensor], xs, ys):
    """Apply :func:`batch_indices_from_keys` plans to M clients' data ->
    ``(xb, yb)`` with leading shape (M, steps, B)."""
    n_c = xs.shape[1]
    steps = _steps_per_round(cfg, n_c)
    if cfg.local_batch_size is None:
        # full-batch: each local step sees the whole local dataset (a view)
        xb = xs[:, None].expand((xs.shape[0], steps) + xs.shape[1:])
        yb = ys[:, None].expand((ys.shape[0], steps) + ys.shape[1:])
        return (xb, yb)
    if cfg.sample_with_replacement:
        rows = torch.arange(xs.shape[0], device=xs.device)[:, None, None]
        return (xs[rows, ids], ys[rows, ids])
    # clamp to the local dataset: n_c < b means ONE short full batch (the
    # same count _num_batches floors to), not an impossible (nb, b) reshape
    b = min(cfg.local_batch_size, n_c)
    nb = _num_batches(n_c, b)
    rows = torch.arange(xs.shape[0], device=xs.device)[:, None]
    xs, ys = xs[rows, ids], ys[rows, ids]
    xb = xs[:, : nb * b].reshape(xs.shape[0], nb, b, *xs.shape[2:])
    yb = ys[:, : nb * b].reshape(ys.shape[0], nb, b)
    reps = cfg.local_epochs
    xb = xb.repeat((1, reps) + (1,) * (xb.ndim - 2))
    yb = yb.repeat(1, reps, 1)
    return (xb, yb)


def make_client_batches(cfg: FLConfig, generator: torch.Generator, client_xs, client_ys, sel):
    """Slice the selected clients' data into (C_p, steps, B, ...) batches."""
    sel = sel.long()
    xs = client_xs[sel]
    ys = client_ys[sel]
    return batches_from_indices(
        cfg, batch_indices_from_keys(cfg, generator, xs.shape[0], xs.shape[1]), xs, ys
    )
