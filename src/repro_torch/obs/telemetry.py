"""Per-round diagnostics that ride a federation round's outputs.

:func:`round_telemetry` is called at the tail of the engine's ``round_fn``
only when ``FLConfig.telemetry`` is set.  It reads values the round
already holds (the cohort's spectral cache, the guard's counters, the
availability mask) and draws from no generator and writes no state field,
so a run with telemetry leaves the same state and the same other outputs
as one without, bit for bit.  Its tensors stay on the round's device;
the segment's drain (:func:`repro_torch.obs.sink.drain_fl_outputs`) reads
them after the segment's last round.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch

__all__ = ["Telemetry", "round_telemetry"]


@dataclasses.dataclass(frozen=True)
class Telemetry:
    """One round's diagnostics (0-d tensors, stacked over a segment's
    rounds).  An optional field is None when its feature is off, so the
    JSONL schema carries only what the config can produce."""

    # -- selection ---------------------------------------------------------
    # the stage-1 candidate count Q (C without the funnel) and Q / C
    funnel_q: torch.Tensor  # int32
    funnel_survival: torch.Tensor  # float32, in (0, 1]
    # rounds since the last reprofile boundary: the age of the spectral
    # cache and candidate set the round drew from (0 right after one;
    # the round count less one without reprofile_every)
    cache_age: torch.Tensor  # int32
    # the DPP kernel's spectrum from the cached eigendecomposition (the
    # normalised eigenvalues; the identity placeholder's are all 1): top
    # eigenvalue, trace, and the participation-ratio rank (Σλ)² / Σλ²
    spectrum_top: torch.Tensor  # float32
    spectrum_trace: torch.Tensor  # float32
    spectrum_erank: torch.Tensor  # float32
    # -- robustness --------------------------------------------------------
    # without the guard: k survivors, nothing flagged or quarantined
    survivors: torch.Tensor  # int32, cohort updates the aggregate kept
    flagged: torch.Tensor  # int32, updates the guard rejected this round
    quarantined: torch.Tensor  # int32, clients in cooldown after the round
    identity_round: torch.Tensor  # int32 0/1, the survivors floor tripped
    # -- scenario ------------------------------------------------------------
    avail_frac: Optional[torch.Tensor] = None  # float32, mean availability
    # (staleness_bound + 1,) int32: the shards contributing at each lag
    staleness_hist: Optional[torch.Tensor] = None

    @staticmethod
    def combine(parts: List["Telemetry"], fn: Callable) -> "Telemetry":
        """``fn`` over the list of each field's values in ``parts`` (a
        stack or a concatenation), field by field; a None field stays None."""
        first = parts[0]
        return Telemetry(**{
            f.name: None if getattr(first, f.name) is None else fn([getattr(p, f.name) for p in parts])
            for f in dataclasses.fields(first)
        })


def round_telemetry(
    cfg,
    state,
    *,
    t: int,
    avail: Optional[torch.Tensor] = None,
    new_s: Optional[torch.Tensor] = None,
    flagged: Optional[torch.Tensor] = None,
    survivors: Optional[torch.Tensor] = None,
    quarantine: Optional[torch.Tensor] = None,
) -> Telemetry:
    """The round's :class:`Telemetry` from values already in scope.

    ``cfg`` and ``state`` are the engine's ``FLConfig`` and the
    ``ServerState`` the round started from; ``t`` the round's number
    (1-based); the keyword arguments are the availability mask, the
    shards' staleness counters after the round, the guard's per-client
    flags and survivor count, and the quarantine counters after the round,
    each None when its feature is off."""
    k, c = cfg.clients_per_round, cfg.num_clients
    q = cfg.candidate_count() if cfg.candidate_frac is not None else c
    lam = state.eig_state.lam.float()
    dev = lam.device

    def const(v, dtype=torch.int32):
        # a fill on the device: no host-to-device copy, so no synchronise
        return torch.full((), v, dtype=dtype, device=dev)

    trace = torch.sum(lam)
    sumsq = torch.clamp_min(torch.sum(lam * lam), 1e-30)
    age = (t - 1) % cfg.reprofile_every if cfg.reprofile_every else t - 1
    if survivors is None:
        surv, ident = const(k), const(0)
    else:
        surv, ident = survivors.to(torch.int32), (survivors < cfg.min_survivors).to(torch.int32)
    return Telemetry(
        funnel_q=const(q),
        funnel_survival=const(q / c, torch.float32),
        cache_age=const(age),
        spectrum_top=torch.amax(lam),
        spectrum_trace=trace,
        spectrum_erank=(trace * trace) / sumsq,
        survivors=surv,
        flagged=const(0) if flagged is None else torch.sum(flagged).to(torch.int32),
        quarantined=const(0) if quarantine is None else torch.sum(quarantine > 0).to(torch.int32),
        identity_round=ident,
        avail_frac=None if avail is None else torch.mean(avail.float()),
        # shards at each lag s in [0, bound], a fixed-width comparison
        staleness_hist=None if new_s is None else torch.sum(
            (new_s[None, :] == torch.arange(cfg.staleness_bound + 1, device=new_s.device)[:, None]).to(torch.int32),
            dim=1,
        ).to(torch.int32),
    )
