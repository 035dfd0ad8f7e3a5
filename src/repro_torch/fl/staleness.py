"""Bounded-staleness aggregation primitives.

The synchronous sharded round is a hard barrier: its one all-reduce waits
for every rank, so one straggler sets the round's wall clock.  Bounded
staleness relaxes exactly that: a shard that misses the round's deadline
keeps contributing, but its partial weighted sums are computed against the
params of round ``t − s_d`` (its staleness ``s_d``, capped at
``FLConfig.staleness_bound``) and enter the same single all-reduce scaled
by a staleness-decay weight ``λ(s_d)``.

The pieces the engine composes, as in the JAX package's module:

* the ring buffer: the last ``s + 1`` param snapshots as one tree whose
  leaves lead with ``(s + 1, ...)``; slot ``t mod (s + 1)`` holds the
  round-``t`` params (:func:`init_param_hist`, :func:`update_param_hist`,
  :func:`read_slots`);
* the per-shard int32 counters and their bounded-lag dynamics
  (:func:`staleness_step`): a shard that beats the deadline syncs
  (``s_d ← 0``), one that misses falls behind (``s_d ← s_d + 1``) until the
  bound forces a blocking sync (``s_d ← 0``, the round waits for it);
* the decay families (:data:`DECAY_FAMILIES`), ``λ(0) = 1`` for each, so
  ``staleness_bound = 0`` is the synchronous round bit for bit; the
  all-reduced ``Σ λ·w`` denominator normalises them
  (:func:`normalized_decay_weights` is the explicit form);
* the simulated wall clock of a round (:func:`round_sim_time`).
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core import metrics as metrics_lib
from repro_torch.tree import tree_leaves, tree_map

__all__ = [
    "DECAY_FAMILIES",
    "decay_weights",
    "normalized_decay_weights",
    "init_param_hist",
    "init_staleness_fields",
    "update_param_hist",
    "read_slots",
    "staleness_step",
    "round_sim_time",
]

Params = Any  # a tree of tensors

# λ(s), each with λ(0) = 1 and non-increasing:
#   constant     λ(s) = 1                 (plain stale FedAvg)
#   polynomial   λ(s) = (1 + s)^{-α}
#   exponential  λ(s) = exp(-α·s)
DECAY_FAMILIES = ("constant", "polynomial", "exponential")


def decay_weights(staleness: torch.Tensor, family: str, alpha: float) -> torch.Tensor:
    """λ(s) per entry of ``staleness`` (an int tensor), fp32, unnormalised.
    Strictly positive, so a weight-0 client (outside the cohort) stays at
    weight 0 after the rescale."""
    s = torch.as_tensor(staleness).float()
    if family == "constant":
        return torch.ones_like(s)
    if family == "polynomial":
        return (1.0 + s) ** torch.full((), -alpha, dtype=torch.float32, device=s.device)
    if family == "exponential":
        return torch.exp(torch.full((), -alpha, dtype=torch.float32, device=s.device) * s)
    raise ValueError(f"unknown staleness decay family {family!r}; known: {DECAY_FAMILIES}")


def normalized_decay_weights(staleness: torch.Tensor, family: str, alpha: float) -> torch.Tensor:
    """λ(s) normalised to a distribution by ``safe_div``: non-negative and
    summing to 1 for any non-empty staleness vector."""
    lam = decay_weights(staleness, family, alpha)
    return metrics_lib.safe_div(lam, torch.sum(lam))


# -------------------------------------------------------------- ring buffer


def init_param_hist(params: Params, bound: int) -> Params:
    """The ring of ``bound + 1`` snapshots, every slot ``params`` (at round
    0 every reachable staleness reads θ₀)."""
    n = bound + 1
    return tree_map(lambda x: x.detach().unsqueeze(0).repeat((n,) + (1,) * x.ndim), params)


def init_staleness_fields(params: Params, bound: int, mesh) -> Tuple[Params, torch.Tensor]:
    """``(param_hist, shard_staleness)`` for a ServerState: the ring with
    every slot at ``params`` and the (D,) lag counters at 0, on the params'
    device.  Staleness is a property of a shard, so a mesh is needed."""
    if mesh is None:
        raise ValueError(
            f"staleness_bound={bound} requires a client mesh (pass mesh=...; "
            "launchers: --staleness-bound needs --shard-clients)"
        )
    dev = tree_leaves(params)[0].device
    return init_param_hist(params, bound), torch.zeros((mesh.size,), dtype=torch.int32, device=dev)


def update_param_hist(hist: Params, params: Params, round_t: int, bound: int) -> Params:
    """The ring with the round-``round_t`` params written into their slot
    (a new tree; ``hist`` is left as it was)."""
    slot = int(round_t) % (bound + 1)

    def leaf(h, p):
        out = h.clone()
        out[slot] = p.to(h.dtype)
        return out

    return tree_map(leaf, hist, params)


def read_slots(round_t: int, staleness: torch.Tensor, bound: int) -> torch.Tensor:
    """The ring slot holding the round-``t − s_d`` params, per shard.  The
    counters satisfy ``s_d ≤ min(t + 1, bound)``, so the read stays in the
    window the ring holds (the ``t = 0``, ``s_d = 1`` corner lands on a slot
    still holding θ₀)."""
    return torch.remainder(int(round_t) - staleness.long(), bound + 1).to(torch.int32)


# ----------------------------------------------------------------- dynamics


def staleness_step(staleness: torch.Tensor, slow: torch.Tensor, bound: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One round of the bounded-lag counters -> ``(new_staleness,
    forced)``.  ``slow`` marks the shards that missed the deadline: fast
    shards sync to 0, slow ones fall one round further behind, and one whose
    counter would pass ``bound`` is forced (the round blocks on it) and
    re-syncs to 0.  With ``bound = 0`` every slow shard is forced: the
    synchronous barrier.  The engine prices a round's contribution on the
    counters returned here, so a shard that misses delivers work based on
    pre-miss params."""
    s = torch.as_tensor(staleness).to(torch.int32)
    bumped = torch.where(slow, s + 1, torch.zeros_like(s))
    forced = bumped > bound
    return torch.where(forced, torch.zeros_like(bumped), bumped).to(torch.int32), forced


def round_sim_time(shard_lat: torch.Tensor, slow: torch.Tensor, forced: torch.Tensor, deadline: float) -> torch.Tensor:
    """The simulated wall clock of a bounded-staleness round: fast shards
    finish at their latency, slow unforced ones are cut off at the
    ``deadline`` (their work lands in a later round), forced ones block the
    round at their full latency; the round closes at the maximum.  With
    ``bound = 0`` this is the synchronous ``max(latency)``."""
    dl = torch.full((), deadline, dtype=torch.float32, device=shard_lat.device)
    per_shard = torch.where(slow, torch.where(forced, shard_lat, dl), shard_lat)
    return torch.amax(per_shard)
