"""The federation engine: configuration, batch plans, and the round
transition run as a host loop.

``FLConfig`` keeps every field of the JAX package's config, so a config
reads the same in both packages.  One default differs: ``use_pallas_kernel``
is True here, so a config left as it is builds the eq.-(14) kernel through
the port's K1 + K2 on the card.  ``__post_init__`` validates the fields as
JAX does.

The engine is the JAX package's single-device engine:
:func:`init_server_state` (Algorithm-1 init into a :class:`ServerState`,
the Cluster baseline's fit and the funnel's candidates included),
:func:`make_round_fn` (selection dispatched over a tuple of strategies,
the scenario's latency and availability draws, the fault draws and the
quarantine mask, local updates under the configured algorithm, the update
guard and eq.-(6) aggregation, loss refresh, GEMD and accuracy; the JAX
``_single_device_body``), :func:`run_scanned` (JAX's one compiled
``lax.scan``, here a host loop that stacks each round's outputs),
:func:`run_many` over a grid of states, :func:`run_checkpointed` with
:func:`save_server_state` and :func:`restore_server_state` (crash-resume),
:func:`funnel_fields` and :func:`history_from_outputs`.  With
``FLConfig.telemetry`` a round also returns its :class:`~repro_torch.obs.Telemetry`,
and the runners take a :class:`~repro_torch.obs.TelemetrySink` that each
segment's outputs are drained to after its last round.  JAX's server key
becomes one ``torch.Generator`` that the round draws from, in place: the
cohort first, then the batch plans.  JAX branches the scenario's draws,
the fault draws and the funnel's predictions off that key with a salt;
here each has a generator of its own, seeded from ``cfg.seed`` and the
salt, so none of them shifts a cohort.  ``FLTrainer`` (``fl/trainer.py``)
runs its rounds through this engine.

With a client mesh (``launch/mesh.py``: D ``torch.distributed`` ranks) every
rank runs the engine on its own state: the replicated fields (params, the
kernel and its cache, the generators, the quarantine, the staleness ring)
the same on every rank, and the client-sharded ones
(:data:`CLIENT_SHARDED_FIELDS`) holding only the rank's C/D resident
clients (:func:`shard_server_state`).  Selection is replicated, so every
rank draws the same cohort, and so are the cohort's batch plans, drawn as
the single-device engine draws them; each rank trains its cohort residents
and one ``mesh.all_reduce`` a round combines the eq.-(6) partial sums with
every other partial the round needs.  Three modes, as JAX's shard-map
bodies: resident (every resident trains, weight 0 outside the cohort),
capacity slots (``cohort_cap``: only the rank's cohort residents train)
and bounded staleness (``staleness_bound``: a rank that misses the
scenario's deadline trains from ring params of round ``t − s_d``, weighed
by λ(s_d); ``fl/staleness.py``).  The (C,) sizes are replicated; a round
reads the whole (C,) losses only for a strategy that draws on them
(``SelectionStrategy.reads_client_stats``), which costs one more
all-reduce; JAX's jit reads its sharded losses the same way.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import checkpoint as checkpoint_lib
from repro_torch.core import dpp as dpp_lib
from repro_torch.core import metrics as metrics_lib
from repro_torch.core import profiles as profiles_lib
from repro_torch.core import selection as selection_lib
from repro_torch.core import similarity as similarity_lib
from repro_torch.device import resolve_device
from repro_torch.fl import faults as faults_lib
from repro_torch.fl import local_algos as local_algos_lib
from repro_torch.fl import rounds as rounds_lib
from repro_torch.fl import scenarios as scenarios_lib
from repro_torch.fl import staleness as staleness_lib
from repro_torch.obs import sink as obs_sink_lib
from repro_torch.obs import telemetry as obs_telemetry_lib
from repro_torch.obs import tracing as obs_tracing_lib
from repro_torch.tree import tree_map

__all__ = [
    "FLConfig",
    "ServerState",
    "batch_indices_from_keys",
    "batches_from_indices",
    "make_client_batches",
    "CLIENT_SHARDED_FIELDS",
    "shard_server_state",
    "candidate_profile_block",
    "funnel_fields",
    "init_server_state",
    "make_round_fn",
    "run_scanned",
    "run_many",
    "run_checkpointed",
    "rank_dir",
    "save_server_state",
    "restore_server_state",
    "stack_states",
    "concat_outputs",
    "unstack_outputs",
    "history_from_outputs",
]

# the salts JAX folds into the server key for the scenario's environment
# draws and the funnel's predictions; here they seed generators of their own
_ENV_SALT = 0x5CE7A210
_FUNNEL_SALT = 0xF0A11E17


def salted_generator(seed: int, salt: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` and ``salt``: a stream
    apart from the server's, so drawing from it moves no cohort."""
    return torch.Generator(device=device).manual_seed((int(seed) * 0x9E3779B1 + salt) % (1 << 63))


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
    # capacity slots (client mesh only): at most this many cohort clients
    # train on a rank a round; >= min(clients_per_round, C / D)
    cohort_cap: Optional[int] = None
    # bounded staleness (client mesh and a scenario): a rank that misses the
    # scenario's deadline contributes partial sums from the params of round
    # t − s_d, s_d <= staleness_bound, weighed by the decay family's λ(s_d);
    # 0 is the synchronous round bit for bit
    staleness_bound: Optional[int] = None
    staleness_decay: str = "polynomial"  # constant | polynomial | exponential
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
    # a round also returns its obs.Telemetry under "telemetry"; every other
    # output and the state stay as they are without it, bit for bit
    telemetry: bool = False

    def local_algo_obj(self) -> local_algos_lib.LocalAlgo:
        """The configured local-update algorithm (``fl/local_algos.py``)."""
        return local_algos_lib.algo_from_config(self.local_algo, self.prox_mu, self.feddyn_alpha)

    def guarded(self) -> bool:
        """True when the update guard and the quarantine are on: a fault
        model, or a robust aggregator (which screens honest runs too)."""
        return self.faults is not None or self.aggregator != "mean"

    def candidate_count(self) -> int:
        """Q, the stage-1 survivors: ``round(C · candidate_frac)`` clamped
        to ``[clients_per_round, num_clients]`` (a cohort must fit)."""
        if self.candidate_frac is None:
            raise ValueError("candidate_count() needs candidate_frac")
        q = int(round(self.num_clients * self.candidate_frac))
        return max(self.clients_per_round, min(q, self.num_clients))

    def __post_init__(self):
        if self.staleness_bound is not None:
            if self.staleness_bound < 0:
                raise ValueError(f"staleness_bound={self.staleness_bound} must be >= 0")
            if self.cohort_cap is not None:
                raise ValueError(
                    f"cohort_cap={self.cohort_cap} is incompatible with staleness_bound="
                    f"{self.staleness_bound}: capacity slots assume a synchronous cohort (every "
                    "slot trains on round-t params); drop one of the two"
                )
            if self.scenario is None:
                raise ValueError(
                    f"staleness_bound={self.staleness_bound} requires a latency scenario (set "
                    "FLConfig.scenario / --scenario): without a latency model no shard goes stale"
                )
            if self.staleness_decay not in staleness_lib.DECAY_FAMILIES:
                raise ValueError(
                    f"unknown staleness_decay {self.staleness_decay!r}; known: {staleness_lib.DECAY_FAMILIES}"
                )
            if self.staleness_alpha < 0:
                raise ValueError(f"staleness_alpha={self.staleness_alpha} must be >= 0")
        if self.local_batch_size is not None and self.local_batch_size < 1:
            raise ValueError(f"local_batch_size={self.local_batch_size} must be >= 1")
        if self.scenario is not None:
            scenarios_lib.get_scenario(self.scenario)  # an unknown name raises
        if self.candidate_frac is not None and not 0.0 < self.candidate_frac <= 1.0:
            raise ValueError(
                f"candidate_frac={self.candidate_frac} must be in (0, 1] "
                "(1.0 = the identity funnel, a run equal to one without it)"
            )
        if self.aggregator not in faults_lib.AGGREGATORS:
            raise ValueError(f"unknown aggregator {self.aggregator!r}; known: {list(faults_lib.AGGREGATORS)}")
        if self.faults is not None:
            faults_lib.get_fault_model(self.faults)  # an unknown name raises
        if self.guarded():
            if self.robust_norm_mult <= 0:
                raise ValueError(f"robust_norm_mult={self.robust_norm_mult} must be > 0")
            if self.min_survivors < 1:
                raise ValueError(
                    f"min_survivors={self.min_survivors} must be >= 1: with 0 survivors the "
                    "weighted sum is all-zero and the aggregate would zero the params; the "
                    "floor makes such a round an identity round"
                )
            if self.min_survivors > self.clients_per_round:
                raise ValueError(
                    f"min_survivors={self.min_survivors} > clients_per_round="
                    f"{self.clients_per_round}: every round would be an identity round"
                )
            if self.quarantine_rounds < 0:
                raise ValueError(f"quarantine_rounds={self.quarantine_rounds} must be >= 0")
        if self.ckpt_every is not None and self.ckpt_every < 1:
            raise ValueError(f"ckpt_every={self.ckpt_every} must be >= 1 (None disables snapshots)")
        if self.local_algo not in local_algos_lib.LOCAL_ALGOS:
            raise ValueError(
                f"unknown local algorithm {self.local_algo!r}; known: {list(local_algos_lib.ALGO_NAMES)}"
            )
        if self.prox_mu is not None:
            if self.local_algo != "fedprox":
                raise ValueError(
                    f"prox_mu={self.prox_mu} only applies to local_algo='fedprox' (got {self.local_algo!r})"
                )
            if self.prox_mu < 0:
                raise ValueError(f"prox_mu={self.prox_mu} must be >= 0")
        if self.feddyn_alpha is not None:
            if self.local_algo != "feddyn":
                raise ValueError(
                    f"feddyn_alpha={self.feddyn_alpha} only applies to local_algo='feddyn' "
                    f"(got {self.local_algo!r})"
                )
            if self.feddyn_alpha <= 0:
                raise ValueError(f"feddyn_alpha={self.feddyn_alpha} must be > 0")


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


# ------------------------------------------------------------- server state


@dataclasses.dataclass(frozen=True)
class ServerState:
    """Everything the server evolves across rounds.

    The JAX package's fields.  ``generator`` takes
    the place of JAX's carried key: a round draws from it in place, so a
    state and the state a round returns share it (:meth:`fork` gives a
    state its own copies).  ``env_generator`` is the scenario's stream
    (None without a scenario), ``fault_generator`` the fault model's (None
    without one).  Under the funnel (``candidates`` set) the kernel, its
    spectral cache and the cluster labels live on the Q × Q candidate
    block.  ``quarantine`` exists only on a guarded config
    (``FLConfig.guarded``), ``algo_state`` only for a stateful local
    algorithm (FedDyn's ``h``), so a plain config's state is as before.

    ``param_hist`` and ``shard_staleness`` (the staleness ring and the (D,)
    lag counters, ``fl/staleness.py``) exist only with
    ``cfg.staleness_bound``.  A rank's state on a client mesh
    (:func:`shard_server_state`) has ``shard_count`` D and its
    ``shard_rank``, and its :data:`CLIENT_SHARDED_FIELDS` hold the rank's
    C/D residents only; a whole state has 0 and 1."""

    params: Any  # global model (a tree of tensors)
    generator: torch.Generator  # server randomness: cohorts, then batch plans
    round: int  # rounds completed
    losses: torch.Tensor  # (C,) last-known local losses
    kernel: torch.Tensor  # eq.-(14) DPP kernel: (C, C), or (Q, Q) under the funnel
    profiles: torch.Tensor  # (C, Q_f) eq.-(11) client profiles
    eig_state: dpp_lib.KDPPSamplerState  # spectral cache of ``kernel``
    client_xs: torch.Tensor  # (C, n_c, ...) simulated client shards
    client_ys: torch.Tensor  # (C, n_c)
    client_sizes: torch.Tensor  # (C,) n_c (replicated on a mesh)
    client_label_dists: torch.Tensor  # (C, num_classes)
    global_label_dist: torch.Tensor  # (num_classes,)
    cluster_labels: torch.Tensor  # (C,) or (Q,) int32, host-fitted (0 if unused)
    strategy_index: int = 0  # into the round_fn's strategies
    candidates: Optional[torch.Tensor] = None  # (Q,) int32 ascending global ids
    env_generator: Optional[torch.Generator] = None  # the scenario's draws
    # (C,) int32 rounds left before a flagged client may be selected again
    quarantine: Optional[torch.Tensor] = None
    # per-client local-algorithm state: a tree of (C, ...) fp32 tensors
    algo_state: Any = None
    fault_generator: Optional[torch.Generator] = None  # the fault model's draws
    param_hist: Any = None  # the ring of the last staleness_bound + 1 params
    shard_staleness: Optional[torch.Tensor] = None  # (D,) int32 per-shard lag
    shard_rank: int = 0  # this state's rank on a client mesh
    shard_count: int = 1  # the mesh's ranks (1: a whole state)

    @property
    def num_clients(self) -> int:
        """C, the federation's clients (on every rank of a mesh)."""
        return self.losses.shape[0] * self.shard_count

    def selection_state(self, losses: Optional[torch.Tensor] = None) -> selection_lib.SelectionState:
        """The per-round draw's input: candidate-space under the funnel
        (the O(Q) gathers of losses and sizes are the funnel's only cost a
        round).  ``losses`` (C,) stand in for the state's own (a rank's
        residents on a mesh)."""
        losses = self.losses if losses is None else losses
        sizes = self.client_sizes
        if self.candidates is None:
            return selection_lib.SelectionState(
                kernel=self.kernel, losses=losses, client_sizes=sizes,
                cluster_labels=self.cluster_labels, eig_state=self.eig_state,
            )
        ids = self.candidates.long()
        return selection_lib.SelectionState(
            kernel=self.kernel, losses=losses[ids], client_sizes=sizes[ids],
            cluster_labels=self.cluster_labels, eig_state=self.eig_state,
            candidates=selection_lib.CandidateSet(ids=self.candidates),
        )

    def fork(self) -> "ServerState":
        """This state with its own copies of the generators: running one of
        the two leaves the other's draws as they were."""

        def copy(g):
            if g is None:
                return None
            out = torch.Generator(device=g.device)
            out.set_state(g.get_state())
            return out

        return dataclasses.replace(
            self, generator=copy(self.generator), env_generator=copy(self.env_generator),
            fault_generator=copy(self.fault_generator),
        )


@torch.no_grad()
def _losses_of(loss_fn: Callable, params, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Per-client loss over each client's whole shard: (M, n_c, ...) -> (M,).
    Under ``torch.no_grad()``: a forward-only pass (K6 may take it)."""
    return torch.stack([loss_fn(params, x, y) for x, y in zip(xs, ys)])


def draw_environment(
    scen: scenarios_lib.Scenario, generator: torch.Generator, t: int, n: int
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One round's scenario draws from ``generator``: the (n,) latencies,
    then, for a scenario with an availability model, the (n,) mask at
    round ``t`` (None otherwise)."""
    lat = scen.latency(generator, n)
    avail = None if scen.availability is None else scen.availability(generator, n, t)
    return lat, avail


# ------------------------------------------------------------- client mesh

# the ServerState fields with one row per client that a rank keeps to its
# residents on a client mesh; every other field is replicated (the kernel
# too: selection needs all of it, and stays the same on every rank; and the
# (C,) sizes, which never change and which selection may read)
CLIENT_SHARDED_FIELDS = (
    "losses",
    "profiles",
    "client_xs",
    "client_ys",
    "client_label_dists",
    "algo_state",
)


def shard_server_state(state: ServerState, mesh) -> ServerState:
    """``state`` as rank ``mesh.rank`` of ``mesh`` holds it: the rows of
    :data:`CLIENT_SHARDED_FIELDS` cut to the rank's residents ``[r·C/D,
    (r+1)·C/D)`` (every other field as it is), and ``shard_rank`` and
    ``shard_count`` set.  A state already laid out for a rank and C not
    divisible by D raise.  The layout is the same with or without
    ``cfg.cohort_cap``: slots live inside a round."""
    if state.shard_count != 1:
        raise ValueError(
            f"the state is rank {state.shard_rank} of {state.shard_count}; shard a whole state"
        )
    c = state.num_clients
    if c % mesh.size:
        raise ValueError(f"num_clients={c} not divisible by the client mesh's {mesh.size} ranks")
    lo, hi = mesh.residents(c)
    updates = {
        f: tree_map(lambda x: x[lo:hi], getattr(state, f)) if getattr(state, f) is not None else None
        for f in CLIENT_SHARDED_FIELDS
    }
    return dataclasses.replace(state, shard_rank=mesh.rank, shard_count=mesh.size, **updates)


# ------------------------------------------------------------------ funnel


def candidate_profile_block(profiles: torch.Tensor, candidates: torch.Tensor, mesh=None) -> torch.Tensor:
    """The Q candidates' profile rows (Q, F).  Without a mesh one
    ``index_select``.  On a mesh ``profiles`` are the rank's residents'
    rows: each rank places the candidate rows it owns, zeros elsewhere,
    and ONE all-reduce assembles the block on every rank.  Only Q·F floats
    cross between ranks, and adding the other ranks' exact zeros leaves
    each row as the unsharded gather's, bit for bit."""
    ids = candidates.long()
    if mesh is None:
        return torch.index_select(profiles, 0, ids)
    c_loc = profiles.shape[0]
    pos = ids - mesh.rank * c_loc
    owned = (pos >= 0) & (pos < c_loc)
    rows = torch.index_select(profiles, 0, torch.clamp(pos, 0, c_loc - 1))
    rows = torch.where(owned[:, None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    return mesh.all_reduce(rows.float().reshape(-1)).reshape(rows.shape).to(profiles.dtype)


def funnel_fields(
    cfg: FLConfig,
    generator: torch.Generator,
    profiles: torch.Tensor,
    losses: torch.Tensor,
    strategy: Optional[selection_lib.SelectionStrategy] = None,
    round_index: int = 0,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor, dpp_lib.KDPPSamplerState]:
    """Stage 1 of the two-stage funnel: ``(candidates, kernel, eig_state)``
    at a segment boundary.  On a client mesh ``profiles`` are the rank's
    residents' rows and ``losses`` the whole (C,) vector; the block comes
    from :func:`candidate_profile_block`'s one all-reduce, and every rank
    then builds the same kernel and cache.

    * prefilter: :func:`~repro_torch.core.selection.funnel_scores` (running
      loss, and the scenario's latency and availability at ``round_index``
      drawn from ``generator`` as a prediction of the next rounds), then
      the top Q ascending ids;
    * the (Q, F) candidate block and its eq.-(14) kernel (Q, Q): K1 + K2 on
      the block's device with ``cfg.use_pallas_kernel``, the plain chain
      otherwise; min-max normalisation runs over the block, not over a
      C × C kernel;
    * the O(Q³) spectral cache (the identity placeholder for a strategy
      that never draws from it).

    Called at init and at every reprofile boundary, never a round."""
    q = cfg.candidate_count()
    lat = avail = None
    if cfg.scenario is not None:
        lat, avail = draw_environment(
            scenarios_lib.get_scenario(cfg.scenario), generator, round_index, losses.shape[0]
        )
    scores = selection_lib.funnel_scores(losses, avail=avail, latency=lat)
    candidates = selection_lib.funnel_candidates(scores, q)
    fq = candidate_profile_block(profiles, candidates, mesh)
    if cfg.use_pallas_kernel:
        from repro_torch.kernels.gram import ops as gram_ops

        kernel = gram_ops.candidate_kernel_from_profiles(fq, device=fq.device)
    else:
        kernel = similarity_lib.kernel_from_profiles(fq)
    if strategy is None or strategy.uses_spectral_cache:
        eig_state = dpp_lib.kdpp_sampler_state(kernel, cfg.clients_per_round)
    else:
        eig_state = dpp_lib.identity_sampler_state(q, cfg.clients_per_round, kernel.device)
    return candidates, kernel, eig_state


def fault_stream(cfg: FLConfig, device: torch.device) -> Optional[torch.Generator]:
    """The fault model's generator at its start (``cfg.seed`` salted with
    ``FAULT_SALT``); None without faults."""
    return None if cfg.faults is None else salted_generator(cfg.seed, faults_lib.FAULT_SALT, device)


def robustness_fields(
    cfg: FLConfig, params, num_clients: int, device: torch.device,
    fault_generator: Optional[torch.Generator],
) -> Dict[str, Any]:
    """ServerState's ``quarantine`` (guarded configs) and ``algo_state``
    (stateful local algorithms) for ``num_clients`` clients at zero, beside
    ``fault_generator``."""
    return dict(
        quarantine=(
            torch.zeros((num_clients,), dtype=torch.int32, device=device) if cfg.guarded() else None
        ),
        algo_state=local_algos_lib.init_client_states(cfg.local_algo_obj(), params, num_clients),
        fault_generator=fault_generator,
    )


def init_server_state(
    cfg: FLConfig,
    params,
    client_xs,
    client_ys,
    profiles: torch.Tensor,
    losses: torch.Tensor,
    strategy: Optional[selection_lib.SelectionStrategy] = None,
    device: Optional[Union[str, torch.device]] = None,
    *,
    loss_fn: Optional[Callable] = None,
    strategy_index: int = 0,
    kernel: Optional[torch.Tensor] = None,
    eig_state: Optional[dpp_lib.KDPPSamplerState] = None,
    mesh=None,
) -> ServerState:
    """Algorithm-1 initialisation as a :class:`ServerState` on ``device``
    (default ``cuda``; raises without a card), or, with a client ``mesh``,
    as that mesh's rank holds it (on the rank's device,
    :func:`shard_server_state`): the inputs are the whole federation's, as
    on one device, and a staleness config gets its ring at ``params`` and
    its counters at 0.

    Takes the clients' profiles (Alg. 1 lines 2-5) and initial last-known
    losses from the caller, builds the eq.-(14) kernel (through K1 + K2
    with ``cfg.use_pallas_kernel``) and, for a strategy that draws from it
    (or ``strategy=None``, a grid's unknown strategy), the k-DPP spectral
    cache (the one O(C³) eigh), and seeds the server's generator from
    ``cfg.seed``.  For the Cluster baseline it fits the labels on the
    clients' representative gradients, which need ``loss_fn``.  A kernel
    and its cache can be passed in.  A guarded config gets its quarantine
    counters at zero and, with a fault model, its fault generator (seeded
    from ``cfg.seed`` and ``FAULT_SALT``); a stateful local algorithm gets
    every client's state at zero, on the params' device.

    With ``cfg.candidate_frac`` set the kernel, cache and labels come from
    :func:`funnel_fields` on the Q candidates (their prediction drawn from
    a generator seeded from ``cfg.seed`` and the funnel's salt, as
    ``FLTrainer``'s first): this path builds no C × C tensor, and a kernel
    or cache passed in is a ``ValueError``.  On a mesh the funnel's block
    comes from the rank's residents' profiles and one all-reduce
    (:func:`candidate_profile_block`), as JAX's mesh init."""
    device = mesh.device if mesh is not None else resolve_device(device)
    client_xs = torch.as_tensor(client_xs, device=device)
    client_ys = torch.as_tensor(client_ys, device=device)
    c, n_c = client_xs.shape[0], client_xs.shape[1]
    profiles = torch.as_tensor(profiles, device=device)
    losses = torch.as_tensor(losses, device=device)
    k = cfg.clients_per_round
    candidates = None
    if cfg.candidate_frac is not None:
        # the losses are the prefilter's score, so they come first; every
        # kernel-shaped piece then lives on the Q block
        if kernel is not None or eig_state is not None:
            raise ValueError(
                "candidate_frac is set: the kernel and spectral cache are funnel-owned "
                "(Q x Q, rebuilt with the candidates); pass no precomputed kernel or eig_state"
            )
        own = profiles if mesh is None else profiles[slice(*mesh.residents(c))]
        candidates, kernel, eig_state = funnel_fields(
            cfg, salted_generator(cfg.seed, _FUNNEL_SALT, device), own, losses, strategy, mesh=mesh
        )
    if kernel is None:
        kernel = similarity_lib.kernel_from_profiles(profiles, use_kernel=cfg.use_pallas_kernel)
    if eig_state is None:
        if strategy is None or strategy.uses_spectral_cache:
            eig_state = dpp_lib.kdpp_sampler_state(kernel, k)
        else:
            eig_state = dpp_lib.identity_sampler_state(kernel.shape[0], k, device)
    if isinstance(strategy, selection_lib.ClusterSelection):
        if loss_fn is None:
            raise ValueError("the Cluster baseline's fit needs loss_fn (representative gradients)")
        # under the funnel, the same fingerprints restricted to the
        # candidate rows: at Q = C the labels are the unfunnelled ones
        rows = range(c) if candidates is None else candidates.tolist()
        gp = torch.stack([
            profiles_lib.representative_gradient_profile(loss_fn, params, client_xs[i], client_ys[i])
            for i in rows
        ])
        cluster_labels = strategy.fit(gp, k)
    else:
        cluster_labels = torch.zeros((kernel.shape[0],), dtype=torch.int32, device=device)
    stale = {}
    if cfg.staleness_bound is not None:
        stale["param_hist"], stale["shard_staleness"] = staleness_lib.init_staleness_fields(
            params, cfg.staleness_bound, mesh
        )
    state = ServerState(
        params=params,
        generator=torch.Generator(device=device).manual_seed(cfg.seed),
        round=0,
        losses=losses,
        kernel=kernel,
        profiles=profiles,
        eig_state=eig_state,
        client_xs=client_xs,
        client_ys=client_ys,
        client_sizes=torch.full((c,), float(n_c), device=device),
        client_label_dists=torch.stack(
            [metrics_lib.label_distribution(client_ys[i], cfg.num_classes) for i in range(c)]
        ),
        global_label_dist=metrics_lib.label_distribution(client_ys.reshape(-1), cfg.num_classes),
        cluster_labels=cluster_labels,
        strategy_index=strategy_index,
        candidates=candidates,
        env_generator=(
            None if cfg.scenario is None else salted_generator(cfg.seed, _ENV_SALT, device)
        ),
        **robustness_fields(cfg, params, c, device, fault_stream(cfg, device)),
        **stale,
    )
    return state if mesh is None else shard_server_state(state, mesh)


# ---------------------------------------------------------------- round_fn


def make_round_fn(
    cfg: FLConfig,
    loss_fn: Callable,  # loss_fn(params, x, y) -> scalar
    strategies: Sequence[selection_lib.SelectionStrategy],
    accuracy_fn: Optional[Callable] = None,
    eval_data: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    mesh=None,
) -> Callable[[ServerState, Any], Tuple[ServerState, Dict[str, Any]]]:
    """The per-round transition ``round_fn(state, _) -> (state, outputs)``.

    Selection through ``strategies[state.strategy_index]`` (one strategy
    for a single run, the method grid for :func:`run_many`), by
    ``select_global_fn``; the cohort's batch plans, the sequential local
    updates under ``cfg.local_algo`` and eq.-(6) aggregation, then the loss
    refresh of the selected clients under ``torch.no_grad()`` (a
    forward-only pass), topic-GEMD and, every ``cfg.eval_every`` rounds,
    ``accuracy_fn(params, xs, ys)`` on ``eval_data`` or, with None, on the
    union training set (the paper's Fig.-1 protocol).

    ``cfg.scenario`` draws each round's latencies (and availability mask)
    from ``state.env_generator`` before the cohort; a mask restricts the
    draw to available clients.  A guarded config (``cfg.guarded()``) adds,
    in JAX's order: the fault draws from ``state.fault_generator``
    (``faults.draw_round_faults``, with the lemons of ``faults.lemon_mask``)
    before selection; the quarantine mask (``state.quarantine <= 0``)
    AND-composed with the scenario's, so the draw is a masked one every
    round (as JAX's); the update guard between the local updates and the
    weighted sum; the loss refresh, and FedDyn's state, only for delivered,
    unflagged clients of a round that keeps its aggregate; the identity
    round (params carried over) below ``cfg.min_survivors``; and the
    quarantine counters: a flagged client's restarts at
    ``cfg.quarantine_rounds``, every other ticks down.

    With ``mesh`` (a :class:`~repro_torch.launch.mesh.ClientMesh`) the round
    is that rank's share of a sharded round, on a state laid out by
    :func:`shard_server_state`: the same cohort on every rank, local
    updates for the rank's cohort residents (all residents, weight 0 outside
    the cohort; with ``cfg.cohort_cap`` only ``min(C/D, cohort_cap)``
    slots), and ONE ``mesh.all_reduce`` for the eq.-(6) partial sums, the
    loss total, the GEMD numerator and denominator and, guarded, the
    survivor count and the flags (the guard runs before it).  The loss
    refresh stays on each client's rank.  ``cfg.staleness_bound`` makes it
    the bounded-staleness round: the shards' deadline misses from the
    round's latency draw, their counters, decay weights and ring reads, and
    the simulated wall clock, all replicated; a stale rank trains from the
    ring.  The fault draws' shard blackout is drawn per rank.  On a mesh,
    the accuracy on the union training set takes one more all-reduce on an
    eval round (held-out ``eval_data`` none).

    Outputs: ``round``, ``acc`` (NaN off the eval grid or without
    ``accuracy_fn``), ``gemd``, ``loss`` (the mean local loss; guarded, the
    mean over the finite losses of the clients left in the sum), ``selected``;
    with a scenario ``sim_time`` (the slowest selected client's latency,
    the synchronous barrier; under staleness :func:`staleness.round_sim_time`)
    and, with an availability model, ``avail``; with staleness
    ``staleness``, the mean lag of the shards' contributions; guarded,
    ``survivors``, ``identity_round``, ``flagged`` and ``quarantined``
    (int32); with ``cfg.telemetry``, ``telemetry`` (an
    :class:`~repro_torch.obs.Telemetry` computed from values the round
    holds, on its device); and ``t_select``, ``t_local``, ``t_refresh``:
    host seconds of the three parts, each closed by a device synchronise
    (the scenario's and the fault draws count to selection, the accuracy
    to the refresh)."""
    strategies = tuple(strategies)
    if not strategies:
        raise ValueError("make_round_fn needs at least one strategy")
    k = cfg.clients_per_round
    if mesh is not None and cfg.cohort_cap is not None:
        c_loc_cfg = cfg.num_clients // mesh.size
        if cfg.cohort_cap < min(k, c_loc_cfg):
            raise ValueError(
                f"cohort_cap={cfg.cohort_cap} < min(clients_per_round={k}, C_loc={c_loc_cfg}): a rank "
                "could hold more cohort members than slots (clients would be dropped)"
            )
    if cfg.staleness_bound is not None and mesh is None:
        raise ValueError(
            f"staleness_bound={cfg.staleness_bound} requires the client mesh (pass mesh=...; launchers: "
            "--staleness-bound needs --shard-clients): staleness is a property of a shard"
        )
    scen = None if cfg.scenario is None else scenarios_lib.get_scenario(cfg.scenario)
    batched_loss = lambda p, batch: loss_fn(p, batch[0], batch[1])
    fault_model = None if cfg.faults is None else faults_lib.get_fault_model(cfg.faults)
    guarded = cfg.guarded()
    lemons = None if fault_model is None else faults_lib.lemon_mask(fault_model, cfg.num_clients)
    lemons_on = {}  # the lemon mask on each device a round ran on, copied once
    guard = None
    if guarded:
        guard = faults_lib.make_update_guard(
            cfg.aggregator, cfg.robust_norm_mult,
            garbage_scale=1.0 if fault_model is None else fault_model.garbage_scale,
            inject=fault_model is not None,
        )
    algo = cfg.local_algo_obj()
    n_shards = 1 if mesh is None else mesh.size

    def clock(device: torch.device) -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    def writeback(full, sel, cand, refresh):
        """``full`` with the cohort's rows set to ``cand`` where ``refresh``
        (FedDyn's state advances only for a kept update)."""

        def leaf(f, n):
            keep = refresh.reshape((-1,) + (1,) * (n.ndim - 1))
            return f.index_put((sel,), torch.where(keep, n, f[sel]))

        return tree_map(leaf, full, cand)

    def writeback_rows(full, cand, refresh):
        """Resident layout: rows of ``cand`` where ``refresh``, else ``full``'s."""
        return tree_map(
            lambda f, n: torch.where(refresh.reshape((-1,) + (1,) * (n.ndim - 1)), n, f), full, cand
        )

    def single_device_body(state, sel, draws, plans):
        """The cohort gathered on one device: JAX's ``_single_device_body``."""
        dev = state.losses.device
        batches = batches_from_indices(cfg, plans, state.client_xs[sel], state.client_ys[sel])
        round_step = rounds_lib.build_client_parallel_round(
            batched_loss, cfg.lr, _steps_per_round(cfg, state.client_xs.shape[1]),
            grad_clip=cfg.grad_clip, update_transform=guard, algo=algo,
        )
        state_kw = {}
        if algo.stateful:
            state_kw["client_states"] = tree_map(lambda s: s[sel], state.algo_state)
        guard_args = () if draws is None else tuple(m[sel] for m in draws)
        res = round_step(state.params, batches, state.client_sizes[sel], *guard_args, **state_kw)
        out = dict(params=res[0], mean_loss=res[1])
        refresh = None
        if guarded:
            flagged, survivors = res[2], res[3]
            delivered = draws.delivered[sel] if draws is not None else torch.ones_like(flagged)
            # only trusted participants of a round whose aggregate is kept
            refresh = delivered & ~flagged & (survivors >= cfg.min_survivors)
            out["flagged_c"] = torch.zeros((state.num_clients,), dtype=torch.bool, device=dev).index_put(
                (sel,), flagged
            )
            out["survivors"] = survivors
        out["t2"] = clock(dev)
        # refresh last-known losses for the selected clients
        sel_losses = _losses_of(loss_fn, out["params"], state.client_xs[sel], state.client_ys[sel])
        if refresh is not None:
            sel_losses = torch.where(refresh, sel_losses, state.losses[sel])
        out["losses"] = state.losses.index_put((sel,), sel_losses)
        if algo.stateful:
            every = torch.ones(sel.shape, dtype=torch.bool, device=dev)
            out["algo_state"] = writeback(state.algo_state, sel, res[-1], every if refresh is None else refresh)
        out["gemd"] = metrics_lib.gemd(
            state.client_label_dists, state.client_sizes, sel, state.global_label_dist
        )
        return out

    def mesh_body(state, sel, draws, plans, lat):
        """This rank's share of the sharded round: JAX's ``_sharded_body``,
        ``_slot_sharded_body`` and ``_stale_sharded_body``."""
        dev = state.losses.device
        c = cfg.num_clients
        c_loc = state.client_xs.shape[0]
        lo = mesh.rank * c_loc
        in_cohort = torch.zeros((c,), dtype=torch.bool, device=dev)
        in_cohort[sel] = True
        mask = in_cohort[lo:lo + c_loc]
        gids = torch.arange(lo, lo + c_loc, device=dev)
        weights = state.client_sizes[lo:lo + c_loc] * mask
        # GEMD (eq. 15) numerator and denominator over this rank's cohort
        # residents ride the round's all-reduce; λ-free under staleness
        w = weights.float()
        gemd_parts = ((w[:, None] * state.client_label_dists).sum(0), torch.sum(w))
        kw = dict(extras=gemd_parts, local_states=state.algo_state if algo.stateful else None)
        if guarded:
            kw["flag_span"] = (lo, c)

        def cohort_pos(ids):
            # each id's position in the cohort (0 outside it, as JAX's argmax)
            return torch.argmax((sel[None, :] == ids[:, None]).to(torch.int8), dim=1)

        out = {}
        slot = None
        if cfg.cohort_cap is not None:
            cap = min(c_loc, cfg.cohort_cap)
            # the rank's slots: cohort residents first (ascending), then
            # weight-0 padding residents
            slot = torch.argsort((~mask).to(torch.int8), stable=True)[:cap]
            rows_x, rows_y = state.client_xs[slot], state.client_ys[slot]
            batches = batches_from_indices(
                cfg, None if plans is None else plans[cohort_pos(gids[slot])], rows_x, rows_y
            )
            if draws is not None:
                kw["guard_args"] = tuple(m[gids[slot]] for m in draws)
            step = rounds_lib.build_shard_cohort_round(
                batched_loss, cfg.lr, mesh, grad_clip=cfg.grad_clip, cap=cap, update_transform=guard, algo=algo,
            )
            res = step(state.params, batches, weights, slot, **kw)
        else:
            # every resident adopts its cohort slot's plan, so a cohort
            # member trains on the batches the single-device engine gives it
            batches = batches_from_indices(
                cfg, None if plans is None else plans[cohort_pos(gids)], state.client_xs, state.client_ys
            )
            if draws is not None:
                kw["guard_args"] = tuple(m[lo:lo + c_loc] for m in draws)
            if cfg.staleness_bound is None:
                step = rounds_lib.build_shard_cohort_round(
                    batched_loss, cfg.lr, mesh, grad_clip=cfg.grad_clip, update_transform=guard, algo=algo,
                )
                res = step(state.params, batches, weights, **kw)
            else:
                bound = cfg.staleness_bound
                # a shard's latency is its slowest cohort resident (a shard
                # with none is instant and re-syncs for free)
                shard_lat = torch.where(in_cohort, lat, torch.zeros((), dtype=lat.dtype, device=dev))
                shard_lat = torch.amax(shard_lat.reshape(n_shards, c_loc), dim=1)
                slow = shard_lat > scen.deadline
                # the post-update counters price the contribution: a shard
                # that misses delivers work from before the miss
                new_s, forced = staleness_lib.staleness_step(state.shard_staleness, slow, bound)
                lam = staleness_lib.decay_weights(new_s, cfg.staleness_decay, cfg.staleness_alpha)
                read = staleness_lib.read_slots(state.round, new_s, bound)
                out.update(new_s=new_s, sim_time=staleness_lib.round_sim_time(shard_lat, slow, forced, scen.deadline))
                step = rounds_lib.build_stale_shard_cohort_round(
                    batched_loss, cfg.lr, mesh, grad_clip=cfg.grad_clip, update_transform=guard, algo=algo,
                )
                res = step(state.param_hist, read[mesh.rank], lam[mesh.rank], batches, weights, **kw)
        params, mean_loss, (num, den) = res[0], res[2], res[3]
        out.update(params=params, mean_loss=mean_loss)
        out["gemd"] = torch.sum(torch.abs(metrics_lib.safe_div(num, den) - state.global_label_dist))
        rows = mask if slot is None else mask[slot]
        if guarded:
            flagged_c, survivors = res[4], res[5]
            out.update(flagged_c=flagged_c, survivors=survivors)
            own = gids if slot is None else gids[slot]
            delivered = draws.delivered[own] if draws is not None else torch.ones_like(rows)
            rows = rows & delivered & ~flagged_c[own] & (survivors >= cfg.min_survivors)
        out["t2"] = clock(dev)
        # the refresh measures the new aggregate on each client's own rank
        local = torch.arange(c_loc, device=dev) if slot is None else slot
        fresh_at = local[rows]
        losses = state.losses.clone()
        if fresh_at.numel():
            losses[fresh_at] = _losses_of(
                loss_fn, params, state.client_xs[fresh_at], state.client_ys[fresh_at]
            ).to(losses.dtype)
        out["losses"] = losses
        if algo.stateful:
            refresh = torch.zeros((c_loc,), dtype=torch.bool, device=dev)
            refresh[local] = rows
            out["algo_state"] = writeback_rows(state.algo_state, res[-1], refresh)
        if cfg.staleness_bound is not None:
            if guarded:
                # the survivors floor before the ring write: the ring holds
                # the params the round kept
                kept = out["survivors"] >= cfg.min_survivors
                params = tree_map(lambda a, o: torch.where(kept, a, o).to(o.dtype), params, state.params)
                out["params"] = params
            out["param_hist"] = staleness_lib.update_param_hist(
                state.param_hist, params, state.round + 1, cfg.staleness_bound
            )
        return out

    def selection_view(state, strategy):
        """The draw's input on a mesh: the whole (C,) losses, through one
        all-reduce, only for a strategy that reads them; NaN stand-ins
        (never read) otherwise."""
        c = cfg.num_clients
        if strategy.reads_client_stats:
            return state.selection_state(mesh.assemble(state.losses, c))
        return state.selection_state(torch.full((c,), float("nan"), dtype=state.losses.dtype,
                                                device=state.losses.device))

    def accuracy(params, state):
        if eval_data is not None:
            return torch.as_tensor(accuracy_fn(params, *eval_data)).float()
        exs = state.client_xs.reshape((-1,) + state.client_xs.shape[2:])
        eys = state.client_ys.reshape(-1)
        acc = torch.as_tensor(accuracy_fn(params, exs, eys)).float()
        if mesh is None:
            return acc
        # the union training set: each rank's share weighed by its samples
        n = torch.full((), float(eys.numel()), device=acc.device)
        tot, cnt = mesh.all_reduce(torch.stack([acc * n, n]))
        return tot / cnt

    def round_fn(state: ServerState, _=None):
        dev = state.losses.device
        c = state.num_clients
        t = state.round + 1
        t0 = clock(dev)
        lat = avail = None
        if scen is not None:
            lat, avail = draw_environment(scen, state.env_generator, t, c)
        draws = None
        if fault_model is not None:
            if dev not in lemons_on:
                lemons_on[dev] = lemons.to(dev)
            draws = faults_lib.draw_round_faults(state.fault_generator, fault_model, c, n_shards, lemons_on[dev])
        mask = avail
        if guarded:
            # a quarantined client is unavailable to selection
            q_ok = state.quarantine <= 0
            mask = q_ok if mask is None else mask & q_ok
        strategy = strategies[state.strategy_index]
        sel_state = state.selection_state() if mesh is None else selection_view(state, strategy)
        sel = strategy.select_global_fn(state.generator, sel_state, k, mask).long()
        t1 = clock(dev)
        # the cohort's batch plans, in cohort order, as every path draws them
        plans = batch_indices_from_keys(cfg, state.generator, sel.shape[0], state.client_xs.shape[1])
        if mesh is None:
            body = single_device_body(state, sel, draws, plans)
        else:
            body = mesh_body(state, sel, draws, plans, lat)
        params, t2 = body["params"], body["t2"]
        updates = dict(losses=body["losses"])
        if algo.stateful:
            updates["algo_state"] = body["algo_state"]
        if "param_hist" in body:
            updates.update(param_hist=body["param_hist"], shard_staleness=body["new_s"])
        if guarded:
            flagged_c, survivors = body["flagged_c"], body["survivors"]
            kept = survivors >= cfg.min_survivors
            # an identity round below the survivors floor keeps the old
            # params (the stale body floored before its ring write already)
            params = tree_map(lambda a, o: torch.where(kept, a, o).to(o.dtype), params, state.params)
            q = torch.clamp_min(state.quarantine - 1, 0)
            q = torch.where(flagged_c, cfg.quarantine_rounds, q).to(torch.int32)
            updates["quarantine"] = q
        acc = torch.tensor(float("nan"))
        if accuracy_fn is not None and t % cfg.eval_every == 0:
            acc = accuracy(params, state)
        t3 = clock(dev)
        new_state = dataclasses.replace(state, params=params, round=t, **updates)
        out = {
            "round": t,
            "acc": acc,
            "gemd": body["gemd"].float(),
            "loss": body["mean_loss"].float(),
            "selected": sel.to(torch.int32),
        }
        if scen is not None:
            if "sim_time" in body:
                out["sim_time"] = body["sim_time"].float()
            else:
                # the synchronous barrier: the round closes at the slowest
                # selected client (latencies are positive; 0 as JAX's floor)
                out["sim_time"] = torch.clamp_min(torch.amax(lat[sel]), 0.0)
        if avail is not None:
            out["avail"] = avail
        if cfg.staleness_bound is not None:
            out["staleness"] = torch.mean(body["new_s"].float())
        if guarded:
            out["survivors"] = survivors.to(torch.int32)
            out["identity_round"] = (~kept).to(torch.int32)
            out["flagged"] = torch.sum(flagged_c.to(torch.int32))
            out["quarantined"] = torch.sum((q > 0).to(torch.int32))
        if cfg.telemetry:
            # it adds outputs only: no draw, no state field, no synchronise
            out["telemetry"] = obs_telemetry_lib.round_telemetry(
                cfg, state, t=t, avail=avail,
                new_s=body.get("new_s"),
                flagged=flagged_c if guarded else None,
                survivors=survivors if guarded else None,
                quarantine=q if guarded else None,
            )
        out.update(t_select=t1 - t0, t_local=t2 - t1, t_refresh=t3 - t2)
        return new_state, out

    return round_fn


# ------------------------------------------------------------------ runners


def _join(outs: List[Dict[str, Any]], fn: Callable) -> Dict[str, Any]:
    """``fn`` over each output's list of values in ``outs`` (a stack or a
    concatenation); the ``telemetry`` record field by field."""

    def one(values):
        if isinstance(values[0], obs_telemetry_lib.Telemetry):
            return obs_telemetry_lib.Telemetry.combine(values, fn)
        return fn(values)

    return {name: one([o[name] for o in outs]) for name in outs[0]}


def _stack(outs: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-round output dicts -> each output stacked on a leading axis, on
    the CPU."""
    return _join(outs, lambda vs: torch.stack([torch.as_tensor(v).detach().cpu() for v in vs]))


def concat_outputs(outs: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Segments' stacked outputs joined along the round axis."""
    return _join(outs, torch.cat)


def run_scanned(
    round_fn, state: ServerState, num_rounds: int,
    sink: Optional[obs_sink_lib.TelemetrySink] = None,
) -> Tuple[ServerState, Dict[str, Any]]:
    """Run ``num_rounds`` rounds -> (final state, per-round outputs stacked
    on a leading ``(num_rounds,)`` axis, on the CPU).  JAX compiles the
    rounds into one ``lax.scan``; here they run eagerly in a host loop
    (capturing them as a CUDA graph is later work).  On a client mesh,
    ``state`` is the rank's (``init_server_state(mesh=)``).

    ``sink`` takes one ``fl_round`` event per round, drained from the
    stacked outputs after the loop, never inside a round, so a sink
    changes no round."""
    outs: List[Dict[str, Any]] = []
    with obs_tracing_lib.annotate(f"fl.scan_chunk[{num_rounds}]"):
        for _ in range(num_rounds):
            state, out = round_fn(state)
            outs.append(out)
        stacked = _stack(outs) if outs else {}
    if sink is not None and num_rounds:
        obs_sink_lib.drain_fl_outputs(sink, stacked)
    return state, stacked


# ------------------------------------------------------------ crash-resume


def _state_tree(state: ServerState) -> Dict[str, Any]:
    """A state as a tree of tensors, field by field: each generator as its
    ``get_state()`` (uint8), the ints ``round`` and ``strategy_index`` as
    0-d int64, the spectral cache as its three tensors."""

    def leafy(v):
        if isinstance(v, torch.Generator):
            return v.get_state()
        if isinstance(v, int):
            return torch.tensor(v, dtype=torch.int64)
        if isinstance(v, dpp_lib.KDPPSamplerState):
            return {f.name: getattr(v, f.name) for f in dataclasses.fields(v)}
        return v

    return {f.name: leafy(getattr(state, f.name)) for f in dataclasses.fields(state)}


def rank_dir(ckpt_dir: str, state: ServerState) -> str:
    """Where ``state`` is snapshotted: ``ckpt_dir`` itself for a whole
    state, else its rank's own ``<ckpt_dir>/rank_<r>_of_<D>`` (each rank
    saves its residents' rows beside the replicated fields)."""
    if state.shard_count == 1:
        return ckpt_dir
    return os.path.join(ckpt_dir, f"rank_{state.shard_rank}_of_{state.shard_count}")


def save_server_state(ckpt_dir: str, state: ServerState) -> str:
    """Snapshot every field of ``state`` under ``<ckpt_dir>/step_<round>/``
    (params, generators, losses, kernel and spectral cache, client data,
    candidates, quarantine, FedDyn state, the staleness ring and counters)
    -> that path; a rank's state under its :func:`rank_dir`.  Where JAX
    saves its key's data, this saves each generator's state."""
    return checkpoint_lib.save(rank_dir(ckpt_dir, state), state.round, _state_tree(state))


def restore_server_state(
    ckpt_dir: str, template: ServerState, step: Optional[int] = None
) -> ServerState:
    """A :func:`save_server_state` snapshot (the latest without ``step``)
    loaded against ``template``, e.g. a fresh :func:`init_server_state` of
    the same config, onto the template's devices, with generators of its
    own.  A snapshot of another config (leaf count, shape or dtype, a CPU
    generator's state against a CUDA one's included) raises ``ValueError``.
    The restored state continues as the snapshotting run did: every tensor
    and every generator's state is the value it held after round
    ``state.round``.  A rank's template loads its rank's own snapshot
    (:func:`rank_dir`)."""
    tree = checkpoint_lib.restore(rank_dir(ckpt_dir, template), _state_tree(template), step=step)

    def unleafy(t, v):
        if isinstance(t, torch.Generator):
            g = torch.Generator(device=t.device)
            g.set_state(v)
            return g
        if isinstance(t, int):
            return int(v)
        if isinstance(t, dpp_lib.KDPPSamplerState):
            return dpp_lib.KDPPSamplerState(**v)
        return v

    return dataclasses.replace(
        template,
        **{f.name: unleafy(getattr(template, f.name), tree[f.name]) for f in dataclasses.fields(template)},
    )


def run_checkpointed(
    round_fn, state: ServerState, num_rounds: int,
    ckpt_dir: Optional[str] = None,
    ckpt_every: Optional[int] = None,
    sink: Optional[obs_sink_lib.TelemetrySink] = None,
) -> Tuple[ServerState, Dict[str, Any]]:
    """:func:`run_scanned` in ``ckpt_every``-round segments, the whole state
    saved (:func:`save_server_state`; a rank's state its own) after
    each.  Segmenting changes no number, and a run restored from a
    snapshot continues as the uninterrupted one (run N == run n, restore,
    run N − n).  With ``ckpt_dir`` or ``ckpt_every`` unset this is
    :func:`run_scanned`.  ``sink`` takes each segment's rounds and an
    ``fl_checkpoint`` event after each save."""
    if ckpt_dir is None or not ckpt_every:
        return run_scanned(round_fn, state, num_rounds, sink=sink)
    done = 0
    outs: List[Dict[str, Any]] = []
    while done < num_rounds:
        n = min(ckpt_every, num_rounds - done)
        state, seg = run_scanned(round_fn, state, n, sink=sink)
        outs.append(seg)
        save_server_state(ckpt_dir, state)
        if sink is not None:
            sink.emit("fl_checkpoint", round=state.round)
        done += n
    if not outs:
        return state, {}
    return state, concat_outputs(outs)


def stack_states(states: Sequence[ServerState]) -> Tuple[ServerState, ...]:
    """A grid of per-run states for :func:`run_many`.  JAX stacks them leaf
    by leaf onto a batch axis for ``vmap``; PyTorch has no ``vmap`` over a
    round that draws from generators, so the port's grid is the sequence of
    states itself, checked to share one federation shape."""
    states = tuple(states)
    if not states:
        raise ValueError("stack_states needs at least one state")
    shape = tuple(states[0].client_xs.shape)
    for s in states:
        if tuple(s.client_xs.shape) != shape:
            raise ValueError(f"grid states differ in client data: {tuple(s.client_xs.shape)} != {shape}")
    return states


def run_many(
    round_fn, stacked_states: Sequence[ServerState], num_rounds: int,
) -> Tuple[Tuple[ServerState, ...], Dict[str, torch.Tensor]]:
    """A batched simulation over a grid of states (:func:`stack_states`),
    e.g. S seeds × K strategies flattened, each dispatching through its own
    ``strategy_index`` -> (final states, outputs in JAX's ``(batch,
    num_rounds, ...)`` layout).

    JAX runs the grid as one ``vmap``-ed XLA program; here it is a host
    loop over the grid, each state through :func:`run_scanned` in turn, so
    each grid point's outputs are exactly its own run's.  A state's
    generators are drawn from in place: :meth:`ServerState.fork` first to
    run one state twice."""
    finals, outs = [], []
    for state in stack_states(stacked_states):
        final, out = run_scanned(round_fn, state, num_rounds)
        finals.append(final)
        outs.append(out)
    if num_rounds == 0:
        return tuple(finals), {}
    return tuple(finals), _join(outs, torch.stack)


def unstack_outputs(outputs: Dict[str, Any]) -> List[Dict[str, Any]]:
    """:func:`run_many` outputs -> one per-run dict of numpy arrays each
    (the ``telemetry`` record's fields as numpy arrays too)."""
    if not outputs:
        return []
    n = outputs["round"].shape[0]
    return [_join([outputs], lambda vs, i=i: np.asarray(vs[0][i])) for i in range(n)]


# ------------------------------------------------------------------ history


def history_from_outputs(
    outputs: Dict[str, Any],
    eval_every: int,
    final_acc: Optional[float] = None,
) -> Dict[str, List]:
    """Stacked outputs -> the ``FLTrainer`` history dict: one entry per
    round where ``t % eval_every == 0``, plus the final round, whose missing
    accuracy ``final_acc`` fills."""
    hist: Dict[str, List] = {"round": [], "acc": [], "gemd": [], "loss": []}
    if not outputs or len(outputs["round"]) == 0:
        return hist
    rounds = np.asarray(outputs["round"]).astype(int)
    acc = np.asarray(outputs["acc"], np.float64)
    gemd = np.asarray(outputs["gemd"], np.float64)
    loss = np.asarray(outputs["loss"], np.float64)
    n = int(rounds[-1])
    for i, t in enumerate(rounds):
        t = int(t)
        if t % eval_every == 0 or t == n:
            a = acc[i]
            if np.isnan(a) and t == n and final_acc is not None:
                a = final_acc
            hist["round"].append(t)
            hist["acc"].append(float(a))
            hist["gemd"].append(float(gemd[i]))
            hist["loss"].append(float(loss[i]))
    return hist
