"""The federation engine: configuration, batch plans, and the round
transition run as a host loop.

``FLConfig`` keeps every field of the JAX package's config, so a config
reads the same in both packages.  One default differs: ``use_pallas_kernel``
is True here, so a config left as it is builds the eq.-(14) kernel through
the port's K1 + K2 on the card.  ``__post_init__`` refuses the fields whose
features this package does not run yet (mesh slots, staleness, faults and
robust aggregation, checkpoints, non-FedAvg local algorithms, telemetry),
each with its ROADMAP item.

The engine is the JAX package's single-device engine:
:func:`init_server_state` (Algorithm-1 init into a :class:`ServerState`,
the Cluster baseline's fit and the funnel's candidates included),
:func:`make_round_fn` (selection dispatched over a tuple of strategies,
the scenario's latency and availability draws, local updates, eq.-(6)
aggregation, loss refresh, GEMD and accuracy; the JAX
``_single_device_body``), :func:`run_scanned` (JAX's one compiled
``lax.scan``, here a host loop that stacks each round's outputs),
:func:`run_many` over a grid of states, :func:`funnel_fields` and
:func:`history_from_outputs`.  JAX's server key becomes one
``torch.Generator`` that the round draws from, in place: the cohort first,
then the batch plans.  JAX branches the scenario's draws and the funnel's
predictions off that key with a salt; here each has a generator of its
own, seeded from ``cfg.seed`` and the salt, so neither shifts a cohort.
``FLTrainer`` (``fl/trainer.py``) runs its rounds through this engine.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import dpp as dpp_lib
from repro_torch.core import metrics as metrics_lib
from repro_torch.core import profiles as profiles_lib
from repro_torch.core import selection as selection_lib
from repro_torch.core import similarity as similarity_lib
from repro_torch.device import resolve_device
from repro_torch.fl import rounds as rounds_lib
from repro_torch.fl import scenarios as scenarios_lib

__all__ = [
    "FLConfig",
    "ServerState",
    "batch_indices_from_keys",
    "batches_from_indices",
    "make_client_batches",
    "candidate_profile_block",
    "funnel_fields",
    "init_server_state",
    "make_round_fn",
    "run_scanned",
    "run_many",
    "stack_states",
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

    def candidate_count(self) -> int:
        """Q, the stage-1 survivors: ``round(C · candidate_frac)`` clamped
        to ``[clients_per_round, num_clients]`` (a cohort must fit)."""
        if self.candidate_frac is None:
            raise ValueError("candidate_count() needs candidate_frac")
        q = int(round(self.num_clients * self.candidate_frac))
        return max(self.clients_per_round, min(q, self.num_clients))

    def __post_init__(self):
        # field -> (in use, ROADMAP Queue-1 item that ports it)
        not_ported = {
            "cohort_cap": (self.cohort_cap is not None, 15),
            # JAX runs staleness on a mesh only, which item 15 brings
            "staleness_bound": (self.staleness_bound is not None, 15),
            "faults": (self.faults is not None, 12),
            "aggregator": (self.aggregator != "mean", 12),
            "ckpt_every": (self.ckpt_every is not None, 12),
            "local_algo": (self.local_algo != "fedavg", 12),
            "prox_mu": (self.prox_mu is not None, 12),
            "feddyn_alpha": (self.feddyn_alpha is not None, 12),
            "telemetry": (self.telemetry, 13),
        }
        fields = [f"{name} (ROADMAP Queue 1 item {item})" for name, (used, item) in not_ported.items() if used]
        if fields:
            raise NotImplementedError(
                f"FLConfig fields {fields} select features that are not yet ported"
            )
        if self.local_batch_size is not None and self.local_batch_size < 1:
            raise ValueError(f"local_batch_size={self.local_batch_size} must be >= 1")
        if self.scenario is not None:
            scenarios_lib.get_scenario(self.scenario)  # an unknown name raises
        if self.candidate_frac is not None and not 0.0 < self.candidate_frac <= 1.0:
            raise ValueError(
                f"candidate_frac={self.candidate_frac} must be in (0, 1] "
                "(1.0 = the identity funnel, a run equal to one without it)"
            )


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

    The JAX package's fields for the features this package runs; the
    fields of the refused ones (staleness ring, quarantine, per-client
    algorithm state) are left out.  ``generator`` takes the place of JAX's
    carried key: a round draws from it in place, so a state and the state a
    round returns share it (:meth:`fork` gives a state its own copy).
    ``env_generator`` is the scenario's stream (None without a scenario).
    Under the funnel (``candidates`` set) the kernel, its spectral cache
    and the cluster labels live on the Q × Q candidate block."""

    params: Any  # global model (a tree of tensors)
    generator: torch.Generator  # server randomness: cohorts, then batch plans
    round: int  # rounds completed
    losses: torch.Tensor  # (C,) last-known local losses
    kernel: torch.Tensor  # eq.-(14) DPP kernel: (C, C), or (Q, Q) under the funnel
    profiles: torch.Tensor  # (C, Q_f) eq.-(11) client profiles
    eig_state: dpp_lib.KDPPSamplerState  # spectral cache of ``kernel``
    client_xs: torch.Tensor  # (C, n_c, ...) simulated client shards
    client_ys: torch.Tensor  # (C, n_c)
    client_sizes: torch.Tensor  # (C,) n_c
    client_label_dists: torch.Tensor  # (C, num_classes)
    global_label_dist: torch.Tensor  # (num_classes,)
    cluster_labels: torch.Tensor  # (C,) or (Q,) int32, host-fitted (0 if unused)
    strategy_index: int = 0  # into the round_fn's strategies
    candidates: Optional[torch.Tensor] = None  # (Q,) int32 ascending global ids
    env_generator: Optional[torch.Generator] = None  # the scenario's draws

    @property
    def num_clients(self) -> int:
        return self.losses.shape[0]

    def selection_state(self) -> selection_lib.SelectionState:
        """The per-round draw's input: candidate-space under the funnel
        (the O(Q) gathers of losses and sizes are the funnel's only cost a
        round)."""
        if self.candidates is None:
            return selection_lib.SelectionState(
                kernel=self.kernel, losses=self.losses, client_sizes=self.client_sizes,
                cluster_labels=self.cluster_labels, eig_state=self.eig_state,
            )
        ids = self.candidates.long()
        return selection_lib.SelectionState(
            kernel=self.kernel, losses=self.losses[ids], client_sizes=self.client_sizes[ids],
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
            self, generator=copy(self.generator), env_generator=copy(self.env_generator)
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


# ------------------------------------------------------------------ funnel


def candidate_profile_block(profiles: torch.Tensor, candidates: torch.Tensor) -> torch.Tensor:
    """The Q candidates' profile rows (Q, F): one ``index_select`` on one
    device.  (JAX's mesh form, a shard-local gather and one psum, waits for
    the mesh engine.)"""
    return torch.index_select(profiles, 0, candidates.long())


def funnel_fields(
    cfg: FLConfig,
    generator: torch.Generator,
    profiles: torch.Tensor,
    losses: torch.Tensor,
    strategy: Optional[selection_lib.SelectionStrategy] = None,
    round_index: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, dpp_lib.KDPPSamplerState]:
    """Stage 1 of the two-stage funnel: ``(candidates, kernel, eig_state)``
    at a segment boundary.

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
    fq = candidate_profile_block(profiles, candidates)
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
) -> ServerState:
    """Algorithm-1 initialisation as a :class:`ServerState` on ``device``
    (default ``cuda``; raises without a card).

    Takes the clients' profiles (Alg. 1 lines 2-5) and initial last-known
    losses from the caller, builds the eq.-(14) kernel (through K1 + K2
    with ``cfg.use_pallas_kernel``) and, for a strategy that draws from it
    (or ``strategy=None``, a grid's unknown strategy), the k-DPP spectral
    cache (the one O(C³) eigh), and seeds the server's generator from
    ``cfg.seed``.  For the Cluster baseline it fits the labels on the
    clients' representative gradients, which need ``loss_fn``.  A kernel
    and its cache can be passed in.

    With ``cfg.candidate_frac`` set the kernel, cache and labels come from
    :func:`funnel_fields` on the Q candidates (their prediction drawn from
    a generator seeded from ``cfg.seed`` and the funnel's salt, as
    ``FLTrainer``'s first): this path builds no C × C tensor, and a kernel
    or cache passed in is a ``ValueError``."""
    device = resolve_device(device)
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
        candidates, kernel, eig_state = funnel_fields(
            cfg, salted_generator(cfg.seed, _FUNNEL_SALT, device), profiles, losses, strategy
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
    return ServerState(
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
    )


# ---------------------------------------------------------------- round_fn


def make_round_fn(
    cfg: FLConfig,
    loss_fn: Callable,  # loss_fn(params, x, y) -> scalar
    strategies: Sequence[selection_lib.SelectionStrategy],
    accuracy_fn: Optional[Callable] = None,
    eval_data: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Callable[[ServerState, Any], Tuple[ServerState, Dict[str, Any]]]:
    """The per-round transition ``round_fn(state, _) -> (state, outputs)``.

    Selection through ``strategies[state.strategy_index]`` (one strategy
    for a single run, the method grid for :func:`run_many`), by
    ``select_global_fn``; the cohort's batch plans, the sequential FedAvg
    local updates and eq.-(6) aggregation, then the loss refresh of the
    selected clients under ``torch.no_grad()`` (a forward-only pass),
    topic-GEMD and, every ``cfg.eval_every`` rounds, ``accuracy_fn(params,
    xs, ys)`` on ``eval_data`` or, with None, on the union training set
    (the paper's Fig.-1 protocol).

    ``cfg.scenario`` draws each round's latencies (and availability mask)
    from ``state.env_generator`` before the cohort; a mask restricts the
    draw to available clients.  Outputs: ``round``, ``acc`` (NaN off the
    eval grid or without ``accuracy_fn``), ``gemd``, ``loss`` (the mean
    local loss), ``selected``; with a scenario ``sim_time`` (the slowest
    selected client's latency, the synchronous barrier) and, with an
    availability model, ``avail``; and ``t_select``, ``t_local``,
    ``t_refresh``: host seconds of the three parts, each closed by a device
    synchronise (the scenario's draws count to selection, the accuracy to
    the refresh)."""
    strategies = tuple(strategies)
    if not strategies:
        raise ValueError("make_round_fn needs at least one strategy")
    k = cfg.clients_per_round
    scen = None if cfg.scenario is None else scenarios_lib.get_scenario(cfg.scenario)
    batched_loss = lambda p, batch: loss_fn(p, batch[0], batch[1])

    def clock(device: torch.device) -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    def round_fn(state: ServerState, _=None):
        dev = state.losses.device
        t = state.round + 1
        t0 = clock(dev)
        lat = avail = None
        if scen is not None:
            lat, avail = draw_environment(scen, state.env_generator, t, state.num_clients)
        strategy = strategies[state.strategy_index]
        sel = strategy.select_global_fn(state.generator, state.selection_state(), k, avail).long()
        t1 = clock(dev)
        batches = make_client_batches(cfg, state.generator, state.client_xs, state.client_ys, sel)
        round_step = rounds_lib.build_client_parallel_round(
            batched_loss, cfg.lr, _steps_per_round(cfg, state.client_xs.shape[1]),
            grad_clip=cfg.grad_clip,
        )
        params, mean_loss = round_step(state.params, batches, state.client_sizes[sel])
        t2 = clock(dev)
        # refresh last-known losses for the selected clients
        sel_losses = _losses_of(loss_fn, params, state.client_xs[sel], state.client_ys[sel])
        losses = state.losses.index_put((sel,), sel_losses)
        g = metrics_lib.gemd(
            state.client_label_dists, state.client_sizes, sel, state.global_label_dist
        )
        acc = torch.tensor(float("nan"))
        if accuracy_fn is not None and t % cfg.eval_every == 0:
            if eval_data is not None:
                exs, eys = eval_data
            else:
                exs = state.client_xs.reshape((-1,) + state.client_xs.shape[2:])
                eys = state.client_ys.reshape(-1)
            acc = torch.as_tensor(accuracy_fn(params, exs, eys)).float()
        t3 = clock(dev)
        new_state = dataclasses.replace(state, params=params, round=t, losses=losses)
        out = {
            "round": t,
            "acc": acc,
            "gemd": g.float(),
            "loss": mean_loss.float(),
            "selected": sel.to(torch.int32),
        }
        if scen is not None:
            # the synchronous barrier: the round closes at the slowest
            # selected client (latencies are positive; 0 as JAX's floor)
            out["sim_time"] = torch.clamp_min(torch.amax(lat[sel]), 0.0)
        if avail is not None:
            out["avail"] = avail
        out.update(t_select=t1 - t0, t_local=t2 - t1, t_refresh=t3 - t2)
        return new_state, out

    return round_fn


# ------------------------------------------------------------------ runners


def _stack(outs: List[Dict[str, Any]]) -> Dict[str, torch.Tensor]:
    """Per-round output dicts -> each output stacked on a leading axis, on
    the CPU."""
    return {
        name: torch.stack([torch.as_tensor(o[name]).detach().cpu() for o in outs])
        for name in outs[0]
    }


def run_scanned(
    round_fn, state: ServerState, num_rounds: int
) -> Tuple[ServerState, Dict[str, torch.Tensor]]:
    """Run ``num_rounds`` rounds -> (final state, per-round outputs stacked
    on a leading ``(num_rounds,)`` axis, on the CPU).  JAX compiles the
    rounds into one ``lax.scan``; here they run eagerly in a host loop
    (capturing them as a CUDA graph is later work)."""
    outs: List[Dict[str, Any]] = []
    for _ in range(num_rounds):
        state, out = round_fn(state)
        outs.append(out)
    return state, (_stack(outs) if outs else {})


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
    round_fn, stacked_states: Sequence[ServerState], num_rounds: int
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
    return tuple(finals), {name: torch.stack([o[name] for o in outs]) for name in outs[0]}


def unstack_outputs(outputs: Dict[str, torch.Tensor]) -> List[Dict[str, np.ndarray]]:
    """:func:`run_many` outputs -> one per-run dict of numpy arrays each."""
    if not outputs:
        return []
    n = next(iter(outputs.values())).shape[0]
    return [{name: np.asarray(v[i]) for name, v in outputs.items()} for i in range(n)]


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
