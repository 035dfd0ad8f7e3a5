"""The federation engine: configuration, batch plans, and the round
transition run as a host loop.

``FLConfig`` keeps every field of the JAX package's config, so a config
reads the same in both packages.  One default differs: ``use_pallas_kernel``
is True here, so a config left as it is builds the eq.-(14) kernel through
the port's K1 + K2 on the card.  ``__post_init__`` refuses the fields whose
features this package does not run yet (mesh slots, staleness, scenarios,
the funnel, faults and robust aggregation, checkpoints, non-FedAvg local
algorithms, telemetry).

The engine is the JAX package's scanned engine on one device, without
those features, for one strategy: :func:`init_server_state`
(Algorithm-1 init into a :class:`ServerState`), :func:`make_round_fn`
(selection, local updates, eq.-(6) aggregation, loss refresh, GEMD; the
JAX ``_single_device_body``), :func:`run_scanned` (JAX's one compiled
``lax.scan``, here a host loop that stacks each round's outputs) and
:func:`history_from_outputs`.  JAX's server key becomes one
``torch.Generator`` that the round draws from, in place: the cohort first,
then the batch plans.  ``FLTrainer`` (``fl/trainer.py``) is the JAX
``run_legacy`` loop and stays beside it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import dpp as dpp_lib
from repro_torch.core import metrics as metrics_lib
from repro_torch.core import selection as selection_lib
from repro_torch.core import similarity as similarity_lib
from repro_torch.device import resolve_device
from repro_torch.fl import rounds as rounds_lib

__all__ = [
    "FLConfig",
    "ServerState",
    "batch_indices_from_keys",
    "batches_from_indices",
    "make_client_batches",
    "init_server_state",
    "make_round_fn",
    "run_scanned",
    "history_from_outputs",
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


# ------------------------------------------------------------- server state


@dataclasses.dataclass(frozen=True)
class ServerState:
    """Everything the server evolves across rounds.

    The JAX package's fields for the features this package runs; the
    fields of the refused ones (cluster labels, staleness ring, funnel
    candidates, quarantine, per-client algorithm state) and the strategy
    index of JAX's multi-strategy ``run_many`` grid are left out.
    ``generator`` takes the place of JAX's carried key: a round draws from
    it in place, so a state and the state a round returns share it."""

    params: Any  # global model (a tree of tensors)
    generator: torch.Generator  # server randomness
    round: int  # rounds completed
    losses: torch.Tensor  # (C,) last-known local losses
    kernel: torch.Tensor  # (C, C) eq.-(14) DPP kernel
    profiles: torch.Tensor  # (C, Q_f) eq.-(11) client profiles
    eig_state: dpp_lib.KDPPSamplerState  # spectral cache of ``kernel``
    client_xs: torch.Tensor  # (C, n_c, ...) simulated client shards
    client_ys: torch.Tensor  # (C, n_c)
    client_sizes: torch.Tensor  # (C,) n_c
    client_label_dists: torch.Tensor  # (C, num_classes)
    global_label_dist: torch.Tensor  # (num_classes,)

    def selection_state(self) -> selection_lib.SelectionState:
        """The per-round draw's input: kernel, losses, sizes and the cache
        (and the neutral cluster labels: the engine runs no Cluster
        baseline)."""
        return selection_lib.selection_state(
            self.losses.shape[0], self.eig_state.k, kernel=self.kernel,
            losses=self.losses, client_sizes=self.client_sizes, eig_state=self.eig_state,
        )


@torch.no_grad()
def _losses_of(loss_fn: Callable, params, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Per-client loss over each client's whole shard: (M, n_c, ...) -> (M,).
    Under ``torch.no_grad()``: a forward-only pass (K6 may take it)."""
    return torch.stack([loss_fn(params, x, y) for x, y in zip(xs, ys)])


def init_server_state(
    cfg: FLConfig,
    params,
    client_xs,
    client_ys,
    profiles: torch.Tensor,
    losses: torch.Tensor,
    strategy: selection_lib.SelectionStrategy,
    device: Optional[Union[str, torch.device]] = None,
) -> ServerState:
    """Algorithm-1 initialisation as a :class:`ServerState` on ``device``
    (default ``cuda``; raises without a card).

    Takes the clients' profiles (Alg. 1 lines 2-5) and initial last-known
    losses from the caller, builds the eq.-(14) kernel (through K1 + K2
    with ``cfg.use_pallas_kernel``) and, for a strategy that draws from it,
    the k-DPP spectral cache (the one O(C³) eigh), and seeds the server's
    generator from ``cfg.seed``.  The Cluster baseline is refused: its
    labels, fitted here in the JAX engine, are not ported to the engine
    (``FLTrainer`` runs it)."""
    if isinstance(strategy, selection_lib.ClusterSelection):
        raise NotImplementedError(
            "the engine's cluster labels (ServerState.cluster_labels) are not "
            "ported yet; FLTrainer runs the Cluster baseline"
        )
    device = resolve_device(device)
    client_xs = torch.as_tensor(client_xs, device=device)
    client_ys = torch.as_tensor(client_ys, device=device)
    c, n_c = client_xs.shape[0], client_xs.shape[1]
    profiles = torch.as_tensor(profiles, device=device)
    kernel = similarity_lib.kernel_from_profiles(profiles, use_kernel=cfg.use_pallas_kernel)
    if strategy.uses_spectral_cache:
        eig_state = dpp_lib.kdpp_sampler_state(kernel, cfg.clients_per_round)
    else:
        eig_state = dpp_lib.identity_sampler_state(c, cfg.clients_per_round, device)
    return ServerState(
        params=params,
        generator=torch.Generator(device=device).manual_seed(cfg.seed),
        round=0,
        losses=torch.as_tensor(losses, device=device),
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
    )


# ---------------------------------------------------------------- round_fn


def make_round_fn(
    cfg: FLConfig,
    loss_fn: Callable,  # loss_fn(params, x, y) -> scalar
    strategy: selection_lib.SelectionStrategy,
) -> Callable[[ServerState, Any], Tuple[ServerState, Dict[str, Any]]]:
    """The per-round transition ``round_fn(state, _) -> (state, outputs)``.

    Selection through ``strategy``, the cohort's batch plans, the
    sequential FedAvg local updates and eq.-(6) aggregation, then the loss
    refresh of the selected clients under ``torch.no_grad()`` (a
    forward-only pass) and topic-GEMD.  Outputs: ``round``, ``acc`` (NaN:
    the LM path evaluates no accuracy, as JAX's launcher passes no
    ``accuracy_fn``), ``gemd``, ``loss`` (the mean local loss),
    ``selected``, and ``t_select``, ``t_local``, ``t_refresh``: host
    seconds of the three parts, each closed by a device synchronise."""
    k = cfg.clients_per_round
    batched_loss = lambda p, batch: loss_fn(p, batch[0], batch[1])

    def clock(device: torch.device) -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    def round_fn(state: ServerState, _=None):
        dev = state.losses.device
        t0 = clock(dev)
        sel = strategy.draw_fn(state.generator, state.selection_state(), k).long()
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
        t3 = clock(dev)
        g = metrics_lib.gemd(
            state.client_label_dists, state.client_sizes, sel, state.global_label_dist
        )
        t = state.round + 1
        new_state = dataclasses.replace(state, params=params, round=t, losses=losses)
        out = {
            "round": t,
            "acc": float("nan"),
            "gemd": g.float(),
            "loss": mean_loss.float(),
            "selected": sel.to(torch.int32),
            "t_select": t1 - t0,
            "t_local": t2 - t1,
            "t_refresh": t3 - t2,
        }
        return new_state, out

    return round_fn


# ------------------------------------------------------------------ runner


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
    if not outs:
        return state, {}
    stacked = {
        name: torch.stack([torch.as_tensor(o[name]).detach().cpu() for o in outs])
        for name in outs[0]
    }
    return state, stacked


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
