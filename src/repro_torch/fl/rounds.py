"""FL round steps over parameter trees: local SGD (eq. 3-5) under a
registered local-update algorithm, the eq.-(6) weighted average, and the
Mode-B optimizer step.

``build_client_parallel_round`` is Mode A of the JAX package in its
``sequential_clients=True`` form: each cohort client runs its E local steps
in turn from the round's global params, then one weighted average forms the
new global params (after the update guard, when one is given).
``build_shard_cohort_round`` and ``build_stale_shard_cohort_round`` are the
round of one rank of a client mesh (``launch/mesh.py``): local updates for
the rank's resident clients, then eq. (6) as partial weighted sums that one
all-reduce combines with every other partial the round needs.
``build_server_opt_round`` is FedOpt: the Mode-A round's aggregate taken as
a pseudo-gradient for a server optimizer.  ``build_fedsgd_step`` is Mode B:
one optimizer step on the (micro-batch accumulated) gradient; the pretrain
loop and the dry run run it.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch
from torch.distributed.tensor import Shard

from repro_torch.core.metrics import finite_mean, safe_div
from repro_torch.fl.local_algos import FedAvg, make_grad_fn
from repro_torch.launch.sharding import from_local_like, is_dtensor
from repro_torch.optim.optimizers import Optimizer, apply_updates, clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = [
    "weighted_average",
    "make_grad_fn",
    "build_local_algo_update",
    "build_local_update",
    "build_client_parallel_round",
    "build_shard_cohort_round",
    "build_stale_shard_cohort_round",
    "build_server_opt_round",
    "build_fedsgd_step",
]

Params = Any  # a tree of tensors
# loss_fn(params, batch) -> scalar loss
LossFn = Callable[[Params, Tuple[torch.Tensor, ...]], torch.Tensor]


def weighted_average(stacked: Params, weights: torch.Tensor) -> Params:
    """Eq. (6): Σ_c (n_c / Σ n_c) · w_c over the leading client axis,
    computed in fp32 and cast back to each leaf's dtype."""
    w = safe_div(weights, torch.sum(weights)).float()

    def avg(x):
        wb = w.reshape((-1,) + (1,) * (x.ndim - 1))
        return torch.sum(wb * x.float(), dim=0).to(x.dtype)

    return tree_map(avg, stacked)


def build_local_algo_update(
    algo, loss_fn: LossFn, lr: float, grad_clip: Optional[float] = None, micro_batches: int = 1
) -> Callable:
    """One client's local steps under a registered algorithm
    (``fl/local_algos.py``; ``None`` is FedAvg): one SGD step ``w − lr·g``
    per leading entry of the batch leaves, ``g`` the gradient (accumulated
    over ``micro_batches`` slices of the step's batch) with the
    algorithm's per-step term folded in (and optionally clipped by global
    norm).  The entry params are the anchor every drift term measures
    against.  Two signatures, by ``algo.stateful``:

    * stateless: ``local_update(params, steps_batch) -> (params, losses)``;
    * stateful: ``local_update(params, client_state, steps_batch) ->
      (params, new_client_state, losses)``, the state constant during the
      steps and evolved once by ``algo.finalize`` after the last."""
    if algo is None:
        algo = FedAvg()
    bound = algo.bind(loss_fn, lr, grad_clip, micro_batches)

    def run_steps(params: Params, client_state, anchor: Params, steps_batch: tuple):
        losses = []
        for s in range(steps_batch[0].shape[0]):
            params, _, loss = bound.step(params, client_state, anchor, tuple(x[s] for x in steps_batch))
            losses.append(loss)
        return params, torch.stack(losses)

    if not algo.stateful:

        def local_update(params: Params, steps_batch: tuple):
            return run_steps(params, (), params, steps_batch)

        return local_update

    def stateful_local_update(params: Params, client_state, steps_batch: tuple):
        new_params, losses = run_steps(params, client_state, params, steps_batch)
        return new_params, algo.finalize(new_params, client_state, params), losses

    return stateful_local_update


def build_local_update(
    loss_fn: LossFn, lr: float, grad_clip: Optional[float] = None
) -> Callable[[Params, tuple], Tuple[Params, torch.Tensor]]:
    """One client's FedAvg local update: ``local_update(params, steps_batch)
    -> (params, losses)``, :func:`build_local_algo_update` with FedAvg."""
    return build_local_algo_update(None, loss_fn, lr, grad_clip=grad_clip)


def _empty_stack(x: torch.Tensor, m: int) -> torch.Tensor:
    """An uninitialised ``(m, *x.shape)`` stack of ``x``'s dtype; of a
    DTensor ``x``, a DTensor laid out as ``x`` with the new leading dim
    replicated (the sharded dry run's client bodies)."""
    if not is_dtensor(x):
        return torch.empty((m,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    local = x.to_local()
    place = tuple(Shard(p.dim + 1) if p.is_shard() else p for p in x.placements)
    return from_local_like(torch.empty((m,) + tuple(local.shape), dtype=x.dtype, device=local.device), x.device_mesh,
                           place, (m,) + tuple(x.shape))


def _write_row(stack: Optional[Params], tree: Params, i: int, m: int) -> Params:
    """Row ``i`` of a tree of ``(m, ...)`` stacks set to ``tree``'s leaves;
    the stacks are allocated at the first row."""
    if stack is None:
        stack = tree_map(lambda x: _empty_stack(x, m), tree)
    for row, x in zip(tree_leaves(stack), tree_leaves(tree)):
        row[i].copy_(x)
    return stack


def build_client_parallel_round(
    loss_fn: LossFn,
    lr: float,
    local_steps: int,
    grad_clip: Optional[float] = None,
    update_transform: Optional[Callable] = None,
    algo=None,
    micro_batches: int = 1,
) -> Callable[..., tuple]:
    """Mode A round step, clients one after another.

    ``round_step(global_params, client_batches, client_weights)`` where every
    leaf of ``client_batches`` has leading shape ``(C_p, local_steps, ...)``
    and ``client_weights`` is ``(C_p,)`` (= n_c).  Returns the aggregated
    global params (eq. 6) and the mean local loss.

    ``update_transform`` is the fault-injection and update-validation guard
    of ``fl/faults.make_update_guard``, applied between the local updates
    and the weighted sum: ``round_step(global_params, client_batches,
    client_weights, *guard_args)`` then returns ``(agg, mean_loss, flagged,
    survivors)``: the mean over the finite losses of the clients left in
    the sum, the clients the guard flagged, and how many were left.

    ``algo`` is the local-update algorithm (``None``: FedAvg).  A stateful
    one takes the keyword ``client_states`` (leaves leading ``(C_p, ...)``)
    and appends the clients' new states to the return; the caller writes
    back the ones whose update it keeps.

    ``micro_batches`` accumulates each local step's gradient over that many
    slices of the client's batch (exact, ``local_algos.make_grad_fn``).
    """
    local_update = build_local_algo_update(algo, loss_fn, lr, grad_clip=grad_clip, micro_batches=micro_batches)
    stateful = algo is not None and algo.stateful

    def round_step(
        global_params: Params, client_batches: tuple, client_weights: torch.Tensor, *guard_args,
        client_states=None,
    ):
        if client_batches[0].shape[1] != local_steps:
            raise ValueError(
                f"client batches hold {client_batches[0].shape[1]} steps, "
                f"the round runs {local_steps}"
            )
        m = client_weights.shape[0]
        stacked = new_states = None
        losses = []
        for i in range(m):
            batch = tuple(x[i] for x in client_batches)
            if stateful:
                p, st, l = local_update(global_params, tree_map(lambda s: s[i], client_states), batch)
                new_states = _write_row(new_states, st, i, m)
            else:
                p, l = local_update(global_params, batch)
            # each client's params go into the (C_p, ...) stack as they come,
            # and its own copy is dropped before the next client trains
            stacked = _write_row(stacked, p, i, m)
            del p
            losses.append(l)
        losses = torch.stack(losses)
        out = (new_states,) if stateful else ()
        if update_transform is None:
            return (weighted_average(stacked, client_weights), torch.mean(losses)) + out
        stacked, w, losses, flagged = update_transform(
            stacked, global_params, client_weights, losses, *guard_args
        )
        entry = torch.mean(losses, dim=tuple(range(1, losses.ndim)))
        mean_loss = finite_mean(entry, where=w > 0)
        survivors = torch.sum((w > 0).to(torch.int32))
        return (weighted_average(stacked, w), mean_loss, flagged, survivors) + out

    return round_step


def _local_updates(local_update, stateful: bool, global_params: Params, batches: tuple, n: int, states=None):
    """``n`` clients' local updates in turn from ``global_params`` ->
    ``(stacked params (n, ...), losses (n, steps), stacked new states or
    None)``; each client's own copy is dropped once it is in the stack."""
    stacked = new_states = None
    losses = []
    for i in range(n):
        batch = tuple(x[i] for x in batches)
        if stateful:
            p, st, l = local_update(global_params, tree_map(lambda s: s[i], states), batch)
            new_states = _write_row(new_states, st, i, n)
        else:
            p, l = local_update(global_params, batch)
        stacked = _write_row(stacked, p, i, n)
        del p
        losses.append(l)
    return stacked, torch.stack(losses), new_states


def _all_reduce_sums(mesh, parts: list) -> list:
    """Every tensor of ``parts`` summed over the mesh's ranks through ONE
    all-reduce of their fp32 concatenation -> the sums, each in its own
    shape and in fp32."""
    flat = torch.cat([p.reshape(-1).float() for p in parts])
    mesh.all_reduce(flat)
    out, at = [], 0
    for p in parts:
        out.append(flat[at:at + p.numel()].reshape(p.shape))
        at += p.numel()
    return out


def build_shard_cohort_round(
    loss_fn: LossFn,
    lr: float,
    mesh,
    grad_clip: Optional[float] = None,
    cap: Optional[int] = None,
    update_transform: Optional[Callable] = None,
    algo=None,
) -> Callable[..., tuple]:
    """The Mode-A round of ONE rank of a client mesh (``launch/mesh.py``):
    local updates only for clients resident on this rank, then eq. (6) as
    this rank's partial weighted sums ``Σ_c w_c·θ_c`` and ``Σ_c w_c``, which
    ``mesh.all_reduce`` combines across the ranks.  The parameter tree is
    never gathered; every partial the round needs (the params' sums, the
    weight sum, the cohort loss total and count, the caller's ``extras``,
    and under the guard the survivor count and the flags) rides the same
    ONE all-reduce, JAX's single ``psum``.

    Two modes, by ``cap``:

    * ``cap=None`` (resident): ``round_step(global_params, local_batches,
      local_weights, extras=None)``, leaves of ``local_batches`` leading
      ``(C_loc, local_steps, ...)`` and ``local_weights`` (C_loc,), 0 for a
      resident outside the round's cohort.  Every resident runs its local
      update, weight 0 or not, as JAX's does.
    * ``cap=int`` (capacity slots): ``slot_round_step(global_params,
      slot_batches, local_weights, slot_index, extras=None)``: the caller
      packs the rank's (at most ``cap``) cohort residents into slots
      (``slot_index``, (cap,) distinct local positions, cohort members
      first; padding slots point at other residents and get weight 0), and
      only the slots train.  Slot losses are scattered back to resident
      layout.

    Both return ``(agg_params, client_losses, mean_loss, extras)``: the
    aggregate (the same on every rank), the per-resident losses (C_loc,)
    (mean over local steps; NaN for every resident outside the cohort, so
    an unselected client's loss never reads as a cohort measurement), the
    cohort's mean local loss, and ``extras`` (a tree of tensors) summed
    over the ranks.

    ``update_transform`` is the update guard (``fl/faults.make_update_guard``):
    both steps then take ``guard_args`` (the fault masks in the rows'
    layout: resident or slot), apply the guard between the local updates
    and the partial sums, so a rejected update never leaves its rank, and
    return ``(agg, client_losses, mean_loss, extras, flagged, survivors)``
    with ``flagged`` in resident layout.  With ``flag_span=(lo, C)`` the
    flags of all ranks ride the all-reduce too (this rank's at
    ``[lo, lo + C_loc)``), and ``flagged`` is the whole (C,) vector.

    ``algo`` is the local-update algorithm (``None``: FedAvg).  A stateful
    one takes ``local_states`` (the rank's resident-layout states, leaves
    leading ``(C_loc, ...)``) and appends the candidate new states (same
    layout; in slot mode the trained slots scattered back, other residents
    keeping theirs) to the return.  Per-rank state, never all-reduced: the
    caller writes back the ones whose update it keeps."""
    local_update = build_local_algo_update(algo, loss_fn, lr, grad_clip=grad_clip)
    stateful = algo is not None and algo.stateful

    def aggregate(stacked, losses, weights, extras, survivors_local=None, flags=None):
        w = weights.float()
        mask = w > 0
        entry = torch.mean(losses, dim=tuple(range(1, losses.ndim)))
        # only finite cohort entries enter the loss total (where, never
        # mask·x: 0·NaN = NaN); no finite entry reports NaN, not 0
        ok = mask & torch.isfinite(entry)
        partials = [
            torch.sum(w.reshape((-1,) + (1,) * (x.ndim - 1)) * x.float(), dim=0) for x in tree_leaves(stacked)
        ]
        ex_leaves = [] if extras is None else tree_leaves(extras)
        parts = partials + [
            torch.sum(w), torch.sum(torch.where(ok, entry, torch.zeros((), dtype=entry.dtype, device=entry.device))),
            torch.sum(ok.float()),
        ] + list(ex_leaves)
        if survivors_local is not None:
            parts.append(survivors_local)
        if flags is not None:
            parts.append(flags)
        sums = _all_reduce_sums(mesh, parts)
        n_p = len(partials)
        wsum, tot, cnt = sums[n_p:n_p + 3]
        inv = safe_div(torch.ones((), dtype=torch.float32, device=wsum.device), wsum)
        agg = tree_unflatten(
            stacked, [(part * inv).to(x.dtype) for part, x in zip(sums[:n_p], tree_leaves(stacked))]
        )
        mean_loss = torch.where(cnt > 0, tot / torch.clamp_min(cnt, 1.0), torch.full_like(tot, float("nan")))
        masked = torch.where(mask, entry, torch.full_like(entry, float("nan")))
        at = n_p + 3 + len(ex_leaves)
        red_extras = None if extras is None else tree_unflatten(
            extras, [s.to(x.dtype) for s, x in zip(sums[n_p + 3:at], ex_leaves)]
        )
        rest = sums[at:]
        return agg, masked, mean_loss, red_extras, rest

    def flag_row(flagged: torch.Tensor, flag_span):
        """This rank's resident flags placed in the (C,) vector of all."""
        lo, c = flag_span
        full = torch.zeros((c,), dtype=torch.float32, device=flagged.device)
        full[lo:lo + flagged.shape[0]] = flagged.float()
        return full

    def guarded_tail(agg, masked, mean_loss, red, rest, flagged, flag_span):
        survivors = rest[0].round().to(torch.int32)
        if flag_span is not None:
            flagged = rest[1] > 0.5
        return (agg, masked, mean_loss, red, flagged, survivors)

    def round_step(
        global_params, local_batches, local_weights, extras=None, guard_args=(), local_states=None,
        flag_span: Optional[Tuple[int, int]] = None,
    ):
        n = local_weights.shape[0]
        stacked, losses, new_states = _local_updates(
            local_update, stateful, global_params, local_batches, n, local_states
        )
        tail = (new_states,) if stateful else ()
        if update_transform is None:
            agg, masked, mean_loss, red, _ = aggregate(stacked, losses, local_weights, extras)
            return (agg, masked, mean_loss, red) + tail
        stacked, w, losses, flagged = update_transform(stacked, global_params, local_weights, losses, *guard_args)
        surv = torch.sum((w > 0).float())
        flags = None if flag_span is None else flag_row(flagged, flag_span)
        agg, masked, mean_loss, red, rest = aggregate(stacked, losses, w, extras, surv, flags)
        return guarded_tail(agg, masked, mean_loss, red, rest, flagged, flag_span) + tail

    def slot_round_step(
        global_params, slot_batches, local_weights, slot_index, extras=None, guard_args=(),
        local_states=None, flag_span: Optional[Tuple[int, int]] = None,
    ):
        idx = slot_index.long()
        slot_states = tree_map(lambda s: s[idx], local_states) if stateful else None
        stacked, losses, new_slot_states = _local_updates(
            local_update, stateful, global_params, slot_batches, cap, slot_states
        )
        tail = ()
        if stateful:
            # trained slots scattered back; residents no slot covered keep
            # their state (their write-back mask is False anyway)
            tail = (tree_map(lambda full, new: full.index_put((idx,), new), local_states, new_slot_states),)
        slot_weights = local_weights[idx]
        if update_transform is not None:
            stacked, slot_weights, losses, slot_flagged = update_transform(
                stacked, global_params, slot_weights, losses, *guard_args
            )
            surv = torch.sum((slot_weights > 0).float())
            # padding slots carry weight 0, so they are never flagged and the
            # scatter to resident layout has no collisions
            flagged = torch.zeros(local_weights.shape, dtype=torch.bool, device=idx.device).index_put(
                (idx,), slot_flagged
            )
            flags = None if flag_span is None else flag_row(flagged, flag_span)
            agg, slot_losses, mean_loss, red, rest = aggregate(stacked, losses, slot_weights, extras, surv, flags)
        else:
            agg, slot_losses, mean_loss, red, _ = aggregate(stacked, losses, slot_weights, extras)
        # slot losses scattered back; what no slot covered (and weight-0
        # padding slots) stays NaN by the convention
        client_losses = torch.full(
            local_weights.shape, float("nan"), dtype=slot_losses.dtype, device=slot_losses.device
        ).index_put((idx,), slot_losses)
        if update_transform is None:
            return (agg, client_losses, mean_loss, red) + tail
        return guarded_tail(agg, client_losses, mean_loss, red, rest, flagged, flag_span) + tail

    return round_step if cap is None else slot_round_step


def build_stale_shard_cohort_round(
    loss_fn: LossFn,
    lr: float,
    mesh,
    grad_clip: Optional[float] = None,
    update_transform: Optional[Callable] = None,
    algo=None,
) -> Callable[..., tuple]:
    """The bounded-staleness form of :func:`build_shard_cohort_round`'s
    resident round: the same residents, local updates and one all-reduce,
    started from this rank's stale params.

    ``round_step(param_hist, read_slot, stale_scale, local_batches,
    local_weights, extras=None)``: ``param_hist`` is the ring of global
    param snapshots (``fl/staleness.py``, leaves leading ``(s+1, ...)``),
    ``read_slot`` this rank's ring index (the round-``t − s_d`` params) and
    ``stale_scale`` its decay weight λ(s_d) > 0.  The rank trains from the
    ring's params and contributes partial sums with weights ``λ·w_c``; the
    all-reduced ``Σ λw`` normalises them, so the aggregate is a convex
    combination across ranks of different staleness.  With ``read_slot`` at
    the current round and ``stale_scale = 1`` this is the synchronous round
    bit for bit.  The guard's base params and a drift-correcting algorithm's
    anchor are the stale read: the params the clients trained from."""
    inner = build_shard_cohort_round(
        loss_fn, lr, mesh, grad_clip=grad_clip, update_transform=update_transform, algo=algo,
    )

    def round_step(
        param_hist, read_slot, stale_scale, local_batches, local_weights, extras=None, guard_args=(),
        local_states=None, flag_span: Optional[Tuple[int, int]] = None,
    ):
        slot = int(read_slot)
        base = tree_map(lambda h: h[slot], param_hist)
        kw = dict(extras=extras, local_states=local_states)
        if update_transform is not None:
            kw.update(guard_args=guard_args, flag_span=flag_span)
        return inner(base, local_batches, local_weights * stale_scale, **kw)

    return round_step


def build_server_opt_round(
    loss_fn: LossFn,
    client_lr: float,
    local_steps: int,
    server_optimizer: Optimizer,
    grad_clip: Optional[float] = None,
) -> Callable[[Params, Any, tuple, torch.Tensor], Tuple[Params, Any, torch.Tensor]]:
    """FedOpt (Reddi et al.) on top of the Mode-A round: the eq.-(6)
    aggregate becomes the pseudo-gradient ``Δ = w_global − avg(w_clients)``
    in fp32, and the server optimizer (``optim.sgd/adam/adafactor``) steps
    the global params with it.  ``round_step(params, server_state,
    client_batches, client_weights) -> (params, server_state, loss)``.
    Server SGD with lr 1 is plain FedAvg."""
    inner = build_client_parallel_round(loss_fn, client_lr, local_steps, grad_clip)

    def round_step(params: Params, server_state, client_batches: tuple, client_weights: torch.Tensor):
        agg, loss = inner(params, client_batches, client_weights)
        pseudo_grad = tree_map(lambda w, a: w.float() - a.float(), params, agg)
        updates, server_state = server_optimizer.update(pseudo_grad, server_state, params)
        return apply_updates(params, updates), server_state, loss

    return round_step


def build_fedsgd_step(
    loss_fn: LossFn,
    optimizer: Optimizer,
    grad_clip: Optional[float] = None,
    micro_batches: int = 1,
) -> Callable[[Params, Any, Any], Tuple[Params, Any, torch.Tensor]]:
    """Mode B step: ``step(params, opt_state, batch) -> (params, opt_state,
    loss)``, one optimizer step on the gradient of ``loss_fn(params,
    batch)``.  ``micro_batches`` splits every leaf of the batch along its
    leading axis and averages the slices' losses and fp32 gradients
    (exact for a mean loss over equal slices)."""
    grad_of = make_grad_fn(loss_fn, micro_batches)

    def step(params: Params, opt_state, batch):
        loss, g = grad_of(params, batch)
        if grad_clip is not None:
            g = clip_by_global_norm(g, grad_clip)
        updates, opt_state = optimizer.update(g, opt_state, params)
        return apply_updates(params, updates), opt_state, loss

    return step
