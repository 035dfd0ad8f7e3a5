"""FL round steps over parameter trees: local SGD (eq. 3-5) under a
registered local-update algorithm, the eq.-(6) weighted average, and the
Mode-B optimizer step.

``build_client_parallel_round`` is Mode A of the JAX package in its
``sequential_clients=True`` form: each cohort client runs its E local steps
in turn from the round's global params, then one weighted average forms the
new global params (after the update guard, when one is given).
``build_server_opt_round`` is FedOpt: the Mode-A round's aggregate taken as
a pseudo-gradient for a server optimizer.  ``build_fedsgd_step`` is Mode B:
one optimizer step on the (micro-batch accumulated) gradient; the pretrain
loop and the dry run run it.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core.metrics import finite_mean, safe_div
from repro_torch.fl.local_algos import FedAvg, make_grad_fn
from repro_torch.optim.optimizers import Optimizer, apply_updates, clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_map

__all__ = [
    "weighted_average",
    "make_grad_fn",
    "build_local_algo_update",
    "build_local_update",
    "build_client_parallel_round",
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


def _write_row(stack: Optional[Params], tree: Params, i: int, m: int) -> Params:
    """Row ``i`` of a tree of ``(m, ...)`` stacks set to ``tree``'s leaves;
    the stacks are allocated at the first row."""
    if stack is None:
        stack = tree_map(lambda x: torch.empty((m,) + tuple(x.shape), dtype=x.dtype, device=x.device), tree)
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
