"""FL round steps over parameter trees: FedAvg local SGD (eq. 3-5), the
eq.-(6) weighted average, and the Mode-B optimizer step.

``build_client_parallel_round`` is Mode A of the JAX package in its
``sequential_clients=True`` form: each cohort client runs its E local steps
in turn from the round's global params, then one weighted average forms the
new global params.  ``build_fedsgd_step`` is Mode B: one optimizer step on
the (micro-batch accumulated) gradient; the pretrain loop runs it.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core.metrics import safe_div
from repro_torch.optim.optimizers import Optimizer, apply_updates, clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = [
    "weighted_average",
    "make_grad_fn",
    "build_local_update",
    "build_client_parallel_round",
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


def make_grad_fn(loss_fn: LossFn) -> Callable[[Params, tuple], Tuple[torch.Tensor, Params]]:
    """``grad_fn(params, batch) -> (loss, grad)`` on the full batch."""

    def grad_fn(params: Params, batch: tuple):
        live = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
        loss = loss_fn(tree_unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live)
        return loss.detach(), tree_unflatten(params, grads)

    return grad_fn


def build_local_update(
    loss_fn: LossFn, lr: float, grad_clip: Optional[float] = None
) -> Callable[[Params, tuple], Tuple[Params, torch.Tensor]]:
    """One client's FedAvg local update: ``local_update(params, steps_batch)
    -> (params, losses)`` runs one SGD step ``w − lr·g`` (g optionally
    clipped by global norm) per leading entry of the batch leaves."""
    grad_fn = make_grad_fn(loss_fn)

    def local_update(params: Params, steps_batch: tuple):
        losses = []
        for s in range(steps_batch[0].shape[0]):
            loss, g = grad_fn(params, tuple(x[s] for x in steps_batch))
            if grad_clip is not None:
                g = clip_by_global_norm(g, grad_clip)
            params = tree_map(lambda w, gw: (w - lr * gw).to(w.dtype), params, g)
            losses.append(loss)
        return params, torch.stack(losses)

    return local_update


def build_client_parallel_round(
    loss_fn: LossFn, lr: float, local_steps: int, grad_clip: Optional[float] = None
) -> Callable[[Params, tuple, torch.Tensor], Tuple[Params, torch.Tensor]]:
    """Mode A round step, clients one after another.

    ``round_step(global_params, client_batches, client_weights)`` where every
    leaf of ``client_batches`` has leading shape ``(C_p, local_steps, ...)``
    and ``client_weights`` is ``(C_p,)`` (= n_c).  Returns the aggregated
    global params (eq. 6) and the mean local loss.
    """
    local_update = build_local_update(loss_fn, lr, grad_clip=grad_clip)

    def round_step(global_params: Params, client_batches: tuple, client_weights: torch.Tensor):
        if client_batches[0].shape[1] != local_steps:
            raise ValueError(
                f"client batches hold {client_batches[0].shape[1]} steps, "
                f"the round runs {local_steps}"
            )
        new_params, losses = [], []
        for i in range(client_weights.shape[0]):
            p, l = local_update(global_params, tuple(x[i] for x in client_batches))
            new_params.append(p)
            losses.append(l)
        stacked = tree_map(lambda *xs: torch.stack(xs), *new_params)
        return weighted_average(stacked, client_weights), torch.mean(torch.stack(losses))

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
    grad_fn = make_grad_fn(loss_fn)

    def grad_of(params: Params, batch):
        if micro_batches == 1:
            return grad_fn(params, batch)
        micro = tree_map(
            lambda x: x.reshape((micro_batches, x.shape[0] // micro_batches) + x.shape[1:]), batch
        )
        tot_l = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
        tot_g = tree_map(lambda w: torch.zeros(w.shape, dtype=torch.float32, device=w.device), params)
        for i in range(micro_batches):
            l, g = grad_fn(params, tree_map(lambda x: x[i], micro))
            tot_l = tot_l + l
            tot_g = tree_map(torch.add, tot_g, g)
        inv = 1.0 / micro_batches
        return tot_l * inv, tree_map(lambda x: x * inv, tot_g)

    def step(params: Params, opt_state, batch):
        loss, g = grad_of(params, batch)
        if grad_clip is not None:
            g = clip_by_global_norm(g, grad_clip)
        updates, opt_state = optimizer.update(g, opt_state, params)
        return apply_updates(params, updates), opt_state, loss

    return step
