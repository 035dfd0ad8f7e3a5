"""FL round steps: FedAvg local SGD (eq. 3-5) and the eq.-(6) weighted
average, over parameter dicts.

``build_client_parallel_round`` is Mode A of the JAX package in its
``sequential_clients=True`` form: each cohort client runs its E local steps
in turn from the round's global params, then one weighted average forms the
new global params.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.metrics import safe_div
from repro_torch.optim.optimizers import clip_by_global_norm

__all__ = [
    "weighted_average",
    "make_grad_fn",
    "build_local_update",
    "build_client_parallel_round",
]

Params = Dict[str, torch.Tensor]
# loss_fn(params, batch) -> scalar loss
LossFn = Callable[[Params, Tuple[torch.Tensor, ...]], torch.Tensor]


def weighted_average(stacked: Params, weights: torch.Tensor) -> Params:
    """Eq. (6): Σ_c (n_c / Σ n_c) · w_c over the leading client axis,
    computed in fp32 and cast back to each leaf's dtype."""
    w = safe_div(weights, torch.sum(weights)).float()

    def avg(x):
        wb = w.reshape((-1,) + (1,) * (x.ndim - 1))
        return torch.sum(wb * x.float(), dim=0).to(x.dtype)

    return {k: avg(v) for k, v in stacked.items()}


def make_grad_fn(loss_fn: LossFn) -> Callable[[Params, tuple], Tuple[torch.Tensor, Params]]:
    """``grad_fn(params, batch) -> (loss, grad)`` on the full batch."""

    def grad_fn(params: Params, batch: tuple):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(p, batch)
        grads = torch.autograd.grad(loss, list(p.values()))
        return loss.detach(), dict(zip(p, grads))

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
            params = {k: (w - lr * g[k]).to(w.dtype) for k, w in params.items()}
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
        stacked = {k: torch.stack([p[k] for p in new_params]) for k in global_params}
        return weighted_average(stacked, client_weights), torch.mean(torch.stack(losses))

    return round_step
