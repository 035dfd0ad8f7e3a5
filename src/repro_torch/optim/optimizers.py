"""Functional optimizers over parameter dicts: plain SGD and global-norm
clipping, the two the FedAvg local update uses."""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

__all__ = ["Optimizer", "clip_by_global_norm", "sgd"]

Params = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def clip_by_global_norm(grads: Params, max_norm: float) -> Params:
    """Scale every gradient by ``min(1, max_norm / ‖g‖)``, ‖g‖ over all leaves."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp_min(gn, 1e-12), max=1.0)
    return {k: g * scale for k, g in grads.items()}


def sgd(lr: float, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    """SGD with optional (Nesterov) momentum; ``update`` returns the
    additive updates and the new state."""

    def init(params: Params):
        if momentum == 0.0:
            return ()
        return {k: torch.zeros_like(v) for k, v in params.items()}

    def update(grads: Params, state, params=None):
        if momentum == 0.0:
            return {k: -lr * g for k, g in grads.items()}, ()
        new_m = {k: momentum * state[k] + g for k, g in grads.items()}
        if nesterov:
            upd = {k: -lr * (momentum * new_m[k] + g) for k, g in grads.items()}
        else:
            upd = {k: -lr * m for k, m in new_m.items()}
        return upd, new_m

    return Optimizer(init, update)
