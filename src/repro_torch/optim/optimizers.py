"""Functional optimizers over parameter trees (dicts, lists and tuples of
tensors), with the JAX package's optax-shaped API::

    opt = adam(3e-4)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

``sgd`` is the FL-local optimizer (paper eq. 3-4).  ``adam`` is the
pretrain optimizer of the dense configs; ``adafactor`` keeps factored
second moments for >= 2-D tensors.  Moments and updates are fp32 whatever
the parameters' dtype; ``apply_updates`` casts back.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = [
    "Optimizer",
    "apply_updates",
    "clip_by_global_norm",
    "sgd",
    "adam",
    "adamw",
    "adafactor",
]

Params = Any  # a tree of tensors


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def apply_updates(params: Params, updates: Params) -> Params:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def clip_by_global_norm(grads: Params, max_norm: float) -> Params:
    """Scale every gradient by ``min(1, max_norm / ‖g‖)``, ‖g‖ over all
    leaves in fp32; a low-precision gradient comes back in fp32, as the
    JAX package's does."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp_min(gn, 1e-12), max=1.0)
    return tree_map(lambda g: g.to(torch.promote_types(g.dtype, scale.dtype)) * scale, grads)


def sgd(lr: float, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    """SGD with optional (Nesterov) momentum; ``update`` returns the
    additive updates and the new state."""

    def init(params: Params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads: Params, state, params=None):
        if momentum == 0.0:
            return tree_map(lambda g: -lr * g, grads), ()
        new_m = tree_map(lambda m, g: momentum * m + g, state, grads)
        if nesterov:
            upd = tree_map(lambda m, g: -lr * (momentum * m + g), new_m, grads)
        else:
            upd = tree_map(lambda m: -lr * m, new_m)
        return upd, new_m

    return Optimizer(init, update)


def _step0(params: Params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


def _zeros32(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


class AdamState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: Params  # fp32 first moments
    nu: Params  # fp32 second moments


def adam(
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    """Adam with bias correction; ``weight_decay`` adds decoupled decay
    ``-lr * wd * p`` (AdamW) when ``update`` is given the params."""

    def init(params: Params) -> AdamState:
        zeros = lambda p: _zeros32(p.shape, p)
        return AdamState(_step0(params), tree_map(zeros, params), tree_map(zeros, params))

    def update(grads: Params, state: AdamState, params: Optional[Params] = None):
        step = state.step + 1
        g32 = tree_map(lambda g: g.float(), grads)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, g32)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, g32)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()

        def upd(m, v, p=None):
            u = -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay and p is not None:
                u = u - lr * weight_decay * p.float()
            return u

        if weight_decay and params is not None:
            updates = tree_map(upd, mu, nu, params)
        else:
            updates = tree_map(upd, mu, nu)
        return updates, AdamState(step, mu, nu)

    return Optimizer(init, update)


def adamw(lr: float, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


class AdafactorState(NamedTuple):
    step: torch.Tensor  # () int32
    vr: Params  # row second moments (the full v for < 2-D tensors)
    vc: Params  # column second moments (a () zero for < 2-D tensors)


def adafactor(
    lr: float = 1e-2,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
) -> Optimizer:
    """Adafactor (Shazeer & Stern) with factored second moments for >= 2-D
    tensors: O(n + m) state instead of O(n * m)."""

    def init(params: Params) -> AdafactorState:
        def vr_init(p):
            return _zeros32(p.shape[:-1] if p.ndim >= 2 else p.shape, p)

        def vc_init(p):
            return _zeros32(p.shape[:-2] + p.shape[-1:] if p.ndim >= 2 else (), p)

        return AdafactorState(_step0(params), tree_map(vr_init, params), tree_map(vc_init, params))

    def update(grads: Params, state: AdafactorState, params: Optional[Params] = None):
        step = state.step + 1
        beta = 1.0 - step.float() ** (-decay)

        def upd(g, vr, vc):
            g = g.float()
            g2 = g * g + eps
            if g.ndim >= 2:
                vr_n = beta * vr + (1 - beta) * torch.mean(g2, dim=-1)
                vc_n = beta * vc + (1 - beta) * torch.mean(g2, dim=-2)
                r = vr_n / torch.clamp_min(torch.mean(vr_n, dim=-1, keepdim=True), eps)
                v = r[..., None] * vc_n[..., None, :]
            else:
                vr_n = beta * vr + (1 - beta) * g2
                vc_n = vc
                v = vr_n
            u = g / torch.sqrt(torch.clamp_min(v, eps))
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            return -lr * u, vr_n, vc_n

        out = [
            upd(g, vr, vc)
            for g, vr, vc in zip(tree_leaves(grads), tree_leaves(state.vr), tree_leaves(state.vc))
        ]
        updates, vr, vc = (tree_unflatten(grads, [o[i] for o in out]) for i in range(3))
        return updates, AdafactorState(step, vr, vc)

    return Optimizer(init, update)
