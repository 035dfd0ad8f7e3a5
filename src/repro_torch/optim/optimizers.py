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

from typing import Any, Callable, List, NamedTuple, Optional, Union

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
    vr: Any  # row second moments (the full v for < 2-D tensors), one per leaf or group
    vc: Any  # column second moments (a () zero for < 2-D tensors), one per leaf or group


# leaf indices (``tree_leaves`` order) grouped into the leaves adafactor
# factors and clips: an int is a leaf alone, a list the leaves stacked along
# a new first axis as one leaf
Groups = List[Union[int, List[int]]]


def adafactor(
    lr: float = 1e-2,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    groups: Optional[Callable[[Params], Groups]] = None,
) -> Optimizer:
    """Adafactor (Shazeer & Stern) with factored second moments for >= 2-D
    tensors: O(n + m) state instead of O(n * m).

    ``groups(tree)`` steps the tree as if some of its leaves were stacked
    into one (a transformer's layers, as the JAX package stacks them): a
    group's second moments are factored over the stacked shape and its
    update is clipped by the RMS of the whole group, without forming the
    stack for leaves of >= 2 dims.  The state then holds one entry per
    group, in the stacked shape; without ``groups`` one per leaf, in the
    tree's structure."""

    def vr_init(shape, like):
        return _zeros32(shape[:-1] if len(shape) >= 2 else shape, like)

    def vc_init(shape, like):
        return _zeros32(shape[:-2] + shape[-1:] if len(shape) >= 2 else (), like)

    def shape_of(leaves, g):
        return tuple(leaves[g].shape) if isinstance(g, int) else (len(g),) + tuple(leaves[g[0]].shape)

    def init(params: Params) -> AdafactorState:
        if groups is None:
            vr = tree_map(lambda p: vr_init(tuple(p.shape), p), params)
            vc = tree_map(lambda p: vc_init(tuple(p.shape), p), params)
            return AdafactorState(_step0(params), vr, vc)
        leaves = tree_leaves(params)
        shapes = [shape_of(leaves, g) for g in groups(params)]
        return AdafactorState(
            _step0(params), [vr_init(s, leaves[0]) for s in shapes], [vc_init(s, leaves[0]) for s in shapes]
        )

    def update(grads: Params, state: AdafactorState, params: Optional[Params] = None):
        step = state.step + 1
        beta = 1.0 - step.float() ** (-decay)

        def scaled(g, vr, vc):
            """The unclipped update of one tensor and its new moments."""
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
            return g / torch.sqrt(torch.clamp_min(v, eps)), vr_n, vc_n

        def clipped(us):
            """-lr times ``us``, clipped by the RMS over all of them."""
            ms = sum(torch.sum(u * u) for u in us) / sum(u.numel() for u in us)
            div = torch.clamp_min(torch.sqrt(ms + eps) / clip_threshold, 1.0)
            return [-lr * (u / div) for u in us]

        leaves = tree_leaves(grads)
        if groups is None:
            vr_l, vc_l = tree_leaves(state.vr), tree_leaves(state.vc)
            grouped = list(range(len(leaves)))
        else:
            vr_l, vc_l, grouped = state.vr, state.vc, groups(grads)
        out: List[Optional[torch.Tensor]] = [None] * len(leaves)
        vrs, vcs = [], []
        for g, vr, vc in zip(grouped, vr_l, vc_l):
            if isinstance(g, int):
                u, vr_n, vc_n = scaled(leaves[g], vr, vc)
                (out[g],) = clipped([u])
            elif leaves[g[0]].ndim < 2:
                # a stack of vectors or scalars: small, so it is formed
                u, vr_n, vc_n = scaled(torch.stack([leaves[i] for i in g]), vr, vc)
                for i, x in zip(g, clipped([u])[0].unbind(0)):
                    out[i] = x
            else:
                # each layer's rows and columns are its own: only the clip
                # reads the whole stack
                parts = [scaled(leaves[i], vr[j], vc[j]) for j, i in enumerate(g)]
                for i, x in zip(g, clipped([p[0] for p in parts])):
                    out[i] = x
                vr_n, vc_n = torch.stack([p[1] for p in parts]), torch.stack([p[2] for p in parts])
            vrs.append(vr_n)
            vcs.append(vc_n)
        if groups is None:
            vrs, vcs = tree_unflatten(grads, vrs), tree_unflatten(grads, vcs)
        return tree_unflatten(grads, out), AdafactorState(step, vrs, vcs)

    return Optimizer(init, update)
