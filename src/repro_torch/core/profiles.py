"""Client data profiling (paper §3.1, Theorem 1).

Each client summarises its local dataset by the *mean vector of the FC-1
outputs* of the (shared, freshly initialised) global model — eq. (11):
``f_c = [u_1^c, …, u_Q^c]``, a distribution fingerprint uploaded once.

Models plug in via ``feature_fn(params, x) -> (logits, feats)`` where
``feats`` is the designated profile layer output (the paper CNN's FC-1
pre-activations).

Also implements the Fig.-3 ablation baselines: gradient profiles and
representative-gradient profiles (Fraboni et al., ICML'21).  Both flatten
the gradient in the JAX package's leaf order and layouts: ``layout`` maps
the port's parameter dict to the JAX model's tree (``cnn.params_to_jax``
for the paper CNN), whose keys are walked sorted, as ``jax.tree_util``
walks a dict.  Without it the dict is walked as it is, which for the CNN
gives other layouts and so another strided profile.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_unflatten

__all__ = [
    "fc1_profile",
    "gradient_profile",
    "representative_gradient_profile",
    "profile_all_clients",
]

FeatureFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]
Layout = Callable[[Mapping[str, torch.Tensor]], Mapping]


@torch.no_grad()
def fc1_profile(
    feature_fn: FeatureFn, params, xs: torch.Tensor, batch_size: int = 256
) -> torch.Tensor:
    """Mean FC-1 output over a client's local dataset (eq. 11), streamed in
    fixed-size batches.

    A client with an **empty** local dataset (n = 0) gets the zero profile of
    width Q — probed with an empty forward batch so the width matches every
    populated client's row.  (Zero is the neutral element of the eq.-(14)
    pipeline and keeps the kernel finite.)
    """
    n = xs.shape[0]
    if n == 0:
        _, feats = feature_fn(params, xs[:0])
        width = int(np.prod(feats.shape[1:]))
        return torch.zeros((width,), dtype=feats.dtype, device=feats.device)
    total = None
    for start in range(0, n, batch_size):
        _, feats = feature_fn(params, xs[start : start + batch_size])
        s = torch.sum(feats.reshape(feats.shape[0], -1), dim=0)
        total = s if total is None else total + s
    return total / n


def profile_all_clients(
    feature_fn: FeatureFn, params, client_data: Iterable[torch.Tensor], batch_size: int = 256
) -> torch.Tensor:
    """Stack eq.-(11) profiles for every client: -> (C, Q)."""
    rows = [fc1_profile(feature_fn, params, xs, batch_size=batch_size) for xs in client_data]
    return torch.stack(rows, dim=0)


def _leaves_with_paths(tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, torch.Tensor]]:
    """(path, leaf) pairs of a nested tree in ``jax.tree_util``'s order:
    the keys of every mapping sorted, a list's items by index."""
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            yield from _leaves_with_paths(tree[key], prefix + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _leaves_with_paths(item, prefix + (i,))
    else:
        yield prefix, tree


def _grad_leaves(
    loss_fn: Callable, params, xs: torch.Tensor, ys: torch.Tensor, layout: Optional[Layout]
) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """The gradient of ``loss_fn(params, xs, ys)`` as (path, leaf) pairs in
    the order and layouts of ``layout(grads)``.  A parameter the loss does
    not reach gets a zero gradient, as ``jax.grad`` gives."""
    live = [v.detach().requires_grad_(True) for v in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, live), xs, ys)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    tree = tree_unflatten(
        params, [torch.zeros_like(v) if g is None else g for v, g in zip(live, grads)]
    )
    return list(_leaves_with_paths(tree if layout is None else layout(tree)))


def gradient_profile(
    loss_fn: Callable,
    params,
    xs: torch.Tensor,
    ys: torch.Tensor,
    max_dim: int = 4096,
    layout: Optional[Layout] = None,
) -> torch.Tensor:
    """Fig.-3 ablation: profile = flattened loss gradient on the local data,
    strided down to ``max_dim`` entries (every ``len // max_dim``-th entry
    from the first) so profiles stay comparable in size with FC-1 profiles."""
    flat = torch.cat([g.reshape(-1) for _, g in _grad_leaves(loss_fn, params, xs, ys, layout)])
    if flat.shape[0] > max_dim:
        stride = flat.shape[0] // max_dim
        flat = flat[: stride * max_dim : stride]
    return flat


def representative_gradient_profile(
    loss_fn: Callable,
    params,
    xs: torch.Tensor,
    ys: torch.Tensor,
    layer: str = "out",
    layout: Optional[Layout] = None,
) -> torch.Tensor:
    """Fig.-3 ablation: representative gradients (Fraboni et al. Alg. 2
    input): the gradient leaves whose "/"-joined path contains ``layer``, in
    sorted path order, else the last leaf (for the paper CNN, which has no
    "out" leaf, FC-2's weight, (in, out))."""
    leaves = _grad_leaves(loss_fn, params, xs, ys, layout)
    named = {"/".join(map(str, path)): g for path, g in leaves}
    picked = [g for k, g in sorted(named.items()) if layer in k]
    if not picked:
        picked = [leaves[-1][1]]
    return torch.cat([g.reshape(-1) for g in picked])
