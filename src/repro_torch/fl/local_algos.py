"""Local-update algorithms: what each selected client computes.

The engine decides who trains and how the updates are aggregated; this
registry decides the client's objective.  Every algorithm is a recipe with
one signature:

* ``algo.init(params) -> client_state``: the per-client state carried
  across rounds (``()`` for a stateless algorithm);
* ``step(params, client_state, global_params, batch) -> (params,
  client_state, loss)``: one local SGD step, from :meth:`LocalAlgo.bind`.

Two hooks on top of plain SGD:

* :meth:`LocalAlgo.transform_grad` folds a per-step term into the raw
  gradient (FedProx's pull ``mu·(w − w_global)``; FedDyn's
  ``−h + alpha·(w − w_global)``).  FedAvg's hook returns the same object,
  so its local update is plain SGD's, bit for bit.
* :meth:`LocalAlgo.finalize` evolves the per-client state once a round,
  after the local steps (FedDyn's ``h ← h − alpha·(w_final − w_global)``).

``global_params`` is the round's base: the params the client trained from.

FedDyn here is the client-side variant: each client's ``h_k`` (fp32, the
params' shapes) corrects its drift in every step, and the server keeps the
plain eq.-(6) average, so every aggregation path and the robust guards stay
as they are.

The registry raises the same ``ValueError`` shape as the scenario, fault and
selection registries: ``unknown local algorithm 'x'; known: [...]``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch
from torch.distributed.tensor import Shard

from repro_torch.launch.sharding import from_local_like, is_dtensor
from repro_torch.optim.optimizers import clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = [
    "LocalAlgo",
    "BoundLocalAlgo",
    "FedAvg",
    "FedProx",
    "FedDyn",
    "LOCAL_ALGOS",
    "ALGO_NAMES",
    "get_local_algo",
    "algo_from_config",
    "init_client_states",
    "make_grad_fn",
]

Params = Any  # a tree of tensors


def make_grad_fn(loss_fn: Callable, micro_batches: int = 1) -> Callable[[Params, tuple], Tuple[torch.Tensor, Params]]:
    """``grad_fn(params, batch) -> (loss, grad)``, optionally accumulated
    over ``micro_batches`` slices of every batch leaf's leading axis: the
    slices' losses and fp32 gradients averaged (the full-batch gradient of
    a mean loss over equal slices, with 1/micro_batches the live
    activations).  The one gradient definition of every local-update
    algorithm and the Mode-B step, as in the JAX package.  A leaf the loss
    does not read (RWKV's ``mu_x``) gets a zero gradient of its shape and
    dtype, as ``jax.grad`` gives it."""

    def full_grad(params: Params, batch):
        live = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
        loss = loss_fn(tree_unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(live, grads)]
        return loss.detach(), tree_unflatten(params, grads)

    if micro_batches == 1:
        return full_grad

    def grad_fn(params: Params, batch):
        micro = tree_map(lambda x: _micro_split(x, micro_batches), batch)
        tot_l = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
        tot_g = tree_map(_zeros_f32, params)
        for i in range(micro_batches):
            l, g = full_grad(params, tree_map(lambda x: x[i], micro))
            tot_l = tot_l + l
            tot_g = tree_map(torch.add, tot_g, g)
        inv = 1.0 / micro_batches
        return tot_l * inv, tree_map(lambda x: x * inv, tot_g)

    return grad_fn


def _micro_split(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x`` (B, ...) as (m, B / m, ...) micro-batches.  A DTensor batch
    sharded on its rows is split on each device's own rows (micro-batch i
    holds every device's i-th slice: no row moves), which DTensor's own
    reshape of a sharded dim cannot do; the full gradient is the same."""
    if not is_dtensor(x):
        return x.reshape((m, x.shape[0] // m) + x.shape[1:])
    local = x.to_local()
    place = tuple(Shard(p.dim + 1) if p.is_shard() else p for p in x.placements)
    return from_local_like(local.reshape((m, local.shape[0] // m) + tuple(local.shape[1:])), x.device_mesh, place,
                           (m, x.shape[0] // m) + tuple(x.shape[1:]))


def _zeros_f32(w: torch.Tensor) -> torch.Tensor:
    """fp32 zeros of ``w``'s shape; of a DTensor ``w``, laid out as ``w``
    (a plain tensor of its global shape would be replicated in full)."""
    if not is_dtensor(w):
        return torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    local = w.to_local()
    return from_local_like(torch.zeros(local.shape, dtype=torch.float32, device=local.device), w.device_mesh,
                           tuple(w.placements), w.shape)


class LocalAlgo:
    """Plain local SGD (eq. 3-5), stateless.  Subclasses override
    :meth:`transform_grad` and, with per-client state, set ``stateful`` and
    override :meth:`init` and :meth:`finalize`."""

    name = "base"
    # True when init() returns per-client state carried across rounds
    # (ServerState.algo_state); stateless algorithms carry nothing
    stateful = False

    def init(self, params: Params) -> Params:
        """Fresh per-client state for one client (stateless: ``()``)."""
        return ()

    def transform_grad(self, grad: Params, params: Params, client_state: Params, global_params: Params) -> Params:
        """The gradient with the algorithm's per-step term folded in; the
        base hook returns ``grad`` itself."""
        return grad

    def finalize(self, params: Params, client_state: Params, global_params: Params) -> Params:
        """The per-client state after the round's local steps."""
        return client_state

    def bind(
        self, loss_fn: Callable, lr: float, grad_clip: Optional[float] = None, micro_batches: int = 1
    ) -> "BoundLocalAlgo":
        """The recipe bound to (loss_fn, lr, grad_clip, micro_batches): the
        object with the per-step ``step(params, client_state,
        global_params, batch)``."""
        return BoundLocalAlgo(self, loss_fn, lr, grad_clip, micro_batches)


class BoundLocalAlgo:
    """A :class:`LocalAlgo` bound to ``loss_fn(params, batch)``, ``lr``,
    ``grad_clip`` and ``micro_batches``."""

    def __init__(
        self, algo: LocalAlgo, loss_fn: Callable, lr: float, grad_clip: Optional[float], micro_batches: int = 1
    ):
        self.algo = algo
        self.lr = lr
        self.grad_clip = grad_clip
        self._grad_fn = make_grad_fn(loss_fn, micro_batches)

    @property
    def name(self) -> str:
        return self.algo.name

    @property
    def stateful(self) -> bool:
        return self.algo.stateful

    def init(self, params: Params) -> Params:
        return self.algo.init(params)

    def step(self, params, client_state, global_params, batch):
        """One local SGD step: ``-> (params, client_state, loss)``."""
        loss, g = self._grad_fn(params, batch)
        g = self.algo.transform_grad(g, params, client_state, global_params)
        if self.grad_clip is not None:
            g = clip_by_global_norm(g, self.grad_clip)
        params = tree_map(lambda w, gw: (w - self.lr * gw).to(w.dtype), params, g)
        return params, client_state, loss

    def finalize(self, params, client_state, global_params):
        return self.algo.finalize(params, client_state, global_params)


class FedAvg(LocalAlgo):
    """Plain local SGD (McMahan et al.): every hook is the base identity."""

    name = "fedavg"


class FedProx(LocalAlgo):
    """FedProx (Li et al., arXiv:1812.06127): the proximal term
    ``mu/2·|w − w_global|²`` folded into every step's gradient as
    ``g + mu·(w − w_global)``.  ``prox_mu == 0`` returns the gradient
    itself, so a zero-mu FedProx is FedAvg bit for bit."""

    name = "fedprox"

    def __init__(self, prox_mu: float = 0.01):
        if prox_mu < 0:
            raise ValueError(f"prox_mu={prox_mu} must be >= 0")
        self.prox_mu = float(prox_mu)

    def transform_grad(self, grad, params, client_state, global_params):
        if self.prox_mu == 0.0:
            return grad
        mu = self.prox_mu
        return tree_map(
            lambda g, w, wg: g + mu * (w.to(g.dtype) - wg.to(g.dtype)), grad, params, global_params
        )


class FedDyn(LocalAlgo):
    """FedDyn (Acar et al., ICLR'21), client-side: each client carries a
    linear-penalty state ``h_k`` (the params' shapes, fp32), making the local
    objective ``L_k(w) − <h_k, w> + alpha/2·|w − w_global|²``:

    * per step: ``g ← g − h_k + alpha·(w − w_global)``
    * per round: ``h_k ← h_k − alpha·(w_final − w_global)``"""

    name = "feddyn"
    stateful = True

    def __init__(self, feddyn_alpha: float = 0.01):
        if feddyn_alpha <= 0:
            raise ValueError(
                f"feddyn_alpha={feddyn_alpha} must be > 0 (alpha=0 is "
                "fedavg with dead state — use local_algo='fedavg')"
            )
        self.feddyn_alpha = float(feddyn_alpha)

    def init(self, params):
        return tree_map(lambda w: torch.zeros(w.shape, dtype=torch.float32, device=w.device), params)

    def transform_grad(self, grad, params, client_state, global_params):
        a = self.feddyn_alpha
        return tree_map(
            lambda g, h, w, wg: g - h.to(g.dtype) + a * (w.to(g.dtype) - wg.to(g.dtype)),
            grad, client_state, params, global_params,
        )

    def finalize(self, params, client_state, global_params):
        a = self.feddyn_alpha
        return tree_map(
            lambda h, w, wg: h - a * (w.to(h.dtype) - wg.to(h.dtype)), client_state, params, global_params
        )


LOCAL_ALGOS = {
    "fedavg": FedAvg,
    "fedprox": FedProx,
    "feddyn": FedDyn,
}

ALGO_NAMES = tuple(sorted(LOCAL_ALGOS))


def get_local_algo(name: str, **kw) -> LocalAlgo:
    """A local-update algorithm by registry name; ``**kw`` go to its
    constructor (``get_local_algo('fedprox', prox_mu=0.01)``)."""
    if name not in LOCAL_ALGOS:
        raise ValueError(f"unknown local algorithm {name!r}; known: {list(ALGO_NAMES)}")
    return LOCAL_ALGOS[name](**kw)


def algo_from_config(name: str, prox_mu: Optional[float] = None, feddyn_alpha: Optional[float] = None) -> LocalAlgo:
    """The FLConfig -> algorithm mapping (``FLConfig.__post_init__`` has
    validated the combination); an unset value takes the constructor's
    default."""
    kw = {}
    if name == "fedprox" and prox_mu is not None:
        kw["prox_mu"] = prox_mu
    if name == "feddyn" and feddyn_alpha is not None:
        kw["feddyn_alpha"] = feddyn_alpha
    return get_local_algo(name, **kw)


def init_client_states(algo: LocalAlgo, params: Params, num_clients: int):
    """The per-client state of all C clients, every leaf of ``algo.init``
    with a leading (C,) axis, at zero; ``None`` for a stateless algorithm."""
    if not algo.stateful:
        return None
    return tree_map(
        lambda s: torch.zeros((num_clients,) + tuple(s.shape), dtype=s.dtype, device=s.device),
        algo.init(params),
    )
