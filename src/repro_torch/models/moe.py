"""Mixture-of-Experts FFN with sort-based capacity dispatch.

The JAX package's module as plain PyTorch, computed the same way:

1. router logits in fp32 -> top-k experts per token; the combine weights
   are a softmax over the top-k logits (mixtral) or their sigmoid
   (llama4, top-1 beside a shared expert); the Switch load-balance aux
   loss uses the softmax over all logits either way;
2. the (token, choice) pairs are sorted by expert id (a stable sort) and
   packed into a fixed ``(num_experts, capacity)`` slot grid; pairs past
   their expert's capacity go to a trash slot at ``e * cap`` and are
   dropped;
3. the experts run as three batched products over the expert axis on the
   gathered slot grid (unused slots zeroed), SiLU rounded as JAX's
   (``layers.silu``);
4. the outputs scatter back in fp32 with the combine weights.

Capacity is ``capacity_factor * T * k / E`` over the T tokens of one call,
rounded up to 8.  Which pairs an expert drops therefore depends on every
token of the call, padding and idle serving slots included, as in JAX: the
same token routed in another batch may keep or lose an expert.

The expert products are library GEMMs: the JAX package computes them
outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.sharding import is_dtensor, local_map, reshape
from repro_torch.models import layers as L

__all__ = ["init_moe", "apply_moe"]


def _expert_weights(
    generator: torch.Generator, shape: Tuple[int, int, int], std: float, dtype: torch.dtype, device
) -> torch.Tensor:
    """N(0, std²) weights of ``shape`` in ``dtype``, drawn in fp32 one expert
    at a time, so the fp32 temporary is one expert's (llama4's 128 experts
    of 5120 × 8192 would be 21.5 GB at once)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i] = (torch.randn(shape[1:], generator=generator, device=device) * std).to(dtype)
    return out


def init_moe(generator: torch.Generator, cfg: ModelConfig, device) -> Dict:
    """JAX's laws: the router N(0, 1/D) in fp32 whatever ``param_dtype``;
    ``wi`` and ``wg`` N(0, 1/D) and ``wo`` N(0, 1/d_ff), (E, D, F) and
    (E, F, D); the shared expert as ``layers.init_mlp``."""
    dtype = L.torch_dtype(cfg.param_dtype)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": L.init_dense(generator, d, e, torch.float32, device),
        "wi": _expert_weights(generator, (e, d, f), d**-0.5, dtype, device),
        "wg": _expert_weights(generator, (e, d, f), d**-0.5, dtype, device),
        "wo": _expert_weights(generator, (e, f, d), f**-0.5, dtype, device),
    }
    if cfg.shared_expert:
        p["shared"] = L.init_mlp(generator, cfg, device)
    return p


def _route(cfg: ModelConfig, logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fp32 logits (T, E) -> (expert ids (T, k), combine weights (T, k)
    fp32, aux loss ()).  ``torch.topk`` orders exact ties as it likes, where
    ``lax.top_k`` puts the lower index first; fp32 router logits of real
    inputs do not tie."""
    e = logits.shape[1]
    k = cfg.experts_per_token
    gate_val, idx = torch.topk(logits, k, dim=-1)
    if cfg.router_type == "sigmoid":  # llama4: top-k, then a sigmoid gate
        combine = L.sigmoid(gate_val)
    else:  # mixtral: softmax over the top-k logits
        combine = torch.softmax(gate_val, dim=-1)
    probs = torch.softmax(logits, dim=-1)  # the aux loss takes the full softmax
    # Switch load balance: E * sum_e fraction_e * prob_e.  The one-hot is a
    # comparison with arange: one_hot checks a real input's range with a
    # host read, a synchronise in every MoE layer on the card
    one_hot = idx[..., None] == torch.arange(e, device=idx.device)
    frac = torch.mean(one_hot.float().sum(dim=1), dim=0) / k
    aux = e * torch.sum(frac * torch.mean(probs, dim=0)) * cfg.router_aux_coef
    return idx, combine.float(), aux


def _capacity(cfg: ModelConfig, t: int) -> int:
    cap = int(cfg.capacity_factor * t * cfg.experts_per_token / cfg.num_experts)
    return max(8, -(-cap // 8) * 8)  # rounded up to 8, as JAX's lane alignment


def _dispatch(idx: torch.Tensor, e: int, cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Expert ids (T, k) -> (the pairs' stable sort by expert, each sorted
    pair's slot in the (E * cap + 1) grid, whether it is kept).  A pair's
    rank within its expert's group is its position past the group's start;
    ranks from ``cap`` on go to the trash slot ``e * cap``."""
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    group_start = torch.searchsorted(sorted_e, torch.arange(e, device=idx.device), side="left")
    rank = torch.arange(flat.shape[0], device=idx.device) - group_start[sorted_e]
    keep = rank < cap
    slot = torch.where(keep, sorted_e * cap + rank, e * cap)
    return order, slot, keep


def _router_logits(p: Dict, xf: torch.Tensor) -> torch.Tensor:
    return xf.float() @ p["router"]["w"]


def apply_moe(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y in x's dtype, aux loss () fp32)."""
    if is_dtensor(x):
        return _apply_moe_sharded(cfg, p, x)
    b, s, d = x.shape
    t = b * s
    k, e = cfg.experts_per_token, cfg.num_experts
    cap = _capacity(cfg, t)
    xf = x.reshape(t, d)
    idx, combine, aux = _route(cfg, _router_logits(p, xf))
    # gather the tokens into the slot grid
    order, slot, keep, _, slot_token, slot_used = _slots(idx, k, e, cap)
    xe = xf[slot_token].reshape(e, cap, d) * slot_used.reshape(e, cap, 1).to(x.dtype)

    # the experts, stacked over the expert axis
    h = L.silu(torch.bmm(xe, p["wg"])) * torch.bmm(xe, p["wi"])
    ye = torch.bmm(h, p["wo"])  # (E, cap, D)

    # combine back in fp32 with the pairs' weights
    w_slot = _slot_weights(slot, keep, combine, order, e * cap)
    contrib = ye.reshape(e * cap, d).float() * w_slot[:-1, None]
    yf = torch.zeros(t, d, dtype=torch.float32, device=x.device).index_add(0, slot_token, contrib)
    y = reshape(yf.to(x.dtype), b, s, d)
    if cfg.shared_expert:
        y = y + L.apply_mlp(cfg, p["shared"], x)
    return y, aux


def _slots(idx: torch.Tensor, k: int, e: int, cap: int):
    """The dispatch into the slot grid (+1 trash slot): (order, slot, keep,
    each pair's token, each slot's token, whether each slot is used), the
    last two with the trash slot cut off."""
    order, slot, keep = _dispatch(idx, e, cap)
    token_of_pair = order // k
    slot_token = torch.zeros(e * cap + 1, dtype=torch.int64, device=idx.device)
    slot_token[slot] = token_of_pair
    slot_used = torch.zeros(e * cap + 1, dtype=torch.bool, device=idx.device)
    slot_used[slot] = keep
    return order, slot, keep, token_of_pair, slot_token[:-1], slot_used[:-1]


def _slot_weights(slot: torch.Tensor, keep: torch.Tensor, combine: torch.Tensor, order: torch.Tensor, n: int):
    """Each slot's combine weight, (n + 1,) with the trash slot."""
    w_slot = torch.zeros(n + 1, dtype=torch.float32, device=slot.device)
    w_slot[slot] = torch.where(keep, combine.reshape(-1)[order], 0.0)
    return w_slot


def _apply_moe_sharded(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`apply_moe` on DTensors (the sharded dry run): the same
    routing and capacity over every token of the call, so the routing and
    the tokens are gathered (replicated, the sort's inputs as JAX's), the
    slot grid is built on each device (``local_map``), the experts run as
    the rules lay their weights out (experts over ``data``, d_ff over
    ``model``), and each device adds its own experts' slots into the
    tokens, the devices' sums pending (``Partial``) until the residual
    add reduces them.  DTensor has no strategy for the sort, the search
    and the index writes."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    rep = (Replicate(),) * mesh.ndim
    b, s, d = x.shape
    t = b * s
    k, e = cfg.experts_per_token, cfg.num_experts
    cap = _capacity(cfg, t)
    xf = reshape(x, t, d)
    idx, combine, aux = _route(cfg, _router_logits(p, xf))
    idx, combine = idx.redistribute(mesh, rep), combine.redistribute(mesh, rep)
    # the same tensors as the plain path's, alive as long
    order, slot, keep, token_of_pair, slot_token, slot_used = local_map(
        lambda i: _slots(i, k, e, cap), out_placements=(rep,) * 6, in_placements=(rep,), device_mesh=mesh,
    )(idx)
    xe = reshape(xf.redistribute(mesh, rep)[slot_token], e, cap, d) * slot_used.reshape(e, cap, 1).to(x.dtype)
    h = L.silu(torch.bmm(xe, p["wg"])) * torch.bmm(xe, p["wi"])
    ye = torch.bmm(h, p["wo"])  # (E, cap, D)
    w_slot = local_map(
        lambda sl, kp, c, o: _slot_weights(sl, kp, c, o, e * cap), out_placements=list(rep),
        in_placements=(rep,) * 4, device_mesh=mesh,
    )(slot, keep, combine, order)
    contrib = reshape(ye, e * cap, d).float() * w_slot[:-1, None]
    # each device's rows of the slot grid (its experts) go to its tokens
    cp = tuple(Replicate() if q.is_shard() and q.dim != 0 else q for q in contrib.placements)
    contrib = contrib.redistribute(mesh, cp)
    tp = tuple(Shard(0) if q.is_shard(0) else Replicate() for q in cp)
    out_p = [Partial() if q.is_shard(0) or q.is_partial() else Replicate() for q in cp]

    def add_rows(tok, rows):
        return torch.zeros(t, d, dtype=torch.float32, device=rows.device).index_add(0, tok, rows)

    yf = local_map(add_rows, out_placements=out_p, in_placements=(tp, cp), device_mesh=mesh)(
        slot_token.redistribute(mesh, tp), contrib
    )
    y = reshape(yf.to(x.dtype), b, s, d)
    if cfg.shared_expert:
        y = y + L.apply_mlp(cfg, p["shared"], x)
    return y, aux
