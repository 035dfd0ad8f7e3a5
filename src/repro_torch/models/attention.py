"""GQA attention (full and sliding-window) with KV-cache decode.

Conventions, the JAX package's:
* activations (B, S, D); q/k/v (B, S, H|Hk, head_dim);
* KV cache ``{"k","v": (B, slots, Hk, hd), "pos": () | (B,)}``: a ring
  buffer of ``slots`` entries (slot = pos % slots).  ``pos: (B,)`` tracks
  one position per batch row, so decode slots at different depths share
  one batch (the serving engine's layout);
* GQA grouping: q heads fold to (Hk, G), so k/v are used ungrouped;
* positions (B, S), or M-RoPE's three streams (3, B, S), whose temporal
  stream orders the causal mask.  RoPE or M-RoPE is applied to q and k
  before any kernel sees them.

With a cache, ``apply_attention`` writes the new k/v into the cache's
tensors **in place** (the port saves a copy of every layer's cache per
step that way) and returns the cache dict with the advanced position; the
position tensor itself is never written in place.

On DTensors (the sharded dry run, ``launch/sharding.py``) a decode step
whose cache is sharded on its sequence takes the plain attention, as the
JAX package's sharded dry run decodes; K5's split-KV partials are not
merged across devices.

``use_flash`` routes a decode step (S == 1, no window) through K5
(``kernels.flash_attention.ops.flash_decode``) and the no-cache forward
without a window through K6 (``kernels.flash_attention.ops.
flash_attention``).  K6 is forward-only: with grad enabled and parameters
that require grad it raises, so a training pass takes ``use_flash=False``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.sharding import (
    constrain, is_dtensor, lay_out, local_map, local_offset, replicate_dims, reshape, sharded, shards_dim,
    split_last,
)
from repro_torch.models import layers as L

__all__ = ["init_attention", "init_cache", "apply_attention"]

NEG_INF = -2.0e38


def init_attention(generator: torch.Generator, cfg: ModelConfig, device) -> Dict:
    dtype = L.torch_dtype(cfg.param_dtype)
    return {
        "wq": L.init_dense(generator, cfg.d_model, cfg.q_dim, dtype, device),
        "wk": L.init_dense(generator, cfg.d_model, cfg.kv_dim, dtype, device),
        "wv": L.init_dense(generator, cfg.d_model, cfg.kv_dim, dtype, device),
        "wo": L.init_dense(generator, cfg.q_dim, cfg.d_model, dtype, device),
    }


def init_cache(
    cfg: ModelConfig, batch: int, cache_len: int, window: Optional[int],
    per_slot: bool = False, device=None,
) -> Dict:
    """Zeroed KV cache; a ring of ``window`` slots for SWA.  ``per_slot``
    gives ``pos: (B,)`` (one position per row) instead of ``pos: ()``."""
    slots = min(cache_len, window) if window else cache_len
    dtype = L.torch_dtype(cfg.dtype)
    shape = (batch, slots, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((batch,) if per_slot else (), dtype=torch.int32, device=device),
    }


def _positions_rope(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    if cfg.pos_style == "mrope":
        return L.apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    if cfg.pos_style == "rope":
        if positions.ndim == 3:  # M-RoPE streams given to a RoPE model
            positions = positions[0]
        return L.apply_rope(x, positions, cfg.rope_theta)
    return x  # sinusoidal and none are applied at the embedding


def _attend(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, Hk, hd)
    v: torch.Tensor,  # (B, Skv, Hk, hd)
    q_pos: torch.Tensor,  # (B, Sq)
    kv_pos: torch.Tensor,  # (B, Skv)
    kv_valid: torch.Tensor,  # (B | 1, Skv) bool
    window: Optional[int],
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """Exact masked GQA attention, queries in blocks of ``chunk`` so the
    live scores are (B, Hk, G, chunk, Skv).  Scores are formed in the
    inputs' dtype and softmaxed in fp32; the probabilities are cast to
    ``v.dtype`` before the PV product, as in the JAX package."""
    b, sq, h, hd = q.shape
    hk = k.shape[2]
    g = h // hk

    def block(q_blk, qpos_blk):
        qg = reshape(q_blk, b, q_blk.shape[1], hk, g, hd)
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()
        scores = scores * (hd**-0.5)
        mask = kv_pos[:, None, :] <= qpos_blk[:, :, None]
        if window is not None:
            mask &= kv_pos[:, None, :] > qpos_blk[:, :, None] - window
        mask &= kv_valid[:, None, :]
        scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
        return reshape(out, b, q_blk.shape[1], h, hd)

    if chunk is None or chunk >= sq:
        return block(q, q_pos)
    outs = [block(q[:, i : i + chunk], q_pos[:, i : i + chunk]) for i in range(0, sq, chunk)]
    return torch.cat(outs, dim=1)


def _write_sharded(cache: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> None:
    """``cache[:, idx] = vals`` on a DTensor cache sharded on its batch and
    its slots (``idx`` a ring run of S slots from ``idx[0]``): each device
    writes only its own slots (through ``local_map``), reading ``vals``
    laid out as the cache on the batch.  A write of at least a device's n
    slots gathers each of them from the last write aimed at it, if any;
    a shorter one writes its S entries, those outside the device's range
    aimed at slot 0 with the value slot 0 ends with, so that no two writes
    of one slot differ.  DTensor has no strategy for an in-place index
    write."""
    from torch.distributed.tensor import Replicate

    mesh, cp = cache.device_mesh, tuple(cache.placements)
    if any(p.is_shard() and p.dim > 1 for p in cp):
        raise ValueError(f"a cache laid out as {cp}: only its batch and slots may be sharded")
    slots, lo = cache.shape[1], local_offset(cache, 1)
    vp = tuple(p if p.is_shard(0) else Replicate() for p in cp)
    vals = vals.redistribute(mesh, vp)
    rep = (Replicate(),) * mesh.ndim
    idx = lay_out(idx, mesh, rep)

    def local(c, v, i):
        n, s = c.shape[1], i.shape[0]
        if s >= n:
            # local slot j holds global slot lo + j: the write t = r + slots·m (the last m) reaches it
            r = torch.remainder(lo + torch.arange(n, device=c.device) - i[0], slots)
            hit = r < s
            t = torch.where(hit, r + slots * torch.div(s - 1 - r, slots, rounding_mode="floor"), 0)
            c.copy_(torch.where(hit[None, :, None, None], v[:, t].to(c.dtype), c))
            return c
        rel = i - lo
        inside = (rel >= 0) & (rel < n)
        first = torch.remainder(lo - i[0], slots)  # the write aimed at local slot 0
        end0 = torch.where(first < s, v.index_select(1, first.clamp(max=s - 1)[None]).to(c.dtype), c[:, :1])
        c[:, torch.where(inside, rel, 0)] = torch.where(inside[None, :, None, None], v.to(c.dtype), end0)
        return c

    local_map(local, out_placements=list(cp), in_placements=(cp, vp, rep), device_mesh=mesh)(cache, vals, idx)


def _flash_decode(q, ck, cv, lengths):
    """K5 on plain tensors; on DTensors (a cache sharded on its batch, or
    replicated) K5 on each device's rows through ``local_map``.  A cache
    sharded on its sequence, K5's reduced axis, never comes here: the
    decode takes the plain attention (``launch/sharding.py``)."""
    if not is_dtensor(ck):
        return flash_ops.flash_decode(q, ck, cv, lengths)

    mesh, place = ck.device_mesh, tuple(ck.placements)
    if any(p.is_shard() and not p.is_shard(0) for p in place):
        raise ValueError(f"K5 on a cache laid out as {place}: only its batch may be sharded")
    q, lengths = (x.redistribute(mesh, place) for x in (q, lengths))
    return local_map(flash_ops.flash_decode, out_placements=list(place), in_placements=(place,) * 4, device_mesh=mesh)(
        q, ck, cv, lengths
    )


def _attend_rows(q, k, v, pos, valid, window, chunk):
    """:func:`_attend` over the step's own keys (no cache).  On DTensors,
    on each device's batch rows through ``local_map``, the heads gathered:
    the rows are independent, and DTensor's strategies for the chunked
    einsums and masks (forward, or the backward's gradients) leave layouts
    its later ops cannot take."""
    if not is_dtensor(q):
        return _attend(q, k, v, pos, pos, valid, window, chunk=chunk)
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    place = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in q.placements)
    q, k, v = (x.redistribute(mesh, place) for x in (q, k, v))
    pos, valid = (lay_out(t, mesh, place) for t in (pos, valid))
    return local_map(
        lambda q, k, v, p, m: _attend(q, k, v, p, p, m, window, chunk=chunk),
        out_placements=list(place), in_placements=(place,) * 5, device_mesh=mesh,
    )(q, k, v, pos, valid)


def apply_attention(
    cfg: ModelConfig,
    p: Dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[Dict] = None,
    window: Optional[int] = None,
    use_flash: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Attention block body.  ``cache=None`` is the no-cache (training)
    path; with a cache, S is the write length (prefill) or 1 (decode)."""
    b, s, _ = x.shape
    q = split_last(L.dense(p["wq"], x), cfg.num_heads, cfg.head_dim)
    k = split_last(L.dense(p["wk"], x), cfg.num_kv_heads, cfg.head_dim)
    v = split_last(L.dense(p["wv"], x), cfg.num_kv_heads, cfg.head_dim)
    # M-RoPE's (3, B, S) streams: causal masking follows the temporal one
    q_pos = positions if positions.ndim == 2 else positions[0]
    q = _positions_rope(cfg, q, positions)
    k = _positions_rope(cfg, k, positions)
    # the hillclimb's layouts of q/k/v (replicated under the default rules)
    q = constrain(q, "act_attn_b", "act_seq", "act_attn_h", None)
    k = constrain(k, "act_attn_b", "act_seq", "act_attn_kv", None)
    v = constrain(v, "act_attn_b", "act_seq", "act_attn_kv", None)

    if cache is None:
        if use_flash and window is None:
            out = flash_ops.flash_attention(q, k, v)
        else:
            valid = torch.ones((b, s), dtype=torch.bool, device=x.device)
            out = _attend_rows(q, k, v, q_pos, valid, window, cfg.attention_chunk)
        new_cache = None
    else:
        ck, cv = cache["k"], cache["v"]
        slots = ck.shape[1]
        pos0 = cache["pos"]
        per_slot = pos0.ndim == 1  # (B,) positions, one per row
        ar = torch.arange(s, device=x.device)
        if sharded(ck):
            if per_slot:
                raise NotImplementedError("a sharded cache holds one shared position")
            idx = (pos0 + ar) % slots
            _write_sharded(ck, idx, k)
            _write_sharded(cv, idx, v)
        elif not per_slot and s == slots and window is None:
            # prefill writing the whole cache
            ck.copy_(k)
            cv.copy_(v)
        elif per_slot:
            # each row writes at its own ring offset
            idx = (pos0[:, None] + ar[None, :]) % slots  # (B, s)
            bidx = torch.arange(b, device=x.device)[:, None]
            ck[bidx, idx] = k.to(ck.dtype)
            cv[bidx, idx] = v.to(cv.dtype)
        else:
            idx = (pos0 + ar) % slots
            ck[:, idx] = k.to(ck.dtype)
            cv[:, idx] = v.to(cv.dtype)
        new_pos = pos0 + s
        if use_flash and s == 1 and window is None and not shards_dim(ck, 1):
            lengths = new_pos.clamp(max=slots).expand(b).contiguous()
            out = _flash_decode(q, ck, cv, lengths)
        else:
            # absolute positions held in each slot (ring-aware)
            slot_ids = torch.arange(slots, device=x.device)
            np_b = new_pos[:, None] if per_slot else new_pos  # (B, 1) | ()
            if window is None:
                kv_pos = slot_ids[None, :].expand(b, slots)
                kv_valid = slot_ids[None, :] < np_b
            else:
                # slot holds the latest absolute position congruent mod `slots`
                last = np_b - 1
                kv_pos = last - torch.remainder(last - slot_ids[None, :], slots)
                kv_pos = kv_pos.expand(b, slots)
                kv_valid = (kv_pos >= 0) & (kv_pos < np_b)
            out = _attend(q, ck, cv, q_pos, kv_pos, kv_valid, window, chunk=cfg.attention_chunk)
            # a cache sharded on its slots leaves the output sharded on its
            # queries (DTensor's softmax layout): gathered back, as q came
            out = replicate_dims(out, 1)
        new_cache = {"k": ck, "v": cv, "pos": new_pos}

    y = L.dense(p["wo"], reshape(out, b, s, cfg.q_dim))
    return y, new_cache
