"""Composable decoder transformer covering every arch of the registry.

A model is a ``block_pattern``, a repeating unit of "mixer+ffn" layer specs
(``cfg.layer_types()``):

    mixers:  attn (full GQA) | swa (window=cfg.window) |
             local (window=cfg.local_window) | rglru | rwkv
    ffns:    mlp | moe | cmix (with rwkv)

e.g. granite ("attn+mlp",); mixtral ("swa+moe",); llama4 ("attn+mlp",
"attn+moe"); recurrentgemma ("rglru+mlp", "rglru+mlp", "local+mlp");
rwkv6 ("rwkv+cmix",).  Positions are (B, S), or (3, B, S) M-RoPE streams
for ``pos_style="mrope"`` (qwen2-vl); ``sinusoidal`` (musicgen) adds
absolute embeddings at the input.  ``forward``, ``lm_loss`` and
``features`` take precomputed ``embeds`` (B, S, D) in place of tokens: the
VLM and audio frontends are stubs that feed them, as in the JAX package.

Parameters are a plain dict: ``embed.w`` (V_pad, D), ``final_norm``,
``lm_head.w`` (D, V_pad) when the embeddings are untied, and ``blocks``,
one dict per layer in layer order.  ``params_from_jax`` turns the JAX
package's layer-stacked tree into this layout.

Caches keep the JAX package's layer-stacked layout (``init_caches``):
``{"unit": (cache of one pattern entry with every leaf stacked (reps, ...),
...), "rem": (per-layer caches, ...)}``.  An attention layer's cache is
``{"k","v": (B, slots, Hk, hd), "pos"}``, an RWKV layer's ``{"tm_x",
"wkv", "cm_x", "pos"}``, an RG-LRU layer's ``{"conv", "h", "pos"}``
(``pos: ()`` or ``(B,)``).  ``forward`` hands each
layer a view of its row and the layers write their tensors in place; the
returned caches share those tensors and carry new positions.

``use_flash`` routes attention through K5/K6 (``attention.py``) and the
RWKV time mix through K7 at every prefill and decode step
(``rwkv6.apply_rwkv_tmix(use_kernel=True)``).  The MoE FFN and the RG-LRU
mixer reach no kernel, as in the JAX package, and neither do windowed
attention layers (``swa``, ``local``).  The JAX package's model
path never sets ``use_kernel`` (its transformer calls the time mix
without it); the port routes it from the same switch, and with
``use_flash=False`` computes exactly what JAX's path computes.

On DTensors (the sharded dry run, ``launch/sharding.py``) the residual
stream is constrained where JAX constrains it (after the embedding and
each repeat unit's layers), and the model code's DTensor branches say
what each device computes where DTensor has no strategy of its own
(``src/repro_torch/DESIGN.md``, "The model axis"); on plain tensors those
branches dispatch nothing.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch.sharding import (
    constrain, is_dtensor, lay_out, local_map, local_offset, matmul, shard_like, shards_dim,
)
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.tree import tree_leaves, tree_unflatten

__all__ = [
    "init_params",
    "init_caches",
    "forward",
    "logits_from_hidden",
    "decode_step",
    "param_count",
    "params_from_jax",
    "layer_groups",
    "vocab_padded",
    "lm_loss",
    "features",
    "mrope_streams",
]

ATTN_MIXERS = ("attn", "swa", "local")
MIXERS = ATTN_MIXERS + ("rglru", "rwkv")
FFNS = ("mlp", "moe", "cmix")


def _parse(btype: str) -> Tuple[str, str]:
    mixer, ffn = btype.split("+")
    if mixer not in MIXERS or ffn not in FFNS or (ffn == "cmix") != (mixer == "rwkv"):
        raise ValueError(
            f"block {btype!r}: mixers are {MIXERS}, FFNs {FFNS}, and cmix goes with rwkv"
        )
    return mixer, ffn


def _mixer_window(cfg: ModelConfig, mixer: str) -> Optional[int]:
    return {"attn": None, "swa": cfg.window, "local": cfg.local_window}.get(mixer)


def vocab_padded(cfg: ModelConfig) -> int:
    return -(-cfg.vocab_size // 128) * 128


# ------------------------------------------------------------------ init


def _init_block(generator: torch.Generator, cfg: ModelConfig, btype: str, device) -> Dict:
    mixer, ffn = _parse(btype)
    p = {"norm1": L.init_norm(cfg, device), "norm2": L.init_norm(cfg, device)}
    if mixer == "rwkv":
        p["mixer"] = rwkv_mod.init_rwkv_tmix(generator, cfg, device)
    elif mixer == "rglru":
        p["mixer"] = rglru_mod.init_rglru(generator, cfg, device)
    else:
        p["mixer"] = attn_mod.init_attention(generator, cfg, device)
    if ffn == "cmix":
        p["ffn"] = rwkv_mod.init_rwkv_cmix(generator, cfg, device)
    elif ffn == "moe":
        p["ffn"] = moe_mod.init_moe(generator, cfg, device)
    else:
        p["ffn"] = L.init_mlp(generator, cfg, device)
    return p


def init_params(
    generator: torch.Generator, cfg: ModelConfig, device: Optional[Union[str, torch.device]] = None
) -> Dict:
    """Random parameters from ``generator`` (which must live on ``device``):
    embeddings N(0, 0.02²), dense weights N(0, 1/d_in), norms 1, the RWKV
    mixes, MoE experts and RG-LRU blocks by the JAX package's laws
    (``rwkv6.init_rwkv_tmix``, ``moe.init_moe``, ``rglru.init_rglru``).
    Leaves are in ``cfg.param_dtype`` except RWKV's ``w0`` and ``u``, the
    MoE router and RG-LRU's ``lam``, fp32."""
    device = resolve_device(device)
    dtype = L.torch_dtype(cfg.param_dtype)
    v = vocab_padded(cfg)
    embed = torch.randn(v, cfg.d_model, generator=generator, device=device) * 0.02
    params: Dict[str, Any] = {"embed": {"w": embed.to(dtype)}, "final_norm": L.init_norm(cfg, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_dense(generator, cfg.d_model, v, dtype, device)
    params["blocks"] = [_init_block(generator, cfg, bt, device) for bt in cfg.layer_types()]
    return params


def params_from_jax(np_params: Mapping, cfg: ModelConfig, device=None) -> Dict:
    """The JAX package's parameter tree (numpy leaves, as
    ``jax.tree_util.tree_map(np.asarray, params)`` gives) -> the port's.

    Layer ``r * len(pattern) + j`` of the unit part is
    ``np_params["unit"][j][...][r]``; the ``rem`` blocks follow.  Dense
    weights keep JAX's (d_in, d_out) layout, and every leaf keeps its own
    dtype (RWKV's ``w0`` and ``u``, the MoE router's ``w`` and RG-LRU's
    ``lam`` are fp32 in a bf16 model)."""
    device = resolve_device(device)

    def conv(tree):
        if isinstance(tree, Mapping):
            return {k: conv(v) for k, v in tree.items()}
        a = np.asarray(tree)
        if a.dtype.name == "bfloat16":  # numpy has no bf16 of its own: widen exactly
            return torch.tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
        return torch.tensor(np.ascontiguousarray(a), device=device)

    pattern = cfg.block_pattern
    reps = cfg.num_layers // len(pattern)
    blocks: List[Dict] = []
    for r in range(reps):
        for j in range(len(pattern)):
            blocks.append(conv(_index(np_params["unit"][j], r)))
    blocks.extend(conv(p) for p in np_params["rem"])
    out = {"embed": conv(np_params["embed"]), "final_norm": conv(np_params["final_norm"]), "blocks": blocks}
    if "lm_head" in np_params:
        out["lm_head"] = conv(np_params["lm_head"])
    return out


def layer_groups(cfg: ModelConfig, tree: Dict) -> List[Union[int, List[int]]]:
    """The leaves of ``tree`` (params of ``cfg``, or grads of their shapes),
    by index in ``tree_leaves`` order, grouped as the JAX package stacks
    them: each leaf outside the blocks alone (an int); for pattern entry
    ``j``, each of its leaves over the repeat units as one stacked leaf (a
    list of the layers' indices, in unit order, even of one unit); and the
    remainder layers' leaves alone."""
    index = tree_unflatten(tree, range(len(tree_leaves(tree))))
    n = len(cfg.block_pattern)
    reps = cfg.num_layers // n
    out: List[Union[int, List[int]]] = []
    for key, value in index.items():
        if key != "blocks":
            out += tree_leaves(value)
            continue
        for j in range(n):
            out += [list(g) for g in zip(*(tree_leaves(b) for b in value[j : reps * n : n]))]
        for b in value[reps * n :]:
            out += tree_leaves(b)
    return out


def _index(tree, r: int):
    if isinstance(tree, Mapping):
        return {k: _index(v, r) for k, v in tree.items()}
    return np.asarray(tree)[r]


def init_caches(
    cfg: ModelConfig, batch: int, cache_len: int, per_slot: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict:
    """Zeroed, layer-stacked caches: KV caches for attention layers, RWKV
    and RG-LRU states for their layers.  ``per_slot=True`` carries one position per
    batch row (``pos: (B,)`` in each layer), the serving engine's layout;
    otherwise one shared scalar position."""
    device = resolve_device(device)
    pattern = cfg.block_pattern
    reps, rem = divmod(cfg.num_layers, len(pattern))

    def one(btype: str) -> Dict:
        mixer, _ = _parse(btype)
        if mixer == "rwkv":  # constant in cache_len
            return rwkv_mod.init_rwkv_state(cfg, batch, per_slot=per_slot, device=device)
        if mixer == "rglru":  # constant in cache_len
            return rglru_mod.init_rglru_state(cfg, batch, per_slot=per_slot, device=device)
        return attn_mod.init_cache(
            cfg, batch, cache_len, _mixer_window(cfg, mixer), per_slot=per_slot, device=device
        )

    unit = tuple(
        {name: x.expand((reps,) + x.shape).contiguous() for name, x in one(bt).items()} for bt in pattern
    )
    return {"unit": unit, "rem": tuple(one(pattern[j]) for j in range(rem))}


# ------------------------------------------------------------------ forward


def _apply_block(
    cfg: ModelConfig, p: Dict, btype: str, x: torch.Tensor, positions: torch.Tensor,
    cache: Optional[Dict], use_flash: bool,
) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """-> (x, the layer's new cache, the MoE aux loss (0 for other FFNs))."""
    mixer, ffn = _parse(btype)
    h = L.apply_norm(cfg, p["norm1"], x)
    if mixer == "rwkv":
        y, new_cache = rwkv_mod.apply_rwkv_tmix(cfg, p["mixer"], h, cache, use_kernel=use_flash)
    elif mixer == "rglru":
        y, new_cache = rglru_mod.apply_rglru(cfg, p["mixer"], h, cache)
    else:
        y, new_cache = attn_mod.apply_attention(
            cfg, p["mixer"], h, positions, cache, _mixer_window(cfg, mixer), use_flash
        )
    x = x + y
    h = L.apply_norm(cfg, p["norm2"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn == "cmix":  # cmix shares the rwkv state dict
        y, new_cache = rwkv_mod.apply_rwkv_cmix(cfg, p["ffn"], h, new_cache)
    elif ffn == "moe":
        y, aux = moe_mod.apply_moe(cfg, p["ffn"], h)
    else:
        y = L.apply_mlp(cfg, p["ffn"], h)
    return x + y, new_cache, aux


def _embed_in(
    cfg: ModelConfig, params: Dict, tokens: Optional[torch.Tensor], positions: torch.Tensor,
    embeds: Optional[torch.Tensor],
) -> torch.Tensor:
    dtype = L.torch_dtype(cfg.dtype)
    if embeds is not None:
        x = embeds.to(dtype)
    else:
        x = _embed_rows(params["embed"]["w"], tokens).to(dtype)
    if cfg.embed_scale:
        # the factor is rounded to the activation dtype first, as in JAX
        x = x * float(torch.tensor(cfg.d_model**0.5, dtype=dtype))
    if cfg.pos_style == "sinusoidal":
        pos = positions if positions.ndim == 2 else positions[0]
        x = x + L.sinusoidal_positions(pos, cfg.d_model).to(x.dtype)
    return x


def _embed_rows(w: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' rows of the table ``w``.  On a DTensor table sharded on
    the vocabulary (``vocab_w``), each device reads the tokens in its own
    slice (zeros elsewhere) and the slices are summed (vocabulary-parallel,
    through ``local_map``); the table's other dims are gathered first."""
    if not shards_dim(w, 0):
        return w[tokens]
    from torch.distributed.tensor import Partial, Replicate

    mesh = w.device_mesh
    w = w.redistribute(mesh, tuple(p if p.is_shard(0) else Replicate() for p in w.placements))
    vocab = [i for i, p in enumerate(w.placements) if p.is_shard(0)]
    t_place = tuple(
        Replicate() if i in vocab else (tokens.placements[i] if is_dtensor(tokens) else Replicate())
        for i in range(mesh.ndim)
    )
    tokens = lay_out(tokens, mesh, t_place)
    out_place = [Partial() if i in vocab else t_place[i] for i in range(mesh.ndim)]
    lo = local_offset(w, 0)

    def local(table, t):
        idx = t.long() - lo
        mine = (idx >= 0) & (idx < table.shape[0])
        rows = table[torch.where(mine, idx, 0)]
        return rows * mine[..., None].to(rows.dtype)

    return local_map(local, out_placements=out_place, in_placements=(tuple(w.placements), t_place), device_mesh=mesh)(
        w, tokens
    )


def _layer_cache(caches: Dict, cfg: ModelConfig, layer: int) -> Dict:
    n = len(cfg.block_pattern)
    reps = cfg.num_layers // n
    r, j = divmod(layer, n)
    if r < reps:
        return {name: x[r] for name, x in caches["unit"][j].items()}
    return caches["rem"][j]


def _run_layers(
    cfg: ModelConfig, blocks: List[Dict], layer_types: Tuple[str, ...], x: torch.Tensor, aux: torch.Tensor,
    positions: torch.Tensor, use_flash: bool, unit: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layers without caches, their aux losses added to ``aux`` in order.
    The residual stream of a repeat ``unit``'s layers is constrained after
    each (``launch/sharding.constrain``), as JAX's layer scan does."""
    for p, btype in zip(blocks, layer_types):
        x, _, a = _apply_block(cfg, p, btype, x, positions, None, use_flash)
        if unit:
            x = constrain(x, "act_batch", "act_seq", "act_embed")
        aux = aux + a
    return x, aux


def _forward_remat(
    cfg: ModelConfig, params: Dict, x: torch.Tensor, aux: torch.Tensor, positions: torch.Tensor,
    use_flash: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cfg.remat``: each repeat unit of the block pattern is checkpointed,
    its activations recomputed in the backward pass, and the remainder
    layers are not, as JAX checkpoints its layer scan's body.  The same
    operations in the same order as without remat, so the loss and the
    gradients are the same bits."""
    from torch.utils.checkpoint import checkpoint

    n = len(cfg.block_pattern)
    reps = cfg.num_layers // n
    blocks = params["blocks"]
    for r in range(reps):
        x, aux = checkpoint(
            _run_layers, cfg, blocks[r * n : (r + 1) * n], cfg.block_pattern, x, aux, positions, use_flash, True,
            use_reentrant=False, preserve_rng_state=False,  # the forward draws no random numbers
        )
    rest = cfg.layer_types()[reps * n :]
    return _run_layers(cfg, blocks[reps * n :], rest, x, aux, positions, use_flash)


def forward(
    cfg: ModelConfig,
    params: Dict,
    tokens: Optional[torch.Tensor],
    positions: torch.Tensor,
    caches: Optional[Dict] = None,
    embeds: Optional[torch.Tensor] = None,
    use_flash: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """-> (final hidden (B, S, D), new caches, total aux loss).  The aux
    loss is the MoE layers' sum, in layer order, on the no-cache path, and
    0 with caches, as in JAX.  ``embeds`` (B, S, D) replaces the token
    embeddings.  With caches, each layer's tensors are written in place
    (module docstring).  With ``cfg.remat``, a pass without caches that
    records gradients checkpoints each repeat unit (``_forward_remat``)."""
    x = constrain(_embed_in(cfg, params, tokens, positions, embeds), "act_batch", "act_seq", "act_embed")
    layer_types = cfg.layer_types()
    new_pos: List[torch.Tensor] = []
    new_rem: List[Dict] = []
    reps = cfg.num_layers // len(cfg.block_pattern)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if caches is None and cfg.remat and torch.is_grad_enabled():
        x, aux = _forward_remat(cfg, params, x, aux, positions, use_flash)
        return L.apply_norm(cfg, params["final_norm"], x), None, aux
    for i, (p, btype) in enumerate(zip(params["blocks"], layer_types)):
        cache = None if caches is None else _layer_cache(caches, cfg, i)
        x, nc, a = _apply_block(cfg, p, btype, x, positions, cache, use_flash)
        if caches is None:
            if i < reps * len(cfg.block_pattern):
                x = constrain(x, "act_batch", "act_seq", "act_embed")
            aux = aux + a
        elif i < reps * len(cfg.block_pattern):
            new_pos.append(nc["pos"])
        else:
            new_rem.append(nc)
    new_caches = None
    if caches is not None:
        n = len(cfg.block_pattern)
        unit = tuple(
            {**u, "pos": torch.stack(new_pos[j::n]) if reps else u["pos"]}
            for j, u in enumerate(caches["unit"])
        )
        new_caches = {"unit": unit, "rem": tuple(new_rem)}
    x = L.apply_norm(cfg, params["final_norm"], x)
    return x, new_caches, aux


def _head_weight(cfg: ModelConfig, params: Dict) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"]["w"].T  # (D, V)
    return params["lm_head"]["w"]


def logits_from_hidden(cfg: ModelConfig, params: Dict, hidden: torch.Tensor) -> torch.Tensor:
    """Logits over the padded vocabulary, in the hidden's dtype."""
    logits = matmul(hidden, _head_weight(cfg, params).to(hidden.dtype))
    if cfg.logits_soft_cap:
        c = cfg.logits_soft_cap
        logits = torch.tanh(logits / c) * c
    return logits


def decode_step(
    cfg: ModelConfig,
    params: Dict,
    tokens: torch.Tensor,  # (B, 1) int
    caches: Dict,
    use_flash: bool = False,
) -> Tuple[torch.Tensor, Dict]:
    """One-token decode against the caches -> (logits (B, 1, V_pad), new
    caches).  A per-slot cache decodes each row at its own position."""
    b = tokens.shape[0]
    pos = _cache_pos(caches)
    if pos.ndim:  # per-slot (B,)
        positions = pos[:, None].to(torch.int32)
    else:
        positions = pos.to(torch.int32).expand(b, 1)
    hidden, new_caches, _ = forward(
        cfg, params, tokens, mrope_streams(cfg, positions), caches, use_flash=use_flash
    )
    return logits_from_hidden(cfg, params, hidden), new_caches


def mrope_streams(cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """Positions as the model takes them: (B, S) positions of an ``mrope``
    model become its three M-RoPE streams (3, B, S), equal for text;
    anything else is returned as it is."""
    if cfg.pos_style == "mrope" and positions.ndim == 2:
        return positions[None].expand((3,) + tuple(positions.shape))
    return positions


def _cache_pos(caches: Dict) -> torch.Tensor:
    """Current position(s): () shared-scalar or (B,) per-slot.  Every layer
    holds the same position, so read the first one."""
    if caches["unit"] and caches["unit"][0]["pos"].shape[0]:
        return caches["unit"][0]["pos"][0]
    return caches["rem"][0]["pos"]


def param_count(params: Dict) -> int:
    def count(tree) -> int:
        if isinstance(tree, torch.Tensor):
            return tree.numel()
        if isinstance(tree, Mapping):
            return sum(count(v) for v in tree.values())
        return sum(count(v) for v in tree)

    return count(params)


def _gold(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The targets' logits.  On DTensor logits sharded on the vocabulary
    (``vocab_w``), each device reads the targets in its own slice and the
    slices' results are summed (vocabulary-parallel, through
    ``local_map``), rather than gathering the logits."""
    last = logits.ndim - 1
    if not shards_dim(logits, last):
        return logits.gather(-1, targets[..., None].long())[..., 0]
    from torch.distributed.tensor import Partial, Replicate

    mesh, place = logits.device_mesh, tuple(logits.placements)
    lo = local_offset(logits, last)  # the vocabulary may be cut on more than one mesh axis
    t_place = tuple(Replicate() if p.is_shard(last) else p for p in place)
    targets = lay_out(targets, mesh, t_place)

    def local(lg, t):
        idx = t.long() - lo
        mine = (idx >= 0) & (idx < lg.shape[-1])
        picked = lg.gather(-1, torch.where(mine, idx, 0)[..., None])[..., 0]
        return torch.where(mine, picked, 0.0)

    out_place = tuple(Partial() if p.is_shard(last) else p for p in place)
    return local_map(local, out_placements=list(out_place), in_placements=(place, t_place), device_mesh=mesh)(
        logits, targets
    )


def lm_loss(
    cfg: ModelConfig,
    params: Dict,
    tokens: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    loss_chunk: Optional[int] = None,
    use_flash: bool = False,
    embeds: Optional[torch.Tensor] = None,
    targets: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Next-token cross-entropy, mean over the B * (S - 1) predictions.

    The logits are formed ``loss_chunk`` (default ``cfg.loss_chunk``)
    positions at a time, with a shorter tail chunk, so (B, S, V) logits
    never exist at once; each chunk is soft-capped as configured and its
    CE taken in fp32, and the chunks' sums are added in order, as in the
    JAX package.  ``targets`` default to the shifted tokens (a (B, S)
    tensor is shifted, a (B, S - 1) one is taken as it is).  ``use_flash``
    routes attention through K6 and the RWKV time mix through K7, both
    forward-only.  ``cfg.remat`` checkpoints each repeat unit of a pass
    that records gradients, as in JAX (``forward``).  The VLM and audio
    frontends pass ``embeds`` (B, S, D) and ``targets`` in place of tokens.
    The MoE layers' aux loss is added."""
    if tokens is None and (embeds is None or targets is None):
        raise ValueError("lm_loss takes tokens, or embeds with targets")
    x = tokens if tokens is not None else embeds
    b, s = x.shape[:2]
    if positions is None:
        positions = shard_like(torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s), x)
    hidden, _, aux = forward(
        cfg, params, tokens, mrope_streams(cfg, positions), embeds=embeds, use_flash=use_flash
    )
    h_in = hidden[:, :-1]
    if targets is None:
        targets = tokens[:, 1:]
    elif targets.shape[1] == s:
        targets = targets[:, 1:]
    n = h_in.shape[1]
    chunk = min(loss_chunk or cfg.loss_chunk, n)
    w = _head_weight(cfg, params)

    def ce(h_c: torch.Tensor, t_c: torch.Tensor) -> torch.Tensor:
        logits = matmul(h_c, w.to(h_c.dtype))
        if cfg.logits_soft_cap:
            logits = torch.tanh(logits / cfg.logits_soft_cap) * cfg.logits_soft_cap
        logits = logits.float()
        return torch.sum(torch.logsumexp(logits, dim=-1) - _gold(logits, t_c))

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, n, chunk):  # full chunks, then the tail
        total = total + ce(h_in[:, i : i + chunk], targets[:, i : i + chunk])
    return total / (b * n) + aux


def features(
    cfg: ModelConfig,
    params: Dict,
    tokens: Optional[torch.Tensor] = None,
    embeds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits of the last position (B, 1, V_pad), mean final hidden (B, D))
    — the FL data profile of an LM client, at positions 0 .. S - 1.  Plain
    attention, as in the JAX package.  ``embeds`` (B, S, D) replaces the
    tokens."""
    x = tokens if tokens is not None else embeds
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    hidden, _, _ = forward(cfg, params, tokens, mrope_streams(cfg, positions), embeds=embeds)
    return logits_from_hidden(cfg, params, hidden[:, -1:]), hidden.mean(dim=1)
