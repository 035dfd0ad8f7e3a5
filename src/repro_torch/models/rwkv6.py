"""RWKV-6 "Finch" block (arXiv:2404.05892): attention-free time mix with
data-dependent decay, and the squared-ReLU channel mix.

Time mix (per head, k/v/r in R^hd):
    y_t = rᵀ_t (S_{t−1} + diag(u ⊙ k_t) v_tᵀ)     u = per-head bonus
    S_t = diag(w_t) S_{t−1} + k_t v_tᵀ            state (hd_k × hd_v)
with w_t = exp(−exp(w0 + LoRA_w(x̃_t))) a data-dependent per-channel
decay, and r/k/v/w/g formed from token-shift interpolations of x.

The JAX package's module as plain PyTorch, with its layouts and dtype
points: ``w0`` and ``u`` stay fp32 whatever ``cfg.param_dtype``, the decay
and the WKV state are fp32, the group norm computes in fp32 and casts back,
and the gates' sigmoid and SiLU round where JAX's do (``layers.sigmoid``).

The state of a layer is ``{"tm_x", "cm_x": (B, D), "wkv": (B, H, hd, hd)
fp32, "pos": () | (B,)}`` (``init_rwkv_state``).  With a state,
``apply_rwkv_tmix`` and ``apply_rwkv_cmix`` write ``tm_x``, ``wkv`` and
``cm_x`` **in place** (the layer's row of the stacked caches, as
``attention.apply_attention`` writes k/v) and return a dict that shares
those tensors; ``pos`` is a new tensor, never written in place.

``wkv6_scan_ref`` is the plain scan over time; ``use_kernel=True`` routes
the recurrence through K7 (``kernels.rwkv6_scan.ops.wkv6``), which is
forward-only.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.sharding import constrain, is_dtensor, lay_out, local_map, matmul, reshape, split_last
from repro_torch.models import layers as L
from repro_torch.models.layers import sigmoid as _sigmoid
from repro_torch.models.layers import silu as _silu

__all__ = [
    "init_rwkv_tmix",
    "init_rwkv_cmix",
    "init_rwkv_state",
    "apply_rwkv_tmix",
    "apply_rwkv_cmix",
    "wkv6_scan_ref",
]

_LORA_RANK = 32


def _num_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


def init_rwkv_tmix(generator: torch.Generator, cfg: ModelConfig, device) -> Dict:
    """JAX's laws: the μ's U(0, 1); ``w0`` U(−6, −5) and ``u`` N(0, 0.1²),
    both fp32; the LoRA weights N(0, 0.01²); dense weights as
    ``layers.init_dense``; the group-norm scale 1."""
    dtype = L.torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    h, hd = _num_heads(cfg), cfg.rwkv_head_dim

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=device)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)

    p = {f"mu_{n}": uniform(d).to(dtype) for n in ("x", "w", "k", "v", "r", "g")}
    p.update(
        w0=uniform(d) * -1.0 - 5.0,
        a_w=(normal(d, _LORA_RANK) * 0.01).to(dtype),
        b_w=(normal(_LORA_RANK, d) * 0.01).to(dtype),
        u=normal(h, hd) * 0.1,
    )
    for name in ("wr", "wk", "wv", "wg", "wo"):
        p[name] = L.init_dense(generator, d, d, dtype, device)
    p["ln_scale"] = torch.ones(d, dtype=dtype, device=device)
    return p


def init_rwkv_cmix(generator: torch.Generator, cfg: ModelConfig, device) -> Dict:
    dtype = L.torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    return {
        "mu_k": torch.rand(d, generator=generator, device=device).to(dtype),
        "mu_r": torch.rand(d, generator=generator, device=device).to(dtype),
        "wk": L.init_dense(generator, d, cfg.d_ff, dtype, device),
        "wv": L.init_dense(generator, cfg.d_ff, d, dtype, device),
        "wr": L.init_dense(generator, d, d, dtype, device),
    }


def init_rwkv_state(cfg: ModelConfig, batch: int, per_slot: bool = False, device=None) -> Dict:
    """Zeroed state, constant in the sequence length.  ``per_slot`` gives
    ``pos: (B,)`` (one position per row) instead of ``pos: ()``."""
    h, hd = _num_heads(cfg), cfg.rwkv_head_dim
    dtype = L.torch_dtype(cfg.dtype)
    return {
        "tm_x": torch.zeros(batch, cfg.d_model, dtype=dtype, device=device),
        "wkv": torch.zeros(batch, h, hd, hd, dtype=torch.float32, device=device),
        "cm_x": torch.zeros(batch, cfg.d_model, dtype=dtype, device=device),
        "pos": torch.zeros((batch,) if per_slot else (), dtype=torch.int32, device=device),
    }


def _shift(x: torch.Tensor, last: Optional[torch.Tensor]) -> torch.Tensor:
    """Token shift: the previous token's activation (zero, or the state's
    last token, at t = 0)."""
    pad = torch.zeros_like(x[:, :1]) if last is None else last[:, None].to(x.dtype)
    return torch.cat([pad, x[:, :-1]], dim=1)


def wkv6_scan_ref(
    r: torch.Tensor,  # (B, T, H, hd)
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # (B, T, H, hd) decay in (0, 1)
    u: torch.Tensor,  # (H, hd)
    state: torch.Tensor,  # (B, H, hd, hd)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential WKV6 recurrence in fp32, a loop over T -> (y (B, T,
    H, hd) fp32, final state fp32).  ``state`` is not written."""
    r, k, v, w = (a.float() for a in (r, k, v, w))
    bonus = u.float()[None, :, :, None]
    s = state.float()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # (B, H, hd, hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + bonus * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def _group_norm(x: torch.Tensor, scale: torch.Tensor, h: int) -> torch.Tensor:
    """Per-head LayerNorm over hd (RWKV's GroupNorm(heads)): population
    variance, eps 1e-5, in fp32, cast back to x's dtype."""
    b, t, d = x.shape
    xh = split_last(x, h, d // h).float()
    mu = xh.mean(-1, keepdim=True)
    var = torch.square(xh - mu).mean(-1, keepdim=True)
    xh = (xh - mu) * torch.rsqrt(var + 1e-5)
    return (reshape(xh, b, t, d) * scale.float()).to(x.dtype)


def _state_like(s0: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """A fresh (B, H, hd, hd) state laid out as the DTensor ``r``'s rows and
    heads (each rank cutting its own); on plain tensors ``s0`` itself."""
    if not is_dtensor(r):
        return s0
    from torch.distributed.tensor import Replicate, Shard

    place = tuple(Shard(0) if p.is_shard(0) else Shard(1) if p.is_shard(2) else Replicate() for p in r.placements)
    return lay_out(s0, r.device_mesh, place)


def _wkv6_kernel(wkv6, r, k, v, w, u, s0):
    """K7 (or its plain scan) on plain tensors; on DTensors on each
    device's heads and rows through ``local_map`` (JAX's ``shard_map``; the
    heads are independent, and the scan's einsums would flatten a sharded
    head dim), laid out as the state ``s0``: its batch dim's shards give
    r/k/v/w's batch, its heads' shards their heads and the bonus
    ``u``'s."""
    if not is_dtensor(s0):
        return wkv6(r, k, v, w, u, s0)
    from torch.distributed.tensor import Replicate, Shard

    mesh, sp = s0.device_mesh, tuple(s0.placements)
    if any(p.is_shard() and p.dim > 1 for p in sp):
        raise ValueError(f"K7 on a state laid out as {sp}: only its batch and heads may be sharded")
    xp = tuple(Shard(2) if p.is_shard(1) else p for p in sp)
    up = tuple(Shard(0) if p.is_shard(1) else Replicate() for p in sp)
    r, k, v, w = (x.redistribute(mesh, xp) for x in (r, k, v, w))
    u = u.redistribute(mesh, up)

    def local(*args):
        return wkv6(*(a.contiguous() for a in args))

    return local_map(local, out_placements=(xp, sp), in_placements=(xp,) * 4 + (up, sp), device_mesh=mesh)(
        r, k, v, w, u, s0
    )


def apply_rwkv_tmix(
    cfg: ModelConfig,
    p: Dict,
    x: torch.Tensor,
    state: Optional[Dict] = None,
    use_kernel: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Time mix of (B, T, D) activations -> (out, new state).  With a
    state, ``tm_x`` and ``wkv`` are written in place (module docstring)."""
    b, t, d = x.shape
    h, hd = _num_heads(cfg), cfg.rwkv_head_dim
    last = state["tm_x"] if state is not None else None
    delta = _shift(x, last) - x

    xw, xk, xv, xr, xg = (x + delta * p[f"mu_{n}"] for n in ("w", "k", "v", "r", "g"))
    r = split_last(L.dense(p["wr"], xr), h, hd)
    k = split_last(L.dense(p["wk"], xk), h, hd)
    v = split_last(L.dense(p["wv"], xv), h, hd)
    g = _silu(L.dense(p["wg"], xg))
    # data-dependent decay (Finch): w = exp(−exp(w0 + tanh(x̃ A) B)), fp32
    dd = matmul(torch.tanh(matmul(xw, p["a_w"])), p["b_w"])
    logw = -torch.exp(torch.clamp(p["w0"].float() + dd.float(), -20.0, 8.0))
    w = split_last(torch.exp(logw), h, hd)
    # one head layout for the wkv inputs (replicated under the default rules)
    r, k, v, w = (constrain(a, "act_inner_b", "act_seq", "act_rwkv_h", None) for a in (r, k, v, w))

    if state is not None:
        s0 = state["wkv"]
    else:
        s0 = _state_like(torch.zeros(b, h, hd, hd, dtype=torch.float32, device=x.device), r)
    if use_kernel:
        from repro_torch.kernels.rwkv6_scan import ops as wkv_ops

        y, s_new = _wkv6_kernel(wkv_ops.wkv6, r, k, v, w, p["u"], s0)
    else:
        y, s_new = _wkv6_kernel(wkv6_scan_ref, r, k, v, w, p["u"], s0)

    y = _group_norm(reshape(y, b, t, d).to(x.dtype), p["ln_scale"], h)
    out = L.dense(p["wo"], y * g)
    new_state = None
    if state is not None:
        state["tm_x"].copy_(x[:, -1])
        state["wkv"].copy_(s_new)
        new_state = dict(state, pos=state["pos"] + t)
    return out, new_state


def apply_rwkv_cmix(
    cfg: ModelConfig, p: Dict, x: torch.Tensor, state: Optional[Dict] = None
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Channel mix -> (out, state).  With a state, ``cm_x`` is written in
    place; the state dict is the time mix's (``pos`` already advanced)."""
    last = state["cm_x"] if state is not None else None
    delta = _shift(x, last) - x
    xk = x + delta * p["mu_k"]
    xr = x + delta * p["mu_r"]
    kk = torch.square(F.relu(L.dense(p["wk"], xk)))
    out = _sigmoid(L.dense(p["wr"], xr)) * L.dense(p["wv"], kk)
    if state is not None:
        state["cm_x"].copy_(x[:, -1])
        state = dict(state)
    return out, state
