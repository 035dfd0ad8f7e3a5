"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Block:  y = W_out( GeLU(W_gate x) ⊙ RG-LRU(causal_conv1d(W_in x)) )

RG-LRU, per channel:
    r_t = σ(W_r ξ_t + b_r)                 recurrence gate
    i_t = σ(W_i ξ_t + b_i)                 input gate
    a_t = exp(−c · softplus(Λ) · r_t)      data-dependent decay (c = 8)
    h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ ξ_t)

The JAX package's module as plain PyTorch, with its dtype points: the
depthwise causal conv (width 4) runs in the activation dtype, one rounding
per product and sum; the gates' products and biases run in the activation
dtype and the gates, decays and ``h`` in fp32; ``Λ`` is fp32 whatever
``cfg.param_dtype``; the GeLU gate rounds as JAX's (``layers.gelu_tanh``).

Without a state the recurrence runs in the parallel form, an associative
scan over time that pairs elements as ``lax.associative_scan`` does, so
the fp32 products group as JAX's.  With a state it runs step by step from
``state["h"]``: serving's prefill and decode both take this path, as in
JAX.  The state of a layer is ``{"conv": (B, 3, d_rnn) in the activation
dtype (the last three conv inputs), "h": (B, d_rnn) fp32, "pos": () |
(B,)}``; ``apply_rglru`` writes ``conv`` and ``h`` **in place** (the
layer's row of the stacked caches, as ``rwkv6.apply_rwkv_tmix`` writes its
state) and returns a dict that shares them, with a new ``pos``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.sharding import is_dtensor, local_map, matmul
from repro_torch.models import layers as L

__all__ = ["init_rglru", "init_rglru_state", "apply_rglru"]

_C = 8.0
_CONV_W = 4  # causal conv width (Griffin's)


def _rnn_width(cfg: ModelConfig) -> int:
    return cfg.rnn_width or cfg.d_model


def init_rglru(generator: torch.Generator, cfg: ModelConfig, device) -> Dict:
    """JAX's laws: dense weights as ``layers.init_dense``, the conv N(0,
    0.1²), biases 0, and Λ fp32 such that a ∈ (0.9, 0.999) at r = 1
    (Griffin's appendix)."""
    dtype = L.torch_dtype(cfg.param_dtype)
    d, dr = cfg.d_model, _rnn_width(cfg)
    u = torch.rand(dr, generator=generator, device=device) * (0.999**2 - 0.9**2) + 0.9**2
    lam = torch.log(torch.expm1(-torch.log(u) / (2.0 * _C)))  # softplus^-1
    zeros = lambda: torch.zeros(dr, dtype=dtype, device=device)  # noqa: E731
    return {
        "w_in": L.init_dense(generator, d, dr, dtype, device),
        "w_gate": L.init_dense(generator, d, dr, dtype, device),
        "w_out": L.init_dense(generator, dr, d, dtype, device),
        "conv_w": (torch.randn(_CONV_W, dr, generator=generator, device=device) * 0.1).to(dtype),
        "conv_b": zeros(),
        "w_r": L.init_dense(generator, dr, dr, dtype, device),
        "b_r": zeros(),
        "w_i": L.init_dense(generator, dr, dr, dtype, device),
        "b_i": zeros(),
        "lam": lam.float(),
    }


def init_rglru_state(cfg: ModelConfig, batch: int, per_slot: bool = False, device=None) -> Dict:
    dr = _rnn_width(cfg)
    return {
        "conv": torch.zeros(batch, _CONV_W - 1, dr, dtype=L.torch_dtype(cfg.dtype), device=device),
        "h": torch.zeros(batch, dr, dtype=torch.float32, device=device),
        "pos": torch.zeros((batch,) if per_slot else (), dtype=torch.int32, device=device),
    }


def _causal_conv(p: Dict, xi: torch.Tensor, buf: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over (B, S, d_rnn) -> (output, the last W - 1
    inputs).  ``buf`` holds the W - 1 inputs before ``xi`` (zeros
    without a state).  Sums in JAX's order, each step rounded to xi's
    dtype: ((0 + t_0) + t_1) + ... + conv_b."""
    if buf is None:
        buf = torch.zeros(xi.shape[0], _CONV_W - 1, xi.shape[2], dtype=xi.dtype, device=xi.device)
    full = torch.cat([buf.to(xi.dtype), xi], dim=1)
    s = xi.shape[1]
    out = sum(full[:, i : i + s, :] * p["conv_w"][i] for i in range(_CONV_W)) + p["conv_b"]
    return out, full[:, -(_CONV_W - 1) :, :]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gates(p: Dict, xi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (a, b) of h_t = a_t h_{t−1} + b_t, fp32."""
    r = L.sigmoid((matmul(xi, p["w_r"]["w"]) + p["b_r"]).float())
    i = L.sigmoid((matmul(xi, p["w_i"]["w"]) + p["b_i"]).float())
    log_a = -_C * _softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * (i * xi.float())
    return a, b


def _combine(lhs: Tuple[torch.Tensor, torch.Tensor], rhs: Tuple[torch.Tensor, torch.Tensor]):
    """(a, b) ∘ (a', b') = (a a', a' b + b'): ``lhs`` then ``rhs``."""
    al, bl = lhs
    ar, br = rhs
    return al * ar, ar * bl + br


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Along axis 1: even[0], odd[0], even[1], ... (len(even) - len(odd)
    is 0 or 1)."""
    out = torch.empty(
        (even.shape[0], even.shape[1] + odd.shape[1]) + even.shape[2:], dtype=even.dtype, device=even.device
    )
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _associative_scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``_combine`` over axis 1, by ``lax.associative_scan``'s
    recursion: combine adjacent pairs, scan the halved sequence (the odd
    results), combine each with the next even element (the even results),
    interleave."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd_a, odd_b = _associative_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        ev_a, ev_b = _combine((odd_a[:, :-1], odd_b[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ev_a, ev_b = _combine((odd_a, odd_b), (a[:, 2::2], b[:, 2::2]))
    ev_a = torch.cat([a[:, :1], ev_a], dim=1)
    ev_b = torch.cat([b[:, :1], ev_b], dim=1)
    return _interleave(ev_a, odd_a), _interleave(ev_b, odd_b)


def _scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_associative_scan`; on DTensors, on each device's rows and
    channels through ``local_map`` (the channels are independent), the
    sequence gathered first where it is sharded."""
    if not is_dtensor(a):
        return _associative_scan(a, b)
    from torch.distributed.tensor import Replicate

    mesh = a.device_mesh
    place = tuple(Replicate() if p.is_shard(1) or p.is_partial() else p for p in a.placements)
    a, b = a.redistribute(mesh, place), b.redistribute(mesh, place)
    return local_map(_associative_scan, out_placements=(place, place), in_placements=(place, place),
                     device_mesh=mesh)(a, b)


def apply_rglru(
    cfg: ModelConfig, p: Dict, x: torch.Tensor, state: Optional[Dict] = None
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, D) -> (y, new state).  ``state=None``: the parallel form
    from h_0 = 0; otherwise step by step from ``state["h"]``, writing the
    state in place (module docstring)."""
    gate = L.gelu_tanh(L.dense(p["w_gate"], x))
    xi = L.dense(p["w_in"], x)

    if state is None:
        xi, _ = _causal_conv(p, xi, None)
        a, b = _gates(p, xi)  # (B, S, d_rnn) fp32
        _, h = _scan(a, b)
        new_state = None
    else:
        xi, new_buf = _causal_conv(p, xi, state["conv"])
        a, b = _gates(p, xi)
        h_t = state["h"]
        hs = []
        for t in range(x.shape[1]):
            h_t = a[:, t] * h_t + b[:, t]
            hs.append(h_t)
        h = torch.stack(hs, dim=1)
        state["conv"].copy_(new_buf)
        state["h"].copy_(h_t)
        new_state = {"conv": state["conv"], "h": state["h"], "pos": state["pos"] + x.shape[1]}

    y = L.dense(p["w_out"], (gate.float() * h).to(x.dtype))
    return y, new_state
