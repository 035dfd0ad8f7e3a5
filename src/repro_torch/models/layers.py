"""Shared decoder-LM layers: dense, norms, position encodings (RoPE,
M-RoPE, sinusoidal), MLP variants.

Plain init/apply pairs over dicts of tensors, as in the JAX package, with
its layouts: activations (B, S, D), a dense weight (d_in, d_out) applied as
``x @ w``.  The dtype points are the JAX package's: norms compute in fp32
and cast back, RoPE rotates in fp32 and casts back, MLPs stay in the
activation dtype, and their activations round where XLA's do (``sigmoid``,
``silu``, ``gelu_tanh``).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.sharding import matmul, replicate_dims

__all__ = [
    "rms_norm",
    "layer_norm",
    "init_norm",
    "apply_norm",
    "rope_freqs",
    "apply_rope",
    "apply_mrope",
    "sinusoidal_positions",
    "sigmoid",
    "silu",
    "gelu_tanh",
    "init_mlp",
    "apply_mlp",
    "init_dense",
    "dense",
]

Params = Dict[str, torch.Tensor]


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name ("float32", "bfloat16") as a torch dtype."""
    return getattr(torch, name)


def init_dense(
    generator: torch.Generator, d_in: int, d_out: int, dtype: torch.dtype, device
) -> Params:
    """Normal weights of std ``d_in ** -0.5``, drawn in fp32 and cast."""
    w = torch.randn(d_in, d_out, generator=generator, device=device) * d_in**-0.5
    return {"w": w.to(dtype)}


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    return matmul(x, p["w"])


# ----------------------------------------------------------------- norms


def init_norm(cfg: ModelConfig, device) -> Params:
    d = cfg.d_model
    dtype = torch_dtype(cfg.param_dtype)
    p = {"scale": torch.ones(d, dtype=dtype, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros(d, dtype=dtype, device=device)
    return p


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """The config's norm over the last dim (of a DTensor, gathered first:
    the statistics need whole rows)."""
    x = replicate_dims(x, x.ndim - 1)
    if cfg.norm_type == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


# ----------------------------------------------------------------- RoPE


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponents)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate pairs, half-split convention: (x1, x2) are the two halves of
    the head dim.  Computes in fp32 (``angles`` is fp32) and casts back."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos, sin = torch.cos(angles), torch.sin(angles)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Standard RoPE.  x: (B, S, H, hd); positions: (B, S) int."""
    inv = rope_freqs(x.shape[-1], theta, device=x.device)  # (hd/2,)
    ang = positions.float()[..., None] * inv  # (B, S, hd/2)
    return _rotate(x, ang[:, :, None, :])


def apply_mrope(
    x: torch.Tensor, positions: torch.Tensor, theta: float, sections: Tuple[int, int, int]
) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL §2.1): the hd/2 frequency slots are split
    into (t, h, w) sections, each rotated by its own position stream.

    x: (B, S, H, hd); positions: (3, B, S) int — temporal, height, width.
    For text all three streams are equal and M-RoPE is RoPE."""
    d2 = x.shape[-1] // 2
    if sum(sections) != d2:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to head_dim / 2 = {d2}")
    if positions.ndim != 3 or positions.shape[0] != 3:
        raise ValueError(f"M-RoPE positions must be (3, B, S), got {tuple(positions.shape)}")
    inv = rope_freqs(x.shape[-1], theta, device=x.device)  # (hd/2,)
    sec_id = torch.tensor([i for i, n in enumerate(sections) for _ in range(n)], device=x.device)
    pos_per_slot = positions.float()[sec_id]  # (hd/2, B, S)
    ang = pos_per_slot.movedim(0, -1) * inv  # (B, S, hd/2)
    return _rotate(x, ang[:, :, None, :])


def sinusoidal_positions(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Sinusoidal absolute embeddings (musicgen), fp32: the sines of
    positions · exp(−log(10⁴) · i / half), then their cosines.
    positions: (B, S) -> (B, S, d_model)."""
    half = d_model // 2
    log_base = torch.log(torch.tensor(10_000.0, device=positions.device))
    freqs = torch.exp(-log_base * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ----------------------------------------------------------------- MLPs


def init_mlp(generator: torch.Generator, cfg: ModelConfig, device) -> Dict[str, Params]:
    dtype = torch_dtype(cfg.param_dtype)
    ff = cfg.d_ff
    p = {"wi": init_dense(generator, cfg.d_model, ff, dtype, device)}
    if cfg.mlp_variant in ("swiglu", "geglu"):
        p["wg"] = init_dense(generator, cfg.d_model, ff, dtype, device)
    p["wo"] = init_dense(generator, ff, cfg.d_model, dtype, device)
    return p


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA expands it: 1 / (1 + exp(−x)), each of the
    three operations rounded to x's dtype.  In bf16 this parts from
    ``torch.sigmoid`` (one rounding) in about a third of elements."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x times its sigmoid rounded to x's dtype."""
    return x * sigmoid(x)


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: a product with it
    rounds as a product with a constant of that dtype does."""
    return float(torch.tensor(value, dtype=dtype))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)`` as XLA expands it: x · 0.5 (1 +
    tanh(c (x + a x³))), each operation rounded to x's dtype, with c =
    √(2/π) and a = 0.044715 rounded to that dtype first (a Python float
    would enter the products unrounded).  In bf16 this parts from
    ``F.gelu(approximate="tanh")`` in about a third of elements."""
    c = _rounded(math.sqrt(2.0 / math.pi), x.dtype)
    a = _rounded(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + a * (x * x * x)))))


def apply_mlp(cfg: ModelConfig, p: Dict[str, Params], x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_variant == "swiglu":
        h = silu(dense(p["wg"], x)) * dense(p["wi"], x)
    elif cfg.mlp_variant == "geglu":
        h = gelu_tanh(dense(p["wg"], x)) * dense(p["wi"], x)
    elif cfg.mlp_variant == "gelu":
        h = gelu_tanh(dense(p["wi"], x))
    else:
        raise ValueError(f"unknown mlp_variant {cfg.mlp_variant!r}")
    return dense(p["wo"], h)
