"""Per-slot token sampling for the serving engine.

Greedy (``temperature == 0``) is a static branch that computes exactly
``argmax(logits[:, 0])``, the legacy loop's choice, and draws nothing.
Temperature sampling is ``argmax(logits / T + g)`` with Gumbel noise ``g``
of shape (B, V) handed in, which is what ``jax.random.categorical``
computes: fed JAX's own Gumbel draws, it gives JAX's tokens.  The engine
draws each slot's row of ``g`` from that slot's own ``torch.Generator``,
seeded at admission, so slots stay independent however they were
refilled.
"""

from __future__ import annotations

from typing import List, Optional

import torch

__all__ = ["gumbel_rows", "sample_tokens", "slot_noise"]


def gumbel_rows(generators: List[torch.Generator], vocab: int, dtype: torch.dtype) -> torch.Tensor:
    """(B, vocab) standard Gumbel noise, row b from ``generators[b]`` (each
    on the device the noise is made on): ``-log(-log(u))`` with u uniform
    in [tiny, 1), as ``jax.random.gumbel`` draws it."""
    tiny = torch.finfo(dtype).tiny
    rows = []
    for gen in generators:
        u = torch.rand(vocab, generator=gen, device=gen.device, dtype=dtype).clamp_min_(tiny)
        rows.append(-torch.log(-torch.log(u)))
    return torch.stack(rows)


def slot_noise(
    logits: torch.Tensor, temperature: float, generators: List[torch.Generator]
) -> Optional[torch.Tensor]:
    """The noise ``sample_tokens`` needs for ``logits`` (B, 1, V): one Gumbel
    row per slot from that slot's generator, in the logits' dtype as JAX
    draws it; None when greedy, which draws nothing."""
    if temperature == 0.0:
        return None
    return gumbel_rows(generators, logits.shape[-1], logits.dtype)


def sample_tokens(
    logits: torch.Tensor,  # (B, 1, V)
    temperature: float,  # static; 0.0 = greedy
    gumbel: Optional[torch.Tensor] = None,  # (B, V) noise; unused when greedy
) -> torch.Tensor:
    """-> tokens (B,) int32."""
    if temperature == 0.0:
        return torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
    if gumbel is None or gumbel.shape != logits[:, 0].shape:
        raise ValueError(f"temperature sampling needs (B, V) Gumbel noise for logits {tuple(logits.shape)}")
    scaled = logits[:, 0] / temperature
    return torch.argmax(gumbel.to(scaled.dtype) + scaled, dim=-1).to(torch.int32)
