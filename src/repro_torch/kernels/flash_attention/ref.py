"""Plain PyTorch versions of the flash-attention kernels: exact causal GQA
softmax attention with an optional sliding window, and single-query decode
attention against a cached-KV prefix of per-slot valid length.  Both
compute in fp32 and return q's dtype."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["attention_ref", "decode_attention_ref"]


def attention_ref(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S, Hk, hd)
    v: torch.Tensor,
    window: Optional[int] = None,
) -> torch.Tensor:
    b, s, h, hd = q.shape
    hk = k.shape[2]
    g = h // hk
    qg = q.reshape(b, s, hk, g, hd).float() * hd**-0.5
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    scores = torch.where(mask[None, None, None], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,  # (B, 1, H, hd)
    k: torch.Tensor,  # (B, S, Hk, hd) cached keys
    v: torch.Tensor,
    lengths: torch.Tensor,  # (B,) int valid cache prefix per slot
) -> torch.Tensor:
    """Each slot's single query attends exactly its ``lengths[b]`` cached
    entries; a zero-length slot returns zeros."""
    b, _, h, hd = q.shape
    s, hk = k.shape[1], k.shape[2]
    g = h // hk
    qg = q[:, 0].reshape(b, hk, g, hd).float() * hd**-0.5
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k.float())
    mask = torch.arange(s, device=q.device)[None, :] < lengths[:, None]  # (B, S)
    scores = torch.where(mask[:, None, None, :], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    p = torch.where(mask[:, None, None, :], p, 0.0)  # empty slot -> zeros
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)
