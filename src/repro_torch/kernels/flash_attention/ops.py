"""K5 and K6 wrappers: the CUDA kernel for CUDA tensors, the plain version
for CPU tensors.  ``repro_torch.models.attention.apply_attention`` calls K5
on every decode step with ``use_flash=True``, and K6 on the no-cache
forward with ``use_flash=True`` and no window."""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref, decode_attention_ref

__all__ = ["decode_flops", "decode_plan", "flash_attention", "flash_decode"]

MAX_HEAD_DIM = 256
MAX_GRID_YZ = 65535  # K6's grid holds the query heads in y and the batch in z
_PLANS = {}  # K5's (splits, positions per split) by (B, S, H, Hk, hd, bf16)


def decode_flops(b: int, s: int, h: int, hd: int) -> float:
    """FLOPs of one decode step's attention, every slot against all ``s``
    cache entries: two matmuls (QKᵀ, PV) at 2 per MAC, ``4·b·h·s·hd``."""
    return 4.0 * b * h * s * hd


def flash_attention(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S, Hk, hd)
    v: torch.Tensor,  # (B, S, Hk, hd)
    window: Optional[int] = None,
) -> torch.Tensor:
    """Causal GQA softmax attention -> (B, S, H, hd) in q's dtype.  Query
    head h reads KV head h // (H / Hk); position i attends j <= i, and
    j > i - window with a window; scale hd^-0.5.  On a card the inputs'
    dtype picks the kernel: bf16 runs on the tensor cores (bf16 products,
    fp32 sums and softmax, the unnormalised probabilities carried into the
    PV product as two bf16 halves), fp32 on the CUDA cores in fp32.  On the
    CPU, the plain version computes in fp32.

    Forward only, like the TPU kernel it replaces (no VJP there, no
    backward here): it raises when grad is enabled and an input requires
    grad."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q/k/v must be (B, S, H|Hk, head_dim)")
    b, s, h, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be ({b}, {s}, Hk, {hd})")
    if h % k.shape[2]:
        raise ValueError(f"q heads {h} not a multiple of kv heads {k.shape[2]}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must all be float32 or all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim={hd} must be a multiple of 8 in [8, {MAX_HEAD_DIM}]")
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be >= 1")
    if min(b, s) < 1:
        raise ValueError("q/k/v must be non-empty")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention (K6) is forward-only: it has no backward, as the TPU "
            "kernel has no VJP; run it under torch.no_grad() or take the plain attention"
        )
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"q, k and v must share one device, got {devices}")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary")
    if max(b, h) > MAX_GRID_YZ:
        raise ValueError(f"batch {b} and heads {h} must each be <= {MAX_GRID_YZ}")
    lib = _build.library("flash_attention")
    out = torch.empty_like(q)
    with _build.on_device(q.device):
        err = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), b, s, h, k.shape[2], hd,
            0 if window is None else int(window), hd**-0.5,
            _build.stream(q.device),
        )
    _build.check("flash_attention", err, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return out


def decode_plan(b: int, s: int, h: int, hk: int, hd: int, bf16: bool) -> Tuple[int, int]:
    """K5's split of the KV axis at this shape on the current card: (number
    of splits, positions per split), from the kernel's own library; cached
    by shape."""
    key = (b, s, h, hk, hd, bf16)
    plan = _PLANS.get(key)
    if plan is None:
        split_len = ctypes.c_int()
        ns = _build.library("flash_decode").flash_decode_plan(
            b, s, h, hk, hd, int(bf16), ctypes.byref(split_len))
        plan = _PLANS[key] = (ns, split_len.value)
    return plan


def flash_decode(
    q: torch.Tensor,  # (B, 1, H, hd)
    k: torch.Tensor,  # (B, S, Hk, hd) cached keys
    v: torch.Tensor,  # (B, S, Hk, hd) cached values
    lengths: torch.Tensor,  # (B,) int32 valid prefix per slot
) -> torch.Tensor:
    """Single-query GQA attention of each slot against its first
    ``lengths[b]`` cache entries -> (B, 1, H, hd) in q's dtype.  fp32 math;
    a slot of length 0 gives zeros.  On a card the KV axis is split across
    blocks (:func:`decode_plan`); with more than one split the partial
    results go through an fp32 workspace allocated here, and a second
    kernel merges them within the same launch call.  Fake tensors (the dry
    run) launch nothing: the call returns an output of the kernel's shape
    and dtype and records the FLOPs of every slot against all S entries,
    as the plain version computes them (the lengths have no values
    there); the split's workspace, a few hundred kB, is not allocated."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q/k/v must be (B, 1|S, H|Hk, head_dim)")
    if q.shape[1] != 1:
        raise ValueError(f"flash_decode takes one query per slot, got S={q.shape[1]}")
    b, _, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be (B, S, Hk, {hd})")
    if h % k.shape[2]:
        raise ValueError(f"q heads {h} not a multiple of kv heads {k.shape[2]}")
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be (B,)=({b},), got {tuple(lengths.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must all be float32 or all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim={hd} must be in [1, {MAX_HEAD_DIM}]")
    if min(b, k.shape[1]) < 1:
        raise ValueError("q/k/v must be non-empty")
    device = q.device
    if k.device != device or v.device != device or lengths.device != device:
        devices = {t.device for t in (q, k, v, lengths)}
        raise ValueError(f"q, k, v and lengths must share one device, got {devices}")
    if _build.is_fake(q):
        out = torch.empty_like(q)
        _build.fake_call("flash_decode", decode_flops(b, k.shape[1], h, hd), (q, k, v, lengths, out))
        return out
    if device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32 on the card, got {lengths.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("q, k, v and lengths must be contiguous")
    s, hk = k.shape[1], k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    lib = _build.library("flash_decode")
    ns, _ = decode_plan(b, s, h, hk, hd, bf16)
    out = torch.empty_like(q)
    ws = q.new_empty(b * h * ns * (hd + 2), dtype=torch.float32) if ns > 1 else None
    with _build.on_device(device):
        err = lib.flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), int(bf16), b, s, h, hk, hd, hd**-0.5,
            _build.stream(device),
        )
    _build.check("flash_decode", err, "flash_decode")
    _build.LAUNCHES["flash_decode"] += 1
    return out
