"""K4 and K2 wrappers and the two-launch profiles -> DPP-kernel pipeline.

``repro_torch.core.similarity`` routes through :func:`kernel_from_profiles`
when ``use_kernel=True``.  On a CUDA device the pipeline is two kernel
launches, K1 then K2, and nothing between them: K1 writes the min-max
range that K2 reads.  On the CPU each wrapper runs its plain version.
:func:`gram` (K4) is the plain Gram product ``XᵀX``, the last launch of
the stage-wise route ``gram(similarity_matrix(f, use_kernel=True))``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.gram.ref import gram_ref, normalized_gram_ref
from repro_torch.kernels.pairwise_l2.ops import pairwise_dists_range

__all__ = ["gram", "normalized_gram", "kernel_from_profiles", "candidate_kernel_from_profiles"]

_WORKSPACE = {}  # K4's workspace length (fp32 elements) by (M, N, bf16)


def gram(x: torch.Tensor) -> torch.Tensor:
    """X (M, N) fp32 or bf16 -> ``XᵀX`` (N, N) fp32 on X's device (K4).

    On a card, N <= 128 takes the upper-triangle CUDA-core loop that K2
    shares (bf16 upcast as loaded, fp32 sums), larger N a SYRK on the
    tensor cores: bf16 products with fp32 sums, or 3xTF32 for fp32 X (each
    element split in two TF32 halves, three products).  The result is
    exactly symmetric.  X may have a row stride (a column slice of a wider
    matrix) but its elements must be contiguous along a row.  On the CPU,
    the plain version multiplies in fp32.
    """
    if x.ndim != 2:
        raise ValueError(f"gram expects a 2-D matrix, got {tuple(x.shape)}")
    dtype = x.dtype
    if dtype != torch.float32 and dtype != torch.bfloat16:
        raise TypeError(f"gram takes float32 or bfloat16, got {dtype}")
    m, n = x.shape
    if m < 1 or n < 1:
        raise ValueError(f"gram expects a non-empty matrix, got {tuple(x.shape)}")
    device = x.device
    if device.type == "cpu":
        return gram_ref(x)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    ld, step = x.stride()
    if step != 1 or ld < n:
        raise ValueError(f"x must be contiguous along its rows, got strides {x.stride()}")
    bf16 = dtype == torch.bfloat16
    lib = _build.library("gram")
    key = (m, n, bf16)
    ws_len = _WORKSPACE.get(key)
    if ws_len is None:
        ws_len = _WORKSPACE[key] = lib.gram_workspace(m, n, int(bf16))
    out = x.new_empty((n, n), dtype=torch.float32)
    ws = out.new_empty(ws_len) if ws_len else None
    with _build.on_device(device):
        err = lib.gram_plain(
            x.data_ptr(), int(bf16), m, n, ld, out.data_ptr(),
            None if ws is None else ws.data_ptr(), _build.stream(device),
        )
    _build.check("gram", err, "gram")
    _build.LAUNCHES["gram"] += 1
    return out


def _scalar(x: torch.Tensor, name: str, device: torch.device) -> torch.Tensor:
    """``x`` as a 0-d fp32 tensor on ``device`` (always contiguous)."""
    if x.numel() != 1 or x.dtype != torch.float32 or x.device != device:
        raise ValueError(f"{name} must be one fp32 value on {device}")
    return x if x.ndim == 0 else x.reshape(())


def normalized_gram(
    s0: torch.Tensor,
    lo: torch.Tensor,
    rng: torch.Tensor,
    c: int,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Distances S0 (P, P), P >= c, plus device scalars lo and rng -> the DPP
    kernel L (c, c) fp32.  ``compute_dtype`` (fp32 or bf16) is the type S is
    rounded to before the product; the sum is fp32 either way."""
    if s0.ndim != 2 or s0.shape[0] != s0.shape[1] or s0.dtype != torch.float32:
        raise ValueError(f"s0 must be a square fp32 matrix, got {tuple(s0.shape)} {s0.dtype}")
    if not 1 <= c <= s0.shape[0]:
        raise ValueError(f"c={c} must be in [1, {s0.shape[0]}]")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    device = s0.device
    lo = _scalar(lo, "lo", device)
    rng = _scalar(rng, "rng", device)
    if device.type == "cpu":
        return normalized_gram_ref(s0, lo, rng, c, compute_dtype)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if not s0.is_contiguous():
        raise ValueError("s0 must be contiguous")
    lib = _build.library("gram")
    out = s0.new_empty((c, c))
    with _build.on_device(device):
        err = lib.gram_normalized(
            s0.data_ptr(), s0.shape[1], c, lo.data_ptr(), rng.data_ptr(),
            int(compute_dtype == torch.bfloat16), out.data_ptr(), _build.stream(device),
        )
    _build.check("gram", err, "normalized_gram")
    _build.LAUNCHES["normalized_gram"] += 1
    return out


def kernel_from_profiles(
    f: torch.Tensor, device: Optional[Union[str, torch.device]] = None
) -> torch.Tensor:
    """Profiles (C, Q) -> PSD DPP kernel (C, C) fp32 in two kernel launches.

    Runs on ``device`` (default ``cuda``; raises when there is no CUDA
    device, unless ``device="cpu"``), moving ``f`` there first.  Launch 1
    (K1) gives the distances, their min and ``rng = max(hi − lo, 1e-30)``;
    launch 2 (K2) normalises and forms ``SᵀS``.
    bf16 profiles give bf16 products with fp32 sums.
    """
    f = f.to(resolve_device(device))
    s0, lo, _, rng = pairwise_dists_range(f)
    compute_dtype = torch.bfloat16 if f.dtype == torch.bfloat16 else torch.float32
    return normalized_gram(s0, lo, rng, f.shape[0], compute_dtype)


def candidate_kernel_from_profiles(
    fq: torch.Tensor, device: Optional[Union[str, torch.device]] = None
) -> torch.Tensor:
    """Funnel candidate block (Q, F) -> PSD DPP kernel (Q, Q).

    The ragged-Q twin of :func:`kernel_from_profiles`: the same kernels with
    the same tiling, so a block of all C clients gives exactly the
    unfunneled kernel.
    """
    if fq.ndim != 2:
        raise ValueError(f"candidate profiles must be (Q, F), got {tuple(fq.shape)}")
    return kernel_from_profiles(fq, device=device)
