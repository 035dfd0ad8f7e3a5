"""K1 and K3 wrappers: the CUDA kernel for a CUDA tensor, the plain version
for a CPU tensor.  ``repro_torch.kernels.gram.ops.kernel_from_profiles``
calls K1 as launch 1 of the profiles -> DPP-kernel pipeline;
``repro_torch.core.similarity.pairwise_sq_dists(use_kernel=True)`` calls
K3, the stage-wise route."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pairwise_l2.ref import pairwise_dists_stats_ref, pairwise_sq_dists_ref

__all__ = ["pairwise_dists_stats", "pairwise_sq_dists"]


def _check_profiles(f: torch.Tensor) -> None:
    if f.ndim != 2:
        raise ValueError(f"profiles must be (C, Q), got {tuple(f.shape)}")
    if f.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"profiles must be float32 or bfloat16, got {f.dtype}")
    if f.shape[0] < 1 or f.shape[1] < 1:
        raise ValueError(f"profiles must be non-empty, got {tuple(f.shape)}")
    if f.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {f.device}")
    if f.device.type == "cuda" and not f.is_contiguous():
        raise ValueError("profiles must be contiguous")


def pairwise_sq_dists(f: torch.Tensor) -> torch.Tensor:
    """F (C, Q) fp32 or bf16 -> D2 (C, C) fp32 on F's device:
    ``D2[i, j] = ‖f_i − f_j‖²₂``, clamped at 0, with the diagonal exactly 0
    (K3; bf16 profiles are upcast in the kernel)."""
    _check_profiles(f)
    if f.device.type == "cpu":
        return pairwise_sq_dists_ref(f)
    c, q = f.shape
    lib = _build.library("pairwise_l2")
    d2 = torch.empty((c, c), dtype=torch.float32, device=f.device)
    with _build.on_device(f.device):
        err = lib.pairwise_l2_sq_dists(
            f.data_ptr(), int(f.dtype == torch.bfloat16), c, q, d2.data_ptr(),
            _build.stream(f.device),
        )
    _build.check("pairwise_l2", err, "pairwise_sq_dists")
    _build.LAUNCHES["pairwise_sq_dists"] += 1
    return d2


def pairwise_dists_stats(f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """F (C, Q) fp32 or bf16 -> (S0 (C, C) fp32, lo, hi).

    ``S0[i, j] = ‖f_i − f_j‖₂`` with the diagonal exactly 0; ``lo`` and
    ``hi`` are 0-d fp32 tensors on F's device holding the min and max of S0.
    Nothing is copied to the host.
    """
    _check_profiles(f)
    if f.device.type == "cpu":
        return pairwise_dists_stats_ref(f)
    c, q = f.shape
    lib = _build.library("pairwise_l2")
    tiles = lib.pairwise_l2_tiles(c)
    s0 = torch.empty((c, c), dtype=torch.float32, device=f.device)
    stats = torch.empty((2, tiles, tiles), dtype=torch.float32, device=f.device)
    with _build.on_device(f.device):
        err = lib.pairwise_l2_dists_stats(
            f.data_ptr(), int(f.dtype == torch.bfloat16), c, q,
            s0.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
            _build.stream(f.device),
        )
    _build.check("pairwise_l2", err, "pairwise_dists_stats")
    _build.LAUNCHES["pairwise_dists_stats"] += 1
    return s0, torch.amin(stats[0]), torch.amax(stats[1])
