"""Similarity kernel construction from client data profiles (paper §3.2).

Implements eq. (14): pairwise L2 distances between profiles, min-max
normalised and flipped into similarities ``S``, then the PSD DPP kernel
``L = Sᵀ S``.

Two execution paths:

* **Plain ops** (default, ``use_kernel=False``): a chain of PyTorch ops
  (expansion distances → sqrt → min-max → matmul).
* **Kernels** (``use_kernel=True``): :func:`kernel_from_profiles` and
  :func:`candidate_kernel` run the chain as two CUDA launches, K1 then K2
  (``repro_torch.kernels.gram.ops``), on the profiles' device; the
  similarity matrix never reaches device memory.  The stage-wise helpers
  (:func:`pairwise_sq_dists`, and :func:`pairwise_dists` and
  :func:`similarity_matrix` through it) route just the distance stage
  through its own kernel, K3 (``repro_torch.kernels.pairwise_l2.ops``);
  ``kernels.gram.ops.gram`` (K4) then forms ``L = SᵀS`` of their ``S``.
"""

from __future__ import annotations

import torch

__all__ = [
    "pairwise_sq_dists",
    "pairwise_dists",
    "similarity_matrix",
    "dpp_kernel",
    "kernel_from_profiles",
    "candidate_kernel",
]


def pairwise_sq_dists(f: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
    """Squared L2 distances between profile rows: (C, Q) -> (C, C), via the
    expansion ``‖a‖² + ‖b‖² − 2 a·b``, clamped at 0 with a zero diagonal.

    ``use_kernel=True`` runs K3 on ``f``'s device instead (fp32 out; on the
    card it sums ``(a − b)²`` directly, which does not cancel)."""
    if use_kernel:
        from repro_torch.kernels.pairwise_l2 import ops as _ops

        return _ops.pairwise_sq_dists(f)
    sq = torch.sum(f * f, dim=-1)
    d2 = torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * (f @ f.T), 0.0)
    # the expansion is exact-zero-free on the diagonal only up to fp error;
    # pin it (distance to self) so eq.-(14) keeps an exact unit diagonal.
    return d2 * (1.0 - torch.eye(d2.shape[0], dtype=d2.dtype, device=d2.device))


def pairwise_dists(f: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
    """L2 distances ``s⁰_{m,n} = ‖f_m − f_n‖₂`` (paper eq. 14)."""
    return torch.sqrt(pairwise_sq_dists(f, use_kernel=use_kernel))


def similarity_matrix(f: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
    """Similarity matrix ``S`` per eq. (14):
    ``s_{m,n} = 1 − (s⁰_{m,n} − min(S⁰)) / (max(S⁰) − min(S⁰))``, values in
    [0, 1] with a unit diagonal."""
    s0 = pairwise_dists(f, use_kernel=use_kernel)
    lo = torch.amin(s0)
    hi = torch.amax(s0)
    rng = torch.clamp_min(hi - lo, 1e-30)
    return 1.0 - (s0 - lo) / rng


def dpp_kernel(s: torch.Tensor) -> torch.Tensor:
    """DPP kernel ``L = Sᵀ S`` — PSD by construction (Gram matrix)."""
    return s.T @ s


def kernel_from_profiles(f: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
    """Profiles (C, Q) -> PSD k-DPP kernel (C, C): eq. (14) then L = SᵀS.

    ``use_kernel=True`` runs the two-launch K1 + K2 pipeline on ``f``'s
    device instead of the op chain.
    """
    if use_kernel:
        from repro_torch.kernels.gram import ops as _gram_ops

        return _gram_ops.kernel_from_profiles(f, device=f.device)
    return dpp_kernel(similarity_matrix(f))


def candidate_kernel(
    f: torch.Tensor, candidates: torch.Tensor, use_kernel: bool = False
) -> torch.Tensor:
    """Q×Q eq.-(14) kernel over a funnel candidate block.

    Semantics: ``kernel_from_profiles(f[candidates])`` — the min-max
    normalisation runs over the *candidate* distance block, NOT the full
    federation, so this is deliberately **not** a submatrix of the C×C
    kernel.  (With ``candidates == arange(C)`` the two coincide.)
    """
    fq = torch.index_select(f, 0, torch.as_tensor(candidates, device=f.device).long())
    if use_kernel:
        from repro_torch.kernels.gram import ops as _gram_ops

        return _gram_ops.candidate_kernel_from_profiles(fq, device=fq.device)
    return kernel_from_profiles(fq, use_kernel=False)
