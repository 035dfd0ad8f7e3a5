"""k-DPP sampling (Kulesza & Taskar, ICML'11) in PyTorch.

This is the selection engine of FL-DP3S (paper eq. (12)-(13)): given a PSD
similarity kernel ``L`` over ``C`` clients, sample a subset of fixed size
``k = C_p`` with probability proportional to ``det(L_Y)``.

The sampler is factored into a **spectral cache** and a **cheap per-round
draw**:

* :func:`kdpp_sampler_state` — one ``torch.linalg.eigh`` plus the
  elementary-symmetric-polynomial table, packed into a
  :class:`KDPPSamplerState`.  O(C³), once per kernel refresh.
* :func:`sample_kdpp_from_eigh` — a draw from the cached spectrum: phase 1
  walks the ESP table (O(C)), phase 2 samples the k items with rank-1
  Householder orthogonal-complement conditioning (O(k²·C)).
* :func:`sample_kdpp` — decompose + draw in one call.
* :func:`greedy_map_kdpp` — deterministic greedy MAP inference (Chen et al.,
  NeurIPS'18).

Randomness: each phase's core takes its noise explicitly — per-step
uniforms for phase 1, Gumbel noise for phase 2 (a categorical draw is
``argmax(logits + gumbel)``) — and :func:`_sample_from_state` draws that
noise from a ``torch.Generator`` on the tensors' device.  Fed the same
noise, the cores pick the same indices as the JAX sampler.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "KDPPSamplerState",
    "elementary_symmetric",
    "identity_sampler_state",
    "kdpp_log_prob",
    "kdpp_sampler_state",
    "log_det_subset",
    "greedy_map_kdpp",
    "masked_kernel",
    "gumbel_noise",
    "sample_kdpp",
    "sample_kdpp_from_eigh",
    "sampler_dtype",
]


def sampler_dtype() -> torch.dtype:
    """The float dtype the sampler runs in (float32, as the JAX sampler
    without x64)."""
    return torch.float32


def elementary_symmetric(lam: torch.Tensor, k: int) -> torch.Tensor:
    """Elementary symmetric polynomials ``E[l, n] = e_l(lam_1..lam_n)``.

    Returns a tensor of shape ``(k + 1, N + 1)`` with the standard DP
    recurrence ``E[l, n] = E[l, n-1] + lam_n * E[l-1, n-1]``.
    """
    row = torch.zeros((k + 1,), dtype=lam.dtype, device=lam.device)
    row[0] = 1.0
    cols = [row]
    zero = torch.zeros((1,), dtype=lam.dtype, device=lam.device)
    for lam_n in lam:
        shifted = torch.cat([zero, row[:-1]])
        row = row + lam_n * shifted
        cols.append(row)
    return torch.stack(cols, dim=1)


# ------------------------------------------------------------ spectral cache


@dataclasses.dataclass(frozen=True)
class KDPPSamplerState:
    """Everything :func:`sample_kdpp_from_eigh` needs — one eigh, many draws.

    ``lam`` holds the clipped eigenvalues *after* the scale normalisation
    phase 1 uses for stability (divide by mean |λ|), so ``esp`` and ``lam``
    share one scale and a draw touches neither the kernel nor ``eigh``.
    """

    lam: torch.Tensor  # (C,) normalised non-negative eigenvalues
    vecs: torch.Tensor  # (C, C) orthonormal eigenvectors (columns)
    esp: torch.Tensor  # (k+1, C+1) elementary-symmetric table of ``lam``

    @property
    def num_items(self) -> int:
        return self.lam.shape[0]

    @property
    def k(self) -> int:
        return self.esp.shape[0] - 1


def kdpp_sampler_state(kernel: torch.Tensor, k: int) -> KDPPSamplerState:
    """Spectral cache for the k-DPP on PSD ``kernel``: the one O(C³) step."""
    lam, vecs = torch.linalg.eigh(kernel.to(sampler_dtype()))
    lam = torch.clamp_min(lam, 0.0)  # clip tiny negative eigenvalues
    lam = lam / torch.clamp_min(torch.mean(torch.abs(lam)), 1e-30)
    return KDPPSamplerState(lam=lam, vecs=vecs, esp=elementary_symmetric(lam, k))


def identity_sampler_state(
    num_items: int, k: int, device: torch.device
) -> KDPPSamplerState:
    """The spectral cache of the identity kernel, built in O(k·C) (no eigh):
    the neutral state for strategies that never draw from a DPP."""
    lam = torch.ones((num_items,), dtype=sampler_dtype(), device=device)
    return KDPPSamplerState(
        lam=lam,
        vecs=torch.eye(num_items, dtype=sampler_dtype(), device=device),
        esp=elementary_symmetric(lam, k),
    )


# ------------------------------------------------------------------ phases


def _phase1_select_eigenvectors(
    uniforms: torch.Tensor, lam: torch.Tensor, esp: torch.Tensor, k: int
) -> torch.Tensor:
    """Phase 1: choose exactly ``k`` eigenvectors; returns a bool mask (N,).

    Iterates n = N..1; eigenvector n is kept when ``uniforms[N - n]`` is
    below ``lam_n * E[r-1, n-1] / E[r, n]``, where ``r`` is the number of
    vectors still to pick.
    """
    n = lam.shape[0]
    rem = torch.tensor(k, dtype=torch.long, device=lam.device)
    takes = []
    for idx in range(n):
        nn = n - idx
        denom = esp[rem, nn]
        num = lam[nn - 1] * esp[torch.clamp_min(rem - 1, 0), nn - 1]
        p = torch.where(denom > 0, num / denom, 0.0)
        # Force-take when we must (rem == nn) and never take when rem == 0.
        p = torch.where(rem == nn, 1.0, p)
        p = torch.where(rem == 0, 0.0, torch.clamp(p, 0.0, 1.0))
        take = uniforms[idx] < p
        rem = rem - take.long()
        takes.append(take)
    # takes[idx] corresponds to eigenvector index n-1-idx; reverse to (N,).
    return torch.stack(takes[::-1])


def _phase2_sample_items(
    gumbels: torch.Tensor, v_sel: torch.Tensor, k: int
) -> torch.Tensor:
    """Phase 2: sample ``k`` items from the elementary DPP given by ``v_sel``.

    ``v_sel`` is (N, k) whose columns are the selected eigenvectors;
    ``gumbels`` is (k, N), one row of Gumbel noise per step.  After picking
    item ``i`` ∝ Σ_c V[i, c]², the subspace is conditioned on the complement
    of e_i with one **rank-1 Householder reflection** in coefficient space:
    ``V ← V·H`` followed by zeroing the pivot column leaves an orthonormal
    basis of span(V) ∩ e_i^⊥.  Returns int32 indices (k,).
    """
    v = v_sel
    items = []
    for step in range(k):
        weights = torch.sum(v * v, dim=1)  # (N,)
        logits = torch.log(torch.clamp_min(weights, 1e-30))
        i = torch.argmax(gumbels[step] + logits)
        row = v[i, :]  # (k,) coefficients of e_i in the current basis
        c_star = torch.argmax(torch.abs(row))  # pivot column (stability)
        # Householder u = row + sign(row_c)·‖row‖·e_c ; H = I − 2uuᵀ/‖u‖².
        u = row.clone()
        u[c_star] = row[c_star] + torch.copysign(torch.linalg.norm(row), row[c_star])
        beta = 2.0 / torch.clamp_min(torch.dot(u, u), 1e-30)
        v = v - torch.outer(v @ u, u) * beta
        v[:, c_star] = 0.0
        items.append(i)
    return torch.stack(items).to(torch.int32)


def gumbel_noise(shape, generator: torch.Generator, dtype, device) -> torch.Tensor:
    """Standard Gumbel noise of ``shape`` from ``generator``: -log(-log u)
    with u uniform in [tiny, 1)."""
    tiny = torch.finfo(dtype).tiny
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return -torch.log(-torch.log(torch.clamp_min(u, tiny)))


def _sample_from_noise(
    uniforms: torch.Tensor, gumbels: torch.Tensor, state: KDPPSamplerState, k: int
) -> torch.Tensor:
    """The draw given its noise: ``uniforms`` (N,) for phase 1 and
    ``gumbels`` (k, N) for phase 2."""
    mask = _phase1_select_eigenvectors(uniforms, state.lam, state.esp, k)
    # Pack the selected eigenvectors into the first k columns: order
    # columns by (selected first, index) and take the top k.
    order = torch.argsort((~mask).int(), stable=True)[:k]
    vecs = state.vecs
    v_sel = vecs[:, order] * mask[order][None, :].to(vecs.dtype)
    return _phase2_sample_items(gumbels, v_sel, k)


def _sample_from_state(
    generator: torch.Generator, state: KDPPSamplerState, k: int
) -> torch.Tensor:
    lam = state.lam
    n = state.num_items
    uniforms = torch.rand((n,), generator=generator, dtype=lam.dtype, device=lam.device)
    gumbels = gumbel_noise((k, n), generator, lam.dtype, lam.device)
    return _sample_from_noise(uniforms, gumbels, state, k)


def sample_kdpp_from_eigh(
    generator: torch.Generator, state: KDPPSamplerState, k: int
) -> torch.Tensor:
    """Draw ``k`` distinct indices from the cached spectrum — no ``eigh``.
    ``k`` must match the table the state was built with (``state.k``)."""
    if state.k != k:
        raise ValueError(f"sampler state was built for k={state.k}, got k={k}")
    return _sample_from_state(generator, state, k)


def sample_kdpp(generator: torch.Generator, kernel: torch.Tensor, k: int) -> torch.Tensor:
    """Sample ``k`` distinct indices from the k-DPP defined by PSD
    ``kernel``: decompose + draw, O(C³) per call.  Returns int32 (k,)."""
    return _sample_from_state(generator, kdpp_sampler_state(kernel, k), k)


def greedy_map_kdpp(kernel: torch.Tensor, k: int) -> torch.Tensor:
    """Deterministic greedy MAP for the k-DPP: argmax det(L_Y), |Y| = k.

    Fast greedy MAP (Chen et al. 2018): maintains for every item ``i`` the
    squared Cholesky diagonal ``d2[i]`` = marginal log-det gain; each of the
    ``k`` steps picks argmax d2 and downdates in O(C).
    """
    c = kernel.shape[0]
    d2 = torch.diagonal(kernel).clone()
    cis = torch.zeros((c, k), dtype=kernel.dtype, device=kernel.device)
    chosen = torch.zeros((c,), dtype=torch.bool, device=kernel.device)
    items = []
    for step in range(k):
        gains = torch.where(chosen, -torch.inf, d2)
        j = torch.argmax(gains)
        dj = torch.sqrt(torch.clamp_min(d2[j], 1e-30))
        # e_i = (L[j, i] - <c_j, c_i>) / dj for all i
        e = (kernel[j, :] - cis @ cis[j, :]) / dj
        cis[:, step] = e
        d2 = d2 - e * e
        chosen[j] = True
        items.append(j)
    return torch.stack(items).to(torch.int32)


def masked_kernel(kernel: torch.Tensor, avail: torch.Tensor) -> torch.Tensor:
    """Fold an availability mask into a PSD kernel: ``L' = m mᵀ ⊙ L`` with
    ``m = avail`` zeroes the rows and columns of unavailable items.  L'
    stays PSD (a congruence by ``diag(m)``), its eigenvectors vanish on the
    unavailable coordinates, so a k-DPP draw from L' returns available
    items only.  It needs the available block to have rank >= k; callers
    fall back to the unmasked kernel when fewer than k items are available."""
    m = avail.to(kernel.dtype)
    return kernel * (m[:, None] * m[None, :])


def log_det_subset(kernel: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """log det(L_Y) for the subset ``idx`` (sign-safe via slogdet)."""
    idx = torch.as_tensor(idx, device=kernel.device).long()
    sub = kernel[idx][:, idx]
    sign, logdet = torch.linalg.slogdet(sub)
    return torch.where(sign > 0, logdet, -torch.inf)


def kdpp_log_prob(kernel: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Unnormalised k-DPP log probability of subset ``idx`` (eq. 13 numerator)."""
    return log_det_subset(kernel, idx)
