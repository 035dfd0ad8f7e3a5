"""Client-selection strategies (paper §3.3 + §4 baselines).

* :class:`DPPSelection` — FL-DP³S (the paper): k-DPP over the eq.-(14) kernel.
* :class:`UniformSelection` — FedAvg's uniform-without-replacement sampling.
* :class:`FedSAESelection` — prefers clients with higher local loss
  (Li et al., IJCNN'21, as characterised in the paper's §4).
* :class:`ClusterSelection` — clustered sampling (Fraboni et al., ICML'21,
  Alg. 2): agglomerative clustering of client fingerprints into C_p
  clusters, one client drawn per cluster ∝ n_c.
* :class:`PowerOfChoiceSelection` — beyond-paper extra baseline (Cho et
  al.): d uniform candidates, keep the C_p with the highest loss.

``draw_fn(generator, SelectionState, k) -> (k,) int32`` is the one draw each
strategy overrides; randomness comes from the explicit ``torch.Generator``
(on the device of the state's tensors).  The three baselines split it in
two: ``noise(generator, state, k)`` draws the random numbers and
``draw_from_noise(noise, state, k)`` makes the cohort from them, so that
the tests can feed the JAX package's noise and compare cohorts exactly.
``select(generator, RoundState, k)`` builds the :class:`SelectionState`
from the server's knowledge (running ``fit`` where a strategy has one) and
draws.  The JAX draw's ``avail=`` mask (availability masking) is not
ported yet: it waits for the engine's availability features.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core import dpp as dpp_mod
from repro_torch.device import resolve_device

__all__ = [
    "RoundState",
    "SelectionState",
    "selection_state",
    "SelectionStrategy",
    "UniformSelection",
    "DPPSelection",
    "FedSAESelection",
    "ClusterSelection",
    "PowerOfChoiceSelection",
    "make_strategy",
    "STRATEGY_NAMES",
]


@dataclasses.dataclass
class RoundState:
    """Server-side knowledge available to a selection strategy."""

    num_clients: int
    round: int = 0
    kernel: Optional[torch.Tensor] = None  # (C, C) PSD, from profiles (eq. 14)
    profiles: Optional[torch.Tensor] = None  # (C, Q)
    losses: Optional[torch.Tensor] = None  # (C,) last-known local losses
    client_sizes: Optional[torch.Tensor] = None  # (C,) n_c
    grad_profiles: Optional[torch.Tensor] = None  # (C, G) representative gradients


@dataclasses.dataclass(frozen=True)
class SelectionState:
    """Tensor view of :class:`RoundState` for a draw; all fields concrete.

    ``eig_state`` is the k-DPP spectral cache (one eigh + ESP table);
    strategies that never draw from a DPP carry the identity-kernel cache.
    """

    kernel: torch.Tensor  # (C, C) PSD profile kernel
    losses: torch.Tensor  # (C,) last-known local losses
    client_sizes: torch.Tensor  # (C,) n_c
    cluster_labels: torch.Tensor  # (C,) int32 — host-fitted, 0 when unused
    eig_state: dpp_mod.KDPPSamplerState  # spectral cache of ``kernel``

    @property
    def num_clients(self) -> int:
        return self.losses.shape[0]


def selection_state(
    num_clients: int,
    k: int,
    kernel: Optional[torch.Tensor] = None,
    losses: Optional[torch.Tensor] = None,
    client_sizes: Optional[torch.Tensor] = None,
    cluster_labels: Optional[torch.Tensor] = None,
    eig_state: Optional[dpp_mod.KDPPSamplerState] = None,
    decompose_kernel: bool = False,
) -> SelectionState:
    """Build a :class:`SelectionState`, filling neutral defaults for the
    signals a strategy does not use.  The eigendecomposition is only paid
    when ``decompose_kernel=True`` and no ``eig_state`` is passed in.  The
    defaults go on the device of the tensors given (``cuda`` if none)."""
    c = num_clients
    given = [t for t in (kernel, losses, client_sizes) if t is not None]
    device = given[0].device if given else resolve_device(None)
    if eig_state is None:
        if decompose_kernel and kernel is not None:
            eig_state = dpp_mod.kdpp_sampler_state(kernel, k)
        else:
            eig_state = dpp_mod.identity_sampler_state(c, k, device)
    ones = torch.ones((c,), dtype=torch.float32, device=device)
    return SelectionState(
        kernel=torch.eye(c, dtype=torch.float32, device=device) if kernel is None else kernel,
        losses=ones if losses is None else losses,
        client_sizes=ones if client_sizes is None else client_sizes,
        cluster_labels=(
            torch.zeros((c,), dtype=torch.int32, device=device)
            if cluster_labels is None else cluster_labels
        ),
        eig_state=eig_state,
    )


class SelectionStrategy:
    name = "base"
    # True when draw_fn draws from SelectionState.eig_state: code that makes
    # the state then pays the O(C³) eigh; everyone else gets the identity cache.
    uses_spectral_cache = False

    def draw_fn(
        self, generator: torch.Generator, state: SelectionState, k: int
    ) -> torch.Tensor:
        """``(generator, SelectionState, k) -> (k,) int32`` client ids."""
        raise NotImplementedError(f"{type(self).__name__} must override draw_fn")

    def prepare(self, state: RoundState, k: int) -> SelectionState:
        """RoundState -> SelectionState."""
        return selection_state(
            state.num_clients, k, kernel=state.kernel, losses=state.losses,
            client_sizes=state.client_sizes,
        )

    def select(self, generator: torch.Generator, state: RoundState, k: int) -> torch.Tensor:
        return self.draw_fn(generator, self.prepare(state, k), k)


class UniformSelection(SelectionStrategy):
    """FedAvg: k clients uniformly at random without replacement."""

    name = "fedavg"

    def draw_fn(self, generator, state, k):
        perm = torch.randperm(
            state.num_clients, generator=generator, device=state.losses.device
        )
        return perm[:k].to(torch.int32)


class DPPSelection(SelectionStrategy):
    """FL-DP³S: sample the cohort from the k-DPP built on the profile kernel.

    ``mode='sample'`` is the paper's stochastic k-DPP; ``mode='map'`` is the
    deterministic greedy-MAP variant.  ``use_cache=True`` draws from
    ``SelectionState.eig_state`` (the spectral cache refreshed only with the
    kernel); ``use_cache=False`` decomposes on every draw.
    """

    name = "fl-dp3s"

    def __init__(self, mode: str = "sample", use_cache: bool = True):
        if mode not in ("sample", "map"):
            raise ValueError(f"mode must be 'sample' or 'map', got {mode!r}")
        self.mode = mode
        self.use_cache = use_cache
        self.uses_spectral_cache = mode == "sample" and use_cache
        if mode == "map":
            self.name = "fl-dp3s-map"

    def draw_fn(self, generator, state, k):
        if self.mode == "map":
            return dpp_mod.greedy_map_kdpp(state.kernel, k)
        if self.use_cache:
            return dpp_mod.sample_kdpp_from_eigh(generator, state.eig_state, k)
        return dpp_mod.sample_kdpp(generator, state.kernel, k)

    def prepare(self, state, k):
        if state.kernel is None:
            raise ValueError("DPPSelection needs the profile kernel")
        return selection_state(
            state.num_clients, k, kernel=state.kernel, losses=state.losses,
            client_sizes=state.client_sizes,
            decompose_kernel=self.uses_spectral_cache,
        )


class _NoiseDrawSelection(SelectionStrategy):
    """A strategy whose draw is ``draw_from_noise(noise(generator, state,
    k), state, k)``: the random numbers apart from what is made of them."""

    def noise(self, generator, state, k) -> torch.Tensor:
        raise NotImplementedError

    def draw_from_noise(self, noise, state, k) -> torch.Tensor:
        raise NotImplementedError

    def draw_fn(self, generator, state, k):
        return self.draw_from_noise(self.noise(generator, state, k), state, k)


class FedSAESelection(_NoiseDrawSelection):
    """Prefer clients with higher local loss (sample ∝ loss, w/o repl.)."""

    name = "fedsae"

    def noise(self, generator, state, k):
        """Gumbel noise (C,), one per client."""
        losses = state.losses
        return dpp_mod.gumbel_noise(losses.shape, generator, losses.dtype, losses.device)

    def draw_from_noise(self, gumbel, state, k):
        # Gumbel top-k: weighted sampling without replacement ∝ loss
        logits = torch.log(torch.clamp_min(state.losses, 1e-8))
        return torch.topk(logits + gumbel, k).indices.to(torch.int32)


class PowerOfChoiceSelection(_NoiseDrawSelection):
    """d uniform candidates -> keep the k with the highest loss."""

    name = "power-of-choice"

    def __init__(self, d: int = 30):
        self.d = d

    def noise(self, generator, state, k):
        """``min(d, C)`` distinct client ids, uniformly without replacement."""
        d = min(self.d, state.num_clients)
        perm = torch.randperm(state.num_clients, generator=generator, device=state.losses.device)
        return perm[:d]

    def draw_from_noise(self, candidates, state, k):
        # a stable sort, as jnp.argsort: equal losses keep the candidate order
        order = torch.argsort(-state.losses[candidates.long()], stable=True)
        return candidates[order[:k]].to(torch.int32)

    def prepare(self, state, k):
        # unknown losses -> all-equal weights => pure power-of-d over uniforms
        prepared = super().prepare(state, k)
        if state.losses is None:
            prepared = dataclasses.replace(prepared, losses=torch.zeros_like(prepared.losses))
        return prepared


class ClusterSelection(_NoiseDrawSelection):
    """Clustered sampling (Fraboni et al., Alg. 2), in two phases:

    * :meth:`fit` — **one-shot, host**: agglomerative average-linkage
      clustering (cosine distance) of client fingerprints (representative
      gradients / profiles) into ``k`` clusters, cached on the *content* of
      the fingerprints, so refreshed profiles re-cluster.
    * :meth:`draw_fn` — **per round, on the device**: one client drawn per
      cluster with probability ∝ n_c, as the argmax of masked logits plus
      Gumbel noise (a categorical draw).
    """

    name = "cluster"

    def __init__(self):
        self._labels: Optional[np.ndarray] = None
        self._fingerprint = None

    @staticmethod
    def _cluster(feats: np.ndarray, k: int) -> np.ndarray:
        c = feats.shape[0]
        norm = np.linalg.norm(feats, axis=1, keepdims=True)
        f = feats / np.maximum(norm, 1e-12)
        sim = f @ f.T
        dist = 1.0 - sim
        # average-linkage agglomerative clustering, O(C^3) worst case — fine
        # for C in the hundreds/thousands (runs once).
        clusters = [[i] for i in range(c)]
        d = dist.copy()
        np.fill_diagonal(d, np.inf)
        active = list(range(c))
        while len(active) > k:
            sub = d[np.ix_(active, active)]
            i_loc, j_loc = np.unravel_index(np.argmin(sub), sub.shape)
            i, j = active[i_loc], active[j_loc]
            if i > j:
                i, j = j, i
            ni, nj = len(clusters[i]), len(clusters[j])
            # average-linkage update of row/col i
            d[i, :] = (ni * d[i, :] + nj * d[j, :]) / (ni + nj)
            d[:, i] = d[i, :]
            d[i, i] = np.inf
            clusters[i] = clusters[i] + clusters[j]
            active.remove(j)
        labels = np.zeros(c, np.int32)
        for lbl, a in enumerate(active):
            labels[np.asarray(clusters[a])] = lbl
        return labels

    def fit(self, feats, k: int) -> torch.Tensor:
        """Cluster fingerprints (C, G) into ``k`` labels (cached on content);
        int32 labels on ``feats``' device (the CPU for a numpy array)."""
        device = feats.device if isinstance(feats, torch.Tensor) else torch.device("cpu")
        if isinstance(feats, torch.Tensor):
            feats = feats.detach().cpu().numpy()
        feats = np.asarray(feats, np.float32)
        fp = (feats.shape, k, hashlib.sha1(feats.tobytes()).hexdigest())
        if self._fingerprint != fp:
            self._labels = self._cluster(feats, k)
            self._fingerprint = fp
        return torch.as_tensor(self._labels, dtype=torch.int32, device=device)

    @staticmethod
    def _cluster_logits(member: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
        """Row l of the (k, C) draw logits: ``base`` masked to cluster l's
        members, falling back to plain ``base`` for rows with no finite
        member entry (an empty cluster)."""
        logits = torch.where(member, base[None, :], -torch.inf)
        ok = torch.any(member & torch.isfinite(base)[None, :], dim=1, keepdim=True)
        return torch.where(ok, logits, base[None, :])

    def noise(self, generator, state, k):
        """Gumbel noise (k, C), one row per cluster."""
        sizes = state.client_sizes
        return dpp_mod.gumbel_noise((k, sizes.shape[0]), generator, torch.float32, sizes.device)

    def draw_from_noise(self, gumbels, state, k):
        labels = state.cluster_labels
        log_sizes = torch.log(torch.clamp_min(state.client_sizes.float(), 1e-30))
        member = labels[None, :] == torch.arange(k, dtype=labels.dtype, device=labels.device)[:, None]
        logits = self._cluster_logits(member, log_sizes)
        return torch.argmax(gumbels + logits, dim=1).to(torch.int32)

    def labels_for(self, state, k: int) -> torch.Tensor:
        """``fit`` on the round state's fingerprints: representative
        gradients when available (as Fraboni et al. cluster), else the
        profiles."""
        feats = state.grad_profiles if state.grad_profiles is not None else state.profiles
        if feats is None:
            raise ValueError("ClusterSelection needs client fingerprints")
        return self.fit(feats, k)

    def prepare(self, state, k):
        return selection_state(
            state.num_clients, k, kernel=state.kernel, losses=state.losses,
            client_sizes=state.client_sizes, cluster_labels=self.labels_for(state, k),
        )


_REGISTRY = {
    "fedavg": UniformSelection,
    "uniform": UniformSelection,
    "fl-dp3s": DPPSelection,
    "dpp": DPPSelection,
    "fl-dp3s-map": lambda **kw: DPPSelection(mode="map", **kw),
    "fedsae": FedSAESelection,
    "cluster": ClusterSelection,
    "power-of-choice": PowerOfChoiceSelection,
}

STRATEGY_NAMES = tuple(sorted(_REGISTRY))


def make_strategy(name: str, **kw) -> SelectionStrategy:
    """Build a strategy by registry name; ``**kw`` forwards to the
    constructor (e.g. ``make_strategy('power-of-choice', d=20)`` or
    ``make_strategy('fl-dp3s', mode='map')``)."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown selection strategy {name!r}; known: {list(STRATEGY_NAMES)}"
        ) from None
    return factory(**kw)
