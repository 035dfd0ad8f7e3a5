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

``draw_fn(generator, SelectionState, k, avail=None) -> (k,) int32`` is the
one draw each strategy overrides; randomness comes from the explicit
``torch.Generator`` (on the device of the state's tensors).  ``avail``, a
(C,) bool mask from a scenario's availability model, restricts the draw to
available clients; every strategy shares one fallback
(:func:`availability_logits`): with fewer than ``k`` available clients the
unmasked draw is made.  Both sides of that test are computed and one is
kept with ``torch.where``, so a draw never waits on the device.  Every
strategy but the k-DPP splits its draw in two: ``noise(generator, state,
k, avail)`` draws the random numbers and ``draw_from_noise(noise, state,
k, avail)`` makes the cohort from them, so that the tests can feed the JAX
package's noise and compare cohorts exactly.

The engine calls :meth:`SelectionStrategy.select_global_fn`, which draws
over the funnel's candidates when the state holds a :class:`CandidateSet`
and maps the picks back to global client ids.  ``select(generator,
RoundState, k)`` builds the :class:`SelectionState` from the server's
knowledge (running ``fit`` where a strategy has one) and draws.
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
    "CandidateSet",
    "SelectionState",
    "availability_logits",
    "candidate_availability",
    "funnel_scores",
    "funnel_candidates",
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
class CandidateSet:
    """Stage 1 of the two-stage selection funnel: the global ids of the Q
    clients that survived the cheap prefilter, **sorted ascending**, so the
    funnel at Q = C is the identity (``arange(C)``).  A
    :class:`SelectionState` holding one is candidate-space: kernel (Q, Q),
    losses, sizes and labels (Q,), spectral cache over the Q × Q block."""

    ids: torch.Tensor  # (Q,) int32 global client ids, ascending

    @property
    def size(self) -> int:
        return self.ids.shape[0]


def funnel_scores(
    losses: torch.Tensor,
    avail: Optional[torch.Tensor] = None,
    latency: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The stage-1 prefilter score, O(C):
    ``max(loss, 1e-8) / (1 + max(latency, 0)) · avail``.  A high running
    loss promotes a client, a predicted latency demotes a straggler, and an
    unavailable client scores exactly 0.  Only the Q survivors are ever
    asked for a profile."""
    score = torch.clamp_min(losses.float(), 1e-8)
    if latency is not None:
        score = score / (1.0 + torch.clamp_min(latency.float(), 0.0))
    if avail is not None:
        score = score * avail.float()
    return score


def funnel_candidates(scores: torch.Tensor, q: int) -> torch.Tensor:
    """The top ``q`` scores' client ids, ascending, int32.  Ties break by
    the lower id, as JAX's ``lax.top_k`` breaks them (unavailable clients
    all score 0): a stable sort, not ``torch.topk``."""
    top = torch.sort(-scores, stable=True).indices[:q]
    return torch.sort(top).values.to(torch.int32)


@dataclasses.dataclass(frozen=True)
class SelectionState:
    """Tensor view of :class:`RoundState` for a draw; all fields concrete.

    ``eig_state`` is the k-DPP spectral cache (one eigh + ESP table);
    strategies that never draw from a DPP carry the identity-kernel cache.
    With ``candidates`` set every other field is candidate-space (Q-sized)
    and ``candidates.ids`` maps a local pick to its global id.
    """

    kernel: torch.Tensor  # (C, C) PSD profile kernel
    losses: torch.Tensor  # (C,) last-known local losses
    client_sizes: torch.Tensor  # (C,) n_c
    cluster_labels: torch.Tensor  # (C,) int32 — host-fitted, 0 when unused
    eig_state: dpp_mod.KDPPSamplerState  # spectral cache of ``kernel``
    candidates: Optional[CandidateSet] = None

    @property
    def num_clients(self) -> int:
        """The population a draw is over: Q under the funnel."""
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
    candidates: Optional[CandidateSet] = None,
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
        candidates=candidates,
    )


def availability_logits(avail: torch.Tensor, k: int, logits: torch.Tensor) -> torch.Tensor:
    """Sampling logits masked to the available clients, or the unmasked
    logits when fewer than ``k`` are available (a round must still field a
    k-cohort)."""
    masked = torch.where(avail, logits, -torch.inf)
    return torch.where(torch.sum(avail) >= k, masked, logits)


def candidate_availability(avail: torch.Tensor, candidates: CandidateSet) -> torch.Tensor:
    """A global (C,) availability mask gathered into candidate space (Q,):
    under the funnel the strategies see only this view, so the
    fewer-than-k fallback of :func:`availability_logits` falls back to the
    candidates, never to a non-candidate."""
    return avail[candidates.ids.long()]


def _top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries, largest first, ties by the
    lower index (``lax.top_k``'s order; ``torch.topk`` promises none)."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


class SelectionStrategy:
    name = "base"
    # True when draw_fn draws from SelectionState.eig_state: code that makes
    # the state then pays the O(C³) eigh; everyone else gets the identity cache.
    uses_spectral_cache = False
    # True when draw_fn reads SelectionState.losses or client_sizes: on a
    # client mesh a round then assembles them from the ranks (one more
    # all-reduce); a strategy that reads neither draws without it
    reads_client_stats = True

    def draw_fn(
        self, generator: torch.Generator, state: SelectionState, k: int,
        avail: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """``(generator, SelectionState, k, avail=None) -> (k,) int32``
        client ids, drawn among the available ones when ``avail`` is given."""
        raise NotImplementedError(f"{type(self).__name__} must override draw_fn")

    def select_global_fn(
        self, generator: torch.Generator, state: SelectionState, k: int,
        avail: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """The draw in **global** client ids, the engine's one entry point.

        Without a funnel (``state.candidates is None``) this is
        :meth:`draw_fn`.  With one, ``state`` is candidate-space: the draw
        runs over the Q candidates (``avail``, a global (C,) mask, gathered
        through :func:`candidate_availability`) and its local picks are
        mapped back through ``candidates.ids``.  ``avail`` is passed on only
        when given, so a ``draw_fn`` that takes no mask still runs every
        round without one."""
        cand = state.candidates
        if cand is not None and avail is not None:
            avail = candidate_availability(avail, cand)
        sel = self.draw_fn(generator, state, k) if avail is None else self.draw_fn(generator, state, k, avail)
        if cand is None:
            return sel
        return cand.ids[sel.long()]

    def prepare(self, state: RoundState, k: int) -> SelectionState:
        """RoundState -> SelectionState."""
        return selection_state(
            state.num_clients, k, kernel=state.kernel, losses=state.losses,
            client_sizes=state.client_sizes,
        )

    def select(self, generator: torch.Generator, state: RoundState, k: int) -> torch.Tensor:
        return self.draw_fn(generator, self.prepare(state, k), k)


class _NoiseDrawSelection(SelectionStrategy):
    """A strategy whose draw is ``draw_from_noise(noise(generator, state, k,
    avail), state, k, avail)``: the random numbers apart from what is made
    of them."""

    def noise(self, generator, state, k, avail=None) -> torch.Tensor:
        raise NotImplementedError

    def draw_from_noise(self, noise, state, k, avail=None) -> torch.Tensor:
        raise NotImplementedError

    def draw_fn(self, generator, state, k, avail=None):
        return self.draw_from_noise(self.noise(generator, state, k, avail), state, k, avail)


def _client_gumbels(generator, state) -> torch.Tensor:
    """Gumbel noise (C,), one per client, in the losses' dtype."""
    losses = state.losses
    return dpp_mod.gumbel_noise(losses.shape, generator, losses.dtype, losses.device)


class UniformSelection(_NoiseDrawSelection):
    """FedAvg: k clients uniformly at random without replacement; with a
    mask, Gumbel top-k over the available clients' equal logits."""

    name = "fedavg"
    reads_client_stats = False  # the losses' shape and device only

    def noise(self, generator, state, k, avail=None):
        """A permutation of the clients, or with a mask Gumbel noise (C,)."""
        if avail is not None:
            return _client_gumbels(generator, state)
        return torch.randperm(state.num_clients, generator=generator, device=state.losses.device)

    def draw_from_noise(self, noise, state, k, avail=None):
        if avail is None:
            return noise[:k].to(torch.int32)
        logits = availability_logits(avail, k, torch.zeros_like(noise))
        return _top_k(logits + noise, k).to(torch.int32)


class DPPSelection(SelectionStrategy):
    """FL-DP³S: sample the cohort from the k-DPP built on the profile kernel.

    ``mode='sample'`` is the paper's stochastic k-DPP; ``mode='map'`` is the
    deterministic greedy-MAP variant.  ``use_cache=True`` draws from
    ``SelectionState.eig_state`` (the spectral cache refreshed only with the
    kernel); ``use_cache=False`` decomposes on every draw.
    """

    name = "fl-dp3s"
    reads_client_stats = False  # the kernel and its cache only

    def __init__(self, mode: str = "sample", use_cache: bool = True):
        if mode not in ("sample", "map"):
            raise ValueError(f"mode must be 'sample' or 'map', got {mode!r}")
        self.mode = mode
        self.use_cache = use_cache
        self.uses_spectral_cache = mode == "sample" and use_cache
        if mode == "map":
            self.name = "fl-dp3s-map"

    def draw_fn(self, generator, state, k, avail=None):
        if avail is not None:
            # the spectral cache decomposes the unmasked kernel: a round
            # with a mask pays the one-shot eigh of the masked one
            kern = self.avail_kernel(state.kernel, avail, k)
            if self.mode == "map":
                return dpp_mod.greedy_map_kdpp(kern, k)
            return dpp_mod.sample_kdpp(generator, kern, k)
        if self.mode == "map":
            return dpp_mod.greedy_map_kdpp(state.kernel, k)
        if self.use_cache:
            return dpp_mod.sample_kdpp_from_eigh(generator, state.eig_state, k)
        return dpp_mod.sample_kdpp(generator, state.kernel, k)

    @staticmethod
    def avail_kernel(kernel: torch.Tensor, avail: torch.Tensor, k: int) -> torch.Tensor:
        """The kernel a masked round draws from: ``masked_kernel`` with at
        least ``k`` available clients, else the unmasked kernel."""
        return torch.where(torch.sum(avail) >= k, dpp_mod.masked_kernel(kernel, avail), kernel)

    def prepare(self, state, k):
        if state.kernel is None:
            raise ValueError("DPPSelection needs the profile kernel")
        return selection_state(
            state.num_clients, k, kernel=state.kernel, losses=state.losses,
            client_sizes=state.client_sizes,
            decompose_kernel=self.uses_spectral_cache,
        )


class FedSAESelection(_NoiseDrawSelection):
    """Prefer clients with higher local loss (sample ∝ loss, w/o repl.)."""

    name = "fedsae"

    def noise(self, generator, state, k, avail=None):
        """Gumbel noise (C,), one per client."""
        return _client_gumbels(generator, state)

    def draw_from_noise(self, gumbel, state, k, avail=None):
        # Gumbel top-k: weighted sampling without replacement ∝ loss
        logits = torch.log(torch.clamp_min(state.losses, 1e-8))
        if avail is not None:
            logits = availability_logits(avail, k, logits)
        return _top_k(logits + gumbel, k).to(torch.int32)


class PowerOfChoiceSelection(_NoiseDrawSelection):
    """d uniform candidates -> keep the k with the highest loss."""

    name = "power-of-choice"

    def __init__(self, d: int = 30):
        self.d = d

    def noise(self, generator, state, k, avail=None):
        """``min(d, C)`` distinct client ids, uniformly without replacement;
        with a mask, Gumbel noise (C,) that ranks the clients instead."""
        if avail is not None:
            return _client_gumbels(generator, state)
        d = min(self.d, state.num_clients)
        perm = torch.randperm(state.num_clients, generator=generator, device=state.losses.device)
        return perm[:d]

    def draw_from_noise(self, noise, state, k, avail=None):
        losses = state.losses
        if avail is None:
            cand = noise
            cand_losses = losses[cand.long()]
        else:
            # d candidates uniformly among the available clients (Gumbel
            # over -inf-masked logits ranks every available client first),
            # then the usual loss top-k with the unavailable padding last;
            # fewer than k available drops the mask (availability_logits)
            d = min(self.d, state.num_clients)
            enough = torch.sum(avail) >= k
            logits = availability_logits(avail, k, torch.zeros_like(noise))
            cand = _top_k(logits + noise, d)
            cand_losses = torch.where(avail[cand] | ~enough, losses[cand], -torch.inf)
        # a stable sort, as jnp.argsort: equal losses keep the candidate order
        order = torch.argsort(-cand_losses, stable=True)
        return cand[order[:k]].to(torch.int32)

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

    def noise(self, generator, state, k, avail=None):
        """Gumbel noise (k, C), one row per cluster."""
        sizes = state.client_sizes
        return dpp_mod.gumbel_noise((k, sizes.shape[0]), generator, torch.float32, sizes.device)

    def draw_from_noise(self, gumbels, state, k, avail=None):
        # with a mask, row l draws among cluster l's available members; a
        # cluster with none falls back to every available client, and fewer
        # than k available drops the mask (availability_logits)
        labels = state.cluster_labels
        log_sizes = torch.log(torch.clamp_min(state.client_sizes.float(), 1e-30))
        member = labels[None, :] == torch.arange(k, dtype=labels.dtype, device=labels.device)[:, None]
        logits = self._cluster_logits(member, log_sizes)
        if avail is not None:
            masked = self._cluster_logits(member, torch.where(avail, log_sizes, -torch.inf))
            logits = torch.where(torch.sum(avail) >= k, masked, logits)
        return torch.argmax(gumbels + logits, dim=1).to(torch.int32)

    def labels_for(self, state, k: int, rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``fit`` on the round state's fingerprints: representative
        gradients when available (as Fraboni et al. cluster), else the
        profiles; only the clients ``rows`` (the funnel's candidates) when
        given."""
        feats = state.grad_profiles if state.grad_profiles is not None else state.profiles
        if feats is None:
            raise ValueError("ClusterSelection needs client fingerprints")
        return self.fit(feats if rows is None else feats[rows.long()], k)

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
