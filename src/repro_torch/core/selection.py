"""Client-selection strategies (paper §3.3 + the FedAvg baseline).

* :class:`DPPSelection` — FL-DP³S (the paper): k-DPP over the eq.-(14) kernel.
* :class:`UniformSelection` — FedAvg's uniform-without-replacement sampling.

``draw_fn(generator, SelectionState, k) -> (k,) int32`` is the one draw each
strategy overrides; randomness comes from the explicit ``torch.Generator``
(on the device of the state's tensors).  ``select(generator, RoundState,
k)`` builds the :class:`SelectionState` from the server's knowledge and
draws.  The other strategies of the JAX package are not ported yet;
:func:`make_strategy` says so.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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


@dataclasses.dataclass(frozen=True)
class SelectionState:
    """Tensor view of :class:`RoundState` for a draw; all fields concrete.

    ``eig_state`` is the k-DPP spectral cache (one eigh + ESP table);
    strategies that never draw from a DPP carry the identity-kernel cache.
    """

    kernel: torch.Tensor  # (C, C) PSD profile kernel
    losses: torch.Tensor  # (C,) last-known local losses
    client_sizes: torch.Tensor  # (C,) n_c
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


_REGISTRY = {
    "fedavg": UniformSelection,
    "uniform": UniformSelection,
    "fl-dp3s": DPPSelection,
    "dpp": DPPSelection,
    "fl-dp3s-map": lambda **kw: DPPSelection(mode="map", **kw),
}
# strategies of the JAX package's registry that this package lacks so far
_NOT_PORTED = ("cluster", "fedsae", "power-of-choice")

STRATEGY_NAMES = tuple(sorted(_REGISTRY))


def make_strategy(name: str, **kw) -> SelectionStrategy:
    """Build a strategy by registry name; ``**kw`` forwards to the
    constructor (e.g. ``make_strategy('fl-dp3s', mode='map')``)."""
    if name in _NOT_PORTED:
        raise NotImplementedError(f"selection strategy {name!r} is not yet ported")
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown selection strategy {name!r}; known: {list(STRATEGY_NAMES)}"
        ) from None
    return factory(**kw)
