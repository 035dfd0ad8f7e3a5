"""System-heterogeneity scenarios: per-client latency and availability.

The federation's second axis of heterogeneity beside non-IID data:
stragglers and intermittent participation.  A :class:`Scenario` names

* ``latency`` — one round's per-client wall-clock draw ``(n,) float32``.
  Families: uniform (a homogeneous fleet), lognormal (moderate
  dispersion), heavy-tail Pareto (the straggler regime: now and then a
  client 10–100× slower than the median);
* ``availability`` — an optional time-varying participation mask ``(n,)
  bool`` (a diurnal sine-modulated Bernoulli with a per-client phase).
  With one, the engine draws each cohort from the available clients only;
* ``deadline`` — the round cutoff of the bounded-staleness engine (not
  ported: it has no reader in this package yet).

Each random quantity is a :class:`Draw`: ``noise(generator, n)`` takes the
random numbers from an explicit ``torch.Generator`` and ``transform(noise,
...)`` makes the quantity of them, a pure function.  So the tests feed the
JAX package's noise through the transforms, as they do for the k-DPP draw.
The engine draws a scenario's quantities from a generator of their own
(``fl.engine``), so a latency-only scenario leaves cohorts and batches
exactly as a run without a scenario draws them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

__all__ = ["Draw", "Scenario", "SCENARIOS", "SCENARIO_NAMES", "get_scenario"]


@dataclasses.dataclass(frozen=True)
class Draw:
    """A random quantity as its noise and a pure transform of it:
    ``draw(generator, n, *args) == transform(noise(generator, n), *args)``."""

    noise: Callable[[torch.Generator, int], torch.Tensor]
    transform: Callable[..., torch.Tensor]

    def __call__(self, generator: torch.Generator, n: int, *args) -> torch.Tensor:
        return self.transform(self.noise(generator, n), *args)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named system-heterogeneity model (latency and an optional
    availability).  Times are in arbitrary round-cost units: only ratios
    matter."""

    name: str
    deadline: float
    latency: Draw  # (generator, n) -> (n,) float32
    availability: Optional[Draw] = None  # (generator, n, t) -> (n,) bool


def _uniform_noise(generator: torch.Generator, n: int) -> torch.Tensor:
    """``n`` fp32 uniforms in [0, 1) on the generator's device."""
    return torch.rand((n,), generator=generator, dtype=torch.float32, device=generator.device)


def _normal_noise(generator: torch.Generator, n: int) -> torch.Tensor:
    """``n`` fp32 standard normals on the generator's device."""
    return torch.randn((n,), generator=generator, dtype=torch.float32, device=generator.device)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _uniform_latency(lo: float, hi: float) -> Draw:
    """Uniform in [lo, hi): ``max(lo, u (hi - lo) + lo)`` of u in [0, 1),
    in fp32 as ``jax.random.uniform(key, shape, float32, lo, hi)``."""

    def transform(u):
        lo32, hi32 = _f32(lo, u), _f32(hi, u)
        return torch.maximum(lo32, u * (hi32 - lo32) + lo32)

    return Draw(_uniform_noise, transform)


def _lognormal_latency(sigma: float) -> Draw:
    """``exp(σ z)`` of standard normals z."""
    return Draw(_normal_noise, lambda z: torch.exp(sigma * z))


def _pareto_latency(alpha: float, scale: float) -> Draw:
    """Inverse-CDF Pareto, ``scale · (1 − u)^(−1/α)``; α near 1 is a very
    heavy tail (infinite variance), the regime where a synchronous barrier
    pays the max of the cohort's draws."""

    def transform(u):
        return scale * (1.0 - u) ** _f32(-1.0 / alpha, u)

    return Draw(_uniform_noise, transform)


def _diurnal_availability(period: float = 24.0, base: float = 0.55, swing: float = 0.4) -> Draw:
    """Client c is available at round t with probability ``base + swing ·
    sin(2π (t / period + c / n))``: the phase spread over the day."""

    def transform(u, t):
        n = u.shape[0]
        phase = torch.arange(n, dtype=torch.float32, device=u.device) / _f32(n, u)
        tt = _f32(float(t), u)
        p = base + swing * torch.sin(_f32(2.0 * math.pi, u) * (tt / _f32(period, u) + phase))
        return u < p

    return Draw(_uniform_noise, transform)


SCENARIOS = {
    # homogeneous fleet: the barrier sits near the deadline
    "uniform": Scenario(name="uniform", deadline=1.15, latency=_uniform_latency(0.8, 1.2)),
    # moderate dispersion: median 1, P95 about 2.7
    "lognormal": Scenario(name="lognormal", deadline=1.6, latency=_lognormal_latency(0.6)),
    # straggler regime: Pareto(α=1.1), median about 0.94, unbounded mean
    "heavy_tail": Scenario(name="heavy_tail", deadline=2.0, latency=_pareto_latency(1.1, 0.5)),
    # heavy-tail latency and diurnal availability
    "flaky": Scenario(
        name="flaky", deadline=2.0, latency=_pareto_latency(1.1, 0.5),
        availability=_diurnal_availability(),
    ),
}

SCENARIO_NAMES = tuple(sorted(SCENARIOS))


def get_scenario(name: str) -> Scenario:
    """Resolve a registry name; raises ``ValueError`` listing known names."""
    try:
        return SCENARIOS[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r}; known: {list(SCENARIO_NAMES)}") from None
