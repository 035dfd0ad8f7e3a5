"""Fault injection and the update guard: robust aggregation and the
quarantine signal.

Clients fail in deployment: they abort mid-round, deliver NaN or
norm-exploded garbage, flip the sign of their update, or lose their whole
shard for a round.  A :class:`FaultModel` names the per-round rates of each
(``FaultModel`` registry ``FAULT_MODELS``, picked by ``FLConfig.faults``).

Randomness follows the port's rule: the numbers apart from what is made of
them.  :func:`faults_from_uniforms` is a pure function of one round's five
lanes of uniforms (dropout, nan, garbage, sign flip per client; blackout
per shard), so the tests feed it the JAX package's own uniforms.
:func:`draw_round_faults` is its generator front end: it draws all five
lanes every round, in that order, from the engine's ``fault_generator`` (a
stream of its own, seeded from the config's seed and ``FAULT_SALT``),
whatever the rates are, so one category's rate never shifts another's
draws and a run without faults draws nothing from any stream.

The persistent "lemon" clients (a fixed fraction that corrupts every round
it is selected, the quarantine workload) come from :func:`lemon_mask`, a
static draw from a CPU generator seeded with ``_LEMON_SEED``: the same set
on every device.  JAX draws its set from ``jax.random.key(_LEMON_SEED)``,
which a torch generator cannot reproduce, so the two sets differ by design.

:func:`make_update_guard` builds the transform the round applies between
the local updates and the eq.-(6) weighted sum: inject the drawn
corruption, zero undelivered clients' weights, then screen the per-client
update norms ``|θ_c − base|`` against the aggregator's policy: ``mean``
admits everything (the vulnerable control), ``clipped_mean`` rescales
over-norm deltas to ``norm_mult × median`` and flags them,
``trimmed_mean`` rejects them (weight 0; ``safe_div`` renormalises).
Non-finite updates are always rejected under the robust aggregators, and
every rejected or clipped cohort member is returned in ``flagged``, the
engine's quarantine signal.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.core.metrics import safe_div
from repro_torch.tree import tree_leaves, tree_map

__all__ = [
    "FAULT_SALT",
    "AGGREGATORS",
    "FaultModel",
    "FAULT_MODELS",
    "FAULT_NAMES",
    "get_fault_model",
    "lemon_mask",
    "FaultDraws",
    "faults_from_uniforms",
    "draw_round_faults",
    "apply_faults",
    "update_norms",
    "masked_median",
    "make_update_guard",
]

# the salt JAX folds into the server key for the fault stream; here it
# seeds the fault generator of its own (``engine.salted_generator``)
FAULT_SALT = 0xFA017ED5

# FLConfig.aggregator values, shared by the engine's validation and the
# launcher's flags
AGGREGATORS = ("mean", "clipped_mean", "trimmed_mean")

_LEMON_SEED = 0x1E303535  # the static draw of the persistent-lemon set
_LEMON_MODES = ("nan", "garbage", "sign_flip")


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """One named fault-injection model; every rate is per client per round
    (``shard_blackout`` per shard per round).

    ``lemon_frac`` marks a fixed fraction of clients persistently faulty:
    they emit ``lemon_mode`` corruption on every round they are selected.
    """

    name: str
    dropout: float = 0.0  # mid-round abort: the update never arrives
    nan: float = 0.0  # NaN-corrupted update
    garbage: float = 0.0  # norm-scaled garbage: delta × garbage_scale
    sign_flip: float = 0.0  # Byzantine: delta → −delta (same norm)
    shard_blackout: float = 0.0  # a whole shard misses the round
    garbage_scale: float = 50.0
    lemon_frac: float = 0.0  # persistently faulty fraction
    lemon_mode: str = "garbage"

    def __post_init__(self):
        for f in ("dropout", "nan", "garbage", "sign_flip", "shard_blackout", "lemon_frac"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"FaultModel.{f}={v} must be in [0, 1]")
        if self.garbage_scale <= 0:
            raise ValueError(f"FaultModel.garbage_scale={self.garbage_scale} must be > 0")
        if self.lemon_mode not in _LEMON_MODES:
            raise ValueError(f"unknown lemon_mode {self.lemon_mode!r}; known: {list(_LEMON_MODES)}")


FAULT_MODELS = {
    # mid-round aborts only: plain FedAvg handles them through the
    # delivered mask (the control: dropout alone needs no robust aggregator)
    "dropout": FaultModel(name="dropout", dropout=0.15),
    # a 10% corrupted-update rate, half NaN, half norm-exploded garbage:
    # plain mean degrades, robust aggregation holds
    "corrupt": FaultModel(name="corrupt", nan=0.05, garbage=0.05),
    # sign-flipped updates at honest norm: invisible to norm screening
    "byzantine": FaultModel(name="byzantine", sign_flip=0.10),
    # whole-shard outages and light dropout: the survivors floor
    "blackout": FaultModel(name="blackout", shard_blackout=0.15, dropout=0.05),
    # persistently faulty clients: the quarantine workload
    "lemons": FaultModel(name="lemons", lemon_frac=0.10),
    # everything at once
    "chaos": FaultModel(
        name="chaos", dropout=0.10, nan=0.03, garbage=0.03, sign_flip=0.04,
        shard_blackout=0.05, lemon_frac=0.05,
    ),
}

FAULT_NAMES = tuple(sorted(FAULT_MODELS))


def get_fault_model(name: str) -> FaultModel:
    """Resolve a registry name; raises ``ValueError`` listing known names."""
    try:
        return FAULT_MODELS[name]
    except KeyError:
        raise ValueError(f"unknown fault model {name!r}; known: {list(FAULT_NAMES)}") from None


def lemon_mask(model: FaultModel, num_clients: int) -> torch.Tensor:
    """(C,) bool CPU mask of the persistently faulty clients: exactly
    ``max(1, round(C · lemon_frac))`` of them when ``lemon_frac > 0``.

    A static draw (the lemon set is a property of the federation, not of a
    round) from a CPU generator seeded with ``_LEMON_SEED``, so every
    device and every run sees the same set."""
    mask = torch.zeros((num_clients,), dtype=torch.bool)
    if model.lemon_frac <= 0.0:
        return mask
    n = max(1, int(round(num_clients * model.lemon_frac)))
    u = torch.rand((num_clients,), generator=torch.Generator().manual_seed(_LEMON_SEED))
    mask[torch.argsort(u, stable=True)[:n]] = True
    return mask


class FaultDraws(NamedTuple):
    """One round's fault masks over the C clients, precedence applied: the
    corruption masks are mutually exclusive and set only for delivered
    clients (an aborted client's update never arrives, so it poisons
    nothing)."""

    delivered: torch.Tensor  # (C,) bool: survived dropout and shard blackout
    nan: torch.Tensor  # (C,) bool
    garbage: torch.Tensor  # (C,) bool
    sign_flip: torch.Tensor  # (C,) bool


def faults_from_uniforms(
    u: Sequence[torch.Tensor],
    model: FaultModel,
    num_clients: int,
    num_shards: int = 1,
    lemons: Optional[torch.Tensor] = None,
) -> FaultDraws:
    """One round's masks from its uniforms ``u``: the (C,) lanes of
    dropout, nan, garbage and sign flip, then the (num_shards,) blackout
    lane.  A lane whose rate is 0 sets nothing; the lemons (a (C,) mask)
    join their ``lemon_mode``'s lane; the blackout of shard d covers the
    clients ``[d·C/D, (d+1)·C/D)``; precedence nan > garbage > sign_flip,
    and an undelivered client corrupts nothing."""
    rates = (model.dropout, model.nan, model.garbage, model.sign_flip, model.shard_blackout)
    dropped, nan_m, garb, flip, blackout = (
        x < p if p > 0.0 else torch.zeros(x.shape, dtype=torch.bool, device=x.device)
        for x, p in zip(u, rates)
    )
    if model.lemon_frac > 0.0 and lemons is not None:
        lemons = lemons.to(nan_m.device)
        if model.lemon_mode == "nan":
            nan_m = nan_m | lemons
        elif model.lemon_mode == "garbage":
            garb = garb | lemons
        else:
            flip = flip | lemons
    delivered = ~dropped & ~torch.repeat_interleave(blackout, num_clients // num_shards)
    nan_m = nan_m & delivered
    garb = garb & ~nan_m & delivered
    flip = flip & ~nan_m & ~garb & delivered
    return FaultDraws(delivered=delivered, nan=nan_m, garbage=garb, sign_flip=flip)


def draw_round_faults(
    generator: torch.Generator,
    model: FaultModel,
    num_clients: int,
    num_shards: int = 1,
    lemons: Optional[torch.Tensor] = None,
) -> FaultDraws:
    """One round's masks, its five lanes of fp32 uniforms drawn from
    ``generator`` (on its device) in a fixed order, all five every round."""
    dev = generator.device
    u = [torch.rand((num_clients,), generator=generator, device=dev) for _ in range(4)]
    u.append(torch.rand((num_shards,), generator=generator, device=dev))
    return faults_from_uniforms(u, model, num_clients, num_shards, lemons)


# ------------------------------------------------------------ update guard


def _bshape(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (ndim - 1))


def apply_faults(new_params, base_params, losses, nan_m, garb_m, flip_m, garbage_scale: float):
    """Corrupt the per-client updates (leading axis M) as drawn:
    ``sign_flip`` negates the delta, ``garbage`` scales it by
    ``garbage_scale``, ``nan`` replaces the whole update with NaN, and a
    NaN client's reported losses are NaN too (the NaN-aware round mean
    then leaves it out)."""

    def leaf(n, b):
        b32 = b.float()
        d = n.float() - b32
        d = torch.where(_bshape(flip_m, d.ndim), -d, d)
        d = torch.where(_bshape(garb_m, d.ndim), garbage_scale * d, d)
        out = torch.where(_bshape(nan_m, d.ndim), torch.nan, b32 + d)
        return out.to(n.dtype)

    corrupted = tree_map(leaf, new_params, base_params)
    losses = torch.where(_bshape(nan_m, losses.ndim), torch.nan, losses)
    return corrupted, losses


def update_norms(new_params, base_params) -> torch.Tensor:
    """(M,) global L2 norms of the per-client deltas ``θ_c − base``, summed
    in fp32; a non-finite entry anywhere makes the client's norm
    non-finite (the finite screen's one signal)."""
    sq = None
    for n, b in zip(tree_leaves(new_params), tree_leaves(base_params)):
        d = n.float() - b.float()
        s = torch.sum(d * d, dim=tuple(range(1, d.ndim))) if d.ndim > 1 else d * d
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Lower median of ``x`` where ``mask``; +inf when the mask is empty
    (a threshold then admits everything finite).  No host sync."""
    s = torch.sort(torch.where(mask, x, torch.inf)).values
    cnt = torch.sum(mask.to(torch.int64))
    idx = torch.clamp(torch.clamp_min(cnt - 1, 0) // 2, 0, x.shape[0] - 1)
    return s[idx]


def make_update_guard(
    aggregator: str,
    norm_mult: float,
    garbage_scale: float = 1.0,
    inject: bool = False,
):
    """The update-validation transform between the local updates and the
    eq.-(6) weighted sum.

    ``guard(new_params, base_params, weights, losses, *masks) ->
    (new_params, weights, losses, flagged)``, every tensor leading with the
    per-client axis M.  ``masks`` are the :class:`FaultDraws` gathered to
    the cohort when ``inject`` (a fault model is set), else empty: the
    robust aggregators screen honest runs too.

    The returned weights are the eq.-(6) weights with undelivered and
    rejected clients zeroed, so rejection is exactly "left out of the
    weighted sum".  Rejected clients' params are zeroed as well: a 0-weight
    NaN update would otherwise poison the sum through ``0 · NaN``.  Under
    ``mean`` nothing is screened, so a delivered NaN update flows through.
    ``flagged`` marks the cohort members the guard rejected or clipped."""
    if aggregator not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {aggregator!r}; known: {list(AGGREGATORS)}")

    def guard(new_params, base_params, weights, losses, *masks):
        if inject:
            delivered, nan_m, garb_m, flip_m = masks
            new_params, losses = apply_faults(
                new_params, base_params, losses, nan_m, garb_m, flip_m, garbage_scale
            )
            w = weights * delivered.to(weights.dtype)
        else:
            w = weights
        cohort = w > 0
        if aggregator == "mean":
            return new_params, w, losses, torch.zeros_like(cohort)
        norms = update_norms(new_params, base_params)
        finite = torch.isfinite(norms)
        tau = norm_mult * masked_median(norms, cohort & finite)
        over = finite & (norms > tau)
        if aggregator == "clipped_mean":
            # over-norm deltas rescaled to the threshold: kept, but flagged
            s = torch.where(over, safe_div(tau, norms), torch.ones_like(norms))
            new_params = tree_map(
                lambda n, b: (b.float() + _bshape(s, n.ndim) * (n.float() - b.float())).to(n.dtype),
                new_params, base_params,
            )
            valid = cohort & finite
        else:  # trimmed_mean: norm outliers rejected
            valid = cohort & finite & ~over
        flagged = cohort & (~valid | over)
        new_params = tree_map(
            lambda n: torch.where(_bshape(valid, n.ndim), n, torch.zeros((), dtype=n.dtype, device=n.device)),
            new_params,
        )
        return new_params, w * valid.to(w.dtype), losses, flagged

    return guard
