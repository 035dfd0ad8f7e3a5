"""The port's fault injection, update guard and quarantine against the JAX
package's, on the CPU.

Parity on the same numpy inputs: ``faults_from_uniforms`` on JAX's own
uniforms (``uniform(fold_in(key, lane))``) against JAX's
``draw_round_faults``, ``masked_median`` exactly, and the update guard of
every aggregator (weights, losses and ``flagged`` exactly, params within
1e-6), alone and inside the round step.  Then the single-device cases of
JAX's ``tests/test_faults_engine.py`` on the port's engine, the port's
crash-resume, and the whole slice: FL-DP³S under ``chaos`` with
``trimmed_mean`` and FedDyn through each package's ``FLTrainer.run``
across a reprofile boundary, the port given JAX's cohorts, fault draws and
lemon mask."""

import dataclasses
import functools
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import selection as jsel  # noqa: E402
from repro.data import make_image_dataset, skewness_partition  # noqa: E402
from repro.fl import engine as jengine  # noqa: E402
from repro.fl import faults as jfaults  # noqa: E402
from repro.fl import rounds as jrounds  # noqa: E402
from repro.fl import trainer as jtrainer  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro import obs as jobs  # noqa: E402

from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.fl import engine as tengine  # noqa: E402
from repro_torch.fl import faults as tfaults  # noqa: E402
from repro_torch.fl import rounds as trounds  # noqa: E402
from repro_torch.fl import trainer as ttrainer  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402

FEAT, N_C, NCLS = 8, 6, 4


@pytest.fixture(autouse=True)
def one_thread():
    """Small models on the CPU: one intra-op thread keeps the port's side
    from contending for the cores with the other test workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def linear_loss(params, x, y):
    logp = torch.log_softmax(x @ params["w"] + params["b"], dim=-1)
    return -torch.mean(torch.take_along_dim(logp, y[..., None].long(), dim=-1))


def j_linear_loss(params, x, y):
    logp = jax.nn.log_softmax(x @ params["w"] + params["b"])
    return -jnp.mean(jnp.take_along_axis(logp, y[..., None], axis=-1))


def _federation(c, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(c, N_C, FEAT)).astype(np.float32)
    ys = rng.integers(0, NCLS, size=(c, N_C)).astype(np.int32)
    params = {
        "w": (0.01 * rng.normal(size=(FEAT, NCLS))).astype(np.float32),
        "b": np.zeros((NCLS,), np.float32),
    }
    return xs, ys, params


def _state_and_cfg(c, k, strategy, rounds=8, **cfg_kw):
    xs, ys, params = _federation(c)
    cfg = tengine.FLConfig(num_clients=c, clients_per_round=k, local_epochs=2, lr=0.1, rounds=rounds,
                           eval_every=2, num_classes=NCLS, seed=0, **cfg_kw)
    params = {n: torch.from_numpy(v) for n, v in params.items()}
    losses = torch.stack([linear_loss(params, torch.from_numpy(x), torch.from_numpy(y)) for x, y in zip(xs, ys)])
    state = tengine.init_server_state(cfg, params, xs, ys, torch.from_numpy(xs.mean(axis=1)), losses, strategy,
                                      device="cpu")
    return cfg, state


def _run(cfg, state, rounds):
    fn = tengine.make_round_fn(cfg, linear_loss, (tsel.UniformSelection(),))
    return tengine.run_scanned(fn, state, rounds)


def _max_param_diff(a, b):
    return max(float(torch.max(torch.abs(a[n].float() - b[n].float()))) for n in a)


# ------------------------------------------------------------- registry


def test_registry_and_constants_are_jax_s():
    assert tfaults.FAULT_SALT == jfaults.FAULT_SALT and tfaults._LEMON_SEED == jfaults._LEMON_SEED
    assert tfaults.AGGREGATORS == jfaults.AGGREGATORS and tfaults.FAULT_NAMES == jfaults.FAULT_NAMES
    for name in tfaults.FAULT_NAMES:
        assert dataclasses.asdict(tfaults.get_fault_model(name)) == dataclasses.asdict(jfaults.get_fault_model(name))
        assert tfaults.get_fault_model(name).name == name
    with pytest.raises(ValueError) as e:
        tfaults.get_fault_model("nope")
    assert all(name in str(e.value) for name in tfaults.FAULT_NAMES)


@pytest.mark.parametrize("bad", [
    dict(dropout=1.5), dict(nan=-0.1), dict(garbage_scale=0.0), dict(lemon_frac=2.0), dict(lemon_mode="weird"),
])
def test_fault_model_validation(bad):
    with pytest.raises(ValueError):
        tfaults.FaultModel(name="x", **bad)


def test_lemon_mask_deterministic_count():
    m = tfaults.FaultModel(name="x", lemon_frac=0.25)
    mask = tfaults.lemon_mask(m, 16)
    assert mask.shape == (16,) and mask.dtype == torch.bool and mask.device.type == "cpu"
    assert int(mask.sum()) == 4 and torch.equal(mask, tfaults.lemon_mask(m, 16))
    # at least one lemon where the fraction rounds to none, none at 0
    assert int(tfaults.lemon_mask(tfaults.FaultModel(name="y", lemon_frac=0.01), 8).sum()) == 1
    assert not tfaults.lemon_mask(tfaults.FaultModel(name="z"), 8).any()


def _jax_uniforms(key, c, shards):
    """JAX's five lanes: ``uniform(fold_in(key, lane))``, lanes 1-4 over the
    clients and lane 5 over the shards."""
    return [np.array(jax.random.uniform(jax.random.fold_in(key, lane), (c if lane < 5 else shards,), jnp.float32))
            for lane in range(1, 6)]


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("name", sorted(jfaults.FAULT_MODELS) + ["dense"])
def test_faults_from_uniforms_matches_jax(name, shards):
    """The masks of JAX's ``draw_round_faults`` bit for bit, on its
    uniforms and its lemon mask, over five keys (``dense``: every rate high,
    so every precedence rule decides something)."""
    c = 32
    if name == "dense":
        kw = dict(dropout=0.3, nan=0.4, garbage=0.4, sign_flip=0.5, shard_blackout=0.3, lemon_frac=0.2,
                  lemon_mode="nan")
        jm, tm = jfaults.FaultModel(name=name, **kw), tfaults.FaultModel(name=name, **kw)
    else:
        jm, tm = jfaults.get_fault_model(name), tfaults.get_fault_model(name)
    jlem = jfaults.lemon_mask(jm, c)
    for seed in range(5):
        key = jax.random.fold_in(jax.random.key(seed), jfaults.FAULT_SALT)
        want = jfaults.draw_round_faults(key, jm, c, shards, jlem)
        u = [torch.from_numpy(x) for x in _jax_uniforms(key, c, shards)]
        got = tfaults.faults_from_uniforms(u, tm, c, shards, torch.from_numpy(np.array(jlem)))
        for field, a, b in zip(tfaults.FaultDraws._fields, got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{name} {field}")


def test_draw_round_faults_determinism_and_precedence():
    m = tfaults.get_fault_model("chaos")
    d1 = tfaults.draw_round_faults(torch.Generator().manual_seed(0), m, 32, num_shards=4)
    d2 = tfaults.draw_round_faults(torch.Generator().manual_seed(0), m, 32, num_shards=4)
    for a, b in zip(d1, d2):
        assert a.shape == (32,) and a.dtype == torch.bool and torch.equal(a, b)
    delivered, nan_m, garb_m, flip_m = (x.numpy() for x in d1)
    assert not np.any(nan_m & garb_m) and not np.any(nan_m & flip_m) and not np.any(garb_m & flip_m)
    for mask in (nan_m, garb_m, flip_m):
        assert not np.any(mask & ~delivered)
    other = tfaults.draw_round_faults(torch.Generator().manual_seed(1), m, 32, num_shards=4)
    assert any(not torch.equal(a, b) for a, b in zip(d1, other))


def test_every_lane_is_drawn_whatever_the_rates():
    """Five lanes every round from one generator: a category's rate moves
    no other category's draws, and the stream advances the same."""
    sparse = tfaults.FaultModel(name="s", dropout=0.3)
    dense = tfaults.FaultModel(name="d", dropout=0.3, nan=0.2, garbage=0.2, sign_flip=0.2)
    ga, gb = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    for _ in range(3):
        a = tfaults.draw_round_faults(ga, sparse, 16)
        b = tfaults.draw_round_faults(gb, dense, 16)
        assert torch.equal(a.delivered, b.delivered)
        assert torch.equal(ga.get_state(), gb.get_state())
    calm = tfaults.draw_round_faults(torch.Generator().manual_seed(0), tfaults.FaultModel(name="calm"), 16)
    assert bool(calm.delivered.all()) and not bool(calm.nan.any() | calm.garbage.any() | calm.sign_flip.any())


@pytest.mark.parametrize("pattern", ["random", "empty", "full", "one", "ties"])
def test_masked_median_matches_jax(pattern):
    rng = np.random.default_rng(7)
    for n in (1, 2, 7, 10):
        x = rng.normal(size=(n,)).astype(np.float32)
        if pattern == "ties":
            x = np.round(x).astype(np.float32)
        mask = {"random": rng.random(n) < 0.5, "empty": np.zeros(n, bool), "full": np.ones(n, bool),
                "one": np.arange(n) == n // 2, "ties": rng.random(n) < 0.7}[pattern]
        x[~mask & (rng.random(n) < 0.5)] = np.nan  # unmasked entries never count
        want = np.asarray(jfaults.masked_median(jnp.asarray(x), jnp.asarray(mask)))
        got = tfaults.masked_median(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
        np.testing.assert_array_equal(got, want)


# -------------------------------------------------------- the update guard


def _guard_inputs(inject):
    """Eight clients' updates around one base: an outlier (client 2), a
    non-finite update (client 5, without injection) and, with injection, a
    dropped client and one of each corruption."""
    rng = np.random.default_rng(11)
    m = 8
    base = {"w": rng.normal(size=(5, 3)).astype(np.float32), "b": rng.normal(size=(3,)).astype(np.float32)}
    new = {n: (b[None] + 0.1 * rng.normal(size=(m,) + b.shape)).astype(np.float32) for n, b in base.items()}
    new["w"][2] += 20.0
    if not inject:
        new["b"][5, 1] = np.nan
    weights = rng.integers(50, 150, size=(m,)).astype(np.float32)
    losses = rng.random(size=(m, 2)).astype(np.float32)
    masks = ()
    if inject:
        delivered = np.ones(m, bool)
        delivered[6] = False
        nan_m, garb_m, flip_m = (np.arange(m) == i for i in (0, 3, 4))
        masks = (delivered, nan_m, garb_m, flip_m)
    return new, base, weights, losses, masks


@pytest.mark.parametrize("inject", [False, True])
@pytest.mark.parametrize("aggregator", jfaults.AGGREGATORS)
def test_update_guard_matches_jax(aggregator, inject):
    new, base, weights, losses, masks = _guard_inputs(inject)
    jg = jfaults.make_update_guard(aggregator, 3.0, garbage_scale=50.0, inject=inject)
    tg = tfaults.make_update_guard(aggregator, 3.0, garbage_scale=50.0, inject=inject)
    j_out = jg(jax.tree_util.tree_map(jnp.asarray, new), jax.tree_util.tree_map(jnp.asarray, base),
               jnp.asarray(weights), jnp.asarray(losses), *(jnp.asarray(x) for x in masks))
    t_out = tg({n: torch.from_numpy(v) for n, v in new.items()}, {n: torch.from_numpy(v) for n, v in base.items()},
               torch.from_numpy(weights), torch.from_numpy(losses), *(torch.from_numpy(x) for x in masks))
    (jp, jw, jl, jf), (tp, tw, tl, tf) = j_out, t_out
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    for n in new:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), rtol=0, atol=1e-6, err_msg=n)
    if aggregator == "mean":
        assert not tf.any()
    else:
        # the outlier (and the NaN update or the garbage one) flagged; only
        # clipped_mean keeps the outlier, rescaled, in the sum
        assert bool(tf[2]) and (aggregator == "clipped_mean") == bool(tw[2] > 0)
        assert all(bool(torch.isfinite(v).all()) for v in tp.values())
    with pytest.raises(ValueError, match="unknown aggregator"):
        tfaults.make_update_guard("median", 3.0)


@pytest.mark.parametrize("aggregator", jfaults.AGGREGATORS)
def test_guarded_round_step_matches_jax(aggregator):
    """One round of six clients on the linear model through each package's
    ``build_client_parallel_round`` with its guard: the aggregate within
    1e-6, the NaN-aware mean loss within 1e-6, ``flagged`` and
    ``survivors`` exactly."""
    xs, ys, params = _federation(6)
    masks = (np.array([1, 1, 1, 0, 1, 1], bool), np.arange(6) == 1, np.arange(6) == 4, np.arange(6) == 5)
    batches = (xs.reshape(6, 2, 3, FEAT), ys.reshape(6, 2, 3))
    weights = np.full((6,), 6.0, np.float32)
    jg = jfaults.make_update_guard(aggregator, 3.0, garbage_scale=50.0, inject=True)
    jstep = jrounds.build_client_parallel_round(lambda p, b: j_linear_loss(p, b[0], b[1]), 0.1, 2,
                                                sequential_clients=True, update_transform=jg)
    jagg, jloss, jflag, jsurv = jstep(jax.tree_util.tree_map(jnp.asarray, params),
                                      tuple(jnp.asarray(b) for b in batches), jnp.asarray(weights),
                                      *(jnp.asarray(m) for m in masks))
    tg = tfaults.make_update_guard(aggregator, 3.0, garbage_scale=50.0, inject=True)
    tstep = trounds.build_client_parallel_round(lambda p, b: linear_loss(p, b[0], b[1]), 0.1, 2, update_transform=tg)
    tagg, tloss, tflag, tsurv = tstep({n: torch.from_numpy(v) for n, v in params.items()},
                                      tuple(torch.from_numpy(b) for b in batches), torch.from_numpy(weights),
                                      *(torch.from_numpy(m) for m in masks))
    np.testing.assert_array_equal(tflag.numpy(), np.asarray(jflag))
    assert int(tsurv) == int(jsurv)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=0, atol=1e-6)
    for n in params:
        np.testing.assert_allclose(tagg[n].numpy(), np.asarray(jagg[n]), rtol=0, atol=1e-6, err_msg=n)


def _listed_round(loss_fn, lr, guard, algo):
    """``build_client_parallel_round`` as it stood before each client's
    params went into a preallocated stack: a list of the clients' new
    params (and states), stacked once they were all trained."""
    from repro_torch.core.metrics import finite_mean
    from repro_torch.tree import tree_map

    local = trounds.build_local_algo_update(algo, loss_fn, lr)
    stateful = algo is not None and algo.stateful

    def step(gp, batches, weights, *g_args, client_states=None):
        ps, sts, ls = [], [], []
        for i in range(weights.shape[0]):
            batch = tuple(x[i] for x in batches)
            if stateful:
                p, st, loss = local(gp, tree_map(lambda s: s[i], client_states), batch)
                sts.append(st)
            else:
                p, loss = local(gp, batch)
            ps.append(p)
            ls.append(loss)
        stacked, losses = tree_map(lambda *xs: torch.stack(xs), *ps), torch.stack(ls)
        out = (tree_map(lambda *xs: torch.stack(xs), *sts),) if stateful else ()
        if guard is None:
            return (trounds.weighted_average(stacked, weights), torch.mean(losses)) + out
        stacked, w, losses, flagged = guard(stacked, gp, weights, losses, *g_args)
        entry = torch.mean(losses, dim=tuple(range(1, losses.ndim)))
        survivors = torch.sum((w > 0).to(torch.int32))
        return (trounds.weighted_average(stacked, w), finite_mean(entry, where=w > 0), flagged, survivors) + out

    return step


@pytest.mark.parametrize("case", ["unguarded"] + list(jfaults.AGGREGATORS) + ["feddyn+trimmed_mean"])
def test_round_step_equals_the_list_then_stack_round_bit_for_bit(case):
    """Writing each client's new params into a preallocated ``(C_p, ...)``
    stack changes no bit: the aggregate, the mean loss, the guard's
    ``flagged`` and ``survivors`` and FedDyn's new states equal those of
    the round that listed the clients' params and stacked them, under
    every aggregator with injected faults (a NaN and a garbage update among
    them)."""
    from repro_torch.fl.local_algos import FedDyn, init_client_states

    aggregator = case.split("+")[-1]
    algo = FedDyn(0.05) if case.startswith("feddyn") else None
    guard = None if case == "unguarded" else tfaults.make_update_guard(aggregator, 3.0, garbage_scale=50.0,
                                                                         inject=True)
    xs, ys, params = _federation(6)
    params = {n: torch.from_numpy(v) for n, v in params.items()}
    masks = () if guard is None else tuple(torch.from_numpy(m) for m in (
        np.array([1, 1, 1, 0, 1, 1], bool), np.arange(6) == 1, np.arange(6) == 4, np.arange(6) == 5))
    batches = (torch.from_numpy(xs.reshape(6, 2, 3, FEAT)), torch.from_numpy(ys.reshape(6, 2, 3)))
    weights = torch.arange(1.0, 7.0)
    kw = {}
    if algo is not None:
        states = init_client_states(algo, params, 6)
        kw["client_states"] = {n: s + 0.01 * torch.randn(s.shape, generator=torch.Generator().manual_seed(1))
                               for n, s in states.items()}
    loss_fn = lambda p, b: linear_loss(p, b[0], b[1])  # noqa: E731
    new = trounds.build_client_parallel_round(loss_fn, 0.1, 2, update_transform=guard, algo=algo)(
        params, batches, weights, *masks, **kw)
    old = _listed_round(loss_fn, 0.1, guard, algo)(params, batches, weights, *masks, **kw)
    assert len(new) == len(old)
    for a, b in zip(new, old):
        for x, y in zip(*(list(t.values()) if isinstance(t, dict) else [t] for t in (a, b))):
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


# ------------------------------------------------------- config contract


@pytest.mark.parametrize("bad", [
    dict(aggregator="median"),
    dict(faults="nope"),
    dict(faults="corrupt", robust_norm_mult=0.0),
    dict(faults="corrupt", min_survivors=0),
    dict(faults="corrupt", min_survivors=99),
    dict(faults="corrupt", quarantine_rounds=-1),
    dict(ckpt_every=0),
])
def test_flconfig_rejects_bad_fault_config(bad):
    kw = dict(num_clients=8, clients_per_round=4, local_epochs=1, lr=0.1, rounds=4, eval_every=2,
              num_classes=NCLS, seed=0, **bad)
    with pytest.raises(ValueError):
        jengine.FLConfig(**kw)
    with pytest.raises(ValueError):
        tengine.FLConfig(**kw)


def test_zero_fault_state_has_no_quarantine_field():
    cfg, state = _state_and_cfg(8, 4, tsel.UniformSelection())
    assert state.quarantine is None and state.fault_generator is None and state.algo_state is None
    _, outs = _run(cfg, state, 4)
    assert "survivors" not in outs and "flagged" not in outs


def test_guarded_state_carries_quarantine():
    cfg, state = _state_and_cfg(8, 4, tsel.UniformSelection(), faults="corrupt", aggregator="trimmed_mean")
    assert cfg.guarded() and state.quarantine.shape == (8,) and state.quarantine.dtype == torch.int32
    assert isinstance(state.fault_generator, torch.Generator)
    f = state.fork()
    assert f.fault_generator is not state.fault_generator
    assert torch.equal(f.fault_generator.get_state(), state.fault_generator.get_state())


# --------------------------------------------------- engine fault behaviour


def test_total_dropout_is_identity_rounds(monkeypatch):
    monkeypatch.setitem(tfaults.FAULT_MODELS, "all_drop", tfaults.FaultModel(name="all_drop", dropout=1.0))
    cfg, state = _state_and_cfg(8, 4, tsel.UniformSelection(), faults="all_drop")
    fin, outs = _run(cfg, state, 4)
    assert (outs["survivors"] == 0).all() and (outs["identity_round"] == 1).all()
    assert torch.isnan(outs["loss"]).all()  # no cohort, no round mean
    assert _max_param_diff(fin.params, state.params) == 0.0
    assert torch.equal(fin.losses, state.losses)  # nothing refreshed


def test_total_nan_trimmed_floors_to_identity(monkeypatch):
    monkeypatch.setitem(tfaults.FAULT_MODELS, "all_nan", tfaults.FaultModel(name="all_nan", nan=1.0))
    cfg, state = _state_and_cfg(8, 4, tsel.UniformSelection(), faults="all_nan", aggregator="trimmed_mean",
                                quarantine_rounds=0)
    fin, outs = _run(cfg, state, 4)
    assert (outs["survivors"] == 0).all() and (outs["identity_round"] == 1).all()
    assert (outs["flagged"] == 4).all()  # the whole cohort screened out
    assert _max_param_diff(fin.params, state.params) == 0.0


def test_total_nan_plain_mean_poisons_params(monkeypatch):
    # the unprotected control: under mean one NaN cohort destroys the params
    monkeypatch.setitem(tfaults.FAULT_MODELS, "all_nan", tfaults.FaultModel(name="all_nan", nan=1.0))
    cfg, state = _state_and_cfg(8, 4, tsel.UniformSelection(), faults="all_nan", aggregator="mean")
    fin, outs = _run(cfg, state, 2)
    assert not torch.isfinite(fin.params["w"]).all()
    assert torch.isnan(outs["loss"]).all()  # the NaN-aware mean: no finite entry


def test_corrupt_trimmed_stays_finite_and_quarantines():
    cfg, state = _state_and_cfg(12, 6, tsel.UniformSelection(), faults="corrupt", aggregator="trimmed_mean",
                                rounds=12)
    fin, outs = _run(cfg, state, 12)
    assert all(bool(torch.isfinite(v).all()) for v in fin.params.values())
    assert torch.isfinite(outs["loss"]).any() and (outs["survivors"] <= 6).all()
    assert outs["flagged"].sum() > 0 and outs["quarantined"].max() > 0


def test_quarantine_prevents_lemon_reselection():
    c, k, rounds = 12, 4, 16
    lemons = torch.nonzero(tfaults.lemon_mask(tfaults.get_fault_model("lemons"), c)).ravel().tolist()
    cfg, state = _state_and_cfg(c, k, tsel.UniformSelection(), faults="lemons", aggregator="trimmed_mean",
                                quarantine_rounds=10 * rounds, rounds=rounds)
    _, outs = _run(cfg, state, rounds)
    sel = outs["selected"].reshape(-1)
    for lem in lemons:
        assert int((sel == lem).sum()) <= 1
    # the contrast: cooldown 0 clears the counter the round it is set
    cfg0, state0 = _state_and_cfg(c, k, tsel.UniformSelection(), faults="lemons", aggregator="trimmed_mean",
                                  quarantine_rounds=0, rounds=rounds)
    _, outs0 = _run(cfg0, state0, rounds)
    sel0 = outs0["selected"].reshape(-1)
    assert max(int((sel0 == lem).sum()) for lem in lemons) > 1


def test_quarantine_counter_decays():
    cfg, state = _state_and_cfg(12, 6, tsel.UniformSelection(), faults="lemons", aggregator="trimmed_mean",
                                quarantine_rounds=3, rounds=16)
    fin, outs = _run(cfg, state, 16)
    assert int(fin.quarantine.max()) <= 3 and outs["quarantined"].max() > 0


def test_guard_without_faults_keeps_clean_cohorts():
    cfg, state = _state_and_cfg(8, 4, tsel.UniformSelection(), aggregator="clipped_mean")
    assert state.fault_generator is None and state.quarantine is not None
    fin, outs = _run(cfg, state, 6)
    assert (outs["survivors"] == 4).all() and torch.isfinite(outs["loss"]).all()
    assert (outs["identity_round"] == 0).all()


def test_engine_run_is_deterministic_under_faults():
    cfg, s1 = _state_and_cfg(10, 4, tsel.UniformSelection(), faults="chaos", aggregator="trimmed_mean")
    _, s2 = _state_and_cfg(10, 4, tsel.UniformSelection(), faults="chaos", aggregator="trimmed_mean")
    f1, o1 = _run(cfg, s1, 6)
    f2, o2 = _run(cfg, s2, 6)
    assert torch.equal(o1["selected"], o2["selected"]) and _max_param_diff(f1.params, f2.params) == 0.0


def test_fault_stream_moves_no_cohort():
    """The fault draws come from a generator of their own: two guarded runs
    whose guard flags nobody (``mean``) draw the same cohorts under other
    fault models."""
    outs = []
    for faults in ("dropout", "corrupt"):
        cfg, state = _state_and_cfg(10, 4, tsel.UniformSelection(), faults=faults, aggregator="mean")
        outs.append(_run(cfg, state, 4)[1])
    assert (outs[0]["flagged"] == 0).all() and (outs[1]["flagged"] == 0).all()
    assert torch.equal(outs[0]["selected"], outs[1]["selected"])


# --------------------------------------------------- checkpoint / resume


def _assert_states_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state()), f.name
        elif isinstance(x, dict):
            for n in x:
                assert torch.equal(x[n], y[n]), (f.name, n)
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f.name
        elif dataclasses.is_dataclass(x):
            for g in dataclasses.fields(x):
                assert torch.equal(getattr(x, g.name), getattr(y, g.name)), (f.name, g.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("kw", [dict(faults="corrupt", aggregator="trimmed_mean"), dict(),
                                dict(faults="chaos", aggregator="clipped_mean", scenario="flaky")])
def test_checkpoint_resume_bit_parity(tmp_path, kw):
    """Run 6 == run 3, save, restore into a fresh state, run 3: every
    tensor and every generator's state, and the tail's outputs."""
    cfg, state = _state_and_cfg(10, 4, tsel.UniformSelection(), **kw)
    fn = tengine.make_round_fn(cfg, linear_loss, (tsel.UniformSelection(),))
    full, outs_full = tengine.run_scanned(fn, state.fork(), 6)
    half, _ = tengine.run_scanned(fn, state.fork(), 3)
    path = tengine.save_server_state(str(tmp_path), half)
    assert path.endswith("step_00000003")
    _, fresh = _state_and_cfg(10, 4, tsel.UniformSelection(), **kw)
    restored = tengine.restore_server_state(str(tmp_path), fresh)
    _assert_states_equal(restored, half)
    assert restored.generator is not half.generator and restored.round == 3
    resumed, outs_tail = tengine.run_scanned(fn, restored, 3)
    _assert_states_equal(resumed, full)
    for name in outs_tail:
        if not name.startswith("t_"):
            torch.testing.assert_close(outs_tail[name], outs_full[name][3:], rtol=0, atol=0, equal_nan=True)


def test_restore_server_state_rejects_other_config(tmp_path):
    cfg, state = _state_and_cfg(8, 4, tsel.UniformSelection())
    tengine.save_server_state(str(tmp_path), state)
    _, other = _state_and_cfg(12, 4, tsel.UniformSelection())
    with pytest.raises(ValueError):
        tengine.restore_server_state(str(tmp_path), other)
    _, guarded = _state_and_cfg(8, 4, tsel.UniformSelection(), faults="corrupt")
    with pytest.raises(ValueError, match="leaves"):
        tengine.restore_server_state(str(tmp_path), guarded)


def test_run_checkpointed_matches_run_scanned(tmp_path):
    cfg, state = _state_and_cfg(10, 4, tsel.UniformSelection(), faults="corrupt", aggregator="clipped_mean")
    fn = tengine.make_round_fn(cfg, linear_loss, (tsel.UniformSelection(),))
    ref_state, ref_outs = tengine.run_scanned(fn, state.fork(), 7)
    ck_state, ck_outs = tengine.run_checkpointed(fn, state.fork(), 7, ckpt_dir=str(tmp_path), ckpt_every=3)
    _assert_states_equal(ref_state, ck_state)
    assert set(ref_outs) == set(ck_outs)
    for name in ref_outs:
        if not name.startswith("t_"):
            torch.testing.assert_close(ref_outs[name], ck_outs[name], rtol=0, atol=0, equal_nan=True)
    # snapshots at the segment boundaries: rounds 3, 6, 7
    assert sorted(os.listdir(str(tmp_path))) == ["step_00000003", "step_00000006", "step_00000007"]


def test_run_checkpointed_without_dir_is_run_scanned():
    cfg, state = _state_and_cfg(8, 4, tsel.UniformSelection())
    fn = tengine.make_round_fn(cfg, linear_loss, (tsel.UniformSelection(),))
    a, outs_a = tengine.run_scanned(fn, state.fork(), 3)
    b, outs_b = tengine.run_checkpointed(fn, state.fork(), 3)
    assert _max_param_diff(a.params, b.params) == 0.0 and torch.equal(outs_a["selected"], outs_b["selected"])
    c, outs_c = tengine.run_checkpointed(fn, state.fork(), 0, ckpt_dir="unused", ckpt_every=2)
    assert outs_c == {} and c.round == 0


# ------------------------------------------------------- the whole slice


def _cnn_federation(c, n_c=10, seed=2):
    ds = make_image_dataset(n=c * n_c, seed=seed)
    shards = skewness_partition(ds.ys, c, 0.8, 10, samples_per_client=n_c, seed=0)
    cxs = np.stack([ds.xs[s] for s in shards])
    cys = np.stack([ds.ys[s] for s in shards])
    jparams = jcnn.init_cnn(jax.random.key(0), channels=(4, 8), fc1_dim=16)
    return cxs, cys, jparams


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_chaos_slice():
    """JAX's side of the whole slice below, run once per process with
    ``telemetry=True`` and a sink (JAX's other outputs are those of a run
    without it, bit for bit: its ``tests/test_obs.py``): FL-DP³S, C = 12,
    k = 4, ``chaos``, ``trimmed_mean``, FedDyn, six rounds re-profiled
    every 3.  Returns its config, segments (start state, outputs, final
    state), outputs (``telemetry`` apart), the events its sink took, its
    history, final params and losses, the lemon mask and each round's
    uniforms and fault draws."""
    c, k, rounds = 12, 4, 6
    cxs, cys, jparams = _cnn_federation(c)
    kw = dict(num_clients=c, clients_per_round=k, local_epochs=1, lr=0.05, rounds=rounds, eval_every=1, seed=1,
              reprofile_every=3, faults="chaos", aggregator="trimmed_mean", local_algo="feddyn",
              feddyn_alpha=0.1, quarantine_rounds=2)

    segments = []
    j_run = jengine.run_scanned

    def j_run_spy(fn, state, n, **kw_):
        final, outs = j_run(fn, state, n, **kw_)
        segments.append((state, _np(outs), final))
        return final, outs

    with pytest.MonkeyPatch.context() as mp, tempfile.TemporaryDirectory() as tmp:
        mp.setattr(jengine, "run_scanned", j_run_spy)
        jt = jtrainer.FLTrainer(jtrainer.FLConfig(telemetry=True, **kw), jparams, jcnn.cnn_loss,
                                jcnn.apply_with_features, cxs, cys, jsel.DPPSelection(), accuracy_fn=jcnn.accuracy)
        with jobs.TelemetrySink(f"{tmp}/jax.jsonl") as jsink:
            jhist = jt.run(sink=jsink)
        jevents = jobs.load_events(f"{tmp}/jax.jsonl")
    assert [int(s[0].round) for s in segments] == [0, 3]
    jouts = {name: np.concatenate([o[name] for _, o, _ in segments]) for name in segments[0][1] if name != "telemetry"}
    # the run exercised the guard: a flagged client, a dropped one, quarantine
    assert jouts["flagged"].sum() > 0 and (jouts["survivors"] < k).any() and jouts["quarantined"].max() > 0

    jm = jfaults.get_fault_model("chaos")
    jlem = np.asarray(jfaults.lemon_mask(jm, c))
    fault_u = []
    for state, outs, _ in segments:
        key = state.key
        for _ in range(len(outs["round"])):
            fk = jax.random.fold_in(key, jfaults.FAULT_SALT)
            fault_u.append(([torch.from_numpy(x) for x in _jax_uniforms(fk, c, 1)],
                            jfaults.draw_round_faults(fk, jm, c, 1, jnp.asarray(jlem))))
            key = jax.random.split(key, 3)[0]
    return dict(kw=kw, c=c, cxs=cxs, cys=cys, jparams=jparams, segments=segments, jouts=jouts, jevents=jevents,
                jhist=jhist, final_params=jt.params, final_losses=np.asarray(jt.losses), jlem=jlem, fault_u=fault_u)


def _port_chaos_slice(monkeypatch, j, telemetry=False, sink=None):
    """The port's side of the whole slice on JAX's cohorts, lemons and
    fault uniforms -> (the trainer, its history, its segments' (outputs,
    final state))."""
    c, jlem = j["c"], j["jlem"]
    cohorts = [np.array(s) for s in j["jouts"]["selected"]]
    fault_u = list(j["fault_u"])

    class Replay(tsel.DPPSelection):
        def draw_fn(self, generator, state, k_, avail=None):
            sel = cohorts.pop(0)
            assert avail is not None  # a guarded run draws under a mask every round
            if int(avail.sum()) >= k_:
                assert bool(avail[torch.from_numpy(sel).long()].all())
            return torch.from_numpy(sel)

    tt = ttrainer.FLTrainer(ttrainer.FLConfig(telemetry=telemetry, **j["kw"]), tcnn.params_from_jax(_np(j["jparams"])),
                            tcnn.cnn_loss, tcnn.apply_with_features, j["cxs"], j["cys"], Replay(),
                            accuracy_fn=tcnn.accuracy, device="cpu")

    def replay_faults(generator, model, n, shards, lemons):
        assert generator is tt.fault_generator and model.name == "chaos" and (n, shards) == (c, 1)
        np.testing.assert_array_equal(lemons.numpy(), jlem)
        u, want = fault_u.pop(0)
        draws = tfaults.faults_from_uniforms(u, model, n, shards, lemons)
        for a, b in zip(draws, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        return draws

    t_segments = []
    t_run = tengine.run_scanned

    def t_run_spy(fn, state, n, **kw_):
        final, outs = t_run(fn, state, n, **kw_)
        t_segments.append((outs, final))
        return final, outs

    monkeypatch.setattr(tfaults, "lemon_mask", lambda model, n: torch.from_numpy(jlem.copy()))
    monkeypatch.setattr(tfaults, "draw_round_faults", replay_faults)
    monkeypatch.setattr(tengine, "run_scanned", t_run_spy)
    thist = tt.run(sink=sink)
    assert not cohorts and not fault_u and len(t_segments) == 2
    return tt, thist, t_segments


def test_whole_slice_chaos_trimmed_feddyn_matches_jax(monkeypatch):
    """FL-DP³S, C = 12, k = 4, ``chaos`` faults, ``trimmed_mean``, FedDyn,
    six rounds re-profiled every 3, through each package's
    ``FLTrainer.run`` (JAX's through its ``run_scanned`` segments).  The
    port gets JAX's cohorts, its lemon mask, and each round's fault masks
    made by the port's ``faults_from_uniforms`` from JAX's uniforms; every
    cohort is drawn under a mask, among the clients out of quarantine.
    ``selected``, ``survivors``, ``flagged``, ``quarantined`` and
    ``identity_round`` equal JAX's, and so do the quarantine counters at
    each segment's end; loss, GEMD and accuracy, the last-known losses,
    the params and FedDyn's state agree within the engine tests' bounds."""
    j = _jax_chaos_slice()
    c, jouts, jhist, segments = j["c"], j["jouts"], j["jhist"], j["segments"]
    tt, thist, t_segments = _port_chaos_slice(monkeypatch, j)

    touts = {name: v.numpy() for name, v in tengine.concat_outputs([o for o, _ in t_segments]).items()}
    assert "telemetry" not in touts
    for name in ("selected", "survivors", "flagged", "quarantined", "identity_round"):
        np.testing.assert_array_equal(touts[name], jouts[name], err_msg=name)
    for (_, tfin), (_, _, jfin) in zip(t_segments, segments):
        np.testing.assert_array_equal(tfin.quarantine.numpy(), np.asarray(jfin.quarantine))
    np.testing.assert_allclose(touts["loss"], jouts["loss"], atol=1e-5)
    np.testing.assert_allclose(touts["gemd"], jouts["gemd"], atol=1e-6)
    np.testing.assert_allclose(touts["acc"], jouts["acc"], rtol=0, atol=1e-6)
    assert thist["round"] == jhist["round"]
    np.testing.assert_allclose(thist["loss"], jhist["loss"], atol=1e-5)
    want = tcnn.params_from_jax(_np(j["final_params"]))
    for name, w in want.items():
        np.testing.assert_allclose(tt.params[name].numpy(), w.numpy(), atol=1e-4, err_msg=name)
    np.testing.assert_allclose(tt.losses.numpy(), j["final_losses"], atol=1e-5)
    # FedDyn's h, in the port's layout: nonzero only for clients kept at
    # least once, JAX's within the params' bound
    th = t_segments[-1][1].algo_state
    jstate = _np(segments[-1][2].algo_state)
    jh = [tcnn.params_from_jax(jax.tree_util.tree_map(lambda x: x[i], jstate)) for i in range(c)]
    for name, h in th.items():
        np.testing.assert_allclose(h.numpy(), np.stack([x[name].numpy() for x in jh]), atol=1e-4, err_msg=name)


def test_whole_slice_chaos_trimmed_feddyn_telemetry_matches_jax(monkeypatch, tmp_path):
    """The slice above with ``telemetry=True`` and a sink on each side:
    the port's Telemetry fields are JAX's (the guard's counts exactly,
    ``cache_age`` [0, 1, 2, 0, 1, 2], ``spectrum_*`` within the kernels'
    1e-4), and its sink's events are JAX's sink's, in order and key for
    key on JAX's keys (``test_torch_obs.assert_events_match_jax``)."""
    from test_torch_obs import assert_events_match_jax, assert_telemetry_matches_jax

    j = _jax_chaos_slice()
    with tobs.TelemetrySink(str(tmp_path / "port.jsonl")) as sink:
        _, _, t_segments = _port_chaos_slice(monkeypatch, j, telemetry=True, sink=sink)
    tel = tengine.concat_outputs([o for o, _ in t_segments])["telemetry"]
    assert_telemetry_matches_jax(tel, [o["telemetry"] for _, o, _ in j["segments"]])
    assert tel.cache_age.tolist() == [0, 1, 2, 0, 1, 2] and int(tel.flagged.sum()) > 0
    events = tobs.load_events(str(tmp_path / "port.jsonl"))
    assert [e["event"] for e in events] == ["fl_round"] * 3 + ["fl_reprofile"] + ["fl_round"] * 3
    assert_events_match_jax(events, j["jevents"])
