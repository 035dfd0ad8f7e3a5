"""The port's federation engine against the JAX package's on the CPU:
accuracy in the round, ``FLTrainer.run`` through the engine against the
port's own legacy loop (bit for bit), the Cluster baseline on the engine,
``run_many`` over a strategy grid, and the whole slice — FL-DP³S through
the funnel under the flaky scenario across a reprofile boundary — against
JAX's ``FLTrainer.run`` (its ``run_scanned`` segments) with JAX's cohorts
and environment draws replayed.  The JAX side's Pallas kernels run in
interpret mode, the port's K1 + K2 through their plain versions."""

import dataclasses
import functools
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import selection as jsel  # noqa: E402
from repro.data import make_image_dataset, skewness_partition  # noqa: E402
from repro.fl import engine as jengine  # noqa: E402
from repro.fl import scenarios as jscen  # noqa: E402
from repro.fl import trainer as jtrainer  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro import obs as jobs  # noqa: E402

from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.fl import engine as tengine  # noqa: E402
from repro_torch.fl import trainer as ttrainer  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402

K, N_C = 3, 10
GRID = ("fedavg", "fl-dp3s", "fedsae", "power-of-choice", "cluster")


def _federation(c, seed=2, n_c=N_C):
    ds = make_image_dataset(n=c * n_c, seed=seed)
    shards = skewness_partition(ds.ys, c, 0.8, 10, samples_per_client=n_c, seed=0)
    cxs = np.stack([ds.xs[s] for s in shards])
    cys = np.stack([ds.ys[s] for s in shards])
    jparams = jcnn.init_cnn(jax.random.key(0), channels=(4, 8), fc1_dim=16)
    return cxs, cys, jparams


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_state(cfg, cxs, cys, jparams, jstate, strategy, **kw):
    """The port's init on JAX's profiles and losses (so the two draw on one
    kernel)."""
    return tengine.init_server_state(
        cfg, tcnn.params_from_jax(_np(jparams)), cxs, cys, _t(jstate.profiles), _t(jstate.losses),
        strategy, device="cpu", loss_fn=tcnn.cnn_loss, **kw,
    )


class _Replay(tsel.DPPSelection):
    """The port's strategy handing out JAX's cohorts in order."""

    def __init__(self, cohorts):
        super().__init__()
        self.cohorts = [np.array(c) for c in cohorts]

    def draw_fn(self, generator, state, k, avail=None):
        return torch.from_numpy(self.cohorts.pop(0))


def _assert_params_close(tparams, jparams):
    # rounds of SGD on fp32 gradients whose conv sums differ in order
    want = tcnn.params_from_jax(_np(jparams))
    for name, w in want.items():
        np.testing.assert_allclose(tparams[name].numpy(), w.numpy(), atol=1e-4, err_msg=name)


# ------------------------------------------------------ accuracy in round


@pytest.mark.parametrize("held_out", [False, True])
@pytest.mark.parametrize("eval_every", [2, 3])
def test_accuracy_in_the_round_matches_jax(eval_every, held_out):
    """Four rounds on JAX's cohorts: ``acc`` is NaN off the ``eval_every``
    grid and JAX's on it (a count of argmax hits; the two round count / n
    apart by at most 1e-6), on the union training set or held-out data."""
    c, rounds = 8, 4
    cxs, cys, jparams = _federation(c)
    ev = make_image_dataset(n=50, seed=9)
    kw = dict(num_clients=c, clients_per_round=K, local_epochs=1, lr=0.05, eval_every=eval_every, seed=0)
    jstrat = jsel.DPPSelection()
    jcfg = jengine.FLConfig(**kw)
    jstate = jengine.init_server_state(jcfg, jparams, jcnn.cnn_loss, jcnn.apply_with_features,
                                       cxs, cys, strategy=jstrat)
    jfn = jengine.make_round_fn(jcfg, jcnn.cnn_loss, (jstrat,), accuracy_fn=jcnn.accuracy,
                                eval_data=(jnp.asarray(ev.xs), jnp.asarray(ev.ys)) if held_out else None)
    jfinal, jouts = jengine.run_scanned(jfn, jstate, rounds)
    jouts = _np(jouts)

    strat = _Replay(jouts["selected"])
    cfg = tengine.FLConfig(**kw)
    state = _port_state(cfg, cxs, cys, jparams, jstate, strat)
    fn = tengine.make_round_fn(cfg, tcnn.cnn_loss, (strat,), accuracy_fn=tcnn.accuracy,
                               eval_data=(_t(ev.xs), _t(ev.ys)) if held_out else None)
    final, outs = tengine.run_scanned(fn, state, rounds)
    acc = outs["acc"].numpy()
    on = np.arange(1, rounds + 1) % eval_every == 0
    assert acc.dtype == np.float32 and np.isnan(acc[~on]).all() and np.isnan(jouts["acc"][~on]).all()
    assert np.isfinite(acc[on]).all()
    np.testing.assert_allclose(acc[on], jouts["acc"][on], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(outs["selected"].numpy(), jouts["selected"])
    np.testing.assert_allclose(outs["loss"].numpy(), jouts["loss"], atol=1e-5)
    np.testing.assert_allclose(outs["gemd"].numpy(), jouts["gemd"], atol=1e-6)
    _assert_params_close(final.params, jfinal.params)
    np.testing.assert_allclose(final.losses.numpy(), np.asarray(jfinal.losses), atol=1e-5)
    assert final.round == rounds and set(outs) >= {"t_select", "t_local", "t_refresh"}


def test_round_without_accuracy_fn_reports_nan():
    c = 6
    cxs, cys, jparams = _federation(c)
    cfg = tengine.FLConfig(num_clients=c, clients_per_round=2, local_epochs=1, eval_every=1)
    jstate = jengine.init_server_state(jengine.FLConfig(num_clients=c, clients_per_round=2), jparams,
                                       jcnn.cnn_loss, jcnn.apply_with_features, cxs, cys)
    strat = tsel.UniformSelection()
    fn = tengine.make_round_fn(cfg, tcnn.cnn_loss, (strat,))
    _, outs = tengine.run_scanned(fn, _port_state(cfg, cxs, cys, jparams, jstate, strat), 2)
    assert np.isnan(outs["acc"].numpy()).all() and "sim_time" not in outs
    with pytest.raises(ValueError, match="at least one strategy"):
        tengine.make_round_fn(cfg, tcnn.cnn_loss, ())


# ----------------------------------------------- engine against legacy


def _trainer(cfg, name, seed=0):
    cxs, cys, jparams = _federation(cfg.num_clients, seed=seed + 2)
    params = tcnn.params_from_jax(_np(jparams))
    return ttrainer.FLTrainer(cfg, params, tcnn.cnn_loss, tcnn.apply_with_features, cxs, cys,
                              tsel.make_strategy(name), accuracy_fn=tcnn.accuracy, device="cpu")


@pytest.mark.parametrize("batch", [None, 4])
@pytest.mark.parametrize("name", GRID + ("heavy_tail",))
def test_run_equals_run_legacy_bit_for_bit(name, batch):
    """Five rounds, re-profiled every 2, then two more continuing the round
    count: the engine's run and the legacy loop give the same history,
    parameters, losses and generator state bit for bit (``heavy_tail``:
    FL-DP³S under a latency-only scenario, which the legacy loop ignores
    and the engine draws from a stream of its own)."""
    scenario = "heavy_tail" if name == "heavy_tail" else None
    strat = "fl-dp3s" if scenario else name
    cfg = tengine.FLConfig(num_clients=8, clients_per_round=K, local_epochs=1, local_batch_size=batch,
                           lr=0.05, rounds=5, eval_every=2, seed=1, reprofile_every=2, scenario=scenario)
    eng, leg = _trainer(cfg, strat), _trainer(cfg, strat)
    h_eng = eng.run()
    h_leg = leg.run_legacy()
    h_eng = eng.run(rounds=2)
    h_leg = leg.run_legacy(rounds=2)
    assert h_eng["round"] == h_leg["round"] == [2, 4, 5, 6, 7]
    for key in ("acc", "gemd", "loss"):
        np.testing.assert_array_equal(np.asarray(h_eng[key]), np.asarray(h_leg[key]), err_msg=key)
    for pname in eng.params:
        np.testing.assert_array_equal(eng.params[pname].numpy(), leg.params[pname].numpy())
    np.testing.assert_array_equal(eng.losses.numpy(), leg.losses.numpy())
    assert torch.equal(eng.generator.get_state(), leg.generator.get_state())
    # both re-profiled at round 6, the last multiple of reprofile_every
    np.testing.assert_array_equal(eng.round_state.profiles.numpy(), leg.round_state.profiles.numpy())
    assert eng.round_state.round == leg.round_state.round == 7


def test_legacy_loop_refuses_an_availability_scenario():
    cfg = tengine.FLConfig(num_clients=6, clients_per_round=2, local_epochs=1, rounds=1, scenario="flaky")
    tr = _trainer(cfg, "fedavg")
    with pytest.raises(ValueError, match="masks availability"):
        tr.run_legacy()
    assert tr.run()["round"] == [1]  # the engine draws it


def test_custom_strategy_without_draw_fn_runs_the_legacy_loop(monkeypatch):
    """A strategy that overrides only ``select`` (a host-side draw on the
    round state) runs through ``run_legacy``, which calls it each round."""

    class HostOnly(tsel.SelectionStrategy):
        name = "host-only"

        rounds = []

        def select(self, generator, state, k):
            self.rounds.append(state.round)
            return torch.arange(state.round % 2, state.round % 2 + k, dtype=torch.int32)

    cfg = tengine.FLConfig(num_clients=6, clients_per_round=2, local_epochs=1, rounds=3, eval_every=1)
    cxs, cys, jparams = _federation(6)
    tr = ttrainer.FLTrainer(cfg, tcnn.params_from_jax(_np(jparams)), tcnn.cnn_loss, tcnn.apply_with_features,
                            cxs, cys, HostOnly(), device="cpu")
    assert not tr._supports_engine()
    calls = []
    monkeypatch.setattr(tr, "run_legacy", lambda **kw: calls.append(kw) or ttrainer.FLTrainer.run_legacy(tr, **kw))
    before = tr.losses.clone()
    hist = tr.run()
    assert calls == [dict(rounds=3, progress=False)] and hist["round"] == [1, 2, 3]
    assert tr.strategy.rounds == [1, 2, 3]
    # rounds 1 and 3 trained clients 1 and 2, round 2 clients 0 and 1
    changed = (tr.losses != before).tolist()
    assert changed == [True, True, True, False, False, False]


# ---------------------------------------------------- Cluster on engine


def _cluster_gumbels(key, k, c):
    """The Gumbel rows of JAX's vmapped categorical: one per split key."""
    return np.stack([np.asarray(jax.random.gumbel(kk, (c,), jnp.float32)) for kk in jax.random.split(key, k)])


@pytest.mark.parametrize("frac", [None, 0.5])
def test_cluster_baseline_on_the_engine_matches_jax(frac):
    """``init_server_state`` fits the Cluster labels on the representative
    gradients (on the candidate rows under the funnel): JAX's labels.  Three
    rounds on JAX's noise then give JAX's cohorts, one client per cluster,
    and JAX's losses, GEMD and parameters."""
    c, rounds = 12, 3
    cxs, cys, jparams = _federation(c)
    kw = dict(num_clients=c, clients_per_round=K, local_epochs=1, lr=0.05, eval_every=1, seed=0,
              candidate_frac=frac)
    jcfg = jengine.FLConfig(**kw)
    jstrat = jsel.ClusterSelection()
    jstate = jengine.init_server_state(jcfg, jparams, jcnn.cnn_loss, jcnn.apply_with_features,
                                       cxs, cys, strategy=jstrat)
    jfn = jengine.make_round_fn(jcfg, jcnn.cnn_loss, (jstrat,), accuracy_fn=jcnn.accuracy)
    jfinal, jouts = jengine.run_scanned(jfn, jstate, rounds)
    jouts = _np(jouts)
    q = c if frac is None else jcfg.candidate_count()
    key, noise = jax.random.key(0), []
    for _ in range(rounds):
        key, k_sel, _ = jax.random.split(key, 3)
        noise.append(_t(_cluster_gumbels(k_sel, K, q)))

    class Replay(tsel.ClusterSelection):
        def noise(self, generator, state, k, avail=None):
            return noise.pop(0)

    strat = Replay()
    cfg = tengine.FLConfig(**kw)
    state = _port_state(cfg, cxs, cys, jparams, jstate, strat)
    labels = np.asarray(jstate.cluster_labels)
    assert labels.shape == (q,) and len(set(labels.tolist())) == K
    np.testing.assert_array_equal(state.cluster_labels.numpy(), labels)
    if frac is not None:
        np.testing.assert_array_equal(state.candidates.numpy(), np.asarray(jstate.candidates))
    fn = tengine.make_round_fn(cfg, tcnn.cnn_loss, (strat,), accuracy_fn=tcnn.accuracy)
    final, outs = tengine.run_scanned(fn, state, rounds)
    assert not noise
    np.testing.assert_array_equal(outs["selected"].numpy(), jouts["selected"])
    ids = np.arange(c) if frac is None else np.asarray(jstate.candidates)
    for sel in outs["selected"].numpy():
        assert sorted(labels[np.searchsorted(ids, sel)].tolist()) == list(range(K))
    np.testing.assert_allclose(outs["loss"].numpy(), jouts["loss"], atol=1e-5)
    np.testing.assert_allclose(outs["gemd"].numpy(), jouts["gemd"], atol=1e-6)
    np.testing.assert_allclose(outs["acc"].numpy(), jouts["acc"], rtol=0, atol=1e-6)
    _assert_params_close(final.params, jfinal.params)


def test_cluster_init_needs_a_loss_fn():
    cxs, cys, jparams = _federation(6)
    cfg = tengine.FLConfig(num_clients=6, clients_per_round=2)
    with pytest.raises(ValueError, match="needs loss_fn"):
        tengine.init_server_state(cfg, tcnn.params_from_jax(_np(jparams)), cxs, cys, torch.ones(6, 4),
                                  torch.ones(6), tsel.ClusterSelection(), device="cpu")


# ------------------------------------------------------------- run_many


def _grid_states(cfg, cxs, cys, jparams, strategies):
    jstate = jengine.init_server_state(jengine.FLConfig(num_clients=cfg.num_clients, clients_per_round=K),
                                       jparams, jcnn.cnn_loss, jcnn.apply_with_features, cxs, cys)
    return [_port_state(cfg, cxs, cys, jparams, jstate, s, strategy_index=i) for i, s in enumerate(strategies)]


@pytest.mark.parametrize("scenario", [None, "flaky"])
def test_run_many_equals_each_states_run_scanned(scenario):
    """A five-strategy grid, three rounds: each grid point's outputs and
    final state are its own ``run_scanned``'s bit for bit, in JAX's
    (batch, rounds, ...) layout."""
    c, rounds = 10, 3
    cxs, cys, jparams = _federation(c)
    cfg = tengine.FLConfig(num_clients=c, clients_per_round=K, local_epochs=1, local_batch_size=4, lr=0.05,
                           eval_every=1, seed=0, scenario=scenario)
    strategies = tuple(tsel.make_strategy(n) for n in GRID)
    states = _grid_states(cfg, cxs, cys, jparams, strategies)
    assert [s.strategy_index for s in states] == list(range(len(GRID)))
    fn = tengine.make_round_fn(cfg, tcnn.cnn_loss, strategies, accuracy_fn=tcnn.accuracy)
    alone = [tengine.run_scanned(fn, s.fork(), rounds) for s in states]
    finals, outs = tengine.run_many(fn, tengine.stack_states(states), rounds)
    assert outs["selected"].shape == (len(GRID), rounds, K) and outs["acc"].shape == (len(GRID), rounds)
    for i, (final, out) in enumerate(alone):
        for key in ("selected", "loss", "gemd", "acc") + (("sim_time", "avail") if scenario else ()):
            np.testing.assert_array_equal(outs[key][i].numpy(), out[key].numpy(), err_msg=f"{GRID[i]} {key}")
        np.testing.assert_array_equal(finals[i].losses.numpy(), final.losses.numpy())
        for pname in final.params:
            np.testing.assert_array_equal(finals[i].params[pname].numpy(), final.params[pname].numpy())
    # the grid points differ: one strategy each
    assert len({tuple(outs["selected"][i].reshape(-1).tolist()) for i in range(len(GRID))}) > 1
    # cluster draws one client per fitted cluster
    labels = states[GRID.index("cluster")].cluster_labels
    for sel in outs["selected"][GRID.index("cluster")]:
        if scenario is None:
            assert sorted(labels[sel.long()].tolist()) == list(range(K))


def test_stack_states_and_unstack_outputs():
    c = 6
    cxs, cys, jparams = _federation(c)
    cfg = tengine.FLConfig(num_clients=c, clients_per_round=2, local_epochs=1, eval_every=1)
    strategies = (tsel.UniformSelection(), tsel.FedSAESelection())
    states = _grid_states(cfg, cxs, cys, jparams, strategies)
    stacked = tengine.stack_states(states)
    assert isinstance(stacked, tuple) and len(stacked) == 2 and stacked[1] is states[1]
    with pytest.raises(ValueError, match="at least one state"):
        tengine.stack_states([])
    other = dataclasses.replace(states[0], client_xs=states[0].client_xs[:, :5])
    with pytest.raises(ValueError, match="differ in client data"):
        tengine.stack_states([states[0], other])
    fn = tengine.make_round_fn(cfg, tcnn.cnn_loss, strategies)
    _, outs = tengine.run_many(fn, stacked, 2)
    runs = tengine.unstack_outputs(outs)
    assert len(runs) == 2
    for i, run in enumerate(runs):
        assert set(run) == set(outs) and run["selected"].shape == (2, 2)
        for key, v in run.items():
            assert isinstance(v, np.ndarray)
            np.testing.assert_array_equal(v, outs[key][i].numpy())
    finals, empty = tengine.run_many(fn, stacked, 0)
    assert empty == {} and tengine.unstack_outputs(empty) == [] and len(finals) == 2
    # fork: the copy's generators draw as the original would have
    f = states[0].fork()
    assert f.generator is not states[0].generator
    assert torch.equal(torch.rand(3, generator=f.generator), torch.rand(3, generator=states[0].generator))


# ---------------------------------------------------------------- config


@pytest.mark.parametrize(
    "field,value,item",
    [("cohort_cap", 2, 15), ("staleness_bound", 1, 15)],
)
def test_flconfig_refusals_name_their_roadmap_item(field, value, item):
    """ROADMAP Queue 1 item ``item`` ported these fields: FLConfig takes them
    where JAX's does and refuses them where JAX's does, with its messages.
    The name dates from when FLConfig refused these fields."""
    kw = {field: value, "scenario": "heavy_tail"}
    assert getattr(tengine.FLConfig(**kw), field) == getattr(jengine.FLConfig(**kw), field) == value
    with pytest.raises(ValueError, match="incompatible"):
        tengine.FLConfig(cohort_cap=value, staleness_bound=value, scenario="heavy_tail")


# ------------------------------------------------------- the whole slice


@functools.lru_cache(maxsize=None)
def _jax_funnel_flaky_slice():
    """JAX's side of the whole slice below, run once per process with
    ``telemetry=True`` (JAX's other outputs are those of a run without it,
    bit for bit: its ``tests/test_obs.py``): FL-DP³S, C = 16, Q = 8, flaky,
    three rounds re-profiled after the second, through ``FLTrainer.run``.
    Returns its config, segments, funnels, outputs (``telemetry`` apart),
    the events its sink took, history, final params and losses, and the
    environment draws replayed from its keys."""
    c, rounds = 16, 3
    cxs, cys, jparams = _federation(c)
    kw = dict(num_clients=c, clients_per_round=K, local_epochs=1, lr=0.05, rounds=rounds, eval_every=1,
              seed=0, reprofile_every=2, candidate_frac=0.5, scenario="flaky", use_pallas_kernel=True)

    segments, funnels = [], []
    j_run, j_funnel = jengine.run_scanned, jengine.funnel_fields

    def j_run_spy(fn, state, n, **kw_):
        final, outs = j_run(fn, state, n, **kw_)
        segments.append((state, _np(outs)))
        return final, outs

    def j_funnel_spy(cfg, key, profiles, losses, **kw_):
        out = j_funnel(cfg, key, profiles, losses, **kw_)
        funnels.append((key, kw_.get("round_index", 0), _np(out[0]), _np(out[1])))
        return out

    with pytest.MonkeyPatch.context() as mp, tempfile.TemporaryDirectory() as tmp:
        mp.setattr(jengine, "run_scanned", j_run_spy)
        mp.setattr(jengine, "funnel_fields", j_funnel_spy)
        jt = jtrainer.FLTrainer(jtrainer.FLConfig(telemetry=True, **kw), jparams, jcnn.cnn_loss,
                                jcnn.apply_with_features, cxs, cys, jsel.DPPSelection(), accuracy_fn=jcnn.accuracy)
        with jobs.TelemetrySink(f"{tmp}/jax.jsonl") as jsink:
            jhist = jt.run(sink=jsink)
        jevents = jobs.load_events(f"{tmp}/jax.jsonl")
    assert [s[0].round for s in segments] == [0, 2] and [f[1] for f in funnels] == [0, 2]
    assert not np.array_equal(funnels[0][2], funnels[1][2])  # the boundary re-funnelled

    scen = jscen.get_scenario("flaky")

    def env_of(key, salt, t):
        k_env = jax.random.fold_in(key, salt)
        return (_t(scen.latency(jax.random.fold_in(k_env, 0), c)),
                _t(scen.availability(jax.random.fold_in(k_env, 1), t, c)))

    round_env = []
    for state, outs in segments:
        key = state.key
        for i in range(len(outs["round"])):
            round_env.append(env_of(key, jengine._ENV_SALT, int(state.round) + i + 1))
            key = jax.random.split(key, 3)[0]
    funnel_env = [env_of(key, jengine._FUNNEL_SALT, r) for key, r, _, _ in funnels]
    jouts = {name: np.concatenate([o[name] for _, o in segments]) for name in segments[0][1] if name != "telemetry"}
    for (lat, avail), want in zip(round_env, jouts["avail"]):
        np.testing.assert_array_equal(avail.numpy(), want)
    return dict(kw=kw, c=c, cxs=cxs, cys=cys, jparams=jparams, segments=segments, funnels=funnels, jouts=jouts,
                jevents=jevents, jhist=jhist, final_params=jt.params, final_losses=np.asarray(jt.losses),
                round_env=round_env, funnel_env=funnel_env)


def _port_funnel_flaky_slice(monkeypatch, j, telemetry=False, sink=None):
    """The port's side of the whole slice on JAX's cohorts and environment
    draws -> (the trainer, its history, its segments' outputs joined, the
    funnels it built)."""
    c = j["c"]
    cohorts = [np.array(s) for s in j["jouts"]["selected"]]
    round_env, funnel_env = list(j["round_env"]), list(j["funnel_env"])

    class Replay(tsel.DPPSelection):
        def draw_fn(self, generator, state, k, avail=None):
            sel = cohorts.pop(0)
            ids = state.candidates.ids.numpy()
            assert avail is not None and np.isin(sel, ids).all()
            local = np.searchsorted(ids, sel)
            if int(avail.sum()) >= k:
                assert bool(avail[torch.from_numpy(local)].all())
            return torch.from_numpy(local.astype(np.int32))

    tt = ttrainer.FLTrainer(ttrainer.FLConfig(telemetry=telemetry, **j["kw"]), tcnn.params_from_jax(_np(j["jparams"])),
                            tcnn.cnn_loss, tcnn.apply_with_features, j["cxs"], j["cys"], Replay(),
                            accuracy_fn=tcnn.accuracy, device="cpu")

    def replay_env(scen_, generator, t, n):
        assert scen_.name == "flaky" and n == c
        if generator is tt.funnel_generator:
            return funnel_env.pop(0)
        assert generator is tt.env_generator
        return round_env.pop(0)

    t_segments, t_funnels = [], []
    t_run, t_funnel = tengine.run_scanned, tengine.funnel_fields

    def t_run_spy(fn, state, n, **kw_):
        final, outs = t_run(fn, state, n, **kw_)
        t_segments.append(outs)
        return final, outs

    def t_funnel_spy(*a, **kw_):
        out = t_funnel(*a, **kw_)
        t_funnels.append(out)
        return out

    monkeypatch.setattr(tengine, "draw_environment", replay_env)
    monkeypatch.setattr(tengine, "run_scanned", t_run_spy)
    monkeypatch.setattr(tengine, "funnel_fields", t_funnel_spy)
    thist = tt.run(sink=sink)
    assert not cohorts and not round_env and not funnel_env and len(t_funnels) == 2
    return tt, thist, tengine.concat_outputs(t_segments), t_funnels


def test_whole_slice_funnel_flaky_matches_jax(monkeypatch):
    """FL-DP³S, C = 16, Q = 8 (``candidate_frac=0.5``), scenario flaky,
    three rounds re-profiled after the second, through each package's
    ``FLTrainer.run``; JAX's through its ``run_scanned`` segments.  The
    port gets JAX's cohorts and environment draws (the rounds' and the
    funnel's predictions, replayed from JAX's keys) and must reach JAX's
    candidates at init and at the boundary, kernels within 1e-4 (the
    boundary's on profiles after two rounds of SGD), every cohort among its
    candidates and available, JAX's ``avail`` and ``sim_time`` exactly, and
    loss, GEMD, accuracy and parameters to the tolerances of the
    unfunnelled slice test."""
    j = _jax_funnel_flaky_slice()
    tt, thist, touts, t_funnels = _port_funnel_flaky_slice(monkeypatch, j)
    jouts, jhist = j["jouts"], j["jhist"]
    assert "telemetry" not in touts

    for (cand, kern, _), (_, _, jcand, jkern) in zip(t_funnels, j["funnels"]):
        np.testing.assert_array_equal(cand.numpy(), jcand)
        np.testing.assert_allclose(kern.numpy(), jkern, rtol=1e-4, atol=1e-4)
    touts = {name: v.numpy() for name, v in touts.items()}
    np.testing.assert_array_equal(touts["selected"], jouts["selected"])
    np.testing.assert_array_equal(touts["avail"], jouts["avail"])
    np.testing.assert_array_equal(touts["sim_time"], jouts["sim_time"])
    np.testing.assert_allclose(touts["acc"], jouts["acc"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(touts["loss"], jouts["loss"], atol=1e-5)
    np.testing.assert_allclose(touts["gemd"], jouts["gemd"], atol=1e-6)
    assert thist["round"] == jhist["round"] == [1, 2, 3]
    np.testing.assert_allclose(thist["acc"], jhist["acc"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(thist["loss"], jhist["loss"], atol=1e-5)
    _assert_params_close(tt.params, j["final_params"])
    np.testing.assert_allclose(tt.losses.numpy(), j["final_losses"], atol=1e-5)


def test_whole_slice_funnel_flaky_telemetry_matches_jax(monkeypatch, tmp_path):
    """The slice above with ``telemetry=True`` and a sink on each side:
    the port's Telemetry fields are JAX's (``cache_age`` [0, 1, 0],
    ``funnel_q`` 8, the availability JAX drew), and its sink's ``fl_round``
    and ``fl_reprofile`` events are JAX's sink's, in order and key for key
    (``test_torch_obs.assert_events_match_jax``)."""
    from test_torch_obs import assert_events_match_jax, assert_telemetry_matches_jax

    j = _jax_funnel_flaky_slice()
    with tobs.TelemetrySink(str(tmp_path / "port.jsonl")) as sink:
        _, _, touts, _ = _port_funnel_flaky_slice(monkeypatch, j, telemetry=True, sink=sink)
    tel = touts["telemetry"]
    assert_telemetry_matches_jax(tel, [o["telemetry"] for _, o in j["segments"]])
    assert tel.cache_age.tolist() == [0, 1, 0] and tel.funnel_q.tolist() == [8, 8, 8]
    events = tobs.load_events(str(tmp_path / "port.jsonl"))
    assert [e["event"] for e in events] == ["fl_round"] * 2 + ["fl_reprofile"] + ["fl_round"]
    assert_events_match_jax(events, j["jevents"])
