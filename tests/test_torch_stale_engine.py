"""The port's bounded-staleness rounds on a client mesh, and the sharded
rounds against the parts of the JAX reference that hold at D > 1.

On this jax, JAX's synchronous and slot mesh bodies part from its own
single-device engine at D > 1, while its stale body agrees with it at
bound 0 (ROADMAP Queue 3).  So the port is held:

* at D = 1, the stale round against JAX's stale round on its 1-device
  mesh, in this process;
* at D = 2, the stale round at bound 2 against JAX's stale round on 2
  virtual devices, and against a plain loop written here (each shard's
  cohort members trained from the params of round ``t − s_d`` and weighed
  by λ(s_d)·n_c), so that a fault the two share cannot pass unseen;
* at bound 0 (D = 2 and 4), to the synchronous port round bit for bit;
* at D = 2 under chaos faults, the trimmed mean and FedDyn, the resident
  and slot rounds against JAX's stale round at bound 0 on 2 devices (the
  guard and the blackout run per shard there too);
* at D = 2, the synchronous round against JAX's single-device engine, not
  against JAX's 2-device result.

JAX's 2-device runs are made once, in one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=2`` (this process's JAX
has one CPU device), which writes its results to an ``.npz``."""

import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import selection as jsel  # noqa: E402
from repro.fl import engine as jengine  # noqa: E402
from repro.fl import scenarios as jscen  # noqa: E402
from repro.launch.mesh import make_client_mesh as j_make_client_mesh  # noqa: E402

from repro_torch.core import dpp as tdpp  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.fl import engine as tengine  # noqa: E402
from repro_torch.fl import faults as tfaults  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

FEAT, N_C, NCLS = 8, 6, 4
C, K, ROUNDS = 8, 3, 8
STALE = dict(scenario="heavy_tail", staleness_bound=2, staleness_decay="exponential", staleness_alpha=0.3)
GUARD = dict(scenario="heavy_tail", staleness_bound=0, faults="chaos", aggregator="trimmed_mean",
             local_algo="feddyn", feddyn_alpha=0.1, quarantine_rounds=2)


def _federation(c=C, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(c, N_C, FEAT)).astype(np.float32)
    ys = rng.integers(0, NCLS, size=(c, N_C)).astype(np.int32)
    params = {"w": (0.01 * rng.normal(size=(FEAT, NCLS))).astype(np.float32), "b": np.zeros((NCLS,), np.float32)}
    return xs, ys, params


def _cfg_kw(**kw):
    base = dict(num_clients=C, clients_per_round=K, local_epochs=2, lr=0.1, rounds=ROUNDS, eval_every=ROUNDS,
                num_classes=NCLS, seed=0)
    base.update(kw)
    return base


def jax_loss(params, x, y):
    logp = jax.nn.log_softmax(x @ params["w"] + params["b"])
    return -jnp.mean(jnp.take_along_axis(logp, y[..., None], axis=-1))


def loss(params, x, y):
    logp = torch.log_softmax(x @ params["w"] + params["b"], -1)
    return -torch.mean(torch.gather(logp, -1, y.long()[..., None]))


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Ranks run as threads: one intra-op thread each keeps D ranks from
    oversubscribing the host's cores (the models here are tiny)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tparams(params):
    return {k: _t(v) for k, v in params.items()}


# JAX's side on 2 virtual devices; the federation and configs are the ones
# above (repeated: the subprocess imports nothing of the tests)
_JAX_SCRIPT = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.core import selection as jsel
    from repro.fl import engine as jengine, faults as jfaults, scenarios as jscen
    from repro.launch.mesh import make_client_mesh
    assert jax.device_count() == 2, jax.devices()
    FEAT, N_C, NCLS, C, K, ROUNDS = {FEAT}, {N_C}, {NCLS}, {C}, {K}, {ROUNDS}
    STALE, GUARD = {STALE!r}, {GUARD!r}

    def loss(p, x, y):
        logp = jax.nn.log_softmax(x @ p["w"] + p["b"])
        return -jnp.mean(jnp.take_along_axis(logp, y[..., None], axis=-1))

    rng = np.random.default_rng(0)
    xs = rng.normal(size=(C, N_C, FEAT)).astype(np.float32)
    ys = rng.integers(0, NCLS, size=(C, N_C)).astype(np.int32)
    params = {{"w": jnp.asarray((0.01 * rng.normal(size=(FEAT, NCLS))).astype(np.float32)),
               "b": jnp.zeros((NCLS,), jnp.float32)}}
    mesh = make_client_mesh(2)
    out = {{}}

    def run(tag, mesh_run, **kw):
        cfg = jengine.FLConfig(num_clients=C, clients_per_round=K, local_epochs=2, lr=0.1, rounds=ROUNDS,
                               eval_every=ROUNDS, num_classes=NCLS, seed=0, **kw)
        strategy = jsel.DPPSelection()
        state = jengine.init_server_state(cfg, params, loss, None, jnp.asarray(xs), jnp.asarray(ys),
                                          strategy=strategy, profiles=jnp.asarray(xs.mean(axis=1)),
                                          mesh=mesh if kw.get("staleness_bound") is not None else None)
        fn = jengine.make_round_fn(cfg, loss, (strategy,), mesh=mesh_run)
        final, outs = jengine.run_scanned(fn, state, ROUNDS, mesh=mesh_run)
        for k, v in outs.items():
            out[f"{{tag}}/{{k}}"] = np.asarray(v)
        for k, v in final.params.items():
            out[f"{{tag}}/params/{{k}}"] = np.asarray(v)
        out[f"{{tag}}/losses"] = np.asarray(final.losses)
        if final.algo_state is not None:
            for k, v in final.algo_state.items():
                out[f"{{tag}}/algo_state/{{k}}"] = np.asarray(v)
        if final.shard_staleness is not None:
            out[f"{{tag}}/shard_staleness"] = np.asarray(final.shard_staleness)
        if tag == "sync1":
            out["init/losses"] = np.asarray(state.losses)
        # each round's environment and fault draws, from JAX's key chain
        key, lats, draws = state.key, [], []
        model = None if cfg.faults is None else jfaults.get_fault_model(cfg.faults)
        lemons = None if model is None else jfaults.lemon_mask(model, C)
        for _ in range(ROUNDS):
            if cfg.scenario is not None:
                k_env = jax.random.fold_in(key, jengine._ENV_SALT)
                lats.append(np.asarray(jscen.get_scenario(cfg.scenario).latency(jax.random.fold_in(k_env, 0), C)))
            if model is not None:
                fk = jax.random.fold_in(key, jfaults.FAULT_SALT)
                draws.append(np.stack([np.asarray(m) for m in jfaults.draw_round_faults(fk, model, C, 2, lemons)]))
            key = jax.random.split(key, 3)[0]
        if lats:
            out[f"{{tag}}/lat"] = np.stack(lats)
        if draws:
            out[f"{{tag}}/draws"] = np.stack(draws)
            out[f"{{tag}}/lemons"] = np.asarray(lemons)

    run("sync1", None)
    run("sync2", mesh)
    run("stale2", mesh, **STALE)
    run("guard2", mesh, **GUARD)
    np.savez(sys.argv[1], **out)
""").format(FEAT=FEAT, N_C=N_C, NCLS=NCLS, C=C, K=K, ROUNDS=ROUNDS, STALE=STALE, GUARD=GUARD)


@pytest.fixture(scope="module")
def jax2(tmp_path_factory):
    """JAX's runs on 2 virtual devices (one subprocess for the module)."""
    path = tmp_path_factory.mktemp("jax2") / "jax2.npz"
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2", JAX_PLATFORMS="cpu",
               PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(path)], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(path) as f:
        return dict(f)


@functools.lru_cache(maxsize=None)
def _jax_init():
    """JAX's init (kernel, spectral cache, losses) and each round's k-DPP
    noise on its key chain, in this process."""
    xs, ys, params = _federation()
    cfg = jengine.FLConfig(**_cfg_kw())
    state = jengine.init_server_state(cfg, {k: jnp.asarray(v) for k, v in params.items()}, jax_loss, None,
                                      jnp.asarray(xs), jnp.asarray(ys), strategy=jsel.DPPSelection(),
                                      profiles=jnp.asarray(xs.mean(axis=1)))
    key, noise, lats = state.key, [], []
    for _ in range(ROUNDS):
        k_env = jax.random.fold_in(key, jengine._ENV_SALT)
        lats.append(np.asarray(jscen.get_scenario("heavy_tail").latency(jax.random.fold_in(k_env, 0), C)))
        key, k_sel, _ = jax.random.split(key, 3)
        k1, k2 = jax.random.split(k_sel)
        u, g = [], []
        for _ in range(C):
            k1, sub = jax.random.split(k1)
            u.append(np.asarray(jax.random.uniform(sub)))
        for _ in range(K):
            k2, k_i = jax.random.split(k2)
            g.append(np.asarray(jax.random.gumbel(k_i, (C,), jnp.float32)))
        noise.append((np.stack(u), np.stack(g)))
    eig = state.eig_state
    return dict(kernel=np.asarray(state.kernel), eig=(np.asarray(eig.lam), np.asarray(eig.vecs), np.asarray(eig.esp)),
                losses=np.asarray(state.losses), noise=noise, lats=lats, key=state.key)


class JaxNoiseDPP(tsel.DPPSelection):
    """FL-DP³S on JAX's k-DPP noise, round after round (one instance a rank)."""

    def __init__(self, noise):
        super().__init__()
        self.noise = list(noise)

    def draw_fn(self, generator, state, k, avail=None):
        u, g = self.noise.pop(0)
        return tdpp._sample_from_noise(_t(u), _t(g), state.eig_state, k)


class Replay(tsel.DPPSelection):
    def __init__(self, cohorts):
        super().__init__()
        self.cohorts = [np.array(c) for c in cohorts]

    def draw_fn(self, generator, state, k, avail=None):
        return torch.from_numpy(self.cohorts.pop(0))


def _replay_latencies(monkeypatch, lats):
    """The port's scenario draws replaced by JAX's, keyed by round."""

    def draw(scen, generator, t, n):
        return _t(lats[t - 1]), None

    monkeypatch.setattr(tengine, "draw_environment", draw)


def _port_run(cfg, d, strategy_of, rounds=ROUNDS):
    """``rounds`` rounds at D ranks on JAX's init -> each rank's (final
    state, outputs, all-reduce count)."""
    j = _jax_init()
    xs, ys, params = _federation()
    lam, vecs, esp = j["eig"]

    def rank(mesh):
        strat = strategy_of()
        state = tengine.init_server_state(
            cfg, _tparams(params), xs, ys, _t(xs.mean(axis=1)), _t(j["losses"]), strat, device="cpu",
            kernel=_t(j["kernel"]), eig_state=tdpp.KDPPSamplerState(lam=_t(lam), vecs=_t(vecs), esp=_t(esp)),
            mesh=mesh,
        )
        fn = tengine.make_round_fn(cfg, loss, (strat,), mesh=mesh)
        mesh.reset_counts()
        final, outs = tengine.run_scanned(fn, state, rounds)
        return final, outs, mesh.all_reduce_calls

    return tmesh.run_ranks(d, rank, "cpu")


def _close(tparams, jparams, atol=1e-5):
    for name in tparams:
        np.testing.assert_allclose(tparams[name].numpy(), np.asarray(jparams[name]), rtol=0, atol=atol, err_msg=name)


def _dist(tparams, jparams):
    return max(float(np.max(np.abs(tparams[n].numpy() - np.asarray(jparams[n])))) for n in tparams)


# ------------------------------------------------------------------ D = 1


def test_stale_d1_matches_jax_one_device_mesh(monkeypatch):
    """Bound 2 (exponential, α 0.3, heavy_tail) on one rank against JAX's
    stale round on its 1-device mesh: cohorts, counters, ``sim_time`` and
    ``staleness`` exactly, params, losses, loss and gemd within 1e-5."""
    j = _jax_init()
    xs, ys, params = _federation()
    jcfg = jengine.FLConfig(**_cfg_kw(**STALE))
    jmesh = j_make_client_mesh(1)
    strategy = jsel.DPPSelection()
    state = jengine.init_server_state(jcfg, {k: jnp.asarray(v) for k, v in params.items()}, jax_loss, None,
                                      jnp.asarray(xs), jnp.asarray(ys), strategy=strategy,
                                      profiles=jnp.asarray(xs.mean(axis=1)), mesh=jmesh)
    fn = jengine.make_round_fn(jcfg, jax_loss, (strategy,), mesh=jmesh)
    jfinal, jouts = jengine.run_scanned(fn, state, ROUNDS, mesh=jmesh)
    jouts = {k: np.asarray(v) for k, v in jouts.items()}

    _replay_latencies(monkeypatch, j["lats"])
    cfg = tengine.FLConfig(**_cfg_kw(**STALE))
    final, outs, calls = _port_run(cfg, 1, lambda: JaxNoiseDPP(j["noise"]))[0]
    assert calls == ROUNDS
    np.testing.assert_array_equal(outs["selected"].numpy(), jouts["selected"])
    np.testing.assert_array_equal(outs["staleness"].numpy(), jouts["staleness"])
    np.testing.assert_array_equal(outs["sim_time"].numpy(), jouts["sim_time"])
    np.testing.assert_array_equal(final.shard_staleness.numpy(), np.asarray(jfinal.shard_staleness))
    for name in ("loss", "gemd"):
        np.testing.assert_allclose(outs[name].numpy(), jouts[name], rtol=0, atol=1e-5)
    _close(final.params, jfinal.params)
    np.testing.assert_allclose(final.losses.numpy(), np.asarray(jfinal.losses), rtol=0, atol=1e-5)
    for name, h in final.param_hist.items():
        np.testing.assert_allclose(h.numpy(), np.asarray(jfinal.param_hist[name]), rtol=0, atol=1e-5)


# -------------------------------------------------------- bound 0 is sync


@pytest.mark.parametrize("d", [2, 4])
def test_bound0_equals_the_synchronous_port_bit_for_bit(d):
    j = _jax_init()
    sync = tengine.FLConfig(**_cfg_kw(scenario="heavy_tail"))
    stale = tengine.FLConfig(**_cfg_kw(scenario="heavy_tail", staleness_bound=0))
    a = _port_run(sync, d, lambda: JaxNoiseDPP(j["noise"]))
    b = _port_run(stale, d, lambda: JaxNoiseDPP(j["noise"]))
    for (fa, oa, ca), (fb, ob, cb) in zip(a, b):
        assert ca == cb == ROUNDS
        for name in ("selected", "loss", "gemd", "sim_time"):
            assert torch.equal(oa[name], ob[name]), name
        for name in fa.params:
            assert torch.equal(fa.params[name], fb.params[name])
        assert torch.equal(fa.losses, fb.losses)
        assert not bool(fb.shard_staleness.any()) and not bool(ob["staleness"].any())


# ---------------------------------------------- D = 2 against JAX's runs


def _plain_stale_loop(lats, cohorts):
    """Bound-2 staleness at D = 2 written out: each round, each shard's
    slowest cohort member against the deadline gives its counter; the shard
    trains its cohort members from the params of round ``t − 1 − s_d`` (the
    initial params before round 1) and weighs them by λ(s_d)·n_c."""
    xs, ys, params = _federation()
    scen = jscen.get_scenario("heavy_tail")
    bound, alpha, c_loc = STALE["staleness_bound"], STALE["staleness_alpha"], C // 2
    history = [{k: torch.from_numpy(v.astype(np.float64)) for k, v in params.items()}]
    s = np.zeros(2, np.int64)
    for t, sel in enumerate(cohorts):
        lat = lats[t].astype(np.float64)
        shard_lat = np.array([max([lat[c] for c in sel if c // c_loc == d], default=0.0) for d in range(2)])
        slow = shard_lat > scen.deadline
        bumped = np.where(slow, s + 1, 0)
        s = np.where(bumped > bound, 0, bumped)
        num = {k: torch.zeros_like(v) for k, v in history[0].items()}
        den = 0.0
        for c in sel:
            d = c // c_loc
            base = history[max(t - int(s[d]), 0)]
            p = {k: v.clone() for k, v in base.items()}
            x, y = torch.from_numpy(xs[c].astype(np.float64)), torch.from_numpy(ys[c]).long()
            for _ in range(2):  # local_epochs full-batch steps
                p = {k: v.detach().requires_grad_() for k, v in p.items()}
                logp = torch.log_softmax(x @ p["w"] + p["b"], -1)
                lval = -torch.mean(torch.gather(logp, -1, y[..., None]))
                grads = torch.autograd.grad(lval, list(p.values()))
                p = {k: (v - 0.1 * g).detach() for (k, v), g in zip(p.items(), grads)}
            wgt = np.exp(-alpha * s[d]) * N_C
            for k in num:
                num[k] += wgt * p[k]
            den += wgt
        history.append({k: v / den for k, v in num.items()})
    return history[-1]


def test_stale_d2_matches_jax_two_devices_and_a_plain_loop(monkeypatch, jax2):
    """Bound 2 at D = 2 on JAX's cohorts and latencies: JAX's counters,
    ``staleness`` and ``sim_time`` exactly, its params, losses, loss and
    gemd within 1e-5 of JAX's 2-device stale round, and the params within
    1e-5 of the plain loop (fp64) too.  The draws give real staleness."""
    j = _jax_init()
    lats = list(jax2["stale2/lat"])
    assert np.allclose(np.stack(lats), np.stack(j["lats"]))
    assert jax2["stale2/staleness"].max() > 0  # some shard went stale
    _replay_latencies(monkeypatch, lats)
    cfg = tengine.FLConfig(**_cfg_kw(**STALE))
    res = _port_run(cfg, 2, lambda: JaxNoiseDPP(j["noise"]))
    final, outs, calls = res[0]
    assert [r[2] for r in res] == [ROUNDS, ROUNDS]
    np.testing.assert_array_equal(outs["selected"].numpy(), jax2["stale2/selected"])
    np.testing.assert_array_equal(outs["staleness"].numpy(), jax2["stale2/staleness"])
    np.testing.assert_array_equal(outs["sim_time"].numpy(), jax2["stale2/sim_time"])
    np.testing.assert_array_equal(final.shard_staleness.numpy(), jax2["stale2/shard_staleness"])
    for name in ("loss", "gemd"):
        np.testing.assert_allclose(outs[name].numpy(), jax2[f"stale2/{name}"], rtol=0, atol=1e-5)
    jparams = {k: jax2[f"stale2/params/{k}"] for k in ("w", "b")}
    _close(final.params, jparams)
    np.testing.assert_allclose(torch.cat([r[0].losses for r in res]).numpy(), jax2["stale2/losses"], rtol=0, atol=1e-5)
    plain = _plain_stale_loop(lats, jax2["stale2/selected"])
    _close(final.params, {k: v.numpy() for k, v in plain.items()})


def test_sync_d2_equals_jax_single_device_not_its_two_device_result(jax2):
    """The port's synchronous round at D = 2 sits at JAX's single-device
    result (within 1e-5).  JAX's own 2-device synchronous body lands
    elsewhere on this jax (ROADMAP Queue 3): the port is at least as far
    from it as JAX's two results are from each other."""
    j = _jax_init()
    cfg = tengine.FLConfig(**_cfg_kw())
    final, outs, _ = _port_run(cfg, 2, lambda: JaxNoiseDPP(j["noise"]))[0]
    single = {k: jax2[f"sync1/params/{k}"] for k in ("w", "b")}
    two = {k: jax2[f"sync2/params/{k}"] for k in ("w", "b")}
    np.testing.assert_array_equal(outs["selected"].numpy(), jax2["sync1/selected"])
    _close(final.params, single)
    jax_gap = max(float(np.max(np.abs(single[k] - two[k]))) for k in single)
    assert _dist(final.params, two) >= jax_gap - 1e-5
    print(f"JAX 2-device synchronous vs JAX single device: {jax_gap:.3g} in params")


def _replay_faults(monkeypatch, draws, lemons):
    """The port's fault draws replaced by JAX's (D = 2 blackout lanes),
    counted per fault generator (one a rank)."""
    seen = {}

    def draw(generator, model, n, shards, lem):
        assert (n, shards) == (C, 2) and model.name == "chaos"
        np.testing.assert_array_equal(lem.numpy(), lemons)
        i = seen.get(id(generator), 0)
        seen[id(generator)] = i + 1
        return tfaults.FaultDraws(*(_t(m) for m in draws[i]))

    monkeypatch.setattr(tfaults, "lemon_mask", lambda model, n: _t(lemons))
    monkeypatch.setattr(tfaults, "draw_round_faults", draw)


@pytest.mark.parametrize("mode", ["resident", "slots", "bound0"])
def test_guard_feddyn_blackout_at_d2_matches_jax(monkeypatch, jax2, mode):
    """Chaos faults (JAX's draws, the blackout drawn per shard), trimmed
    mean and FedDyn at D = 2, on JAX's cohorts: the resident round, the
    slot round and the stale round at bound 0 against JAX's stale round at
    bound 0 on 2 devices: survivors, flags, identity rounds and the
    quarantine exactly, params, losses, FedDyn's state, loss and gemd
    within 1e-5."""
    draws, lemons = jax2["guard2/draws"], jax2["guard2/lemons"]
    assert jax2["guard2/flagged"].sum() > 0 and (jax2["guard2/survivors"] < K).any()
    _replay_faults(monkeypatch, draws, lemons)
    kw = {k: v for k, v in GUARD.items() if k != "staleness_bound"}
    if mode == "slots":
        kw["cohort_cap"] = K
    if mode == "bound0":
        kw["staleness_bound"] = 0
    cfg = tengine.FLConfig(**_cfg_kw(**kw))
    res = _port_run(cfg, 2, lambda: Replay(jax2["guard2/selected"]))
    final, outs, calls = res[0]
    assert calls == ROUNDS
    for name in ("selected", "survivors", "flagged", "identity_round", "quarantined"):
        np.testing.assert_array_equal(outs[name].numpy(), jax2[f"guard2/{name}"], err_msg=name)
    for name in ("loss", "gemd"):
        np.testing.assert_allclose(outs[name].numpy(), jax2[f"guard2/{name}"], rtol=0, atol=1e-5, err_msg=name)
    _close(final.params, {k: jax2[f"guard2/params/{k}"] for k in ("w", "b")})
    np.testing.assert_allclose(torch.cat([r[0].losses for r in res]).numpy(), jax2["guard2/losses"], rtol=0, atol=1e-5)
    for name in ("w", "b"):
        h = torch.cat([r[0].algo_state[name] for r in res]).numpy()
        np.testing.assert_allclose(h, jax2[f"guard2/algo_state/{name}"], rtol=0, atol=1e-5)


def test_stale_telemetry_counts_the_shards_at_each_lag(monkeypatch, jax2):
    j = _jax_init()
    _replay_latencies(monkeypatch, list(jax2["stale2/lat"]))
    cfg = tengine.FLConfig(**_cfg_kw(telemetry=True, **STALE))
    res = _port_run(cfg, 2, lambda: JaxNoiseDPP(j["noise"]))
    hist = res[0][1]["telemetry"].staleness_hist
    assert hist.shape == (ROUNDS, STALE["staleness_bound"] + 1) and hist.dtype == torch.int32
    assert bool((hist.sum(1) == 2).all())
    lags = (hist * torch.arange(STALE["staleness_bound"] + 1)).sum(1).float() / 2
    np.testing.assert_array_equal(lags.numpy(), jax2["stale2/staleness"])
