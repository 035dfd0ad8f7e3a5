"""The port's system-heterogeneity scenarios against the JAX package's on
the CPU: each latency family and the diurnal availability as a pure
transform of the JAX draw's own noise, the registry, and the engine's use
of them (a latency-only scenario moves no cohort; ``sim_time`` is JAX's on
the same cohort and latencies)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import selection as jsel  # noqa: E402
from repro.data import make_image_dataset, skewness_partition  # noqa: E402
from repro.fl import engine as jengine  # noqa: E402
from repro.fl import scenarios as jscen  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402

from repro_torch.core import profiles as tprof  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.fl import engine as tengine  # noqa: E402
from repro_torch.fl import scenarios as tscen  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

# the noise each family's JAX draw makes of its key
JAX_NOISE = {
    "uniform": lambda key, n: jax.random.uniform(key, (n,), jnp.float32),
    "lognormal": lambda key, n: jax.random.normal(key, (n,), jnp.float32),
    "heavy_tail": lambda key, n: jax.random.uniform(key, (n,), jnp.float32),
    "flaky": lambda key, n: jax.random.uniform(key, (n,), jnp.float32),
}


# ------------------------------------------------------------ transforms


@pytest.mark.parametrize("n", [1, 37, 1000])
@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("name", ["uniform", "lognormal", "heavy_tail", "flaky"])
def test_latency_transform_on_jax_noise(name, seed, n):
    """Each family on JAX's noise: within 1 ulp of fp32 (``exp`` and ``pow``
    in two libraries; the uniform family's multiply-add may fuse)."""
    key = jax.random.key(seed)
    want = np.asarray(jscen.get_scenario(name).latency(key, n))
    noise = torch.from_numpy(np.array(JAX_NOISE[name](key, n)))
    got = tscen.get_scenario(name).latency.transform(noise)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)


@pytest.mark.parametrize("n", [5, 64, 1000])
@pytest.mark.parametrize("t", [0, 1, 7, 30])
def test_diurnal_availability_on_jax_noise(t, n):
    """The flaky scenario's mask on JAX's uniforms, exactly: ``u < p`` with
    p within an ulp of JAX's, and no u of these draws that close to p."""
    key = jax.random.fold_in(jax.random.key(t), n)
    want = np.asarray(jscen.get_scenario("flaky").availability(key, t, n))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (n,), jnp.float32)))
    got = tscen.get_scenario("flaky").availability.transform(u, t)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < n or n < 10  # the mask is not trivial


@pytest.mark.parametrize("name", ["uniform", "lognormal", "heavy_tail", "flaky"])
def test_draw_is_the_transform_of_its_noise(name):
    scen = tscen.get_scenario(name)
    a, b = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    lat = scen.latency(a, 50)
    np.testing.assert_array_equal(lat.numpy(), scen.latency.transform(scen.latency.noise(b, 50)).numpy())
    assert bool((lat > 0).all())
    if name == "uniform":
        assert bool((lat >= 0.8).all() and (lat < 1.2).all())
    if scen.availability is not None:
        mask = scen.availability(a, 50, 4)
        want = scen.availability.transform(scen.availability.noise(b, 50), 4)
        np.testing.assert_array_equal(mask.numpy(), want.numpy())


# -------------------------------------------------------------- registry


def test_registry_matches_jax():
    assert tscen.SCENARIO_NAMES == jscen.SCENARIO_NAMES
    for name in tscen.SCENARIO_NAMES:
        t, j = tscen.get_scenario(name), jscen.get_scenario(name)
        assert t.name == j.name == name and t.deadline == j.deadline
        assert (t.availability is None) == (j.availability is None)


@pytest.mark.parametrize("bad", ["diurnal", "", "Flaky"])
def test_get_scenario_unknown_name_lists_known(bad):
    with pytest.raises(ValueError, match="known: .*flaky.*heavy_tail"):
        tscen.get_scenario(bad)
    with pytest.raises(ValueError, match="unknown scenario"):
        tengine.FLConfig(scenario=bad)


# ---------------------------------------------------------- in the engine


C, K, N_C = 8, 3, 6


def _federation():
    ds = make_image_dataset(n=C * N_C, seed=2)
    shards = skewness_partition(ds.ys, C, 0.8, 10, samples_per_client=N_C, seed=0)
    cxs = np.stack([ds.xs[s] for s in shards])
    cys = np.stack([ds.ys[s] for s in shards])
    jparams = jcnn.init_cnn(jax.random.key(0), channels=(4, 8), fc1_dim=16)
    return cxs, cys, jparams


def _port_state(cfg, cxs, cys, jparams, strategy):
    params = tcnn.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    xs = torch.from_numpy(cxs)
    profiles = tprof.profile_all_clients(tcnn.apply_with_features, params, list(xs))
    losses = torch.stack([tcnn.cnn_loss(params, x, torch.from_numpy(y)) for x, y in zip(xs, cys)])
    return tengine.init_server_state(
        cfg, params, cxs, cys, profiles, losses.detach(), strategy, device="cpu", loss_fn=tcnn.cnn_loss,
    )


@pytest.mark.parametrize("scenario", ["uniform", "lognormal", "heavy_tail"])
@pytest.mark.parametrize("name", ["fl-dp3s", "fedavg", "fedsae", "cluster"])
def test_latency_only_scenario_leaves_cohorts_unchanged(name, scenario):
    """Three rounds with and without a latency-only scenario: the same
    cohorts, parameters and losses bit for bit (its draws come from a
    generator of their own); only ``sim_time`` is added."""
    cxs, cys, jparams = _federation()
    runs = []
    for scen in (None, scenario):
        cfg = tengine.FLConfig(num_clients=C, clients_per_round=K, local_epochs=1, local_batch_size=3,
                               lr=0.05, eval_every=2, seed=1, scenario=scen)
        strat = tsel.make_strategy(name)
        state = _port_state(cfg, cxs, cys, jparams, strat)
        fn = tengine.make_round_fn(cfg, tcnn.cnn_loss, (strat,), accuracy_fn=tcnn.accuracy)
        runs.append(tengine.run_scanned(fn, state, 3))
    (s0, o0), (s1, o1) = runs
    for key in ("selected", "loss", "gemd", "acc"):
        np.testing.assert_array_equal(o0[key].numpy(), o1[key].numpy(), err_msg=key)
    np.testing.assert_array_equal(s0.losses.numpy(), s1.losses.numpy())
    for pname in s0.params:
        np.testing.assert_array_equal(s0.params[pname].numpy(), s1.params[pname].numpy())
    assert "sim_time" not in o0 and "avail" not in o1
    assert o1["sim_time"].shape == (3,) and bool((o1["sim_time"] > 0).all())


@pytest.mark.parametrize("scenario", ["heavy_tail", "flaky"])
def test_sim_time_matches_jax_on_the_same_cohort_and_latencies(monkeypatch, scenario):
    """Four rounds of JAX's ``run_scanned`` under the scenario; the port's
    round on JAX's cohorts and environment draws (the key's salted branch
    replayed) gives JAX's ``sim_time`` exactly (a max of the same floats)
    and its ``avail``."""
    cxs, cys, jparams = _federation()
    rounds = 4
    kw = dict(num_clients=C, clients_per_round=K, local_epochs=1, lr=0.05, eval_every=2,
              seed=0, scenario=scenario)
    jstrat = jsel.DPPSelection()
    jstate = jengine.init_server_state(jengine.FLConfig(**kw), jparams, jcnn.cnn_loss,
                                       jcnn.apply_with_features, cxs, cys, strategy=jstrat)
    jfn = jengine.make_round_fn(jengine.FLConfig(**kw), jcnn.cnn_loss, (jstrat,))
    _, jouts = jengine.run_scanned(jfn, jstate, rounds)

    # the environment draws of each round, from the key the round starts with
    scen = jscen.get_scenario(scenario)
    key, env = jax.random.key(0), []
    for t in range(1, rounds + 1):
        k_env = jax.random.fold_in(key, jengine._ENV_SALT)
        lat = np.array(scen.latency(jax.random.fold_in(k_env, 0), C))
        avail = None
        if scen.availability is not None:
            avail = np.array(scen.availability(jax.random.fold_in(k_env, 1), t, C))
        env.append((lat, avail))
        key = jax.random.split(key, 3)[0]
    queue = list(env)

    def replay_env(scen_, generator, t, n):
        lat, avail = queue.pop(0)
        return torch.from_numpy(lat), None if avail is None else torch.from_numpy(avail)

    monkeypatch.setattr(tengine, "draw_environment", replay_env)
    cohorts = [np.array(c) for c in jouts["selected"]]

    class Replay(tsel.DPPSelection):
        def draw_fn(self, generator, state, k, avail=None):
            sel = cohorts.pop(0)
            if avail is not None and int(avail.sum()) >= k:
                assert bool(avail[torch.from_numpy(sel).long()].all())
            return torch.from_numpy(sel)

    strat = Replay()
    cfg = tengine.FLConfig(**kw)
    state = _port_state(cfg, cxs, cys, jparams, strat)
    fn = tengine.make_round_fn(cfg, tcnn.cnn_loss, (strat,))
    _, outs = tengine.run_scanned(fn, state, rounds)
    assert not queue and not cohorts
    np.testing.assert_array_equal(outs["selected"].numpy(), np.asarray(jouts["selected"]))
    np.testing.assert_array_equal(outs["sim_time"].numpy(), np.asarray(jouts["sim_time"]))
    if scenario == "flaky":
        np.testing.assert_array_equal(outs["avail"].numpy(), np.asarray(jouts["avail"]))
    else:
        assert "avail" not in outs and "avail" not in jouts
    # the rest of the round on the same cohorts: fp32 sums in another order
    np.testing.assert_allclose(outs["loss"].numpy(), np.asarray(jouts["loss"]), atol=1e-5)
    np.testing.assert_allclose(outs["gemd"].numpy(), np.asarray(jouts["gemd"]), atol=1e-6)
