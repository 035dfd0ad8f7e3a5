"""The port's local-update algorithms (FedAvg, FedProx, FedDyn) against the
JAX package's, on the CPU.

The registry and ``FLConfig``'s validation of the algorithm fields as
JAX's; one client's local update under each algorithm (with and without a
gradient clip) within 1e-6 of JAX's on the same numpy inputs; the
``prox_mu = 0`` reduction to FedAvg bit for bit; then the single-device
cases of JAX's ``tests/test_local_algos.py`` on the port's engine, and a
FedDyn run of the engine against JAX's ``run_scanned`` on JAX's cohorts."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import selection as jsel  # noqa: E402
from repro.fl import engine as jengine  # noqa: E402
from repro.fl import local_algos as jalgos  # noqa: E402
from repro.fl import rounds as jrounds  # noqa: E402

from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.fl import engine as tengine  # noqa: E402
from repro_torch.fl import faults as tfaults  # noqa: E402
from repro_torch.fl import local_algos as talgos  # noqa: E402
from repro_torch.fl import rounds as trounds  # noqa: E402
from repro_torch.fl import scenarios as tscen  # noqa: E402
from repro_torch.fl import trainer as ttrainer  # noqa: E402

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


def _t(tree):
    return {n: torch.from_numpy(np.array(v)) for n, v in tree.items()}


def _state_and_cfg(c, k, strategy, rounds=8, **cfg_kw):
    xs, ys, params = _federation(c)
    cfg = tengine.FLConfig(num_clients=c, clients_per_round=k, local_epochs=2, lr=0.1, rounds=rounds,
                           eval_every=2, num_classes=NCLS, seed=0, **cfg_kw)
    params = _t(params)
    losses = torch.stack([linear_loss(params, torch.from_numpy(x), torch.from_numpy(y)) for x, y in zip(xs, ys)])
    state = tengine.init_server_state(cfg, params, xs, ys, torch.from_numpy(xs.mean(axis=1)), losses, strategy,
                                      device="cpu")
    return cfg, state


def _run(cfg, state, rounds):
    fn = tengine.make_round_fn(cfg, linear_loss, (tsel.UniformSelection(),))
    return tengine.run_scanned(fn, state, rounds)


def _max_param_diff(a, b):
    return max(float(torch.max(torch.abs(a[n].float() - b[n].float()))) for n in a)


def _h_norm(algo_state):
    return sum(torch.abs(v).sum(dim=tuple(range(1, v.ndim))) for v in algo_state.values())


# ------------------------------------------------------------ registry


def test_unknown_local_algo_lists_known():
    with pytest.raises(ValueError) as e:
        talgos.get_local_algo("nope")
    assert all(name in str(e.value) for name in talgos.ALGO_NAMES)


def test_registry_error_shape_uniform():
    """The selection, scenario, fault and local-algorithm registries raise
    one ``ValueError`` shape: ``unknown <what> '<name>'; known: [...]``."""
    for fn in (lambda: tsel.make_strategy("nope"), lambda: tscen.get_scenario("nope"),
               lambda: tfaults.get_fault_model("nope"), lambda: talgos.get_local_algo("nope")):
        with pytest.raises(ValueError, match=r"unknown .*'nope'; known: \["):
            fn()


def test_all_algo_names_resolve():
    assert talgos.ALGO_NAMES == jalgos.ALGO_NAMES == tuple(sorted(talgos.LOCAL_ALGOS))
    for name in talgos.ALGO_NAMES:
        a = talgos.get_local_algo(name)
        assert a.name == name and a.stateful == jalgos.get_local_algo(name).stateful
    assert [talgos.get_local_algo(n).stateful for n in ("fedavg", "fedprox", "feddyn")] == [False, False, True]
    assert talgos.algo_from_config("fedprox", prox_mu=0.3).prox_mu == 0.3
    assert talgos.algo_from_config("feddyn").feddyn_alpha == 0.01  # the constructor's default


@pytest.mark.parametrize("bad", [
    lambda: talgos.FedProx(prox_mu=-0.1),
    lambda: talgos.FedDyn(feddyn_alpha=0.0),
    lambda: talgos.FedDyn(feddyn_alpha=-1.0),
])
def test_algo_hyperparam_validation(bad):
    with pytest.raises(ValueError):
        bad()


@pytest.mark.parametrize("bad_kw", [
    dict(local_algo="nope"),
    dict(local_algo="fedavg", prox_mu=0.01),
    dict(local_algo="fedavg", feddyn_alpha=0.01),
    dict(local_algo="fedprox", feddyn_alpha=0.01),
    dict(local_algo="fedprox", prox_mu=-0.5),
    dict(local_algo="feddyn", prox_mu=0.01),
    dict(local_algo="feddyn", feddyn_alpha=0.0),
])
def test_flconfig_validates_algo_combos(bad_kw):
    kw = dict(num_clients=8, clients_per_round=4, local_epochs=1, lr=0.1, rounds=2, eval_every=1,
              num_classes=NCLS, seed=0, **bad_kw)
    with pytest.raises(ValueError):
        jengine.FLConfig(**kw)
    with pytest.raises(ValueError):
        tengine.FLConfig(**kw)


def test_init_client_states():
    params = _t(_federation(2)[2])
    assert talgos.init_client_states(talgos.FedAvg(), params, 5) is None
    assert talgos.init_client_states(talgos.FedProx(0.1), params, 5) is None
    st = talgos.init_client_states(talgos.FedDyn(0.1), params, 5)
    for n, p in params.items():
        assert st[n].shape == (5,) + p.shape and st[n].dtype == torch.float32 and not st[n].any()


# ------------------------------------------------------- local updates


def _local_inputs(seed):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(FEAT, NCLS)).astype(np.float32), "b": rng.normal(size=(NCLS,)).astype(np.float32)}
    x = rng.normal(size=(3, 5, FEAT)).astype(np.float32)
    y = rng.integers(0, NCLS, size=(3, 5)).astype(np.int32)
    h = {n: (0.1 * rng.normal(size=v.shape)).astype(np.float32) for n, v in params.items()}
    return params, x, y, h


def _torch_local(algo, seed, grad_clip=None):
    params, x, y, h = _local_inputs(seed)
    upd = trounds.build_local_algo_update(algo, lambda p, b: linear_loss(p, b[0], b[1]), 0.07, grad_clip=grad_clip)
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    if algo is not None and algo.stateful:
        return upd(_t(params), _t(h), batch)
    return upd(_t(params), batch)


@pytest.mark.parametrize("grad_clip", [None, 0.5])
@pytest.mark.parametrize("name,kw", [("fedavg", {}), ("fedprox", {"prox_mu": 0.3}), ("feddyn", {"feddyn_alpha": 0.2})])
def test_local_update_matches_jax(name, kw, grad_clip):
    """Three local steps from random params (FedDyn from a nonzero ``h``):
    params, per-step losses and the new state within 1e-6 of JAX's."""
    params, x, y, h = _local_inputs(4)
    jalgo = jalgos.get_local_algo(name, **kw)
    jupd = jrounds.build_local_algo_update(jalgo, lambda p, b: j_linear_loss(p, b[0], b[1]), 0.07, grad_clip=grad_clip)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jout = jupd(jp, jax.tree_util.tree_map(jnp.asarray, h), (x, y)) if jalgo.stateful else jupd(jp, (x, y))
    tout = _torch_local(talgos.get_local_algo(name, **kw), 4, grad_clip)
    assert len(tout) == len(jout)
    for t_tree, j_tree in zip(tout[:-1], jout[:-1]):
        for n in params:
            np.testing.assert_allclose(t_tree[n].numpy(), np.asarray(j_tree[n]), rtol=0, atol=1e-6, err_msg=n)
    np.testing.assert_allclose(tout[-1].numpy(), np.asarray(jout[-1]), rtol=0, atol=1e-6)
    # one bound step, the registry's other entry point
    bound, jbound = talgos.get_local_algo(name, **kw).bind(
        lambda p, b: linear_loss(p, b[0], b[1]), 0.07, grad_clip), jalgo.bind(
        lambda p, b: j_linear_loss(p, b[0], b[1]), 0.07, grad_clip)
    state = _t(h) if bound.stateful else ()
    p1, s1, l1 = bound.step(_t(params), state, _t(params), (torch.from_numpy(x[0]), torch.from_numpy(y[0])))
    jp1, _, jl1 = jbound.step(jp, jax.tree_util.tree_map(jnp.asarray, h) if jbound.stateful else (), jp, (x[0], y[0]))
    assert s1 is state and bound.name == name
    for n in params:
        np.testing.assert_allclose(p1[n].numpy(), np.asarray(jp1[n]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(l1), float(jl1), rtol=0, atol=1e-6)


def test_fedavg_transform_grad_is_the_same_object():
    g = {"w": torch.ones(2)}
    assert talgos.FedAvg().transform_grad(g, g, (), g) is g
    assert talgos.FedProx(prox_mu=0.0).transform_grad(g, g, (), g) is g


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fedprox_zero_mu_is_fedavg_local_update(seed):
    p_avg, l_avg = _torch_local(talgos.FedAvg(), seed)
    p_prx, l_prx = _torch_local(talgos.FedProx(prox_mu=0.0), seed)
    p_old, l_old = trounds.build_local_update(lambda p, b: linear_loss(p, b[0], b[1]), 0.07)(
        _t(_local_inputs(seed)[0]), tuple(torch.from_numpy(a) for a in _local_inputs(seed)[1:3]))
    for n in p_avg:
        assert torch.equal(p_avg[n], p_prx[n]) and torch.equal(p_avg[n], p_old[n])
    assert torch.equal(l_avg, l_prx) and torch.equal(l_avg, l_old)


# ------------------------------------------------------------- engine


def test_fedprox_zero_mu_engine_history_bit_identical():
    cfg_a, s_a = _state_and_cfg(12, 4, tsel.UniformSelection())
    cfg_p, s_p = _state_and_cfg(12, 4, tsel.UniformSelection(), local_algo="fedprox", prox_mu=0.0)
    f_a, o_a = _run(cfg_a, s_a, 6)
    f_p, o_p = _run(cfg_p, s_p, 6)
    assert torch.equal(o_a["selected"], o_p["selected"]) and torch.equal(o_a["loss"], o_p["loss"])
    assert _max_param_diff(f_a.params, f_p.params) == 0.0 and torch.equal(f_a.losses, f_p.losses)


@pytest.mark.parametrize("name,kw", [("fedprox", dict(prox_mu=1.0)), ("feddyn", dict(feddyn_alpha=0.5))])
def test_algorithm_changes_trajectory_not_cohorts(name, kw):
    cfg_a, s_a = _state_and_cfg(12, 4, tsel.UniformSelection())
    cfg_p, s_p = _state_and_cfg(12, 4, tsel.UniformSelection(), local_algo=name, **kw)
    f_a, o_a = _run(cfg_a, s_a, 6)
    f_p, o_p = _run(cfg_p, s_p, 6)
    # same cohorts (selection does not depend on the algorithm), other params
    assert torch.equal(o_a["selected"], o_p["selected"]) and _max_param_diff(f_a.params, f_p.params) > 0.0


def test_feddyn_state_lives_in_server_state():
    c = 12
    cfg, state = _state_and_cfg(c, 4, tsel.UniformSelection(), local_algo="feddyn", feddyn_alpha=0.1)
    assert state.algo_state is not None and state.quarantine is None
    for n, p in state.params.items():
        h = state.algo_state[n]
        assert h.shape == (c,) + p.shape and h.dtype == torch.float32 and float(h.abs().sum()) == 0.0


def test_feddyn_state_updates_only_selected_clients():
    c = 12
    cfg, state = _state_and_cfg(c, 4, tsel.UniformSelection(), local_algo="feddyn", feddyn_alpha=0.1)
    fin, outs = _run(cfg, state, 1)
    sel = set(outs["selected"].ravel().tolist())
    h = _h_norm(fin.algo_state)
    for ci in range(c):
        assert (h[ci] > 0) == (ci in sel), ci
    # the state a round was given is left as it was
    assert float(_h_norm(state.algo_state).sum()) == 0.0


def test_feddyn_checkpoint_roundtrip_bit_parity(tmp_path):
    cfg, state = _state_and_cfg(10, 4, tsel.UniformSelection(), local_algo="feddyn", feddyn_alpha=0.1)
    fn = tengine.make_round_fn(cfg, linear_loss, (tsel.UniformSelection(),))
    full, outs_full = tengine.run_scanned(fn, state.fork(), 6)
    half, _ = tengine.run_scanned(fn, state.fork(), 3)
    tengine.save_server_state(str(tmp_path), half)
    restored = tengine.restore_server_state(str(tmp_path), state)
    assert _max_param_diff(half.algo_state, restored.algo_state) == 0.0
    resumed, outs_tail = tengine.run_scanned(fn, restored, 3)
    assert _max_param_diff(full.params, resumed.params) == 0.0
    assert _max_param_diff(full.algo_state, resumed.algo_state) == 0.0
    assert resumed.round == 6 and torch.equal(outs_full["selected"][3:], outs_tail["selected"])


def test_feddyn_guarded_state_only_for_kept_updates():
    """Under the guard a client's ``h`` advances only in a round it was
    selected, delivered and not flagged, and the round kept its aggregate."""
    c, k = 12, 6
    cfg, state = _state_and_cfg(c, k, tsel.UniformSelection(), local_algo="feddyn", feddyn_alpha=0.1,
                                faults="corrupt", aggregator="trimmed_mean")
    fn = tengine.make_round_fn(cfg, linear_loss, (tsel.UniformSelection(),))
    real = tfaults.draw_round_faults
    draws = []
    tfaults.draw_round_faults = lambda *a: draws.append(real(*a)) or draws[-1]
    try:
        fin, outs = tengine.run_scanned(fn, state, 4)
    finally:
        tfaults.draw_round_faults = real
    assert all(bool(torch.isfinite(v).all()) for v in fin.algo_state.values())
    h = _h_norm(fin.algo_state)
    sel = set(outs["selected"].ravel().tolist())
    kept = set()
    for d, s in zip(draws, outs["selected"]):
        kept |= {int(i) for i in s if d.delivered[i] and not (d.nan[i] or d.garbage[i])}
    assert any(d.nan.any() or d.garbage.any() for d in draws)
    for ci in range(c):
        if h[ci] > 0:
            assert ci in sel and ci in kept, ci


def test_feddyn_engine_matches_jax():
    """Four FedDyn rounds of the linear model through each engine on JAX's
    cohorts: per-round losses, the last-known losses, the params and every
    client's ``h`` within 1e-6."""
    c, k, rounds = 10, 4, 4
    xs, ys, params = _federation(c)
    kw = dict(num_clients=c, clients_per_round=k, local_epochs=2, lr=0.1, rounds=rounds, eval_every=2,
              num_classes=NCLS, seed=0, local_algo="feddyn", feddyn_alpha=0.2)
    jcfg = jengine.FLConfig(**kw)
    jstrat = jsel.UniformSelection()
    jstate = jengine.init_server_state(jcfg, jax.tree_util.tree_map(jnp.asarray, params), j_linear_loss, None,
                                       xs, ys, strategy=jstrat, profiles=jnp.asarray(xs.mean(axis=1)))
    jfin, jouts = jengine.run_scanned(jengine.make_round_fn(jcfg, j_linear_loss, (jstrat,)), jstate, rounds)
    cohorts = [np.array(s) for s in np.asarray(jouts["selected"])]

    class Replay(tsel.UniformSelection):
        def draw_fn(self, generator, state, k_, avail=None):
            return torch.from_numpy(cohorts.pop(0))

    cfg = tengine.FLConfig(**kw)
    state = tengine.init_server_state(cfg, _t(params), xs, ys, torch.from_numpy(xs.mean(axis=1)),
                                      torch.from_numpy(np.array(jstate.losses)), Replay(), device="cpu")
    fin, outs = tengine.run_scanned(tengine.make_round_fn(cfg, linear_loss, (Replay(),)), state, rounds)
    assert not cohorts
    np.testing.assert_allclose(outs["loss"].numpy(), np.asarray(jouts["loss"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(fin.losses.numpy(), np.asarray(jfin.losses), rtol=0, atol=1e-6)
    for n in params:
        np.testing.assert_allclose(fin.params[n].numpy(), np.asarray(jfin.params[n]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(fin.algo_state[n].numpy(), np.asarray(jfin.algo_state[n]), rtol=0, atol=1e-6)


# ------------------------------------------------------------- trainer


def test_legacy_only_strategy_refuses_faults_and_algorithms():
    """A strategy that overrides only ``select`` runs the legacy loop, which
    has no guard and runs plain SGD: faults, a robust aggregator and a
    non-FedAvg algorithm raise JAX's ``ValueError``s."""

    class HostOnly(tsel.SelectionStrategy):
        name = "host-only"

        def select(self, generator, state, k):
            return torch.arange(k, dtype=torch.int32)

    xs, ys, params = _federation(6)
    feature_fn = lambda p, x: (x @ p["w"] + p["b"], x)
    for kw, match in ((dict(faults="dropout"), "fault-injection"), (dict(aggregator="trimmed_mean"), "quarantine"),
                      (dict(local_algo="fedprox"), "hardwired to plain SGD")):
        cfg = tengine.FLConfig(num_clients=6, clients_per_round=2, local_epochs=1, rounds=1, **kw)
        tr = ttrainer.FLTrainer(cfg, _t(params), linear_loss, feature_fn, xs, ys, HostOnly(), device="cpu")
        with pytest.raises(ValueError, match=match):
            tr.run()


def test_trainer_keeps_fault_stream_and_starts_states_at_zero():
    """``FLTrainer.run`` through the engine under faults and FedDyn: the
    trainer's fault generator is the state's and advances across calls; a
    call starts quarantine and ``h`` at zero."""
    xs, ys, params = _federation(8)
    feature_fn = lambda p, x: (x @ p["w"] + p["b"], x)
    cfg = tengine.FLConfig(num_clients=8, clients_per_round=3, local_epochs=1, lr=0.1, rounds=2, eval_every=1,
                           faults="corrupt", aggregator="trimmed_mean", local_algo="feddyn", feddyn_alpha=0.1)
    tr = ttrainer.FLTrainer(cfg, _t(params), linear_loss, feature_fn, xs, ys, tsel.make_strategy("fl-dp3s"),
                            device="cpu")
    before = tr.fault_generator.get_state()
    st = tr.server_state()
    assert st.fault_generator is tr.fault_generator and not st.quarantine.any()
    assert float(_h_norm(st.algo_state).sum()) == 0.0
    tr.run()
    assert not torch.equal(tr.fault_generator.get_state(), before)
    mid = tr.fault_generator.get_state()
    hist = tr.run(rounds=1)
    assert hist["round"] == [1, 2, 3] and not torch.equal(tr.fault_generator.get_state(), mid)
    assert dataclasses.replace(tr.server_state()).quarantine.sum() == 0
