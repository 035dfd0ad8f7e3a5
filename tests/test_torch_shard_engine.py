"""The port's client-sharded engine on the CPU: D gloo ranks in threads of
one process (``launch/mesh.run_ranks``), against the JAX package's
single-device engine.

The synchronous (resident) and capacity-slot rounds at D ∈ {1, 2, 4} on
JAX's k-DPP noise give JAX's cohorts bit for bit, its params, losses,
``loss``, ``gemd`` and accuracy within 1e-5 (JAX's own bound for its
sharded engine), and one all-reduce a round.  JAX's own mesh paths at
D > 1 are not used as a reference here: on this jax their synchronous and
slot bodies part from its single-device engine (ROADMAP Queue 3);
``tests/test_torch_stale_engine.py`` holds the port against the parts of
the reference that hold.  Beside them: the NaN convention for non-cohort
residents, the funnel's shard-local block, the trainer across reprofile
and funnel boundaries, ``run_many``, a sharded crash-resume bit for bit,
the mesh's own contract and the launcher's flags."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import selection as jsel  # noqa: E402
from repro.fl import engine as jengine  # noqa: E402
from repro.fl import rounds as jrounds  # noqa: E402
from repro.launch.mesh import make_client_mesh as j_make_client_mesh  # noqa: E402

from repro_torch.core import dpp as tdpp  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.fl import engine as tengine  # noqa: E402
from repro_torch.fl import rounds as trounds  # noqa: E402
from repro_torch.fl.trainer import FLTrainer  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

FEAT, N_C, NCLS = 8, 6, 4
C, K, ROUNDS = 8, 3, 6


# ------------------------------------------------------------ the federation


def jax_loss(params, x, y):
    logp = jax.nn.log_softmax(x @ params["w"] + params["b"])
    return -jnp.mean(jnp.take_along_axis(logp, y[..., None], axis=-1))


def jax_accuracy(params, x, y):
    return jnp.mean(jnp.argmax(x @ params["w"] + params["b"], -1) == y)


def loss(params, x, y):
    logp = torch.log_softmax(x @ params["w"] + params["b"], -1)
    return -torch.mean(torch.gather(logp, -1, y.long()[..., None]))


def accuracy(params, x, y):
    return torch.mean((torch.argmax(x @ params["w"] + params["b"], -1) == y).float())


def features(params, x):
    h = x @ params["w"] + params["b"]
    return h, h


def _federation(c=C, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(c, N_C, FEAT)).astype(np.float32)
    ys = rng.integers(0, NCLS, size=(c, N_C)).astype(np.int32)
    params = {"w": (0.01 * rng.normal(size=(FEAT, NCLS))).astype(np.float32), "b": np.zeros((NCLS,), np.float32)}
    return xs, ys, params


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


def _cfg_kw(**kw):
    base = dict(num_clients=C, clients_per_round=K, local_epochs=2, lr=0.1, rounds=ROUNDS, eval_every=2,
                num_classes=NCLS, seed=0)
    base.update(kw)
    return base


def _jax_kdpp_noise(key, n, k):
    """JAX's draws inside its k-DPP sampler (``dpp._sample_from_state``)."""
    key1, key2 = jax.random.split(key)
    uniforms, gumbels = [], []
    for _ in range(n):
        key1, sub = jax.random.split(key1)
        uniforms.append(np.asarray(jax.random.uniform(sub)))
    for _ in range(k):
        key2, k_i = jax.random.split(key2)
        gumbels.append(np.asarray(jax.random.gumbel(k_i, (n,), jnp.float32)))
    return np.stack(uniforms), np.stack(gumbels)


class JaxNoiseDPP(tsel.DPPSelection):
    """FL-DP³S drawing on JAX's k-DPP noise, round after round (one instance
    a rank)."""

    def __init__(self, noise):
        super().__init__()
        self.noise = list(noise)

    def draw_fn(self, generator, state, k, avail=None):
        assert avail is None
        u, g = self.noise.pop(0)
        return tdpp._sample_from_noise(_t(u), _t(g), state.eig_state, k)


class Replay(tsel.DPPSelection):
    """Hands out given cohorts in order (one instance a rank)."""

    def __init__(self, cohorts, reads=False):
        super().__init__()
        self.cohorts = [np.array(c) for c in cohorts]
        self.reads_client_stats = reads

    def draw_fn(self, generator, state, k, avail=None):
        return torch.from_numpy(self.cohorts.pop(0))


@functools.lru_cache(maxsize=None)
def _jax_single(strat_name, rounds=ROUNDS, **kw):
    """JAX's single-device ``run_scanned`` (accuracy every 2 rounds) ->
    outputs, final params and losses, the init kernel and spectral cache,
    and each round's k-DPP noise."""
    xs, ys, params = _federation()
    strategy = jsel.make_strategy(strat_name)
    cfg = jengine.FLConfig(**_cfg_kw(**kw))
    state = jengine.init_server_state(cfg, {k: jnp.asarray(v) for k, v in params.items()}, jax_loss, None,
                                      jnp.asarray(xs), jnp.asarray(ys), strategy=strategy,
                                      profiles=jnp.asarray(xs.mean(axis=1)))
    fn = jengine.make_round_fn(cfg, jax_loss, (strategy,), accuracy_fn=jax_accuracy)
    final, outs = jengine.run_scanned(fn, state, rounds)
    key, noise = state.key, []
    for _ in range(rounds):
        key, k_sel, _ = jax.random.split(key, 3)
        noise.append(_jax_kdpp_noise(k_sel, C, K))
    eig = state.eig_state
    return dict(
        outs={k: np.asarray(v) for k, v in outs.items()},
        params={k: np.asarray(v) for k, v in final.params.items()},
        losses=np.asarray(final.losses), kernel=np.asarray(state.kernel),
        eig=(np.asarray(eig.lam), np.asarray(eig.vecs), np.asarray(eig.esp)),
        init_losses=np.asarray(state.losses), noise=noise,
    )


def _port_state(cfg, j, strategy, mesh=None):
    """The port's init on JAX's kernel, spectral cache and initial losses."""
    xs, ys, params = _federation()
    lam, vecs, esp = j["eig"]
    return tengine.init_server_state(
        cfg, _tparams(params), xs, ys, _t(xs.mean(axis=1)), _t(j["init_losses"]), strategy, device="cpu",
        kernel=_t(j["kernel"]), eig_state=tdpp.KDPPSamplerState(lam=_t(lam), vecs=_t(vecs), esp=_t(esp)),
        mesh=mesh,
    )


def _gather_losses(results):
    """The ranks' resident losses, in rank order -> (C,)."""
    return torch.cat([r[0].losses for r in results])


# ----------------------------------------------- parity with JAX's engine


@pytest.mark.parametrize("cap", [None, 3])
@pytest.mark.parametrize("d", [1, 2, 4])
def test_sharded_rounds_match_jax_single_device(d, cap):
    """Resident and slot rounds at D ranks on JAX's k-DPP noise: JAX's
    cohorts bit for bit, params, losses, loss, gemd and accuracy within
    1e-5, every rank's params the same, and one all-reduce a round (one
    more on each eval round, for the union training set's accuracy)."""
    j = _jax_single("fl-dp3s")
    cfg = tengine.FLConfig(**_cfg_kw(cohort_cap=cap))

    def rank(mesh):
        strat = JaxNoiseDPP(j["noise"])
        state = _port_state(cfg, j, strat, mesh)
        fn = tengine.make_round_fn(cfg, loss, (strat,), accuracy_fn=accuracy, mesh=mesh)
        mesh.reset_counts()
        final, outs = tengine.run_scanned(fn, state, ROUNDS)
        return final, outs, mesh.all_reduce_calls

    res = tmesh.run_ranks(d, rank, "cpu")
    final, outs, _ = res[0]
    assert [r[2] for r in res] == [ROUNDS + ROUNDS // 2] * d
    np.testing.assert_array_equal(outs["selected"].numpy(), j["outs"]["selected"])
    for name in ("loss", "gemd", "acc"):
        np.testing.assert_allclose(outs[name].numpy(), j["outs"][name], rtol=0, atol=1e-5, err_msg=name)
    for name, w in j["params"].items():
        np.testing.assert_allclose(final.params[name].numpy(), w, rtol=0, atol=1e-5, err_msg=name)
        for other in res[1:]:
            assert torch.equal(other[0].params[name], final.params[name])
    np.testing.assert_allclose(_gather_losses(res).numpy(), j["losses"], rtol=0, atol=1e-5)
    assert final.shard_count == d and final.losses.shape == (C // d,)


@pytest.mark.parametrize("d", [2, 4])
def test_one_all_reduce_a_round_and_fedavg_on_jax_cohorts(d):
    """Without accuracy the counter reads exactly one all-reduce a round;
    FedAvg on JAX's cohorts matches JAX within 1e-5."""
    j = _jax_single("fedavg")
    cfg = tengine.FLConfig(**_cfg_kw())

    def rank(mesh):
        strat = Replay(j["outs"]["selected"])
        state = _port_state(cfg, j, strat, mesh)
        fn = tengine.make_round_fn(cfg, loss, (strat,), mesh=mesh)
        counts = []
        for _ in range(ROUNDS):
            before = mesh.all_reduce_calls
            state, _ = fn(state)
            counts.append(mesh.all_reduce_calls - before)
        return state, counts

    res = tmesh.run_ranks(d, rank, "cpu")
    assert all(r[1] == [1] * ROUNDS for r in res)
    for name, w in j["params"].items():
        np.testing.assert_allclose(res[0][0].params[name].numpy(), w, rtol=0, atol=1e-5)
    np.testing.assert_allclose(torch.cat([r[0].losses for r in res]).numpy(), j["losses"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("cap", [None, 3])
def test_minibatch_plans_and_loss_reading_strategies_match_the_unsharded_port(cap):
    """Minibatch permutations (the cohort's plans drawn as the single-device
    engine draws them) and FedSAE (which reads the whole losses and sizes:
    one more all-reduce a round): at D = 2 the unsharded port's cohorts and
    generator state bit for bit, its params and losses within 1e-5."""
    xs, ys, params = _federation()
    for name, per_round in (("fl-dp3s", 1), ("fedsae", 2)):
        cfg = tengine.FLConfig(**_cfg_kw(local_batch_size=4, cohort_cap=cap))

        def build(mesh=None):
            strat = tsel.make_strategy(name)
            with torch.no_grad():
                l0 = torch.stack([loss(_tparams(params), _t(x), _t(y)) for x, y in zip(xs, ys)])
            state = tengine.init_server_state(cfg, _tparams(params), xs, ys, _t(xs.mean(1)), l0, strat,
                                              device="cpu", mesh=mesh)
            return state, tengine.make_round_fn(cfg, loss, (strat,), mesh=mesh)

        state, fn = build()
        rounds = 4
        ref, ref_outs = tengine.run_scanned(fn, state, rounds)

        def rank(mesh):
            state, fn = build(mesh)
            mesh.reset_counts()
            final, outs = tengine.run_scanned(fn, state, rounds)
            return final, outs, mesh.all_reduce_calls

        res = tmesh.run_ranks(2, rank, "cpu")
        final, outs, calls = res[0]
        assert calls == per_round * rounds, name
        assert torch.equal(outs["selected"], ref_outs["selected"]), name
        assert torch.equal(final.generator.get_state(), ref.generator.get_state())
        np.testing.assert_allclose(outs["loss"].numpy(), ref_outs["loss"].numpy(), rtol=0, atol=1e-5)
        for p in ref.params:
            np.testing.assert_allclose(final.params[p].numpy(), ref.params[p].numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(_gather_losses(res).numpy(), ref.losses.numpy(), rtol=0, atol=1e-5)


# ------------------------------------------------ the round's conventions


def _round_inputs(c_loc=4, steps=2, seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(FEAT, NCLS)).astype(np.float32)}
    xb = rng.normal(size=(c_loc, steps, N_C, FEAT)).astype(np.float32)
    yb = rng.integers(0, NCLS, size=(c_loc, steps, N_C)).astype(np.int32)
    return params, xb, yb


def _lin(p, batch):
    x, y = batch
    logp = torch.log_softmax(x @ p["w"], -1)
    return -torch.mean(torch.gather(logp, -1, y.long()[..., None]))


# the strategies a mesh round draws for without the whole losses
LOSS_FREE = [n for n in tsel.STRATEGY_NAMES if not tsel.make_strategy(n).reads_client_stats]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", LOSS_FREE)
def test_loss_free_strategies_draw_the_same_on_nan_losses(name, masked):
    """A strategy with ``reads_client_stats`` False gets NaN stand-ins for
    the losses on a mesh: its draw from the same generator state is the
    draw on the real losses, with and without an availability mask."""
    assert set(LOSS_FREE) >= {"fedavg", "fl-dp3s"}
    rng = np.random.default_rng(3)
    x = rng.normal(size=(C, FEAT)).astype(np.float32)
    kern = _t(x @ x.T / FEAT + 0.1 * np.eye(C, dtype=np.float32))
    losses = _t(rng.uniform(0.5, 2.0, size=C).astype(np.float32))
    avail = torch.from_numpy(rng.random(C) < 0.7) if masked else None
    draws = []
    for ls in (losses, torch.full((C,), float("nan"))):
        st = tsel.selection_state(C, K, kernel=kern, losses=ls, client_sizes=torch.full((C,), 6.0),
                                  decompose_kernel=True)
        g = torch.Generator().manual_seed(11)
        draws.append(tsel.make_strategy(name).select_global_fn(g, st, K, avail))
    assert torch.equal(draws[0], draws[1])


def test_shard_round_masks_noncohort_losses():
    """NaN for every resident outside the cohort, in resident and slot mode;
    the resident round against JAX's on its 1-device mesh (params and
    cohort losses within 1e-6), the slot round's aggregate equal to the
    resident one's within 1e-6."""
    params, xb, yb = _round_inputs()
    weights = np.array([2.0, 0.0, 3.0, 0.0], np.float32)  # residents 1, 3 not in the cohort
    mesh = tmesh.make_client_mesh(1, "cpu")
    resident = trounds.build_shard_cohort_round(_lin, 0.1, mesh)
    agg, losses, mean_loss, _ = resident(_tparams(params), (_t(xb), _t(yb)), _t(weights))
    assert np.isnan(losses.numpy()[[1, 3]]).all() and np.isfinite(losses.numpy()[[0, 2]]).all()
    assert mesh.all_reduce_calls == 1

    def jlin(p, batch):
        x, y = batch
        logp = jax.nn.log_softmax(x @ p["w"])
        return -jnp.mean(jnp.take_along_axis(logp, y[..., None], axis=-1))

    jmesh = j_make_client_mesh(1)
    jres = jrounds.build_shard_cohort_round(jlin, 0.1, jengine.CLIENT_AXIS)
    body = jengine._checked_shard_map(
        lambda p, b, w: jres(p, b, w)[:3], mesh=jmesh,
        in_specs=(jengine.P(), jengine.P(jengine.CLIENT_AXIS), jengine.P(jengine.CLIENT_AXIS)),
        out_specs=(jengine.P(), jengine.P(jengine.CLIENT_AXIS), jengine.P()),
    )
    jagg, jlosses, jmean = body({"w": jnp.asarray(params["w"])}, (jnp.asarray(xb), jnp.asarray(yb)),
                                jnp.asarray(weights))
    np.testing.assert_allclose(agg["w"].numpy(), np.asarray(jagg["w"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(mean_loss), float(jmean), rtol=0, atol=1e-6)

    slotted = trounds.build_shard_cohort_round(_lin, 0.1, mesh, cap=2)
    s_agg, s_losses, s_mean, _ = slotted(_tparams(params), (_t(xb[[0, 2]]), _t(yb[[0, 2]])), _t(weights),
                                         torch.tensor([0, 2]))
    assert np.isnan(s_losses.numpy()[[1, 3]]).all() and np.isfinite(s_losses.numpy()[[0, 2]]).all()
    np.testing.assert_allclose(s_agg["w"].numpy(), agg["w"].numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(s_losses.numpy()[[0, 2]], losses.numpy()[[0, 2]], rtol=0, atol=1e-6)
    assert float(s_mean) == pytest.approx(float(mean_loss), abs=1e-6)


def test_shard_round_across_two_ranks_equals_one_rank():
    """The same eight residents split over two ranks: each rank's NaN
    pattern is its own, the aggregate and the extras the one-rank round's
    within 1e-6, from one all-reduce a rank."""
    params, xb, yb = _round_inputs(c_loc=8, seed=1)
    weights = np.array([1.0, 0.0, 2.0, 0.0, 0.0, 3.0, 0.0, 1.5], np.float32)
    extras = (_t(np.arange(8, dtype=np.float32)), _t(np.float32(1.0)))

    def rank(mesh):
        lo, hi = mesh.residents(8)
        step = trounds.build_shard_cohort_round(_lin, 0.1, mesh)
        out = step(_tparams(params), (_t(xb[lo:hi]), _t(yb[lo:hi])), _t(weights[lo:hi]), extras=extras)
        return out, mesh.all_reduce_calls

    one = tmesh.run_ranks(1, rank, "cpu")[0][0]
    two = tmesh.run_ranks(2, rank, "cpu")
    assert [r[1] for r in two] == [1, 1]
    np.testing.assert_allclose(two[0][0][0]["w"].numpy(), one[0]["w"].numpy(), rtol=0, atol=1e-6)
    losses = torch.cat([two[0][0][1], two[1][0][1]]).numpy()
    np.testing.assert_array_equal(np.isnan(losses), weights == 0)
    np.testing.assert_allclose(losses, one[1].numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(two[1][0][2]), float(one[2]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(two[0][0][3][0].numpy(), 2 * extras[0].numpy())
    assert float(two[0][0][3][1]) == 2.0


# ----------------------------------------------------------------- funnel


def test_funnel_block_across_four_ranks_is_index_select_bit_for_bit():
    rng = np.random.default_rng(5)
    c, f = 16, 5
    prof = rng.normal(size=(c, f)).astype(np.float32)
    cand = np.sort(rng.choice(c, size=7, replace=False)).astype(np.int32)
    want = torch.index_select(_t(prof), 0, _t(cand).long())

    def rank(mesh):
        lo, hi = mesh.residents(c)
        return tengine.candidate_profile_block(_t(prof[lo:hi]), _t(cand), mesh), mesh.all_reduce_calls

    for block, calls in tmesh.run_ranks(4, rank, "cpu"):
        assert torch.equal(block, want) and calls == 1
    assert torch.equal(tengine.candidate_profile_block(_t(prof), _t(cand)), want)


@pytest.mark.parametrize("kw", [
    dict(candidate_frac=0.5, scenario="flaky"),
    dict(cohort_cap=3, candidate_frac=0.75),
])
def test_trainer_across_reprofile_and_funnel_boundaries(kw):
    """``FLTrainer(mesh=)`` at D = 2, re-profiled (and re-funnelled) every 3
    rounds: the unsharded trainer's history and cohorts, its params within
    1e-5; the all-reduces: one a round, two at init and at the boundary
    (the losses for the prefilter, then the (Q, F) block), one per eval
    round for the union accuracy."""
    xs, ys, params = _federation()
    cfg = tengine.FLConfig(**_cfg_kw(local_epochs=1, rounds=6, eval_every=3, reprofile_every=3, **kw))
    spy = {}

    def mk(mesh=None):
        return FLTrainer(cfg, _tparams(params), loss, features, xs, ys, tsel.DPPSelection(),
                         accuracy_fn=accuracy, device="cpu", mesh=mesh)

    ref = mk()
    h_ref = ref.run()

    def rank(mesh):
        tr = mk(mesh)
        h = tr.run()
        spy[mesh.rank] = tr
        return h, tr.params, mesh.all_reduce_calls

    res = tmesh.run_ranks(2, rank, "cpu")
    h, p, calls = res[0]
    assert calls == 6 + 2 * 2 + 2
    assert h["round"] == h_ref["round"] == [3, 6]
    np.testing.assert_allclose(h["loss"], h_ref["loss"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(h["acc"], h_ref["acc"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(h["gemd"], h_ref["gemd"], rtol=0, atol=1e-5)
    for name in p:
        np.testing.assert_allclose(p[name].numpy(), ref.params[name].numpy(), rtol=0, atol=1e-5)
    assert torch.equal(spy[0].generator.get_state(), ref.generator.get_state())
    with pytest.raises(ValueError, match="one device"):
        spy[0].run_legacy()


def test_run_many_over_a_mesh_matches_the_unsharded_grid():
    xs, ys, params = _federation()
    cfg = tengine.FLConfig(**_cfg_kw(eval_every=ROUNDS))
    strategies = (tsel.UniformSelection(), tsel.DPPSelection())

    def grid(mesh=None):
        with torch.no_grad():
            l0 = torch.stack([loss(_tparams(params), _t(x), _t(y)) for x, y in zip(xs, ys)])
        states = [tengine.init_server_state(cfg, _tparams(params), xs, ys, _t(xs.mean(1)), l0, s, device="cpu",
                                            strategy_index=i, mesh=mesh) for i, s in enumerate(strategies)]
        fn = tengine.make_round_fn(cfg, loss, strategies, mesh=mesh)
        return tengine.run_many(fn, tengine.stack_states(states), 3)

    _, ref = grid()
    _, got = tmesh.run_ranks(2, grid, "cpu")[0]
    assert torch.equal(got["selected"], ref["selected"])
    np.testing.assert_allclose(got["loss"].numpy(), ref["loss"].numpy(), rtol=0, atol=1e-5)


# ------------------------------------------------------------ crash-resume


def test_sharded_crash_resume_equals_an_unbroken_run(tmp_path):
    """D = 2 under chaos faults, trimmed mean, FedDyn and staleness bound 1:
    4 rounds with a snapshot every 2 (each rank its own), then 2 rounds,
    restore of round 2, 2 more: every rank's state, generators, ring and
    counters bit for bit the unbroken run's."""
    xs, ys, params = _federation()
    cfg = tengine.FLConfig(**_cfg_kw(scenario="heavy_tail", staleness_bound=1, faults="chaos",
                                     aggregator="trimmed_mean", local_algo="feddyn", feddyn_alpha=0.1,
                                     min_survivors=1))

    def build(mesh):
        with torch.no_grad():
            l0 = torch.stack([loss(_tparams(params), _t(x), _t(y)) for x, y in zip(xs, ys)])
        strat = tsel.DPPSelection()
        state = tengine.init_server_state(cfg, _tparams(params), xs, ys, _t(xs.mean(1)), l0, strat,
                                          device="cpu", mesh=mesh)
        return state, tengine.make_round_fn(cfg, loss, (strat,), mesh=mesh)

    def rank(mesh):
        state, fn = build(mesh)
        whole, outs = tengine.run_checkpointed(fn, state, 4, ckpt_dir=str(tmp_path / "a"), ckpt_every=2)
        state, fn = build(mesh)
        tengine.run_checkpointed(fn, state, 2, ckpt_dir=str(tmp_path / "b"), ckpt_every=2)
        fresh, fn = build(mesh)
        restored = tengine.restore_server_state(str(tmp_path / "b"), fresh)
        assert restored.round == 2
        resumed, _ = tengine.run_scanned(fn, restored, 2)
        return whole, resumed, outs

    for whole, resumed, outs in tmesh.run_ranks(2, rank, "cpu"):
        a, b = tengine._state_tree(whole), tengine._state_tree(resumed)
        from repro_torch.tree import tree_leaves

        la = [x for x in tree_leaves(a) if x is not None]
        lb = [x for x in tree_leaves(b) if x is not None]
        assert len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))
        assert whole.param_hist is not None and whole.shard_staleness.shape == (2,)
        assert (tmp_path / "a" / f"rank_{whole.shard_rank}_of_2").is_dir()
        assert torch.isfinite(outs["staleness"]).all()


# --------------------------------------------------------------- the mesh


def test_mesh_contract():
    mesh = tmesh.make_client_mesh(1, "cpu")
    assert (mesh.rank, mesh.size, mesh.backend, mesh.device.type) == (0, 1, "gloo", "cpu")
    x = torch.arange(3.0)
    assert torch.equal(mesh.all_reduce(x), torch.arange(3.0)) and mesh.all_reduce_calls == 1
    with pytest.raises(ValueError, match="share a store"):
        tmesh.make_client_mesh(2, "cpu")
    with pytest.raises(ValueError, match="outside"):
        tmesh.make_client_mesh(2, "cpu", rank=2, store=torch.distributed.HashStore())
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.run_ranks(2, lambda m: m.residents(7), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_client_mesh(1)
    sums = tmesh.run_ranks(4, lambda m: m.all_reduce(torch.full((2,), float(m.rank + 1))).tolist(), "cpu")
    assert sums == [[10.0, 10.0]] * 4
    rows = tmesh.run_ranks(2, lambda m: m.assemble(torch.full((2, 3), float(m.rank)), 4), "cpu")
    assert all(torch.equal(r, torch.tensor([[0.0] * 3] * 2 + [[1.0] * 3] * 2)) for r in rows)


def test_shard_server_state_layout_and_checks():
    xs, ys, params = _federation()
    cfg = tengine.FLConfig(**_cfg_kw(local_algo="feddyn", feddyn_alpha=0.1, faults="dropout"))
    state = tengine.init_server_state(cfg, _tparams(params), xs, ys, _t(xs.mean(1)), torch.ones(C),
                                      tsel.DPPSelection(), device="cpu")

    def rank(mesh):
        s = tengine.shard_server_state(state, mesh)
        with pytest.raises(ValueError, match="shard a whole state"):
            tengine.shard_server_state(s, mesh)
        lo, hi = mesh.residents(C)
        for f in tengine.CLIENT_SHARDED_FIELDS:
            from repro_torch.tree import tree_leaves

            for a, b in zip(tree_leaves(getattr(s, f)), tree_leaves(getattr(state, f))):
                assert torch.equal(a, b[lo:hi]), f
        assert torch.equal(s.kernel, state.kernel) and torch.equal(s.quarantine, state.quarantine)
        assert torch.equal(s.client_sizes, state.client_sizes)  # replicated
        assert s.num_clients == C and s.shard_count == 4
        return True

    assert all(tmesh.run_ranks(4, rank, "cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.run_ranks(3, lambda m: tengine.shard_server_state(state, m), "cpu")


def test_make_round_fn_checks_cap_and_staleness_as_jax():
    cfg = tengine.FLConfig(**_cfg_kw(clients_per_round=4, cohort_cap=2))
    mesh = tmesh.make_client_mesh(1, "cpu")
    with pytest.raises(ValueError, match="cohort_cap"):
        tengine.make_round_fn(cfg, loss, (tsel.UniformSelection(),), mesh=mesh)
    jcfg = jengine.FLConfig(**_cfg_kw(clients_per_round=4, cohort_cap=2))
    with pytest.raises(ValueError, match="cohort_cap"):
        jengine.make_round_fn(jcfg, jax_loss, (jsel.UniformSelection(),), mesh=j_make_client_mesh(1))
    scfg = tengine.FLConfig(**_cfg_kw(staleness_bound=1, scenario="heavy_tail"))
    with pytest.raises(ValueError, match="requires the client mesh"):
        tengine.make_round_fn(scfg, loss, (tsel.UniformSelection(),))
    # the cap that covers every cohort member is accepted
    tengine.make_round_fn(dataclasses.replace(cfg, cohort_cap=4), loss, (tsel.UniformSelection(),), mesh=mesh)


# ------------------------------------------------------------ the launcher

_LM = ["--mode", "fl", "--rounds", "2", "--clients", "10", "--per-round", "3", "--docs-per-client", "4",
       "--local-steps", "1", "--local-batch", "2", "--seq", "16", "--log-every", "1", "--device", "cpu"]


@pytest.mark.parametrize("flags,err,match", [
    (["--shard-clients", "3"], SystemExit, "divisible"),
    (["--cohort-cap", "3"], SystemExit, "--cohort-cap requires --shard-clients"),
    (["--staleness-bound", "1", "--scenario", "heavy_tail"], SystemExit, "--staleness-bound requires --shard-clients"),
    (["--shard-clients", "2", "--staleness-bound", "1"], ValueError, "requires a latency scenario"),
    (["--shard-clients", "2", "--cohort-cap", "1"], ValueError, "cohort_cap"),
])
def test_launcher_mesh_flag_errors(flags, err, match):
    with pytest.raises(err, match=match):
        ttrain.run_fl(ttrain.parse_args(_LM + flags))


def test_launcher_refuses_an_unknown_decay_and_mesh_flags_in_pretrain():
    with pytest.raises(SystemExit):
        ttrain.parse_args(_LM + ["--staleness-decay", "bogus"])
    args = ttrain.parse_args(["--mode", "pretrain", "--steps", "1", "--device", "cpu", "--shard-clients", "2"])
    with pytest.raises(ValueError, match="--shard-clients"):
        ttrain.run_pretrain(args)


def test_launcher_shard_clients_matches_the_unsharded_run(tmp_path):
    """``--shard-clients 2 --cohort-cap 3`` over the reduced LM clients:
    the unsharded launcher's cohorts bit for bit, its round losses within
    1e-5, and a manifest whose ``mesh`` names 2 gloo ranks."""
    _, ref = ttrain.run_fl(ttrain.parse_args(_LM))
    path = tmp_path / "t.jsonl"
    _, got = ttrain.run_fl(ttrain.parse_args(_LM + ["--shard-clients", "2", "--cohort-cap", "3",
                                                    "--telemetry", str(path)]))
    assert torch.equal(got["selected"], ref["selected"])
    np.testing.assert_allclose(got["loss"].numpy(), ref["loss"].numpy(), rtol=0, atol=1e-5)
    from repro_torch.obs import load_events

    man = load_events(str(path))[0]
    assert man["event"] == "manifest" and man["mesh"]["ranks"] == 2 and man["mesh"]["backend"] == "gloo"
    assert man["mesh"]["axes"] == {"clients": 2} and man["mesh"]["device"] == "cpu"
