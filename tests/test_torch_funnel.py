"""The port's two-stage selection funnel and availability-masked draws
against the JAX package on the CPU: the prefilter's scores and candidates
(ties included), the availability helpers, every strategy's ``avail=`` draw
on JAX's noise, ``select_global_fn``, ``funnel_fields`` (the JAX side's
Pallas kernels in interpret mode, the port's K1 + K2 through their plain
versions), the identity funnel at Q = C, re-funnelling at each reprofile
boundary, and a funnelled init that builds no C × C tensor."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import dpp as jdpp  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.core import similarity as jsim  # noqa: E402
from repro.data import make_image_dataset, skewness_partition  # noqa: E402
from repro.fl import engine as jengine  # noqa: E402
from repro.fl import scenarios as jscen  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402

from repro_torch.core import dpp as tdpp  # noqa: E402
from repro_torch.core import profiles as tprof  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.fl import engine as tengine  # noqa: E402
from repro_torch.fl import trainer as ttrainer  # noqa: E402
from repro_torch.kernels.gram import ops as tgram_ops  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

STRATEGIES = ("fedavg", "fl-dp3s", "fl-dp3s-map", "fedsae", "power-of-choice", "cluster")


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------- prefilter (stage 1)


def _score_inputs(c, seed, ties):
    rng = np.random.default_rng(seed)
    losses = rng.uniform(0.1, 3.0, size=c).astype(np.float32)
    if ties:  # repeated losses and non-positive ones (clamped to one eps)
        losses[::3] = losses[0]
        losses[1::5] = rng.choice([0.0, -1.0], size=losses[1::5].shape)
    lat = rng.pareto(1.1, size=c).astype(np.float32) - 0.2  # some negative
    avail = rng.uniform(size=c) < 0.6
    return losses, lat, avail


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("c,seed", [(16, 0), (100, 1), (4096, 2)])
def test_funnel_scores_and_candidates_equal_jax(c, seed, ties):
    """Scores bit for bit, and the candidates for every Q, ties included:
    the unavailable clients all score 0, and lax.top_k takes the lower id
    first among equal scores."""
    losses, lat, avail = _score_inputs(c, seed, ties)
    for kw in ({}, {"avail": avail}, {"latency": lat}, {"avail": avail, "latency": lat}):
        want = np.asarray(jsel.funnel_scores(jnp.asarray(losses), **{k: jnp.asarray(v) for k, v in kw.items()}))
        got = tsel.funnel_scores(_t(losses), **{k: _t(v) for k, v in kw.items()})
        np.testing.assert_array_equal(got.numpy(), want)
        for q in sorted({1, c // 8, c // 2, c - int(avail.sum()) + 1, c}):
            cand = tsel.funnel_candidates(got, q)
            assert cand.dtype == torch.int32
            np.testing.assert_array_equal(cand.numpy(), np.asarray(jsel.funnel_candidates(jnp.asarray(want), q)))


def test_funnel_candidates_break_ties_by_the_lower_id():
    scores = torch.tensor([0.0, 2.0, 0.0, 2.0, 0.0, 1.0, 0.0])
    np.testing.assert_array_equal(tsel.funnel_candidates(scores, 4).numpy(), [0, 1, 3, 5])
    np.testing.assert_array_equal(tsel.funnel_candidates(scores, 7).numpy(), np.arange(7))


# ------------------------------------------------ availability helpers


def test_candidate_availability_gather():
    avail = torch.tensor([True, False, True, False, True])
    cand = tsel.CandidateSet(ids=torch.tensor([1, 2, 4], dtype=torch.int32))
    assert cand.size == 3
    np.testing.assert_array_equal(tsel.candidate_availability(avail, cand).numpy(), [False, True, True])


@pytest.mark.parametrize("c,seed", [(6, 0), (40, 3)])
def test_masked_kernel_equals_jax(c, seed):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(c, 5)).astype(np.float32)
    kern = (f @ f.T).astype(np.float32)
    avail = rng.uniform(size=c) < 0.5
    got = tdpp.masked_kernel(_t(kern), _t(avail))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jdpp.masked_kernel(jnp.asarray(kern), jnp.asarray(avail))))
    off = ~avail
    assert not got.numpy()[off].any() and not got.numpy()[:, off].any()


@pytest.mark.parametrize("n_avail", [0, 2, 3, 4, 9])
def test_availability_logits_fall_back_below_k(n_avail):
    """Masked with at least k = 3 available clients, unmasked below."""
    logits = np.linspace(-1.0, 1.0, 9).astype(np.float32)
    avail = np.zeros(9, bool)
    avail[:n_avail] = True
    got = tsel.availability_logits(_t(avail), 3, _t(logits))
    want = np.asarray(jsel.availability_logits(jnp.asarray(avail), 3, jnp.asarray(logits)))
    np.testing.assert_array_equal(got.numpy(), want)
    if n_avail < 3:
        np.testing.assert_array_equal(got.numpy(), logits)
    else:
        assert np.isneginf(got.numpy()[n_avail:]).all()


# ----------------------------------------------- avail= draws on JAX noise


def _selection_states(c, k, seed):
    """The same server knowledge as a JAX and a port SelectionState (k-DPP
    spectral cache from JAX, so both draw from one spectrum)."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(c, 6)).astype(np.float32)
    kern = np.asarray(jsim.kernel_from_profiles(jnp.asarray(f)))
    losses = rng.uniform(0.1, 3.0, size=c).astype(np.float32)
    sizes = rng.integers(5, 50, size=c).astype(np.float32)
    labels = np.concatenate([np.arange(k), rng.integers(0, k, size=c - k)]).astype(np.int32)
    js = jsel.selection_state(c, k, kernel=jnp.asarray(kern), losses=jnp.asarray(losses),
                              client_sizes=jnp.asarray(sizes), cluster_labels=jnp.asarray(labels))
    ts = tsel.selection_state(c, k, kernel=_t(kern), losses=_t(losses), client_sizes=_t(sizes),
                              cluster_labels=_t(labels))
    return js, ts


def _jax_kdpp_noise(key, n, k):
    """JAX's draws inside the k-DPP sampler (one split a phase-1 step for a
    uniform, one a phase-2 step for a categorical)."""
    key1, key2 = jax.random.split(key)
    uniforms, gumbels = [], []
    for _ in range(n):
        key1, sub = jax.random.split(key1)
        uniforms.append(np.asarray(jax.random.uniform(sub)))
    for _ in range(k):
        key2, k_i = jax.random.split(key2)
        gumbels.append(np.asarray(jax.random.gumbel(k_i, (n,), jnp.float32)))
    return np.stack(uniforms), np.stack(gumbels)


def _jax_avail_noise(name, key, c, k):
    """The noise each JAX strategy's masked draw makes of its key."""
    if name in ("fedavg", "fedsae"):
        return _t(jax.random.gumbel(key, (c,), jnp.float32))
    if name == "power-of-choice":
        return _t(jax.random.gumbel(jax.random.split(key)[0], (c,), jnp.float32))
    if name == "cluster":
        return _t(np.stack([np.asarray(jax.random.gumbel(kk, (c,), jnp.float32)) for kk in jax.random.split(key, k)]))
    raise KeyError(name)


def _masks(c, k, seed):
    """Availability masks: many available, exactly k, fewer than k (the
    unmasked fallback), and none."""
    rng = np.random.default_rng(seed)
    many = rng.uniform(size=c) < 0.6
    many[:k] = True
    exact = np.zeros(c, bool)
    exact[rng.choice(c, k, replace=False)] = True
    few = np.zeros(c, bool)
    few[rng.choice(c, k - 1, replace=False)] = True
    return {"many": many, "exactly-k": exact, "fewer-than-k": few, "none": np.zeros(c, bool)}


@pytest.mark.parametrize("mask", ["many", "exactly-k", "fewer-than-k", "none"])
@pytest.mark.parametrize("name", STRATEGIES)
def test_avail_draw_on_jax_noise(name, mask):
    """Each strategy's masked draw gives JAX's cohort on JAX's noise; with
    at least k available every pick is available, below k the draw is the
    unmasked one."""
    c, k = 24, 4
    js, ts = _selection_states(c, k, seed=len(name))
    avail = _masks(c, k, seed=7)[mask]
    jstrat, tstrat = jsel.make_strategy(name), tsel.make_strategy(name)
    for seed in range(6):
        key = jax.random.key(100 * seed + len(mask))
        want = np.asarray(jstrat.draw_fn(key, js, k, avail=jnp.asarray(avail)))
        if name.startswith("fl-dp3s"):
            kern = tsel.DPPSelection.avail_kernel(ts.kernel, _t(avail), k)
            jkern = jnp.where(jnp.sum(avail) >= k, jdpp.masked_kernel(js.kernel, jnp.asarray(avail)), js.kernel)
            np.testing.assert_array_equal(kern.numpy(), np.asarray(jkern))
            if name == "fl-dp3s-map":
                got = tstrat.draw_fn(torch.Generator(), ts, k, _t(avail))
            else:
                # the one-shot draw on JAX's spectrum of the masked kernel
                st = jdpp.kdpp_sampler_state(jkern, k)
                u, g = _jax_kdpp_noise(key, c, k)
                got = tdpp._sample_from_noise(
                    _t(u), _t(g),
                    tdpp.KDPPSamplerState(lam=_t(st.lam), vecs=_t(st.vecs), esp=_t(st.esp)), k,
                )
        else:
            got = tstrat.draw_from_noise(_jax_avail_noise(name, key, c, k), ts, k, _t(avail))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert name == "cluster" or len(set(got.tolist())) == k
        if avail.sum() >= k:
            assert avail[got.numpy()].all()


@pytest.mark.parametrize("name", STRATEGIES)
def test_generator_avail_draws_are_available_cohorts(name):
    """The port's own noise: k distinct available clients each draw, and
    the mask-free draw unchanged by the ``avail`` argument's presence."""
    c, k = 30, 5
    _, ts = _selection_states(c, k, seed=3)
    ts = dataclasses.replace(ts, eig_state=tdpp.kdpp_sampler_state(ts.kernel, k))
    avail = _t(_masks(c, k, seed=1)["many"])
    strat = tsel.make_strategy(name)
    for seed in range(5):
        sel = strat.draw_fn(torch.Generator().manual_seed(seed), ts, k, avail)
        assert (name == "cluster" or len(set(sel.tolist())) == k) and bool(avail[sel.long()].all())
        a = strat.draw_fn(torch.Generator().manual_seed(seed), ts, k)
        b = strat.select_global_fn(torch.Generator().manual_seed(seed), ts, k)
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("name", STRATEGIES)
def test_select_global_fn_maps_candidates_as_jax(name):
    """With a CandidateSet the draw runs in candidate space and returns
    global ids that lie in the candidates; on JAX's noise, JAX's global
    ids.  With fewer than k available candidates (every non-candidate
    available) the fallback stays inside the candidates."""
    c, q, k = 16, 6, 4
    rng = np.random.default_rng(3)
    f = rng.normal(size=(c, 8)).astype(np.float32)
    losses = rng.uniform(0.5, 2.0, size=c).astype(np.float32)
    cand = np.asarray(jsel.funnel_candidates(jsel.funnel_scores(jnp.asarray(losses)), q))
    jkern = jsim.candidate_kernel(jnp.asarray(f), jnp.asarray(cand))
    kw = dict(losses=losses[cand], client_sizes=np.full(q, 6.0, np.float32),
              cluster_labels=np.arange(q, dtype=np.int32) % k)
    js = jsel.selection_state(q, k, kernel=jkern, decompose_kernel=True,
                              candidates=jsel.CandidateSet(ids=jnp.asarray(cand)),
                              **{n: jnp.asarray(v) for n, v in kw.items()})
    jst = js.eig_state
    ts = tsel.selection_state(
        q, k, kernel=_t(jkern), candidates=tsel.CandidateSet(ids=_t(cand)),
        eig_state=tdpp.KDPPSamplerState(lam=_t(jst.lam), vecs=_t(jst.vecs), esp=_t(jst.esp)),
        **{n: _t(v) for n, v in kw.items()},
    )
    few = np.ones(c, bool)
    few[cand] = False
    few[cand[:2]] = True
    jstrat, tstrat = jsel.make_strategy(name), tsel.make_strategy(name)
    for avail in (None, few, np.ones(c, bool)):
        key = jax.random.key(7)
        want = np.asarray(jstrat.select_global_fn(key, js, k, avail=None if avail is None else jnp.asarray(avail)))
        assert np.isin(want, cand).all()
        # the port's own generator: global ids among the candidates
        got = tstrat.select_global_fn(torch.Generator().manual_seed(0), ts, k, None if avail is None else _t(avail))
        assert got.dtype == torch.int32 and np.isin(got.numpy(), cand).all()
        if avail is None or name.startswith("fl-dp3s"):
            continue
        # on JAX's noise: JAX's global ids
        local_avail = tsel.candidate_availability(_t(avail), ts.candidates)
        local = tstrat.draw_from_noise(_jax_avail_noise(name, key, q, k), ts, k, local_avail)
        np.testing.assert_array_equal(cand[local.numpy()], want)


# ------------------------------------------------------ funnel_fields


C, K, N_C = 16, 3, 6


def _federation(c=C, seed=2):
    ds = make_image_dataset(n=c * N_C, seed=seed)
    shards = skewness_partition(ds.ys, c, 0.8, 10, samples_per_client=N_C, seed=0)
    cxs = np.stack([ds.xs[s] for s in shards])
    cys = np.stack([ds.ys[s] for s in shards])
    jparams = jcnn.init_cnn(jax.random.key(0), channels=(4, 8), fc1_dim=16)
    return cxs, cys, jparams


def _tparams(jparams):
    return tcnn.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))


@pytest.mark.parametrize("scenario", [None, "heavy_tail", "flaky"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_funnel_fields_match_jax(monkeypatch, use_kernel, scenario):
    """The same candidates as JAX's on the same profiles, losses and
    predicted environment (JAX's draws at round 5 handed to the port), and
    the (Q, Q) kernel and its spectrum within 1e-5 (K1 + K2's plain
    versions, or the plain chain, against Pallas in interpret mode, or
    JAX's chain)."""
    cxs, cys, jparams = _federation()
    rng = np.random.default_rng(1)
    profiles = rng.normal(size=(C, 16)).astype(np.float32)
    losses = rng.uniform(0.2, 2.5, size=C).astype(np.float32)
    kw = dict(num_clients=C, clients_per_round=K, candidate_frac=0.5, scenario=scenario,
              use_pallas_kernel=use_kernel)
    key = jax.random.key(11)
    jcand, jkern, jeig = jengine.funnel_fields(jengine.FLConfig(**kw), key, jnp.asarray(profiles),
                                              jnp.asarray(losses), strategy=jsel.DPPSelection(), round_index=5)
    if scenario is not None:
        scen = jscen.get_scenario(scenario)
        k_env = jax.random.fold_in(key, jengine._FUNNEL_SALT)
        lat = _t(scen.latency(jax.random.fold_in(k_env, 0), C))
        avail = None if scen.availability is None else _t(scen.availability(jax.random.fold_in(k_env, 1), 5, C))
        seen = []

        def replay(scen_, generator, t, n):
            seen.append((t, n))
            return lat, avail

        monkeypatch.setattr(tengine, "draw_environment", replay)
    cand, kern, eig = tengine.funnel_fields(tengine.FLConfig(**kw), torch.Generator(), _t(profiles),
                                            _t(losses), strategy=tsel.DPPSelection(), round_index=5)
    if scenario is not None:
        assert seen == [(5, C)]
    np.testing.assert_array_equal(cand.numpy(), np.asarray(jcand))
    assert tuple(kern.shape) == (8, 8) and eig.num_items == 8 and eig.k == K
    np.testing.assert_allclose(kern.numpy(), np.asarray(jkern), rtol=1e-5, atol=1e-5)
    # eigenvalues of the two kernels (normalised by their mean, as the cache
    # keeps them), and the ESP tables built on them
    np.testing.assert_allclose(eig.lam.numpy(), np.asarray(jeig.lam), rtol=1e-5, atol=1e-5)
    scale = np.abs(np.asarray(jeig.esp)).max(axis=1, keepdims=True)
    assert np.all(np.abs(eig.esp.numpy() - np.asarray(jeig.esp)) <= 1e-5 * scale)
    # a strategy that never draws from the cache gets the identity layout
    _, _, ident = tengine.funnel_fields(tengine.FLConfig(**kw), torch.Generator(), _t(profiles),
                                        _t(losses), strategy=tsel.UniformSelection())
    np.testing.assert_array_equal(ident.vecs.numpy(), np.eye(8, dtype=np.float32))


def test_candidate_count_and_validation_match_jax():
    for frac, k in ((0.01, 4), (1.0, 2), (0.5, 2), (0.125, 3), (0.3, 2)):
        kw = dict(num_clients=16, clients_per_round=k, candidate_frac=frac)
        assert tengine.FLConfig(**kw).candidate_count() == jengine.FLConfig(**kw).candidate_count()
    for bad in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError, match="candidate_frac"):
            tengine.FLConfig(candidate_frac=bad)
    with pytest.raises(ValueError, match="candidate_frac"):
        tengine.FLConfig().candidate_count()


def _port_inputs(cxs, cys, jparams):
    params = _tparams(jparams)
    xs = torch.from_numpy(cxs)
    profiles = tprof.profile_all_clients(tcnn.apply_with_features, params, list(xs))
    losses = torch.stack([tcnn.cnn_loss(params, x, torch.from_numpy(y)) for x, y in zip(xs, cys)]).detach()
    return params, profiles, losses


def test_init_rejects_precomputed_kernel_under_funnel():
    cxs, cys, jparams = _federation(c=8)
    params, profiles, losses = _port_inputs(cxs, cys, jparams)
    cfg = tengine.FLConfig(num_clients=8, clients_per_round=2, candidate_frac=0.5)
    for kw in ({"kernel": torch.eye(8)}, {"eig_state": tdpp.identity_sampler_state(8, 2, torch.device("cpu"))}):
        with pytest.raises(ValueError, match="funnel-owned"):
            tengine.init_server_state(cfg, params, cxs, cys, profiles, losses, tsel.DPPSelection(),
                                      device="cpu", **kw)


@pytest.mark.parametrize("name", ["fl-dp3s", "cluster", "fedsae"])
def test_funnelled_init_builds_no_cxc_tensor(monkeypatch, name):
    """C = 20, Q = 4: the kernel, its cache and the labels are on the Q
    block, every profiles -> kernel call and every eigh sees Q rows, and
    no tensor of the state is C × C."""
    c = 20
    cxs, cys, jparams = _federation(c=c)
    params, profiles, losses = _port_inputs(cxs, cys, jparams)
    rows = []
    for mod, fn in ((tgram_ops, "kernel_from_profiles"), (tdpp, "kdpp_sampler_state")):
        orig = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda x, *a, _o=orig, **kw: rows.append(x.shape[0]) or _o(x, *a, **kw))
    cfg = tengine.FLConfig(num_clients=c, clients_per_round=K, candidate_frac=0.2)
    state = tengine.init_server_state(cfg, params, cxs, cys, profiles, losses, tsel.make_strategy(name),
                                      device="cpu", loss_fn=tcnn.cnn_loss)
    q = cfg.candidate_count()
    assert q == 4 and rows and set(rows) == {q}
    assert tuple(state.kernel.shape) == (q, q) and tuple(state.cluster_labels.shape) == (q,)
    assert state.eig_state.num_items == q
    np.testing.assert_array_equal(state.candidates.numpy(), np.sort(np.argsort(-losses.numpy(), kind="stable")[:q]))
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        leaves = [v] if isinstance(v, torch.Tensor) else (
            [v.lam, v.vecs, v.esp] if isinstance(v, tdpp.KDPPSamplerState) else [])
        for x in leaves:
            assert not (x.ndim >= 2 and x.shape[0] == c and x.shape[1] == c), f"{f.name} is C x C"


# ------------------------------------------- the funnel through the engine


def _run(name, frac, scenario=None, rounds=4, c=8):
    cxs, cys, jparams = _federation(c=c)
    params, profiles, losses = _port_inputs(cxs, cys, jparams)
    cfg = tengine.FLConfig(num_clients=c, clients_per_round=K, local_epochs=1, local_batch_size=3,
                           lr=0.1, eval_every=2, seed=0, candidate_frac=frac, scenario=scenario)
    strat = tsel.make_strategy(name, d=5) if name == "power-of-choice" else tsel.make_strategy(name)
    state = tengine.init_server_state(cfg, params, cxs, cys, profiles, losses, strat, device="cpu",
                                      loss_fn=tcnn.cnn_loss)
    fn = tengine.make_round_fn(cfg, tcnn.cnn_loss, (strat,), accuracy_fn=tcnn.accuracy)
    return state, tengine.run_scanned(fn, state, rounds)


@pytest.mark.parametrize("scenario", [None, "flaky"])
@pytest.mark.parametrize("name", ["fedavg", "fl-dp3s", "fedsae", "power-of-choice", "cluster"])
def test_q_equals_c_bit_identical(name, scenario):
    """``candidate_frac=1.0`` is the identity funnel: candidates arange(C),
    and every observable equal to the run without a funnel, bit for bit."""
    ref_state, (st_r, out_r) = _run(name, None, scenario)
    fun_state, (st_f, out_f) = _run(name, 1.0, scenario)
    np.testing.assert_array_equal(fun_state.candidates.numpy(), np.arange(8))
    np.testing.assert_array_equal(fun_state.kernel.numpy(), ref_state.kernel.numpy())
    for key in ("selected", "loss", "gemd", "acc") + (("sim_time", "avail") if scenario else ()):
        np.testing.assert_array_equal(out_r[key].numpy(), out_f[key].numpy(), err_msg=key)
    for pname in st_r.params:
        np.testing.assert_array_equal(st_r.params[pname].numpy(), st_f.params[pname].numpy())
    np.testing.assert_array_equal(st_r.losses.numpy(), st_f.losses.numpy())


@pytest.mark.parametrize("name", ["fl-dp3s", "fedsae", "cluster"])
def test_funnel_selects_only_available_candidates(name):
    """Q = 8 of 16 under the flaky scenario: every cohort lies in the
    candidates, and in its round's mask when k candidates are available.
    (A cluster with no available member draws among every available
    client, as JAX's does, so a Cluster cohort may repeat a client.)"""
    state, (_, outs) = _run(name, 0.5, "flaky", rounds=5, c=C)
    cand = state.candidates
    assert cand.shape == (8,) and bool((cand[1:] > cand[:-1]).all())
    for sel, avail in zip(outs["selected"], outs["avail"]):
        assert np.isin(sel.numpy(), cand.numpy()).all()
        assert name == "cluster" or len(set(sel.tolist())) == K
        if int(avail[cand.long()].sum()) >= K:
            assert bool(avail[sel.long()].all())


def _trainer(cfg, name="fl-dp3s", seed=0):
    cxs, cys, jparams = _federation(c=cfg.num_clients, seed=seed + 2)
    return ttrainer.FLTrainer(cfg, _tparams(jparams), tcnn.cnn_loss, tcnn.apply_with_features, cxs, cys,
                              tsel.make_strategy(name), accuracy_fn=tcnn.accuracy, device="cpu")


@pytest.mark.parametrize("name", ["fl-dp3s", "cluster"])
def test_trainer_q_equals_c_parity_across_reprofile(name):
    """``FLTrainer.run`` at Q = C across a reprofile boundary (a re-funnel)
    gives the unfunnelled history bit for bit."""
    cfg = tengine.FLConfig(num_clients=8, clients_per_round=3, local_epochs=1, lr=0.1, rounds=5,
                           eval_every=2, seed=0, reprofile_every=3)
    h_ref = _trainer(cfg, name).run()
    h_fun = _trainer(dataclasses.replace(cfg, candidate_frac=1.0), name).run()
    assert h_ref["round"] == h_fun["round"] == [2, 4, 5]
    for key in ("loss", "gemd", "acc"):
        np.testing.assert_array_equal(np.asarray(h_ref[key]), np.asarray(h_fun[key]), err_msg=key)


@pytest.mark.parametrize("scenario", [None, "flaky"])
def test_trainer_refunnels_each_segment(monkeypatch, scenario):
    """frac 0.5, reprofile every 3 rounds of 6: the trainer funnels at the
    start and at round 3, on the losses of that time (without a scenario,
    exactly the top Q by loss), each with a prediction for its own round,
    and each segment's cohorts lie in its candidates.  Legacy refuses the
    funnel."""
    cfg = tengine.FLConfig(num_clients=C, clients_per_round=3, local_epochs=1, lr=0.1, rounds=6,
                           eval_every=3, seed=0, reprofile_every=3, candidate_frac=0.5, scenario=scenario)
    tr = _trainer(cfg)
    calls = []
    orig = tengine.funnel_fields

    def spy(cfg_, generator, profiles, losses, strategy=None, round_index=0, mesh=None):
        out = orig(cfg_, generator, profiles, losses, strategy, round_index, mesh=mesh)
        assert generator is tr.funnel_generator and mesh is None
        calls.append((round_index, losses.clone(), out[0]))
        return out

    monkeypatch.setattr(tengine, "funnel_fields", spy)
    cohorts = []
    draw = tr.strategy.select_global_fn
    monkeypatch.setattr(tr.strategy, "select_global_fn",
                        lambda *a, **kw: cohorts.append(draw(*a, **kw)) or cohorts[-1])
    h = tr.run()
    assert [c[0] for c in calls] == [0, 3]
    assert h["round"] == [3, 6] and np.isfinite(h["loss"]).all()
    for r, (_, losses, cand) in enumerate(calls):
        if scenario is None:
            np.testing.assert_array_equal(cand.numpy(), np.sort(np.argsort(-losses.numpy(), kind="stable")[:8]))
        for sel in cohorts[3 * r: 3 * r + 3]:
            assert np.isin(sel.numpy(), cand.numpy()).all()
    assert not torch.equal(calls[0][1], calls[1][1])  # the losses evolved
    with pytest.raises(ValueError, match="legacy loop has no funnel"):
        tr.run_legacy(rounds=1)
