"""The port's core (``repro_torch.core``: similarity, metrics, k-DPP
sampler) against ``repro.core`` on the same numpy inputs."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import dpp as jdpp  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.core import similarity as jsim  # noqa: E402

from repro_torch.core import dpp as tdpp  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.core import similarity as tsim  # noqa: E402


def _profiles(c, q, seed=0):
    return np.random.default_rng(seed).normal(size=(c, q)).astype(np.float32)


def _kernel(c, q=5, seed=0):
    return np.array(jsim.kernel_from_profiles(jnp.asarray(_profiles(c, q, seed))))


# ----------------------------------------------------------- similarity


@pytest.mark.parametrize(
    "name", ["pairwise_sq_dists", "pairwise_dists", "similarity_matrix", "kernel_from_profiles"]
)
def test_similarity_stage_matches_jax(name):
    f = _profiles(23, 9)
    want = np.asarray(getattr(jsim, name)(jnp.asarray(f)))
    got = getattr(tsim, name)(torch.from_numpy(f)).numpy()
    # fp32 dot products summed in another order: a few ulps of values up to
    # O(10) (squared distances) and O(20) (kernel entries)
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale)


def test_dpp_kernel_matches_jax():
    s = np.random.default_rng(1).uniform(size=(17, 17)).astype(np.float32)
    want = np.asarray(jsim.dpp_kernel(jnp.asarray(s)))
    got = tsim.dpp_kernel(torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_candidate_kernel_matches_jax(use_kernel):
    f = _profiles(30, 12, seed=2)
    cand = np.array([1, 4, 5, 9, 17, 22, 29], np.int32)
    want = np.asarray(jsim.candidate_kernel(jnp.asarray(f), jnp.asarray(cand), use_kernel=use_kernel))
    got = tsim.candidate_kernel(torch.from_numpy(f), torch.from_numpy(cand), use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # normalised over the candidate block: not a submatrix of the C x C kernel
    full = tsim.kernel_from_profiles(torch.from_numpy(f)).numpy()
    assert not np.allclose(got.numpy(), full[np.ix_(cand, cand)])


def test_stage_wise_kernel_route_names_k3(monkeypatch):
    """``use_kernel=True`` on the stage-wise helpers routes the distance
    stage through K3's wrapper (its plain version on the CPU) and matches
    JAX's stage-wise Pallas route (interpret mode)."""
    from repro_torch.kernels.pairwise_l2 import ops as tpw

    calls = []
    k3 = tpw.pairwise_sq_dists
    monkeypatch.setattr(tpw, "pairwise_sq_dists", lambda f: calls.append(1) or k3(f))
    f = _profiles(23, 9, seed=3)
    for i, name in enumerate(("pairwise_sq_dists", "pairwise_dists", "similarity_matrix")):
        want = np.asarray(getattr(jsim, name)(jnp.asarray(f), use_kernel=True))
        got = getattr(tsim, name)(torch.from_numpy(f), use_kernel=True)
        assert got.dtype == torch.float32 and len(calls) == i + 1
        # the JAX sweep's fp32 bound, 1e-3 of max(1, max), on every stage
        np.testing.assert_allclose(got.numpy(), want, atol=1e-3 * max(1.0, np.abs(want).max()))


# -------------------------------------------------------------- metrics


def test_metrics_match_jax():
    rng = np.random.default_rng(3)
    c, n, classes = 9, 40, 10
    ys = rng.integers(0, classes, size=(c, n)).astype(np.int32)
    sizes = rng.integers(1, 50, size=c).astype(np.float32)
    sel = np.array([0, 3, 7], np.int32)
    jd = jnp.stack([jmetrics.label_distribution(jnp.asarray(y), classes) for y in ys])
    td = torch.stack([tmetrics.label_distribution(torch.from_numpy(y), classes) for y in ys])
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    jg = jmetrics.label_distribution(jnp.asarray(ys.reshape(-1)), classes)
    tg = tmetrics.label_distribution(torch.from_numpy(ys.reshape(-1)), classes)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
    args_j = (jd, jnp.asarray(sizes), jnp.asarray(sel))
    args_t = (td, torch.from_numpy(sizes), torch.from_numpy(sel).long())
    np.testing.assert_allclose(
        tmetrics.cohort_label_distribution(*args_t).numpy(),
        np.asarray(jmetrics.cohort_label_distribution(*args_j)), atol=1e-6,
    )
    np.testing.assert_allclose(
        float(tmetrics.gemd(*args_t, tg)), float(jmetrics.gemd(*args_j, jg)), atol=1e-6
    )


def test_safe_div_and_finite_mean_match_jax():
    x = np.array([1.0, np.nan, 3.0, np.inf, -2.0], np.float32)
    where = np.array([True, True, False, True, True])
    for w in (None, where):
        want = float(jmetrics.finite_mean(jnp.asarray(x), None if w is None else jnp.asarray(w)))
        got = float(tmetrics.finite_mean(torch.from_numpy(x), None if w is None else torch.from_numpy(w)))
        np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.isnan(float(tmetrics.finite_mean(torch.tensor([np.nan], dtype=torch.float32))))
    num = np.array([1.0, 2.0], np.float32)
    for den in (np.float32(4.0), np.float32(0.0)):
        np.testing.assert_allclose(
            tmetrics.safe_div(torch.from_numpy(num), torch.tensor(den)).numpy(),
            np.asarray(jmetrics.safe_div(jnp.asarray(num), jnp.asarray(den))), atol=1e-6,
        )


# ------------------------------------------------------------------ k-DPP


def test_elementary_symmetric_matches_jax():
    lam = np.random.default_rng(4).uniform(0.1, 2.0, size=11).astype(np.float32)
    want = np.asarray(jdpp.elementary_symmetric(jnp.asarray(lam), 4))
    got = tdpp.elementary_symmetric(torch.from_numpy(lam), 4).numpy()
    assert got.shape == (5, 12)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("c,k", [(12, 3), (40, 10)])
def test_sampler_state_matches_jax(c, k):
    kern = _kernel(c, q=6, seed=c)
    js = jdpp.kdpp_sampler_state(jnp.asarray(kern), k)
    ts = tdpp.kdpp_sampler_state(torch.from_numpy(kern), k)
    jlam, tlam = np.asarray(js.lam), ts.lam.numpy()
    # fp32 eigh of a kernel with entries O(c): eigenvalues agree to ~1e-5 of
    # the largest; eigenvectors only up to sign, so compare V diag(λ) Vᵀ
    tol = 1e-5 * jlam.max()
    np.testing.assert_allclose(tlam, jlam, atol=tol)
    jv, tv = np.asarray(js.vecs), ts.vecs.numpy()
    np.testing.assert_allclose((tv * tlam) @ tv.T, (jv * jlam) @ jv.T, atol=tol)
    # e_l(λ_1..λ_n) inherits the eigenvalues' error on the scale of row l
    jesp = np.asarray(js.esp)
    row_scale = np.abs(jesp).max(axis=1, keepdims=True)
    assert np.all(np.abs(ts.esp.numpy() - jesp) <= 1e-4 * row_scale)
    assert ts.k == k and ts.num_items == c


def _jax_noise(key, n, k):
    """JAX's draws inside sample_kdpp_from_eigh, regenerated with the same
    split pattern: phase 1 splits once per step for a uniform, phase 2 once
    per step for a categorical (argmax of logits + Gumbel)."""
    key1, key2 = jax.random.split(key)
    uniforms = []
    for _ in range(n):
        key1, sub = jax.random.split(key1)
        uniforms.append(np.asarray(jax.random.uniform(sub)))
    gumbels = []
    for _ in range(k):
        key2, k_i = jax.random.split(key2)
        gumbels.append(np.asarray(jax.random.gumbel(k_i, (n,), jnp.float32)))
    return np.stack(uniforms), np.stack(gumbels)


@pytest.mark.parametrize("c,k", [(8, 3), (30, 5)])
def test_phases_give_identical_indices_under_jax_noise(c, k):
    kern = _kernel(c, q=7, seed=c + 1)
    js = jdpp.kdpp_sampler_state(jnp.asarray(kern), k)
    ts = tdpp.KDPPSamplerState(
        lam=torch.tensor(np.asarray(js.lam)),
        vecs=torch.tensor(np.asarray(js.vecs)),
        esp=torch.tensor(np.asarray(js.esp)),
    )
    for seed in range(12):
        key = jax.random.key(seed)
        u, g = _jax_noise(key, c, k)
        mask = tdpp._phase1_select_eigenvectors(torch.from_numpy(u), ts.lam, ts.esp, k)
        jmask = jdpp._phase1_select_eigenvectors(jax.random.split(key)[0], js.lam, js.esp, k)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        got = tdpp._sample_from_noise(torch.from_numpy(u), torch.from_numpy(g), ts, k)
        want = np.asarray(jdpp.sample_kdpp_from_eigh(key, js, k))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("c,k", [(7, 3), (25, 6)])
def test_greedy_map_gives_identical_indices(c, k):
    kern = _kernel(c, q=4, seed=2 * c)
    want = np.asarray(jdpp.greedy_map_kdpp(jnp.asarray(kern), k))
    got = tdpp.greedy_map_kdpp(torch.from_numpy(kern), k).numpy()
    np.testing.assert_array_equal(got, want)


def test_log_det_subset_matches_jax():
    kern = _kernel(9, q=5, seed=5)
    for idx in ([0, 2, 5], [1, 8], [3, 4, 6, 7]):
        want = float(jdpp.kdpp_log_prob(jnp.asarray(kern), jnp.asarray(idx)))
        got = float(tdpp.kdpp_log_prob(torch.from_numpy(kern), torch.tensor(idx)))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k,use_cache", [(2, True), (3, True), (3, False)])
def test_generator_draws_follow_the_kdpp(k, use_cache):
    """Subset frequencies of the torch.Generator path against the exact k-DPP
    law, det(L_Y) / Σ det, by enumeration (C = 6)."""
    c, ns = 6, 3000
    kern = torch.from_numpy(_kernel(c, q=5, seed=7))
    subsets = list(itertools.combinations(range(c), k))
    logp = np.array([float(tdpp.kdpp_log_prob(kern, torch.tensor(s))) for s in subsets])
    p_true = np.exp(logp - logp.max())
    p_true /= p_true.sum()
    strat = tsel.DPPSelection(use_cache=use_cache)
    state = strat.prepare(tsel.RoundState(num_clients=c, kernel=kern), k)
    gen = torch.Generator().manual_seed(k)
    counts = dict.fromkeys(subsets, 0)
    for _ in range(ns):
        draw = strat.draw_fn(gen, state, k).tolist()
        assert len(set(draw)) == k
        counts[tuple(sorted(draw))] += 1
    p_emp = np.array([counts[s] / ns for s in subsets])
    # total variation of 3000 draws over <= 20 subsets: ~0.03 expected
    assert 0.5 * np.abs(p_emp - p_true).sum() < 0.06


def test_sample_kdpp_rejects_mismatched_k():
    state = tdpp.kdpp_sampler_state(torch.from_numpy(_kernel(6)), 2)
    with pytest.raises(ValueError):
        tdpp.sample_kdpp_from_eigh(torch.Generator(), state, 3)


def test_make_strategy_names():
    """Every name of the JAX registry builds the same strategy class, and
    each draws k distinct clients through ``select``."""
    from repro.core import selection as jsel

    assert tsel.STRATEGY_NAMES == jsel.STRATEGY_NAMES
    assert isinstance(tsel.make_strategy("fedavg"), tsel.UniformSelection)
    assert tsel.make_strategy("fl-dp3s-map").mode == "map"
    assert tsel.make_strategy("power-of-choice", d=5).d == 5
    with pytest.raises(ValueError):
        tsel.make_strategy("nope")
    c, k = 9, 4
    rng = np.random.default_rng(10)
    state = tsel.RoundState(
        num_clients=c, losses=torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32)),
        kernel=torch.from_numpy(_kernel(c)), profiles=torch.from_numpy(_profiles(c, 5)),
        client_sizes=torch.full((c,), 20.0),
    )
    for name in jsel.STRATEGY_NAMES:
        strat = tsel.make_strategy(name)
        assert type(strat).__name__ == type(jsel.make_strategy(name)).__name__
        sel = strat.select(torch.Generator().manual_seed(0), state, k)
        assert sel.dtype == torch.int32 and sel.shape == (k,), name
        assert len(set(sel.tolist())) == k and all(0 <= i < c for i in sel.tolist()), name


# ------------------------------------------------ optimizers and eq. (6)


def test_sgd_and_clipping_match_jax():
    from repro import optim as joptim
    from repro_torch.optim import optimizers as toptim

    rng = np.random.default_rng(8)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32), "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    tg = {k: torch.from_numpy(v) for k, v in grads.items()}
    for max_norm in (0.5, 100.0):  # clipping active, and a no-op
        want = joptim.clip_by_global_norm(jg, max_norm)
        got = toptim.clip_by_global_norm(tg, max_norm)
        for k in grads:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
    for momentum, nesterov in ((0.0, False), (0.9, False), (0.9, True)):
        jopt, topt = joptim.sgd(0.1, momentum, nesterov), toptim.sgd(0.1, momentum, nesterov)
        js = jopt.init({k: jnp.asarray(v) for k, v in params.items()})
        ts = topt.init({k: torch.from_numpy(v) for k, v in params.items()})
        for _ in range(2):  # the second step reads the momentum state
            jupd, js = jopt.update(jg, js)
            tupd, ts = topt.update(tg, ts)
        for k in grads:
            np.testing.assert_allclose(tupd[k].numpy(), np.asarray(jupd[k]), rtol=1e-6, atol=1e-7)


def test_weighted_average_matches_jax():
    from repro.fl import rounds as jrounds
    from repro_torch.fl import rounds as trounds

    rng = np.random.default_rng(9)
    stacked = {"w": rng.normal(size=(4, 3, 2)).astype(np.float32)}
    for weights in (np.array([600.0, 20.0, 0.0, 5.0], np.float32), np.zeros(4, np.float32)):
        want = jrounds.weighted_average({"w": jnp.asarray(stacked["w"])}, jnp.asarray(weights))
        got = trounds.weighted_average({"w": torch.from_numpy(stacked["w"])}, torch.from_numpy(weights))
        # all-zero weights give 0 through safe_div, never NaN
        np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]), rtol=1e-6, atol=1e-7)
