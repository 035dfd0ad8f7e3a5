"""The paper's baseline selection strategies (FedSAE, power-of-choice,
clustered sampling) and the Fig.-3 gradient profiles of the port against
the JAX package on the CPU: each draw given JAX's noise, the clustering,
the profiles, and two rounds of ``FLTrainer`` against JAX ``run_legacy``
for each baseline."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import profiles as jprof  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.data import make_image_dataset, skewness_partition  # noqa: E402
from repro.fl import trainer as jtrainer  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402

from repro_torch.core import profiles as tprof  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.fl import trainer as ttrainer  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402


def _losses(c, seed):
    return np.random.default_rng(seed).uniform(0.1, 3.0, size=c).astype(np.float32)


def _states(c, k, losses=None, sizes=None, labels=None):
    """The same server knowledge as a JAX and a port SelectionState."""
    kw = {}
    if losses is not None:
        kw["losses"] = losses
    if sizes is not None:
        kw["client_sizes"] = sizes
    if labels is not None:
        kw["cluster_labels"] = labels
    js = jsel.selection_state(c, k, **{n: jnp.asarray(v) for n, v in kw.items()})
    ts = tsel.selection_state(c, k, **{n: torch.from_numpy(v) for n, v in kw.items()})
    return js, ts


# ---------------------------------------------------------- draws on noise


@pytest.mark.parametrize("c,k", [(10, 3), (50, 10)])
def test_fedsae_draw_on_jax_noise(c, k):
    js, ts = _states(c, k, losses=_losses(c, c))
    strat = tsel.FedSAESelection()
    for seed in range(20):
        key = jax.random.key(seed)
        want = np.asarray(jsel.FedSAESelection().draw_fn(key, js, k))
        g = torch.tensor(np.asarray(jax.random.gumbel(key, (c,), jnp.float32)))
        got = strat.draw_from_noise(g, ts, k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("known", [True, False])
@pytest.mark.parametrize("c,k,d", [(12, 3, 30), (50, 10, 30), (40, 4, 6)])
def test_power_of_choice_draw_on_jax_candidates(c, k, d, known):
    """Given JAX's candidates, the top k by loss; with unknown losses
    ``prepare`` feeds zeros and the stable sort keeps the candidate order."""
    losses = _losses(c, c + d) if known else None
    jstrat, tstrat = jsel.PowerOfChoiceSelection(d=d), tsel.PowerOfChoiceSelection(d=d)
    js = jstrat.prepare(
        jsel.RoundState(num_clients=c, losses=None if losses is None else jnp.asarray(losses)), k
    )
    ts = tstrat.prepare(
        tsel.RoundState(
            num_clients=c, losses=None if losses is None else torch.from_numpy(losses),
            client_sizes=torch.ones(c),
        ), k,
    )
    np.testing.assert_array_equal(ts.losses.numpy(), np.asarray(js.losses))
    for seed in range(20):
        key = jax.random.key(seed)
        want = np.asarray(jstrat.draw_fn(key, js, k))
        cand = jax.random.choice(jax.random.split(key)[0], c, shape=(min(d, c),), replace=False)
        got = tstrat.draw_from_noise(torch.tensor(np.asarray(cand)), ts, k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        if not known:
            np.testing.assert_array_equal(got.numpy(), np.asarray(cand)[:k])


def _cluster_gumbels(key, k, c):
    """The Gumbel rows of JAX's vmapped ``jax.random.categorical``: one per
    split key."""
    return np.stack([np.asarray(jax.random.gumbel(kk, (c,), jnp.float32))
                     for kk in jax.random.split(key, k)])


@pytest.mark.parametrize(
    "c,k,empty", [(12, 3, False), (40, 8, False), (10, 4, True)]
)
def test_cluster_draw_on_jax_noise(c, k, empty):
    """One client per cluster ∝ n_c given JAX's noise; with an empty cluster
    (label k-1 unused) that row falls back to all clients."""
    rng = np.random.default_rng(c)
    labels = rng.integers(0, k - 1 if empty else k, size=c).astype(np.int32)
    labels[: k - int(empty)] = np.arange(k - int(empty))  # every other cluster non-empty
    sizes = rng.integers(1, 100, size=c).astype(np.float32)
    js, ts = _states(c, k, sizes=sizes, labels=labels)
    strat = tsel.ClusterSelection()
    for seed in range(20):
        key = jax.random.key(seed)
        want = np.asarray(jsel.ClusterSelection().draw_fn(key, js, k))
        got = strat.draw_from_noise(torch.from_numpy(_cluster_gumbels(key, k, c)), ts, k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        for row, pick in enumerate(got.tolist()[: k - int(empty)]):
            assert labels[pick] == row


@pytest.mark.parametrize("c,k,g", [(20, 4, 6), (37, 10, 16), (3, 5, 4), (60, 6, 1280)])
def test_cluster_fit_gives_jax_labels(c, k, g):
    """``_cluster`` is a verbatim copy: the same fingerprints give the same
    labels (C < k leaves clusters empty); ``fit`` caches on content."""
    rng = np.random.default_rng(g)
    centres = rng.normal(size=(k, g))
    feats = (centres[rng.integers(0, k, size=c)] + 0.3 * rng.normal(size=(c, g))).astype(np.float32)
    want = np.asarray(jsel.ClusterSelection().fit(jnp.asarray(feats), k))
    strat = tsel.ClusterSelection()
    got = strat.fit(torch.from_numpy(feats), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(got.tolist())) == min(c, k)
    assert strat.fit(torch.from_numpy(feats.copy()), k) is not None and strat._fingerprint[2]
    moved = feats.copy()
    moved[0] = -moved[0]
    np.testing.assert_array_equal(
        strat.fit(torch.from_numpy(moved), k).numpy(),
        np.asarray(jsel.ClusterSelection().fit(jnp.asarray(moved), k)),
    )


@pytest.mark.parametrize("name", ["fedsae", "power-of-choice", "cluster"])
def test_generator_draws_are_valid_cohorts(name):
    c, k = 30, 6
    rng = np.random.default_rng(1)
    state = tsel.RoundState(
        num_clients=c, losses=torch.from_numpy(_losses(c, 2)),
        client_sizes=torch.from_numpy(rng.integers(1, 50, size=c).astype(np.float32)),
        profiles=torch.from_numpy(rng.normal(size=(c, 8)).astype(np.float32)),
    )
    # power-of-choice over d < C candidates: with d = C the top k by loss
    # would be the same cohort every time
    strat = tsel.make_strategy(name, **({"d": 10} if name == "power-of-choice" else {}))
    gen = torch.Generator().manual_seed(0)
    draws = [strat.select(gen, state, k).tolist() for _ in range(50)]
    for d in draws:
        assert len(set(d)) == k and all(0 <= i < c for i in d)
    assert len({tuple(d) for d in draws}) > 1  # the generator moves on


# ------------------------------------------------------ gradient profiles


def _cnn_case(channels, fc1, n, seed):
    ds = make_image_dataset(n=n, seed=seed)
    jparams = jcnn.init_cnn(jax.random.key(seed), channels=channels, fc1_dim=fc1)
    tparams = tcnn.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return ds.xs, ds.ys, jparams, tparams


@pytest.mark.parametrize(
    "channels,fc1,n,length,rep",
    [((4, 8), 16, 24, 4096, 160), ((16, 32), 128, 8, 4096, 1280)],
)
def test_gradient_profiles_match_jax(channels, fc1, n, length, rep):
    """Both Fig.-3 profiles, element by element, in JAX's leaf order and
    layouts.  (4, 8)/16 has 6,882 gradient entries (stride 1); the paper's
    widths 215,370 (stride 52).  The CNN has no "out" leaf, so the
    representative profile is FC-2's weight, (in, out)."""
    xs, ys, jparams, tparams = _cnn_case(channels, fc1, n, seed=len(channels) + fc1)
    args_j = (jcnn.cnn_loss, jparams, jnp.asarray(xs), jnp.asarray(ys))
    args_t = (tcnn.cnn_loss, tparams, torch.from_numpy(xs), torch.from_numpy(ys))
    for jfn, tfn, size in (
        (jprof.gradient_profile, tprof.gradient_profile, length),
        (jprof.representative_gradient_profile, tprof.representative_gradient_profile, rep),
    ):
        want = np.asarray(jfn(*args_j))
        got = tfn(*args_t, layout=tcnn.params_to_jax).numpy()
        assert got.shape == want.shape == (min(size, want.size),)
        # fp32 conv gradients summed in another order
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    if fc1 == 128:
        total = sum(x.size for x in jax.tree_util.tree_leaves(jparams))
        assert (total, total // 4096) == (215370, 52)
    # the port's own dict order and layouts give another strided profile
    other = tprof.gradient_profile(*args_t).numpy()
    assert other.shape == (length,) and not np.allclose(other, np.asarray(jprof.gradient_profile(*args_j)))


def test_params_to_jax_inverts_params_from_jax():
    jparams = jcnn.init_cnn(jax.random.key(3), channels=(4, 8), fc1_dim=16)
    nested = jax.tree_util.tree_map(np.asarray, jparams)
    back = tcnn.params_to_jax(tcnn.params_from_jax(nested))
    assert sorted(back) == sorted(nested)
    for name in nested:
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(back[name][leaf].numpy(), nested[name][leaf])


# ------------------------------------------------------------- the slice


def _recording(base):
    class Recording(base):
        """The JAX strategy, keeping each draw's key, prepared state and cohort."""

        def __init__(self):
            super().__init__()
            self.draws = []

        def select(self, key, state, k):
            prepared = self.prepare(state, k)
            sel = self.select_fn(key, prepared, k)
            self.draws.append(dict(
                key=key, losses=np.asarray(prepared.losses),
                labels=np.asarray(prepared.cluster_labels), sel=np.asarray(sel),
            ))
            return sel

    return Recording()


def _replaying(base, draws, noise_of):
    class Replay(base):
        """The port's strategy: at each draw its prepared state must be
        JAX's, and its draw on JAX's noise must give JAX's cohort."""

        def __init__(self):
            super().__init__()
            self.draws = list(draws)

        def draw_fn(self, generator, state, k):
            rec = self.draws.pop(0)
            np.testing.assert_allclose(state.losses.numpy(), rec["losses"], rtol=0, atol=1e-5)
            np.testing.assert_array_equal(state.cluster_labels.numpy(), rec["labels"])
            sel = self.draw_from_noise(noise_of(rec["key"], state, k), state, k)
            np.testing.assert_array_equal(sel.numpy(), rec["sel"])
            return sel

    return Replay()


NOISE = {
    "fedsae": lambda key, state, k: torch.tensor(
        np.asarray(jax.random.gumbel(key, (state.num_clients,), jnp.float32))
    ),
    "power-of-choice": lambda key, state, k: torch.tensor(np.asarray(
        jax.random.choice(jax.random.split(key)[0], state.num_clients,
                          shape=(min(30, state.num_clients),), replace=False)
    )),
    "cluster": lambda key, state, k: torch.from_numpy(_cluster_gumbels(key, k, state.num_clients)),
}


@pytest.mark.parametrize("name", ["fedsae", "power-of-choice", "cluster"])
def test_baseline_slice_matches_jax_run_legacy(name):
    """C=8, C_p=3, 20 samples per client, CNN (4, 8) / fc1 16, two rounds,
    built like test_torch_trainer's whole-slice test: the port's trainer
    prepares the same state as JAX's ``run_legacy`` at every draw (losses,
    cluster labels on representative gradients), draws JAX's cohort on
    JAX's noise, and ends with the same parameters and history."""
    c, cp, n_c, rounds = 8, 3, 20, 2
    ds = make_image_dataset(n=c * n_c, seed=2)
    shards = skewness_partition(ds.ys, c, 0.8, 10, samples_per_client=n_c, seed=0)
    cxs = np.stack([ds.xs[s] for s in shards])
    cys = np.stack([ds.ys[s] for s in shards])
    jparams = jcnn.init_cnn(jax.random.key(0), channels=(4, 8), fc1_dim=16)
    kw = dict(num_clients=c, clients_per_round=cp, local_epochs=2, lr=0.05,
              rounds=rounds, eval_every=1, seed=0, use_pallas_kernel=True)

    jbase = type(jsel.make_strategy(name))
    jstrat = _recording(jbase)
    jt = jtrainer.FLTrainer(
        jtrainer.FLConfig(**kw), jparams, jcnn.cnn_loss, jcnn.apply_with_features,
        cxs, cys, jstrat, accuracy_fn=jcnn.accuracy,
    )
    jgrad = jt.round_state.grad_profiles
    jhist = jt.run_legacy()
    assert len(jstrat.draws) == rounds

    tbase = type(tsel.make_strategy(name))
    tt = ttrainer.FLTrainer(
        ttrainer.FLConfig(**kw),
        tcnn.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)),
        tcnn.cnn_loss, tcnn.apply_with_features, cxs, cys,
        _replaying(tbase, jstrat.draws, NOISE[name]), accuracy_fn=tcnn.accuracy,
        device="cpu",
    )
    if name == "cluster":
        want = np.asarray(jgrad)
        assert want.shape == (c, 16 * 10)
        # the port's fingerprint is FC-2's weight gradient as (out, in), JAX's
        # as (in, out): the same entries, transposed alike for every client
        got = tt.round_state.grad_profiles.numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(
            got.reshape(c, 10, 16).transpose(0, 2, 1).reshape(c, -1), want,
            rtol=0, atol=1e-5 * np.abs(want).max(),
        )
        assert len(set(jstrat.draws[0]["labels"].tolist())) == cp
    else:
        assert jgrad is None and tt.round_state.grad_profiles is None
    thist = tt.run()
    assert not tt.strategy.draws  # every JAX draw was replayed

    want = tcnn.params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params))
    for pname, w in want.items():
        np.testing.assert_allclose(tt.params[pname].numpy(), w.numpy(), atol=1e-4, err_msg=pname)
    assert thist["round"] == jhist["round"] == [1, 2]
    # accuracy is a count of argmax hits over 160 samples (one hit is
    # 1/160); the two frameworks round count / n to fp32 differently
    np.testing.assert_allclose(thist["acc"], jhist["acc"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(thist["gemd"], jhist["gemd"], atol=1e-6)
    np.testing.assert_allclose(thist["loss"], jhist["loss"], atol=1e-5)
    np.testing.assert_allclose(tt.losses.numpy(), np.asarray(jt.losses), atol=1e-5)


def test_reprofile_refits_the_clusters():
    """``reprofile_every`` recomputes the representative gradients on the
    current parameters, and the next draw's labels are fitted on them."""
    c, n_c = 8, 10
    ds = make_image_dataset(n=c * n_c, seed=4)
    shards = skewness_partition(ds.ys, c, 0.5, 10, samples_per_client=n_c, seed=1)
    cfg = ttrainer.FLConfig(num_clients=c, clients_per_round=3, local_epochs=1, lr=0.5,
                            rounds=2, eval_every=1, seed=0, reprofile_every=1)
    params = tcnn.init_cnn(torch.Generator().manual_seed(0), channels=(2, 4), fc1_dim=8)
    strat = tsel.ClusterSelection()
    tt = ttrainer.FLTrainer(
        cfg, params, tcnn.cnn_loss, tcnn.apply_with_features,
        np.stack([ds.xs[s] for s in shards]), np.stack([ds.ys[s] for s in shards]),
        strat, device="cpu",
    )
    first = tt.round_state.grad_profiles.clone()
    fp0 = (tt.selection_state(), strat._fingerprint)[1]
    tt.run(rounds=1)
    assert not torch.equal(tt.round_state.grad_profiles, first)
    labels = tt.selection_state().cluster_labels
    assert strat._fingerprint != fp0
    np.testing.assert_array_equal(
        labels.numpy(), tsel.ClusterSelection._cluster(tt.round_state.grad_profiles.numpy(), 3)
    )
