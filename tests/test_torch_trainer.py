"""The port's data copies and the whole FL-DP³S slice against the JAX
package: ``repro.fl.trainer.FLTrainer.run_legacy`` vs
``repro_torch.fl.trainer.FLTrainer.run`` on the CPU, on the same data and
JAX-initialised weights, with JAX's cohorts handed to the port."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import selection as jsel  # noqa: E402
from repro.data import make_image_dataset as j_make_image_dataset  # noqa: E402
from repro.data import skewness_partition as j_skewness_partition  # noqa: E402
from repro.fl import engine as jengine  # noqa: E402
from repro.fl import trainer as jtrainer  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402

from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.data import make_image_dataset, skewness_partition  # noqa: E402
from repro_torch.fl import engine as tengine  # noqa: E402
from repro_torch.fl import trainer as ttrainer  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402


@pytest.mark.parametrize("seed,noise", [(0, 0.6), (11, 0.5)])
def test_image_dataset_copy_is_byte_identical(seed, noise):
    a = make_image_dataset(n=300, seed=seed, noise=noise)
    b = j_make_image_dataset(n=300, seed=seed, noise=noise)
    assert a.xs.tobytes() == b.xs.tobytes() and a.xs.dtype == b.xs.dtype
    assert a.ys.tobytes() == b.ys.tobytes() and a.num_classes == b.num_classes


@pytest.mark.parametrize("xi", [1.0, 0.8, 0.5, "H"])
def test_skewness_partition_copy_is_identical(xi):
    ys = make_image_dataset(n=400, seed=3).ys
    a = skewness_partition(ys, 12, xi, 10, samples_per_client=30, seed=5)
    b = j_skewness_partition(ys, 12, xi, 10, samples_per_client=30, seed=5)
    assert len(a) == len(b)
    for sa, sb in zip(a, b):
        assert sa.dtype == sb.dtype and sa.tobytes() == sb.tobytes()


class _RecordingDPP(jsel.DPPSelection):
    """The JAX strategy, keeping the cohort it drew each round."""

    def __init__(self):
        super().__init__()
        self.cohorts = []

    def select(self, key, state, k):
        sel = super().select(key, state, k)
        self.cohorts.append(np.asarray(sel))
        return sel


class _ReplayDPP(tsel.DPPSelection):
    """The port's strategy, handing out JAX's cohorts in order: the k-DPP
    draws of the two packages come from different generators, so the slice
    is compared on the same cohorts."""

    def __init__(self, cohorts):
        super().__init__()
        self.cohorts = list(cohorts)

    def draw_fn(self, generator, state, k):
        sel = torch.tensor(self.cohorts.pop(0), device=state.kernel.device)
        assert sel.shape == (k,)
        return sel


def test_whole_slice_matches_jax_run_legacy():
    """C=8, C_p=3, 20 samples per client, CNN (4, 8) / fc1 16, two rounds of
    full-batch GD, use_pallas_kernel=True on both sides (Pallas in interpret
    mode on the JAX side, the kernels' plain versions on the port's)."""
    c, cp, n_c, rounds = 8, 3, 20, 2
    ds = j_make_image_dataset(n=c * n_c, seed=2)
    shards = j_skewness_partition(ds.ys, c, 0.8, 10, samples_per_client=n_c, seed=0)
    cxs = np.stack([ds.xs[s] for s in shards])
    cys = np.stack([ds.ys[s] for s in shards])
    jparams = jcnn.init_cnn(jax.random.key(0), channels=(4, 8), fc1_dim=16)
    kw = dict(num_clients=c, clients_per_round=cp, local_epochs=2, lr=0.05,
              rounds=rounds, eval_every=1, seed=0, use_pallas_kernel=True)

    jstrat = _RecordingDPP()
    jt = jtrainer.FLTrainer(
        jtrainer.FLConfig(**kw), jparams, jcnn.cnn_loss, jcnn.apply_with_features,
        cxs, cys, jstrat, accuracy_fn=jcnn.accuracy,
    )
    jprof = np.asarray(jt.round_state.profiles)
    jkern = np.asarray(jt.round_state.kernel)
    jhist = jt.run_legacy()

    tt = ttrainer.FLTrainer(
        ttrainer.FLConfig(**kw),
        tcnn.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)),
        tcnn.cnn_loss, tcnn.apply_with_features, cxs, cys,
        _ReplayDPP(jstrat.cohorts), accuracy_fn=tcnn.accuracy, device="cpu",
    )
    # profiles and kernel: fp32 sums of the same terms in another order
    np.testing.assert_allclose(tt.round_state.profiles.numpy(), jprof, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tt.round_state.kernel.numpy(), jkern, rtol=1e-5, atol=1e-5)
    thist = tt.run()

    # two rounds of SGD on fp32 gradients whose conv sums differ in order
    want = tcnn.params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params))
    for name, w in want.items():
        np.testing.assert_allclose(tt.params[name].numpy(), w.numpy(), atol=1e-4, err_msg=name)
    assert thist["round"] == jhist["round"] == [1, 2]
    # accuracy is a count of argmax hits: equal unless a logit pair ties
    assert thist["acc"] == jhist["acc"]
    np.testing.assert_allclose(thist["gemd"], jhist["gemd"], atol=1e-6)  # same cohorts
    np.testing.assert_allclose(thist["loss"], jhist["loss"], atol=1e-5)
    np.testing.assert_allclose(tt.losses.numpy(), np.asarray(jt.losses), atol=1e-5)


@pytest.mark.parametrize(
    "batch,replace,n_c", [(None, False, 10), (4, False, 10), (16, False, 10), (3, True, 10)]
)
def test_batch_plan_matches_jax_on_the_same_indices(batch, replace, n_c):
    """``batches_from_indices`` slices as the JAX helper does, given one
    index plan (the plans themselves come from different generators)."""
    kw = dict(local_epochs=2, local_batch_size=batch, sample_with_replacement=replace)
    jcfg, tcfg = jengine.FLConfig(**kw), tengine.FLConfig(**kw)
    assert tengine._steps_per_round(tcfg, n_c) == jengine._steps_per_round(jcfg, n_c)
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(3, n_c, 2, 2, 1)).astype(np.float32)
    ys = rng.integers(0, 10, size=(3, n_c)).astype(np.int32)
    plan = tengine.batch_indices_from_keys(tcfg, torch.Generator().manual_seed(0), 3, n_c)
    if batch is None:
        assert plan is None
        ids = None
    else:
        ids = plan.numpy()
        if replace:
            assert ids.shape == (3, tengine._steps_per_round(tcfg, n_c), batch)
        else:
            assert all(sorted(row) == list(range(n_c)) for row in ids.tolist())
    want = jengine.batches_from_indices(jcfg, None if ids is None else jnp.asarray(ids), xs, ys)
    got = tengine.batches_from_indices(
        tcfg, None if ids is None else torch.from_numpy(ids), torch.from_numpy(xs), torch.from_numpy(ys)
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_minibatch_trainer_runs_and_continues_rounds():
    """Minibatch SGD through the port's trainer on the CPU (uniform cohorts),
    with round numbers continuing across ``run`` calls."""
    c, n_c = 6, 12
    ds = make_image_dataset(n=c * n_c, seed=4)
    shards = skewness_partition(ds.ys, c, 0.5, 10, samples_per_client=n_c, seed=1)
    cfg = ttrainer.FLConfig(num_clients=c, clients_per_round=2, local_epochs=1,
                            local_batch_size=5, lr=0.05, rounds=2, eval_every=2, seed=3)
    params = tcnn.init_cnn(torch.Generator().manual_seed(3), channels=(2, 4), fc1_dim=8)
    tt = ttrainer.FLTrainer(
        cfg, params, tcnn.cnn_loss, tcnn.apply_with_features,
        np.stack([ds.xs[s] for s in shards]), np.stack([ds.ys[s] for s in shards]),
        tsel.make_strategy("fedavg"), accuracy_fn=tcnn.accuracy, device="cpu",
    )
    assert tt.run()["round"] == [2]
    hist = tt.run(rounds=3)
    assert hist["round"] == [2, 4, 5]
    assert np.isfinite(hist["loss"]).all() and all(0.0 <= a <= 1.0 for a in hist["acc"])
