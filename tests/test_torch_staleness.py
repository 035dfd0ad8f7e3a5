"""The port's bounded-staleness primitives (``fl/staleness.py``) against the
JAX package's on the same numpy inputs: the decay families (λ within 1e-7,
the normalised weights within 3 ulps, with JAX's hypothesis property), the ring
buffer, the counter dynamics, the slots read and the simulated wall clock
(integers exact), and the config's checks of the staleness fields."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.fl import staleness as jst  # noqa: E402

from repro_torch.fl import engine as tengine  # noqa: E402
from repro_torch.fl import staleness as tst  # noqa: E402
from repro_torch.launch.mesh import make_client_mesh  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("family", tst.DECAY_FAMILIES)
@pytest.mark.parametrize("alpha", [0.0, 0.3, 0.7, 2.5])
def test_decay_weights_match_jax(family, alpha):
    s = np.arange(13, dtype=np.int32)
    lam = tst.decay_weights(_t(s), family, alpha)
    assert lam.dtype == torch.float32
    np.testing.assert_allclose(lam.numpy(), np.asarray(jst.decay_weights(jnp.asarray(s), family, alpha)),
                               rtol=0, atol=1e-7)
    assert float(lam[0]) == 1.0 and bool(torch.all(lam > 0)) and bool(torch.all(torch.diff(lam) <= 1e-7))
    # the normalised weights divide by Σλ, summed in another order than
    # XLA's: within 3 fp32 ulps of JAX's
    norm = tst.normalized_decay_weights(_t(s), family, alpha)
    np.testing.assert_allclose(
        norm.numpy(), np.asarray(jst.normalized_decay_weights(jnp.asarray(s), family, alpha)), rtol=3e-7, atol=0
    )


def test_decay_weights_unknown_family():
    with pytest.raises(ValueError, match="unknown staleness decay"):
        tst.decay_weights(torch.arange(3), "bogus", 0.5)


def test_normalized_decay_weights_property():
    """JAX's hypothesis property: the normalised weights are a distribution
    for every family, rate and staleness vector, and equal JAX's."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=40, deadline=None)
    @given(
        family=st.sampled_from(tst.DECAY_FAMILIES),
        alpha=st.floats(0.0, 5.0, allow_nan=False),
        svec=st.lists(st.integers(0, 12), min_size=1, max_size=16),
    )
    def check(family, alpha, svec):
        w = tst.normalized_decay_weights(torch.tensor(svec, dtype=torch.int32), family, alpha).numpy()
        assert np.all(w >= 0) and np.isclose(w.sum(), 1.0, atol=1e-5)
        want = np.asarray(jst.normalized_decay_weights(jnp.asarray(svec, jnp.int32), family, alpha))
        np.testing.assert_allclose(w, want, rtol=3e-7, atol=0)

    check()


@pytest.mark.parametrize("bound", [0, 1, 2, 3])
def test_ring_buffer_matches_jax(bound):
    """init, writes of rounds 1..6 and every reachable read: the same slots
    and the same snapshots as JAX's ring, exactly."""
    rng = np.random.default_rng(bound)
    p0 = {"w": rng.normal(size=(3, 2)).astype(np.float32), "b": rng.normal(size=(2,)).astype(np.float32)}
    th = tst.init_param_hist({k: _t(v) for k, v in p0.items()}, bound)
    jh = jst.init_param_hist({k: jnp.asarray(v) for k, v in p0.items()}, bound)
    assert th["w"].shape == (bound + 1, 3, 2)
    for t in range(1, 7):
        p = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
        before = {k: v.clone() for k, v in th.items()}
        th = tst.update_param_hist(th, {k: _t(v) for k, v in p.items()}, t, bound)
        jh = jst.update_param_hist(jh, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(t), bound)
        for k in p0:
            np.testing.assert_array_equal(th[k].numpy(), np.asarray(jh[k]))
            assert torch.equal(before[k], before[k])  # the old ring is left as it was
        for s in range(min(t + 1, bound) + 1):
            svec = np.array([s, 0, min(s, bound)], np.int32)
            got = tst.read_slots(t, _t(svec), bound)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(jst.read_slots(jnp.asarray(t), jnp.asarray(svec), bound)))


def test_ring_reads_round_t_minus_s():
    th = tst.init_param_hist({"w": torch.arange(4.0)}, bound=2)
    for t in range(1, 5):
        th = tst.update_param_hist(th, {"w": torch.full((4,), float(t))}, t, bound=2)
    for s in range(3):
        slot = int(tst.read_slots(4, torch.tensor([s]), bound=2)[0])
        assert float(th["w"][slot, 0]) == 4.0 - s


@pytest.mark.parametrize("bound", [0, 1, 2, 4])
def test_staleness_step_matches_jax(bound):
    rng = np.random.default_rng(10 + bound)
    s = np.zeros((5,), np.int32)
    for _ in range(12):
        slow = rng.uniform(size=5) < 0.6
        ts, tf = tst.staleness_step(_t(s), _t(slow), bound)
        js, jf = jst.staleness_step(jnp.asarray(s), jnp.asarray(slow), bound)
        assert ts.dtype == torch.int32 and tf.dtype == torch.bool
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        assert int(ts.max()) <= bound
        s = ts.numpy()
    new_s, forced = tst.staleness_step(torch.tensor([0, 1, 2, 2, 0], dtype=torch.int32),
                                       torch.tensor([False, True, True, False, True]), bound=2)
    assert new_s.tolist() == [0, 2, 0, 0, 1] and forced.tolist() == [False, False, True, False, False]


def test_round_sim_time_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(10):
        lat = rng.pareto(1.1, size=4).astype(np.float32) + 0.5
        slow = lat > 2.0
        forced = slow & (rng.uniform(size=4) < 0.5)
        got = tst.round_sim_time(_t(lat), _t(slow), _t(forced), 2.0)
        want = jst.round_sim_time(jnp.asarray(lat), jnp.asarray(slow), jnp.asarray(forced), 2.0)
        assert float(got) == float(want)
    lat = torch.tensor([0.5, 3.0, 9.0])
    slow = torch.tensor([False, True, True])
    assert float(tst.round_sim_time(lat, slow, torch.zeros(3, dtype=torch.bool), 2.0)) == 2.0
    assert float(tst.round_sim_time(lat, slow, torch.tensor([False, False, True]), 2.0)) == 9.0


def test_init_staleness_fields_needs_a_mesh():
    params = {"w": torch.ones(3)}
    with pytest.raises(ValueError, match="requires a client mesh"):
        tst.init_staleness_fields(params, 2, None)
    hist, s = tst.init_staleness_fields(params, 2, make_client_mesh(1, "cpu"))
    assert hist["w"].shape == (3, 3) and s.dtype == torch.int32 and s.tolist() == [0]


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(staleness_bound=1, cohort_cap=2, scenario="heavy_tail"), "incompatible"),
        (dict(staleness_bound=1), "requires a latency scenario"),
        (dict(staleness_bound=-1, scenario="heavy_tail"), "must be >= 0"),
        (dict(staleness_bound=1, scenario="heavy_tail", staleness_decay="bogus"), "unknown staleness_decay"),
        (dict(staleness_bound=1, scenario="heavy_tail", staleness_alpha=-0.1), "staleness_alpha"),
    ],
)
def test_flconfig_checks_staleness_as_jax(kw, match):
    from repro.fl import engine as jengine

    with pytest.raises(ValueError, match=match):
        tengine.FLConfig(**kw)
    with pytest.raises(ValueError):
        jengine.FLConfig(**kw)
