"""The port's CNN and FC-1 profiles (``repro_torch.models.cnn``,
``repro_torch.core.profiles``) against ``repro.models.cnn`` and
``repro.core.profiles`` with JAX-initialised weights carried across by
``params_from_jax``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import profiles as jprofiles  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402

from repro_torch.core import profiles as tprofiles  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

CHANNELS, FC1 = (4, 8), 16


def _jax_params(scheme="kaiming_uniform", seed=0):
    p = jcnn.init_cnn(jax.random.key(seed), channels=CHANNELS, fc1_dim=FC1, scheme=scheme)
    return p, tcnn.params_from_jax(jax.tree_util.tree_map(np.asarray, p))


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 28, 28, 1)).astype(np.float32), rng.integers(0, 10, n).astype(np.int32)


@pytest.mark.parametrize("scheme", list(jcnn.INIT_SCHEMES))
def test_params_from_jax_forward_matches(scheme):
    jp, tp = _jax_params(scheme, seed=1)
    assert tp["conv1.weight"].shape == (CHANNELS[0], 1, 5, 5)
    assert tp["fc1.weight"].shape == (FC1, 7 * 7 * CHANNELS[1])
    tcnn.CNN(channels=CHANNELS, fc1_dim=FC1).load_state_dict(tp)  # the module's own names
    x, _ = _images(6)
    jl, jf = jcnn.apply_with_features(jp, jnp.asarray(x))
    tl, tf = tcnn.apply_with_features(tp, torch.from_numpy(x))
    # fp32 convolutions and products summed in another order
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-5)


@pytest.mark.parametrize("scheme", list(jcnn.INIT_SCHEMES))
def test_init_cnn_follows_the_scheme(scheme):
    """The port's own init draws other numbers than JAX from the same law:
    each layer's standard deviation is the scheme's (fan-in/fan-out from the
    JAX layouts) within 5 standard errors, and uniform draws stay in bounds."""
    tp = tcnn.init_cnn(torch.Generator().manual_seed(2), channels=CHANNELS, fc1_dim=FC1, scheme=scheme)
    fans = {  # (fan_in, fan_out) of the JAX HWIO / (in, out) shapes
        "conv1": (25, 25 * CHANNELS[0]),
        "conv2": (25 * CHANNELS[0], 25 * CHANNELS[1]),
        "fc1": (7 * 7 * CHANNELS[1], FC1),
        "fc2": (FC1, 10),
    }
    for name, (fan_in, fan_out) in fans.items():
        w = tp[f"{name}.weight"]
        assert torch.all(tp[f"{name}.bias"] == 0)
        var = 2.0 / fan_in if scheme.startswith("kaiming") else 2.0 / (fan_in + fan_out)
        std = np.sqrt(var)
        if scheme.endswith("uniform"):
            assert float(w.abs().max()) <= np.sqrt(3.0) * std * (1 + 1e-6)
        assert abs(float(w.std()) - std) <= 5 * std / np.sqrt(2 * w.numel())


def test_loss_and_gradient_match_jax():
    jp, tp = _jax_params(seed=3)
    x, y = _images(12, seed=3)
    jl, jg = jax.value_and_grad(jcnn.cnn_loss)(jp, jnp.asarray(x), jnp.asarray(y))
    p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tl = tcnn.cnn_loss(p, torch.from_numpy(x), torch.from_numpy(y))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    want = tcnn.params_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    for name, g in want.items():
        # rtol 1e-5 on each entry; entries near 0 get 1e-6 of the leaf's scale
        scale = float(g.abs().max())
        np.testing.assert_allclose(p[name].grad.numpy(), g.numpy(), rtol=1e-5, atol=1e-6 * scale, err_msg=name)


@pytest.mark.parametrize("n,batch", [(10, 4), (8, 8), (3, 2048)])
def test_accuracy_matches_jax_with_padded_tail(n, batch):
    jp, tp = _jax_params(seed=4)
    x, _ = _images(n, seed=4)
    # labels = the model's own argmax on half the samples: a non-trivial count
    pred = np.asarray(jnp.argmax(jcnn.apply_cnn(jp, jnp.asarray(x)), -1)).astype(np.int32)
    y = np.where(np.arange(n) % 2 == 0, pred, (pred + 1) % 10).astype(np.int32)
    want = float(jcnn.accuracy(jp, jnp.asarray(x), jnp.asarray(y), batch_size=batch))
    got = float(tcnn.accuracy(tp, torch.from_numpy(x), torch.from_numpy(y), batch_size=batch))
    assert got == want
    np.testing.assert_allclose(got, np.ceil(n / 2) / n, rtol=1e-6)


def test_fc1_profiles_match_jax():
    jp, tp = _jax_params(seed=5)
    x, _ = _images(21, seed=5)
    clients = [x[:9], x[9:]]  # 9 samples: a short last batch of 4
    want = np.asarray(
        jprofiles.profile_all_clients(jcnn.apply_with_features, jp, [jnp.asarray(c) for c in clients], batch_size=4)
    )
    got = tprofiles.profile_all_clients(
        tcnn.apply_with_features, tp, [torch.from_numpy(c) for c in clients], batch_size=4
    ).numpy()
    assert got.shape == (2, FC1)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_fc1_profile_empty_client_is_the_zero_row():
    """An empty client's profile is the zero row of width Q, for the CNN (the
    JAX CNN cannot run an empty batch: its flatten is ``reshape(0, -1)``)
    and, against JAX, for the linear feature map of the JAX test."""
    _, tp = _jax_params(seed=6)
    x, _ = _images(5, seed=6)
    got = tprofiles.profile_all_clients(
        tcnn.apply_with_features, tp, [torch.from_numpy(x), torch.from_numpy(x[:0])]
    )
    assert got.shape == (2, FC1) and torch.all(got[1] == 0.0) and torch.all(torch.isfinite(got))

    w = np.random.default_rng(6).normal(size=(7, 5)).astype(np.float32)
    data = [np.zeros((0, 7), np.float32), np.ones((3, 7), np.float32)]
    want = jprofiles.profile_all_clients(
        lambda p, v: (v @ p, v @ p), jnp.asarray(w), [jnp.asarray(d) for d in data]
    )
    got = tprofiles.profile_all_clients(
        lambda p, v: (v @ p, v @ p), torch.from_numpy(w), [torch.from_numpy(d) for d in data]
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert torch.all(got[0] == 0.0)
