"""The port's batch pipeline (``repro_torch.data.pipeline``) against the
JAX package's ``repro.data.pipeline``: the same batches, byte for byte,
for the same seed."""

import itertools

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import pipeline as jpipe  # noqa: E402

from repro_torch.data import pipeline as tpipe  # noqa: E402


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_batches_equal_jax_byte_for_byte(seed):
    """Three epochs and a ragged tail dropped: ``batch_iterator``'s first
    batches, and one ``epoch_batches`` pass from a generator of the seed."""
    rng = np.random.default_rng(100 + seed)
    xs = rng.normal(size=(53, 4, 3)).astype(np.float32)
    ys = rng.integers(0, 10, size=53).astype(np.int32)
    want = list(itertools.islice(jpipe.batch_iterator(xs, ys, 8, seed=seed), 20))
    got = list(itertools.islice(tpipe.batch_iterator(xs, ys, 8, seed=seed), 20))
    assert len(got) == len(want) == 20
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.tobytes() == wx.tobytes() and gy.tobytes() == wy.tobytes() and gx.shape == (8, 4, 3)
    one = list(tpipe.epoch_batches(xs, ys, 10, np.random.default_rng(seed)))
    ref = list(jpipe.epoch_batches(xs, ys, 10, np.random.default_rng(seed)))
    assert len(one) == len(ref) == 5  # 53 // 10
    assert all(a[0].tobytes() == b[0].tobytes() and a[1].tobytes() == b[1].tobytes() for a, b in zip(one, ref))
