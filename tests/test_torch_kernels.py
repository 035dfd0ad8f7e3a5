"""The port's K1/K2 pipeline (``repro_torch.kernels``) against the JAX
package's Pallas kernels, run in interpret mode on the CPU as the JAX tests
run them.  On the CPU the port's wrappers run their plain versions; the
CUDA kernels themselves are held against those plain versions by
``tests/test_torch_cuda.py`` on a card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.gram import ops as jgram  # noqa: E402
from repro.kernels.pairwise_l2.pairwise_l2 import pairwise_dists_stats_kernel  # noqa: E402

from repro_torch.kernels.gram import ops as tgram  # noqa: E402
from repro_torch.kernels.gram import ref as tgram_ref  # noqa: E402
from repro_torch.kernels.pairwise_l2 import ops as tpw  # noqa: E402

SHAPES = [(4, 3), (10, 7), (100, 128), (130, 257), (257, 33)]


def _profiles(c, q, seed=0):
    return np.random.default_rng(seed).normal(size=(c, q)).astype(np.float32)


@pytest.mark.parametrize("c,q", [(130, 37), (100, 128), (5, 300)])
def test_pairwise_dists_stats_matches_pallas(c, q):
    f = _profiles(c, q)
    js0, jlo, jhi = pairwise_dists_stats_kernel(jnp.asarray(f), interpret=True)
    s0, lo, hi = tpw.pairwise_dists_stats(torch.from_numpy(f))
    assert s0.shape == (c, c) and s0.dtype == torch.float32
    assert float(lo) == float(jlo) == 0.0  # the diagonal pin makes min(S0) exactly 0
    # fp32 expansion sums in another order: ~1e-6 relative on distances of O(10)
    np.testing.assert_allclose(float(hi), float(jhi), rtol=1e-5)
    np.testing.assert_allclose(
        s0.numpy(), np.asarray(js0)[:c, :c], rtol=1e-5, atol=1e-5 * float(jhi)
    )
    assert np.all(np.diag(s0.numpy()) == 0.0)


@pytest.mark.parametrize("c,q", SHAPES)
def test_kernel_from_profiles_matches_pallas_fp32(c, q):
    f = _profiles(c, q)
    want = np.asarray(jgram.kernel_from_profiles(jnp.asarray(f)))
    got = tgram.kernel_from_profiles(torch.from_numpy(f), device="cpu")
    # the JAX fused-kernel test's own fp32 bound
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c,q", SHAPES)
def test_candidate_kernel_from_profiles_matches_pallas_fp32(c, q):
    f = _profiles(c, q, seed=1)
    want = np.asarray(jgram.candidate_kernel_from_profiles(jnp.asarray(f)))
    got = tgram.candidate_kernel_from_profiles(torch.from_numpy(f), device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c,q", SHAPES)
def test_kernel_from_profiles_matches_pallas_bf16(c, q):
    f = _profiles(c, q, seed=2)
    f_bf16 = jnp.asarray(f).astype(jnp.bfloat16)
    want = np.asarray(jgram.kernel_from_profiles(f_bf16))
    got = tgram.kernel_from_profiles(
        torch.from_numpy(f).to(torch.bfloat16), device="cpu"
    ).numpy()
    # the JAX bf16 test's bound: S rounded to bf16 on both sides, but a
    # distance near a rounding boundary can round the other way
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2 * np.abs(want).max())


def test_candidate_q_equals_c_is_the_unfunneled_kernel():
    f = torch.from_numpy(_profiles(37, 21, seed=3))
    a = tgram.kernel_from_profiles(f, device="cpu")
    b = tgram.candidate_kernel_from_profiles(f, device="cpu")
    assert torch.equal(a, b)


def test_pipeline_matches_plain_chain():
    f = torch.from_numpy(_profiles(70, 48, seed=4))
    got = tgram.kernel_from_profiles(f, device="cpu")
    want = tgram_ref.kernel_from_profiles_ref(f)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def test_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError):
        tpw.pairwise_dists_stats(torch.zeros(3, 4, 5))
    with pytest.raises(TypeError):
        tpw.pairwise_dists_stats(torch.zeros(3, 4, dtype=torch.float64))
    with pytest.raises(ValueError):
        tpw.pairwise_dists_stats(torch.zeros(0, 4))
    s0 = torch.zeros(4, 4)
    with pytest.raises(ValueError):
        tgram.normalized_gram(s0, torch.zeros(()), torch.ones(()), 5)
    with pytest.raises(ValueError):
        tgram.normalized_gram(s0, torch.zeros(2), torch.ones(()), 4)
    with pytest.raises(TypeError):
        tgram.normalized_gram(s0, torch.zeros(()), torch.ones(()), 4, torch.float16)
