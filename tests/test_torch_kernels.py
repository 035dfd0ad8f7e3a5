"""The port's kernels' wrappers (``repro_torch.kernels``: the K1/K2
pipeline, K3 and K4) against the JAX package's Pallas kernels, run in
interpret mode on the CPU as the JAX tests run them.  On the CPU the port's wrappers run their plain versions; the
CUDA kernels themselves are held against those plain versions by
``tests/test_torch_cuda.py`` on a card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import similarity as jsim  # noqa: E402
from repro.kernels.gram import ops as jgram  # noqa: E402
from repro.kernels.gram.gram import gram_kernel  # noqa: E402
from repro.kernels.pairwise_l2 import ops as jpw  # noqa: E402
from repro.kernels.pairwise_l2.pairwise_l2 import pairwise_dists_stats_kernel  # noqa: E402

from repro_torch.core import similarity as tsim  # noqa: E402
from repro_torch.kernels.gram import ops as tgram  # noqa: E402
from repro_torch.kernels.gram import ref as tgram_ref  # noqa: E402
from repro_torch.kernels.pairwise_l2 import ops as tpw  # noqa: E402

SHAPES = [(4, 3), (10, 7), (100, 128), (130, 257), (257, 33)]
# the JAX tests' sweeps: tests/test_kernels.py::test_pairwise_l2_sweep (K3)
# and tests/test_gram_kernels.py::test_gram_matches_ref (K4)
K3_SHAPES = [(4, 3), (10, 7), (100, 128), (130, 257), (64, 512)]
K4_SHAPES = [(5, 4), (64, 64), (130, 70), (33, 257)]


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,q", K3_SHAPES)
def test_pairwise_sq_dists_matches_pallas(c, q, dtype):
    """K3's wrapper, and the stage-wise entry point that reaches it, against
    the JAX package's K3 (Pallas, interpret mode), at the JAX sweep's
    shapes and tolerances."""
    f = np.random.default_rng(c * 1000 + q).normal(size=(c, q)).astype(np.float32)
    jf = jnp.asarray(f).astype(dtype)
    tf = torch.from_numpy(f).to(getattr(torch, dtype))
    want = np.asarray(jpw.pairwise_sq_dists(jf))
    scale = max(1.0, want.max())
    tol = (5e-2 if dtype == "bfloat16" else 1e-3) * scale
    for got in (tpw.pairwise_sq_dists(tf), tsim.pairwise_sq_dists(tf, use_kernel=True)):
        assert got.shape == (c, c) and got.dtype == torch.float32
        got = got.numpy()
        np.testing.assert_allclose(got, want, atol=tol)
        assert (got >= 0).all()
        np.testing.assert_array_equal(np.diag(got), 0.0)
    if dtype == "float32":
        # the later stages on K3's distances, against JAX's on its K3's
        for name in ("pairwise_dists", "similarity_matrix"):
            want = np.asarray(getattr(jsim, name)(jf, use_kernel=True))
            got = getattr(tsim, name)(tf, use_kernel=True).numpy()
            np.testing.assert_allclose(got, want, atol=1e-3 * max(1.0, np.abs(want).max()))


def _direct_sum(f: torch.Tensor, acc_dtype: torch.dtype) -> torch.Tensor:
    """K3's arithmetic emulated on the CPU: sum_k (f_ik - f_jk)^2 in the
    kernel's sequential k order, accumulated in ``acc_dtype`` and rounded
    to fp32, diagonal 0.  The difference d is taken in ``acc_dtype``, as
    the kernel takes it.  An fp32 step is fmaf(d, d, acc) up to a rare
    double rounding: the product is exact in fp64, the sum is rounded to
    fp64 and then to fp32."""
    f = f.float().to(acc_dtype)
    c, q = f.shape
    acc = torch.zeros(c, c, dtype=acc_dtype)
    for k in range(q):
        d = (f[:, k, None] - f[None, :, k]).double()
        acc = (d * d + acc.double()).to(acc_dtype)
    out = acc.float()
    out.fill_diagonal_(0.0)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,q", K3_SHAPES)
def test_k3_accumulator_against_fp64(c, q, dtype):
    """Why K3 accumulates in fp64: on the JAX sweep's random profiles (made
    as ``chip_smoke.py`` makes them), the fp64 direct sum rounded once is no
    further from an fp64 chain than the plain fp32 chain, while a
    sequential fp32 direct sum (K1's accumulator) is further than the plain
    chain once Q reaches 128.  ``pytest -s`` prints the three errors."""
    f = torch.randn(c, q, generator=torch.Generator().manual_seed(c * 7919 + q))
    f = f.to(getattr(torch, dtype))
    fd = f.double()
    sq = torch.sum(fd * fd, dim=-1)
    exact = torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * (fd @ fd.T), 0.0)
    exact.fill_diagonal_(0.0)
    err = {
        name: float((d2.double() - exact).abs().max())
        for name, d2 in (
            ("fp64 direct", _direct_sum(f, torch.float64)),
            ("fp32 direct", _direct_sum(f, torch.float32)),
            ("plain", tpw.pairwise_sq_dists(f)),
        )
    }
    print(f"K3 {c}x{q} {dtype} max error vs fp64: {err}")
    assert err["fp64 direct"] <= err["plain"]
    if q >= 128:
        assert err["fp32 direct"] > err["plain"]


@pytest.mark.parametrize("m,n", K4_SHAPES)
def test_gram_matches_pallas(m, n):
    x = np.random.default_rng(m * 1000 + n).normal(size=(m, n)).astype(np.float32)
    want = np.asarray(jgram.gram(jnp.asarray(x)))
    got = tgram.gram(torch.from_numpy(x))
    assert got.shape == (n, n) and got.dtype == torch.float32
    # the JAX test's fp32 bound
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _tf32(x):
    """fp32 -> TF32 by clearing the 13 low mantissa bits of the float32 bit
    pattern (toward zero), as K4 forms hi and as the tensor cores read an
    fp32 register given as TF32."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _gram_3xtf32(x, hi_only=False):
    """K4's fp32 arithmetic on the tensor cores: hi = tf32(x), lo = x - hi
    (exact), read by the tensor cores as tf32(lo); XᵀX as lo·hi + hi·lo +
    hi·hi with fp32 sums (lo·lo dropped).  ``hi_only`` (the control):
    hi·hi alone, plain TF32."""
    hi = _tf32(x)
    if hi_only:
        return hi.T @ hi
    lo = _tf32(x - hi)
    return (lo.T @ hi + hi.T @ lo) + hi.T @ hi


@pytest.mark.parametrize("m,n", K4_SHAPES)
def test_k4_3xtf32_matches_pallas(m, n):
    """3xTF32 at the JAX test's fp32 shapes and bound (1e-5) against the
    Pallas K4 in interpret mode; TF32 alone (the control) breaks it."""
    x = np.random.default_rng(m * 1000 + n).normal(size=(m, n)).astype(np.float32)
    want = np.asarray(gram_kernel(jnp.asarray(x), interpret=True))
    got = _gram_3xtf32(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    control = _gram_3xtf32(torch.from_numpy(x), hi_only=True).numpy()
    assert not np.allclose(control, want, rtol=1e-5, atol=1e-5)


def test_k4_3xtf32_against_fp64_at_the_large_shape_bound():
    """At (1024, 256), made as ``chip_smoke.py`` makes its inputs, 3xTF32
    holds ``chip_smoke.py``'s large-shape fp32 bound (rtol 1e-5 plus atol
    1e-5 * max|G|) against an fp64 product; TF32 alone breaks it."""
    m, n = 1024, 256
    x = torch.randn(m, n, generator=torch.Generator().manual_seed(m * 7919 + n))
    exact = x.double().T @ x.double()
    tol = 1e-5 * exact.abs().max() + 1e-5 * exact.abs()
    assert bool(torch.all((_gram_3xtf32(x).double() - exact).abs() <= tol))
    assert not bool(torch.all((_gram_3xtf32(x, hi_only=True).double() - exact).abs() <= tol))


def test_gram_bf16_inputs_fp32_accumulation():
    x = np.random.default_rng(7).normal(size=(96, 40)).astype(np.float32)
    want = np.asarray(jgram.gram(jnp.asarray(x).astype(jnp.bfloat16)))
    got = tgram.gram(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.float32
    # the JAX test's bf16 bound (both sides take exact bf16 products in fp32)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2 * np.abs(want).max())


def test_stage_wise_kernel_matches_the_pipeline():
    """``gram(similarity_matrix(f, use_kernel=True))`` (K3, then K4) gives the
    eq.-14 kernel of the two-launch pipeline (K1 + K2)."""
    f = torch.from_numpy(_profiles(100, 128, seed=5))
    stage = tgram.gram(tsim.similarity_matrix(f, use_kernel=True))
    fused = tgram.kernel_from_profiles(f, device="cpu")
    np.testing.assert_allclose(stage.numpy(), fused.numpy(), rtol=1e-5, atol=1e-5)


def test_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError):
        tpw.pairwise_dists_stats(torch.zeros(3, 4, 5))
    with pytest.raises(TypeError):
        tpw.pairwise_dists_stats(torch.zeros(3, 4, dtype=torch.float64))
    with pytest.raises(ValueError):
        tpw.pairwise_dists_stats(torch.zeros(0, 4))
    with pytest.raises(ValueError):
        tpw.pairwise_sq_dists(torch.zeros(3))
    with pytest.raises(TypeError):
        tpw.pairwise_sq_dists(torch.zeros(3, 4, dtype=torch.float16))
    with pytest.raises(ValueError):
        tgram.gram(torch.zeros(3, 4, 5))
    with pytest.raises(TypeError):
        tgram.gram(torch.zeros(3, 4, dtype=torch.int32))
    with pytest.raises(ValueError):
        tgram.gram(torch.zeros(3, 0))
    s0 = torch.zeros(4, 4)
    with pytest.raises(ValueError):
        tgram.normalized_gram(s0, torch.zeros(()), torch.ones(()), 5)
    with pytest.raises(ValueError):
        tgram.normalized_gram(s0, torch.zeros(2), torch.ones(()), 4)
    with pytest.raises(TypeError):
        tgram.normalized_gram(s0, torch.zeros(()), torch.ones(()), 4, torch.float16)
