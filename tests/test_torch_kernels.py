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
    sequential fp32 direct sum is further than the plain
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


# the shapes the K1/K3 emulation is held at: the JAX sweep's, the LM
# path's K1 shape and the Fig.-3 gradient profiles' K3 shape
PLANNED_SHAPES = K3_SHAPES + [(10, 960), (100, 4096)]


def _planned_sum(f: torch.Tensor) -> torch.Tensor:
    """K1 and K3's arithmetic on the card, emulated: for the plan of F's
    shape, each rank's group g sums (f_ik − f_jk)² over the terms k = lo +
    g, lo + g + G, ... of the rank's range in fp64, the groups' partials
    are added in group order, the ranks' in rank order, and the sum is
    rounded once to fp32, diagonal 0.  The kernel's fma(d, d, acc) is
    emulated up to the rounding of d·d (exact while d has 26 significant
    bits or fewer)."""
    c, q = f.shape
    p = tpw.plan(c, q)
    x = f.float().double()
    total = None
    for r in range(p.ranks):
        span = p.span(r, q)
        part = None
        for g in range(p.groups):
            acc = torch.zeros(c, c, dtype=torch.float64)
            for k in span[g::p.groups]:
                d = x[:, k, None] - x[None, :, k]
                acc = d * d + acc
            part = acc if part is None else part + acc
        total = part if total is None else total + part
    out = total.float()
    out.fill_diagonal_(0.0)
    return out


def _fp64_chain(f: torch.Tensor) -> torch.Tensor:
    fd = f.double()
    sq = torch.sum(fd * fd, dim=-1)
    exact = torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * (fd @ fd.T), 0.0)
    exact.fill_diagonal_(0.0)
    return exact


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,q", PLANNED_SHAPES)
def test_k1_k3_planned_sum_matches_pallas_and_fp64(c, q, dtype):
    """The planned fp64 sum (``_planned_sum``, made as ``chip_smoke.py``
    makes its inputs) against the Pallas K3 and K1 in interpret mode, with
    the JAX sweep's bounds (fp32 1e-3, bf16 5e-2 of max(1, max)) and K1's
    rtol 1e-5 on S0 = √D2 and on hi; and no further from an fp64 chain
    than the plain fp32 chain.  The control, a sequential fp32 sum, is
    further from it than the plain chain once Q reaches 128.  ``pytest -s`` prints the errors."""
    f = torch.randn(c, q, generator=torch.Generator().manual_seed(c * 7919 + q))
    f = f.to(getattr(torch, dtype))
    d2 = _planned_sum(f)
    jf = jnp.asarray(f.float().numpy()).astype(dtype)
    want = np.asarray(jpw.pairwise_sq_dists(jf))
    tol = (5e-2 if dtype == "bfloat16" else 1e-3) * max(1.0, want.max())
    np.testing.assert_allclose(d2.numpy(), want, atol=tol)
    js0, jlo, jhi = pairwise_dists_stats_kernel(jf, interpret=True)
    s0 = torch.sqrt(d2)
    assert float(s0.min()) == float(jlo) == 0.0
    np.testing.assert_allclose(float(s0.max()), float(jhi), rtol=1e-5)
    np.testing.assert_allclose(s0.numpy(), np.asarray(js0)[:c, :c], rtol=1e-5, atol=1e-5 * float(jhi))
    exact = _fp64_chain(f)
    err = {
        name: float((x.double() - exact).abs().max())
        for name, x in (("planned", d2), ("plain", tpw.pairwise_sq_dists(f)),
                        ("fp32 direct", _direct_sum(f, torch.float32)))
    }
    print(f"K1/K3 {c}x{q} {dtype} plan {tpw.plan(c, q)} max error vs fp64: {err}")
    assert err["planned"] <= err["plain"]
    if q >= 128:
        assert err["fp32 direct"] > err["plain"]


def _upper_tile(p: int, t: int):
    """``upper_tile`` of ``csrc/pairwise_l2.cu``: tile p of the upper
    triangle of a t x t grid, row by row."""
    ti = 0
    while p >= t - ti:
        p -= t - ti
        ti += 1
    return ti, ti + p


# the paths' shapes first (FC-1, LM, representative and gradient profiles)
PATH_SHAPES = [(100, 128), (10, 960), (100, 1280), (100, 4096)]


@pytest.mark.parametrize(
    "c,q",
    PATH_SHAPES + [(4, 3), (10, 7), (130, 257), (64, 512), (1000, 700), (4096, 128), (4096, 512),
                   (513, 257), (5, 300), (300, 64), (130, 37), (1, 1), (128, 63), (129, 64),
                   (1024, 40), (1025, 2000)],
)
def test_pairwise_plan_covers_every_tile_and_term(c, q):
    """The plan's Python mirror: every upper-triangle tile appears once and
    with its mirror covers the C x C output once; the ranks' ranges tile
    [0, Q) exactly, in order, each of 32 terms or more when there are
    several ranks; S is 1, 2, 4 or 8; the groups' strided terms tile each
    range; each path shape but C = 10 gets at least 100 blocks."""
    p = tpw.plan(c, q)
    assert p.tile in (16, 32, 64) and p.ranks in (1, 2, 4, 8)
    t = -(-c // p.tile)
    tiles = [_upper_tile(k, t) for k in range(p.tiles)]
    assert sorted(tiles) == [(i, j) for i in range(t) for j in range(i, t)]
    covered = np.zeros((t * p.tile, t * p.tile), dtype=np.int64)
    for ti, tj in tiles:
        rows, cols = slice(ti * p.tile, (ti + 1) * p.tile), slice(tj * p.tile, (tj + 1) * p.tile)
        if ti == tj:  # row <= col, mirrored below the diagonal
            block = np.triu(np.ones((p.tile, p.tile), dtype=np.int64))
            covered[rows, cols] += block + np.triu(block, 1).T
        else:
            covered[rows, cols] += 1
            covered[cols, rows] += 1
    assert (covered[:c, :c] == 1).all()
    spans = [p.span(r, q) for r in range(p.ranks)]
    assert [k for span in spans for k in span] == list(range(q))
    assert all(len(span) >= (32 if p.ranks > 1 else 1) for span in spans)
    for span in spans:
        assert sorted(k for g in range(p.groups) for k in span[g::p.groups]) == list(span)
    if (c, q) in PATH_SHAPES and c != 10:
        assert p.blocks >= 100


def test_k1_binding_returns_views_of_one_buffer():
    """K1's host binding (``csrc/pairwise_l2_bind.cpp``, built here with the
    host compiler) around a stand-in for the library's launch function:
    the call passes F, its type, C, Q, the ticket and the stream through,
    S0, lo, hi and rng are views of the one buffer it allocates at the
    offsets the kernel writes, and a refused launch raises with the
    library's error string."""
    import ctypes

    from repro_torch.kernels import _build

    bind = _build.binding("pairwise_l2_bind")
    c, q = 5, 3
    n = c * c + 3 + 2
    f = torch.from_numpy(_profiles(c, q)).to(torch.bfloat16)
    seen = {}

    @ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)
    def launch(fp, is_bf16, cc, qq, s0, stats, ticket, stream):
        seen.update(f=fp, bf16=is_bf16, c=cc, q=qq, stats=stats - s0, ticket=ticket, stream=stream)
        out = (ctypes.c_float * n).from_address(s0)
        for k in range(n):
            out[k] = k
        return seen.get("err", 0)

    message = ctypes.create_string_buffer(b"stand-in error")

    @ctypes.CFUNCTYPE(ctypes.c_void_p, ctypes.c_int)
    def error_string(err):
        return ctypes.addressof(message)

    fns = (ctypes.cast(launch, ctypes.c_void_p).value, ctypes.cast(error_string, ctypes.c_void_p).value)
    s0, lo, hi, rng = bind.dists_range(f, *fns, n, 1234, 5678)
    assert seen == dict(f=f.data_ptr(), bf16=1, c=c, q=q, stats=4 * c * c, ticket=1234, stream=5678)
    assert s0.dtype == torch.float32 and s0.shape == (c, c) and s0.is_contiguous()
    assert torch.equal(s0, torch.arange(c * c, dtype=torch.float32).view(c, c))
    assert [x.shape for x in (lo, hi, rng)] == [()] * 3
    assert [float(x) for x in (lo, hi, rng)] == [c * c, c * c + 1, c * c + 2]
    assert lo.data_ptr() == s0.data_ptr() + 4 * c * c  # one buffer
    s0b, lob, hib = bind.dists_stats(f.float(), *fns, n, 1234, 5678)
    assert seen["bf16"] == 0 and torch.equal(s0b, s0) and float(lob) == c * c and float(hib) == c * c + 1
    seen["err"] = 2
    with pytest.raises(RuntimeError, match=r"CUDA error 2 \(stand-in error\)"):
        bind.dists_stats(f, *fns, n, 1234, 5678)


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
