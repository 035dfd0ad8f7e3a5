"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips without a card; this
file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import gc
import os
import tempfile
import warnings

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.gram import ops as gram_ops  # noqa: E402
from repro_torch.kernels.gram import ref as gram_ref  # noqa: E402
from repro_torch.kernels.pairwise_l2 import ops as pw_ops  # noqa: E402
from repro_torch.kernels.pairwise_l2 import ref as pw_ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full fp32
    return torch.device("cuda")


def _profiles(c, q, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(c, q, generator=g).to(dtype).to(device)


# K1's and K3's path shapes: the FL paths' K1 (FC-1 and LM profiles) and
# the stage-wise route's K3 (FC-1, representative and gradient profiles)
PAIRWISE_PATH_SHAPES = [(10, 960, torch.float32), (100, 1280, torch.float32), (100, 4096, torch.float32)]
# K1 at the LM path's inits of the later archs: their profile widths
# (qwen2-vl-2b and musicgen-medium; rwkv6-7b, recurrentgemma-9b, mixtral-8x7b)
TRAIN_PROFILE_SHAPES = [(10, 1536, torch.float32), (10, 4096, torch.float32)]


@pytest.mark.parametrize(
    "c,q,dtype",
    [(100, 128, torch.float32), (1000, 700, torch.float32), (513, 257, torch.bfloat16), (5, 3, torch.float32)]
    + PAIRWISE_PATH_SHAPES + TRAIN_PROFILE_SHAPES,
)
def test_pairwise_dists_stats_kernel_matches_plain(card, c, q, dtype):
    f = _profiles(c, q, dtype, card)
    before = _build.LAUNCHES["pairwise_dists_stats"]
    s0, lo, hi = pw_ops.pairwise_dists_stats(f)
    again = pw_ops.pairwise_dists_stats(f)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pairwise_dists_stats"] == before + 2
    # one upper triangle mirrored, and every order of addition fixed
    assert torch.equal(s0, s0.T)
    assert all(torch.equal(x, y) for x, y in zip((s0, lo, hi), again))
    ws0, wlo, whi = pw_ref.pairwise_dists_stats_ref(f)
    assert float(lo) == float(wlo) == 0.0
    torch.testing.assert_close(hi, whi, rtol=1e-5, atol=0.0)
    # fp32 sums over Q in another order: ~1e-6 relative on distances
    torch.testing.assert_close(s0, ws0, rtol=1e-5, atol=1e-5 * float(whi))
    assert torch.all(torch.diagonal(s0) == 0)


@pytest.mark.parametrize(
    "c,q,dtype",
    [(100, 128, torch.float32), (1000, 700, torch.float32), (513, 257, torch.bfloat16), (5, 3, torch.float32)],
)
def test_normalized_gram_kernel_matches_plain(card, c, q, dtype):
    s0, lo, hi = pw_ref.pairwise_dists_stats_ref(_profiles(c, q, dtype, card, seed=1))
    rng = torch.clamp_min(hi - lo, 1e-30)
    before = _build.LAUNCHES["normalized_gram"]
    got = gram_ops.normalized_gram(s0, lo, rng, c, dtype)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["normalized_gram"] == before + 1
    want = gram_ref.normalized_gram_ref(s0, lo, rng, c, dtype)
    # same rounded inputs, fp32 sums over c terms in another order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("c", [1, 15, 16, 17, 100, 130])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normalized_gram_kernel_is_exactly_symmetric(card, c, dtype):
    """K2 at and around its 16-wide tiles (one upper-triangle loop at every
    c): L equals its transpose bit for bit, and the plain version within
    the bound above, in both rounding modes."""
    s0, lo, hi = pw_ref.pairwise_dists_stats_ref(_profiles(c, 24, dtype, card, seed=7))
    rng = torch.clamp_min(hi - lo, 1e-30)
    got = gram_ops.normalized_gram(s0, lo, rng, c, dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, got.T)
    want = gram_ref.normalized_gram_ref(s0, lo, rng, c, dtype)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4 * float(want.abs().max()))


def test_kernel_pipeline_on_the_card_matches_plain_chain(card):
    f = _profiles(300, 64, torch.float32, card, seed=2)
    got = gram_ops.kernel_from_profiles(f)
    want = gram_ref.kernel_from_profiles_ref(f)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4 * float(want.abs().max()))
    torch.testing.assert_close(gram_ops.candidate_kernel_from_profiles(f), got, rtol=0, atol=0)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    f = _profiles(8, 6, torch.float32, card)
    with pytest.raises(ValueError, match="contiguous"):
        pw_ops.pairwise_dists_stats(f.T)
    s0 = torch.zeros(8, 8, device=card)
    with pytest.raises(ValueError):
        gram_ops.normalized_gram(s0, torch.zeros(()), torch.ones((), device=card), 8)


# ------------------------------------------------------------- K3 and K4

from repro_torch.core import similarity as sim  # noqa: E402


@pytest.mark.parametrize(
    "c,q,dtype",
    [(100, 128, torch.float32), (130, 257, torch.float32), (64, 512, torch.bfloat16),
     (4, 3, torch.float32), (1000, 700, torch.bfloat16)] + PAIRWISE_PATH_SHAPES,
)
def test_pairwise_sq_dists_kernel_matches_plain(card, c, q, dtype):
    f = _profiles(c, q, dtype, card, seed=3)
    before = _build.LAUNCHES["pairwise_sq_dists"]
    got = pw_ops.pairwise_sq_dists(f)
    again = pw_ops.pairwise_sq_dists(f)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pairwise_sq_dists"] == before + 2
    assert got.shape == (c, c) and got.dtype == torch.float32
    assert torch.equal(got, got.T) and torch.equal(got, again)
    want = pw_ref.pairwise_sq_dists_ref(f)
    # the JAX sweep's fp32 bound (both sides upcast bf16 exactly, so bf16
    # inputs take it too); the direct sum and the expansion differ by ulps
    tol = 1e-3 * max(1.0, float(want.max()))
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    assert bool((got >= 0).all()) and bool((torch.diagonal(got) == 0).all())
    # K1's distances: the square roots of the same sums, taken in fp32
    s0, _, _ = pw_ops.pairwise_dists_stats(f)
    torch.testing.assert_close(torch.sqrt(got), s0, rtol=1e-5, atol=0)


@pytest.mark.parametrize(
    "c,q",
    [(100, 128), (10, 960), (100, 1280), (100, 4096), (1000, 700), (4096, 512), (513, 257), (130, 257),
     (64, 512), (4, 3), (300, 64)],
)
def test_pairwise_plan_is_the_python_mirror(card, c, q):
    """``pairwise_l2_plan``, the launch the library takes, equals the Python
    mirror that the CPU tests check (tiles, S, spans), and the path shapes
    take the plans the design names."""
    p = pw_ops.cuda_plan(c, q)
    assert p == pw_ops.plan(c, q)
    named = {(100, 128): (16, 4, 28), (10, 960): (16, 8, 1), (100, 1280): (16, 8, 28), (100, 4096): (16, 8, 28)}
    if (c, q) in named:
        assert tuple(p) == named[(c, q)]


def _device_kernels(fn):
    """The device work (kernels, copies, fills) one call of ``fn`` puts on
    its stream: one label per node of a CUDA graph captured from the call,
    from the graph's DOT dump (a kernel node's label holds its name).  A
    capture records every launch, where torch.profiler drops a session's
    device events now and then.  One call on the capture stream first, so
    that what a wrapper caches per stream (K1's ticket) exists already."""
    import re

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    side.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept for the dump, never run
    graph.enable_debug_mode()
    with torch.cuda.graph(graph, stream=side):
        fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "call.dot")
        with warnings.catch_warnings():  # the dump's own notices
            warnings.simplefilter("ignore")
            graph.debug_dump(path)
        with open(path) as fh:
            dot = fh.read()
    starts = [m.start() for m in re.finditer(r'^"graph_\d+_node_\d+"\s*\[', dot, flags=re.M)]
    return [dot[a:b] for a, b in zip(starts, starts[1:] + [len(dot)])]


def test_pairwise_calls_are_one_kernel_and_the_pipeline_two(card):
    """At the FL main path's shape a K1 call and a K3 call are one device
    kernel each and ``kernel_from_profiles`` two (K1, then K2); the range
    K1 writes equals ``clamp_min(hi - lo, 1e-30)`` bit for bit, and K1's S0
    is the fp32 square root of K3's D2 bit for bit."""
    f = _profiles(100, 128, torch.float32, card, seed=8)
    k1 = _device_kernels(lambda: pw_ops.pairwise_dists_stats(f))
    k3 = _device_kernels(lambda: pw_ops.pairwise_sq_dists(f))
    pipe = _device_kernels(lambda: gram_ops.kernel_from_profiles(f))
    assert len(k1) == 1 and "pairwise" in k1[0], k1
    assert len(k3) == 1 and "pairwise" in k3[0], k3
    assert len(pipe) == 2 and "pairwise" in pipe[0] and "gram" in pipe[1], pipe
    s0, lo, hi, rng = pw_ops.pairwise_dists_range(f)
    assert torch.equal(rng, torch.clamp_min(hi - lo, 1e-30))
    assert torch.equal(s0, torch.sqrt(pw_ops.pairwise_sq_dists(f)))


@pytest.mark.parametrize("c,q", [(100, 128), (10, 960), (1000, 700)])
def test_pairwise_ticket_resets_between_launches(card, c, q):
    """K1 and K3 back to back, twice: K1's last tile resets its ticket, so
    the second K1 finds its own last tile and writes the same statistics
    (a stale ticket would leave them unwritten or written early)."""
    f = _profiles(c, q, torch.float32, card, seed=9)
    runs = []
    for _ in range(2):
        s0, lo, hi, rng = pw_ops.pairwise_dists_range(f)
        d2 = pw_ops.pairwise_sq_dists(f)
        runs.append((s0, lo.clone(), hi.clone(), rng.clone(), d2))
    torch.cuda.synchronize()
    (s0, lo, hi, rng, d2), again = runs
    assert all(torch.equal(x, y) for x, y in zip(runs[0], again))
    ws0, wlo, whi = pw_ref.pairwise_dists_stats_ref(f)
    assert float(lo) == float(wlo) == 0.0
    torch.testing.assert_close(hi, whi, rtol=1e-5, atol=0.0)
    assert float(hi) == float(s0.max()) and float(rng) == float(hi) - float(lo)
    # a third launch on another stream takes that stream's own ticket
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        s0b, lob, hib = pw_ops.pairwise_dists_stats(f)
    torch.cuda.synchronize()
    assert torch.equal(s0b, s0) and torch.equal(lob, lo) and torch.equal(hib, hi)


@pytest.mark.parametrize(
    "m,n,dtype",
    [(5, 4, torch.float32), (64, 64, torch.float32), (130, 70, torch.float32),
     (33, 257, torch.float32), (96, 40, torch.bfloat16), (1000, 300, torch.bfloat16)],
)
def test_gram_kernel_matches_plain(card, m, n, dtype):
    x = _profiles(m, n, dtype, card, seed=4)
    before = dict(_build.LAUNCHES)
    got = gram_ops.gram(x)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gram"] == before["gram"] + 1
    assert _build.LAUNCHES["normalized_gram"] == before["normalized_gram"]
    assert got.shape == (n, n) and got.dtype == torch.float32
    want = gram_ref.gram_ref(x)
    # the same exact products (bf16 x bf16 is exact in fp32), fp32 sums over
    # m terms in another order: the JAX test's fp32 bound
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * max(1.0, float(want.abs().max())))


def test_gram_takes_a_row_stride(card):
    wide = _profiles(70, 90, torch.float32, card, seed=5)
    x = wide[:, 10:60]
    assert not x.is_contiguous()
    torch.testing.assert_close(gram_ops.gram(x), gram_ref.gram_ref(x), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize(
    "m,n,dtype,cols",
    [(4096, 1024, torch.float32, None), (4096, 1024, torch.bfloat16, None),
     (3000, 777, torch.float32, None), (3000, 777, torch.bfloat16, None),  # rows not 16-byte aligned
     (2000, 520, torch.float32, None), (2000, 520, torch.bfloat16, None),  # a ragged last tile
     (3000, 784, torch.float32, 777)],  # a row stride: the last 16-byte chunk half in
)
def test_gram_tensor_core_syrk_is_symmetric_repeatable_and_in_bounds(card, m, n, dtype, cols):
    """K4 for N > 128 (the tensor-core SYRK): exactly symmetric, the same
    bits on two runs (deterministic row-slice sums), and within
    ``chip_smoke.py``'s large-shape bound of the plain fp32 product, rtol
    1e-5 plus atol 1e-5 * max|G|, in both types (bf16 products are exact
    in fp32, so the plain version sums the same products); the result with
    one stage of rows dropped must break that bound."""
    x = torch.randn(m, n, generator=torch.Generator().manual_seed(m * 7919 + n)).to(dtype).to(card)
    if cols is not None:
        x = x[:, :cols]
    before = _build.LAUNCHES["gram"]
    got = gram_ops.gram(x)
    again = gram_ops.gram(x)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gram"] == before + 2
    assert torch.equal(got, got.T)
    assert torch.equal(got, again)
    want = gram_ref.gram_ref(x)
    tol = 1e-5 * float(want.abs().max()) + 1e-5 * want.abs()
    diff = (got - want).abs()
    assert bool(torch.all(diff <= tol)), f"max {float(diff.max())}"
    stage = 64 if dtype == torch.bfloat16 else 32
    assert not bool(torch.all((got - gram_ref.gram_ref(x[:stage]) - want).abs() <= tol))


def test_k3_and_k4_refuse_what_the_kernels_do_not_take(card):
    f = _profiles(8, 6, torch.float32, card)
    with pytest.raises(ValueError, match="contiguous"):
        pw_ops.pairwise_sq_dists(f.T)
    with pytest.raises(ValueError):
        pw_ops.pairwise_sq_dists(f[None])
    with pytest.raises(TypeError):
        pw_ops.pairwise_sq_dists(f.half())
    with pytest.raises(ValueError, match="rows"):
        gram_ops.gram(f.T)
    with pytest.raises(ValueError):
        gram_ops.gram(f[None])
    with pytest.raises(TypeError):
        gram_ops.gram(f.double())


def test_stage_wise_route_launches_k3_then_k4(card):
    """``similarity_matrix(use_kernel=True)`` launches K3 exactly once and
    ``gram`` K4 exactly once, never K2; the stage-wise L agrees with the
    K1 + K2 pipeline's."""
    f = _profiles(100, 128, torch.float32, card, seed=6)
    _build.reset_launches()
    s = sim.similarity_matrix(f, use_kernel=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pairwise_sq_dists"] == 1
    assert sum(_build.LAUNCHES.values()) == 1
    lk = gram_ops.gram(s)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gram"] == 1 and _build.LAUNCHES["normalized_gram"] == 0
    assert sum(_build.LAUNCHES.values()) == 2
    fused = gram_ops.kernel_from_profiles(f)
    torch.testing.assert_close(lk, fused, rtol=0, atol=1e-4 * float(fused.abs().max()))


# ------------------------------------------------------------------- K5

from repro_torch.kernels.flash_attention import ops as fd_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fd_ref  # noqa: E402


def _qkv(b, s, h, hk, hd, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(n, generator=g) for n in ((b, 1, h, hd), (b, s, hk, hd), (b, s, hk, hd)))
    return q.to(dtype).to(device), k.to(dtype).to(device), v.to(dtype).to(device)


@pytest.mark.parametrize(
    "b,s,h,hk,hd,lengths,dtype",
    [
        (5, 40, 4, 2, 32, [0, 1, 7, 33, 40], torch.float32),  # the JAX test's shapes
        (2, 64, 4, 4, 16, [64, 50], torch.float32),
        (3, 16, 4, 1, 64, [16, 3, 9], torch.float32),
        (4, 40, 15, 5, 64, [0, 40, 17, 1], torch.float32),
        (16, 256, 15, 5, 64, None, torch.bfloat16),  # the serving path's shape
        (3, 300, 48, 8, 128, [300, 0, 129], torch.bfloat16),
        (2, 100, 32, 2, 256, [100, 31], torch.float32),  # 16 rows per KV head: two groups
        (2, 70, 6, 3, 40, [70, 5], torch.bfloat16),  # hd*2 % 16 == 0: vector loads
        (2, 70, 6, 3, 20, [69, 70], torch.bfloat16),  # scalar loads
    ],
)
def test_flash_decode_kernel_matches_plain(card, b, s, h, hk, hd, lengths, dtype):
    q, k, v = _qkv(b, s, h, hk, hd, dtype, card)
    if lengths is None:  # ragged, with an empty and a full slot
        lengths = [0, s] + [int(x) for x in torch.randint(1, s, (b - 2,), generator=torch.Generator().manual_seed(1))]
    ln = torch.tensor(lengths, dtype=torch.int32, device=card)
    before = _build.LAUNCHES["flash_decode"]
    got = fd_ops.flash_decode(q, k, v, ln)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_decode"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    _check_decode(got, fd_ref.decode_attention_ref(q, k, v, ln), ln)


def _check_decode(got, want, ln):
    """K5's bounds against its plain version; empty slots exactly zero."""
    assert torch.all(got[ln == 0] == 0)
    if got.dtype == torch.float32:
        # fp32 sums in another order: the JAX test's bound
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    else:
        # both compute in fp32 from the same bf16 inputs and round once at the
        # end: they differ by at most one bf16 step of each output element
        # (<= 2^-7 of |out|), plus the fp32 sums' order near 0, bounded by
        # 2^-8 of the slot's largest output
        wf = want.float()
        atol = 2.0**-8 * wf.abs().amax(dim=(1, 2, 3), keepdim=True)
        diff = (got.float() - wf).abs()
        bad = diff > 2.0**-7 * wf.abs() + atol
        assert not bool(bad.any()), f"{int(bad.sum())} elements off, max {float(diff.max())}"


@pytest.mark.parametrize(
    "b,s,h,hk,hd,dtype,lengths",
    [
        (6, 1000, 15, 5, 64, torch.bfloat16, "boundaries"),
        (6, 1000, 15, 5, 64, torch.float32, "boundaries"),
        (6, 300, 32, 2, 128, torch.bfloat16, "boundaries"),  # G = 16: two row groups
        (6, 2000, 16, 1, 64, torch.float32, "boundaries"),  # G = 16
        (1, 32768, 15, 5, 64, torch.bfloat16, "full"),
        (16, 4096, 15, 5, 64, torch.bfloat16, "ragged"),
    ],
)
def test_flash_decode_split_kv_matches_plain(card, b, s, h, hk, hd, dtype, lengths):
    """K5 with its KV axis split across blocks (``decode_plan``) and the
    partials merged by its second kernel: at lengths 0, 1, on the first two
    split boundaries, one past the start of the last split and S (not a
    multiple of the split); a slot of 32768 positions; and a ragged
    (16, 4096) batch with an empty and a full slot.  One wrapper call adds
    exactly 1 to the launch count."""
    q, k, v = _qkv(b, s, h, hk, hd, dtype, card, seed=s)
    ns, split = fd_ops.decode_plan(b, s, h, hk, hd, dtype == torch.bfloat16)
    assert ns > 1 and split * (ns - 1) < s <= split * ns
    if lengths == "boundaries":
        assert s % split
        lengths = [0, 1, split, 2 * split, split * (ns - 1) + 1, s]
    elif lengths == "full":
        lengths = [s] * b
    else:
        gen = torch.Generator().manual_seed(2)
        lengths = [0, s] + [int(x) for x in torch.randint(1, s, (b - 2,), generator=gen)]
    ln = torch.tensor(lengths, dtype=torch.int32, device=card)
    before = _build.LAUNCHES["flash_decode"]
    got = fd_ops.flash_decode(q, k, v, ln)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_decode"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    _check_decode(got, fd_ref.decode_attention_ref(q, k, v, ln), ln)


@pytest.mark.parametrize(
    "h,hk,hd",
    [(12, 2, 128), (24, 24, 64), (40, 8, 128)],
    ids=["qwen2-vl-2b", "musicgen-medium", "llama4-maverick"],
)
@pytest.mark.parametrize("lengths", ["full", "ragged"])
def test_flash_decode_at_the_new_archs_decode_shapes(card, h, hk, hd, lengths):
    """K5 at the serving shapes of the archs of the last model slice, bf16,
    B = 16 and S = 192 (prompt 128 and 64 generated): GQA groups of 6 and 5
    (run as padded groups of 8) and MHA (groups of 1); every slot full,
    and ragged with an empty and a full slot."""
    b, s = 16, 192
    q, k, v = _qkv(b, s, h, hk, hd, torch.bfloat16, card, seed=h + hd)
    if lengths == "full":
        lengths = [s] * b
    else:
        gen = torch.Generator().manual_seed(3)
        lengths = [0, s] + [int(x) for x in torch.randint(1, s, (b - 2,), generator=gen)]
    ln = torch.tensor(lengths, dtype=torch.int32, device=card)
    before = _build.LAUNCHES["flash_decode"]
    got = fd_ops.flash_decode(q, k, v, ln)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_decode"] == before + 1
    _check_decode(got, fd_ref.decode_attention_ref(q, k, v, ln), ln)


def test_flash_decode_all_empty_batch_is_zero(card):
    """Every split of every row empty: the merge gives zeros."""
    q, k, v = _qkv(4, 512, 15, 5, 64, torch.bfloat16, card)
    assert fd_ops.decode_plan(4, 512, 15, 5, 64, True)[0] > 1
    got = fd_ops.flash_decode(q, k, v, torch.zeros(4, dtype=torch.int32, device=card))
    torch.cuda.synchronize()
    assert bool(torch.all(got == 0))


def test_flash_decode_refuses_what_the_kernel_does_not_take(card):
    q, k, v = _qkv(2, 16, 4, 2, 32, torch.float32, card)
    ln = torch.tensor([3, 16], dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="lengths"):
        fd_ops.flash_decode(q, k, v, ln[:1])
    with pytest.raises(ValueError, match="one query"):
        fd_ops.flash_decode(torch.cat([q, q], dim=1), k, v, ln)
    with pytest.raises(ValueError, match="multiple"):
        fd_ops.flash_decode(q[:, :, :3], k, v, ln)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        fd_ops.flash_decode(q.half(), k.half(), v.half(), ln)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        fd_ops.flash_decode(q, k.bfloat16(), v, ln)
    with pytest.raises(ValueError, match="int32"):
        fd_ops.flash_decode(q, k, v, ln.long())
    with pytest.raises(ValueError, match="contiguous"):
        fd_ops.flash_decode(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, ln)
    with pytest.raises(ValueError, match="one device"):
        fd_ops.flash_decode(q, k, v, ln.cpu())
    q3, k3, v3 = _qkv(1, 8, 2, 1, 264, torch.float32, card)
    with pytest.raises(ValueError, match="head_dim"):
        fd_ops.flash_decode(q3, k3, v3, torch.tensor([8], dtype=torch.int32, device=card))


def test_decode_step_with_flash_launches_k5_once_per_layer(card):
    from repro_torch.launch import serve as tserve
    from repro_torch.models import transformer as T

    cfg, params = tserve.build_model("smollm-360m", 0, device=card)  # reduced, fp32
    b, p = 3, 5
    toks = torch.randint(0, cfg.vocab_size, (b, p), generator=torch.Generator().manual_seed(0))
    toks = toks.to(torch.int32).to(card)
    pos = torch.arange(p, dtype=torch.int32, device=card)[None].expand(b, p)
    logits = {}
    for use_flash in (False, True):
        caches = T.init_caches(cfg, b, p + 2, per_slot=True, device=card)
        _, caches, _ = T.forward(cfg, params, toks, pos, caches)
        before = _build.LAUNCHES["flash_decode"]
        logits[use_flash], _ = T.decode_step(cfg, params, toks[:, -1:], caches, use_flash=use_flash)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["flash_decode"] - before == (cfg.num_layers if use_flash else 0)
    # fp32 attention summed in another order, carried through the layers
    scale = float(logits[False].abs().max())
    torch.testing.assert_close(logits[True], logits[False], rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize(
    "arch", ["qwen2-vl-2b", "musicgen-medium", "llama4-maverick-400b-a17b", "mixtral-8x7b", "recurrentgemma-9b"]
)
def test_new_archs_decode_through_k5_once_per_window_free_layer(card, arch):
    """The archs of the last model slice, reduced in fp32: a decode step with
    ``use_flash`` launches K5 once per attention layer without a window
    (every layer of qwen2-vl, musicgen and llama4; none of mixtral's SWA
    layers or recurrentgemma's RG-LRU and local layers) and gives the plain
    step's logits."""
    from repro_torch.launch import serve as tserve
    from repro_torch.models import transformer as T

    cfg, params = tserve.build_model(arch, 0, device=card)
    b, p = 3, 5
    toks = torch.randint(0, cfg.vocab_size, (b, p), generator=torch.Generator().manual_seed(0))
    toks = toks.to(torch.int32).to(card)
    pos = T.mrope_streams(cfg, torch.arange(p, dtype=torch.int32, device=card)[None].expand(b, p))
    window_free = sum(bt.split("+")[0] == "attn" for bt in cfg.layer_types())
    logits = {}
    for use_flash in (False, True):
        caches = T.init_caches(cfg, b, p + 2, per_slot=True, device=card)
        _, caches, _ = T.forward(cfg, params, toks, pos, caches)
        before = dict(_build.LAUNCHES)
        logits[use_flash], _ = T.decode_step(cfg, params, toks[:, -1:], caches, use_flash=use_flash)
        torch.cuda.synchronize()
        ran = {n: _build.LAUNCHES[n] - before[n] for n in before}
        assert ran == {n: (window_free if use_flash and n == "flash_decode" else 0) for n in before}
    scale = float(logits[False].abs().max())
    torch.testing.assert_close(logits[True], logits[False], rtol=1e-4, atol=1e-4 * scale)


# ------------------------------------------------------------------- K6


def _seq_qkv(b, s, h, hk, hd, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(n, generator=g) for n in ((b, s, h, hd), (b, s, hk, hd), (b, s, hk, hd)))
    return q.to(dtype).to(device), k.to(dtype).to(device), v.to(dtype).to(device)


def _assert_one_bf16_step(got, want):
    """K6's bf16 kernel multiplies the bf16 inputs on the tensor cores with
    fp32 sums and carries the unnormalised probabilities (each <= 1) into
    the PV product as two bf16 halves, hi + lo, which hold them to 2^-17;
    the plain version is fp32 throughout.  Both round the output once, so
    they differ by at most one bf16 step of each output element (<= 2^-7 of
    |out|), plus the sums' order near 0, bounded by 2^-8 of the largest
    output of the same query row (row 0 returns v[0] itself, a late row of
    a long sequence outputs far smaller values)."""
    wf = want.float()
    diff = (got.float() - wf).abs()
    bad = diff > 2.0**-7 * wf.abs() + 2.0**-8 * wf.abs().amax(dim=-1, keepdim=True)
    assert not bool(bad.any()), f"{int(bad.sum())} elements off, max {float(diff.max())}"


@pytest.mark.parametrize(
    "b,s,h,hk,hd,window,dtype",
    [
        (2, 64, 4, 2, 32, None, torch.float32),  # the JAX test's shapes
        (1, 100, 4, 4, 16, None, torch.float32),
        (2, 64, 8, 2, 32, 16, torch.float32),
        (1, 128, 4, 1, 64, 32, torch.float32),
        (1, 32, 2, 2, 8, None, torch.float32),
        (16, 512, 15, 5, 64, None, torch.bfloat16),  # the LM path's refresh shape
        (16, 128, 12, 2, 128, None, torch.bfloat16),  # qwen2-vl-2b's refresh
        (16, 128, 24, 24, 64, None, torch.bfloat16),  # musicgen-medium's refresh
        (2, 1000, 48, 8, 128, None, torch.bfloat16),  # ragged: 1000 = 15 * 64 + 40
        (1, 300, 16, 16, 256, 100, torch.bfloat16),
        (2, 200, 6, 3, 40, None, torch.bfloat16),  # hd not a multiple of 64
        (3, 77, 4, 2, 24, 5, torch.float32),
        # the bf16 kernel's edges: S below one tile and one past it, hd 8,
        # 16 and 256 (zero-padded to the tile's width), G in {1, 3, 6},
        # windows shorter than a tile (1: each row attends itself)
        (2, 40, 6, 6, 64, None, torch.bfloat16),
        (1, 65, 6, 2, 64, None, torch.bfloat16),
        (2, 100, 6, 1, 8, None, torch.bfloat16),
        (1, 130, 4, 4, 16, 10, torch.bfloat16),
        (1, 257, 6, 2, 256, None, torch.bfloat16),
        (2, 90, 12, 2, 128, 7, torch.bfloat16),
        (3, 33, 3, 1, 32, 1, torch.bfloat16),
    ],
)
def test_flash_attention_kernel_matches_plain(card, b, s, h, hk, hd, window, dtype):
    q, k, v = _seq_qkv(b, s, h, hk, hd, dtype, card)
    before = _build.LAUNCHES["flash_attention"]
    got = fd_ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = fd_ref.attention_ref(q, k, v, window=window)
    if dtype == torch.float32:
        # fp32 sums in another order
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    else:
        _assert_one_bf16_step(got, want)


def test_flash_attention_refuses_what_the_kernel_does_not_take(card):
    q, k, v = _seq_qkv(2, 16, 4, 2, 32, torch.float32, card)
    with pytest.raises(ValueError, match="multiple"):
        fd_ops.flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        fd_ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        fd_ops.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        fd_ops.flash_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), v)
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.zeros(q.numel() + 1, device=card)
        fd_ops.flash_attention(flat[1:].view(q.shape), k, v)
    with pytest.raises(ValueError, match="one device"):
        fd_ops.flash_attention(q, k, v.cpu())
    with pytest.raises(ValueError, match="head_dim"):
        fd_ops.flash_attention(*(t[..., :20].contiguous() for t in (q, k, v)))
    with pytest.raises(ValueError, match="window"):
        fd_ops.flash_attention(q, k, v, window=0)


def test_backward_through_flash_attention_raises(card):
    q, k, v = _seq_qkv(1, 16, 2, 1, 32, torch.float32, card)
    with pytest.raises(RuntimeError, match="forward-only"):
        fd_ops.flash_attention(q.requires_grad_(True), k, v)


def test_no_cache_forward_with_flash_launches_k6_once_per_layer(card):
    from repro_torch.launch import serve as tserve
    from repro_torch.models import transformer as T

    cfg, params = tserve.build_model("smollm-360m", 0, device=card)  # reduced, fp32
    b, s = 3, 70
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=torch.Generator().manual_seed(0))
    toks = toks.to(torch.int32).to(card)
    pos = torch.arange(s, dtype=torch.int32, device=card)[None].expand(b, s)
    hidden = {}
    with torch.no_grad():
        for use_flash in (False, True):
            before = _build.LAUNCHES["flash_attention"]
            hidden[use_flash], _, _ = T.forward(cfg, params, toks, pos, use_flash=use_flash)
            torch.cuda.synchronize()
            assert _build.LAUNCHES["flash_attention"] - before == (cfg.num_layers if use_flash else 0)
    # fp32 attention summed in another order, carried through the layers
    torch.testing.assert_close(hidden[True], hidden[False], rtol=1e-4, atol=1e-4)
    # a gradient pass through the K6 route raises; the plain route trains
    with pytest.raises(RuntimeError, match="forward-only"):
        T.lm_loss(cfg, _requiring_grad(params), toks, use_flash=True)
    T.lm_loss(cfg, _requiring_grad(params), toks).backward()


def _requiring_grad(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().requires_grad_(True)
    if isinstance(tree, dict):
        return {k: _requiring_grad(v) for k, v in tree.items()}
    return [_requiring_grad(v) for v in tree]


# ------------------------------------------------------------------- K7

from repro_torch.kernels.rwkv6_scan import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ref as wkv_ref  # noqa: E402


def _wkv_inputs(b, t, h, hd, dtype, device, seed=0, w_range=(0.4, 0.99)):
    """r/k/v normal in ``dtype``; w fp32 in ``w_range`` (None: the model's
    law exp(-exp(z)) with z ~ U(-6, 0), w in (0.37, 0.9975)); u normal;
    s0 normal, fp32."""
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn(b, t, h, hd, generator=g).to(dtype).to(device) for _ in range(3))
    if w_range is None:
        w = torch.exp(-torch.exp(torch.rand(b, t, h, hd, generator=g) * 6.0 - 6.0))
    else:
        w = w_range[0] + (w_range[1] - w_range[0]) * torch.rand(b, t, h, hd, generator=g)
    u = torch.randn(h, hd, generator=g)
    s0 = torch.randn(b, h, hd, hd, generator=g)
    return r, k, v, w.to(device), u.to(device), s0.to(device)


def assert_wkv6_close(got, want, atol=None):
    """K7's (y, s_out) against the plain version's.  fp32 (``atol`` given):
    elementwise at ``atol``.  bf16: each y element within one bf16 step of
    itself (2^-7 |y|) plus 2^-8 of the largest |y| of the same (b, t, h)
    row (the fp32 sums' order near 0); both versions compute in fp32 from
    the same bf16 inputs and round y once.  The fp32 state within 1e-5 of
    its (b, h) head's largest |S|: the two versions round each step's
    w S + k v differently (one fma against a product and a sum), about one
    fp32 step of |S| a step, and the decay forgets old steps' rounding."""
    (gy, gs), (wy, ws) = got, want
    assert gy.dtype == wy.dtype and gs.dtype == ws.dtype == torch.float32
    if atol is not None:
        torch.testing.assert_close(gy, wy, rtol=0, atol=atol)
        torch.testing.assert_close(gs, ws, rtol=0, atol=atol)
        return
    wf = wy.float()
    diff = (gy.float() - wf).abs()
    bad = diff > 2.0**-7 * wf.abs() + 2.0**-8 * wf.abs().amax(dim=-1, keepdim=True)
    assert not bool(bad.any()), f"y: {int(bad.sum())} elements off, max {float(diff.max())}"
    sdiff = (gs - ws).abs()
    sbad = sdiff > 1e-5 * ws.abs().amax(dim=(2, 3), keepdim=True)
    assert not bool(sbad.any()), f"s_out: {int(sbad.sum())} elements off, max {float(sdiff.max())}"


@pytest.mark.parametrize(
    "b,t,h,hd,dtype",
    [
        (2, 64, 2, 16, torch.float32),  # the JAX test's four shapes
        (1, 100, 3, 32, torch.float32),
        (2, 33, 1, 64, torch.float32),
        (1, 16, 2, 8, torch.float32),
        (16, 1, 64, 64, torch.bfloat16),  # rwkv6-7b's decode step
        (1, 128, 64, 64, torch.bfloat16),  # rwkv6-7b's prefill
        (4, 2048, 64, 64, torch.bfloat16),
        (1, 4096, 64, 64, torch.bfloat16),
        (3, 45, 5, 32, torch.float32),  # T not a multiple of the staged chunk
        (16, 128, 64, 64, torch.bfloat16),  # rwkv6-7b's scan prefill
        (2, 15, 4, 64, torch.bfloat16),  # T on each side of the chunked design's 16
        (2, 17, 4, 64, torch.bfloat16),
        (3, 15, 2, 32, torch.float32),
        (3, 16, 2, 32, torch.float32),
        (2, 37, 72, 32, torch.float32),  # one slice: A formed in the chunks' kernel
    ],
)
def test_wkv6_kernel_matches_plain(card, b, t, h, hd, dtype):
    w_range = (0.4, 0.99) if dtype == torch.float32 else None
    args = _wkv_inputs(b, t, h, hd, dtype, card, seed=t, w_range=w_range)
    s0 = args[5].clone()
    before = _build.LAUNCHES["wkv6"]
    got = wkv_ops.wkv6(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["wkv6"] == before + 1
    assert torch.equal(args[5], s0)  # s0 is read, not written
    assert got[0].shape == args[0].shape and got[1].shape == s0.shape
    # the design follows the shape alone: chunked from T = 16 at hd >= 16
    chunked = t >= wkv_ops.CHUNK and hd >= 16
    assert (wkv_ops.design(b, t, h, hd) > 0) == chunked
    y, s = wkv_ref.wkv6_scan_ref(*args)
    # the JAX sweep's bound for fp32
    assert_wkv6_close(got, (y.to(dtype), s), atol=5e-4 if dtype == torch.float32 else None)


def _edge_decays(w):
    """w with every fifth channel exactly 0 (the model's exponent clamped at
    8: exp(-exp(8)) is 0 in fp32) and every fifth from the second 1 - 1e-7
    (its slowest decay)."""
    w = w.clone()
    w[..., 0::5] = 0.0
    w[..., 1::5] = 1.0 - 1e-7
    return w


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wkv6_prefill_with_exact_zero_and_slowest_decays(card, dtype):
    """rwkv6-7b's admission prefill shape with decays that are exactly 0 and
    1 - 1e-7: the chunked design's running products give 0 where the
    recurrence does, and no NaN."""
    r, k, v, w, u, s0 = _wkv_inputs(1, 128, 64, 64, dtype, card, seed=11, w_range=None)
    w = _edge_decays(w)
    before = _build.LAUNCHES["wkv6"]
    got = wkv_ops.wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["wkv6"] == before + 1
    assert wkv_ops.design(1, 128, 64, 64) > 0
    assert bool(torch.isfinite(got[0].float()).all()) and bool(torch.isfinite(got[1]).all())
    y, s = wkv_ref.wkv6_scan_ref(r, k, v, w, u, s0)
    assert_wkv6_close(got, (y.to(dtype), s), atol=5e-4 if dtype == torch.float32 else None)


@pytest.mark.parametrize("b,t,h", [(2, 40, 4), (3, 20, 48)])  # four slices; one
def test_wkv6_chunked_kernel_takes_unaligned_inputs(card, b, t, h):
    """Inputs that start 2 bytes past a 16-byte boundary take the chunked
    kernels' ordinary loads in place of cp.async, with the same result."""
    args = _wkv_inputs(b, t, h, 64, torch.bfloat16, card, seed=3, w_range=None)

    def shifted(x):
        buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
        out = buf[1 : 1 + x.numel()].view(x.shape)
        out.copy_(x)
        return out

    r, k, v, w = (shifted(x) for x in args[:4])
    assert r.data_ptr() % 16 != 0 and r.is_contiguous()
    got = wkv_ops.wkv6(r, k, v, w, *args[4:])
    torch.cuda.synchronize()
    assert_wkv6_close(got, wkv_ops.wkv6(*args))
    y, s = wkv_ref.wkv6_scan_ref(*args)
    assert_wkv6_close(got, (y.to(torch.bfloat16), s))


def test_wkv6_kernel_state_handoff_equals_one_shot(card):
    """Two halves with the state handed over == one shot, at the JAX
    hand-off test's bound."""
    r, k, v, w, u, _ = _wkv_inputs(1, 32, 2, 16, torch.float32, card, seed=5, w_range=(0.5, 0.99))
    s0 = torch.zeros(1, 2, 16, 16, device=card)
    y_full, s_full = wkv_ops.wkv6(r, k, v, w, u, s0)
    y1, s_mid = wkv_ops.wkv6(*(x[:, :16].contiguous() for x in (r, k, v, w)), u, s0)
    y2, s_end = wkv_ops.wkv6(*(x[:, 16:].contiguous() for x in (r, k, v, w)), u, s_mid)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, rtol=0, atol=1e-4)
    torch.testing.assert_close(s_end, s_full, rtol=0, atol=1e-4)


def test_wkv6_refuses_what_the_kernel_does_not_take(card):
    r, k, v, w, u, s0 = _wkv_inputs(2, 8, 2, 16, torch.float32, card)
    with pytest.raises(ValueError, match="B, T, H, head_dim"):
        wkv_ops.wkv6(r[0], k, v, w, u, s0)
    with pytest.raises(ValueError, match="one shape"):
        wkv_ops.wkv6(r, k[:, :4], v, w, u, s0)
    with pytest.raises(ValueError, match="state shape"):
        wkv_ops.wkv6(r, k, v, w, u, s0[:1])
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        wkv_ops.wkv6(r.half(), k.half(), v.half(), w, u, s0)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        wkv_ops.wkv6(r, k.bfloat16(), v, w, u, s0)
    with pytest.raises(ValueError, match="must be float32"):
        wkv_ops.wkv6(r, k, v, w.bfloat16(), u, s0)
    with pytest.raises(ValueError, match="must be float32"):
        wkv_ops.wkv6(r, k, v, w, u, s0.double())
    with pytest.raises(ValueError, match="contiguous"):
        wkv_ops.wkv6(r.transpose(1, 2).contiguous().transpose(1, 2), k, v, w, u, s0)
    with pytest.raises(ValueError, match="one device"):
        wkv_ops.wkv6(r, k, v, w, u.cpu(), s0)
    r2, k2, v2, w2, u2, s2 = _wkv_inputs(1, 4, 2, 24, torch.float32, card)
    with pytest.raises(ValueError, match="head_dim"):
        wkv_ops.wkv6(r2, k2, v2, w2, u2, s2)


def test_backward_through_wkv6_raises(card):
    r, k, v, w, u, s0 = _wkv_inputs(1, 4, 2, 8, torch.float32, card)
    with pytest.raises(RuntimeError, match="forward-only"):
        wkv_ops.wkv6(r, k, v, w, u.requires_grad_(True), s0)


def test_rwkv_prefill_and_decode_with_flash_launch_k7_once_per_layer(card):
    from repro_torch.launch import serve as tserve
    from repro_torch.models import transformer as T

    cfg, params = tserve.build_model("rwkv6-7b", 0, device=card)  # reduced, fp32
    b, p = 3, 37
    toks = torch.randint(0, cfg.vocab_size, (b, p), generator=torch.Generator().manual_seed(0))
    toks = toks.to(torch.int32).to(card)
    pos = torch.arange(p, dtype=torch.int32, device=card)[None].expand(b, p)
    logits = {}
    for use_flash in (False, True):
        caches = T.init_caches(cfg, b, p + 2, per_slot=True, device=card)
        before = _build.LAUNCHES["wkv6"]
        _, caches, _ = T.forward(cfg, params, toks, pos, caches, use_flash=use_flash)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["wkv6"] - before == (cfg.num_layers if use_flash else 0)
        before = _build.LAUNCHES["wkv6"]
        logits[use_flash], _ = T.decode_step(cfg, params, toks[:, -1:], caches, use_flash=use_flash)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["wkv6"] - before == (cfg.num_layers if use_flash else 0)
    # the fp32 recurrence summed in another order, carried through the layers
    scale = float(logits[False].abs().max())
    torch.testing.assert_close(logits[True], logits[False], rtol=1e-4, atol=1e-4 * scale)


def test_funnel_fields_launch_k1_and_k2_once_on_the_candidate_block(card):
    """The funnel at C = 4,096, Q = 512 under the flaky scenario: one K1 and
    one K2 launch on the (512, 128) candidate block, whose (512, 512)
    kernel is exactly symmetric and within 1e-4 · max|L| of the plain
    chain on the same block."""
    from repro_torch.core import selection
    from repro_torch.fl import engine

    f = _profiles(4096, 128, torch.float32, card, seed=3)
    losses = torch.rand(4096, generator=torch.Generator().manual_seed(4)).to(card)
    cfg = engine.FLConfig(num_clients=4096, clients_per_round=10, candidate_frac=0.125, scenario="flaky")
    before = dict(_build.LAUNCHES)
    cand, kern, eig = engine.funnel_fields(
        cfg, torch.Generator(device=card).manual_seed(0), f, losses, strategy=selection.DPPSelection()
    )
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pairwise_dists_stats"] == before["pairwise_dists_stats"] + 1
    assert _build.LAUNCHES["normalized_gram"] == before["normalized_gram"] + 1
    assert cand.shape == (512,) and bool((cand[1:] > cand[:-1]).all()) and eig.num_items == 512
    want = gram_ref.kernel_from_profiles_ref(f[cand.long()])
    assert kern.shape == (512, 512) and torch.equal(kern, kern.T)
    assert float((kern - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize(
    "arch",
    ["rwkv6-7b", "qwen2-vl-2b", "musicgen-medium", "recurrentgemma-9b", "mixtral-8x7b",
     "llama4-maverick-400b-a17b"],
)
def test_full_width_gradient_step_through_one_unit_launches_no_kernel(card, arch):
    """One gradient step of the LM loss at the arch's published widths and
    dtypes, through one unit of each family's block pattern (RWKV, M-RoPE,
    sinusoidal, mixtral's softmax top-2 MoE; recurrentgemma's RG-LRU,
    RG-LRU and local attention; llama4's attn+mlp and attn+moe layers, the
    second with its sigmoid router, 128 experts and the shared expert,
    ~18.6 B parameters and as many gradients in bf16): finite, no kernel
    launched (K6 and K7 are forward-only and the gradient path takes the
    plain versions), and the same with remat, which recomputes the unit in
    the backward pass (MoE's scatter-add sums in the order its atomics
    land).  The first pass's gradients wait on the host while the second
    runs, since two sets of llama4's do not fit the card."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.fl.local_algos import make_grad_fn
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves

    full = get_arch(arch).model
    cfg = dataclasses.replace(full, num_layers=len(full.block_pattern))
    gc.collect()
    torch.cuda.empty_cache()
    params = T.init_params(torch.Generator(device=card).manual_seed(0), cfg, card)
    toks = torch.randint(0, cfg.vocab_size, (2, 128), generator=torch.Generator().manual_seed(1)).to(card)
    before = dict(_build.LAUNCHES)
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        loss, grads = make_grad_fn(lambda p, b: T.lm_loss(c, p, b))(params, toks)
        out[remat] = (loss, grads if remat else [g.cpu() for g in tree_leaves(grads)])
        del grads
    torch.cuda.synchronize()
    assert _build.LAUNCHES == before
    (l0, g0), (l1, g1) = out[False], out[True]
    assert bool(torch.isfinite(l0)) and float(l0) > 0
    torch.testing.assert_close(l1, l0, rtol=1e-5, atol=0.0)
    piece = 1 << 26  # elements compared at a time: an fp32 copy of an expert leaf would not fit
    for a, b in zip(tree_leaves(g1), g0):
        assert a.dtype == b.dtype and a.shape == b.shape
        scale = max(float(y.to(card).float().abs().max()) for y in b.flatten().split(piece))
        for x, y in zip(a.flatten().split(piece), b.flatten().split(piece)):
            assert bool(torch.isfinite(x).all())
            torch.testing.assert_close(x.float(), y.to(card).float(), rtol=0.0, atol=1e-2 * scale + 1e-30)
    del params, out, g1
    gc.collect()
    torch.cuda.empty_cache()


def _state_tensors(state):
    """Every tensor of a ServerState by a dotted name, on the CPU, and each
    generator's state."""
    import dataclasses

    out = {}

    def walk(name, v):
        if isinstance(v, torch.Generator):
            out[name] = v.get_state()
        elif isinstance(v, torch.Tensor):
            out[name] = v.cpu()
        elif isinstance(v, dict):
            for key, x in v.items():
                walk(f"{name}.{key}", x)
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                walk(f"{name}.{i}", x)
        elif dataclasses.is_dataclass(v):
            for f in dataclasses.fields(v):
                walk(f"{name}.{f.name}", getattr(v, f.name))
        elif v is not None:
            out[name] = torch.tensor(v)

    for f in dataclasses.fields(state):
        walk(f.name, getattr(state, f.name))
    return out


def _bits_equal(a, b):
    """Equal bit for bit, NaN where NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    eq = a == b
    if a.is_floating_point():
        eq |= torch.isnan(a) & torch.isnan(b)
    return bool(eq.all())


def test_cnn_engine_with_telemetry_equals_the_run_without_on_the_card(card):
    """FL-DP³S on a small CNN federation under ``chaos`` + ``trimmed_mean``
    with FedDyn, 4 rounds through the engine, from two states built alike
    (K1 + K2 at each init), with and without ``telemetry``: every output
    but the host timings, every state tensor and every generator's state
    equal bit for bit, and the telemetry's tensors computed on the card.
    cuDNN deterministic for the comparison (nothing else gives the CNN's
    rounds the same bits twice on the card)."""
    import numpy as np

    from repro_torch.core import profiles, selection
    from repro_torch.data import make_image_dataset, skewness_partition
    from repro_torch.fl import engine
    from repro_torch.models import cnn
    from repro_torch.obs import Telemetry

    c, n_c = 20, 30
    ds = make_image_dataset(n=c * n_c, seed=2)
    shards = skewness_partition(ds.ys, c, 0.8, 10, samples_per_client=n_c, seed=0)
    xs = torch.as_tensor(np.stack([ds.xs[s] for s in shards]), device=card)
    ys = torch.as_tensor(np.stack([ds.ys[s] for s in shards]), device=card)
    params = cnn.init_cnn(torch.Generator(device=card).manual_seed(0), channels=(4, 8), fc1_dim=16)
    deterministic = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        prof = profiles.profile_all_clients(cnn.apply_with_features, params, list(xs))
        with torch.no_grad():
            losses = torch.stack([cnn.cnn_loss(params, x, y) for x, y in zip(xs, ys)])
        runs = {}
        for telemetry in (False, True):
            cfg = engine.FLConfig(num_clients=c, clients_per_round=4, local_epochs=1, lr=0.05, eval_every=2,
                                  faults="chaos", aggregator="trimmed_mean", local_algo="feddyn",
                                  feddyn_alpha=0.1, telemetry=telemetry)
            before = dict(_build.LAUNCHES)
            state = engine.init_server_state(cfg, params, xs, ys, prof, losses, selection.DPPSelection(),
                                             device=card, loss_fn=cnn.cnn_loss)
            assert _build.LAUNCHES["pairwise_dists_stats"] == before["pairwise_dists_stats"] + 1
            assert _build.LAUNCHES["normalized_gram"] == before["normalized_gram"] + 1
            fn = engine.make_round_fn(cfg, cnn.cnn_loss, (selection.DPPSelection(),), accuracy_fn=cnn.accuracy)
            runs[telemetry] = engine.run_scanned(fn, state, 4)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic
    (off_state, off), (on_state, on) = runs[False], runs[True]
    a, b = _state_tensors(off_state), _state_tensors(on_state)
    assert set(a) == set(b) and all(_bits_equal(a[k], b[k]) for k in a), [k for k in a if not _bits_equal(a[k], b[k])]
    assert set(on) == set(off) | {"telemetry"}
    for name in off:
        if not name.startswith("t_"):
            assert _bits_equal(off[name], on[name]), name
    tel = on["telemetry"]
    assert isinstance(tel, Telemetry) and tel.cache_age.tolist() == [0, 1, 2, 3]
    assert torch.equal(tel.survivors.long(), on["survivors"].long())
    assert bool(((tel.spectrum_erank >= 1) & (tel.spectrum_erank <= c)).all())


def test_serve_engine_with_a_sink_equals_the_engine_without_on_the_card(card, tmp_path):
    """smollm-360m (reduced fp32) with K5 through ``ServeEngine``: 7
    requests of mixed budgets with a sink and without: the same tokens bit
    for bit, one shape signature per entry point, K5 launched as often in
    both runs, and 7 submissions, admissions and finishes."""
    import numpy as np

    from repro_torch.launch.serve import build_model
    from repro_torch.obs import TelemetrySink, load_events
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg, params = build_model("smollm-360m", 0, device=card)
    b, p, g = 3, 6, 8
    scfg = ServeConfig(batch=b, cache_len=p + g, max_new=g, decode_chunk=4, use_flash=True)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(7, p)).astype(np.int32)
    budgets = [8, 3, 1, 5, 8, 2, 4]

    def traffic(sink):
        eng = ServeEngine(cfg, scfg, params, prompt_len=p, telemetry=sink)
        for i, n in enumerate(budgets):
            eng.submit(prompts[i], n)
        before = _build.LAUNCHES["flash_decode"]
        fin = eng.run()
        torch.cuda.synchronize()
        assert eng.compile_counts() == {"decode_chunk": 1, "admit": 1}
        return {f.seq_id: f.tokens for f in fin}, _build.LAUNCHES["flash_decode"] - before, eng.state.step

    with TelemetrySink(str(tmp_path / "s.jsonl")) as sink:
        on, k5_on, steps_on = traffic(sink)
    off, k5_off, steps_off = traffic(None)
    assert set(on) == set(off) == set(range(7)) and all(np.array_equal(on[i], off[i]) for i in on)
    assert k5_on == k5_off == cfg.num_layers * steps_on and steps_on == steps_off > 0
    kinds = [e["event"] for e in load_events(str(tmp_path / "s.jsonl"))]
    assert kinds.count("serve_submit") == kinds.count("serve_admit") == kinds.count("serve_finish") == 7


# ----------------------------------------------- the dry run against the card


def _hold_workspaces(card):
    """Make sure this process holds cuBLAS's workspaces for this thread and
    for autograd's thread (a matmul and its gradient), so that a step's peak
    read from here on is the dry run's ``peak_bytes - workspace_bytes``."""
    a = torch.randn(64, 64, device=card, dtype=torch.bfloat16, requires_grad=True)
    torch.autograd.grad((a @ a).float().sum(), a)
    torch.cuda.synchronize()


def _on_card(card, case):
    """The case's step built and run on the card: its output, its FLOPs by
    FlopCounterMode and its peak above what was allocated before the
    arguments were made, cuBLAS's workspaces already held."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun

    gc.collect()
    torch.cuda.empty_cache()
    _hold_workspaces(card)
    m0 = torch.cuda.memory_allocated(card)
    step, args, _ = dryrun.build_step(case, card)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(card)
    fc = FlopCounterMode(display=False)
    with fc:
        out = step(*args)
    torch.cuda.synchronize()
    return out, fc.get_total_flops(), torch.cuda.max_memory_allocated(card) - m0


def test_cublas_workspace_per_thread_is_the_dry_runs(card):
    """A fresh process's first matmul, and its gradient on autograd's
    thread, each allocate HW.CUBLAS_WORKSPACE beside their results: the
    workspaces the dry run adds to a step's peak."""
    import subprocess
    import sys

    code = (
        "import torch\n"
        "a = torch.randn(64, 64, device='cuda', dtype=torch.bfloat16, requires_grad=True)\n"
        "m0 = torch.cuda.memory_allocated()\n"
        "y = a @ a\n"
        "m1 = torch.cuda.memory_allocated()\n"
        "(g,) = torch.autograd.grad(y.float().sum(), a)\n"
        "torch.cuda.synchronize()\n"
        "print(m1 - m0 - y.untyped_storage().nbytes(), torch.cuda.memory_allocated() - m1 - g.untyped_storage().nbytes())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout
    from repro_torch.analysis.roofline import HW

    assert [int(x) for x in out.split()] == [HW.CUBLAS_WORKSPACE] * 2, out


@pytest.mark.parametrize("contiguous", [True, False])
def test_softmax_backward_buffers_are_the_dry_runs(card, contiguous):
    """The buffers ``_softmax_backward_data`` allocates for itself on the
    card, at the plain attention's score shape (B, Hk, G, chunk, S) of
    smollm-360m, equal ``analysis/ops.card_temporaries``."""
    from repro_torch.analysis.ops import card_temporaries

    op = torch.ops.aten._softmax_backward_data.default
    shape = (1, 5, 3, 512, 4096)
    grad = torch.randn(shape, device=card) if contiguous else torch.randn(1, 3, 5, 512, 4096, device=card).transpose(1, 2)
    out = torch.softmax(torch.randn(shape, device=card), -1)
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated(card)
    torch.cuda.reset_peak_memory_stats(card)
    res = op(grad, out, -1, torch.float32)
    torch.cuda.synchronize()
    held = torch.cuda.max_memory_allocated(card) - m0 - res.untyped_storage().nbytes()
    assert held == card_temporaries(op, (grad, out, -1, torch.float32)) > 0


@pytest.mark.parametrize("use_flash", [False, True])
def test_dryrun_decode_step_matches_the_card(card, use_flash):
    """smollm-360m's decode_32k step at full width and depth, batch 4: the
    FLOPs the card's run counts equal the dry run's (through K5, whose
    launches FlopCounterMode does not see, the dry run's counted part, its
    K5 count being the plain version's), and max_memory_allocated is within
    10% of the dry run's peak without the workspaces this process holds."""
    from repro_torch.launch import dryrun

    case = dryrun.DryRunCase("smollm-360m", "decode_32k", batch=4, use_flash=use_flash)
    rec = dryrun.run_case(case)
    assert rec["ok"], rec.get("error")
    _build.reset_launches()
    (logits, _), flops, peak = _on_card(card, case)
    assert bool(torch.isfinite(logits.float()).all())
    assert _build.LAUNCHES["flash_decode"] == (32 if use_flash else 0)
    assert flops == (rec["flops_counted"] if use_flash else rec["flops"])
    want = rec["peak_bytes"] - rec["workspace_bytes"]
    assert abs(peak / want - 1) <= 0.10, (peak, want)


def test_dryrun_mode_a_round_matches_the_card(card):
    """smollm-360m's Mode-A round at full width and depth with two clients
    of one 4,096-token sequence and two local steps, so that the dry run
    replays a gradient across steps and across clients: FLOPs equal to the
    dry run's, max_memory_allocated within 10% of its peak without the
    workspaces this process holds, a finite loss."""
    import math

    from repro_torch.launch import dryrun

    case = dryrun.DryRunCase("smollm-360m", "train_4k", batch=2, clients=2, local_steps=2)
    rec = dryrun.run_case(case)
    assert rec["ok"], rec.get("error")
    assert rec["grads_counted"] == 1 and rec["grads_replayed"] == 3
    (params, loss), flops, peak = _on_card(card, case)
    assert math.isfinite(float(loss))
    assert flops == rec["flops"]
    want = rec["peak_bytes"] - rec["workspace_bytes"]
    assert abs(peak / want - 1) <= 0.10, (peak, want)


@pytest.fixture
def fake_group():
    """A mesh test's fake default group (``launch/mesh.make_fake_mesh``)
    lives only while the test runs: the NCCL client-mesh tests after it
    share the process."""
    yield
    from repro_torch.launch.mesh import release_fake_meshes

    release_fake_meshes()


def _mesh_on_card(card, case):
    """Rank 0's program of a sharded case on the card (``dryrun.
    materialize``: real tensors at the device's shapes, the ``fake`` group
    moving nothing), after the dry run's record of it -> (the counter, the
    peak above what was allocated before the arguments were made, the
    record); kernel launches counted from the real run's start."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis.ops import StepCounter
    from repro_torch.launch import dryrun

    rec = dryrun.run_case(case)
    assert rec["ok"], rec.get("traceback")
    mesh = dryrun.case_mesh(case)
    with FakeTensorMode():
        step, fake_args, _ = dryrun.build_sharded_step(case, mesh, "cuda")
    gc.collect()
    torch.cuda.empty_cache()
    _hold_workspaces(card)
    m0 = torch.cuda.memory_allocated(card)
    args = dryrun.materialize(fake_args, card)
    counter = StepCounter(mesh)
    counter.hold(args)
    _build.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(card)
    with counter:
        step(*args)
    torch.cuda.synchronize()
    return counter, torch.cuda.max_memory_allocated(card) - m0, rec


def test_mesh_decode_launches_k7_at_the_devices_heads(card, fake_group):
    """rwkv6-7b's decode_32k step on the 16 x 16 mesh, rank 0 on the card:
    K7 launched once a layer at the device's (8, 1, 4, 64) through
    ``local_map``, its first real call's outputs within the bf16 bound of
    the plain scan on the same local inputs; FLOPs counted on the local
    tensors equal the sharded dry run's; collectives kind by kind."""
    from repro_torch.analysis.ops import collective_bytes
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.kernels.rwkv6_scan.ref import wkv6_scan_ref
    from repro_torch.launch import dryrun

    calls, kernel = [], wkv_ops.wkv6

    def spy(*a):
        y, s_new = kernel(*a)
        if not _build.is_fake(a[0]):  # the real run's, not the dry run's
            calls.append((tuple(a[0].shape), [x.clone() for x in a], y.clone(), s_new.clone()))
        return y, s_new

    wkv_ops.wkv6 = spy
    try:
        case = dryrun.DryRunCase("rwkv6-7b", "decode_32k", multi_pod=False, mesh_device="cuda")
        counter, peak, rec = _mesh_on_card(card, case)
    finally:
        wkv_ops.wkv6 = kernel
    assert _build.LAUNCHES["wkv6"] == rec["kernel_calls"]["wkv6"] == len(calls) == 32
    assert {c[0] for c in calls} == {(8, 1, 4, 64)}
    _, inputs, y, s_new = calls[0]
    want_y, want_s = wkv6_scan_ref(*inputs)
    want_y = want_y.to(y.dtype).float()
    atol = 2.0**-8 * want_y.abs().amax(dim=-1, keepdim=True)
    assert bool(((y.float() - want_y).abs() <= 2.0**-7 * want_y.abs() + atol).all())
    assert bool(((s_new - want_s).abs() <= 1e-5 * want_s.abs().amax(dim=(2, 3), keepdim=True)).all())
    assert counter.flops == rec["flops_counted"]
    assert collective_bytes(counter.collectives)["calls"] == rec["collectives"]["calls"]
    assert abs(peak / (rec["peak_bytes"] - rec["workspace_bytes"]) - 1) <= 0.10


def test_mesh_mode_a_round_flops_on_the_card(card, fake_group):
    """smollm-360m's Mode-A round on the 16 x 16 mesh cut to one client of
    one sequence a device and two local steps (``chip_smoke.py`` phase
    8b's): the FLOPs rank 0's real run counts on its local tensors equal
    the sharded dry run's, its collectives kind by kind, its peak within
    10% of the dry run's (without the workspaces this process holds)."""
    from repro_torch.analysis.ops import collective_bytes
    from repro_torch.launch import dryrun

    case = dryrun.DryRunCase("smollm-360m", "train_4k", batch=16, local_steps=2, multi_pod=False,
                             mesh_device="cuda")
    counter, peak, rec = _mesh_on_card(card, case)
    assert counter.flops == rec["flops_counted"] > 0
    assert collective_bytes(counter.collectives)["calls"] == rec["collectives"]["calls"]
    assert abs(peak / (rec["peak_bytes"] - rec["workspace_bytes"]) - 1) <= 0.10


# ------------------------------------------------------------- client mesh


def _mesh_federation(card, c=8, n_c=6, feat=8, ncls=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    xs = torch.randn(c, n_c, feat, generator=g)
    ys = torch.randint(0, ncls, (c, n_c), generator=g).to(torch.int32)
    params = {"w": (0.01 * torch.randn(feat, ncls, generator=g)).to(card), "b": torch.zeros(ncls, device=card)}
    return xs.numpy(), ys.numpy(), params


def _mesh_loss(params, x, y):
    logp = torch.log_softmax(x @ params["w"] + params["b"], -1)
    return -torch.mean(torch.gather(logp, -1, y.long()[..., None]))


def test_nccl_mesh_of_one_rank(card):
    """The client mesh on the card: NCCL at world size 1, one counted
    all-reduce a call, its tensor summed in place; more ranks than cards
    raise."""
    from repro_torch.launch import mesh as mesh_lib

    mesh = mesh_lib.make_client_mesh(1)
    try:
        assert (mesh.backend, mesh.device, mesh.size) == ("nccl", torch.device("cuda", 0), 1)
        x = torch.arange(6.0, device=card)
        assert mesh.all_reduce(x) is x and torch.equal(x, torch.arange(6.0, device=card))
        assert mesh.all_reduce_calls == 1
        with pytest.raises(ValueError, match="on cpu"):
            mesh.all_reduce(torch.ones(2))
    finally:
        mesh.close()
    with pytest.raises(ValueError, match="CUDA devices visible"):
        mesh_lib.make_client_mesh(torch.cuda.device_count() + 1, store=torch.distributed.HashStore())


@pytest.mark.parametrize("cap", [None, 3])
def test_sharded_round_on_the_card_equals_the_unsharded_one(card, cap):
    """One NCCL rank: each round's cohort the unsharded engine's from the
    same seed, params and losses within 1e-5, one all-reduce a round."""
    from repro_torch.core import selection
    from repro_torch.fl import engine
    from repro_torch.launch import mesh as mesh_lib

    xs, ys, params = _mesh_federation(card)
    cfg = engine.FLConfig(num_clients=8, clients_per_round=3, local_epochs=2, lr=0.1, num_classes=4, seed=0,
                          cohort_cap=cap)
    with torch.no_grad():
        l0 = torch.stack([_mesh_loss(params, torch.as_tensor(x, device=card), torch.as_tensor(y, device=card))
                          for x, y in zip(xs, ys)])
    prof = torch.as_tensor(xs.mean(1), device=card)
    strat = selection.DPPSelection()
    ref_state = engine.init_server_state(cfg, params, xs, ys, prof, l0, strat)
    ref, ref_outs = engine.run_scanned(engine.make_round_fn(cfg, _mesh_loss, (strat,)), ref_state, 4)
    mesh = mesh_lib.make_client_mesh(1)
    try:
        state = engine.init_server_state(cfg, params, xs, ys, prof, l0, strat, mesh=mesh)
        fn = engine.make_round_fn(cfg, _mesh_loss, (strat,), mesh=mesh)
        mesh.reset_counts()
        final, outs = engine.run_scanned(fn, state, 4)
        assert mesh.all_reduce_calls == 4
    finally:
        mesh.close()
    assert torch.equal(outs["selected"], ref_outs["selected"])
    for name in ref.params:
        assert float((final.params[name] - ref.params[name]).abs().max()) <= 1e-5
    assert float((final.losses - ref.losses).abs().max()) <= 1e-5
