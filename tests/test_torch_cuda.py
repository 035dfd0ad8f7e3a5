"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips without a card; this
file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

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


@pytest.mark.parametrize(
    "c,q,dtype",
    [(100, 128, torch.float32), (1000, 700, torch.float32), (513, 257, torch.bfloat16), (5, 3, torch.float32)],
)
def test_pairwise_dists_stats_kernel_matches_plain(card, c, q, dtype):
    f = _profiles(c, q, dtype, card)
    before = _build.LAUNCHES["pairwise_dists_stats"]
    s0, lo, hi = pw_ops.pairwise_dists_stats(f)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pairwise_dists_stats"] == before + 1
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
