"""The port's decoder-LM modules (``repro_torch.models``, ``configs`` and
the K5 wrapper) against the JAX package on the CPU, with JAX-initialised
weights carried across by ``params_from_jax``.  JAX's Pallas kernel runs in
interpret mode, as the JAX package's own tests run it; the port's K5
wrapper runs its plain version for CPU tensors (the CUDA kernel itself is
held against that plain version in ``tests/test_torch_cuda.py``).

Tolerances: everything here is fp32.  The two frameworks sum the same
products in another order (XLA's and PyTorch's CPU GEMMs, softmax and
RoPE's pow/sin/cos), which moves results by a few fp32 ulps of the
largest terms summed: ``atol = rtol = 1e-5`` on O(1) activations, and the
same relative to max|x| for the larger logits."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.kernels.flash_attention import ref as jflash_ref  # noqa: E402
from repro.kernels.flash_attention.decode import flash_decode_kernel  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jT  # noqa: E402

from repro_torch.configs import ARCH_NAMES, get_arch  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tflash  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tflash_ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402

DENSE = ["smollm-360m", "granite-3-2b", "internlm2-20b", "gemma-7b"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    """numpy tree -> torch tree (CPU)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _cfgs(arch, **overrides):
    kw = dict(param_dtype="float32", dtype="float32", remat=False, **overrides)
    return jget_arch(arch).model.reduced(**kw), get_arch(arch).model.reduced(**kw)


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ------------------------------------------------------------- configs


@pytest.mark.parametrize("arch", DENSE)
def test_dense_configs_are_the_jax_configs(arch):
    """Every field the port keeps holds the JAX config's value, at full
    width and reduced."""
    jm, tm = jget_arch(arch).model, get_arch(arch).model
    for full_j, full_t in ((jm, tm), (jm.reduced(), tm.reduced())):
        want = dataclasses.asdict(full_j)
        for name, value in dataclasses.asdict(full_t).items():
            assert value == want[name], (arch, name)
        assert full_t.layer_types() == full_j.layer_types()
        assert (full_t.q_dim, full_t.kv_dim) == (full_j.q_dim, full_j.kv_dim)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_get_arch_gives_every_arch_the_jax_config(arch):
    """All ten archs: the port's ``ModelConfig`` equals JAX's field by
    field, at full width and reduced, with the same layer types; so do the
    ``FLRunConfig``, the optimizer, ``long_context`` and the long-context
    model."""
    js, ts = jget_arch(arch), get_arch(arch)
    jm, tm = js.model, ts.model
    for full_j, full_t in ((jm, tm), (jm.reduced(), tm.reduced())):
        assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j), arch
        assert full_t.layer_types() == full_j.layer_types()
    assert dataclasses.asdict(ts.fl) == dataclasses.asdict(js.fl), arch
    assert (ts.optimizer, ts.long_context) == (js.optimizer, js.long_context), arch
    assert dataclasses.asdict(ts.long_context_model()) == dataclasses.asdict(js.long_context_model()), arch


# --------------------------------------------------------------- layers


def test_rms_norm_matches_jax():
    x, scale = _normal((3, 5, 64), 0), 1.0 + 0.1 * _normal((64,), 1)
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale))
    got = tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rms_norm_bf16_computes_in_fp32_and_casts_back():
    x = torch.from_numpy(_normal((2, 3, 32), 2)).bfloat16()
    scale = torch.ones(32, dtype=torch.bfloat16)
    got = tlayers.rms_norm(x, scale)
    assert got.dtype == torch.bfloat16
    x32 = x.float()
    want = (x32 * torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + 1e-6)).bfloat16()
    assert torch.equal(got, want)


def test_apply_rope_matches_jax():
    x = _normal((2, 7, 3, 64), 3)
    pos = np.random.default_rng(4).integers(0, 5000, size=(2, 7)).astype(np.int32)
    for positions in (pos, pos % 64):  # angles up to 5000 rad, and small ones
        want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(positions), 10_000.0)
        got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(positions), 10_000.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _exact_mlp_weights(cfg, variant, seed):
    """bf16 MLP weights (numpy fp32 holding bf16 values) on which every GEMM
    sum is exact in fp32, whatever its order: wi and wg are multiples of
    2^-5 in [-1/4, 1/4] (with inputs that are multiples of 2^-2 in [-2, 2],
    a product is a multiple of 2^-7 and a sum of d_model of them stays
    under 2^24 of those steps), and wo is a signed permutation, so h @ wo
    adds one product to zeros.  The frameworks' GEMMs take their sums in
    other orders, and on general weights that flips one bf16 rounding in a
    few thousand outputs; here only the activation can part them."""
    rng = np.random.default_rng(seed)
    d, ff = cfg.d_model, cfg.d_ff
    assert ff == d  # wo is a permutation: every h element reaches the output
    p = {"wi": {"w": rng.integers(-8, 9, size=(d, ff)) * 2.0**-5}}
    if variant != "gelu":
        p["wg"] = {"w": rng.integers(-8, 9, size=(d, ff)) * 2.0**-5}
    wo = np.zeros((ff, d))
    wo[rng.permutation(ff), np.arange(d)] = rng.choice([-1.0, 1.0], size=d)
    p["wo"] = {"w": wo}
    return jax.tree_util.tree_map(lambda a: a.astype(np.float32), p)


def _mlp_rounding_once(variant, p, x):
    """The bf16 MLP with PyTorch's fused activations, each rounding once."""
    import torch.nn.functional as F

    if variant == "swiglu":
        h = F.silu(x @ p["wg"]["w"]) * (x @ p["wi"]["w"])
    elif variant == "geglu":
        h = F.gelu(x @ p["wg"]["w"], approximate="tanh") * (x @ p["wi"]["w"])
    else:
        h = F.gelu(x @ p["wi"]["w"], approximate="tanh")
    return h @ p["wo"]["w"]


@pytest.mark.parametrize(
    "variant,dtype",
    [pytest.param(v, "float32", id=v) for v in ("swiglu", "geglu", "gelu")]
    + [pytest.param(v, "bfloat16", id=f"{v}-bf16") for v in ("swiglu", "geglu", "gelu")],
)
def test_apply_mlp_matches_jax(variant, dtype):
    """fp32: at 1e-5.  bf16: bit for bit, on the same bf16 weights and
    inputs (``_exact_mlp_weights``), because the port's activations round
    each operation as XLA's expansion of ``jax.nn.silu`` and
    ``jax.nn.gelu(approximate=True)`` does; the same MLP with
    ``F.silu``/``F.gelu`` (one rounding) parts from JAX's on these inputs."""
    if dtype == "float32":
        jcfg, tcfg = _cfgs("smollm-360m", mlp_variant=variant)
        jp = jlayers.init_mlp(jax.random.key(5), jcfg)
        x = _normal((2, 4, jcfg.d_model), 6)
        want = jlayers.apply_mlp(jcfg, jp, jnp.asarray(x))
        tp = _t(_np(jp))
        assert set(tp) == ({"wi", "wo"} if variant == "gelu" else {"wi", "wg", "wo"})
        got = tlayers.apply_mlp(tcfg, tp, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        return
    kw = dict(param_dtype="bfloat16", dtype="bfloat16", remat=False, mlp_variant=variant, d_ff=256)
    jcfg, tcfg = jget_arch("smollm-360m").model.reduced(**kw), get_arch("smollm-360m").model.reduced(**kw)
    p = _exact_mlp_weights(jcfg, variant, 5)
    x = np.random.default_rng(6).integers(-8, 9, size=(2, 8, jcfg.d_model)).astype(np.float32) / 4
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    want = np.asarray(jlayers.apply_mlp(jcfg, jp, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(a).bfloat16(), p)
    xt = torch.from_numpy(x).bfloat16()
    got = tlayers.apply_mlp(tcfg, tp, xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert (_mlp_rounding_once(variant, tp, xt).float().numpy() != want).mean() > 0.05


def test_activations_round_as_jax_does():
    """``layers.sigmoid``, ``silu`` and ``gelu_tanh`` against
    ``jax.nn.sigmoid``, ``jax.nn.silu`` and ``jax.nn.gelu(approximate=True)``
    on a bf16 sweep of N(0, 4²), bit for bit; PyTorch's fused ``F.silu`` and
    ``F.gelu(approximate="tanh")`` round once and part from JAX's in about
    a third of elements (the control).  In fp32 at 1e-5."""
    import torch.nn.functional as F

    x = np.random.default_rng(18).normal(scale=4.0, size=(65536,)).astype(np.float32)
    pairs = (
        (jax.nn.sigmoid, tlayers.sigmoid, torch.sigmoid),
        (jax.nn.silu, tlayers.silu, F.silu),
        (lambda v: jax.nn.gelu(v, approximate=True), tlayers.gelu_tanh,
         lambda v: F.gelu(v, approximate="tanh")),
    )
    for jfn, tfn, fused in pairs:
        want = np.asarray(jfn(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
        got = tfn(torch.from_numpy(x).bfloat16())
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)
        assert (fused(torch.from_numpy(x).bfloat16()).float().numpy() != want).mean() > 0.2
        np.testing.assert_allclose(tfn(torch.from_numpy(x)).numpy(), np.asarray(jfn(jnp.asarray(x))), **TOL)


def test_init_mlp_shapes_and_scale():
    _, tcfg = _cfgs("gemma-7b")
    p = tlayers.init_mlp(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert p["wi"]["w"].shape == (tcfg.d_model, tcfg.d_ff)
    assert p["wo"]["w"].shape == (tcfg.d_ff, tcfg.d_model)
    # N(0, 1/d_in): the sample std of 131k draws is within 2% of d_in^-0.5
    assert abs(float(p["wi"]["w"].std()) * tcfg.d_model**0.5 - 1.0) < 0.02


# ------------------------------------------------------------------- K5


@pytest.mark.parametrize(
    "b,s,h,hk,hd,bk,lengths",
    [
        (5, 40, 4, 2, 32, 16, [0, 1, 7, 33, 40]),  # the JAX test's three shapes
        (2, 64, 4, 4, 16, 32, [64, 50]),
        (3, 16, 4, 1, 64, 128, [16, 3, 9]),
        (4, 40, 15, 5, 64, 16, [0, 40, 17, 1]),  # smollm's heads, an empty slot
    ],
)
def test_flash_decode_matches_pallas_and_ref(b, s, h, hk, hd, bk, lengths):
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((b, 1, h, hd), (b, s, hk, hd), (b, s, hk, hd)))
    ln = np.asarray(lengths, np.int32)
    jargs = [jnp.asarray(a) for a in (q, k, v, ln)]
    pallas = flash_decode_kernel(*jargs, block_k=bk, interpret=True)
    jref = jflash_ref.decode_attention_ref(*jargs)
    got = tflash.flash_decode(*(torch.from_numpy(a) for a in (q, k, v, ln)))
    assert got.shape == (b, 1, h, hd) and got.dtype == torch.float32
    # the JAX flash-decode test's bound
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), atol=1e-5)
    assert np.all(got.numpy()[ln == 0] == 0)


def _split_decode(q, k, v, lengths, split, rescale=True):
    """K5's split-KV arithmetic in torch on the CPU.  The KV axis is cut
    into splits of ``split`` positions; each split gives a partial per
    (slot, query head): the row max m of its scores in log2 units (scaled
    by hd^-0.5 * log2(e)), the sum l of exp2(score - m) and the
    unnormalised P.V sum, or an empty partial (m = -inf, l = 0) where the
    split starts at or past the slot's length.  The partials are merged
    with the log-sum-exp rescale, skipping empty ones; a row whose every
    split is empty gives zeros.  ``rescale=False`` (the control) adds the
    partials without it."""
    b, _, h, hd = q.shape
    s, hk = k.shape[1], k.shape[2]
    qs = q[:, 0].float().reshape(b, hk, h // hk, hd) * (hd**-0.5 * 1.4426950408889634)
    parts = []
    for lo in range(0, s, split):
        hi = min(lo + split, s)
        kt, vt = (t[:, lo:hi].float().permute(0, 2, 1, 3) for t in (k, v))  # (B, Hk, n, hd)
        valid = (torch.arange(lo, hi)[None, :] < lengths[:, None].long())[:, None, None, :]
        sc = torch.where(valid, qs @ kt.transpose(-1, -2), -torch.inf)  # (B, Hk, G, n)
        m = sc.amax(-1)
        p = torch.where(valid, torch.exp2(sc - m[..., None]), 0.0)
        parts.append((m, p.sum(-1), p @ vt))
    m, l, acc = (torch.stack(t) for t in zip(*parts))
    if rescale:
        big = torch.where(l > 0, m, -torch.inf).amax(0)
        w = torch.where(l > 0, torch.exp2(m - big), 0.0)
    else:
        w = (l > 0).float()
    lsum, out = (l * w).sum(0), (acc * w[..., None]).sum(0)
    out = torch.where(lsum[..., None] > 0, out / lsum[..., None], 0.0)
    return out.reshape(b, 1, h, hd).to(q.dtype)


@pytest.mark.parametrize(
    "b,s,h,hk,hd,split,lengths",
    [
        (5, 40, 4, 2, 32, 16, [0, 1, 7, 33, 40]),  # the JAX test's three shapes
        (5, 40, 4, 2, 32, 7, [0, 1, 7, 33, 40]),
        (2, 64, 4, 4, 16, 32, [64, 50]),
        (2, 64, 4, 4, 16, 5, [64, 50]),
        (3, 16, 4, 1, 64, 64, [16, 3, 9]),
        (3, 16, 4, 1, 64, 1, [16, 3, 9]),
        # 0; 1; on a split boundary (16, 32); inside the last split (49);
        # S = 50 not a multiple of the split; smollm's heads
        (6, 50, 15, 5, 64, 16, [0, 1, 16, 32, 49, 50]),
        (3, 24, 4, 2, 32, 8, [0, 0, 0]),  # a batch that is all empty
    ],
)
def test_k5_split_and_merge_match_pallas_and_ref(b, s, h, hk, hd, split, lengths):
    """The split-KV arithmetic of K5's CUDA kernel (``_split_decode``) at
    the JAX test's bound, 1e-5, against the Pallas kernel in interpret mode
    and the plain version; a merge without the rescale (the control) breaks
    it wherever a row has two non-empty splits."""
    rng = np.random.default_rng(b * 100 + s + split)
    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((b, 1, h, hd), (b, s, hk, hd), (b, s, hk, hd)))
    ln = np.asarray(lengths, np.int32)
    jargs = [jnp.asarray(a) for a in (q, k, v, ln)]
    pallas = np.asarray(flash_decode_kernel(*jargs, block_k=16, interpret=True))
    targs = [torch.from_numpy(a) for a in (q, k, v, ln)]
    got = _split_decode(*targs, split)
    np.testing.assert_allclose(got.numpy(), pallas, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), tflash_ref.decode_attention_ref(*targs).numpy(), atol=1e-5)
    assert np.all(got.numpy()[ln == 0] == 0)
    control = _split_decode(*targs, split, rescale=False).numpy()
    if any(x > split for x in lengths):
        assert np.abs(control - pallas).max() > 1e-2
    else:
        np.testing.assert_allclose(control, pallas, atol=1e-5)


def test_attention_ref_matches_jax():
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in ((2, 9, 4, 32), (2, 9, 2, 32), (2, 9, 2, 32)))
    for window in (None, 4):
        want = jflash_ref.attention_ref(*(jnp.asarray(a) for a in (q, k, v)), window=window)
        got = tflash_ref.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_decode_wrapper_refuses_bad_inputs():
    q, k = torch.zeros(2, 1, 4, 8), torch.zeros(2, 16, 2, 8)
    ln = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="lengths"):
        tflash.flash_decode(q, k, k, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="one query"):
        tflash.flash_decode(torch.zeros(2, 2, 4, 8), k, k, ln)
    with pytest.raises(ValueError, match="multiple"):
        tflash.flash_decode(torch.zeros(2, 1, 3, 8), k, k, ln)
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.zeros(2, 16, 2, 272)
        tflash.flash_decode(torch.zeros(2, 1, 4, 272), big, big, ln)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        tflash.flash_decode(q.double(), k.double(), k.double(), ln)


# ------------------------------------------------------------ attention


def _attention_case(window, per_slot, cache_len, prefill, decode, use_flash, seed=9):
    """Prefill ``prefill`` tokens then ``decode`` single steps through both
    frameworks' apply_attention; compare each output and the caches."""
    jcfg, tcfg = _cfgs("smollm-360m")
    b, d = 3, jcfg.d_model
    jp = jattn.init_attention(jax.random.key(seed), jcfg)
    tp = _t(_np(jp))
    jc = jattn.init_cache(jcfg, b, cache_len, window, per_slot=per_slot)
    tc = tattn.init_cache(tcfg, b, cache_len, window, per_slot=per_slot)
    start = np.zeros(b, np.int32)
    if per_slot:  # rows at different depths: pre-advance rows 1 and 2
        start = np.asarray([0, 2, 5], np.int32)
        jc = dict(jc, pos=jnp.asarray(start))
        tc = dict(tc, pos=torch.from_numpy(start.copy()))
    steps = [prefill] + [1] * decode
    t0 = 0
    for i, s in enumerate(steps):
        x = _normal((b, s, d), seed + 10 + i)
        pos = (start[:, None] + t0 + np.arange(s)[None]).astype(np.int32)
        flash = use_flash and s == 1
        jy, jc = jattn.apply_attention(jcfg, jp, jnp.asarray(x), jnp.asarray(pos), jc, window, flash)
        ty, tc = tattn.apply_attention(tcfg, tp, torch.from_numpy(x), torch.from_numpy(pos), tc, window, flash)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL, err_msg=f"step {i}")
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        t0 += s
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **TOL)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("per_slot", [False, True])
def test_apply_attention_prefill_then_decode_matches_jax(per_slot, use_flash):
    _attention_case(None, per_slot, cache_len=12, prefill=6, decode=4, use_flash=use_flash)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("per_slot", [False, True])
def test_apply_attention_ring_wrap_matches_jax(per_slot, use_flash):
    """Positions past the cache's slots wrap the write index (pos % slots);
    K5's lengths are min(pos, slots)."""
    _attention_case(None, per_slot, cache_len=8, prefill=6, decode=6, use_flash=use_flash)


@pytest.mark.parametrize("per_slot", [False, True])
def test_apply_attention_sliding_window_ring_matches_jax(per_slot):
    _attention_case(4, per_slot, cache_len=16, prefill=3, decode=5, use_flash=True)


def test_apply_attention_whole_cache_prefill_and_no_cache_match_jax():
    jcfg, tcfg = _cfgs("smollm-360m", attention_chunk=3)  # 3 query chunks of 3
    jp = jattn.init_attention(jax.random.key(11), jcfg)
    tp = _t(_np(jp))
    x = _normal((2, 9, jcfg.d_model), 12)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()
    for window in (None, 4):
        jy, _ = jattn.apply_attention(jcfg, jp, jnp.asarray(x), jnp.asarray(pos), None, window)
        ty, tc = tattn.apply_attention(tcfg, tp, torch.from_numpy(x), torch.from_numpy(pos), None, window)
        assert tc is None
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    jc = jattn.init_cache(jcfg, 2, 9, None)  # s == slots: the whole-cache write
    tc = tattn.init_cache(tcfg, 2, 9, None)
    jy, jc = jattn.apply_attention(jcfg, jp, jnp.asarray(x), jnp.asarray(pos), jc)
    ty, tc = tattn.apply_attention(tcfg, tp, torch.from_numpy(x), torch.from_numpy(pos), tc)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)
    assert int(tc["pos"]) == int(jc["pos"]) == 9


def test_no_cache_flash_route_names_k6():
    """``apply_attention(cache=None, use_flash=True)`` routes through K6
    (Pallas in interpret mode on the JAX side, the port's plain version for
    CPU tensors) and matches JAX's; with a window both stay on the masked
    attention."""
    jcfg, tcfg = _cfgs("smollm-360m")
    jp = jattn.init_attention(jax.random.key(21), jcfg)
    tp = _t(_np(jp))
    x = _normal((2, 19, jcfg.d_model), 22)
    pos = np.broadcast_to(np.arange(19, dtype=np.int32), (2, 19)).copy()
    for window in (None, 5):
        jy, _ = jattn.apply_attention(jcfg, jp, jnp.asarray(x), jnp.asarray(pos), None, window, True)
        with torch.no_grad():
            ty, tc = tattn.apply_attention(tcfg, tp, torch.from_numpy(x), torch.from_numpy(pos), None, window, True)
        assert tc is None
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    # K6 is forward-only: a pass that takes gradients of the weights raises
    live = {name: {"w": w["w"].clone().requires_grad_(True)} for name, w in tp.items()}
    with pytest.raises(RuntimeError, match="forward-only"):
        tattn.apply_attention(tcfg, live, torch.from_numpy(x), torch.from_numpy(pos), None, None, True)


# ----------------------------------------------------------- transformer


def _models(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = jT.init_params(jax.random.key(13), jcfg)
    return jcfg, tcfg, jp, tT.params_from_jax(_np(jp), tcfg, device="cpu")


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma-7b", "internlm2-20b"])
def test_forward_and_decode_step_match_jax(arch):
    """smollm: tied head, SwiGLU; gemma: tied head, embed_scale, GeGLU, MHA;
    internlm2: untied head.  Prefill on per-slot caches, three decode steps,
    each with K5's plain version and without."""
    jcfg, tcfg, jp, tp = _models(arch)
    assert tT.param_count(tp) == jT.param_count(jp)
    assert ("lm_head" in tp) == (not tcfg.tie_embeddings)
    b, p = 2, 5
    toks = np.random.default_rng(14).integers(0, tcfg.vocab_size, size=(b, p)).astype(np.int32)
    pos = np.broadcast_to(np.arange(p, dtype=np.int32), (b, p)).copy()

    # the no-cache forward
    jh, _, _ = jT.forward(jcfg, jp, jnp.asarray(toks), jnp.asarray(pos))
    th, tc, aux = tT.forward(tcfg, tp, torch.from_numpy(toks), torch.from_numpy(pos))
    assert tc is None and float(aux) == 0.0
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)

    for use_flash in (False, True):
        jc = jT.init_caches(jcfg, b, p + 4, per_slot=True)
        tc = tT.init_caches(tcfg, b, p + 4, per_slot=True, device="cpu")
        jh, jc, _ = jT.forward(jcfg, jp, jnp.asarray(toks), jnp.asarray(pos), jc)
        th, tc, _ = tT.forward(tcfg, tp, torch.from_numpy(toks), torch.from_numpy(pos), tc)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        jl = jT.logits_from_hidden(jcfg, jp, jh[:, -1:])
        tl = tT.logits_from_hidden(tcfg, tp, th[:, -1:])
        assert tl.shape == (b, 1, tT.vocab_padded(tcfg))
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)[:, None]
        for step in range(3):
            jl, jc = jT.decode_step(jcfg, jp, jnp.asarray(nxt), jc, use_flash=use_flash)
            tl, tc = tT.decode_step(tcfg, tp, torch.from_numpy(nxt), tc, use_flash=use_flash)
            scale = float(np.abs(np.asarray(jl)).max())
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5 * scale,
                                       err_msg=f"{arch} flash={use_flash} step {step}")
            nxt = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)[:, None]
        for tu, ju in zip(tc["unit"], jc["unit"]):
            np.testing.assert_array_equal(tu["pos"].numpy(), np.asarray(ju["pos"]))
            np.testing.assert_allclose(tu["k"].numpy(), np.asarray(ju["k"]), **TOL)
            np.testing.assert_allclose(tu["v"].numpy(), np.asarray(ju["v"]), **TOL)


def test_scalar_cache_decode_matches_jax_with_a_remainder_layer():
    """A three-layer model over a two-block pattern: one stacked unit plus a
    remainder layer, on the shared-scalar cache."""
    jcfg, tcfg = _cfgs("smollm-360m", num_layers=3, block_pattern=("attn+mlp", "swa+mlp"))
    jp = jT.init_params(jax.random.key(15), jcfg)
    tp = tT.params_from_jax(_np(jp), tcfg, device="cpu")
    assert len(tp["blocks"]) == 3
    b, p = 2, 4
    toks = np.random.default_rng(16).integers(0, tcfg.vocab_size, size=(b, p)).astype(np.int32)
    pos = np.broadcast_to(np.arange(p, dtype=np.int32), (b, p)).copy()
    jc = jT.init_caches(jcfg, b, 8)
    tc = tT.init_caches(tcfg, b, 8, device="cpu")
    assert len(tc["rem"]) == 1 and tc["unit"][1]["k"].shape[0] == 1
    jh, jc, _ = jT.forward(jcfg, jp, jnp.asarray(toks), jnp.asarray(pos), jc)
    th, tc, _ = tT.forward(tcfg, tp, torch.from_numpy(toks), torch.from_numpy(pos), tc)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    nxt = toks[:, -1:]
    for _ in range(3):
        jl, jc = jT.decode_step(jcfg, jp, jnp.asarray(nxt), jc)
        tl, tc = tT.decode_step(tcfg, tp, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(np.asarray(jl)).max()))
    assert int(tT._cache_pos(tc)) == int(jT._cache_pos(jc)) == p + 3
    np.testing.assert_allclose(tc["rem"][0]["k"].numpy(), np.asarray(jc["rem"][0]["k"]), **TOL)


def test_init_params_layout_and_scale():
    _, tcfg = _cfgs("internlm2-20b")
    tp = tT.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    v = tT.vocab_padded(tcfg)
    assert tp["embed"]["w"].shape == (v, tcfg.d_model) and tp["lm_head"]["w"].shape == (tcfg.d_model, v)
    assert len(tp["blocks"]) == tcfg.num_layers
    assert tp["blocks"][0]["mixer"]["wq"]["w"].shape == (tcfg.d_model, tcfg.q_dim)
    assert abs(float(tp["embed"]["w"].std()) / 0.02 - 1.0) < 0.02
    assert tT.vocab_padded(get_arch("granite-3-2b").model) == 49_280


def test_moe_and_rglru_blocks_initialise():
    """``moe`` FFNs and ``rglru`` mixers get their parameters and caches;
    an unknown block type raises."""
    _, tcfg = _cfgs("smollm-360m", block_pattern=("attn+moe", "rglru+mlp"), num_experts=4,
                    experts_per_token=2, rnn_width=128)
    tp = tT.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert tp["blocks"][0]["ffn"]["wi"].shape == (4, tcfg.d_model, tcfg.d_ff)
    assert tp["blocks"][1]["mixer"]["w_r"]["w"].shape == (128, 128)
    caches = tT.init_caches(tcfg, 1, 4, device="cpu")
    assert set(caches["unit"][0]) == {"k", "v", "pos"} and set(caches["unit"][1]) == {"conv", "h", "pos"}
    _, tcfg = _cfgs("smollm-360m", block_pattern=("attn+cmix",))
    with pytest.raises(ValueError, match="cmix goes with rwkv"):
        tT.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
