"""The LM training modules of the port against the JAX package on the CPU:
K6's plain route (against the Pallas kernel in interpret mode and JAX's
``attention_ref``), ``lm_loss`` with its gradient, and ``features``
(``tests/test_torch_models.py`` holds the no-cache flash route of
``apply_attention``).  Weights are JAX-initialised and carried across by
``params_from_jax``; inputs come from numpy.

Tolerances: fp32 everywhere but the one bf16 case.  The two frameworks sum
the same products in another order (XLA's and PyTorch's CPU GEMMs, softmax
and RoPE), which moves results by a few fp32 ulps of the largest terms:
``atol = rtol = 1e-5`` on O(1) values, the JAX kernel test's 2e-5 for K6,
and its 3e-2 for bf16."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.kernels.flash_attention import ref as jflash_ref  # noqa: E402
from repro.kernels.flash_attention.flash_attention import flash_attention_kernel  # noqa: E402
from repro.models import transformer as jT  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tflash  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(arch, **overrides):
    kw = dict(param_dtype="float32", dtype="float32", remat=False, **overrides)
    return jget_arch(arch).model.reduced(**kw), get_arch(arch).model.reduced(**kw)


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ------------------------------------------------------------------- K6


@pytest.mark.parametrize(
    "b,s,h,hk,hd,window,bq,bk",
    [  # the JAX kernel test's five shapes and Pallas blocks
        (2, 64, 4, 2, 32, None, 32, 32),
        (1, 100, 4, 4, 16, None, 32, 16),  # padded in Pallas, ragged here; MHA
        (2, 64, 8, 2, 32, 16, 32, 32),  # GQA + window
        (1, 128, 4, 1, 64, 32, 64, 32),  # MQA + window
        (1, 32, 2, 2, 8, None, 8, 8),
    ],
)
def test_flash_attention_plain_route_matches_pallas_and_ref(b, s, h, hk, hd, window, bq, bk):
    q, k, v = (_normal(shape, i) for i, shape in enumerate(((b, s, h, hd), (b, s, hk, hd), (b, s, hk, hd))))
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    pallas = flash_attention_kernel(*jargs, window=window, block_q=bq, block_k=bk, interpret=True)
    jref = jflash_ref.attention_ref(*jargs, window=window)
    before = dict(_build.LAUNCHES)
    got = tflash.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), window=window)
    assert _build.LAUNCHES == before  # a CPU tensor takes the plain version, no launch
    assert got.shape == (b, s, h, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), atol=2e-5)


def test_flash_attention_plain_route_bf16_matches_pallas():
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in ((1, 64, 4, 32), (1, 64, 2, 32), (1, 64, 2, 32)))
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    want = flash_attention_kernel(*jargs, interpret=True)
    got = tflash.flash_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=3e-2)


def _k6_bf16_emulation(q, k, v, window=None):
    """K6's bf16 tensor-core arithmetic (``csrc/flash_attention.cu``) in
    plain torch on the CPU: KV tiles of the kernel's width (64 positions,
    32 for hd > 128); scores as fp32 sums of the bf16 products, scaled in
    fp32 by hd^-0.5 * log2(e) and masked; the online softmax in exp2; the
    unnormalised P of each tile carried into the PV product as two bf16
    halves, hi = P rounded to bf16 and lo = P - hi cut to bf16, the row sum
    l taken from the fp32 P; O in fp32, divided by l once at the end and
    rounded to bf16."""
    b, s, h, hd = q.shape
    hk = k.shape[2]
    bk = 64 if hd <= 128 else 32
    qf = q.float().reshape(b, s, hk, h // hk, hd)
    kf, vf = k.float(), v.float()
    scale_log2 = torch.tensor(hd**-0.5, dtype=torch.float32) * torch.tensor(1.4426950408889634)
    pos = torch.arange(s)
    m = torch.full((b, hk, h // hk, s), -torch.inf)
    l = torch.zeros_like(m)
    o = torch.zeros(b, hk, h // hk, s, hd)
    for k0 in range(0, s, bk):
        kp = pos[k0 : k0 + bk]
        mask = kp[None, :] <= pos[:, None]
        if window is not None:
            mask &= kp[None, :] > pos[:, None] - window
        sc = torch.einsum("bqkgd,bskd->bkgqs", qf, kf[:, k0 : k0 + bk]) * scale_log2
        sc = torch.where(mask, sc, -torch.inf)
        m_new = torch.maximum(m, sc.amax(-1))
        m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(sc - m_use[..., None])
        l = l * alpha + p.sum(-1)
        hi = p.bfloat16().float()
        lo = ((p - hi).view(torch.int32) & -65536).view(torch.float32)  # cut to bf16
        p2 = hi + lo  # exact in fp32
        pv = torch.einsum("bkgqs,bskd->bkgqd", p2, vf[:, k0 : k0 + bk])
        o = o * alpha[..., None] + pv
        m = m_new
    out = o / torch.where(l == 0, 1.0, l)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).bfloat16()


@pytest.mark.parametrize(
    "b,s,h,hk,hd,window",
    [(1, 512, 3, 1, 64, None), (2, 200, 6, 3, 40, None), (1, 300, 4, 4, 128, 100)],
)
def test_k6_bf16_arithmetic_fits_the_cards_bound(b, s, h, hk, hd, window):
    """The rounding of K6's bf16 kernel, emulated on the CPU, against JAX's
    Pallas K6 (interpret mode) and JAX's and the port's ``attention_ref``
    (fp32 throughout), on the same bf16 inputs, at the bound the card holds
    the kernel to (``tests/test_torch_cuda.py``): |got - want| <= 2^-7
    |want| + 2^-8 max|want of the row|."""
    q, k, v = (_normal(shape, 30 + i) for i, shape in enumerate(((b, s, h, hd), (b, s, hk, hd), (b, s, hk, hd))))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    jargs = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (tq, tk, tv)]
    got = _k6_bf16_emulation(tq, tk, tv, window=window).float()
    wants = {
        "pallas": np.asarray(flash_attention_kernel(*jargs, window=window, interpret=True), np.float32),
        "jax ref": np.asarray(jflash_ref.attention_ref(*jargs, window=window), np.float32),
        "port ref": tflash.flash_attention(tq, tk, tv, window=window).float().numpy(),
    }
    for name, want in wants.items():
        want = torch.from_numpy(want)
        diff = (got - want).abs()
        bad = diff > 2.0**-7 * want.abs() + 2.0**-8 * want.abs().amax(dim=-1, keepdim=True)
        assert not bool(bad.any()), f"{name}: {int(bad.sum())} elements off, max {float(diff.max())}"


def test_flash_attention_wrapper_refuses_bad_inputs():
    q, k = torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="multiple"):
        tflash.flash_attention(torch.zeros(1, 8, 3, 16), k, k)
    with pytest.raises(ValueError, match="head_dim"):
        tflash.flash_attention(torch.zeros(1, 8, 4, 12), torch.zeros(1, 8, 2, 12), torch.zeros(1, 8, 2, 12))
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        tflash.flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(ValueError, match=r"must be \(1, 8, Hk, 16\)"):
        tflash.flash_attention(q, torch.zeros(1, 9, 2, 16), torch.zeros(1, 9, 2, 16))
    with pytest.raises(RuntimeError, match="forward-only"):
        tflash.flash_attention(q.requires_grad_(True), k, k)
    with torch.no_grad():  # no gradient taken: the forward runs
        assert tflash.flash_attention(q, k, k).shape == q.shape


# -------------------------------------------------------- lm_loss, features


def _models(arch, **overrides):
    jcfg, tcfg = _cfgs(arch, **overrides)
    jp = jT.init_params(jax.random.key(31), jcfg)
    return jcfg, tcfg, jp, tT.params_from_jax(_np(jp), tcfg, device="cpu")


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize(
    "arch,loss_chunk",
    [
        ("smollm-360m", None),  # one chunk of all 15 predictions
        ("smollm-360m", 4),  # three chunks of 4 and a tail of 3
        ("gemma-7b", 6),  # embed scale, GeGLU, MHA; two chunks and a tail
    ],
)
def test_lm_loss_matches_jax_with_and_without_flash(arch, loss_chunk):
    jcfg, tcfg, jp, tp = _models(arch)
    toks = _tokens(jcfg, 3, 16, 32)
    want = {f: float(jT.lm_loss(jcfg, jp, jnp.asarray(toks), loss_chunk=loss_chunk, use_flash=f))
            for f in (False, True)}
    with torch.no_grad():
        got = {f: float(tT.lm_loss(tcfg, tp, torch.from_numpy(toks), loss_chunk=loss_chunk, use_flash=f))
               for f in (False, True)}
    for f in (False, True):
        np.testing.assert_allclose(got[f], want[f], **TOL)


def test_lm_loss_soft_cap_and_explicit_targets_match_jax():
    jcfg, tcfg, jp, tp = _models("smollm-360m", logits_soft_cap=5.0, loss_chunk=7)
    toks = _tokens(jcfg, 2, 12, 33)
    tgt = _tokens(jcfg, 2, 11, 34)  # (B, S - 1): taken as it is
    pos = (np.arange(12, dtype=np.int32)[None] + np.asarray([[0], [3]], np.int32))
    want = jT.lm_loss(jcfg, jp, jnp.asarray(toks), positions=jnp.asarray(pos), targets=jnp.asarray(tgt))
    got = tT.lm_loss(tcfg, tp, torch.from_numpy(toks), positions=torch.from_numpy(pos),
                     targets=torch.from_numpy(tgt))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    # the VLM/audio frontends' path: embeddings and targets in place of tokens
    emb = np.random.default_rng(36).normal(scale=0.05, size=(2, 12, tcfg.d_model)).astype(np.float32)
    want = jT.lm_loss(jcfg, jp, embeds=jnp.asarray(emb), targets=jnp.asarray(tgt), loss_chunk=7)
    got = tT.lm_loss(tcfg, tp, embeds=torch.from_numpy(emb), targets=torch.from_numpy(tgt), loss_chunk=7)
    np.testing.assert_allclose(float(got), float(want), **TOL)


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma-7b"])
def test_lm_loss_gradient_matches_jax_grad(arch):
    jcfg, tcfg, jp, tp = _models(arch, loss_chunk=5)
    toks = _tokens(jcfg, 2, 13, 35)
    jg = _np(jax.grad(lambda p: jT.lm_loss(jcfg, p, jnp.asarray(toks)))(jp))
    want = tT.params_from_jax(jg, tcfg, device="cpu")
    live = tT.params_from_jax(_np(jp), tcfg, device="cpu")
    leaves = tree_leaves(live)
    for x in leaves:
        x.requires_grad_(True)
    tT.lm_loss(tcfg, live, torch.from_numpy(toks)).backward()
    for g, w in zip((x.grad for x in leaves), tree_leaves(want)):
        # gradients of a mean CE: O(1e-2) entries, summed over 26 predictions
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("arch", ["smollm-360m", "internlm2-20b"])
def test_features_match_jax(arch):
    jcfg, tcfg, jp, tp = _models(arch)
    toks = _tokens(jcfg, 3, 10, 36)
    jlog, jfeat = jT.features(jcfg, jp, jnp.asarray(toks))
    with torch.no_grad():
        tlog, tfeat = tT.features(tcfg, tp, torch.from_numpy(toks))
    assert tlog.shape == (3, 1, tT.vocab_padded(tcfg)) and tfeat.shape == (3, tcfg.d_model)
    np.testing.assert_allclose(tfeat.numpy(), np.asarray(jfeat), **TOL)
    scale = float(np.abs(np.asarray(jlog)).max())
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5, atol=1e-5 * scale)
