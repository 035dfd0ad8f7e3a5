"""The five archs of the last model slice — mixtral-8x7b and llama4-maverick
(MoE FFNs), recurrentgemma-9b (RG-LRU mixers and local attention),
qwen2-vl-2b (M-RoPE) and musicgen-medium (sinusoidal positions, LayerNorm,
GELU) — through the port against the JAX package on the CPU, at
``reduced()`` size in fp32, with JAX-initialised weights carried across by
``params_from_jax``; and the position layers they need (``apply_mrope``,
``sinusoidal_positions``).

Tolerances (``tests/test_torch_models.py``'s ``TOL``): ``rtol = atol =
1e-5`` on O(1) activations and losses, relative to max|logits| for the
logits, since the two frameworks sum the same products in another order.
Serving tokens are compared as ``tests/test_torch_serve.py`` compares
them: JAX runs ``run_legacy`` (plain attention, its reference); the port
runs scan mode with ``use_flash=True`` (K5's plain version on the CPU)
and its own legacy loop; the port's tokens are JAX's up to the first step
where JAX's top-2 margin is below 4e-5 * max|logits|, and at that step
the margin is below it."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jT  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402

ARCHS = ["mixtral-8x7b", "llama4-maverick-400b-a17b", "recurrentgemma-9b", "qwen2-vl-2b", "musicgen-medium"]
TOL = dict(rtol=1e-5, atol=1e-5)
MARGIN_REL = 4e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(arch):
    kw = dict(param_dtype="float32", dtype="float32", remat=False)
    jcfg, tcfg = jget_arch(arch).model.reduced(**kw), get_arch(arch).model.reduced(**kw)
    jp = jT.init_params(jax.random.key(17), jcfg)
    return jcfg, tcfg, jp, tT.params_from_jax(_np(jp), tcfg, device="cpu")


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _jpos(cfg, b, s, offset=0):
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None] + offset, (b, s))
    return jnp.broadcast_to(pos[None], (3, b, s)) if cfg.pos_style == "mrope" else pos


def _logits_close(got, want, msg=""):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale, err_msg=msg)


# ------------------------------------------------------------ positions


def test_apply_mrope_matches_jax_on_distinct_streams():
    """Three different streams over (16, 24, 24) sections of hd 128."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 128)).astype(np.float32)
    pos = rng.integers(0, 50, size=(3, 2, 5)).astype(np.int32)
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, (16, 24, 24))
    got = tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, (16, 24, 24))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="sum"):
        tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, (16, 24, 23))
    with pytest.raises(ValueError, match=r"\(3, B, S\)"):
        tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos[0]), 1e6, (16, 24, 24))


def test_mrope_with_three_equal_streams_is_rope():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 7, 4, 64)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 4096, size=(2, 7)).astype(np.int32))
    got = tlayers.apply_mrope(x, pos[None].expand(3, 2, 7), 1e4, (8, 12, 12))
    torch.testing.assert_close(got, tlayers.apply_rope(x, pos, 1e4), rtol=0, atol=0)


def test_sinusoidal_positions_match_jax():
    pos = np.random.default_rng(2).integers(0, 4096, size=(2, 9)).astype(np.int32)
    want = jlayers.sinusoidal_positions(jnp.asarray(pos), 96)
    got = tlayers.sinusoidal_positions(torch.from_numpy(pos), 96)
    assert got.shape == (2, 9, 96) and got.dtype == torch.float32
    # sin and cos of angles up to ~4,096 rad: an fp32 ulp of the angle is
    # ~5e-4, so the frameworks' fp32 exp may move the result by that much
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-3)
    np.testing.assert_allclose(got[:, :, :1].numpy(), np.sin(pos[..., None].astype(np.float64)), atol=2e-3)


# ------------------------------------------------------------ the archs


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_step_match_jax(arch):
    """The no-cache forward with its aux loss (the MoE layers' sum), then a
    prefill on per-slot caches and three decode steps; the port's with and
    without K5's plain version against JAX's plain path (its reference,
    jitted); the caches' positions after."""
    jcfg, tcfg, jp, tp = _models(arch)
    assert tT.param_count(tp) == jT.param_count(jp)
    b, p = 2, 6
    toks = _tokens(tcfg, b, p, 18)
    jpos = _jpos(jcfg, b, p)
    tpos = torch.from_numpy(np.array(jpos))

    jh, _, jaux = jT.forward(jcfg, jp, jnp.asarray(toks), jpos)
    th, tc, taux = tT.forward(tcfg, tp, torch.from_numpy(toks), tpos)
    assert tc is None
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    assert (float(taux) > 0) == ("moe" in "".join(tcfg.block_pattern))

    jc = jT.init_caches(jcfg, b, p + 4, per_slot=True)
    jh, jc, jaux = jax.jit(lambda prm, t, c: jT.forward(jcfg, prm, t, jpos, c))(jp, jnp.asarray(toks), jc)
    assert float(jaux) == 0.0  # no aux loss with caches
    step = jax.jit(lambda prm, t, c: jT.decode_step(jcfg, prm, t, c))
    nxt = [np.asarray(jnp.argmax(jT.logits_from_hidden(jcfg, jp, jh[:, -1:])[:, 0], -1)).astype(np.int32)[:, None]]
    want = []
    for _ in range(3):
        jl, jc = step(jp, jnp.asarray(nxt[-1]), jc)
        want.append(np.asarray(jl))
        nxt.append(np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)[:, None])
    for use_flash in (False, True):
        tc = tT.init_caches(tcfg, b, p + 4, per_slot=True, device="cpu")
        th, tc, taux = tT.forward(tcfg, tp, torch.from_numpy(toks), tpos, tc)
        assert float(taux) == 0.0
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        for i in range(3):
            tl, tc = tT.decode_step(tcfg, tp, torch.from_numpy(nxt[i]), tc, use_flash=use_flash)
            _logits_close(tl.numpy(), want[i], f"{arch} flash={use_flash} step {i}")
        assert tT._cache_pos(tc).tolist() == [p + 3] * b


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_embeds_and_features_match_jax(arch):
    """``lm_loss`` over tokens (its aux loss included, two chunks and a
    tail), over precomputed embeddings with targets (the stubbed VLM and
    audio frontends), and ``features``, each against JAX's; ``features``
    over the tokens' own embeddings equals ``features`` over the tokens."""
    jcfg, tcfg, jp, tp = _models(arch)
    toks = _tokens(tcfg, 2, 12, 19)
    want = jT.lm_loss(jcfg, jp, jnp.asarray(toks), loss_chunk=5)
    with torch.no_grad():
        got = tT.lm_loss(tcfg, tp, torch.from_numpy(toks), loss_chunk=5)
    np.testing.assert_allclose(float(got), float(want), **TOL)

    embeds = np.random.default_rng(20).normal(scale=0.05, size=(2, 12, tcfg.d_model)).astype(np.float32)
    tgt = _tokens(tcfg, 2, 12, 21)
    want = jT.lm_loss(jcfg, jp, embeds=jnp.asarray(embeds), targets=jnp.asarray(tgt))
    with torch.no_grad():
        got = tT.lm_loss(tcfg, tp, embeds=torch.from_numpy(embeds), targets=torch.from_numpy(tgt))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    with pytest.raises(ValueError, match="targets"):
        tT.lm_loss(tcfg, tp, embeds=torch.from_numpy(embeds))

    jl, jf = jT.features(jcfg, jp, jnp.asarray(toks))
    tl, tf = tT.features(tcfg, tp, torch.from_numpy(toks))
    _logits_close(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **TOL)
    # embeds holding the tokens' own embedding rows give the tokens' features
    # (an embed-scaled arch scales embeds too, as JAX does)
    own = tp["embed"]["w"][torch.from_numpy(toks).long()]
    el, ef = tT.features(tcfg, tp, embeds=own)
    torch.testing.assert_close(ef, tf, rtol=0, atol=0)
    jh, _, _ = jT.forward(jcfg, jp, None, _jpos(jcfg, 2, 12), embeds=jnp.asarray(embeds))
    th, _, _ = tT.forward(tcfg, tp, None, torch.from_numpy(np.array(_jpos(jcfg, 2, 12))),
                          embeds=torch.from_numpy(embeds))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


def _jax_teacher_logits(jcfg, jp, prompts, toks):
    b, p = prompts.shape
    caches = jT.init_caches(jcfg, b, p + toks.shape[1])
    hidden, caches, _ = jax.jit(lambda prm, t, c: jT.forward(jcfg, prm, t, _jpos(jcfg, b, p), c))(
        jp, jnp.asarray(prompts), caches)
    out = [np.asarray(jT.logits_from_hidden(jcfg, jp, hidden[:, -1:]))]
    step = jax.jit(lambda prm, t, c: jT.decode_step(jcfg, prm, t, c))
    for i in range(toks.shape[1] - 1):
        logits, caches = step(jp, jnp.asarray(toks[:, i : i + 1]), caches)
        out.append(np.asarray(logits))
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_tokens_match_jax_run_legacy(arch):
    """Greedy tokens of the port's scan mode (K5's plain version) and of its
    legacy loop against JAX's ``run_legacy``: equal up to the first step
    below the margin, and that step's margin below it (module docstring);
    the port's scan mode without K5 equals its legacy loop bit for bit."""
    jcfg, tcfg, jp, tp = _models(arch)
    b, p, g = 3, 6, 8
    prompts = _tokens(tcfg, b, p, 22)
    jtoks, _ = jserve.run_legacy(jcfg, jp, jnp.asarray(prompts), g)
    jtoks = np.asarray(jtoks)
    scan, _ = tserve.run_scan_mode(tcfg, tp, torch.from_numpy(prompts), g, use_flash=True)
    legacy, _ = tserve.run_legacy(tcfg, tp, torch.from_numpy(prompts), g)
    plain, _ = tserve.run_scan_mode(tcfg, tp, torch.from_numpy(prompts), g)
    np.testing.assert_array_equal(plain, legacy)
    jl = _jax_teacher_logits(jcfg, jp, prompts, jtoks)
    np.testing.assert_array_equal(np.argmax(jl, -1), jtoks)
    scale = float(np.abs(jl).max())
    top2 = np.sort(jl, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > MARGIN_REL * scale
    for toks in (scan, legacy):
        for i in range(b):
            low = np.nonzero(~clear[i])[0]
            agree_to = int(low[0]) + 1 if low.size else g
            np.testing.assert_array_equal(toks[i, :agree_to], jtoks[i, :agree_to], err_msg=f"{arch} row {i}")
