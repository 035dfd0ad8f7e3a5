"""The port's RWKV-6 family (``repro_torch.models.rwkv6``, K7's plain
version and wrapper, the ``rwkv+cmix`` transformer and its config) against
the JAX package on the CPU, with JAX-initialised weights carried across by
``params_from_jax``.  JAX's Pallas WKV6 kernel runs in interpret mode, as
the JAX package's own tests run it; the port's K7 wrapper runs its plain
version for CPU tensors (the CUDA kernel itself is held against that plain
version in ``tests/test_torch_cuda.py``).

Tolerances: everything here is fp32.  The plain WKV6 is held to JAX's at
``atol = 1e-5`` and ``rtol = 1e-5``: the same fp32 recurrence with its sums
over hd taken in another order, on outputs up to |y| ~ 30, where one fp32
step is 1.9e-6 and the two orders part by up to 1.5e-5 (1e-6 relative);
the model functions at ``rtol = 1e-5`` and ``atol = 1e-5 * max|want|``
(XLA's and PyTorch's CPU GEMMs sum the same products in another
order)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.kernels.rwkv6_scan.rwkv6_scan import wkv6_kernel  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.models import transformer as jT  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as twkv  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ref as twkv_ref  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402

ARCH = "rwkv6-7b"
WKV_TOL = dict(rtol=2e-6, atol=1e-5)
# the JAX test's four shapes (tests/test_kernels.py::test_rwkv6_scan_sweep)
JAX_SHAPES = [(2, 64, 2, 16, 32), (1, 100, 3, 32, 64), (2, 33, 1, 64, 16), (1, 16, 2, 8, 16)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    """numpy tree -> torch tree (CPU)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _cfgs(**overrides):
    kw = dict(param_dtype="float32", dtype="float32", remat=False, **overrides)
    return jget_arch(ARCH).model.reduced(**kw), get_arch(ARCH).model.reduced(**kw)


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()), err_msg=err_msg)


def _wkv_inputs(b, t, h, hd, seed, w_lo=0.4):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, t, h, hd)).astype(np.float32) for _ in range(3))
    w = rng.uniform(w_lo, 0.99, size=(b, t, h, hd)).astype(np.float32)
    u = rng.normal(size=(h, hd)).astype(np.float32)
    s0 = rng.normal(size=(b, h, hd, hd)).astype(np.float32)
    return r, k, v, w, u, s0


# --------------------------------------------------------- plain WKV6


@pytest.mark.parametrize("b,t,h,hd,bt", JAX_SHAPES)
def test_plain_wkv6_matches_pallas_and_jax_ref(b, t, h, hd, bt):
    args = _wkv_inputs(b, t, h, hd, seed=100 + t)
    jargs = [jnp.asarray(a) for a in args]
    py, ps = wkv6_kernel(*jargs, block_t=bt, interpret=True)
    jy, js = jrwkv.wkv6_scan_ref(*jargs)
    targs = [torch.from_numpy(a) for a in args]
    s0_before = targs[5].clone()
    ty, ts = twkv_ref.wkv6_scan_ref(*targs)
    assert ty.shape == (b, t, h, hd) and ts.shape == (b, h, hd, hd)
    assert ty.dtype == ts.dtype == torch.float32
    assert torch.equal(targs[5], s0_before)  # the plain scan does not write s0
    for want_y, want_s in ((py, ps), (jy, js)):
        np.testing.assert_allclose(ty.numpy(), np.asarray(want_y), **WKV_TOL)
        np.testing.assert_allclose(ts.numpy(), np.asarray(want_s), **WKV_TOL)
    # the wrapper takes the plain version for CPU tensors
    wy, ws = twkv.wkv6(*targs)
    assert torch.equal(wy, ty) and torch.equal(ws, ts)


# ------------------------------------------- K7's chunked design on the CPU


def _tf32(x):
    """fp32 -> TF32 by clearing the 13 low mantissa bits of the float32 bit
    pattern (toward zero), as K7 forms hi and as the tensor cores read an
    fp32 register given as TF32."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mma(a, b, exact_b=False, hi_only=False):
    """a (.., M, K) @ b (.., K, N) as K7's ``mma_3x``: each k-step of 8 is a
    fresh fp32 sum lo·hi + hi·lo + hi·hi of the exact splits x = hi + lo
    (lo read as TF32; no hi·lo where b is exact in TF32), added to the fp32
    total.  ``hi_only`` (a control): hi·hi alone, one TF32 pass."""
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], 8):
        ak, bk = a[..., k0 : k0 + 8], b[..., k0 : k0 + 8, :]
        ahi, bhi = _tf32(ak), _tf32(bk)
        d = torch.zeros_like(out) if hi_only else _tf32(ak - ahi) @ bhi
        if not (exact_b or hi_only):
            d = d + ahi @ _tf32(bk - bhi)
        out = out + (d + ahi @ bhi)
    return out


def _chunked_wkv6(r, k, v, w, u, s0, exact_v=False, control=None):
    """K7's chunked arithmetic (``csrc/wkv6.cu``) in torch on the CPU.
    Chunks of ``CHUNK`` tokens, a last partial one padded with r = k = v =
    0 and w = 1.  Per chunk: prefix products P_t = Π_{m<t} w_m give r̃ = r ⊙
    P and the chunk decay D = P_CHUNK; suffix products give k̃_s = k_s ⊙
    Π_{s<m<CHUNK} w_m; the triangle A_ts = Σ_i r_ti k_si Π_{s<m<t} w_mi
    (s < t) keeps k_s times its running product, and A_tt is the bonus Σ_i
    r_ti u_i k_ti.  Then y = R̃ S + A V and S ← diag(D) S + K̃ᵀ V, the
    products taken as the tensor cores take them (``_mma``; ``exact_v``:
    v holds bf16 values).  ``control``: "prefix_through_t" takes P_t
    through w_t, "no_chunk_decay" drops D, "tf32_only" takes each product
    in one TF32 pass."""
    b, t, h, hd = r.shape
    n = twkv.CHUNK
    r, k, v, w = (x.float().permute(0, 2, 1, 3) for x in (r, k, v, w))  # (B, H, T, hd)
    s = s0.float().clone()
    ys = []
    for c0 in range(0, t, n):
        tc = min(n, t - c0)
        rc, kc, vc, wc = (x[:, :, c0 : c0 + tc] for x in (r, k, v, w))
        if tc < n:
            pad = torch.zeros(b, h, n - tc, hd)
            rc, kc, vc = (torch.cat([x, pad], 2) for x in (rc, kc, vc))
            wc = torch.cat([wc, torch.ones(b, h, n - tc, hd)], 2)
        rt, kt = torch.empty_like(rc), torch.empty_like(kc)
        p = torch.ones(b, h, hd)
        for i in range(n):
            if control == "prefix_through_t":
                p = p * wc[:, :, i]
            rt[:, :, i] = rc[:, :, i] * p
            if control != "prefix_through_t":
                p = p * wc[:, :, i]
        dec = torch.ones_like(p) if control == "no_chunk_decay" else p
        p = torch.ones(b, h, hd)
        for i in reversed(range(n)):
            kt[:, :, i] = kc[:, :, i] * p
            p = p * wc[:, :, i]
        a = torch.zeros(b, h, n, n)
        kp = kc.clone()
        for i in range(n):
            a[:, :, i, i] = (rc[:, :, i] * u[None] * kc[:, :, i]).sum(-1)
            if i:
                a[:, :, i, :i] = (rc[:, :, i, None, :] * kp[:, :, :i]).sum(-1)
                kp[:, :, :i] = kp[:, :, :i] * wc[:, :, i, None, :]
        one_pass = control == "tf32_only"
        y = _mma(rt, s, hi_only=one_pass) + _mma(a, vc, exact_b=exact_v, hi_only=one_pass)
        s = dec[..., None] * s + _mma(kt.transpose(-1, -2), vc, exact_b=exact_v, hi_only=one_pass)
        ys.append(y[:, :, :tc])
    return torch.cat(ys, 2).permute(0, 2, 1, 3), s


def _scan64(r, k, v, w, u, s):
    """The recurrence in fp64 (the plain version's loop, without its fp32)."""
    r, k, v, w, u, s = (torch.from_numpy(np.asarray(x, np.float64)) for x in (r, k, v, w, u, s))
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + u[None, :, :, None] * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, 1), s


def _chunked_inputs(b, t, h, hd, decays, seed):
    """numpy inputs.  "jax": fp32 r/k/v and the JAX sweep's decays in [0.4,
    0.99); "law": r/k/v rounded to bf16 (the main path's) and the model's
    law exp(-exp(z)), z ~ U(-6, 0); "edge": the same with a fifth of the
    channels at exactly 0 (the exponent clamped at 8), a fifth at 1 - 1e-7
    and a fifth at exactly 1 (clamped at -20)."""
    if decays == "jax":
        return _wkv_inputs(b, t, h, hd, seed)
    rng = np.random.default_rng(seed)
    to_bf16 = lambda x: torch.from_numpy(x).bfloat16().float().numpy()  # noqa: E731
    r, k, v = (to_bf16(rng.normal(size=(b, t, h, hd)).astype(np.float32)) for _ in range(3))
    w = np.exp(-np.exp(rng.uniform(-6.0, 0.0, size=(b, t, h, hd)))).astype(np.float32)
    if decays == "edge":
        w[..., 0::5] = np.exp(-np.exp(np.float32(8.0)))
        w[..., 1::5] = np.float32(1.0 - 1e-7)
        w[..., 2::5] = np.exp(-np.exp(np.float32(-20.0)))
        assert np.all(w[..., 0::5] == 0) and np.all(w[..., 2::5] == 1)
    u = rng.normal(size=(h, hd)).astype(np.float32)
    s0 = rng.normal(size=(b, h, hd, hd)).astype(np.float32)
    return r, k, v, w, u, s0


def _within_k7_bounds(y, s, want_y, want_s, decays):
    """The bounds K7 is held to on the card: S within 1e-5 of its (b, h)
    head's largest |S|; y within 5e-4 on fp32 inputs ("jax", the JAX
    sweep's bound), else rounded to bf16 within 2^-7 |y| + 2^-8 of the
    largest |y| of its (b, t, h) row."""
    want_y, want_s = (torch.from_numpy(np.array(x, np.float32)) for x in (want_y, want_s))
    s_ok = bool(((s - want_s).abs() <= 1e-5 * want_s.abs().amax(dim=(2, 3), keepdim=True)).all())
    if decays == "jax":
        return s_ok and bool(((y - want_y).abs() <= 5e-4).all())
    yb, wb = y.bfloat16().float(), want_y.bfloat16().float()
    tol = 2.0**-7 * wb.abs() + 2.0**-8 * wb.abs().amax(dim=-1, keepdim=True)
    return s_ok and bool(((yb - wb).abs() <= tol).all())


CHUNKED_CASES = [
    (2, 5, 2, 16, "jax"),  # T < CHUNK
    (1, 16, 2, 32, "law"),  # T = CHUNK
    (2, 45, 2, 64, "law"),  # T not a multiple of CHUNK
    (1, 100, 3, 32, "jax"),
    (1, 100, 2, 16, "law"),
    (2, 64, 2, 16, "jax"),
    (1, 128, 2, 64, "edge"),  # exact zeros, 1 - 1e-7 and exact ones
    (2, 45, 2, 32, "edge"),
]


@pytest.mark.parametrize("b,t,h,hd,decays", CHUNKED_CASES)
def test_k7_chunked_form_matches_pallas_ref_and_fp64(b, t, h, hd, decays):
    """K7's chunked arithmetic with its TF32 splits (``_chunked_wkv6``)
    within the card's bounds of the Pallas kernel in interpret mode and of
    the plain scan, and against an fp64 recurrence: S within 1e-5 of its
    head's max, y within 2e-6 of the largest |y|."""
    args = _chunked_inputs(b, t, h, hd, decays, seed=b * 1000 + t + hd)
    py, ps = wkv6_kernel(*(jnp.asarray(a) for a in args), block_t=16, interpret=True)
    targs = [torch.from_numpy(a) for a in args]
    ry, rs = twkv_ref.wkv6_scan_ref(*targs)
    y, s = _chunked_wkv6(*targs, exact_v=decays != "jax")
    assert y.shape == (b, t, h, hd) and s.shape == (b, h, hd, hd)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    assert _within_k7_bounds(y, s, py, ps, decays)
    assert _within_k7_bounds(y, s, ry, rs, decays)
    y64, s64 = _scan64(*args)
    assert float((y.double() - y64).abs().max()) <= 2e-6 * float(y64.abs().max())
    assert bool(((s.double() - s64).abs() <= 1e-5 * s64.abs().amax(dim=(2, 3), keepdim=True)).all())


@pytest.mark.parametrize("control", ["prefix_through_t", "no_chunk_decay", "tf32_only"])
def test_k7_chunked_form_control_breaks_the_bounds(control):
    """r̃ with its prefix products taken through t, S without the chunk's
    decay, or the products in one TF32 pass without the lo halves, is
    outside the bounds the chunked form meets."""
    args = _chunked_inputs(2, 45, 2, 64, "law", seed=7)
    targs = [torch.from_numpy(a) for a in args]
    want = twkv_ref.wkv6_scan_ref(*targs)
    assert _within_k7_bounds(*_chunked_wkv6(*targs, exact_v=True), *want, "law")
    assert not _within_k7_bounds(*_chunked_wkv6(*targs, exact_v=True, control=control), *want, "law")


def test_plain_wkv6_state_handoff_equals_one_shot_and_jax():
    """Two halves with the state handed over == one shot (the decode path),
    as ``tests/test_kernels.py::test_rwkv6_state_handoff_equals_one_shot``."""
    r, k, v, w, u, _ = _wkv_inputs(1, 32, 2, 16, seed=7, w_lo=0.5)
    s0 = np.zeros((1, 2, 16, 16), np.float32)
    jargs = [jnp.asarray(a) for a in (r, k, v, w, u, s0)]
    j_full, js_full = wkv6_kernel(*jargs, block_t=16, interpret=True)
    t = [torch.from_numpy(a) for a in (r, k, v, w, u, s0)]
    y_full, s_full = twkv.wkv6(*t)
    y1, s_mid = twkv.wkv6(*(x[:, :16] for x in t[:4]), t[4], t[5])
    y2, s_end = twkv.wkv6(*(x[:, 16:] for x in t[:4]), t[4], s_mid)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(), **WKV_TOL)
    np.testing.assert_allclose(s_end.numpy(), s_full.numpy(), **WKV_TOL)
    np.testing.assert_allclose(y_full.numpy(), np.asarray(j_full), **WKV_TOL)
    np.testing.assert_allclose(s_full.numpy(), np.asarray(js_full), **WKV_TOL)


def test_wkv6_wrapper_dtypes_and_refusals():
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in _wkv_inputs(2, 5, 2, 8, seed=3))
    y, s = twkv.wkv6(r.bfloat16(), k.bfloat16(), v.bfloat16(), w, u, s0)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32  # y in r's dtype
    with pytest.raises(ValueError, match="B, T, H, head_dim"):
        twkv.wkv6(r[0], k, v, w, u, s0)
    with pytest.raises(ValueError, match="one shape"):
        twkv.wkv6(r, k[:, :4], v, w, u, s0)
    with pytest.raises(ValueError, match="state shape"):
        twkv.wkv6(r, k, v, w, u, s0[:1])
    with pytest.raises(ValueError, match="bonus shape"):
        twkv.wkv6(r, k, v, w, u[:1], s0)
    with pytest.raises(ValueError, match="non-empty"):
        twkv.wkv6(*(x[:, :0] for x in (r, k, v, w)), u, s0)
    with pytest.raises(RuntimeError, match="forward-only"):
        twkv.wkv6(r.requires_grad_(True), k, v, w, u, s0)
    with torch.no_grad():
        twkv.wkv6(r, k, v, w, u, s0)  # no gradient pass, no refusal


# ----------------------------------------------------- model functions


def _x(b, t, d, seed):
    return np.random.default_rng(seed).normal(size=(b, t, d)).astype(np.float32)


def _state_pair(jcfg, b, seed):
    """JAX's and the port's RWKV state holding the same random values."""
    rng = np.random.default_rng(seed)
    js = jrwkv.init_rwkv_state(jcfg, b)
    vals = {name: rng.normal(size=np.asarray(x).shape).astype(np.float32) * 0.5
            for name, x in js.items() if name != "pos"}
    vals["pos"] = np.asarray(3, np.int32)
    return {n: jnp.asarray(a) for n, a in vals.items()}, {n: torch.from_numpy(a.copy()) for n, a in vals.items()}


def test_group_norm_matches_jax():
    x = _x(2, 5, 256, 0) * 3.0 + 1.0
    scale = 1.0 + 0.1 * np.random.default_rng(1).normal(size=256).astype(np.float32)
    want = jrwkv._group_norm(jnp.asarray(x), jnp.asarray(scale), 4)
    got = trwkv._group_norm(torch.from_numpy(x), torch.from_numpy(scale), 4)
    _close(got.numpy(), want)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
def test_apply_rwkv_tmix_matches_jax(with_state, use_kernel):
    """With a state the port writes ``tm_x`` and ``wkv`` in place and returns
    a dict sharing them; ``use_kernel`` takes Pallas in interpret mode on the
    JAX side and K7's plain version on the port's."""
    jcfg, tcfg = _cfgs()
    jp = jrwkv.init_rwkv_tmix(jax.random.key(1), jcfg)
    tp = _t(_np(jp))
    b, t = 2, 7
    x = _x(b, t, jcfg.d_model, 2)
    js, ts = _state_pair(jcfg, b, 3) if with_state else (None, None)
    jy, jns = jrwkv.apply_rwkv_tmix(jcfg, jp, jnp.asarray(x), js, use_kernel=use_kernel)
    with torch.no_grad():
        ty, tns = trwkv.apply_rwkv_tmix(tcfg, tp, torch.from_numpy(x), ts, use_kernel=use_kernel)
    _close(ty.numpy(), jy)
    if not with_state:
        assert tns is None and jns is None
        return
    assert set(tns) == set(jns) == {"tm_x", "wkv", "cm_x", "pos"}
    for name in ("tm_x", "wkv", "cm_x"):
        _close(tns[name].numpy(), jns[name], err_msg=name)
        assert tns[name] is ts[name]  # written in place
    assert int(tns["pos"]) == int(jns["pos"]) == 3 + t
    assert int(ts["pos"]) == 3  # the position is a new tensor


@pytest.mark.parametrize("with_state", [False, True])
def test_apply_rwkv_cmix_matches_jax(with_state):
    jcfg, tcfg = _cfgs()
    jp = jrwkv.init_rwkv_cmix(jax.random.key(4), jcfg)
    tp = _t(_np(jp))
    b, t = 3, 5
    x = _x(b, t, jcfg.d_model, 5)
    js, ts = _state_pair(jcfg, b, 6) if with_state else (None, None)
    jy, jns = jrwkv.apply_rwkv_cmix(jcfg, jp, jnp.asarray(x), js)
    ty, tns = trwkv.apply_rwkv_cmix(tcfg, tp, torch.from_numpy(x), ts)
    _close(ty.numpy(), jy)
    if with_state:
        for name in ("tm_x", "wkv", "cm_x"):
            _close(tns[name].numpy(), jns[name], err_msg=name)
        assert tns["cm_x"] is ts["cm_x"]
    else:
        assert tns is None and jns is None


# ------------------------------------------------------- the transformer


def _models(**overrides):
    jcfg, tcfg = _cfgs(**overrides)
    jp = jT.init_params(jax.random.key(13), jcfg)
    return jcfg, tcfg, jp, tT.params_from_jax(_np(jp), tcfg, device="cpu")


@pytest.mark.parametrize("per_slot", [False, True])
def test_forward_and_decode_step_match_jax(per_slot):
    """Prefill then four decode steps on the reduced rwkv6-7b (2 layers,
    d_model 256, 4 heads of 64), with K7's plain version and without: the
    logits of every step and the final states of every layer."""
    jcfg, tcfg, jp, tp = _models()
    assert tT.param_count(tp) == jT.param_count(jp)
    assert "lm_head" in tp and len(tp["blocks"]) == 2
    b, p = 2, 6
    toks = np.random.default_rng(14).integers(0, tcfg.vocab_size, size=(b, p)).astype(np.int32)
    pos = np.broadcast_to(np.arange(p, dtype=np.int32), (b, p)).copy()

    jh, _, _ = jT.forward(jcfg, jp, jnp.asarray(toks), jnp.asarray(pos))
    th, tc, aux = tT.forward(tcfg, tp, torch.from_numpy(toks), torch.from_numpy(pos))
    assert tc is None and float(aux) == 0.0
    _close(th.numpy(), jh)

    for use_flash in (False, True):
        jc = jT.init_caches(jcfg, b, p + 4, per_slot=per_slot)
        tc = tT.init_caches(tcfg, b, p + 4, per_slot=per_slot, device="cpu")
        jh, jc, _ = jT.forward(jcfg, jp, jnp.asarray(toks), jnp.asarray(pos), jc)
        with torch.no_grad():
            th, tc, _ = tT.forward(tcfg, tp, torch.from_numpy(toks), torch.from_numpy(pos), tc,
                                   use_flash=use_flash)
        _close(th.numpy(), jh)
        nxt = np.asarray(jnp.argmax(jT.logits_from_hidden(jcfg, jp, jh[:, -1:])[:, 0], -1))
        nxt = nxt.astype(np.int32)[:, None]
        for step in range(4):
            jl, jc = jT.decode_step(jcfg, jp, jnp.asarray(nxt), jc)
            with torch.no_grad():
                tl, tc = tT.decode_step(tcfg, tp, torch.from_numpy(nxt), tc, use_flash=use_flash)
            assert tl.shape == (b, 1, tT.vocab_padded(tcfg))
            _close(tl.numpy(), jl, err_msg=f"flash={use_flash} step {step}")
            nxt = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)[:, None]
        for tu, ju in zip(tc["unit"], jc["unit"]):
            assert set(tu) == set(ju) == {"tm_x", "wkv", "cm_x", "pos"}
            np.testing.assert_array_equal(tu["pos"].numpy(), np.asarray(ju["pos"]))
            for name in ("tm_x", "wkv", "cm_x"):
                _close(tu[name].numpy(), ju[name], err_msg=name)
        assert int(tT._cache_pos(tc).max()) == p + 4


def test_forward_returns_every_cache_key_sharing_the_tensors():
    """The caches ``forward`` returns carry every key a layer's cache has
    (an RWKV layer's tm_x, wkv and cm_x, not only k/v), as the same tensors
    written in place, with advanced positions; a remainder layer too."""
    jcfg, tcfg, jp, tp = _models(num_layers=3, block_pattern=("rwkv+cmix", "rwkv+cmix"))
    caches = tT.init_caches(tcfg, 2, 8, device="cpu")
    assert len(caches["rem"]) == 1
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 512, size=(2, 4)).astype(np.int32))
    pos = torch.arange(4, dtype=torch.int32)[None].expand(2, 4)
    _, new, _ = tT.forward(tcfg, tp, toks, pos, caches)
    for old_u, new_u in zip(caches["unit"], new["unit"]):
        assert set(new_u) == set(old_u) == {"tm_x", "wkv", "cm_x", "pos"}
        for name in ("tm_x", "wkv", "cm_x"):
            assert new_u[name] is old_u[name] and bool(new_u[name].abs().sum() > 0)
        assert new_u["pos"].tolist() == [4]  # one repeat of the two-layer unit
    assert set(new["rem"][0]) == {"tm_x", "wkv", "cm_x", "pos"} and int(new["rem"][0]["pos"]) == 4
    # a second forward continues from the returned caches, as JAX's does
    jc = jT.init_caches(jcfg, 2, 8)
    _, jc, _ = jT.forward(jcfg, jp, jnp.asarray(toks.numpy()), jnp.asarray(pos.numpy()), jc)
    jl, _ = jT.decode_step(jcfg, jp, jnp.asarray(toks.numpy()[:, :1]), jc)
    tl, _ = tT.decode_step(tcfg, tp, toks[:, :1], new)
    _close(tl.numpy(), jl)


def test_rwkv_state_is_constant_size():
    """The decode state is O(1) in the sequence length, as
    ``tests/test_models.py::test_rwkv_state_is_constant_size`` states."""
    _, tcfg = _cfgs()
    sizes = {n: sum(x.numel() for c in tT.init_caches(tcfg, 1, n, device="cpu")["unit"] for x in c.values())
             for n in (8, 1 << 19)}
    assert sizes[8] == sizes[1 << 19] < 1e6


# --------------------------------------------------------------- weights


def test_params_from_jax_keeps_each_leaf_dtype():
    """Under a bf16 param_dtype JAX keeps ``w0`` and ``u`` fp32; the port's
    converted tree keeps them so (a cast of every leaf to the param dtype
    would round the decay base and the bonus to bf16)."""
    kw = dict(param_dtype="bfloat16", dtype="bfloat16", remat=False)
    jcfg = jget_arch(ARCH).model.reduced(**kw)
    tcfg = get_arch(ARCH).model.reduced(**kw)
    jp = jT.init_params(jax.random.key(3), jcfg)
    tp = tT.params_from_jax(_np(jp), tcfg, device="cpu")
    mixer = tp["blocks"][1]["mixer"]
    assert mixer["w0"].dtype == mixer["u"].dtype == torch.float32
    assert mixer["wr"]["w"].dtype == mixer["mu_k"].dtype == tp["embed"]["w"].dtype == torch.bfloat16
    jm = jax.tree_util.tree_map(lambda a: np.asarray(a[1], np.float32), jp["unit"][0]["mixer"])
    np.testing.assert_array_equal(mixer["w0"].numpy(), jm["w0"])  # not rounded
    np.testing.assert_array_equal(mixer["u"].numpy(), jm["u"])
    np.testing.assert_array_equal(mixer["wr"]["w"].float().numpy(), jm["wr"]["w"])


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def test_init_params_follows_jax_laws():
    kw = dict(param_dtype="bfloat16", dtype="bfloat16", remat=False)
    jcfg = jget_arch(ARCH).model.reduced(d_model=512, **kw)
    tcfg = get_arch(ARCH).model.reduced(d_model=512, **kw)
    tp = tT.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    jp = jT.init_params(jax.random.key(0), jcfg)
    assert tT.param_count(tp) == jT.param_count(jp)
    # the same leaves, shapes and dtypes as JAX's layer 0
    jblock = jax.tree_util.tree_map(lambda a: a[0], jp["unit"][0])
    want = {n: (tuple(np.shape(a)), str(a.dtype)) for n, a in _leaves(_np(jblock))}
    got = {n: (tuple(x.shape), str(x.dtype).replace("torch.", "")) for n, x in _leaves(tp["blocks"][0])}
    assert got == want
    m, c = tp["blocks"][0]["mixer"], tp["blocks"][0]["ffn"]
    d = tcfg.d_model
    for mu in [m[f"mu_{n}"] for n in "xwkvrg"] + [c["mu_k"], c["mu_r"]]:
        assert 0.0 <= float(mu.min()) and float(mu.max()) <= 1.0 and abs(float(mu.float().mean()) - 0.5) < 0.05
    assert m["w0"].dtype == torch.float32 and -6.0 <= float(m["w0"].min()) and float(m["w0"].max()) <= -5.0
    assert abs(float(m["w0"].mean()) + 5.5) < 0.05
    # sample stds of 16k draws (LoRA), 512 (u), 262k (dense) within a few percent
    for name in ("a_w", "b_w"):
        assert abs(float(m[name].float().std()) / 0.01 - 1.0) < 0.03
    assert m["u"].dtype == torch.float32 and abs(float(m["u"].std()) / 0.1 - 1.0) < 0.1
    assert abs(float(m["wr"]["w"].float().std()) * d**0.5 - 1.0) < 0.02
    assert abs(float(c["wv"]["w"].float().std()) * tcfg.d_ff**0.5 - 1.0) < 0.02
    assert torch.equal(m["ln_scale"], torch.ones(d, dtype=torch.bfloat16))


def test_rwkv_config_is_the_jax_config():
    jm, tm = jget_arch(ARCH).model, get_arch(ARCH).model
    for full_j, full_t in ((jm, tm), (jm.reduced(), tm.reduced())):
        want = dataclasses.asdict(full_j)
        for name, value in dataclasses.asdict(full_t).items():
            assert value == want[name], name
        assert full_t.layer_types() == full_j.layer_types() == ("rwkv+cmix",) * full_t.num_layers
    assert get_arch(ARCH).fl.lr == jget_arch(ARCH).fl.lr == 2e-3
    red = tm.reduced()
    assert (red.num_layers, red.d_model, red.d_model // red.rwkv_head_dim, red.rwkv_head_dim) == (2, 256, 4, 64)


@pytest.mark.parametrize("use_flash", [False, True])
def test_lm_loss_matches_jax(use_flash):
    """The no-cache forward (the training path's) through the RWKV blocks;
    ``use_flash`` sends the time mix through K7's plain version."""
    jcfg, tcfg, jp, tp = _models(loss_chunk=5)
    toks = np.random.default_rng(15).integers(0, tcfg.vocab_size, size=(2, 12)).astype(np.int32)
    want = jT.lm_loss(jcfg, jp, jnp.asarray(toks))
    with torch.no_grad():
        got = tT.lm_loss(tcfg, tp, torch.from_numpy(toks), use_flash=use_flash)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ bf16


def test_gate_sigmoid_and_silu_round_as_jax_does():
    """The time mix's SiLU gate and the channel mix's sigmoid gate round
    where JAX's do: XLA evaluates a bf16 ``jax.nn.sigmoid`` as 1 / (1 +
    exp(−x)) with exp(−x) rounded to bf16, and ``jax.nn.silu`` as x times
    that sigmoid rounded to bf16.  Bit for bit on bf16 inputs."""
    x = np.random.default_rng(17).normal(scale=4.0, size=(4096,)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    for jfn, tfn in ((jax.nn.sigmoid, trwkv._sigmoid), (jax.nn.silu, trwkv._silu)):
        got = tfn(xt)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(jfn(xj).astype(jnp.float32)))


@pytest.mark.parametrize("num_layers", [2, 4])
def test_bf16_forward_parts_from_jax_no_further_than_from_fp32(num_layers):
    """JAX's bf16 ``forward`` against the port's plain bf16 path on the same
    ``params_from_jax`` weights and token ids, with the port's fp32 copy of
    the model as the yardstick: the port's bf16 logits may part from JAX's
    no further than from its own fp32 logits, by the largest element and
    by the Frobenius norm.  Both bf16 paths keep their remaining
    differences below that: the WKV's fp32 sums taken in another order and
    fp32 ``exp`` ulps in the decay flip single bf16 roundings."""
    kw = dict(param_dtype="bfloat16", dtype="bfloat16", remat=False, num_layers=num_layers)
    jcfg, tcfg = jget_arch(ARCH).model.reduced(**kw), get_arch(ARCH).model.reduced(**kw)
    jp = jT.init_params(jax.random.key(13), jcfg)
    tp = tT.params_from_jax(_np(jp), tcfg, device="cpu")
    cfg32 = dataclasses.replace(tcfg, dtype="float32", param_dtype="float32")
    tp32 = jax.tree_util.tree_map(lambda a: a.float(), tp)
    toks = np.random.default_rng(16).integers(0, tcfg.vocab_size, size=(2, 16)).astype(np.int32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()

    jh, _, _ = jT.forward(jcfg, jp, jnp.asarray(toks), jnp.asarray(pos))
    want = np.asarray(jT.logits_from_hidden(jcfg, jp, jh).astype(jnp.float32))
    with torch.no_grad():
        logits = {}
        for name, (c, p) in {"bf16": (tcfg, tp), "fp32": (cfg32, tp32)}.items():
            h, _, _ = tT.forward(c, p, torch.from_numpy(toks), torch.from_numpy(pos))
            logits[name] = tT.logits_from_hidden(c, p, h).float().numpy()
    assert logits["bf16"].shape == want.shape and np.isfinite(logits["bf16"]).all()
    to_jax, to_fp32 = logits["bf16"] - want, logits["bf16"] - logits["fp32"]
    assert np.abs(to_jax).max() <= np.abs(to_fp32).max()
    assert np.linalg.norm(to_jax) <= np.linalg.norm(to_fp32)
