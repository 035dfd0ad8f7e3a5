"""The port's RG-LRU block (``repro_torch.models.rglru``) against the JAX
package's ``repro.models.rglru`` on the CPU, with JAX-initialised weights
carried across as numpy.

Tolerances: fp32 at ``rtol = atol = 1e-5`` (``tests/test_torch_models.py``'s
``TOL``: the dense products sum in another order).  The parallel form's
scan pairs its elements as ``lax.associative_scan`` does and matches it
bit for bit on the same (a, b).  bf16: the causal conv, whose every
product and sum rounds to bf16 in JAX, bit for bit; the whole block may
part from JAX's no further than from the port's own fp32 block (the
gates' fp32 ``exp`` and ``sigmoid`` differ in the last ulp between XLA
and PyTorch, which flips single bf16 roundings of the output)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro.models import transformer as jT  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402

ARCH = "recurrentgemma-9b"
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(dtype="float32", **overrides):
    kw = dict(param_dtype=dtype, dtype=dtype, remat=False, **overrides)
    return jget_arch(ARCH).model.reduced(**kw), get_arch(ARCH).model.reduced(**kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_torch(tree):
    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).bfloat16()
        return torch.from_numpy(np.array(a))

    return jax.tree_util.tree_map(conv, tree)


def _block(dtype="float32", seed=0):
    jcfg, tcfg = _cfgs(dtype)
    jp = jrg.init_rglru(jax.random.key(seed), jcfg)
    return jcfg, tcfg, jp, _to_torch(jp)


def _x(b, s, d, seed):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(np.float32)


@pytest.mark.parametrize("s", [1, 2, 3, 7, 16, 33])
def test_associative_scan_pairs_as_lax_does(s):
    """The parallel form's scan on the same (a, b) as ``lax.associative_scan``
    with JAX's combine: bit for bit, at odd and even lengths (the
    recursion's two cases)."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, size=(2, s, 24)).astype(np.float32)
    b = rng.normal(size=(2, s, 24)).astype(np.float32)

    def combine(lhs, rhs):
        return lhs[0] * rhs[0], rhs[0] * lhs[1] + rhs[1]

    ja, jh = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    ta, th = trg._associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    # and it is the recurrence h_t = a_t h_{t-1} + b_t from 0
    h, hs = np.zeros((2, 24), np.float64), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    np.testing.assert_allclose(th.numpy(), np.stack(hs, 1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [1, 6, 13])
def test_apply_rglru_without_a_state_matches_jax(s):
    jcfg, tcfg, jp, tp = _block()
    assert tp["lam"].dtype == torch.float32
    x = _x(2, s, jcfg.d_model, 20 + s)
    jy, jst = jrg.apply_rglru(jcfg, jp, jnp.asarray(x))
    ty, tst = trg.apply_rglru(tcfg, tp, torch.from_numpy(x))
    assert jst is None and tst is None
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


@pytest.mark.parametrize("per_slot", [False, True])
def test_apply_rglru_with_a_state_matches_jax_and_writes_it_in_place(per_slot):
    """From a state already advanced (conv buffer and h nonzero), a prefill
    of 5 then three decode steps: y, conv, h and pos as JAX's after each;
    the state's tensors are written in place and the returned dict shares
    them."""
    jcfg, tcfg, jp, tp = _block(seed=1)
    b = 3
    jst = jrg.init_rglru_state(jcfg, b, per_slot=per_slot)
    tst = trg.init_rglru_state(tcfg, b, per_slot=per_slot)
    conv_t, h_t = tst["conv"], tst["h"]
    for i, s in enumerate([4, 5, 1, 1, 1]):
        x = _x(b, s, jcfg.d_model, 30 + i)
        jy, jst = jrg.apply_rglru(jcfg, jp, jnp.asarray(x), jst)
        ty, tst = trg.apply_rglru(tcfg, tp, torch.from_numpy(x), tst)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL, err_msg=f"call {i}")
        for name in ("conv", "h"):
            np.testing.assert_allclose(tst[name].numpy(), np.asarray(jst[name]), **TOL, err_msg=f"{name} {i}")
        np.testing.assert_array_equal(tst["pos"].numpy(), np.asarray(jst["pos"]))
        assert tst["conv"] is conv_t and tst["h"] is h_t
    assert tst["h"].dtype == torch.float32 and tst["conv"].shape == (b, 3, tcfg.rnn_width)


def test_prefill_then_decode_equals_the_whole_sequence():
    """The sequential path in pieces (prefill 7, then 5 single steps) gives
    the parallel form's output over the whole 12 steps, and JAX's."""
    jcfg, tcfg, jp, tp = _block(seed=2)
    x = _x(2, 12, jcfg.d_model, 40)
    whole, _ = trg.apply_rglru(tcfg, tp, torch.from_numpy(x))
    st = trg.init_rglru_state(tcfg, 2)
    parts = []
    for lo, hi in [(0, 7)] + [(t, t + 1) for t in range(7, 12)]:
        y, st = trg.apply_rglru(tcfg, tp, torch.from_numpy(x[:, lo:hi]), st)
        parts.append(y)
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(), whole.numpy(), **TOL)
    jy, _ = jrg.apply_rglru(jcfg, jp, jnp.asarray(x))
    np.testing.assert_allclose(whole.numpy(), np.asarray(jy), **TOL)
    assert int(st["pos"]) == 12


def test_bf16_conv_rounds_as_jax_does():
    """The causal conv in bf16, each product and sum rounded as JAX's, with
    and without a buffer: bit for bit.  The control sums in fp32 and rounds
    once, and parts from JAX's."""
    jcfg, tcfg, jp, tp = _block("bfloat16", seed=3)
    jp = dict(jp, conv_b=jnp.asarray(_x(1, 1, jcfg.rnn_width, 50)[0, 0] * 0.1, jnp.bfloat16))
    tp = _to_torch(jp)
    xi = _x(2, 9, jcfg.rnn_width, 51)
    buf = _x(2, 3, jcfg.rnn_width, 52)
    for jb, tb in ((None, None), (jnp.asarray(buf, jnp.bfloat16), torch.from_numpy(buf).bfloat16())):
        jo, jnew = jrg._causal_conv(jp, jnp.asarray(xi, jnp.bfloat16), jb)
        to, tnew = trg._causal_conv(tp, torch.from_numpy(xi).bfloat16(), tb)
        assert to.dtype == torch.bfloat16
        want = np.asarray(jo.astype(jnp.float32))
        np.testing.assert_array_equal(to.float().numpy(), want)
        if jnew is not None:
            np.testing.assert_array_equal(tnew.float().numpy(), np.asarray(jnew.astype(jnp.float32)))
    full = torch.cat([torch.from_numpy(buf).bfloat16(), torch.from_numpy(xi).bfloat16()], 1).float()
    once = (sum(full[:, i : i + 9] * tp["conv_w"][i].float() for i in range(4)) + tp["conv_b"].float()).bfloat16()
    assert (once.float().numpy() != want).mean() > 0.05


@pytest.mark.parametrize("stateful", [False, True])
def test_bf16_block_parts_from_jax_no_further_than_from_fp32(stateful):
    """JAX's bf16 block against the port's on the same bf16 weights and
    inputs, with the port's fp32 copy of the block as the yardstick: by
    the largest element and by the Frobenius norm."""
    jcfg, tcfg, jp, tp = _block("bfloat16", seed=4)
    cfg32 = dataclasses.replace(tcfg, dtype="float32", param_dtype="float32")
    tp32 = jax.tree_util.tree_map(lambda a: a.float(), tp)
    x = torch.from_numpy(_x(2, 16, jcfg.d_model, 60)).bfloat16()
    jst = jrg.init_rglru_state(jcfg, 2) if stateful else None
    want = np.asarray(jrg.apply_rglru(jcfg, jp, jnp.asarray(x.float().numpy(), jnp.bfloat16), jst)[0]
                      .astype(jnp.float32))
    st = trg.init_rglru_state(tcfg, 2) if stateful else None
    st32 = trg.init_rglru_state(cfg32, 2) if stateful else None
    got = trg.apply_rglru(tcfg, tp, x, st)[0]
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ref32 = trg.apply_rglru(cfg32, tp32, x.float(), st32)[0].numpy()
    to_jax, to_fp32 = got - want, got - ref32
    assert np.abs(to_jax).max() <= np.abs(to_fp32).max()
    assert np.linalg.norm(to_jax) <= np.linalg.norm(to_fp32)


def test_init_rglru_laws():
    """Λ fp32 in a bf16 model, with a = exp(−8 softplus(Λ)) in (0.9, 0.999)
    at r = 1; zero biases; conv N(0, 0.1²); the state's dtypes."""
    _, tcfg = _cfgs("bfloat16")
    p = trg.init_rglru(torch.Generator().manual_seed(0), tcfg, "cpu")
    dr = tcfg.rnn_width
    assert p["lam"].dtype == torch.float32 and p["w_in"]["w"].dtype == torch.bfloat16
    a = torch.exp(-8.0 * torch.nn.functional.softplus(p["lam"]))
    assert bool(((a > 0.9 - 1e-6) & (a < 0.999 + 1e-6)).all())
    assert p["conv_w"].shape == (4, dr) and abs(float(p["conv_w"].float().std()) / 0.1 - 1) < 0.1
    assert not p["b_r"].any() and not p["b_i"].any() and not p["conv_b"].any()
    st = trg.init_rglru_state(tcfg, 2, per_slot=True)
    assert st["conv"].dtype == torch.bfloat16 and st["h"].dtype == torch.float32 and st["pos"].shape == (2,)


def test_forward_writes_rglru_states_into_the_stacked_caches():
    """Through ``transformer.forward``, every RG-LRU layer's conv buffer and
    ``h`` land in the layer's row of the layer-stacked caches (unit and
    remainder), as JAX's new caches hold them."""
    kw = dict(param_dtype="float32", dtype="float32", remat=False, num_layers=5)
    jcfg, tcfg = jget_arch(ARCH).model.reduced(**kw), get_arch(ARCH).model.reduced(**kw)
    jp = jT.init_params(jax.random.key(5), jcfg)
    tp = tT.params_from_jax(_np(jp), tcfg, device="cpu")
    toks = np.random.default_rng(6).integers(0, tcfg.vocab_size, size=(2, 6)).astype(np.int32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6)).copy()
    jc = jT.init_caches(jcfg, 2, 8, per_slot=True)
    tc = tT.init_caches(tcfg, 2, 8, per_slot=True, device="cpu")
    held = [tc["unit"][j]["h"] for j in (0, 1)] + [tc["rem"][0]["h"], tc["rem"][1]["h"]]
    _, jc, _ = jT.forward(jcfg, jp, jnp.asarray(toks), jnp.asarray(pos), jc)
    _, tc, _ = tT.forward(tcfg, tp, torch.from_numpy(toks), torch.from_numpy(pos), tc)
    assert len(tc["rem"]) == 2 and tc["unit"][0]["h"].shape == (1, 2, tcfg.rnn_width)
    assert all(bool(h.abs().sum() > 0) for h in held)
    for tu, ju in list(zip(tc["unit"][:2], jc["unit"][:2])) + list(zip(tc["rem"], jc["rem"])):
        for name in ("conv", "h"):
            np.testing.assert_allclose(tu[name].numpy(), np.asarray(ju[name]), **TOL)
        np.testing.assert_array_equal(tu["pos"].numpy(), np.asarray(ju["pos"]))
    assert tc["unit"][0]["h"] is held[0] and tc["rem"][0]["h"] is held[2]
