"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's
``repro.models.moe`` on the CPU, with JAX-initialised weights carried
across as numpy.

Tolerances: fp32 at ``rtol = atol = 1e-5`` (``tests/test_torch_models.py``'s
``TOL``: the router's and experts' GEMMs sum in another order).  The
routing itself is held exactly: the same experts per token, the same kept
(token, expert) pairs, the same drops.  bf16 is held on weights whose
GEMM sums are exact in fp32 in any order (``_exact_weights``): with one
expert a token the combine weight is exactly 1 and the output matches
JAX's bit for bit; with the real routers the combine weights come from
fp32 ``exp`` (softmax, sigmoid), whose last-ulp differences between XLA
and PyTorch may flip the final rounding to bf16, so each element is held
within one bf16 step of JAX's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ROUTERS = {  # arch -> what its router is
    "mixtral-8x7b": "softmax over the top 2",
    "llama4-maverick-400b-a17b": "sigmoid of the top 1",
}


def _cfgs(arch, dtype="float32", **overrides):
    kw = dict(param_dtype=dtype, dtype=dtype, remat=False, **overrides)
    return jget_arch(arch).model.reduced(**kw), get_arch(arch).model.reduced(**kw)


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jax_kept_pairs(jcfg, jp, x):
    """JAX's routing and dispatch on x, in its own ops: the experts of each
    token and the set of kept (token, expert) pairs."""
    t = x.shape[0] * x.shape[1]
    k, e = jcfg.experts_per_token, jcfg.num_experts
    logits = jnp.asarray(x).reshape(t, -1).astype(jnp.float32) @ jp["router"]["w"]
    idx, _, _ = jmoe._route(jcfg, logits)
    flat = idx.reshape(-1)
    order = jnp.argsort(flat, stable=True)
    sorted_e = flat[order]
    group_start = jnp.searchsorted(sorted_e, jnp.arange(e), side="left")
    keep = jnp.arange(t * k) - group_start[sorted_e] < jmoe._capacity(jcfg, t)
    pairs = {(int(o) // k, int(ex)) for o, ex, kp in zip(order, sorted_e, keep) if kp}
    return np.asarray(idx), pairs


def _torch_kept_pairs(tcfg, tp, x):
    t = x.shape[0] * x.shape[1]
    k = tcfg.experts_per_token
    idx, _, _ = tmoe._route(tcfg, tmoe._router_logits(tp, x.reshape(t, -1)))
    order, _, keep = tmoe._dispatch(idx, tcfg.num_experts, tmoe._capacity(tcfg, t))
    sorted_e = idx.reshape(-1)[order]
    pairs = {(int(o) // k, int(ex)) for o, ex, kp in zip(order, sorted_e, keep) if kp}
    return idx.numpy(), pairs


def _exact_weights(cfg, seed):
    """bf16 MoE weights (fp32 numpy holding bf16 values) on which every
    expert GEMM sum is exact in fp32: ``wi``, ``wg`` multiples of 2^-5 in
    [-1/4, 1/4] (inputs multiples of 2^-2 in [-2, 2]), ``wo`` a signed
    permutation per expert, as ``test_torch_models._exact_mlp_weights``;
    the router fp32 N(0, 1/D), so routing has no ties; the shared expert
    like the routed ones."""
    rng = np.random.default_rng(seed)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    assert f == d

    def perm():
        w = np.zeros((f, d))
        w[rng.permutation(f), np.arange(d)] = rng.choice([-1.0, 1.0], size=d)
        return w

    small = lambda *shape: rng.integers(-8, 9, size=shape) * 2.0**-5  # noqa: E731
    p = {
        "router": {"w": rng.normal(size=(d, e)) * d**-0.5},
        "wi": small(e, d, f),
        "wg": small(e, d, f),
        "wo": np.stack([perm() for _ in range(e)]),
    }
    if cfg.shared_expert:
        p["shared"] = {"wi": {"w": small(d, f)}, "wg": {"w": small(d, f)}, "wo": {"w": perm()}}
    return jax.tree_util.tree_map(lambda a: a.astype(np.float32), p)


def _exact_inputs(shape, seed):
    return np.random.default_rng(seed).integers(-8, 9, size=shape).astype(np.float32) / 4


def _bf16_pair(p):
    """The same exact weights for JAX (bf16, the router fp32) and the port."""
    jp = {k: (jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), v) if k != "router"
              else jax.tree_util.tree_map(jnp.asarray, v)) for k, v in p.items()}
    tp = {k: (jax.tree_util.tree_map(lambda a: torch.from_numpy(a).bfloat16(), v) if k != "router"
              else jax.tree_util.tree_map(torch.from_numpy, v)) for k, v in p.items()}
    return jp, tp


# ---------------------------------------------------------------- fp32


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25], ids=["no-drops", "drops"])
@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared"])
@pytest.mark.parametrize("arch", sorted(ROUTERS))
def test_apply_moe_matches_jax(arch, shared, capacity_factor):
    """Both routers, with and without the shared expert; at the config's
    capacity factor (no drops here) and at 0.25, where every expert
    overflows and pairs drop.  The same experts, kept pairs and drops; y
    and the aux loss at TOL."""
    jcfg, tcfg = _cfgs(arch, shared_expert=shared, capacity_factor=capacity_factor)
    jp = jmoe.init_moe(jax.random.key(3), jcfg)
    tp = _to_torch(jp)
    assert tp["router"]["w"].dtype == torch.float32 and ("shared" in tp) == shared
    x = np.random.default_rng(4).normal(size=(2, 16, jcfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x))
    ty, taux = tmoe.apply_moe(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)

    jidx, jkept = _jax_kept_pairs(jcfg, jp, x)
    tidx, tkept = _torch_kept_pairs(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_array_equal(tidx, jidx)
    assert tkept == jkept
    dropped = 32 * tcfg.experts_per_token - len(tkept)
    assert (dropped > 0) == (capacity_factor < 1)


def test_capacity_rounds_up_to_eight_and_depends_on_the_call():
    """``_capacity`` is JAX's; the same tokens routed alone or beside
    others keep different pairs (capacity counts every token of the call),
    as in JAX."""
    for arch in ROUTERS:
        jcfg, tcfg = _cfgs(arch)
        for t in (1, 7, 16, 100, 2048):
            assert tmoe._capacity(tcfg, t) == jmoe._capacity(jcfg, t)
            assert tmoe._capacity(tcfg, t) % 8 == 0
    jcfg, tcfg = _cfgs("mixtral-8x7b", capacity_factor=0.25)
    jp = jmoe.init_moe(jax.random.key(5), jcfg)
    tp = _to_torch(jp)
    x = np.random.default_rng(6).normal(size=(2, 16, jcfg.d_model)).astype(np.float32)
    # the second row's tokens sort after the first row's within each expert,
    # so beside them they find the experts fuller than alone
    _, both = _torch_kept_pairs(tcfg, tp, torch.from_numpy(x))
    _, alone = _torch_kept_pairs(tcfg, tp, torch.from_numpy(x[1:]))
    beside = {(t - 16, ex) for t, ex in both if t >= 16}
    assert beside < alone
    for rows in (x, x[1:]):
        jy, _ = jmoe.apply_moe(jcfg, jp, jnp.asarray(rows))
        ty, _ = tmoe.apply_moe(tcfg, tp, torch.from_numpy(rows))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


# ---------------------------------------------------------------- bf16


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25], ids=["no-drops", "drops"])
@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared"])
def test_bf16_moe_bit_for_bit_with_one_expert_a_token(shared, capacity_factor, monkeypatch):
    """Top-1 softmax routing (a combine weight of exactly 1) on exact
    weights: JAX's bf16 output bit for bit, drops included.  The control
    rounds the SiLU once (``F.silu``, the PR 17 fault) and parts from it."""
    kw = dict(d_ff=256, experts_per_token=1, router_type="softmax", shared_expert=shared,
              capacity_factor=capacity_factor)
    jcfg, tcfg = _cfgs("mixtral-8x7b", "bfloat16", **kw)
    jp, tp = _bf16_pair(_exact_weights(jcfg, 7))
    x = _exact_inputs((2, 16, jcfg.d_model), 8)
    want = np.asarray(jmoe.apply_moe(jcfg, jp, jnp.asarray(x, jnp.bfloat16))[0].astype(jnp.float32))
    got, _ = tmoe.apply_moe(tcfg, tp, torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    kept = _torch_kept_pairs(tcfg, tp, torch.from_numpy(x).bfloat16())[1]
    assert (len(kept) < 32) == (capacity_factor < 1)

    import torch.nn.functional as F

    monkeypatch.setattr(tlayers, "silu", F.silu)
    once, _ = tmoe.apply_moe(tcfg, tp, torch.from_numpy(x).bfloat16())
    assert (once.float().numpy() != want).mean() > 0.05


@pytest.mark.parametrize("arch", sorted(ROUTERS))
def test_bf16_moe_within_one_bf16_step_with_the_real_routers(arch):
    """The arch's own router on exact expert weights, with pairs dropped:
    the same kept pairs as JAX, and every output element within one bf16
    step of JAX's (the combine weights' fp32 ulps may flip the last
    rounding); the aux loss at TOL."""
    jcfg, tcfg = _cfgs(arch, "bfloat16", d_ff=256,
                       capacity_factor=0.5)
    jp, tp = _bf16_pair(_exact_weights(jcfg, 9))
    x = _exact_inputs((2, 16, jcfg.d_model), 10)
    jy, jaux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x, jnp.bfloat16))
    ty, taux = tmoe.apply_moe(tcfg, tp, torch.from_numpy(x).bfloat16())
    want = np.asarray(jy.astype(jnp.float32))
    got = ty.float().numpy()
    assert np.all(np.abs(got - want) <= 2.0**-7 * np.abs(want))
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    _, jkept = _jax_kept_pairs(jcfg, jp, jnp.asarray(x, jnp.bfloat16))
    _, tkept = _torch_kept_pairs(tcfg, tp, torch.from_numpy(x).bfloat16())
    assert tkept == jkept and len(tkept) < 32 * tcfg.experts_per_token


def test_init_moe_laws_and_dtypes():
    """Shapes, the fp32 router in a bf16 model, and the scale of each
    weight (std 1/sqrt(D) for wi, wg and the router, 1/sqrt(d_ff) for wo)."""
    _, tcfg = _cfgs("llama4-maverick-400b-a17b", "bfloat16")
    p = tmoe.init_moe(torch.Generator().manual_seed(0), tcfg, "cpu")
    e, d, f = tcfg.num_experts, tcfg.d_model, tcfg.d_ff
    assert p["router"]["w"].shape == (d, e) and p["router"]["w"].dtype == torch.float32
    assert p["wi"].shape == p["wg"].shape == (e, d, f) and p["wo"].shape == (e, f, d)
    assert p["wi"].dtype == p["wo"].dtype == p["shared"]["wi"]["w"].dtype == torch.bfloat16
    for w, std in ((p["wi"], d**-0.5), (p["wg"], d**-0.5), (p["wo"], f**-0.5)):
        assert abs(float(w.float().std()) / std - 1.0) < 0.05
