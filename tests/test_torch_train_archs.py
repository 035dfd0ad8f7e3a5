"""Training the six archs the port first only served (rwkv6-7b, qwen2-vl-2b,
musicgen-medium, recurrentgemma-9b, mixtral-8x7b, llama4-maverick) against
the JAX package on the CPU, at ``reduced()`` size in fp32 with JAX's
params carried across by ``params_from_jax``: ``lm_loss`` and its gradient
(MoE aux loss included; the ``embeds=`` path for qwen2-vl-2b and
musicgen-medium), the launcher's pretrain against JAX's ``run_pretrain``
construction, ``cfg.remat`` against the same pass without it, the
launcher on every arch of the registry, and the repair of rwkv6-7b's
training crash (a leaf the loss does not read).

Tolerances: losses ``rtol = atol = 1e-5`` (fp32 sums of the same products
in another order); a gradient leaf within ``GRAD_REL`` of its largest
entry; remat bit for bit."""

import argparse
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.data import make_token_dataset as j_make_token_dataset  # noqa: E402
from repro.fl import rounds as jrounds  # noqa: E402
from repro.models import transformer as jT  # noqa: E402

from repro_torch import optim as toptim  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_arch  # noqa: E402
from repro_torch.fl.local_algos import make_grad_fn  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCHS = ["rwkv6-7b", "qwen2-vl-2b", "musicgen-medium", "recurrentgemma-9b", "mixtral-8x7b",
         "llama4-maverick-400b-a17b"]
REDUCED = dict(param_dtype="float32", dtype="float32", remat=False)
TOL = dict(rtol=1e-5, atol=1e-5)
# a gradient leaf's largest error over its largest entry: fp32 sums of the
# same products in another order, through up to six layers (measured up to
# ~1e-5 at these inputs)
GRAD_REL = 5e-5



@pytest.fixture(autouse=True)
def one_thread():
    """Small models on the CPU: one intra-op thread keeps the port's side
    from contending for the cores with the other test workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(arch, seed=17, **kw):
    cfg_kw = dict(REDUCED, **kw)
    jcfg, tcfg = jget_arch(arch).model.reduced(**cfg_kw), get_arch(arch).model.reduced(**cfg_kw)
    jp = jT.init_params(jax.random.key(seed), jcfg)
    return jcfg, tcfg, jp, tT.params_from_jax(_np(jp), tcfg, device="cpu")


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _assert_grads_close(tgrad, jgrad, tcfg):
    want = tT.params_from_jax(_np(jgrad), tcfg, device="cpu")
    for a, b in zip(tree_leaves(tgrad), tree_leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= GRAD_REL * scale + 1e-12, (tuple(a.shape), err, scale)


# ------------------------------------------------------- loss and gradient


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradient_match_jax(arch):
    """``lm_loss`` (with the MoE layers' aux loss) and its gradient through
    ``make_grad_fn`` against ``jax.value_and_grad``, on a (2, 12) batch."""
    jcfg, tcfg, jp, tp = _models(arch)
    toks = _tokens(jcfg, 2, 12, 3)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jT.lm_loss(jcfg, p, jnp.asarray(toks))))(jp)
    tl, tg = make_grad_fn(lambda p, b: tT.lm_loss(tcfg, p, b))(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    _assert_grads_close(tg, jg, tcfg)


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-medium"])
def test_lm_loss_gradient_through_embeds_matches_jax(arch):
    """The frontends' path: ``embeds`` (B, S, D) with ``targets`` in place
    of tokens, the gradient taken over the params and the embeds."""
    jcfg, tcfg, jp, tp = _models(arch)
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((2, 10, jcfg.d_model)).astype(np.float32) * 0.1
    tgt = _tokens(jcfg, 2, 10, 6)

    def jloss(p, e):
        return jT.lm_loss(jcfg, p, embeds=e, targets=jnp.asarray(tgt))

    jl, (jg, jge) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(emb))
    e = torch.from_numpy(emb).requires_grad_(True)
    tl, tg = make_grad_fn(lambda p, b: tT.lm_loss(tcfg, p, embeds=b[0], targets=b[1]))(
        tp, (e, torch.from_numpy(tgt))
    )
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    _assert_grads_close(tg, jg, tcfg)
    te = torch.autograd.grad(tT.lm_loss(tcfg, tp, embeds=e, targets=torch.from_numpy(tgt)), e)[0]
    np.testing.assert_allclose(te.numpy(), np.asarray(jge), rtol=0, atol=GRAD_REL * float(np.abs(jge).max()))


# ---------------------------------------------------------------- pretrain


@pytest.mark.parametrize("arch", ARCHS)
def test_pretrain_matches_jax_run_pretrain(arch):
    """The launcher's ``--mode pretrain`` (the arch's optimizer: Adam, or
    Adafactor for the MoE archs; clip 1.0) against JAX's ``run_pretrain``
    construction for 3 steps on the same batches, from JAX's params.  The
    optimizer steps JAX's layer-stacked layout: Adafactor factors and clips
    whole stacked leaves.  The losses to ``TOL``.  The params within ``3 *
    lr * 2e-2`` plus ``1e-5`` relative, but for at most one entry in 10,000
    of a leaf, which stays within ``2 * 3 * lr``: Adam divides each gradient
    entry by its own running size (plus eps 1e-8), so an entry whose
    gradient is near eps, where fp32 rounding is a sizeable part of it,
    steps by another fraction of lr (up to a step of the other sign)."""
    steps, batch, seq, lr = 3, 2, 12, 1e-3
    jcfg, tcfg, jp, tp = _models(arch, seed=0)
    spec = jget_arch(arch)
    assert spec.optimizer == get_arch(arch).optimizer
    assert spec.optimizer == ("adafactor" if "moe" in jcfg.block_pattern[-1] else "adam")
    jopt = getattr(joptim, spec.optimizer)(lr)
    docs, _ = j_make_token_dataset(n_docs=4096, doc_len=seq, vocab=min(jcfg.vocab_size, 512), seed=0)
    jstep = jax.jit(jrounds.build_fedsgd_step(lambda p, b: jT.lm_loss(jcfg, p, b["tokens"]), jopt, grad_clip=1.0))
    rng = np.random.default_rng(0)
    js, jlosses = jopt.init(jp), []
    for _ in range(steps):
        idx = rng.integers(0, len(docs), size=batch)
        jp, js, loss = jstep(jp, js, {"tokens": jnp.asarray(docs[idx])})
        jlosses.append(float(loss))

    args = argparse.Namespace(
        arch=arch, mode="pretrain", steps=steps, local_batch=batch, seq=seq, lr=lr, seed=0, log_every=1,
        device="cpu", full_width=False, layers=None, flash=False, shard_clients=0, cohort_cap=None,
        scenario=None, staleness_bound=None, staleness_decay="polynomial", staleness_alpha=0.5,
        candidate_frac=None, faults=None, aggregator="mean", local_algo="fedavg", prox_mu=None,
        feddyn_alpha=None, ckpt_every=None, ckpt=None, telemetry=None, profile_dir=None,
    )
    params, _, hist = ttrain.run_pretrain(args, model=(tcfg, tp))
    np.testing.assert_allclose([h["loss"] for h in hist], jlosses, **TOL)
    want = tT.params_from_jax(_np(jp), tcfg, device="cpu")
    for a, b in zip(tree_leaves(params), tree_leaves(want)):
        d = (a - b).abs()
        loose = d > 1e-5 * b.abs() + steps * lr * 2e-2
        assert float(d.max()) <= 2 * steps * lr and int(loose.sum()) <= max(1, d.numel() // 10_000)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama4-maverick-400b-a17b"])
def test_adafactor_steps_the_layer_stacked_layout_as_jax(arch):
    """Two Adafactor updates of the launcher's pretrain optimizer, fed
    JAX's gradient, against JAX's on its layer-stacked params: equal to
    fp32 rounding (the second update reads the moments the first left).
    The same optimizer on the port's per-layer leaves is another function
    (a layer's norm scale is a vector there, factored with its neighbours
    in JAX's (layers, D) leaf), which the first update shows.
    ``layer_groups`` names every leaf once, and its groups have the shapes
    of JAX's stacked leaves."""
    jcfg, tcfg, jp, tp = _models(arch)
    leaves, groups = tree_leaves(tp), tT.layer_groups(tcfg, tp)
    assert sorted(i for g in groups for i in ([g] if isinstance(g, int) else g)) == list(range(len(leaves)))
    shapes = [tuple(leaves[g].shape) if isinstance(g, int) else (len(g),) + tuple(leaves[g[0]].shape)
              for g in groups]
    assert sorted(shapes) == sorted(tuple(x.shape) for x in jax.tree_util.tree_leaves(jp))
    toks = _tokens(jcfg, 2, 12, 20)
    jg = jax.jit(jax.grad(lambda p: jT.lm_loss(jcfg, p, jnp.asarray(toks))))(jp)
    tg = tT.params_from_jax(_np(jg), tcfg, device="cpu")
    jopt = joptim.adafactor(1e-3)
    jupdate = jax.jit(jopt.update)
    topt = ttrain.pretrain_optimizer(tcfg, "adafactor", 1e-3)
    per_layer = toptim.adafactor(1e-3)
    js, ts, ps = jopt.init(jp), topt.init(tp), per_layer.init(tp)
    for step in range(2):
        ju, js = jupdate(jg, js, jp)
        tu, ts = topt.update(tg, ts, tp)
        pu, ps = per_layer.update(tg, ps, tp)
        want = tT.params_from_jax(_np(ju), tcfg, device="cpu")
        for a, b in zip(tree_leaves(tu), tree_leaves(want)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-9)
        if step == 0:
            gap = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(pu), tree_leaves(want)))
            assert gap > 1e-4  # a tenth of lr


# ------------------------------------------------------------------- remat


REMAT_CASES = ARCHS + ["smollm-360m", "recurrentgemma-9b:4"]


@pytest.mark.parametrize("case", REMAT_CASES)
def test_remat_gives_the_same_loss_and_gradients_bit_for_bit(case, monkeypatch):
    """``cfg.remat`` checkpoints each repeat unit of the block pattern (the
    remainder layers of ``recurrentgemma-9b:4``, one unit and one layer,
    stay outside) and recomputes it in the backward pass: the loss, the MoE
    aux loss and every gradient are the bits of the pass without remat, for
    the dense, RWKV, RG-LRU and MoE families.  Passes without gradients
    never checkpoint."""
    from torch.utils import checkpoint as ckpt

    arch, _, layers = case.partition(":")
    cfg = get_arch(arch).model.reduced(**REDUCED)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=int(layers))
    params = tT.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 12, 4))
    calls = []
    real = ckpt.checkpoint
    monkeypatch.setattr(ckpt, "checkpoint", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = make_grad_fn(lambda p, b: tT.lm_loss(c, p, b))(params, toks)
    assert len(calls) == cfg.num_layers // len(cfg.block_pattern)
    (l0, g0), (l1, g1) = out[False], out[True]
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)
    with torch.no_grad():
        tT.lm_loss(dataclasses.replace(cfg, remat=True), params, toks)
    assert len(calls) == cfg.num_layers // len(cfg.block_pattern)


# ------------------------------------------------------- the launcher


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("mode", ["fl", "pretrain"])
def test_launcher_trains_every_arch_on_the_cpu(mode, arch, capsys):
    """Both modes run for every arch of the registry at its reduced fp32
    config, with JAX's configs and optimizers: one FL round of 4 clients
    (the refresh through K6's and K7's plain versions), two pretrain
    steps."""
    assert get_arch(arch).optimizer == jget_arch(arch).optimizer
    assert get_arch(arch).fl.lr == jget_arch(arch).fl.lr
    common = ["--arch", arch, "--seq", "10", "--local-batch", "2", "--log-every", "1", "--device", "cpu"]
    if mode == "fl":
        state, outs = ttrain.main(common + ["--mode", "fl", "--rounds", "1", "--clients", "4", "--per-round", "2",
                                            "--docs-per-client", "3", "--local-steps", "1", "--flash"])
        assert capsys.readouterr().out.count("[fl:fl-dp3s] round") == 2
        assert bool(torch.isfinite(outs["loss"]).all()) and state.round == 1
        params = state.params
    else:
        params, _, hist = ttrain.main(common + ["--mode", "pretrain", "--steps", "2"])
        assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(params))


# ------------------------------------------------- the rwkv6-7b repair


@pytest.mark.parametrize("mode", ["fl", "pretrain"])
def test_launcher_trains_rwkv6_on_the_cpu(mode, capsys):
    """rwkv6-7b's training crashed in both modes: its time mix initialises
    ``mu_x`` and never reads it, and the gradient raised "One of the
    differentiated Tensors appears to not have been used in the graph".
    Both modes run now, and ``mu_x`` keeps its initial value: its gradient
    is zero, as ``jax.grad`` gives it, under SGD (fl) and Adam (pretrain)."""
    cfg, init = ttrain.build_model("rwkv6-7b", 0, device="cpu")
    argv = ["--arch", "rwkv6-7b", "--seq", "12", "--local-batch", "2", "--log-every", "1", "--device", "cpu"]
    if mode == "fl":
        state, _ = ttrain.main(argv + ["--mode", "fl", "--rounds", "2", "--clients", "4", "--per-round", "2",
                                       "--docs-per-client", "3", "--local-steps", "1"])
        params = state.params
        assert capsys.readouterr().out.count("[fl:fl-dp3s] round") == 4
    else:
        params, _, hist = ttrain.main(argv + ["--mode", "pretrain", "--steps", "2"])
        assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    for i, b in enumerate(params["blocks"]):
        assert torch.equal(b["mixer"]["mu_x"], init["blocks"][i]["mixer"]["mu_x"])
        assert not torch.equal(b["mixer"]["mu_k"], init["blocks"][i]["mixer"]["mu_k"])
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(params))


def test_unread_leaves_get_zero_gradients_as_in_jax():
    """``make_grad_fn`` gives a leaf the loss does not read a zero gradient
    of its shape and dtype: rwkv6-7b's ``mu_x`` leaves against
    ``jax.grad``'s zeros, and a bf16 leaf of a toy loss."""
    jcfg, tcfg, jp, tp = _models("rwkv6-7b")
    toks = _tokens(jcfg, 2, 12, 8)
    jg = jax.jit(jax.grad(lambda p: jT.lm_loss(jcfg, p, jnp.asarray(toks))))(jp)
    _, tg = make_grad_fn(lambda p, b: tT.lm_loss(tcfg, p, b))(tp, torch.from_numpy(toks))
    for j, block in enumerate(tg["blocks"]):
        g = block["mixer"]["mu_x"]
        assert g.shape == (tcfg.d_model,) and g.dtype == torch.float32 and not bool(g.any())
        assert not np.asarray(jg["unit"][0]["mixer"]["mu_x"][j]).any()
    toy = {"used": torch.ones(3), "unused": torch.ones(2, 2, dtype=torch.bfloat16)}
    loss, g = make_grad_fn(lambda p, b: (p["used"] * b).sum())(toy, torch.arange(3.0))
    assert float(loss) == 3.0 and torch.equal(g["used"], torch.arange(3.0))
    assert g["unused"].dtype == torch.bfloat16 and g["unused"].shape == (2, 2) and not bool(g["unused"].any())
