"""The LM client path of the six archs the port first only served
(rwkv6-7b, qwen2-vl-2b, musicgen-medium, recurrentgemma-9b, mixtral-8x7b,
llama4-maverick) against the JAX package on the CPU: the port's
``launch/train.run_fl`` on JAX's reduced fp32 params, with JAX's cohorts and
batch index plans handed to it, against JAX's ``run_scanned`` on the LM FL
configuration of ``repro.launch.train.run_fl``, round by round, with and
without ``--flash`` (the refresh through K6's and K7's plain versions).

Two archs need bounds of their own, each derived here from what sets it:
musicgen-medium's eq.-14 kernel (its clients' profiles nearly coincide,
so the min-max normalisation amplifies their rounding) and rwkv6-7b's
params and refreshed losses after round 2 (a local step whose gradient is
ill-conditioned in fp32, where reordering sums in one package moves the
run as far)."""

import argparse
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.fl import engine as jengine  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import transformer as jT  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.core import similarity  # noqa: E402
from repro_torch.fl import engine as tengine  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tflash  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as twkv  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCHS = ["rwkv6-7b", "qwen2-vl-2b", "musicgen-medium", "recurrentgemma-9b", "mixtral-8x7b",
         "llama4-maverick-400b-a17b"]
C, K, DOCS, SEQ, STEPS, BATCH, ROUNDS = 6, 3, 4, 12, 2, 2, 3
REDUCED = dict(param_dtype="float32", dtype="float32", remat=False)



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


def _args(arch, flash):
    return argparse.Namespace(
        arch=arch, mode="fl", selection="fl-dp3s", rounds=ROUNDS, steps=3, clients=C,
        per_round=K, docs_per_client=DOCS, local_steps=STEPS, local_batch=BATCH, seq=SEQ,
        lr=1e-3, seed=0, log_every=1, device="cpu", full_width=False, layers=None, flash=flash,
        shard_clients=0, cohort_cap=None, scenario=None, staleness_bound=None,
        staleness_decay="polynomial", staleness_alpha=0.5, candidate_frac=None, faults=None,
        aggregator="mean", local_algo="fedavg", prox_mu=None, feddyn_alpha=None,
        ckpt_every=None, ckpt=None, telemetry=None, profile_dir=None,
    )


@functools.lru_cache(maxsize=None)
def _jax_lm_fl(arch):
    """JAX's ``run_fl`` construction (the arch's reduced fp32 config, seed
    0) through its scanned engine -> (initial params, profiles, kernel,
    outputs, final params, final losses, per-round batch index plans), all
    numpy."""
    cfg = jget_arch(arch).model.reduced(**REDUCED)
    params = jT.init_params(jax.random.key(0), cfg)
    clients = jtrain._token_clients(cfg, C, DOCS, SEQ)
    topics = np.stack([np.full((DOCS,), ci % C, np.int32) for ci in range(C)])
    feat_fn = jax.jit(lambda p, xs: jT.features(cfg, p, xs)[1].mean(0))
    profiles = jnp.stack([feat_fn(params, jnp.asarray(clients[ci][: min(8, DOCS)])) for ci in range(C)])
    strategy = jsel.DPPSelection()
    loss_fn = lambda p, x, y: jT.lm_loss(cfg, p, x)
    flcfg = jengine.FLConfig(
        num_clients=C, clients_per_round=K, local_batch_size=BATCH, local_steps=STEPS,
        sample_with_replacement=True, lr=jget_arch(arch).fl.lr, rounds=ROUNDS,
        eval_every=1, num_classes=C, seed=0,
    )
    state = jengine.init_server_state(
        flcfg, params, loss_fn, None, clients, topics, strategy=strategy, profiles=profiles,
        losses=jnp.ones((C,)),
    )
    final, outs = jengine.run_scanned(jengine.make_round_fn(flcfg, loss_fn, (strategy,)), state, ROUNDS)
    # the round's key schedule, replayed on the host: key -> (key, k_sel, k_batch)
    key, plans = jax.random.key(0), []
    for _ in range(ROUNDS):
        key, _, k_batch = jax.random.split(key, 3)
        plans.append(np.asarray(jengine.batch_indices_from_keys(flcfg, jax.random.split(k_batch, K), DOCS)))
    return (_np(params), np.asarray(profiles), np.asarray(state.kernel), _np(outs), _np(final.params),
            np.asarray(final.losses), plans)


class _Replay(tsel.DPPSelection):
    """The port's strategy handing out JAX's cohorts in order: the two
    packages draw from different generators."""

    def __init__(self, cohorts):
        super().__init__()
        self.cohorts = [np.array(c) for c in cohorts]

    def draw_fn(self, generator, state, k):
        return torch.as_tensor(self.cohorts.pop(0), device=state.kernel.device)


def _run_port(monkeypatch, arch, flash=False, cfg=None, cast=None):
    """The port's ``run_fl`` on JAX's initial params with JAX's cohorts and
    batch plans: ``cfg`` (default the reduced fp32 config) and ``cast``
    applied to every leaf -> (final state, outputs)."""
    jparams, _, _, jouts, _, _, plans = _jax_lm_fl(arch)
    tcfg = get_arch(arch).model.reduced(**REDUCED)
    params = tT.params_from_jax(jparams, tcfg, device="cpu")
    if cast is not None:
        params = tree_map(cast, params)
    monkeypatch.setattr(ttrain, "make_strategy", lambda name: _Replay(jouts["selected"]))
    queue = [torch.from_numpy(p.astype(np.int64)) for p in plans]

    def jax_plan(cfg_, generator, m, n_c):
        plan = queue.pop(0)
        assert plan.shape == (m, STEPS, BATCH) and n_c == DOCS
        return plan

    monkeypatch.setattr(tengine, "batch_indices_from_keys", jax_plan)
    state, outs = ttrain.run_fl(_args(arch, flash), model=(cfg or tcfg, params))
    assert not queue
    return state, outs


def _count(monkeypatch, module, name, calls):
    real = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **kw: calls.append(name) or real(*a, **kw))


def _params_gap(a, b):
    return max(float((x.double() - y.double()).abs().max()) for x, y in zip(tree_leaves(a), tree_leaves(b)))


# bounds for rwkv6-7b's params and refreshed losses, against JAX and
# against the exact (fp64) run: set from test_rwkv_fl_drift_is_rounding_growth,
# where reordering the dense sums of the port alone moves its params by
# 1.8e-4 and a refreshed loss by 1.1e-2, and JAX's own fp32 run is 2.4e-4
# and 3.7e-2 off the fp64 run, in the CPU's fp32 arithmetic
RWKV_PARAMS_ATOL, RWKV_LOSS_ATOL = 5e-4, 5e-2


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_fl_matches_jax_run_scanned(monkeypatch, arch, flash):
    """The port's ``run_fl`` against JAX's scanned engine, round by round.
    With ``--flash`` the refresh goes through K6's plain version in every
    window-free attention layer and K7's in every RWKV layer, and nothing
    else does; without it, neither runs."""
    _, jprof, jkern, jouts, jfinal, jlosses, _ = _jax_lm_fl(arch)
    tcfg = get_arch(arch).model.reduced(**REDUCED)
    calls = []
    _count(monkeypatch, tflash, "flash_attention", calls)
    _count(monkeypatch, twkv, "wkv6", calls)
    state, outs = _run_port(monkeypatch, arch, flash)
    mixers = [bt.split("+")[0] for bt in tcfg.layer_types()]
    refreshes = ROUNDS * K if flash else 0
    assert calls.count("flash_attention") == mixers.count("attn") * refreshes
    assert calls.count("wkv6") == mixers.count("rwkv") * refreshes

    # profiles: fp32 sums in another order
    np.testing.assert_allclose(state.profiles.numpy(), jprof, rtol=1e-5, atol=1e-5)
    # the kernel through K1 + K2's plain versions against JAX's op chain,
    # fp32 sums in another order; musicgen's bound is its conditioning's
    # (test_musicgen_kernel_gap_is_conditioning)
    kern_atol = 2.5e-3 if arch == "musicgen-medium" else 1e-4
    np.testing.assert_allclose(state.kernel.numpy(), jkern, rtol=1e-4, atol=kern_atol)
    np.testing.assert_array_equal(outs["selected"].numpy(), jouts["selected"])
    np.testing.assert_array_equal(outs["round"].numpy(), jouts["round"])
    np.testing.assert_allclose(outs["gemd"].numpy(), jouts["gemd"], atol=1e-6)  # same cohorts
    # mean local losses: rounds of SGD on fp32 gradients summed in another
    # order (rwkv6-7b: the round-2 step of RWKV_PARAMS_ATOL)
    np.testing.assert_allclose(outs["loss"].numpy(), jouts["loss"], rtol=1e-5 if arch != "rwkv6-7b" else 1e-4)
    assert (state.losses.numpy() != 1.0).sum() == len(np.unique(jouts["selected"]))
    want = tT.params_from_jax(jfinal, tcfg, device="cpu")
    if arch == "rwkv6-7b":
        np.testing.assert_allclose(state.losses.numpy(), jlosses, atol=RWKV_LOSS_ATOL)
        assert _params_gap(state.params, want) <= RWKV_PARAMS_ATOL
    else:
        np.testing.assert_allclose(state.losses.numpy(), jlosses, rtol=1e-5, atol=1e-5)
        for a, b in zip(tree_leaves(state.params), tree_leaves(want)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    assert state.round == ROUNDS


def test_musicgen_kernel_gap_is_conditioning(monkeypatch):
    """musicgen-medium's eq.-14 kernel parts from JAX's by ~1.2e-3 while the
    profiles agree to ~5e-7: at random init its clients' mean hidden states
    nearly coincide (sinusoidal positions of amplitude 1 swamp token
    embeddings of std 0.02), so their distances (~0.25-0.31) are small
    beside their norms (~15), where the fp32 chain's ‖a‖² + ‖b‖² − 2a·b
    cancels, and the min-max normalisation then divides by a range of
    ~0.06.  An fp64 chain gives the same kernel on both packages' profiles;
    each package's fp32 kernel parts from it on its own, the port's no
    further than JAX's.  The FL test's bound of 2.5e-3 is twice JAX's own
    distance from the fp64 chain."""
    _, jprof, jkern, *_ = _jax_lm_fl("musicgen-medium")
    state, _ = _run_port(monkeypatch, "musicgen-medium")
    tprof, tkern = state.profiles.double(), state.kernel.double()
    jprof, jkern = torch.tensor(jprof, dtype=torch.float64), torch.tensor(jkern, dtype=torch.float64)
    exact_t, exact_j = similarity.kernel_from_profiles(tprof), similarity.kernel_from_profiles(jprof)
    gap = lambda a, b: float((a - b).abs().max())
    # the same function: the fp64 chains on the two profile sets agree
    assert gap(tprof, jprof) <= 1e-5 and gap(exact_t, exact_j) <= 1e-4
    port_err, jax_err = gap(tkern, exact_t), gap(jkern, exact_j)
    assert port_err <= jax_err and 1e-4 < jax_err <= 1.25e-3
    assert gap(tkern, jkern) <= port_err + jax_err + gap(exact_t, exact_j)
    # the conditioning: distances and their range small beside the norms
    d = torch.cdist(tprof, tprof)
    off = d[~torch.eye(C, dtype=torch.bool)]
    norm = float(tprof.norm(dim=1).min())
    assert float(off.max()) <= 0.05 * norm and float(off.max() - off.min()) <= 0.01 * norm


def _split_dense(p, x):
    """``layers.dense`` with its fp32 sum over d_in split in two halves and
    added: the same product, its sums in another order."""
    w = p["w"]
    h = w.shape[0] // 2
    return x[..., :h] @ w[:h] + x[..., h:] @ w[h:]


def test_rwkv_fl_drift_is_rounding_growth(monkeypatch):
    """rwkv6-7b's params and refreshed losses part from JAX's in round 2
    (the gap after round 1 is 5e-7) and not further in round 3: rounding
    growth, not a fault.

    * A witness that reorders the dense layers' fp32 sums in the port alone
      moves its final params by as much as JAX's run does (within 2x), and
      its refreshed losses by ~1e-2.
    * The port in fp64 (the exact run of the same function) stays within
      the witness's spread of the port in fp32, and JAX's fp32 run is no
      closer to it than the port's is.
    * At JAX's final params, JAX's fp32 gradient is within 1e-3 (relative,
      over all leaves) of the port's fp64 gradient, and within 2e-5 at init:
      the port's gradient is JAX's function, and the step that spreads the
      runs has an ill-conditioned gradient."""
    jparams, _, _, _, jfinal, jlosses, _ = _jax_lm_fl("rwkv6-7b")
    tcfg = get_arch("rwkv6-7b").model.reduced(**REDUCED)
    port, _ = _run_port(monkeypatch, "rwkv6-7b")
    with monkeypatch.context() as m:
        m.setattr(tL, "dense", _split_dense)
        witness, _ = _run_port(m, "rwkv6-7b")
    cfg64 = dataclasses.replace(tcfg, dtype="float64", param_dtype="float64")
    exact, _ = _run_port(monkeypatch, "rwkv6-7b", cfg=cfg64, cast=lambda x: x.double())
    want = tT.params_from_jax(jfinal, tcfg, device="cpu")

    gap_jax = _params_gap(port.params, want)
    gap_witness = _params_gap(port.params, witness.params)
    loss_witness = float((port.losses - witness.losses).abs().max())
    assert gap_jax <= 2 * gap_witness <= 2 * RWKV_PARAMS_ATOL
    assert 1e-3 <= loss_witness <= RWKV_LOSS_ATOL
    # against the exact run
    port_exact = _params_gap(port.params, exact.params)
    jax_exact = _params_gap(want, exact.params)
    port_exact_loss = float((port.losses.double() - exact.losses).abs().max())
    jax_exact_loss = float((torch.tensor(jlosses, dtype=torch.float64) - exact.losses).abs().max())
    assert port_exact <= gap_witness and port_exact_loss <= loss_witness
    assert port_exact <= jax_exact <= RWKV_PARAMS_ATOL and port_exact_loss <= jax_exact_loss <= RWKV_LOSS_ATOL

    # gradients of client 5's shard (refreshed in rounds 1 and 2)
    jcfg = jget_arch("rwkv6-7b").model.reduced(**REDUCED)
    x = jtrain._token_clients(jcfg, C, DOCS, SEQ)[5]
    jgrad = jax.jit(jax.grad(lambda p: jT.lm_loss(jcfg, p, jnp.asarray(x))))

    def rel_to_fp64(np_params):
        p32 = tT.params_from_jax(np_params, tcfg, device="cpu")
        p64 = tree_map(lambda t: t.double().requires_grad_(True), p32)
        leaves = tree_leaves(p64)
        loss = tT.lm_loss(cfg64, p64, torch.from_numpy(x))
        g64 = torch.autograd.grad(loss, leaves, allow_unused=True)
        jg = jgrad(jax.tree_util.tree_map(jnp.asarray, np_params))
        g32 = tree_leaves(tT.params_from_jax(_np(jg), tcfg, device="cpu"))
        num = sum(float(((a.double() - (b if b is not None else 0)) ** 2).sum()) for a, b in zip(g32, g64))
        den = sum(float((b**2).sum()) for b in g64 if b is not None)
        return (num / den) ** 0.5

    assert rel_to_fp64(jparams) <= 2e-5
    assert rel_to_fp64(jfinal) <= 1e-3
