"""The port's LM client path against the JAX package on the CPU: the
optimizers, the Mode-B step, the token corpus, and the slice as a whole —
``repro_torch.launch.train.run_fl`` (``init_server_state`` →
``make_round_fn`` → ``run_scanned``) against JAX's ``run_scanned`` on the
LM FL configuration of ``repro.launch.train.run_fl``, with JAX's cohorts
and batch index plans handed to the port.  Then the port's launcher in both
modes, and the flags that must raise."""

import argparse
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.data import make_token_dataset as j_make_token_dataset  # noqa: E402
from repro.fl import engine as jengine  # noqa: E402
from repro.fl import rounds as jrounds  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import transformer as jT  # noqa: E402

from repro_torch import optim as toptim  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.data import make_token_dataset  # noqa: E402
from repro_torch.fl import engine as tengine  # noqa: E402
from repro_torch.fl import rounds as trounds  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tflash  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


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


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


# -------------------------------------------------------------- configs


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-3-2b", "internlm2-20b", "gemma-7b"])
def test_fl_run_config_and_optimizer_are_the_jax_ones(arch):
    j, t = jget_arch(arch), get_arch(arch)
    assert t.optimizer == j.optimizer == "adam"
    assert t.fl.lr == j.fl.lr


# ------------------------------------------------------------ optimizers


def _opt_tree(seed):
    """A tree with 1-, 2- and 3-D leaves; keys in sorted order, the order
    JAX walks a dict in."""
    rng = np.random.default_rng(seed)
    return {
        "blocks": [
            {"b": rng.normal(size=(7,)).astype(np.float32)},
            {"t": rng.normal(size=(2, 3, 4)).astype(np.float32)},
        ],
        "w": rng.normal(size=(5, 7)).astype(np.float32),
    }


@pytest.mark.parametrize(
    "name,kw",
    [
        ("sgd", dict(lr=0.1, momentum=0.9)),
        ("sgd", dict(lr=0.1, momentum=0.9, nesterov=True)),
        ("adam", dict(lr=1e-2)),
        ("adamw", dict(lr=1e-2, weight_decay=0.1)),
        ("adafactor", dict(lr=1e-2)),
    ],
)
def test_optimizers_match_jax_over_steps(name, kw):
    """Four steps on gradients drawn with numpy; params, updates and state
    leaves agree to fp32 rounding (pow, sqrt and means in another order)."""
    jopt, topt = getattr(joptim, name)(**kw), getattr(toptim, name)(**kw)
    jp, tp = _opt_tree(0), _t(_opt_tree(0))
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for step in range(4):
        g = _opt_tree(10 + step)
        jup, jstate = jopt.update(g, jstate, jp)
        tup, tstate = topt.update(_t(g), tstate, tp)
        jp, tp = joptim.apply_updates(jp, jup), toptim.apply_updates(tp, tup)
        for a, b in zip(tree_leaves(tup), jax.tree_util.tree_leaves(jup)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
    for a, b in zip(tree_leaves(tstate), jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-7)


def test_clip_by_global_norm_matches_jax_and_widens_bf16():
    g = _opt_tree(3)
    want = joptim.clip_by_global_norm(g, 0.5)
    got = toptim.clip_by_global_norm(_t(g), 0.5)
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    low = toptim.clip_by_global_norm({"w": torch.ones(3, dtype=torch.bfloat16)}, 1.0)
    assert low["w"].dtype == torch.float32  # as JAX promotes bf16 * fp32


@pytest.mark.parametrize("micro_batches", [1, 2])
def test_fedsgd_step_matches_jax(micro_batches):
    """Two steps of ``build_fedsgd_step`` (clip 1.0) on the reduced smollm
    LM: the loss of each step and the parameters after both.  Plain SGD
    here, so a parameter parts by lr times its gradient's fp32 rounding;
    Adam divides every gradient by its own size and so turns the rounding
    of a near-zero gradient into a step of up to lr, which the optimizer
    test above avoids by feeding both packages the same gradients."""
    kw = dict(param_dtype="float32", dtype="float32", remat=False)
    jcfg = jget_arch("smollm-360m").model.reduced(**kw)
    tcfg = get_arch("smollm-360m").model.reduced(**kw)
    jp = jT.init_params(jax.random.key(41), jcfg)
    tp = tT.params_from_jax(_np(jp), tcfg, device="cpu")
    jopt, topt = joptim.sgd(0.1), toptim.sgd(0.1)
    jstep = jax.jit(jrounds.build_fedsgd_step(
        lambda p, b: jT.lm_loss(jcfg, p, b["tokens"]), jopt, grad_clip=1.0, micro_batches=micro_batches))
    tstep = trounds.build_fedsgd_step(
        lambda p, b: tT.lm_loss(tcfg, p, b["tokens"]), topt, grad_clip=1.0, micro_batches=micro_batches)
    js, ts = jopt.init(jp), topt.init(tp)
    rng = np.random.default_rng(42)
    for _ in range(2):
        toks = rng.integers(0, jcfg.vocab_size, size=(4, 9)).astype(np.int32)
        jp, js, jl = jstep(jp, js, {"tokens": jnp.asarray(toks)})
        tp, ts, tl = tstep(tp, ts, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    want = tT.params_from_jax(_np(jp), tcfg, device="cpu")
    for a, b in zip(tree_leaves(tp), tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("seed,n,length,topics", [(0, 300, 17, 10), (5, 64, 40, 6)])
def test_token_dataset_copy_is_byte_identical(seed, n, length, topics):
    a_docs, a_top = make_token_dataset(n_docs=n, doc_len=length, vocab=512, num_topics=topics, seed=seed)
    b_docs, b_top = j_make_token_dataset(n_docs=n, doc_len=length, vocab=512, num_topics=topics, seed=seed)
    assert a_docs.dtype == b_docs.dtype and a_docs.tobytes() == b_docs.tobytes()
    assert a_top.dtype == b_top.dtype and a_top.tobytes() == b_top.tobytes()


@pytest.mark.parametrize("clients,docs,seq", [(10, 16, 32), (6, 4, 9)])
def test_token_clients_are_byte_identical(clients, docs, seq):
    jcfg = jget_arch("smollm-360m").model
    a = ttrain._token_clients(get_arch("smollm-360m").model, clients, docs, seq)
    b = jtrain._token_clients(jcfg, clients, docs, seq)
    assert a.shape == (clients, docs, seq) and a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ------------------------------------------------------- the whole slice


C, K, DOCS, SEQ, STEPS, BATCH, ROUNDS = 6, 3, 4, 12, 2, 2, 3


def _args(**kw):
    base = dict(
        arch="smollm-360m", mode="fl", selection="fl-dp3s", rounds=ROUNDS, steps=3, clients=C,
        per_round=K, docs_per_client=DOCS, local_steps=STEPS, local_batch=BATCH, seq=SEQ,
        lr=1e-3, seed=0, log_every=1, device="cpu", full_width=False, layers=None, flash=False,
        shard_clients=0, cohort_cap=None, scenario=None, staleness_bound=None,
        staleness_decay="polynomial", staleness_alpha=0.5, candidate_frac=None, faults=None,
        aggregator="mean", local_algo="fedavg", prox_mu=None, feddyn_alpha=None,
        ckpt_every=None, ckpt=None, telemetry=None, profile_dir=None,
    )
    base.update(kw)
    return argparse.Namespace(**base)


def _jax_lm_fl():
    """JAX's ``run_fl`` construction (reduced smollm, seed 0), run through
    its scanned engine -> (params, profiles, kernel, outputs, final state,
    per-round batch index plans)."""
    cfg = jget_arch("smollm-360m").model.reduced(param_dtype="float32", dtype="float32", remat=False)
    params = jT.init_params(jax.random.key(0), cfg)
    clients = jtrain._token_clients(cfg, C, DOCS, SEQ)
    topics = np.stack([np.full((DOCS,), ci % C, np.int32) for ci in range(C)])
    feat_fn = jax.jit(lambda p, xs: jT.features(cfg, p, xs)[1].mean(0))
    profiles = jnp.stack([feat_fn(params, jnp.asarray(clients[ci][: min(8, DOCS)])) for ci in range(C)])
    strategy = jsel.DPPSelection()
    loss_fn = lambda p, x, y: jT.lm_loss(cfg, p, x)
    flcfg = jengine.FLConfig(
        num_clients=C, clients_per_round=K, local_batch_size=BATCH, local_steps=STEPS,
        sample_with_replacement=True, lr=jget_arch("smollm-360m").fl.lr, rounds=ROUNDS,
        eval_every=1, num_classes=C, seed=0,
    )
    state = jengine.init_server_state(
        flcfg, params, loss_fn, None, clients, topics, strategy=strategy, profiles=profiles,
        losses=jnp.ones((C,)),
    )
    kernel = np.asarray(state.kernel)
    final, outs = jengine.run_scanned(jengine.make_round_fn(flcfg, loss_fn, (strategy,)), state, ROUNDS)
    # the round's key schedule, replayed on the host: key -> (key, k_sel, k_batch)
    key, plans = jax.random.key(0), []
    for _ in range(ROUNDS):
        key, _, k_batch = jax.random.split(key, 3)
        keys = jax.random.split(k_batch, K)
        plans.append(np.asarray(jengine.batch_indices_from_keys(flcfg, keys, DOCS)))
    return params, np.asarray(profiles), kernel, _np(outs), final, plans


class _Replay(tsel.DPPSelection):
    """The port's strategy handing out JAX's cohorts in order: the two
    packages draw from different generators."""

    def __init__(self, cohorts):
        super().__init__()
        self.cohorts = [np.array(c) for c in cohorts]

    def draw_fn(self, generator, state, k):
        return torch.as_tensor(self.cohorts.pop(0), device=state.kernel.device)


@pytest.mark.parametrize("flash", [False, True])
def test_lm_fl_slice_matches_jax_run_scanned(monkeypatch, flash):
    """The port's ``run_fl`` (the refresh through K6's plain version with
    ``--flash``) against JAX's scanned engine, round by round."""
    jparams, jprof, jkern, jouts, jfinal, plans = _jax_lm_fl()
    tcfg = get_arch("smollm-360m").model.reduced(param_dtype="float32", dtype="float32", remat=False)
    monkeypatch.setattr(ttrain, "make_strategy", lambda name: _Replay(jouts["selected"]))
    queue = [torch.from_numpy(p.astype(np.int64)) for p in plans]

    def jax_plan(cfg, generator, m, n_c):
        plan = queue.pop(0)
        assert plan.shape == (m, STEPS, BATCH) and n_c == DOCS
        return plan

    monkeypatch.setattr(tengine, "batch_indices_from_keys", jax_plan)
    calls = []
    k6 = tflash.flash_attention
    monkeypatch.setattr(tflash, "flash_attention", lambda *a, **kw: calls.append(1) or k6(*a, **kw))
    state, outs = ttrain.run_fl(_args(flash=flash), model=(tcfg, tT.params_from_jax(_np(jparams), tcfg, device="cpu")))
    assert not queue
    # K6 takes every layer of each refresh forward (one per cohort client
    # and round) and nothing else
    assert len(calls) == (tcfg.num_layers * ROUNDS * K if flash else 0)

    # profiles and kernel: fp32 sums in another order; the kernel through
    # K1 + K2's plain versions against JAX's op chain: K1 sums (a - b)^2
    # where the chain expands it, ~1e-5 apart
    np.testing.assert_allclose(state.profiles.numpy(), jprof, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state.kernel.numpy(), jkern, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(outs["selected"].numpy(), jouts["selected"])
    np.testing.assert_array_equal(outs["round"].numpy(), jouts["round"])
    assert np.isnan(outs["acc"].numpy()).all() and np.isnan(jouts["acc"]).all()
    np.testing.assert_allclose(outs["gemd"].numpy(), jouts["gemd"], atol=1e-6)  # same cohorts
    # mean local losses and refreshed losses: three rounds of SGD on fp32
    # gradients summed in another order, through two layers
    np.testing.assert_allclose(outs["loss"].numpy(), jouts["loss"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state.losses.numpy(), np.asarray(jfinal.losses), rtol=1e-5, atol=1e-5)
    assert (state.losses.numpy() != 1.0).sum() == len(np.unique(jouts["selected"]))
    want = tT.params_from_jax(_np(jfinal.params), tcfg, device="cpu")
    for a, b in zip(tree_leaves(state.params), tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    assert state.round == ROUNDS and set(outs) >= {"t_select", "t_local", "t_refresh"}
    hist = tengine.history_from_outputs(outs, 2, final_acc=0.5)
    jhist = jengine.history_from_outputs(jouts, 2, final_acc=0.5)
    assert hist["round"] == jhist["round"] == [2, 3]
    for name in ("acc", "gemd", "loss"):
        np.testing.assert_allclose(hist[name], jhist[name], rtol=1e-5, atol=1e-6)
    assert np.isnan(hist["acc"][0]) and hist["acc"][1] == 0.5


# ------------------------------------------------------------- launcher


def test_launcher_runs_both_modes_on_the_cpu(capsys):
    ttrain.main(["--mode", "fl", "--rounds", "2", "--clients", "4", "--per-round", "2",
                 "--docs-per-client", "3", "--local-steps", "1", "--local-batch", "2",
                 "--seq", "10", "--log-every", "1", "--flash", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("[fl:fl-dp3s] round") == 4 and "seconds: selection" in out
    params, _, hist = ttrain.main(["--mode", "pretrain", "--steps", "3", "--local-batch", "2",
                                   "--seq", "10", "--log-every", "1", "--device", "cpu"])
    assert [h["step"] for h in hist] == [1, 2, 3] and all(np.isfinite(h["loss"]) for h in hist)
    assert capsys.readouterr().out.count("[pretrain] step") == 3


_SMALL_FL = ["--mode", "fl", "--rounds", "2", "--clients", "4", "--per-round", "2",
             "--docs-per-client", "3", "--local-steps", "1", "--local-batch", "2",
             "--seq", "10", "--log-every", "1", "--device", "cpu"]


@pytest.mark.parametrize("selection", ["fedsae", "power-of-choice", "cluster"])
def test_launcher_runs_the_loss_baselines_and_refuses_cluster(capsys, selection):
    """The engine's rounds draw with the loss-driven baselines and with the
    Cluster baseline, which was refused until the engine fitted its labels
    (on the LM clients' representative gradients): one client per
    cluster."""
    state, outs = ttrain.main(_SMALL_FL + ["--selection", selection])
    assert capsys.readouterr().out.count(f"[fl:{selection}] round") == 4
    if selection == "cluster":
        labels = state.cluster_labels
        assert sorted(set(labels.tolist())) == [0, 1]
        for sel in outs["selected"]:
            assert labels[sel.long()].tolist() == [0, 1]


@pytest.mark.parametrize("selection", ["fl-dp3s", "fedavg", "cluster"])
def test_launcher_runs_the_funnel_under_the_flaky_scenario(capsys, selection):
    """``--scenario flaky --candidate-frac 0.5``: the funnel keeps Q = 5 of
    10 clients, every cohort lies in the candidates and in its round's
    availability mask (at least k clients are available in every round
    here), and the simulated wall clock is the sum of the cohorts' slowest
    latencies."""
    argv = [a if a != "4" else "10" for a in _SMALL_FL]  # 10 clients
    state, outs = ttrain.main(argv + ["--selection", selection, "--scenario", "flaky",
                                      "--candidate-frac", "0.5"])
    out = capsys.readouterr().out
    assert f"[fl:{selection}] funnel: C=10 -> Q=5 candidates (kernel (5, 5))" in out
    assert "scenario=flaky (synchronous barrier): simulated wall clock" in out
    cand = state.candidates.tolist()
    assert len(cand) == 5 and cand == sorted(cand)
    assert tuple(state.kernel.shape) == (5, 5) and tuple(state.cluster_labels.shape) == (5,)
    for sel, avail in zip(outs["selected"].tolist(), outs["avail"]):
        assert set(sel) <= set(cand) and len(set(sel)) == 2
        if int(avail[state.candidates.long()].sum()) >= 2:
            assert bool(avail[sel].all())
    assert outs["sim_time"].shape == (2,) and bool((outs["sim_time"] > 0).all())


def test_launcher_writes_telemetry_and_a_trace_on_the_cpu(tmp_path, capsys):
    """``--telemetry`` and ``--profile-dir`` in ``--mode fl`` through
    ``run_checkpointed`` (a snapshot every round): the manifest (the FL
    config's hash, mode, arch and selection), one ``fl_round`` a round
    equal to the run's outputs, an ``fl_checkpoint`` after each save, the
    closing line, the report's rendering and a Chrome trace with each
    segment's span; every other output and the final state as the same
    run without the flags, bit for bit."""
    from repro_torch import obs as tobs
    from repro_torch.analysis import report as treport

    path = tmp_path / "t.jsonl"
    argv = _SMALL_FL + ["--faults", "chaos", "--aggregator", "trimmed_mean", "--ckpt-every", "1"]
    state, outs = ttrain.main(argv + ["--ckpt", str(tmp_path / "a"), "--telemetry", str(path),
                                      "--profile-dir", str(tmp_path / "prof")])
    out = capsys.readouterr().out
    assert f"telemetry -> {path} (5 events; render with `python -m repro_torch.analysis.report {path}`)" in out
    ref_state, ref = ttrain.main(argv + ["--ckpt", str(tmp_path / "b")])
    assert set(outs) == set(ref) | {"telemetry"}
    for name, v in ref.items():
        if not name.startswith("t_"):
            assert torch.equal(torch.nan_to_num(v, 7.0), torch.nan_to_num(outs[name], 7.0)), name
    for a, b in zip(tree_leaves(state.params), tree_leaves(ref_state.params)):
        assert torch.equal(a, b)
    assert torch.equal(state.losses, ref_state.losses) and torch.equal(state.quarantine, ref_state.quarantine)
    events = tobs.load_events(str(path))
    assert [e["event"] for e in events] == ["manifest"] + ["fl_round", "fl_checkpoint"] * 2
    man = events[0]
    assert (man["mode"], man["arch"], man["selection"], man["backend"]) == ("fl", "smollm-360m", "fl-dp3s", "cpu")
    assert man["config"]["telemetry"] is True and man["config_hash"] == tobs.config_hash(man["config"])
    rounds = [e for e in events if e["event"] == "fl_round"]
    for i, e in enumerate(rounds):
        assert e["round"] == i + 1 and e["selected"] == outs["selected"][i].tolist()
        assert e["loss"] == float(outs["loss"][i]) and e["gemd"] == float(outs["gemd"][i])
        assert e["cache_age"] == i and e["survivors"] == int(outs["survivors"][i])
    assert [e["round"] for e in events if e["event"] == "fl_checkpoint"] == [1, 2]
    assert "training: 2 rounds" in treport.summarize(events)
    (trace,) = (tmp_path / "prof").glob("*.pt.trace.json")
    spans = [e["name"] for e in json.loads(trace.read_text())["traceEvents"] if e.get("cat") == "user_annotation"]
    assert spans.count("fl.scan_chunk[1]") == 2


def test_launcher_scenario_and_funnel_flags_are_fl_only():
    for flag, value in (("--scenario", "flaky"), ("--candidate-frac", "0.5"), ("--telemetry", "t.jsonl"),
                        ("--profile-dir", "prof")):
        with pytest.raises(ValueError, match=f"{flag} select federation features"):
            ttrain.main(["--mode", "pretrain", flag, value, "--device", "cpu"])
    with pytest.raises(SystemExit):  # argparse: not one of SCENARIO_NAMES
        ttrain.main(["--mode", "fl", "--scenario", "diurnal", "--device", "cpu"])


def test_launcher_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("fl", "pretrain"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttrain.main(["--mode", mode, "--rounds", "1", "--steps", "1"])


@pytest.mark.parametrize(
    "flag,value",
    [
        ("--shard-clients", "2"), ("--cohort-cap", "2"),
        ("--staleness-bound", "1"), ("--staleness-decay", "exponential"),
        ("--staleness-alpha", "0.3"),
    ],
)
@pytest.mark.parametrize("mode", ["fl", "pretrain"])
def test_launcher_refuses_flags_not_ported(monkeypatch, mode, flag, value):
    """The client mesh's flags are ported: ``--mode pretrain`` refuses them
    as federation features; ``--mode fl`` gives JAX's errors for a cap or a
    bound without ``--shard-clients`` and otherwise runs with the flag (the
    run itself stubbed here: ``tests/test_torch_shard_engine.py`` runs it).
    The name dates from when the launcher refused these flags."""
    if mode == "pretrain":
        with pytest.raises(ValueError, match=f"{flag}.*use --mode fl"):
            ttrain.main(["--mode", mode, flag, value, "--device", "cpu"])
        return
    seen = []
    monkeypatch.setattr(ttrain, "_run_fl", lambda args, model, mesh: seen.append((args, mesh)) or (None, {}))
    argv = ["--mode", mode, flag, value, "--device", "cpu"]
    if flag in ("--cohort-cap", "--staleness-bound"):
        with pytest.raises(SystemExit, match=f"{flag} requires --shard-clients"):
            ttrain.main(argv)
        return
    ttrain.main(argv)
    if flag == "--shard-clients":
        # one call a rank, each in its own thread (in either order)
        assert sorted(m.rank for _, m in seen) == [0, 1] and all(m.backend == "gloo" for _, m in seen)
    else:
        (args, mesh), = seen
        assert mesh is None and str(getattr(args, flag[2:].replace("-", "_"))) == value


def test_layers_cuts_the_published_config():
    """``--layers N`` keeps the first N layers of the full-width config,
    its widths and dtypes as published."""
    cfg, params = ttrain.build_model("smollm-360m", 0, full_width=True, layers=2, device="cpu")
    full = get_arch("smollm-360m").model
    assert cfg.num_layers == 2 and len(params["blocks"]) == 2
    assert (cfg.d_model, cfg.param_dtype, cfg.remat) == (full.d_model, full.param_dtype, full.remat)
    assert params["embed"]["w"].dtype == torch.bfloat16


@pytest.mark.parametrize(
    "argv,match",
    [
        (["--arch", "rwkv6-7b", "--layers", "2"], "needs --full-width"),
        (["--arch", "llama4-maverick-400b-a17b", "--full-width", "--layers", "3"], "multiple of its block pattern"),
        (["--arch", "recurrentgemma-9b", "--full-width", "--layers", "4"], "multiple of its block pattern"),
        (["--arch", "mixtral-8x7b", "--full-width", "--layers", "33"], "at most its 32"),
    ],
)
@pytest.mark.parametrize("mode", ["fl", "pretrain"])
def test_layers_refuses_cuts_the_pattern_does_not_take(mode, argv, match):
    with pytest.raises(ValueError, match=match):
        ttrain.main(["--mode", mode, "--device", "cpu"] + argv)


def test_flash_in_pretrain_raises():
    with pytest.raises(NotImplementedError, match="forward-only"):
        ttrain.main(["--mode", "pretrain", "--flash", "--device", "cpu"])
