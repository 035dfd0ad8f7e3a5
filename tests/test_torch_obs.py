"""The port's observability (``repro_torch.obs``, ``repro_torch.analysis.report``)
on the CPU, case by case as the JAX package's ``tests/test_obs.py`` states
its contract, and against the JAX package where the two can be held to
each other: ``config_hash`` of the same configs, the serving event stream
of the same traffic, the report of the same events, and the files one
package writes read by the other.  (The Telemetry fields and ``fl_round``
events of the two whole-slice runs are held to JAX's beside those runs,
in ``test_torch_engine.py`` and ``test_torch_faults.py``, with the
helpers below.)

Tolerances: telemetry on and off are compared bit for bit (every output
but the host timings ``t_*``, every state tensor and generator state,
every serving token); integer fields and event keys exactly; the floats
of a drained event within ``EVENT_TOL`` (the whole-slice tests' bounds on
the same outputs)."""

import dataclasses
import functools
import glob
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import obs as jobs  # noqa: E402
from repro.analysis import report as jreport  # noqa: E402
from repro.fl import engine as jengine  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402

from repro_torch import obs as tobs  # noqa: E402
from repro_torch.analysis import report as treport  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.fl import engine as tengine  # noqa: E402
from repro_torch.fl.trainer import FLTrainer  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.obs import sink as tsink  # noqa: E402
from repro_torch.obs import tracing as ttracing  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402

from test_obs import FL_ROUND_REQUIRED  # noqa: E402
from test_torch_cuda import _bits_equal as _same  # noqa: E402
from test_torch_cuda import _state_tensors as _flat_state  # noqa: E402

FEAT, N_C, NCLS = 8, 6, 4


@pytest.fixture(autouse=True)
def one_thread():
    """Small models on the CPU: one intra-op thread keeps the port's side
    from contending for the cores with the other test workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def linear_loss(params, x, y):
    logp = torch.log_softmax(x @ params["w"] + params["b"], dim=-1)
    return -torch.mean(torch.take_along_dim(logp, y[..., None].long(), dim=-1))


def _federation(c, seed=0):
    """JAX's test federation (``tests/test_obs.py``), as tensors."""
    rng = np.random.default_rng(seed)
    xs = torch.from_numpy(rng.normal(size=(c, N_C, FEAT)).astype(np.float32))
    ys = torch.from_numpy(rng.integers(0, NCLS, size=(c, N_C)).astype(np.int32))
    params = {
        "w": torch.from_numpy((0.01 * rng.normal(size=(FEAT, NCLS))).astype(np.float32)),
        "b": torch.zeros((NCLS,), dtype=torch.float32),
    }
    return xs, ys, params


def _state(c=12, k=4, rounds=6, strategy=None, telemetry=False, **cfg_kw):
    xs, ys, params = _federation(c)
    cfg = tengine.FLConfig(num_clients=c, clients_per_round=k, local_epochs=2, lr=0.1, rounds=rounds,
                           eval_every=2, num_classes=NCLS, seed=0, telemetry=telemetry, **cfg_kw)
    strategy = strategy or tsel.UniformSelection()
    losses = torch.stack([linear_loss(params, x, y) for x, y in zip(xs, ys)])
    state = tengine.init_server_state(cfg, params, xs, ys, xs.mean(dim=1), losses, strategy, device="cpu")
    return cfg, strategy, state


def _run(c=12, k=4, rounds=6, strategy=None, telemetry=False, sink=None, **cfg_kw):
    cfg, strategy, state = _state(c, k, rounds, strategy, telemetry, **cfg_kw)
    fn = tengine.make_round_fn(cfg, linear_loss, (strategy,))
    return tengine.run_scanned(fn, state, rounds, sink=sink)


# ----------------------------------------------------- helpers against JAX

# tolerances of the whole slices' floats in a drained event, as the slice
# tests hold the same outputs: (atol, rtol); spectrum_* as the kernels
EVENT_TOL = {
    "loss": (1e-5, 0.0), "gemd": (1e-6, 0.0), "acc": (1e-6, 0.0),
    "spectrum_top": (1e-4, 1e-4), "spectrum_trace": (1e-4, 1e-4), "spectrum_erank": (1e-4, 1e-4),
}


def assert_events_match_jax(events, jevents):
    """Two event streams alike: the same kinds in the same order (the
    manifest apart), and each pair equal on the keys JAX's event has
    (``t`` and ``wall`` apart): integers, lists and the other floats
    exactly, the floats of ``EVENT_TOL`` within it."""
    events = [e for e in events if e["event"] != "manifest"]
    jevents = [e for e in jevents if e["event"] != "manifest"]
    assert [e["event"] for e in events] == [e["event"] for e in jevents]
    for e, je in zip(events, jevents):
        shared = set(je) - {"t", "wall"}
        assert shared <= set(e), sorted(shared - set(e))
        for key in shared:
            if key in EVENT_TOL and je[key] is not None:
                atol, rtol = EVENT_TOL[key]
                np.testing.assert_allclose(e[key], je[key], atol=atol, rtol=rtol, err_msg=key)
            else:
                assert e[key] == je[key], (e["event"], key, e[key], je[key])


def assert_telemetry_matches_jax(tel, jtels):
    """The port's Telemetry (joined over a run) against JAX's segments':
    the integer fields, ``funnel_survival`` and ``avail_frac`` exactly
    and of the same dtype, ``spectrum_*`` within the kernels' 1e-4 (atol
    and rtol)."""
    for f in dataclasses.fields(tel):
        got = getattr(tel, f.name)
        want = [getattr(t, f.name) for t in jtels]
        if want[0] is None:
            assert got is None, f.name
            continue
        want = np.concatenate(want)
        if f.name.startswith("spectrum_"):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4, err_msg=f.name)
        else:
            assert got.numpy().dtype == want.dtype, (f.name, got.dtype, want.dtype)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f.name)


# ------------------------------------------------- off-by-default contract


def test_telemetry_default_off_and_no_extra_outputs():
    assert tengine.FLConfig().telemetry is False and jengine.FLConfig().telemetry is False
    _, outs = _run(telemetry=False)
    assert "telemetry" not in outs


MODES = {
    "plain": {},
    "funnel": {"candidate_frac": 0.75},
    "fault_guarded": {"faults": "chaos", "aggregator": "trimmed_mean"},
    "scenario": {"scenario": "flaky"},
    # the guarded round with FedDyn's per-client state as well
    "fault_feddyn": {"faults": "chaos", "aggregator": "trimmed_mean", "local_algo": "feddyn", "feddyn_alpha": 0.1},
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_telemetry_on_is_bit_identical(mode):
    """``telemetry=True`` only adds the ``telemetry`` output: the final
    state (params, losses, kernel, quarantine, FedDyn's state, every
    generator's state) and every other output but the host timings are
    those of the run without it, bit for bit.  FL-DP³S, so the draws
    read the spectral cache the telemetry summarises."""
    fin_off, outs_off = _run(strategy=tsel.DPPSelection(), telemetry=False, **MODES[mode])
    fin_on, outs_on = _run(strategy=tsel.DPPSelection(), telemetry=True, **MODES[mode])
    a, b = _flat_state(fin_off), _flat_state(fin_on)
    assert set(a) == set(b)
    for name in a:
        assert _same(a[name], b[name]), f"{mode}: state {name} diverged"
    assert set(outs_on) == set(outs_off) | {"telemetry"}
    for name in outs_off:
        if not name.startswith("t_"):
            assert _same(outs_off[name], outs_on[name]), f"{mode}: output {name!r} diverged"
    assert isinstance(outs_on["telemetry"], tobs.Telemetry)
    if "faults" in MODES[mode]:
        assert a["quarantine"].numel() == 12
    if "local_algo" in MODES[mode]:
        assert any(name.startswith("algo_state.") for name in a)


# -------------------------------------------------------- telemetry fields


def test_telemetry_field_semantics():
    _, outs = _run(telemetry=True, rounds=6, reprofile_every=3, candidate_frac=0.5)
    tel = outs["telemetry"]
    q = tengine.FLConfig(num_clients=12, clients_per_round=4, candidate_frac=0.5).candidate_count()
    assert q == jengine.FLConfig(num_clients=12, clients_per_round=4, candidate_frac=0.5).candidate_count()
    assert tel.funnel_q.dtype == torch.int32 and (tel.funnel_q == q).all()
    np.testing.assert_allclose(tel.funnel_survival.numpy(), q / 12, rtol=1e-6)
    # the cache's age restarts at each aligned reprofile boundary
    assert tel.cache_age.tolist() == [0, 1, 2, 0, 1, 2]
    # the honest path: the whole cohort survives, none flagged or quarantined
    assert (tel.survivors == 4).all() and (tel.flagged == 0).all() and (tel.quarantined == 0).all()
    assert (tel.identity_round == 0).all()
    # uniform draws keep the identity placeholder: all-ones spectrum
    assert (tel.spectrum_top == 1).all() and (tel.spectrum_trace == q).all() and (tel.spectrum_erank == q).all()
    assert tel.avail_frac is None and tel.staleness_hist is None
    # FL-DP³S: a real spectrum, its effective rank within [1, Q]
    _, outs_d = _run(strategy=tsel.DPPSelection(), telemetry=True, candidate_frac=0.5)
    er = outs_d["telemetry"].spectrum_erank
    assert (outs_d["telemetry"].spectrum_trace > 0).all() and (er >= 1).all() and (er <= q).all()
    assert (er < q).any()
    # an availability-aware scenario fills the available fraction
    _, outs_f = _run(telemetry=True, scenario="flaky")
    af = outs_f["telemetry"].avail_frac
    assert af.shape == (6,) and (af >= 0).all() and (af <= 1).all()
    torch.testing.assert_close(af, outs_f["avail"].float().mean(dim=1), rtol=0, atol=0)
    # the guarded path reports the guard's counts, as the outputs do
    _, outs_g = _run(telemetry=True, faults="chaos", aggregator="trimmed_mean")
    tg = outs_g["telemetry"]
    for name in ("survivors", "flagged", "quarantined", "identity_round"):
        assert torch.equal(getattr(tg, name).long(), outs_g[name].long()), name


# ------------------------------------------------------------ JSONL schema


def test_jsonl_schema_roundtrip(tmp_path):
    path = tmp_path / "train.jsonl"
    _, outs = _run(telemetry=True, rounds=5, scenario="flaky")
    with tobs.TelemetrySink(str(path)) as sink:
        man = sink.write_manifest(config={"demo": 1}, extra={"mode": "fl"}, device="cpu")
        assert tobs.drain_fl_outputs(sink, outs) == 5
        assert sink.event_counts == {"manifest": 1, "fl_round": 5}
    lines = path.read_text().strip().splitlines()
    for line in lines:
        json.loads(line)  # strict JSON: NaN became null
    events = tobs.load_events(str(path))
    assert events == jobs.load_events(str(path))  # JAX's loader reads it too
    assert [e["event"] for e in events] == ["manifest"] + ["fl_round"] * 5
    assert events[0]["config_hash"] == man["config_hash"]
    for key in ("torch_version", "cuda_version", "backend", "device_count", "device_kind", "host_cores",
                "git_sha", "config"):
        assert key in events[0]
    assert "mesh" not in events[0] and "jax_version" not in events[0]
    assert events[0]["backend"] == "cpu" and events[0]["device_kind"] == "cpu" and events[0]["mode"] == "fl"
    for i, e in enumerate(events[1:]):
        assert FL_ROUND_REQUIRED <= set(e)
        assert {"avail_frac", "sim_time", "t_select", "t_local", "t_refresh"} <= set(e) and "avail" not in e
        assert e["round"] == i + 1
        assert e["acc"] is None  # no accuracy_fn: NaN every round
        assert isinstance(e["selected"], list) and len(e["selected"]) == 4
        assert e["cache_age"] == i and e["funnel_q"] == 12


def test_sink_sanitises_tensors_and_non_finite_values(tmp_path):
    path = tmp_path / "s.jsonl"
    with tobs.TelemetrySink(str(path), line_buffered=True) as sink:
        sink.emit("x", a=float("nan"), b=float("inf"), c=np.float32(1.5), d=torch.tensor(2, dtype=torch.int32),
                  e=torch.tensor([1.25, float("nan")], dtype=torch.bfloat16), f={"g": (np.int64(3), None)})
        assert tobs.load_events(str(path))[0]["a"] is None  # line-buffered: on disk before close
        sink.emit_many("y", [{"i": 1}, {"i": 2}])
        sink.emit_many("y", [])
    e, y1, y2 = tobs.load_events(str(path))
    assert (e["a"], e["b"], e["c"], e["d"], e["e"], e["f"]) == (None, None, 1.5, 2, [1.25, None], {"g": [3, None]})
    assert (y1["i"], y2["i"]) == (1, 2) and y1["t"] == y2["t"]
    assert tsink._column(torch.tensor([1.0, 2.5], dtype=torch.bfloat16)) == [1.0, 2.5]
    assert tsink._column(torch.tensor([1.0, float("nan")])) == [1.0, None]
    assert tsink._column(torch.tensor([1, 2], dtype=torch.int32)) == [1, 2]
    sink.close()  # closing twice is harmless


def test_trainer_drains_sink_at_segment_boundaries(tmp_path):
    xs, ys, params = _federation(8)
    cfg = tengine.FLConfig(num_clients=8, clients_per_round=3, local_epochs=1, lr=0.1, rounds=6, eval_every=2,
                           num_classes=NCLS, seed=0, reprofile_every=2, telemetry=True)
    tr = FLTrainer(cfg, params, linear_loss, lambda p, x: (None, x @ p["w"]), xs.numpy(), ys.numpy(),
                   strategy=tsel.UniformSelection(), device="cpu")
    path = tmp_path / "trainer.jsonl"
    with tobs.TelemetrySink(str(path)) as sink:
        sink.write_manifest(config=dataclasses.asdict(cfg), device="cpu")
        tr.run(sink=sink)
    events = tobs.load_events(str(path))
    kinds = [e["event"] for e in events]
    # the boundaries inside the run, as JAX's test counts them: the port
    # also re-profiles at round 6, which ends the run, without an event
    assert kinds == ["manifest"] + (["fl_round"] * 2 + ["fl_reprofile"]) * 2 + ["fl_round"] * 2
    assert [e["round"] for e in events if e["event"] == "fl_reprofile"] == [2, 4]
    assert all(e["funneled"] is False for e in events if e["event"] == "fl_reprofile")
    assert [e["cache_age"] for e in events if e["event"] == "fl_round"] == [0, 1] * 3
    assert tr.history["round"] == [2, 4, 6]


class _SelectOnly(tsel.SelectionStrategy):
    """A host-side strategy (no draw_fn): it runs the legacy loop."""

    name = "select-only"

    def select(self, generator, state, k):
        return torch.arange(k)


def test_legacy_loop_refuses_a_sink(tmp_path):
    xs, ys, params = _federation(6)
    cfg = tengine.FLConfig(num_clients=6, clients_per_round=2, local_epochs=1, lr=0.1, rounds=2,
                           num_classes=NCLS, telemetry=True)
    tr = FLTrainer(cfg, params, linear_loss, lambda p, x: (None, x @ p["w"]), xs.numpy(), ys.numpy(),
                   strategy=_SelectOnly(), device="cpu")
    with tobs.TelemetrySink(str(tmp_path / "l.jsonl")) as sink, pytest.raises(ValueError, match="legacy loop"):
        tr.run(sink=sink)
    assert tr.run()["round"] == [2]  # without a sink it runs


def test_checkpointed_merge_with_telemetry(tmp_path):
    """run_checkpointed's segments join the telemetry record like any
    other output, equal to the uninterrupted run's, with an
    ``fl_checkpoint`` event after each save."""
    cfg, strat, state = _state(c=10, k=3, rounds=7, telemetry=True, ckpt_every=3)
    fn = tengine.make_round_fn(cfg, linear_loss, (strat,))
    _, ref = tengine.run_scanned(fn, state.fork(), 7)
    with tobs.TelemetrySink(str(tmp_path / "ck.jsonl")) as sink:
        _, outs = tengine.run_checkpointed(fn, state.fork(), 7, ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=3,
                                           sink=sink)
    assert outs["telemetry"].cache_age.shape == (7,)
    assert outs["round"].tolist() == list(range(1, 8))
    for f in dataclasses.fields(tobs.Telemetry):
        a, b = getattr(ref["telemetry"], f.name), getattr(outs["telemetry"], f.name)
        assert (a is None and b is None) or _same(a, b), f.name
    events = tobs.load_events(str(tmp_path / "ck.jsonl"))
    assert [e["round"] for e in events if e["event"] == "fl_checkpoint"] == [3, 6, 7]
    assert [e["event"] for e in events].count("fl_round") == 7


def test_run_many_and_unstack_carry_telemetry():
    cfg, strat, state = _state(c=8, k=3, rounds=3, telemetry=True, scenario="flaky")
    fn = tengine.make_round_fn(cfg, linear_loss, (strat,))
    _, one = tengine.run_scanned(fn, state.fork(), 3)
    _, outs = tengine.run_many(fn, [state.fork(), state.fork()], 3)
    assert outs["telemetry"].cache_age.shape == (2, 3) and outs["telemetry"].staleness_hist is None
    per_run = tengine.unstack_outputs(outs)
    assert len(per_run) == 2
    for run in per_run:
        assert isinstance(run["telemetry"], tobs.Telemetry)
        np.testing.assert_array_equal(run["telemetry"].avail_frac, one["telemetry"].avail_frac.numpy())
        assert tengine.history_from_outputs(run, 2)["round"] == [2, 3]


# ----------------------------------------------------- manifest determinism


def test_manifest_determinism_and_config_hash_matches_jax():
    cfg = tengine.FLConfig(num_clients=16, clients_per_round=4, telemetry=True)
    h1 = tobs.config_hash(cfg)
    assert h1 == tobs.config_hash(tengine.FLConfig(num_clients=16, clients_per_round=4, telemetry=True))
    assert tobs.config_hash(dataclasses.asdict(cfg)) == h1
    assert tobs.run_manifest(config=cfg, device="cpu")["config_hash"] == h1
    assert tobs.config_hash(tengine.FLConfig(num_clients=16, clients_per_round=5, telemetry=True)) != h1
    # the same fields in the same order as JAX's config, and the same hash
    # for the same values; the port's one differing default
    # (use_pallas_kernel=True) gives another hash until it is set alike
    jcfg = jengine.FLConfig(num_clients=16, clients_per_round=4, telemetry=True)
    assert list(dataclasses.asdict(cfg)) == list(dataclasses.asdict(jcfg))
    assert h1 != jobs.config_hash(jcfg)
    assert h1 == jobs.config_hash(dataclasses.replace(jcfg, use_pallas_kernel=True))
    assert tobs.config_hash(dataclasses.replace(cfg, use_pallas_kernel=False)) == jobs.config_hash(jcfg)
    full = dict(num_clients=12, clients_per_round=3, lr=0.1, reprofile_every=2, scenario="flaky",
                candidate_frac=0.5, faults="chaos", aggregator="trimmed_mean", local_algo="feddyn",
                feddyn_alpha=0.1, ckpt_every=2, telemetry=True, use_pallas_kernel=False)
    assert tobs.config_hash(tengine.FLConfig(**full)) == jobs.config_hash(jengine.FLConfig(**full))
    # plain dicts, with each package's scalars and arrays
    plain = {"arch": "smollm-360m", "lr": 0.1, "nan": float("nan"), "nested": {"a": [1, 2.5, None]}}
    assert tobs.config_hash({**plain, "n": np.int32(3), "v": torch.tensor([1.5, 2.0])}) == jobs.config_hash(
        {**plain, "n": np.int32(3), "v": jax.numpy.asarray([1.5, 2.0])})


# --------------------------------------------------------- serving events


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(JAX cfg, JAX params, port cfg, port params), the same weights."""
    jcfg, jp = jserve.build_model(arch, seed=0)
    tcfg = get_arch(arch).model.reduced(param_dtype="float32", dtype="float32", remat=False)
    tp = tT.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def test_serve_zero_recompile_and_token_parity_with_telemetry(tmp_path):
    cfg, params = tserve.build_model("smollm-360m", 0, device="cpu")
    b, p, g = 3, 6, 8
    scfg = ServeConfig(batch=b, cache_len=p + g, max_new=g, decode_chunk=4)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(7, p)).astype(np.int32)
    budgets = [8, 3, 1, 5, 8, 2, 4]

    def traffic(telemetry):
        eng = ServeEngine(cfg, scfg, params, prompt_len=p, telemetry=telemetry)
        for i in range(len(budgets)):
            eng.submit(prompts[i], budgets[i])
        fin = eng.run()
        return eng, {f.seq_id: f.tokens for f in fin}

    path = tmp_path / "serve.jsonl"
    with tobs.TelemetrySink(str(path)) as sink:
        eng_on, toks_on = traffic(sink)
    eng_off, toks_off = traffic(None)
    # a sink adds no shape signature, and no token changes
    assert eng_on.compile_counts() == eng_off.compile_counts() == {"decode_chunk": 1, "admit": 1}
    assert set(toks_on) == set(toks_off) == set(range(7))
    for sid in toks_on:
        np.testing.assert_array_equal(toks_on[sid], toks_off[sid])
    events = tobs.load_events(str(path))
    kinds = [e["event"] for e in events]
    assert kinds.count("serve_submit") == kinds.count("serve_admit") == kinds.count("serve_finish") == 7
    assert kinds.count("serve_chunk") >= 1
    for e in events:
        if e["event"] == "serve_admit":
            assert e["ttft_s"] >= 0 and 1 <= e["occupancy"] <= b
        if e["event"] == "serve_chunk":
            assert e["tokens"] >= 0 and e["dt_s"] > 0 and e["batch"] == b and e["steps"] == 4
    fin = {e["seq_id"]: e["n_tokens"] for e in events if e["event"] == "serve_finish"}
    assert fin == {i: budgets[i] for i in range(7)}
    assert sum(e["tokens"] for e in events if e["event"] == "serve_chunk") + 7 == sum(budgets)
    # reset forgets the queue's clocks with the queue
    with tobs.TelemetrySink(str(tmp_path / "reset.jsonl")) as sink:
        eng = ServeEngine(cfg, scfg, params, prompt_len=p, telemetry=sink)
        eng.submit(prompts[0], 2)
        assert eng._t_submit
        eng.reset()
    assert eng._t_submit == {} and eng._pending_admits == []


def test_serve_event_stream_matches_jax(tmp_path):
    """``test_torch_serve.py::test_serve_engine_matches_jax``'s traffic
    through both engines, each with a sink: the same events in the same
    order, with the same sequence ids, budgets, queue depths, occupancies,
    generated counts, and chunk shapes (timings apart)."""
    jcfg, jp, tcfg, tp = _models("smollm-360m")
    b, p, g, n = 3, 6, 7, 7
    prompts = np.random.default_rng(7).integers(0, tcfg.vocab_size, size=(n, p)).astype(np.int32)
    budgets = [g, 1, 3, g, 2, 5, 4]
    with jobs.TelemetrySink(str(tmp_path / "jax.jsonl")) as jsink:
        jeng = JServeEngine(jcfg, JServeConfig(batch=b, cache_len=p + g, max_new=g, decode_chunk=3), jp,
                            prompt_len=p, telemetry=jsink)
        for i in range(n):
            jeng.submit(prompts[i], budgets[i])
        jeng.run()
    with tobs.TelemetrySink(str(tmp_path / "port.jsonl")) as sink:
        teng = ServeEngine(tcfg, ServeConfig(batch=b, cache_len=p + g, max_new=g, decode_chunk=3), tp,
                           prompt_len=p, telemetry=sink)
        for i in range(n):
            teng.submit(prompts[i], budgets[i])
        teng.run()
    keys = ("event", "seq_id", "gen_target", "queue_depth", "occupancy", "n_tokens", "steps", "tokens",
            "active_slots", "batch")
    jev, tev = jobs.load_events(str(tmp_path / "jax.jsonl")), tobs.load_events(str(tmp_path / "port.jsonl"))
    assert len(tev) == len(jev) and {e["event"] for e in tev} == {"serve_submit", "serve_admit", "serve_chunk",
                                                                  "serve_finish"}
    for e, je in zip(tev, jev):
        assert set(e) == set(je)
        assert [e.get(k) for k in keys] == [je.get(k) for k in keys], (e, je)


# ------------------------------------------------------------------ report


def _mixed_events(path, write_manifest):
    _, outs = _run(telemetry=True, rounds=5)
    with tobs.TelemetrySink(str(path)) as sink:
        write_manifest(sink)
        tobs.drain_fl_outputs(sink, outs)
        sink.emit("fl_reprofile", round=3, funneled=False)
        sink.emit("fl_checkpoint", round=5)
        sink.emit("serve_submit", seq_id=0, gen_target=4, queue_depth=1)
        sink.emit("serve_admit", seq_id=0, ttft_s=0.01, queue_depth=0, occupancy=1)
        sink.emit("serve_chunk", steps=4, tokens=4, dt_s=0.002, tok_s=2000.0, active_slots=1, batch=2,
                  queue_depth=0)
        sink.emit("serve_finish", seq_id=0, n_tokens=4, latency_s=0.02)
    return tobs.load_events(str(path))


def test_report_renders_train_and_serve(tmp_path, capsys):
    path = tmp_path / "mixed.jsonl"
    _mixed_events(path, lambda s: s.write_manifest(config={"demo": 1}, extra={"mode": "fl"}, device="cpu"))
    text = treport.summarize(tobs.load_events(str(path)))
    for want in ("run manifest", "torch_version:", "backend: cpu", "device_kind: cpu", "mode: fl",
                 "training: 5 rounds", "cache_age", "spectrum_erank", "reprofile boundaries: 1",
                 "checkpoints: 1 (last at round 5)", "serving: 1 finished seqs", "TTFT", "latency (s)",
                 "decode: 4 tokens"):
        assert want in text, want
    assert treport.summarize([]) == "no telemetry events"
    treport.main([str(path)])
    assert capsys.readouterr().out.strip() == text


def test_report_matches_jax_on_the_same_events(tmp_path):
    """JAX's ``summarize`` and the port's render the same text from the
    port's events, apart from the manifest's version lines (JAX's report
    knows ``jax_version`` only); from a file with JAX's manifest the two
    texts are equal."""
    port = _mixed_events(tmp_path / "p.jsonl",
                         lambda s: s.write_manifest(config={"demo": 1}, extra={"mode": "fl"}, device="cpu"))
    drop = lambda text: [line for line in text.splitlines() if "_version:" not in line]  # noqa: E731
    assert drop(treport.summarize(port)) == drop(jreport.summarize(port))
    assert treport.summarize(port, max_rows=2) != treport.summarize(port)
    assert drop(treport.summarize(port, max_rows=2)) == drop(jreport.summarize(port, max_rows=2))

    def jax_manifest(sink):
        sink.emit("manifest", **jobs.run_manifest(config={"demo": 1}, extra={"mode": "fl"}))

    jaxs = _mixed_events(tmp_path / "j.jsonl", jax_manifest)
    text = treport.summarize(jaxs)
    assert text == jreport.summarize(jaxs) and "jax_version:" in text


# ---------------------------------------------------------------- tracing


def test_trace_writes_a_chrome_trace_with_the_spans(tmp_path):
    """``trace(dir)`` writes one ``*.pt.trace.json`` that holds the host
    spans of the engine (a segment of 2 rounds, the reprofile after it)
    and of the serving engine (admissions, decode chunks);
    ``trace(None)`` records nothing."""
    with ttracing.trace(None):
        pass
    xs, ys, params = _federation(6)
    cfg = tengine.FLConfig(num_clients=6, clients_per_round=2, local_epochs=1, lr=0.1, rounds=2, eval_every=2,
                           num_classes=NCLS, reprofile_every=2)
    tr = FLTrainer(cfg, params, linear_loss, lambda p, x: (None, x @ p["w"]), xs.numpy(), ys.numpy(),
                   strategy=tsel.DPPSelection(), device="cpu")
    _, _, tcfg, tp = _models("smollm-360m")
    eng = ServeEngine(tcfg, ServeConfig(batch=2, cache_len=6, max_new=2, decode_chunk=1), tp, prompt_len=4)
    with ttracing.trace(str(tmp_path / "prof")):
        tr.run()
        for i in range(3):
            eng.submit(np.full(4, i, np.int32), 2)
        eng.run()
        with ttracing.annotate("outer"):
            pass
    files = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    spans = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert spans.count("fl.scan_chunk[2]") == 1 and spans.count("fl.reprofile") == 1
    assert spans.count("serve.admit") == 3 and spans.count("serve.decode_chunk") >= 2 and "outer" in spans
    assert any(e.get("cat") == "cpu_op" for e in events)
