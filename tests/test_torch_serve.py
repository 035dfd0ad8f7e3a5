"""The port's serving path (``repro_torch.serve``, ``repro_torch.launch.serve``)
on the CPU: the engine's own contracts, as the JAX package's
``tests/test_serve_engine.py`` states them, and the whole slice against the
JAX package with JAX-initialised weights carried across by
``params_from_jax``.  With ``use_flash`` JAX runs its Pallas flash-decode
kernel in interpret mode and the port runs K5's plain version.

Tolerances: the reduced models run in fp32.  Per-step logits of the two
frameworks agree within ``rtol = 1e-5`` and ``atol = 1e-5 * max|logits|``
(the same products summed in another order by XLA and PyTorch); a greedy
token is compared only where JAX's top-2 margin exceeds twice that bound,
4e-5 * max|logits|, since below it either choice is within rounding."""

import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.launch import serve as jserve  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import sample_tokens as jsample_tokens  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ServeConfig,
    ServeEngine,
    gumbel_rows,
    init_decode_state,
    make_decode_fn,
    run_while,
    sample_tokens,
)

RTOL, ATOL_REL, MARGIN_REL = 1e-5, 1e-5, 4e-5


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(JAX cfg, JAX params, port cfg, port params), the same weights."""
    jcfg, jp = jserve.build_model(arch, seed=0)
    tcfg = get_arch(arch).model.reduced(param_dtype="float32", dtype="float32", remat=False)
    tp = tT.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _prompts(cfg, b, p, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, p)).astype(np.int32)


def _solo(tcfg, tp, prompt, budget):
    out, _ = tserve.run_legacy(tcfg, tp, torch.from_numpy(prompt)[None], budget)
    return out[0]


def _prefilled_state(tcfg, tp, scfg, prompts):
    """A decode state with every slot admitted from one batched prefill."""
    b, p = prompts.shape
    caches = tT.init_caches(tcfg, b, scfg.cache_len, per_slot=True, device="cpu")
    pos = torch.arange(p, dtype=torch.int32)[None].expand(b, p)
    hidden, caches, _ = tT.forward(tcfg, tp, torch.from_numpy(prompts), pos, caches)
    tok0 = sample_tokens(tT.logits_from_hidden(tcfg, tp, hidden[:, -1:]), 0.0)
    state = init_decode_state(tcfg, scfg, device="cpu")
    state.caches = caches
    state.last_tok = tok0[:, None]
    state.out_tokens[:, 0] = tok0
    state.n_gen.fill_(1)
    state.seq_ids = torch.arange(b, dtype=torch.int32)
    return state


# --------------------------------------------------------------- sampling


def test_greedy_is_exact_argmax_and_draws_nothing():
    logits = np.random.default_rng(0).normal(size=(4, 1, 16)).astype(np.float32)
    got = sample_tokens(torch.from_numpy(logits), 0.0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.argmax(logits[:, 0], -1))
    keys = jax.random.key_data(jax.random.split(jax.random.key(7), 4))
    jt, jk = jsample_tokens(jnp.asarray(logits), keys, 0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jt))
    # a greedy decode step leaves every slot's stream where it was
    _, _, tcfg, tp = _models("smollm-360m")
    scfg = ServeConfig(batch=2, cache_len=8, max_new=2)
    state = _prefilled_state(tcfg, tp, scfg, _prompts(tcfg, 2, 6))
    state.gen_target.fill_(2)
    state.active.fill_(True)
    before = [gen.get_state() for gen in state.generators]
    state = make_decode_fn(tcfg, scfg)(tp, state)
    assert all(torch.equal(gen.get_state(), s) for gen, s in zip(state.generators, before))


@pytest.mark.parametrize("temperature", [0.3, 0.8, 1.7])
def test_temperature_sampling_matches_jax_under_its_gumbel_draws(temperature):
    """JAX's per-slot draw splits each slot's key and calls
    ``categorical(use, row / T)``; feeding the port the Gumbel noise that
    key gives reproduces JAX's tokens exactly."""
    logits = (3.0 * np.random.default_rng(1).normal(size=(6, 1, 500))).astype(np.float32)
    keys = jax.random.key_data(jax.random.split(jax.random.key(11), 6))
    for _ in range(4):  # four successive draws from the advancing streams
        jt, new_keys = jsample_tokens(jnp.asarray(logits), keys, temperature)
        uses = [jax.random.split(jax.random.wrap_key_data(kd))[1] for kd in keys]
        g = np.stack([np.asarray(jax.random.gumbel(u, (500,), jnp.float32)) for u in uses])
        got = sample_tokens(torch.from_numpy(logits), temperature, torch.from_numpy(g))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jt))
        keys = new_keys


def test_gumbel_rows_are_per_slot_streams():
    gens = [torch.Generator().manual_seed(s) for s in (5, 6, 5)]
    g = gumbel_rows(gens, 50_000, torch.float32)
    assert g.shape == (3, 50_000) and torch.isfinite(g).all()
    assert torch.equal(g[0], g[2]) and not torch.equal(g[0], g[1])
    # standard Gumbel: mean 0.5772 (Euler's constant), std pi/sqrt(6); the
    # bound is 5 standard errors of 100k draws
    sample = g[:2].reshape(-1)
    assert abs(float(sample.mean()) - 0.5772157) < 5 * 1.2825 / 100_000**0.5
    assert abs(float(sample.std()) - 1.2825498) < 0.03
    with pytest.raises(ValueError, match="Gumbel"):
        sample_tokens(torch.zeros(3, 1, 8), 0.5)


# ------------------------------------------------------------ the engine


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma-7b", "internlm2-20b", "rwkv6-7b"])
def test_scan_decode_bit_identical_to_legacy(arch):
    _, _, tcfg, tp = _models(arch)
    prompts = torch.from_numpy(_prompts(tcfg, 3, 6))
    legacy, _ = tserve.run_legacy(tcfg, tp, prompts, 5)
    scan, _ = tserve.run_scan_mode(tcfg, tp, prompts, 5)
    assert legacy.shape == (3, 5)
    np.testing.assert_array_equal(scan, legacy)


def test_flash_decode_route_gives_the_plain_tokens():
    _, _, tcfg, tp = _models("smollm-360m")
    prompts = torch.from_numpy(_prompts(tcfg, 2, 6))
    plain, _ = tserve.run_scan_mode(tcfg, tp, prompts, 4)
    flash, _ = tserve.run_scan_mode(tcfg, tp, prompts, 4, use_flash=True)
    np.testing.assert_array_equal(plain, flash)


def test_while_loop_per_slot_stopping():
    _, _, tcfg, tp = _models("smollm-360m")
    b, p, g = 4, 6, 8
    prompts = _prompts(tcfg, b, p)
    legacy, _ = tserve.run_legacy(tcfg, tp, torch.from_numpy(prompts), g)
    scfg = ServeConfig(batch=b, cache_len=p + g, max_new=g)
    state = _prefilled_state(tcfg, tp, scfg, prompts)
    targets = torch.tensor([2, g, 1, 5], dtype=torch.int32)
    state.gen_target = targets
    state.active = targets > 1
    state = run_while(make_decode_fn(tcfg, scfg), tp, state, g)
    n_gen = state.n_gen.numpy()
    np.testing.assert_array_equal(n_gen, targets.numpy())
    assert not state.active.any()
    assert state.step == g - 1  # stops at the longest slot, not the budget
    out = state.out_tokens.numpy()
    for i in range(b):
        np.testing.assert_array_equal(out[i, : n_gen[i]], legacy[i, : n_gen[i]])


def test_eos_stops_slots_early():
    _, _, tcfg, tp = _models("smollm-360m")
    b, p, g = 3, 6, 7
    prompts = _prompts(tcfg, b, p)
    legacy, _ = tserve.run_legacy(tcfg, tp, torch.from_numpy(prompts), g)
    eos = int(legacy[0, 2])
    scfg = ServeConfig(batch=b, cache_len=p + g, max_new=g, eos_id=eos)
    state = _prefilled_state(tcfg, tp, scfg, prompts)
    state.gen_target.fill_(g)
    state.active.fill_(True)
    state = run_while(make_decode_fn(tcfg, scfg), tp, state, g)
    n_gen = state.n_gen.numpy()
    for i in range(b):
        hits = np.nonzero(legacy[i] == eos)[0]
        # the prefill sample is never checked against EOS, as in JAX
        hits = hits[hits > 0]
        expect = int(hits[0]) + 1 if hits.size else g
        assert n_gen[i] == expect, (i, n_gen[i], expect)
        np.testing.assert_array_equal(state.out_tokens.numpy()[i, :expect], legacy[i, :expect])


def test_continuous_refill_matches_solo_decode():
    _, _, tcfg, tp = _models("smollm-360m")
    b, p, g, n = 2, 6, 8, 5
    eng = ServeEngine(tcfg, ServeConfig(batch=b, cache_len=p + g, max_new=g, decode_chunk=3), tp, prompt_len=p)
    prompts = _prompts(tcfg, n, p, seed=2)
    budgets = [3, g, 1, 6, 4]
    for i in range(n):
        eng.submit(prompts[i], budgets[i])
    finished = eng.run()
    assert sorted(f.seq_id for f in finished) == list(range(n))
    for f in finished:
        assert len(f.tokens) == budgets[f.seq_id]
        np.testing.assert_array_equal(f.tokens, _solo(tcfg, tp, prompts[f.seq_id], budgets[f.seq_id]))


@pytest.mark.parametrize("drain", [False, True])
def test_budget1_not_clobbered_by_same_wave_admission(drain):
    _, _, tcfg, tp = _models("smollm-360m")
    b, p, g, n = 3, 6, 6, 4
    eng = ServeEngine(tcfg, ServeConfig(batch=b, cache_len=p + g, max_new=g, decode_chunk=2), tp, prompt_len=p)
    prompts = _prompts(tcfg, n, p, seed=4)
    budgets = [1, 1, g, 3]  # two budget-1 admissions in the first wave
    for i in range(n):
        eng.submit(prompts[i], budgets[i])
    finished = eng.run(drain=drain)
    assert sorted(f.seq_id for f in finished) == list(range(n))
    for f in finished:
        assert len(f.tokens) == budgets[f.seq_id], f"seq {f.seq_id} truncated"
        np.testing.assert_array_equal(f.tokens, _solo(tcfg, tp, prompts[f.seq_id], budgets[f.seq_id]))


def test_engine_validates_sizes():
    _, _, tcfg, tp = _models("smollm-360m")
    with pytest.raises(ValueError, match="cache_len"):
        ServeEngine(tcfg, ServeConfig(batch=2, cache_len=8, max_new=6), tp, prompt_len=4)
    with pytest.raises(ValueError, match="prompt_len"):
        ServeEngine(tcfg, ServeConfig(batch=2, cache_len=8, max_new=6), tp, prompt_len=0)
    for bad in (dict(batch=0), dict(max_new=9), dict(max_new=0), dict(temperature=-1.0), dict(decode_chunk=0)):
        with pytest.raises(ValueError):
            ServeConfig(**{**dict(batch=2, cache_len=8, max_new=4), **bad})
    eng = ServeEngine(tcfg, ServeConfig(batch=2, cache_len=8, max_new=4), tp, prompt_len=4)
    with pytest.raises(ValueError, match="prompt must be"):
        eng.submit(np.zeros(5, np.int32), 2)
    with pytest.raises(ValueError, match="gen_target"):
        eng.submit(np.zeros(4, np.int32), 5)
    # a sink is taken: each submission is an event at once
    events = []

    class Sink:
        def emit(self, event, **payload):
            events.append((event, payload))

    eng = ServeEngine(tcfg, ServeConfig(batch=2, cache_len=8, max_new=4), tp, prompt_len=4, telemetry=Sink())
    assert eng.submit(np.zeros(4, np.int32), 2) == 0
    assert events == [("serve_submit", {"seq_id": 0, "gen_target": 2, "queue_depth": 1})]


def test_slot_refill_keeps_one_shape_signature():
    """Mixed budgets reuse one input-shape signature for the decode chunk
    and one for admission, also after a reset."""
    _, _, tcfg, tp = _models("smollm-360m")
    b, p, g = 2, 6, 6
    eng = ServeEngine(tcfg, ServeConfig(batch=b, cache_len=p + g, max_new=g, decode_chunk=2), tp, prompt_len=p)
    prompts = _prompts(tcfg, 7, p, seed=3)
    for i, budget in enumerate([1, g, 2, 5, 3, g, 2]):
        eng.submit(prompts[i], budget)
    eng.run()
    counts = eng.compile_counts()
    assert counts == {"decode_chunk": 1, "admit": 1}, counts
    eng.reset()
    for i in range(4):
        eng.submit(prompts[i], 2 + i)
    assert len(eng.run()) == 4
    assert eng.compile_counts() == counts


def test_temperature_engine_is_reproducible_per_seed():
    _, _, tcfg, tp = _models("smollm-360m")
    p, g = 6, 6
    prompts = _prompts(tcfg, 5, p, seed=5)

    def run(seed):
        eng = ServeEngine(tcfg, ServeConfig(batch=2, cache_len=p + g, max_new=g, temperature=0.9),
                          tp, prompt_len=p, seed=seed)
        for i in range(5):
            eng.submit(prompts[i], g)
        return {f.seq_id: f.tokens.tolist() for f in eng.run()}

    a, b = run(0), run(0)
    assert a == b and sorted(a) == list(range(5))
    assert run(1) != a


# ------------------------------------------------ the slice against JAX


def _jax_teacher_logits(jcfg, jp, prompts, toks, use_flash):
    b, p = prompts.shape
    caches = jT.init_caches(jcfg, b, p + toks.shape[1], per_slot=True)
    pos = jnp.broadcast_to(jnp.arange(p, dtype=jnp.int32)[None], (b, p))
    hidden, caches, _ = jax.jit(lambda prm, t, c: jT.forward(jcfg, prm, t, pos, c))(jp, jnp.asarray(prompts), caches)
    out = [np.asarray(jT.logits_from_hidden(jcfg, jp, hidden[:, -1:]))]
    step = jax.jit(lambda prm, t, c: jT.decode_step(jcfg, prm, t, c, use_flash=use_flash))
    for i in range(toks.shape[1] - 1):
        logits, caches = step(jp, jnp.asarray(toks[:, i : i + 1]), caches)
        out.append(np.asarray(logits))
    return np.concatenate(out, axis=1)


def _torch_teacher_logits(tcfg, tp, prompts, toks, use_flash):
    b, p = prompts.shape
    caches = tT.init_caches(tcfg, b, p + toks.shape[1], per_slot=True, device="cpu")
    pos = torch.arange(p, dtype=torch.int32)[None].expand(b, p)
    hidden, caches, _ = tT.forward(tcfg, tp, torch.from_numpy(prompts), pos, caches)
    out = [tT.logits_from_hidden(tcfg, tp, hidden[:, -1:])]
    for i in range(toks.shape[1] - 1):
        logits, caches = tT.decode_step(tcfg, tp, torch.from_numpy(toks[:, i : i + 1].copy()), caches,
                                        use_flash=use_flash)
        out.append(logits)
    return torch.cat(out, dim=1).numpy()


def _margins(logits):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.mark.parametrize("use_flash", [False, True])
def test_run_scan_mode_matches_jax(use_flash, capsys):
    """Reduced smollm through both frameworks' ``run_scan_mode`` on the same
    prompts and weights.  Teacher-forced over JAX's tokens, every step's
    logits agree within the stated bound and the port's greedy choice is
    JAX's wherever JAX's top-2 margin exceeds 4e-5 * max|logits|; the port's
    own tokens agree with JAX's up to the first step below that margin."""
    jcfg, jp, tcfg, tp = _models("smollm-360m")
    b, p, g = 3, 6, 8 if use_flash else 12
    prompts = _prompts(tcfg, b, p, seed=6)
    jtoks, _ = jserve.run_scan_mode(jcfg, jp, jnp.asarray(prompts), g, use_flash=use_flash)
    jtoks = np.asarray(jtoks)
    ttoks, _ = tserve.run_scan_mode(tcfg, tp, torch.from_numpy(prompts), g, use_flash=use_flash)
    jl = _jax_teacher_logits(jcfg, jp, prompts, jtoks, use_flash)
    tl = _torch_teacher_logits(tcfg, tp, prompts, jtoks, use_flash)
    assert tl.shape == jl.shape == (b, g, tT.vocab_padded(tcfg))
    scale = float(np.abs(jl).max())
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL_REL * scale)

    np.testing.assert_array_equal(np.argmax(jl, -1), jtoks)  # JAX's scan is its own greedy choice
    clear = _margins(jl) > MARGIN_REL * scale
    np.testing.assert_array_equal(np.argmax(tl, -1)[clear], jtoks[clear])
    for i in range(b):
        low = np.nonzero(~clear[i])[0]
        agree_to = int(low[0]) + 1 if low.size else g
        np.testing.assert_array_equal(ttoks[i, :agree_to], jtoks[i, :agree_to])
    with capsys.disabled():
        print(f"\n[run_scan_mode flash={use_flash}] {int((~clear).sum())} of {clear.size} "
              f"steps below the margin; free-running tokens equal: {bool((ttoks == jtoks).all())}")


def test_serve_engine_matches_jax():
    """Continuous greedy batching with mixed budgets through both engines:
    the same sequences finish with the same lengths, and each sequence's
    tokens are JAX's up to the first step below the margin."""
    jcfg, jp, tcfg, tp = _models("smollm-360m")
    b, p, g, n = 3, 6, 7, 7
    prompts = _prompts(tcfg, n, p, seed=7)
    budgets = [g, 1, 3, g, 2, 5, 4]
    jeng = JServeEngine(jcfg, JServeConfig(batch=b, cache_len=p + g, max_new=g, decode_chunk=3), jp, prompt_len=p)
    teng = ServeEngine(tcfg, ServeConfig(batch=b, cache_len=p + g, max_new=g, decode_chunk=3), tp, prompt_len=p)
    for i in range(n):
        jeng.submit(prompts[i], budgets[i])
        teng.submit(prompts[i], budgets[i])
    jfin = {f.seq_id: np.asarray(f.tokens) for f in jeng.run()}
    tfin = {f.seq_id: f.tokens for f in teng.run()}
    assert sorted(tfin) == sorted(jfin) == list(range(n))
    assert teng.compile_counts() == {"decode_chunk": 1, "admit": 1}
    for i in range(n):
        assert len(tfin[i]) == len(jfin[i]) == budgets[i]
        if not np.array_equal(tfin[i], jfin[i]):
            jl = _jax_teacher_logits(jcfg, jp, prompts[i : i + 1], jfin[i][None], False)[0]
            first = int(np.nonzero(tfin[i] != jfin[i])[0][0])
            assert _margins(jl[first]) <= MARGIN_REL * float(np.abs(jl).max()), (i, first)


def test_rwkv_serve_engine_matches_jax():
    """The RWKV-6 family through both engines, continuous greedy batching
    with mixed budgets: per-slot recurrent states admitted row by row, and
    inactive slots' states advancing on token 0 until admission overwrites
    them.  The port runs the time mix through K7's plain version
    (``use_flash``), JAX through its plain scan."""
    jcfg, jp, tcfg, tp = _models("rwkv6-7b")
    b, p, g, n = 3, 6, 7, 7
    prompts = _prompts(tcfg, n, p, seed=8)
    budgets = [g, 1, 3, g, 2, 5, 4]
    jeng = JServeEngine(jcfg, JServeConfig(batch=b, cache_len=p + g, max_new=g, decode_chunk=3), jp, prompt_len=p)
    teng = ServeEngine(tcfg, ServeConfig(batch=b, cache_len=p + g, max_new=g, decode_chunk=3, use_flash=True),
                       tp, prompt_len=p)
    for i in range(n):
        jeng.submit(prompts[i], budgets[i])
        teng.submit(prompts[i], budgets[i])
    jfin = {f.seq_id: np.asarray(f.tokens) for f in jeng.run()}
    tfin = {f.seq_id: f.tokens for f in teng.run()}
    assert sorted(tfin) == sorted(jfin) == list(range(n))
    assert teng.compile_counts() == {"decode_chunk": 1, "admit": 1}
    wkv = teng.state.caches["unit"][0]["wkv"]
    assert wkv.shape == (tcfg.num_layers, b, 4, 64, 64) and wkv.dtype == torch.float32
    for i in range(n):
        assert len(tfin[i]) == len(jfin[i]) == budgets[i]
        np.testing.assert_array_equal(tfin[i], _solo(tcfg, tp, prompts[i], budgets[i]))
        if not np.array_equal(tfin[i], jfin[i]):
            jl = _jax_teacher_logits(jcfg, jp, prompts[i : i + 1], jfin[i][None], False)[0]
            first = int(np.nonzero(tfin[i] != jfin[i])[0][0])
            assert _margins(jl[first]) <= MARGIN_REL * float(np.abs(jl).max()), (i, first)


# ------------------------------------------------------------ the driver


def test_cli_scan_check_and_continuous_on_the_cpu(capsys):
    toks = tserve.main(["--batch", "2", "--prompt-len", "5", "--gen", "6", "--scan", "--check", "--device", "cpu"])
    assert toks.shape == (2, 6)
    assert "parity OK" in capsys.readouterr().out
    fin = tserve.main(["--arch", "gemma-7b", "--batch", "2", "--prompt-len", "4", "--gen", "8", "--continuous",
                       "--requests", "5", "--mixed", "--temperature", "0.7", "--flash", "--device", "cpu"])
    assert sorted(f.seq_id for f in fin) == list(range(5))
    assert all(2 <= len(f.tokens) <= 8 for f in fin)
    assert "{'decode_chunk': 1, 'admit': 1}" in capsys.readouterr().out


def test_cli_telemetry_and_profile_dir_on_the_cpu(tmp_path, capsys):
    """``--telemetry`` and ``--profile-dir``: in ``--continuous`` the
    manifest and the engine's events (one submission, admission and finish
    per request, the decode chunks' tokens adding up) and a Chrome trace
    with the engine's spans, the tokens those of the run without the
    flags; in ``--scan`` the manifest and one ``serve_summary``."""
    from repro_torch import obs as tobs
    from repro_torch.analysis import report as treport

    argv = ["--batch", "2", "--prompt-len", "4", "--gen", "6", "--continuous", "--requests", "4", "--mixed",
            "--flash", "--device", "cpu"]
    path, prof = tmp_path / "s.jsonl", tmp_path / "prof"
    fin = tserve.main(argv + ["--telemetry", str(path), "--profile-dir", str(prof)])
    assert f"telemetry -> {path} (render with `python -m repro_torch.analysis.report {path}`)" in capsys.readouterr().out
    ref = {f.seq_id: f.tokens for f in tserve.main(argv)}
    assert {f.seq_id for f in fin} == set(ref)
    for f in fin:
        np.testing.assert_array_equal(f.tokens, ref[f.seq_id])
    events = tobs.load_events(str(path))
    kinds = [e["event"] for e in events]
    assert kinds[0] == "manifest" and events[0]["mode"] == "serve" and events[0]["config"]["use_flash"] is True
    assert kinds.count("serve_submit") == kinds.count("serve_admit") == kinds.count("serve_finish") == 4
    assert sum(e["tokens"] for e in events if e["event"] == "serve_chunk") + 4 == sum(len(t) for t in ref.values())
    assert "serving: 4 finished seqs, 4 admissions" in treport.summarize(events)
    (trace,) = prof.glob("*.pt.trace.json")
    spans = {e["name"] for e in json.loads(trace.read_text())["traceEvents"] if e.get("cat") == "user_annotation"}
    assert {"serve.admit", "serve.decode_chunk"} <= spans
    tserve.main(["--batch", "2", "--prompt-len", "4", "--gen", "3", "--scan", "--device", "cpu",
                 "--telemetry", str(tmp_path / "scan.jsonl")])
    man, summary = tobs.load_events(str(tmp_path / "scan.jsonl"))
    assert man["event"] == "manifest" and summary["event"] == "serve_summary"
    assert (summary["mode"], summary["tokens"]) == ("scan", 6) and summary["decode_tok_s"] > 0


def test_cli_rwkv_scan_check_and_continuous_on_the_cpu(capsys):
    toks = tserve.main(["--arch", "rwkv6-7b", "--batch", "2", "--prompt-len", "5", "--gen", "6", "--scan",
                        "--check", "--device", "cpu"])
    assert toks.shape == (2, 6)
    out = capsys.readouterr().out
    assert "arch=rwkv6-7b (reduced, float32)" in out and "parity OK" in out
    fin = tserve.main(["--arch", "rwkv6-7b", "--batch", "2", "--prompt-len", "4", "--gen", "8", "--continuous",
                       "--requests", "5", "--mixed", "--flash", "--device", "cpu"])
    assert sorted(f.seq_id for f in fin) == list(range(5))
    assert all(2 <= len(f.tokens) <= 8 for f in fin)
    assert "{'decode_chunk': 1, 'admit': 1}" in capsys.readouterr().out


def test_serving_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.build_model("smollm-360m", 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--batch", "1", "--prompt-len", "2", "--gen", "2"])
    # --telemetry and --profile-dir run, on the CPU when asked
    fin = tserve.main(["--batch", "1", "--prompt-len", "2", "--gen", "2", "--continuous", "--requests", "1",
                       "--telemetry", str(tmp_path / "x.jsonl"), "--profile-dir", str(tmp_path / "p"),
                       "--device", "cpu"])
    assert len(fin) == 1 and (tmp_path / "x.jsonl").exists() and list((tmp_path / "p").glob("*.pt.trace.json"))
    # an arch of the last model slice builds on the CPU when asked
    cfg, params = tserve.build_model("mixtral-8x7b", 0, device="cpu")
    assert cfg.block_pattern == ("swa+moe",) and params["blocks"][0]["ffn"]["wi"].shape[0] == cfg.num_experts
