"""Serving driver: prefill and batched decode against the KV cache.

Three decode modes over the same model:

* legacy (default): a host loop of greedy decode steps on the shared-scalar
  cache, without kernels (K5, K7).  The parity oracle: greedy scan mode
  without ``--flash`` must give its tokens bit for bit.
* ``--scan``: the serving engine's decode loop over per-slot caches, greedy
  or with ``--temperature``.
* ``--continuous``: slot-based continuous batching through
  :class:`repro_torch.serve.ServeEngine`: ``--requests`` sequences stream
  through ``--batch`` slots, finished slots refilled from the queue.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --batch 4 --prompt-len 8 --gen 12 --scan --check --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
        --batch 4 --prompt-len 8 --gen 16 --continuous --requests 10 --mixed \\
        --flash --device cpu

Without ``--full-width`` the model is the arch's ``reduced`` variant in
fp32; with it, the arch's own widths and dtypes.  Weights are random from
``--seed``, and prompts (and ``--mixed`` budgets) come from
``np.random.default_rng(seed)``.  Prefill is charged the ``b*p`` prompt
tokens and samples the first generated token; decode is charged the other
``b*(g-1)``.  Timings are host clock up to a device synchronise.

``--telemetry PATH`` writes the run's manifest and, with ``--continuous``,
the engine's events (submissions, admissions with TTFT, decode chunks,
finishes), in the other modes one ``serve_summary`` event, as JSONL that
``python -m repro_torch.analysis.report PATH`` renders.  ``--profile-dir
DIR`` traces the whole run with ``torch.profiler`` into a Chrome trace
there.
"""

from __future__ import annotations

import argparse
import contextlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, model_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.obs import TelemetrySink
from repro_torch.obs import tracing as obs_tracing_lib
from repro_torch.serve import (
    Finished,
    ServeConfig,
    ServeEngine,
    init_decode_state,
    make_decode_fn,
    run_scan,
    sample_tokens,
    slot_noise,
)


def build_model(
    arch: str, seed: int, full_width: bool = False, device=None, layers: Optional[int] = None
) -> Tuple[ModelConfig, Dict]:
    """``configs.model_config(arch, full_width, layers)`` and random
    parameters from ``seed``, on ``device`` (default ``cuda``); both
    launchers build their model here."""
    cfg = model_config(arch, full_width, layers)
    device = resolve_device(device)
    params = T.init_params(torch.Generator(device=device).manual_seed(seed), cfg, device)
    return cfg, params


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prefill(cfg: ModelConfig, params: Dict, prompts: torch.Tensor, caches: Dict, use_flash: bool = False):
    """Prompts (B, P) through the model into ``caches`` -> (logits of the
    last position (B, 1, V_pad), caches)."""
    b, p = prompts.shape
    positions = T.mrope_streams(cfg, torch.arange(p, dtype=torch.int32, device=prompts.device)[None].expand(b, p))
    hidden, caches, _ = T.forward(cfg, params, prompts, positions, caches, use_flash=use_flash)
    return T.logits_from_hidden(cfg, params, hidden[:, -1:]), caches


def run_legacy(cfg: ModelConfig, params: Dict, prompts: torch.Tensor, gen: int):
    """Host-loop greedy decode on the shared-scalar cache, without kernels
    (K5, K7) — the parity oracle.  -> (tokens (B, gen) numpy, {"t_prefill": s, "t_decode": s})."""
    b, p = prompts.shape
    dev = prompts.device
    caches = T.init_caches(cfg, b, p + gen, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = prefill(cfg, params, prompts, caches)
    toks = torch.argmax(logits[:, 0], dim=-1)[:, None].to(torch.int32)
    _sync(dev)  # the first generated token belongs to prefill
    t_prefill = time.perf_counter() - t0

    out = [toks]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, caches = T.decode_step(cfg, params, toks, caches)
        toks = torch.argmax(logits[:, 0], dim=-1)[:, None].to(torch.int32)
        out.append(toks)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return torch.cat(out, dim=1).cpu().numpy(), {"t_prefill": t_prefill, "t_decode": t_decode}


def run_scan_mode(cfg: ModelConfig, params: Dict, prompts: torch.Tensor, gen: int,
                  temperature: float = 0.0, use_flash: bool = False, seed: int = 0):
    """Engine decode: batch prefill into per-slot caches, then ``gen - 1``
    steps of the decode loop.  -> (tokens (B, gen) numpy, timings)."""
    b, p = prompts.shape
    dev = prompts.device
    scfg = ServeConfig(batch=b, cache_len=p + gen, max_new=gen,
                       temperature=temperature, use_flash=use_flash)
    decode_fn = make_decode_fn(cfg, scfg)
    state = init_decode_state(cfg, scfg, seed, dev)
    caches = T.init_caches(cfg, b, p + gen, per_slot=True, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = prefill(cfg, params, prompts, caches, use_flash)
    tok0 = sample_tokens(logits, temperature, slot_noise(logits, temperature, state.generators))
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    state.caches = caches
    state.last_tok = tok0[:, None]
    state.out_tokens[:, 0] = tok0
    state.n_gen.fill_(1)
    state.gen_target.fill_(gen)
    state.active.fill_(True)
    state.seq_ids = torch.arange(b, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    state = run_scan(decode_fn, params, state, gen - 1)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return state.out_tokens.cpu().numpy(), {"t_prefill": t_prefill, "t_decode": t_decode}


def run_continuous(cfg: ModelConfig, params: Dict, prompts: np.ndarray, budgets, batch: int,
                   temperature: float = 0.0, decode_chunk: int = 8,
                   use_flash: bool = False, seed: int = 0, telemetry=None):
    """Stream ``len(prompts)`` requests through ``batch`` slots.
    -> (finished list, {"t_total": s, "tokens": n, "compiles": {...}}).
    ``telemetry`` (a :class:`~repro_torch.obs.TelemetrySink`) takes the
    engine's events."""
    n, p = prompts.shape
    gmax = int(max(budgets))
    scfg = ServeConfig(batch=batch, cache_len=p + gmax, max_new=gmax,
                       temperature=temperature, decode_chunk=decode_chunk,
                       use_flash=use_flash)
    eng = ServeEngine(cfg, scfg, params, prompt_len=p, seed=seed, telemetry=telemetry)
    _sync(eng.device)
    t0 = time.perf_counter()
    for i in range(n):
        eng.submit(np.asarray(prompts[i]), int(budgets[i]))
    finished = eng.run()
    _sync(eng.device)
    t_total = time.perf_counter() - t0
    tokens = sum(len(f.tokens) for f in finished)
    return finished, {"t_total": t_total, "tokens": tokens, "compiles": eng.compile_counts()}


def serve(args) -> Optional[np.ndarray | List[Finished]]:
    device = resolve_device(args.device)
    cfg, params = build_model(args.arch, args.seed, args.full_width, device)
    b, p, g = args.batch, args.prompt_len, args.gen
    rng = np.random.default_rng(args.seed)
    width = "full width" if args.full_width else "reduced"
    print(f"arch={args.arch} ({width}, {cfg.dtype}) batch={b} prompt={p} gen={g} on {device}")

    # the trace spans the whole run; the sink closes however the run ends
    with contextlib.ExitStack() as stack:
        stack.enter_context(obs_tracing_lib.trace(args.profile_dir))
        sink = None
        if args.telemetry:
            sink = stack.enter_context(TelemetrySink(args.telemetry))
            sink.write_manifest(
                config={"arch": args.arch, "batch": b, "prompt_len": p, "gen": g,
                        "temperature": args.temperature, "use_flash": bool(args.flash), "seed": args.seed,
                        "full_width": bool(args.full_width)},
                extra={"mode": "serve"}, device=device,
            )

        if args.continuous:
            n = args.requests or 2 * b
            all_prompts = rng.integers(0, cfg.vocab_size, size=(n, p), dtype=np.int32)
            budgets = rng.integers(max(1, g // 4), g + 1, size=n) if args.mixed else np.full(n, g)
            finished, stats = run_continuous(
                cfg, params, all_prompts, budgets, b, temperature=args.temperature,
                use_flash=args.flash, seed=args.seed, telemetry=sink,
            )
            print(f"continuous: {len(finished)} seqs, {stats['tokens']} generated "
                  f"tokens in {stats['t_total']*1e3:.1f} ms "
                  f"({stats['tokens']/stats['t_total']:,.0f} tok/s aggregate)")
            print(f"compiled programs: {stats['compiles']}")
            if sink is not None:
                print(f"telemetry -> {args.telemetry} (render with "
                      f"`python -m repro_torch.analysis.report {args.telemetry}`)")
            return finished

        prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(b, p), dtype=np.int32), device=device)
        if args.scan:
            gen_toks, t = run_scan_mode(cfg, params, prompts, g, temperature=args.temperature,
                                        use_flash=args.flash, seed=args.seed)
            mode = "scan"
        else:
            if args.temperature:
                raise SystemExit("--temperature requires --scan or --continuous "
                                 "(the legacy oracle is greedy-only)")
            gen_toks, t = run_legacy(cfg, params, prompts, g)
            mode = "legacy"
        if sink is not None:
            # the batch modes have no admission queue: one summary event
            sink.emit("serve_summary", mode=mode, t_prefill_s=t["t_prefill"], t_decode_s=t["t_decode"],
                      tokens=b * g, decode_tok_s=b * (g - 1) / max(t["t_decode"], 1e-9))
            print(f"telemetry -> {args.telemetry}")

    print(f"prefill: {t['t_prefill']*1e3:.1f} ms "
          f"({b*p/t['t_prefill']:,.0f} prompt tok/s, +{b} sampled)")
    print(f"decode[{mode}]: {t['t_decode']*1e3:.1f} ms "
          f"({b*(g-1)/max(t['t_decode'], 1e-9):,.0f} tok/s)")
    print(f"generated total: {b*g} tokens")
    print("sample tokens:", gen_toks[0, :16].tolist())

    if args.check:
        if args.temperature:
            raise SystemExit("--check compares against the greedy oracle; drop --temperature")
        oracle, _ = run_legacy(cfg, params, prompts, g)
        if not (gen_toks == oracle).all():
            raise SystemExit("parity FAILED: scan tokens != legacy tokens")
        print("parity OK: scan tokens bit-identical to legacy loop")
    return gen_toks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_NAMES, default="smollm-360m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scan", action="store_true", help="engine decode loop")
    ap.add_argument("--continuous", action="store_true", help="slot-based continuous batching")
    ap.add_argument("--requests", type=int, default=0,
                    help="continuous mode: total requests (default 2*batch)")
    ap.add_argument("--mixed", action="store_true",
                    help="continuous mode: budgets drawn in [gen // 4, gen]")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--flash", action="store_true",
                    help="route attention through K5/K6 and the RWKV-6 time mix through K7")
    ap.add_argument("--check", action="store_true",
                    help="assert scan tokens match the legacy oracle")
    ap.add_argument("--telemetry", default=None, metavar="PATH",
                    help="write the run's manifest and serving events as JSONL to PATH")
    ap.add_argument("--profile-dir", default=None, metavar="PATH",
                    help="trace the run with torch.profiler into a Chrome trace (*.pt.trace.json) in PATH")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--full-width", action="store_true",
                    help="the arch's own widths and dtypes instead of the reduced fp32 model")
    return serve(ap.parse_args(argv))


if __name__ == "__main__":
    main()
