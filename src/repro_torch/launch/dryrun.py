"""Dry run: one step of each (arch × input shape) at full width on fake
tensors, and what it would take on one H100, without running it.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k --reduced
    PYTHONPATH=src python -m repro_torch.launch.dryrun --sweep --out build/dryrun.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --serve-engine

The step is the port's own code path on tensors that have shapes and
dtypes but no storage (``torch._subclasses.fake_tensor.FakeTensorMode``):
a Mode-A round (``fl/rounds.build_client_parallel_round``: 16 clients,
the arch's ``local_steps`` and micro-batches), a Mode-B step
(``build_fedsgd_step`` with the arch's optimizer as the JAX package steps
it), a prefill or a decode step (through K5 and K7, as the serving path
takes them).  Each record holds:

* ``params``; ``argument_bytes`` (params, optimizer state, batch, client
  weights, caches) and ``output_bytes``;
* ``peak_bytes``: the arguments plus the most bytes the step holds live
  beside them (``analysis/ops.StepCounter``: each result's storage added
  when made, dropped when freed, and the buffers a kernel on the card
  allocates for itself, ``analysis/ops.card_temporaries``) plus cuBLAS's
  workspaces (``workspace_bytes``: one for each thread that runs a
  matmul), as a process that runs the step alone holds them;
* ``flops``: the step's matmul FLOPs by ``FlopCounterMode``'s formulas plus the
  model kernels' analytic FLOPs (``kernel_flops``: a kernel's wrapper on
  fake tensors launches nothing and records its count), and
  ``bytes_moved``, every op's argument and result bytes;
* ``ops``, the aten-op histogram (``analysis/ops.op_histogram``);
* ``fits_one_card`` and ``cards_needed`` on the card named in ``card``.

Counting a full-width step op by op on fake tensors would take hours (16
clients × E steps × micro-batches of passes through every layer), so the
counts are exact extrapolations: the repeat units of a config are
identical, so the step is counted at two and at three units and every
count (ops, FLOPs, bytes, kernel calls, peak) is taken as ``C + R·B`` for
R units, as the JAX package's ``_accounting_counts`` does from one and
two (here one unit is not on the line: ``count_step``); and the gradient
of a loss is counted once per input signature and replayed for every
later client, step and micro-batch of the same shapes (``_GradMemo``).
The tests hold both against the direct count.

``--serve-engine`` runs ``ServeEngine`` (scan decode and continuous
admission) on reduced archs on real CPU tensors, since the engine reads
back to the host, and reports its shape signatures: one per entry point.
``--multi-pod``, ``--both-meshes`` and ``--fl-sharded`` need a mesh or
``shard_map`` and are refused (ROADMAP Queue 1 item 15).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.analysis.ops import StepCounter, tensor_bytes
from repro_torch.analysis.roofline import HW
from repro_torch.configs import ARCH_NAMES, ArchSpec, ModelConfig, get_arch
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.fl import rounds as rounds_lib
from repro_torch.kernels import _build
from repro_torch.launch.train import pretrain_optimizer
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves, tree_unflatten

__all__ = [
    "DryRunCase", "SHAPE_NAMES", "arguments", "build_step", "case_config", "count_step", "main", "run_case",
    "run_serve_engine_case",
]

SHAPE_NAMES = list(INPUT_SHAPES)
N_CLIENTS = 16  # Mode A's clients a round: the JAX package's single-pod data axis


@dataclasses.dataclass
class DryRunCase:
    arch: str
    shape: str
    reduced: bool = False
    scan_rounds: int = 1  # > 1: N Mode-A rounds in one step, batches stacked (N, ...)
    use_flash: bool = True  # serving through K5 and K7, as the serving path runs
    batch: Optional[int] = None  # the shape's global batch unless given
    clients: int = N_CLIENTS  # Mode A's clients a round
    local_steps: Optional[int] = None  # Mode A's local steps, the arch's unless given


def case_config(case: DryRunCase) -> Tuple[ArchSpec, ModelConfig, Dict]:
    spec = get_arch(case.arch)
    ishape = INPUT_SHAPES[case.shape]
    cfg = spec.long_context_model() if case.shape == "long_500k" else spec.model
    dims = dict(seq=ishape.seq_len, batch=ishape.global_batch, kind=ishape.kind)
    if case.reduced:
        cfg = cfg.reduced(param_dtype="bfloat16", dtype="bfloat16")
        dims.update(
            seq=min(dims["seq"], 128),
            batch=max(min(dims["batch"], 8), N_CLIENTS) if ishape.global_batch > 1 else 1,
        )
    if case.batch is not None:
        dims["batch"] = case.batch
    return spec, cfg, dims


def _micro(requested: int, batch: int) -> int:
    """The largest micro-batch count <= ``requested`` that divides ``batch``."""
    micro = max(1, min(requested, batch))
    while batch % micro:
        micro -= 1
    return micro


# ------------------------------------------------------------ step builders


def build_step(
    case: DryRunCase, device="cpu", cfg: Optional[ModelConfig] = None, wrap_loss: Callable = lambda f: f,
) -> Tuple[Callable, tuple, Dict]:
    """``(step, args, info)`` of ``case``: ``step(*args)`` is the port's step
    on tensors made on ``device`` (random, from seed 0; fake ones under
    ``FakeTensorMode``).  ``cfg`` replaces the case's model config (the
    dry run's unit-cut copies); ``wrap_loss`` wraps the training loss."""
    spec, case_cfg, dims = case_config(case)
    cfg = cfg or case_cfg
    b, s = dims["batch"], dims["seq"]
    gen = torch.Generator(device=device).manual_seed(0)
    params = T.init_params(gen, cfg, device)
    vlm = cfg.arch_type == "vlm"  # the frontend stub feeds embeddings

    def inputs(lead: Tuple[int, ...]) -> tuple:
        if vlm and dims["kind"] != "decode":
            embeds = torch.randn(lead + (s, cfg.d_model), generator=gen, device=device).to(torch.bfloat16)
            if dims["kind"] == "prefill":
                return (embeds,)
            return embeds, torch.randint(0, cfg.vocab_size, lead + (s,), generator=gen, device=device, dtype=torch.int32)
        width = 1 if dims["kind"] == "decode" else s
        return (torch.randint(0, cfg.vocab_size, lead + (width,), generator=gen, device=device, dtype=torch.int32),)

    info: Dict = {"kind": dims["kind"], "batch": b, "seq": s, "dtype": cfg.dtype}
    if dims["kind"] == "train":

        def raw_loss(p, batch):
            if vlm:
                return T.lm_loss(cfg, p, embeds=batch[0], targets=batch[1])
            return T.lm_loss(cfg, p, batch[0])

        loss = wrap_loss(raw_loss)
        if spec.fl.mode == "client_parallel":
            m, steps = case.clients, case.local_steps or spec.fl.local_steps
            local_b = max(1, b // m)
            micro = _micro(spec.fl.micro_batches, local_b)
            round_step = rounds_lib.build_client_parallel_round(loss, spec.fl.lr, steps, micro_batches=micro)
            rounds = case.scan_rounds
            batches = inputs(((rounds,) if rounds > 1 else ()) + (m, steps, local_b))
            weights = torch.ones(m, dtype=torch.float32, device=device)
            info.update(fl_mode=spec.fl.mode, clients=m, local_steps=steps, local_batch=local_b,
                        micro_batches=micro, scan_rounds=rounds)
            if rounds == 1:
                return round_step, (params, batches, weights), info

            def scanned(params, batches, weights):
                losses = []
                for i in range(rounds):  # the engine's host loop over rounds
                    params, l = round_step(params, tuple(x[i] for x in batches), weights)
                    losses.append(l)
                return params, torch.stack(losses)

            return scanned, (params, batches, weights), info
        opt = pretrain_optimizer(cfg, spec.optimizer, spec.fl.lr)
        micro = _micro(spec.fl.micro_batches, b)
        info.update(fl_mode=spec.fl.mode, optimizer=spec.optimizer, micro_batches=micro, scan_rounds=1)
        step = rounds_lib.build_fedsgd_step(loss, opt, micro_batches=micro)
        return step, (params, opt.init(params), inputs((b,))), info

    info.update(fl_mode="serve", scan_rounds=1, use_flash=case.use_flash)
    caches = T.init_caches(cfg, b, s, device=device)
    if dims["kind"] == "prefill":

        def prefill(params, batch, caches):
            positions = torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)
            tokens, embeds = (None, batch[0]) if vlm else (batch[0], None)
            with torch.no_grad():
                hidden, new_caches, _ = T.forward(
                    cfg, params, tokens, T.mrope_streams(cfg, positions), caches, embeds=embeds,
                    use_flash=case.use_flash,
                )
                return T.logits_from_hidden(cfg, params, hidden[:, -1:]), new_caches

        return prefill, (params, inputs((b,)), caches), info

    def decode(params, tokens, caches):
        with torch.no_grad():
            return T.decode_step(cfg, params, tokens, caches, use_flash=case.use_flash)

    return decode, (params, inputs((b,))[0], caches), info


# ------------------------------------------------------------ counting


def _kernel_state() -> Dict[str, Dict[str, float]]:
    return {"calls": dict(_build.FAKE_CALLS), "flops": dict(_build.FAKE_FLOPS), "bytes": dict(_build.FAKE_BYTES)}


def _signature(tensors) -> tuple:
    return tuple((tuple(x.shape), x.dtype) for x in tensors)


class _GradMemo:
    """Counts a loss's gradient once per input signature and replays it.

    ``wrap(loss_fn)`` is the loss the round builders take.  At a new
    signature of (params, batch) it takes the gradient itself, inside a
    window of the counters, and records what they saw from the loss's
    first op to its last gradient: ops, FLOPs, bytes, kernel calls, the
    peak above the live bytes at entry, and which params got none.  It
    returns the loss through an autograd function whose backward hands the
    caller's ``autograd.grad`` those gradients, with the counters muted.
    At a signature it has seen, the function adds the record to the
    counters, raises the peak by the record's, and its backward returns
    fresh gradients of the params' shapes, or none where none came."""

    def __init__(self, counter: StepCounter):
        self.counter = counter
        self.entries: Dict[tuple, Dict] = {}
        self.real = self.replayed = 0

    def wrap(self, loss_fn: Callable) -> Callable:
        def memo_loss(params, batch):
            live = tree_leaves(params)
            if not torch.is_grad_enabled() or not all(x.requires_grad for x in live):
                return loss_fn(params, batch)
            key = (_signature(live), _signature(tree_leaves(batch)))
            entry, grads, loss = self.entries.get(key), None, None
            if entry is None:
                entry, grads, loss = self._record(loss_fn, params, batch, live)
                self.entries[key] = entry
            else:
                self.replayed += 1
            return _Replay.apply(self, entry, grads, loss, *live)

        return memo_loss

    def _record(self, loss_fn, params, batch, live):
        c = self.counter
        ops0, flops0, bytes0, kernels0 = collections.Counter(c.ops), c.flops, c.bytes_moved, _kernel_state()
        live0 = c.window()
        c.muted = True
        inner = [x.detach().requires_grad_(True) for x in live]
        c.muted = False
        loss = loss_fn(tree_unflatten(params, inner), batch)
        grads = torch.autograd.grad(loss, inner, allow_unused=True)
        k1 = _kernel_state()
        entry = dict(
            ops=c.ops - ops0, flops=c.flops - flops0, bytes=c.bytes_moved - bytes0,
            kernels={f: {n: k1[f][n] - kernels0[f][n] for n in k1[f]} for f in k1},
            peak=c.window_peak - live0, unused=tuple(g is None for g in grads), loss_dtype=loss.dtype,
        )
        self.real += 1
        return entry, grads, loss

    def replay(self, entry: Dict) -> None:
        c = self.counter
        c.raise_peak(c.live + entry["peak"])
        c.ops.update(entry["ops"])
        c.bytes_moved += entry["bytes"]
        c.flops += entry["flops"]
        for field, store in (("calls", _build.FAKE_CALLS), ("flops", _build.FAKE_FLOPS), ("bytes", _build.FAKE_BYTES)):
            for name, n in entry["kernels"][field].items():
                store[name] += n


class _Replay(torch.autograd.Function):
    """The memo's loss: forward and backward muted; ``grads`` (from a
    recording call) or fresh ones (a replay) in the backward."""

    @staticmethod
    def forward(ctx, memo, entry, grads, loss, *live):
        memo.counter.muted = True
        if grads is None:
            memo.replay(entry)
            loss = torch.zeros((), dtype=entry["loss_dtype"], device=live[0].device)
        ctx.memo, ctx.entry, ctx.grads = memo, entry, grads
        ctx.metas = [(x.shape, x.dtype, x.device) for x in live]
        return loss.detach()

    @staticmethod
    def backward(ctx, _):
        grads = ctx.grads
        if grads is None:
            grads = tuple(
                None if unused else torch.empty(shape, dtype=dtype, device=device)
                for (shape, dtype, device), unused in zip(ctx.metas, ctx.entry["unused"])
            )
        ctx.grads = None
        ctx.memo.counter.muted = False
        return (None, None, None, None) + tuple(grads)


def _count(case: DryRunCase, cfg: ModelConfig, memoize: bool = True) -> Dict:
    """One step of ``case`` at ``cfg`` on fake tensors, counted."""
    with FakeTensorMode():
        counter = StepCounter()
        memo = _GradMemo(counter)
        step, args, _ = build_step(case, "cpu", cfg, memo.wrap if memoize else (lambda f: f))
        _build.reset_fake_calls()
        counter.hold(args)
        with counter:
            out = step(*args)
        kernels = _kernel_state()
        return dict(
            flops=counter.flops, bytes_moved=counter.bytes_moved,
            step_peak=counter.peak, output_bytes=sum(tensor_bytes(x) for x in tree_leaves(out)),
            ops=dict(counter.ops), kernel_calls=kernels["calls"], kernel_flops=kernels["flops"],
            kernel_bytes=kernels["bytes"], grads_counted=memo.real, grads_replayed=memo.replayed,
        )


def _with_units(cfg: ModelConfig, reps: int) -> ModelConfig:
    n = len(cfg.block_pattern)
    return dataclasses.replace(cfg, num_layers=reps * n + cfg.num_layers % n)


def _extrapolate(c2: Dict, c3: Dict, reps: int) -> Dict:
    """Counts at two and three repeat units -> at ``reps``: ``c2 + (reps −
    2)·(c3 − c2)``, key by key in the histograms and kernel tallies."""

    def f(a, b):
        if isinstance(a, dict):
            return {k: f(a.get(k, 0), b.get(k, 0)) for k in sorted(set(a) | set(b))}
        return a + (reps - 2) * (b - a)

    return {k: f(c2[k], c3[k]) for k in c2}


_WARMED = set()


def _warm(case: DryRunCase) -> None:
    """Run the arch's reduced decode step once per process: the model code
    caches host-side constants on first use (``layers._rounded``), whose
    ops would otherwise be counted in the first count only."""
    if case.arch not in _WARMED:
        _count(DryRunCase(case.arch, "decode_32k", reduced=True), case_config(
            DryRunCase(case.arch, "decode_32k", reduced=True))[1])
        _WARMED.add(case.arch)


def count_step(case: DryRunCase, extrapolate: bool = True, memoize: bool = True) -> Dict:
    """The case's counts at its full depth: counted at two and three
    repeat units and extrapolated when it has more than three
    (``extrapolate``), else counted directly.  From two units on every
    count is affine in the units; one unit is not (the caches' stacked
    positions hold one entry, and a peak can fall elsewhere)."""
    _, cfg, _ = case_config(case)
    reps = cfg.num_layers // len(cfg.block_pattern)
    _warm(case)
    if not extrapolate or reps <= 3:
        return dict(_count(case, cfg, memoize), layer_reps=reps, extrapolated=False)
    out = _extrapolate(_count(case, _with_units(cfg, 2), memoize), _count(case, _with_units(cfg, 3), memoize), reps)
    out["ops"] = {k: v for k, v in out["ops"].items() if v}
    return dict(out, layer_reps=reps, extrapolated=True)


def arguments(case: DryRunCase) -> Dict:
    """The step's setting (``build_step``'s info), its parameter count and
    the bytes of its arguments, at full depth on fake tensors."""
    with FakeTensorMode():
        _, args, info = build_step(case, "cpu")
        return dict(info, params=T.param_count(args[0]),
                    argument_bytes=sum(tensor_bytes(x) for x in tree_leaves(args)))


def run_case(case: DryRunCase, extrapolate: bool = True, memoize: bool = True) -> Dict:
    t0 = time.perf_counter()
    rec: Dict = {"case": "arch", "arch": case.arch, "shape": case.shape, "reduced": case.reduced,
                 "card": HW.NAME}
    try:
        rec.update(arguments(case))
        counts = count_step(case, extrapolate, memoize)
        rec.update(counts)
        rec["flops"] = counts["flops"] + sum(counts["kernel_flops"].values())
        rec["flops_counted"] = counts["flops"]
        rec["bytes_moved"] = counts["bytes_moved"] + sum(counts["kernel_bytes"].values())
        # cuBLAS's workspaces: the calling thread's, and for a step that
        # takes gradients that of autograd's thread for the card
        rec["workspace_bytes"] = HW.CUBLAS_WORKSPACE * (2 if rec["kind"] == "train" else 1)
        rec["peak_bytes"] = rec["argument_bytes"] + counts["step_peak"] + rec["workspace_bytes"]
        rec["n_ops"] = sum(counts["ops"].values())
        rec["card_bytes"] = HW.HBM_BYTES
        rec["fits_one_card"] = rec["peak_bytes"] <= HW.HBM_BYTES
        rec["cards_needed"] = math.ceil(rec["peak_bytes"] / HW.HBM_BYTES)
        rec["ok"] = True
    except Exception as e:
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.perf_counter() - t0, 2)
    return rec


# ----------------------------------------------------- serving engine


def run_serve_engine_case(arch: str, batch: int = 4, prompt: int = 8, gen: int = 8) -> Dict:
    """``ServeEngine`` on a reduced arch on the CPU (real tensors): its scan
    decode over every slot and one continuous admission into a slot freed
    by a harvest (``batch + 1`` requests), through K5 and K7's plain
    versions.  ``ok`` when every request finished with its budget and each
    entry point saw one shape signature (``compile_counts``)."""
    from repro_torch.serve import ServeConfig, ServeEngine

    t0 = time.perf_counter()
    rec: Dict = {"case": "serve_engine", "arch": arch, "batch": batch, "prompt": prompt, "gen": gen}
    try:
        cfg = get_arch(arch).model.reduced(param_dtype="float32", dtype="float32", remat=False)
        scfg = ServeConfig(batch=batch, cache_len=prompt + gen, max_new=gen, use_flash=True)
        params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        engine = ServeEngine(cfg, scfg, params, prompt_len=prompt, seed=0)
        rng = np.random.default_rng(0)
        for _ in range(batch + 1):
            engine.submit(rng.integers(0, cfg.vocab_size, prompt), gen)
        done = engine.run()
        rec["compile_counts"] = engine.compile_counts()
        rec["finished"] = len(done)
        rec["ok"] = len(done) == batch + 1 and all(len(f.tokens) == gen for f in done) and all(
            n == 1 for n in rec["compile_counts"].values()
        )
        if not rec["ok"]:
            rec["error"] = f"finished {len(done)} of {batch + 1}, signatures {rec['compile_counts']}"
    except Exception as e:
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.perf_counter() - t0, 2)
    return rec


# ------------------------------------------------------------------ CLI


def _refuse_unported(args) -> None:
    """Flags that need a mesh or ``shard_map``, with their ROADMAP Queue-1 item."""
    used = [f"{flag} (ROADMAP Queue 1 item 15)" for flag, on in (
        ("--multi-pod", args.multi_pod), ("--both-meshes", args.both_meshes), ("--fl-sharded", args.fl_sharded),
    ) if on]
    if used:
        raise NotImplementedError(f"not ported yet: {', '.join(used)}")


def _append(path: Optional[str], rec: Dict) -> None:
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=SHAPE_NAMES)
    ap.add_argument("--sweep", action="store_true", help="all arch x shapes")
    ap.add_argument("--reduced", action="store_true", help="reduced configs + tiny shapes (CI smoke)")
    ap.add_argument("--scan-rounds", type=int, default=1,
                    help="N Mode-A rounds in one step, batches stacked on a leading (N,) axis")
    ap.add_argument("--serve-engine", action="store_true",
                    help="run ServeEngine's scan decode and continuous admission on reduced archs (CPU)")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--multi-pod", action="store_true", help="not ported (a mesh: ROADMAP Queue 1 item 15)")
    ap.add_argument("--both-meshes", action="store_true", help="not ported (a mesh: ROADMAP Queue 1 item 15)")
    ap.add_argument("--fl-sharded", action="store_true", help="not ported (shard_map: ROADMAP Queue 1 item 15)")
    args = ap.parse_args(argv)
    _refuse_unported(args)

    if args.serve_engine:
        # one cache family each: dense GQA KV, the RWKV state, SWA ring + MoE
        archs = [args.arch] if args.arch else ["smollm-360m", "rwkv6-7b", "mixtral-8x7b"]
        failed = False
        for arch in archs:
            rec = run_serve_engine_case(arch)
            print(f"[{'OK ' if rec['ok'] else 'FAIL'}] serve_engine {arch:28s} b={rec['batch']} p={rec['prompt']} "
                  f"g={rec['gen']} {rec['total_s']:7.1f}s  "
                  + (f"signatures {rec['compile_counts']}" if rec["ok"] else rec["error"][:160]))
            failed |= not rec["ok"]
            _append(args.out, rec)
        if failed:
            raise SystemExit(1)
        return

    if args.sweep:
        pairs = [(a, s) for a in ARCH_NAMES for s in SHAPE_NAMES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --sweep, are required")
        pairs = [(args.arch, args.shape)]
    done = set()
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("ok") and r.get("case") == "arch":
                    done.add((r["arch"], r["shape"], r.get("reduced", False)))
    cases = [DryRunCase(arch, shape, reduced=args.reduced, scan_rounds=args.scan_rounds)
             for arch, shape in pairs if (arch, shape, args.reduced) not in done]
    for arch, shape in pairs:
        if (arch, shape, args.reduced) in done:
            print(f"[skip] {arch} {shape} (in {args.out})")
    jobs = min(len(cases), max(1, (os.cpu_count() or 1) // 2))  # one process a case, on half the host's cores
    if jobs > 1:
        import concurrent.futures
        import multiprocessing

        pool = concurrent.futures.ProcessPoolExecutor(jobs, mp_context=multiprocessing.get_context("spawn"))
        records = pool.map(run_case, cases)
    else:
        pool, records = None, map(run_case, cases)
    failed = False
    for case, rec in zip(cases, records):
        if rec["ok"]:
            fit = "fits one card" if rec["fits_one_card"] else f"needs {rec['cards_needed']} cards"
            print(f"[OK ] {case.arch:28s} {case.shape:12s} {rec['total_s']:7.1f}s  params {rec['params']:.3e}  "
                  f"flops {rec['flops']:.3e}  peak {rec['peak_bytes'] / 2**30:.2f} GiB  {fit}", flush=True)
        else:
            failed = True
            print(f"[FAIL] {case.arch:28s} {case.shape:12s} {rec['total_s']:7.1f}s  {rec['error'][:160]}")
            print(rec.get("traceback", "")[-800:], flush=True)
        _append(args.out, rec)
    if pool is not None:
        pool.shutdown()
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
