"""Training launcher: federated LM clients selected by FL-DP³S, or a plain
pretrain loop.

    PYTHONPATH=src python -m repro_torch.launch.train --mode fl \\
        --arch smollm-360m --full-width --flash --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --mode pretrain \\
        --arch smollm-360m --steps 200 --device cpu

``--mode fl`` runs Algorithm 1 over topic-skewed LM clients: every client
profiled once with the fresh global model (mean final hidden of up to 8
docs), the eq.-(14) kernel over the profiles (K1 + K2), then per round a
k-DPP cohort, local SGD on each cohort client, FedAvg, and the refresh of
the cohort's losses over their whole shards.  ``--mode pretrain`` runs
optimizer steps (the arch's optimizer, global-norm clip 1.0) on random
batches of a topic-mixed corpus.

Without ``--full-width`` the model is the arch's ``reduced`` variant in
fp32; with it, the arch's own widths, depth and dtypes.  Weights are random
from ``--seed``.  ``--flash`` routes the attention of every pass that takes
no gradient (the loss refresh) through K6; gradient passes keep the plain
attention, since K6 is forward-only.  ``--device`` defaults to ``cuda`` and
raises without a card.  In ``--mode fl``, ``--scenario`` draws each round's
client latencies (and, for ``flaky``, an availability mask the cohort is
drawn within) and prints the simulated wall clock, and ``--candidate-frac``
funnels the federation to its Q top-scored clients, whose (Q, Q) kernel the
k-DPP draws from.  ``--faults`` injects a fault model's client failures,
``--aggregator`` picks the robust aggregation that screens them, and
``--local-algo`` (with ``--prox-mu`` or ``--feddyn-alpha``) the clients'
objective.  With ``--ckpt DIR --ckpt-every N`` the whole server state is
saved every N rounds, and a relaunch resumes from the latest snapshot and
runs only the rounds left; ``--ckpt`` alone saves the final params (in
``--mode pretrain`` the params and the optimizer state).  ``--telemetry
PATH`` writes the run's manifest and one ``fl_round`` event a round (with
the per-round diagnostics of ``FLConfig.telemetry``) as JSONL, which
``python -m repro_torch.analysis.report PATH`` renders, and
``--profile-dir DIR`` traces the rounds with ``torch.profiler`` into a
Chrome trace there; both only in ``--mode fl``.

``--shard-clients N`` runs the federation on a client mesh of N
``torch.distributed`` ranks (``launch/mesh.py``; one thread a rank, rank r
on ``cuda:r`` over NCCL, or all on the CPU over gloo with ``--device
cpu``), each holding ``--clients / N`` resident clients; rank 0 prints and
writes the telemetry, and each rank keeps its own snapshots under
``--ckpt``.  ``--cohort-cap`` trains at most that many cohort clients a
rank, and ``--staleness-bound`` (with ``--scenario``,
``--staleness-decay`` and ``--staleness-alpha``) lets a rank that misses
the scenario's deadline contribute stale work; both need
``--shard-clients``, as JAX's launcher.

Every arch of the registry trains in both modes.  ``--layers N`` (with
``--full-width``) keeps the first N layers of the published config, a
multiple of its block pattern's length: one card holds neither the large
archs whole nor the C_p updated copies a round keeps of them.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import optim as optim_lib
from repro_torch.checkpoint import latest_step, save
from repro_torch.configs import ARCH_NAMES, get_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.core.selection import make_strategy
from repro_torch.data import make_token_dataset
from repro_torch.device import resolve_device
from repro_torch.fl import engine as engine_lib
from repro_torch.fl import rounds as rounds_lib
from repro_torch.fl.faults import AGGREGATORS, FAULT_NAMES
from repro_torch.fl.local_algos import ALGO_NAMES
from repro_torch.fl.scenarios import SCENARIO_NAMES
from repro_torch.fl.staleness import DECAY_FAMILIES
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.serve import build_model
from repro_torch.models import transformer as T
from repro_torch.obs import TelemetrySink
from repro_torch.obs import tracing as obs_tracing_lib
from repro_torch.tree import tree_map

__all__ = ["main", "parse_args", "pretrain_optimizer", "run_fl", "run_pretrain"]


def pretrain_optimizer(cfg: ModelConfig, name: str, lr: float) -> optim_lib.Optimizer:
    """The pretrain optimizer ``name`` as the JAX package steps it on its
    layer-stacked params: adafactor factors its second moments and clips
    its RMS over each pattern entry's layers as one leaf
    (``transformer.layer_groups``); sgd and adam are elementwise, and step
    the port's own leaves."""
    if name == "adafactor":
        return optim_lib.adafactor(lr, groups=lambda tree: T.layer_groups(cfg, tree))
    return getattr(optim_lib, name)(lr)


def _token_clients(cfg, num_clients, docs_per_client, seq, seed=0):
    """Topic-skewed client corpora (ξ=1-style: one topic per client)."""
    docs, topics = make_token_dataset(
        n_docs=num_clients * docs_per_client * 2,
        doc_len=seq,
        vocab=min(cfg.vocab_size, 512),
        num_topics=min(10, num_clients),
        seed=seed,
    )
    clients = []
    for c in range(num_clients):
        topic = c % min(10, num_clients)
        idx = np.nonzero(topics == topic)[0][:docs_per_client]
        clients.append(docs[idx])
    return np.stack(clients)  # (C, docs, seq)


def run_fl(
    args, model: Optional[Tuple[ModelConfig, Dict]] = None
) -> Tuple[engine_lib.ServerState, Dict[str, torch.Tensor]]:
    """Federated LM training through the engine -> (final state, per-round
    outputs stacked over rounds, with the host seconds of each round's
    selection, local updates and loss refresh, and with ``--telemetry``
    each round's ``telemetry``; empty when a resumed run has no round
    left).  ``model`` (config, params on the device) trains in place of the
    random model the flags describe.  With ``--shard-clients`` rank 0's
    state and outputs (every rank's outputs are the same)."""
    if args.ckpt_every is not None and not args.ckpt:
        raise SystemExit("--ckpt-every requires --ckpt DIR")
    ranks = args.shard_clients
    if ranks:
        if args.clients % ranks:
            raise SystemExit(f"--clients={args.clients} must be divisible by --shard-clients={ranks}")
    elif args.cohort_cap is not None:
        raise SystemExit("--cohort-cap requires --shard-clients")
    elif args.staleness_bound is not None:
        raise SystemExit("--staleness-bound requires --shard-clients")
    if not ranks:
        return _run_fl(args, model, None)
    return mesh_lib.run_ranks(ranks, lambda mesh: _run_fl(args, model, mesh), args.device)[0]


def _run_fl(args, model, mesh) -> Tuple[engine_lib.ServerState, Dict[str, torch.Tensor]]:
    """:func:`run_fl` on one device, or as one rank of ``mesh``."""
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    device = resolve_device(args.device) if mesh is None else mesh.device
    spec = get_arch(args.arch)
    if model is None:
        cfg, params = build_model(args.arch, args.seed, args.full_width, device, layers=args.layers)
    else:
        cfg, params = model[0], tree_map(lambda x: x.to(device), model[1])
    clients = _token_clients(cfg, args.clients, args.docs_per_client, args.seq)
    c, n_docs, _ = clients.shape
    num_topics = min(10, args.clients)
    # per-doc topic labels (one topic per client): the engine's GEMD then
    # measures how topic-representative each selected cohort is
    topics = np.stack([np.full((n_docs,), ci % num_topics, np.int32) for ci in range(c)])

    # Alg. 1 init: profile every client once (plain attention, as in JAX)
    xs = torch.as_tensor(clients, device=device)
    with torch.no_grad():
        profiles = torch.stack(
            [T.features(cfg, params, xs[ci, : min(8, n_docs)])[1].float().mean(0) for ci in range(c)]
        )
    strategy = make_strategy(args.selection)

    # topics only feed GEMD; K6 only where no gradient is taken
    def loss_fn(p, x, y):
        return T.lm_loss(cfg, p, x, use_flash=args.flash and not torch.is_grad_enabled())

    flcfg = engine_lib.FLConfig(
        num_clients=c,
        clients_per_round=args.per_round,
        local_batch_size=args.local_batch,
        local_steps=args.local_steps,
        sample_with_replacement=True,
        lr=spec.fl.lr,
        rounds=args.rounds,
        eval_every=max(args.log_every, 1),
        num_classes=num_topics,
        seed=args.seed,
        cohort_cap=args.cohort_cap,
        staleness_bound=args.staleness_bound,
        staleness_decay=args.staleness_decay,
        staleness_alpha=args.staleness_alpha,
        scenario=args.scenario,
        candidate_frac=args.candidate_frac,
        faults=args.faults,
        aggregator=args.aggregator,
        ckpt_every=args.ckpt_every,
        local_algo=args.local_algo,
        prox_mu=args.prox_mu,
        feddyn_alpha=args.feddyn_alpha,
        telemetry=args.telemetry is not None,
    )
    # the run's events; the sink closes however the run ends
    with contextlib.ExitStack() as stack:
        sink = None
        if args.telemetry and lead:
            sink = stack.enter_context(TelemetrySink(args.telemetry))
            sink.write_manifest(
                config=dataclasses.asdict(flcfg), device=device, mesh=mesh,
                extra={"mode": "fl", "arch": args.arch, "selection": args.selection},
            )
        state = engine_lib.init_server_state(
            flcfg, params, xs, topics, profiles, torch.ones((c,), device=device), strategy, device=device,
            loss_fn=loss_fn, mesh=mesh,
        )
        tag = f"[fl:{args.selection}]"
        if mesh is not None:
            cap = "" if flcfg.cohort_cap is None else f", cohort cap {min(flcfg.cohort_cap, c // mesh.size)}"
            stale = "" if flcfg.staleness_bound is None else (
                f", staleness bound {flcfg.staleness_bound} ({flcfg.staleness_decay}, alpha {flcfg.staleness_alpha})"
            )
            say(f"{tag} client mesh: {mesh.size} ranks over {mesh.backend}, {c // mesh.size} resident clients "
                f"a rank{cap}{stale}")
        if flcfg.candidate_frac is not None:
            say(f"{tag} funnel: C={c} -> Q={flcfg.candidate_count()} candidates "
                f"(kernel {tuple(state.kernel.shape)})")
        round_fn = engine_lib.make_round_fn(flcfg, loss_fn, (strategy,), mesh=mesh)
        # crash-resume: with --ckpt-every the directory holds whole-state
        # snapshots (on a mesh, each rank's own), so a relaunch continues from
        # the latest and runs only the rounds left, as the uninterrupted run
        # would have
        checkpointed = flcfg.ckpt_every is not None
        start = 0
        if checkpointed:
            step = latest_step(engine_lib.rank_dir(args.ckpt, state))
            if step is not None:
                state = engine_lib.restore_server_state(args.ckpt, state, step=step)
                start = state.round
                say(f"{tag} resumed round {start} from {engine_lib.rank_dir(args.ckpt, state)}/step_{step:08d}")
        remaining = max(args.rounds - start, 0)
        with obs_tracing_lib.trace(args.profile_dir if lead else None):
            state, outs = engine_lib.run_checkpointed(
                round_fn, state, remaining, ckpt_dir=args.ckpt, ckpt_every=flcfg.ckpt_every, sink=sink,
            )
        for i in range(remaining):
            t = int(outs["round"][i])
            if t % args.log_every == 0 or t == args.rounds:
                say(f"{tag} round {t:4d} sel={outs['selected'][i].tolist()} "
                    f"loss={float(outs['loss'][i]):.4f} gemd={float(outs['gemd'][i]):.3f}")
                say(f"{tag} round {t:4d} seconds: selection {float(outs['t_select'][i]):.4f} "
                    f"local updates {float(outs['t_local'][i]):.4f} "
                    f"refresh {float(outs['t_refresh'][i]):.4f}")
        if flcfg.guarded() and remaining:
            # identity rounds and all-corrupt cohorts report NaN round losses
            surv, losses = outs["survivors"].double(), outs["loss"].double()
            finite = losses[torch.isfinite(losses)]
            best = f"{float(finite.min()):.4f}" if finite.numel() else "n/a (no finite round losses)"
            say(f"{tag} faults={flcfg.faults or 'none'} aggregator={flcfg.aggregator}: "
                f"mean survivors {float(surv.mean()):.1f}/{args.per_round}, "
                f"flagged {int(outs['flagged'].sum())}, "
                f"identity rounds {int(outs['identity_round'].sum())}, best finite loss {best}")
        if "sim_time" in outs:
            sim = outs["sim_time"].double()
            mode = "bounded-staleness" if flcfg.staleness_bound is not None else "synchronous barrier"
            say(f"{tag} scenario={args.scenario} ({mode}): simulated wall clock "
                f"{float(sim.sum()):.2f} (mean round {float(sim.mean()):.2f})")
        if "staleness" in outs:
            say(f"{tag} mean staleness a round {[round(float(v), 3) for v in outs['staleness']]}")
        if args.ckpt and not checkpointed and lead:
            # the final params alone; with --ckpt-every the directory already
            # holds whole-state snapshots
            save(args.ckpt, args.rounds, state.params)
            say(f"checkpoint -> {args.ckpt}")
        if sink is not None:
            n_ev = sum(sink.event_counts.values())
            say(f"{tag} telemetry -> {args.telemetry} ({n_ev} events; render with "
                f"`python -m repro_torch.analysis.report {args.telemetry}`)")
    return state, outs


def run_pretrain(
    args, model: Optional[Tuple[ModelConfig, Dict]] = None
) -> Tuple[Dict, object, List[Dict[str, float]]]:
    """Optimizer steps on random batches -> (params, optimizer state, one
    record per logged step: step, loss, host seconds since the first step
    began, tokens/s so far).  ``model`` as in :func:`run_fl`."""
    fl_only = [flag for flag, on in (("--shard-clients", bool(args.shard_clients)),
                                     ("--cohort-cap", args.cohort_cap is not None),
                                     ("--staleness-bound", args.staleness_bound is not None),
                                     ("--staleness-decay", args.staleness_decay != "polynomial"),
                                     ("--staleness-alpha", args.staleness_alpha != 0.5),
                                     ("--scenario", args.scenario is not None),
                                     ("--candidate-frac", args.candidate_frac is not None),
                                     ("--faults", args.faults is not None),
                                     ("--aggregator", args.aggregator != "mean"),
                                     ("--local-algo", args.local_algo != "fedavg"),
                                     ("--prox-mu", args.prox_mu is not None),
                                     ("--feddyn-alpha", args.feddyn_alpha is not None),
                                     ("--ckpt-every", args.ckpt_every is not None),
                                     ("--telemetry", args.telemetry is not None),
                                     ("--profile-dir", args.profile_dir is not None)) if on]
    if fl_only:
        # the JAX launcher ignores them in pretrain; the port refuses them
        raise ValueError(f"{', '.join(fl_only)} select federation features: use --mode fl")
    if args.flash:
        raise NotImplementedError(
            "--flash has no pass to route in --mode pretrain: every pass takes a "
            "gradient, and K6 is forward-only (the TPU kernel has no VJP either)"
        )
    device = resolve_device(args.device)
    spec = get_arch(args.arch)
    cfg, params = model or build_model(args.arch, args.seed, args.full_width, device, layers=args.layers)
    opt = pretrain_optimizer(cfg, spec.optimizer, args.lr)
    opt_state = opt.init(params)
    docs, _ = make_token_dataset(
        n_docs=4096, doc_len=args.seq, vocab=min(cfg.vocab_size, 512), seed=args.seed
    )
    docs = torch.as_tensor(docs, device=device)
    step = rounds_lib.build_fedsgd_step(
        lambda p, batch: T.lm_loss(cfg, p, batch["tokens"]), opt, grad_clip=1.0
    )
    rng = np.random.default_rng(args.seed)
    history: List[Dict[str, float]] = []
    t0 = time.perf_counter()
    for i in range(1, args.steps + 1):
        idx = torch.as_tensor(rng.integers(0, len(docs), size=args.local_batch), device=device)
        params, opt_state, loss = step(params, opt_state, {"tokens": docs[idx]})
        if i % args.log_every == 0 or i == args.steps:
            loss_v = float(loss)  # waits for the step on the device
            sec = time.perf_counter() - t0
            tps = i * args.local_batch * args.seq / sec
            history.append({"step": i, "loss": loss_v, "seconds": sec, "tok_s": tps})
            print(f"[pretrain] step {i:5d} loss={loss_v:.4f} tok/s={tps:,.0f}")
    if args.ckpt:
        save(args.ckpt, args.steps, {"params": params, "opt": opt_state})
        print(f"checkpoint -> {args.ckpt}")
    return params, opt_state, history


def parse_args(argv=None) -> argparse.Namespace:
    """The launcher's flags -> the namespace ``run_fl`` and ``run_pretrain``
    take."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_NAMES, default="smollm-360m")
    ap.add_argument("--mode", choices=("fl", "pretrain"), default="fl")
    ap.add_argument("--selection", default="fl-dp3s")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--per-round", type=int, default=4)
    ap.add_argument("--docs-per-client", type=int, default=16)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--local-batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--full-width", action="store_true",
                    help="the arch's own widths, depth and dtypes instead of the reduced fp32 model")
    ap.add_argument("--layers", type=int, default=None,
                    help="with --full-width: the first N layers of the published config, a "
                         "multiple of its block pattern's length")
    ap.add_argument("--flash", action="store_true",
                    help="route the attention of gradient-free passes (the loss refresh) through K6")
    ap.add_argument("--scenario", choices=SCENARIO_NAMES, default=None,
                    help="--mode fl: per-client latency model and optional availability mask; "
                         "prices a simulated round wall clock")
    ap.add_argument("--candidate-frac", type=float, default=None,
                    help="--mode fl: the funnel's fraction of clients kept as candidates, in (0, 1]")
    ap.add_argument("--faults", choices=FAULT_NAMES, default=None,
                    help="--mode fl: fault-injection model (client dropout, NaN/garbage/sign-flip "
                         "corruption, shard blackout)")
    ap.add_argument("--aggregator", choices=AGGREGATORS, default="mean",
                    help="--mode fl: mean (eq. 6), clipped_mean (norm-clip outliers to the cohort "
                         "median's threshold), trimmed_mean (reject outliers)")
    ap.add_argument("--local-algo", choices=ALGO_NAMES, default="fedavg",
                    help="--mode fl: fedavg (plain SGD), fedprox (proximal drift penalty), "
                         "feddyn (per-client linear-penalty state)")
    ap.add_argument("--prox-mu", type=float, default=None,
                    help="fedprox's proximal coefficient (needs --local-algo fedprox)")
    ap.add_argument("--feddyn-alpha", type=float, default=None,
                    help="feddyn's penalty coefficient (needs --local-algo feddyn)")
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="--mode fl: save the whole server state to --ckpt every N rounds; a "
                         "relaunch resumes from the latest snapshot (needs --ckpt)")
    ap.add_argument("--ckpt", default=None, metavar="DIR",
                    help="checkpoint directory; without --ckpt-every the final params (and, "
                         "in --mode pretrain, the optimizer state) are saved there")
    ap.add_argument("--telemetry", default=None, metavar="PATH",
                    help="--mode fl: write the run's manifest and per-round diagnostics as JSONL to "
                         "PATH (turns on FLConfig.telemetry)")
    ap.add_argument("--profile-dir", default=None, metavar="PATH",
                    help="--mode fl: trace the rounds with torch.profiler into a Chrome trace "
                         "(*.pt.trace.json) in PATH")
    ap.add_argument("--shard-clients", type=int, default=0,
                    help="--mode fl: run the federation on a client mesh of N ranks (one thread a rank; "
                         "NCCL on the cards, gloo with --device cpu), --clients / N resident clients a rank")
    ap.add_argument("--cohort-cap", type=int, default=None,
                    help="capacity slots: at most N cohort clients trained a rank (requires "
                         "--shard-clients; >= min(--per-round, clients / ranks))")
    ap.add_argument("--staleness-bound", type=int, default=None,
                    help="bounded staleness: the most rounds a rank may lag (requires --shard-clients and "
                         "--scenario; 0 is the synchronous round)")
    ap.add_argument("--staleness-decay", choices=DECAY_FAMILIES, default="polynomial",
                    help="the decay family weighing stale contributions")
    ap.add_argument("--staleness-alpha", type=float, default=0.5,
                    help="the decay rate of the polynomial and exponential families")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    return (run_fl if args.mode == "fl" else run_pretrain)(args)


if __name__ == "__main__":
    main()
