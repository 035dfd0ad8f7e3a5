#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. Card and build: prints the card's name and power limit, turns TF32 off
   for matmuls and cuDNN, and builds every CUDA kernel from the sources in
   this checkout (``nvcc`` for ``sm_90a``).
2. Kernels against their plain PyTorch versions on the card, at the
   main-path shape and three larger ones, with the tolerances stated below;
   prints errors and the kernel, plain and library times.
3. The main path: five rounds of FL-DP³S at the paper's scale (C=100
   clients, 10 per round, 600 samples each, CNN (16, 32) with Q=128) through
   ``FLTrainer`` on ``cuda`` with the paper's config as it stands; checks
   that K1 and K2 ran on that path, that each cohort is 10 distinct clients and
   that losses, accuracy and GEMD are finite and in range.
4. Prints one JSON line describing every kernel, then the device line
   ``{"ok": true, "device": {...}}`` last.

It needs no network and imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}  # fp32 on the CUDA cores; bf16 tensor cores

ROUNDS = 5
SHAPES = [  # (C, Q, dtype name): the main-path shape first
    (100, 128, "fp32"),
    (1000, 700, "fp32"),
    (4096, 128, "fp32"),
    (513, 257, "bf16"),
]


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(torch, fn, launches: int = 50, repeats: int = 5, warmup: int = 5) -> float:
    """Device time of one call: CUDA events around ``launches`` calls back
    to back, over their count; the median of ``repeats`` such runs, after
    warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / launches)
    return statistics.median(per_call)


def bound(nbytes: float, flops: float, kind: str):
    """Least time (ms) the card could take: the larger of bytes over the
    memory rate and operations over the peak rate for their type."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import paper_cnn
    from repro_torch.core import selection, similarity
    from repro_torch.data import make_image_dataset, skewness_partition
    from repro_torch.fl import engine, rounds
    from repro_torch.fl.trainer import FLTrainer
    from repro_torch.kernels import _build
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.gram import ref as gram_ref
    from repro_torch.kernels.pairwise_l2 import ops as pw_ops
    from repro_torch.kernels.pairwise_l2 import ref as pw_ref
    from repro_torch.models import cnn

    t_start = time.perf_counter()
    dev = torch.device("cuda")

    # ---------------------------------------------------- 1. card and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}"
    )
    t0 = time.perf_counter()
    logs = _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
    print(f"built {list(_build.SOURCES)} for sm_90a in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # ------------------------------------- 2. kernels against plain versions
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    rows = {"pairwise_dists_stats": {}, "normalized_gram": {}}
    for c, q, kind in SHAPES:
        g = torch.Generator().manual_seed(c * 7919 + q)
        f = torch.randn(c, q, generator=g).to(dtypes[kind]).to(dev)
        compute = dtypes[kind]

        # K1 on its own
        s0, lo, hi = pw_ops.pairwise_dists_stats(f)
        torch.cuda.synchronize()
        ws0, wlo, whi = pw_ref.pairwise_dists_stats_ref(f)
        err1 = float((s0 - ws0).abs().max())
        check(float(lo) == 0.0 and float(wlo) == 0.0, f"K1 lo != 0 at {c}x{q}")
        check(abs(float(hi) - float(whi)) <= 1e-5 * float(whi), f"K1 hi off at {c}x{q}")
        # fp32 sums over Q in another order: ~1e-6 relative on the distances
        check(
            bool(torch.all((s0 - ws0).abs() <= 1e-5 * ws0.abs() + 1e-5 * float(whi))),
            f"K1 S0 off at {c}x{q}: {err1}",
        )

        # K2 on its own, on the same inputs as its plain version
        rng = torch.clamp_min(whi - wlo, 1e-30)
        lk = gram_ops.normalized_gram(ws0, wlo, rng, c, compute)
        torch.cuda.synchronize()
        wl = gram_ref.normalized_gram_ref(ws0, wlo, rng, c, compute)
        err2 = float((lk - wl).abs().max())
        # the same rounded S on both sides; fp32 sums over c terms in another order
        check(err2 <= 1e-5 + 1e-4 * float(wl.abs().max()), f"K2 off at {c}x{q}: {err2}")

        # the two-launch pipeline against the plain chain
        lp = gram_ops.kernel_from_profiles(f)
        torch.cuda.synchronize()
        wp = gram_ref.kernel_from_profiles_ref(f)
        errp = float((lp - wp).abs().max())
        lmax = float(wp.abs().max())
        if kind == "bf16":
            tol = 3e-2 * lmax  # bf16 products vs the fp32 chain: the JAX test's bound
        elif (c, q) == SHAPES[0][:2]:
            tol = None  # main-path shape: rtol 1e-5 / atol 1e-5 elementwise
            check(
                bool(torch.all((lp - wp).abs() <= 1e-5 + 1e-5 * wp.abs())),
                f"L off at {c}x{q}: {errp}",
            )
        else:
            tol = 1e-4 * lmax  # sums over up to 4096 terms in another order
        if tol is not None:
            check(errp <= tol, f"L off at {c}x{q}: {errp} > {tol}")

        # times: wrapper as the main path calls it, its plain version, and
        # one PyTorch call computing the same function where there is one
        k1_ms = time_ms(torch, lambda: pw_ops.pairwise_dists_stats(f))
        k1_plain = time_ms(torch, lambda: pw_ref.pairwise_dists_stats_ref(f))
        k1_lib = time_ms(torch, lambda: torch.cdist(f, f))
        k2_ms = time_ms(torch, lambda: gram_ops.normalized_gram(ws0, wlo, rng, c, compute))
        k2_plain = time_ms(torch, lambda: gram_ref.normalized_gram_ref(ws0, wlo, rng, c, compute))
        s = (1.0 - (ws0 - wlo) / rng).to(compute)
        k2_lib = time_ms(torch, lambda: torch.mm(s.T, s))
        pipe_ms = time_ms(torch, lambda: gram_ops.kernel_from_profiles(f))

        # least work: both outputs are symmetric, so K1 needs one triangle of
        # dot products (c(c-1)/2 of q FMAs, in fp32 whatever F's type) plus
        # the c norms, and K2 one triangle of S^T S (a SYRK, c(c+1)/2 dots
        # of c FMAs) plus three operations to normalise each S0 element
        esize = f.element_size()
        tiles = math.ceil(c / 64)
        b1 = bound(
            c * q * esize + c * c * 4 + 2 * tiles * tiles * 4,
            1.0 * c * (c - 1) * q + 2.0 * c * q, "fp32",
        )
        b2 = bound(c * c * 4 + 8 + c * c * 4, 1.0 * c * c * (c + 1) + 3.0 * c * c, kind)
        rows["pairwise_dists_stats"][(c, q, kind)] = dict(
            max_abs_err=err1, ms=k1_ms, plain_ms=k1_plain, library_ms=k1_lib,
            bound_ms=b1[0], bound_by=b1[1],
        )
        rows["normalized_gram"][(c, q, kind)] = dict(
            max_abs_err=err2, ms=k2_ms, plain_ms=k2_plain, library_ms=k2_lib,
            bound_ms=b2[0], bound_by=b2[1],
        )
        print(
            f"kernels C={c} Q={q} {kind}: "
            f"K1 err={err1:.3e} ms={k1_ms:.5f} plain={k1_plain:.5f} cdist={k1_lib:.5f} "
            f"bound={b1[0]:.6f} ({b1[1]}) | "
            f"K2 err={err2:.3e} ms={k2_ms:.5f} plain={k2_plain:.5f} mm={k2_lib:.5f} "
            f"bound={b2[0]:.6f} ({b2[1]}) | "
            f"pipeline err={errp:.3e} (max|L|={lmax:.4g}) ms={pipe_ms:.5f}"
        )

    # --------------------------------------------------------- 3. main path
    exp = paper_cnn.paper_scale()
    c, cp = exp.num_clients, exp.clients_per_round
    t0 = time.perf_counter()
    ds = make_image_dataset(n=c * exp.samples_per_client, seed=11, noise=0.5)
    shards = skewness_partition(
        ds.ys, c, 0.8, ds.num_classes, samples_per_client=exp.samples_per_client, seed=0
    )
    client_xs = np.stack([ds.xs[s] for s in shards])
    client_ys = np.stack([ds.ys[s] for s in shards])
    print(f"data: {client_xs.shape} images in {time.perf_counter() - t0:.2f} s")

    class RecordingDPP(selection.DPPSelection):
        """FL-DP³S, keeping each round's cohort for the checks below."""

        def __init__(self):
            super().__init__()
            self.cohorts = []

        def draw_fn(self, generator, state, k):
            sel = super().draw_fn(generator, state, k)
            self.cohorts.append(sel.tolist())
            return sel

    strategy = RecordingDPP()
    cfg = paper_cnn.fl_config(exp, seed=0)
    check(cfg.use_pallas_kernel, "the paper config does not route through K1 + K2")
    params = cnn.init_cnn(
        torch.Generator(device=dev).manual_seed(0),
        channels=exp.cnn_channels, fc1_dim=exp.fc1_dim,
    )

    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = FLTrainer(
        cfg, params, cnn.cnn_loss, cnn.apply_with_features, client_xs, client_ys,
        strategy, accuracy_fn=cnn.accuracy,
    )
    torch.cuda.synchronize()
    init_launches = dict(_build.LAUNCHES)
    print(
        f"init (profiles, kernel, losses) on {trainer.device}: "
        f"{time.perf_counter() - t0:.3f} s, launches {init_launches}"
    )
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        hist = trainer.run(rounds=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(
            f"round {hist['round'][-1]}: {wall:.3f} s  cohort={strategy.cohorts[-1]} "
            f"loss={hist['loss'][-1]:.4f} acc={hist['acc'][-1]:.4f} gemd={hist['gemd'][-1]:.4f}"
        )
    launches = dict(_build.LAUNCHES)
    print(f"launches on the main path: {launches}")

    check(trainer.device.type == "cuda", "the trainer did not run on the card")
    for name in launches:
        check(init_launches[name] >= 1, f"{name} did not run during _init_profiles")
    check(len(strategy.cohorts) == ROUNDS, "not one cohort per round")
    for cohort in strategy.cohorts:
        check(
            len(cohort) == cp and len(set(cohort)) == cp and all(0 <= i < c for i in cohort),
            f"bad cohort {cohort}",
        )
    check(hist["round"] == list(range(1, ROUNDS + 1)), f"rounds {hist['round']}")
    check(all(math.isfinite(v) for v in hist["loss"]), f"losses {hist['loss']}")
    check(all(0.0 <= v <= 1.0 for v in hist["acc"]), f"accuracies {hist['acc']}")
    check(all(0.0 <= v <= 2.0 for v in hist["gemd"]), f"GEMDs {hist['gemd']}")
    check(bool(torch.all(torch.isfinite(trainer.losses))), "non-finite client losses")
    kern = trainer.round_state.kernel
    prof = trainer.round_state.profiles
    check(tuple(prof.shape) == (c, exp.fc1_dim) and tuple(kern.shape) == (c, c), "shapes")
    want = gram_ref.kernel_from_profiles_ref(prof)
    exact = similarity.kernel_from_profiles(prof.double())  # plain chain in fp64
    kerr = float((kern - want).abs().max())
    lmax = float(want.abs().max())
    kerr64 = float((kern.double() - exact).abs().max())
    perr64 = float((want.double() - exact).abs().max())
    # FC-1 profiles lie close together relative to their norms, so the plain
    # chain's expansion |a|^2 + |b|^2 - 2ab cancels in fp32 and K1's direct
    # sum of (a - b)^2 does not: the two differ by about 1e-5 of max|L|
    # here, and the bound of the larger shapes above applies.  The kernel
    # must be no further from an fp64 chain than the plain chain is.
    check(kerr <= 1e-4 * lmax, f"kernel off: {kerr} > 1e-4 * {lmax}")
    check(kerr64 <= perr64, f"kernel {kerr64} further from fp64 than the plain chain {perr64}")
    print(
        f"main-path kernel vs plain chain: max abs err {kerr:.3e} (max|L|={lmax:.4g}); "
        f"vs fp64 chain: kernel {kerr64:.3e}, plain {perr64:.3e}"
    )

    # where a round's time goes: its three parts once more, each timed on
    # the host clock up to a synchronise, after the run (no kernel launches)
    def host_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    t_sel, sel = host_s(lambda: strategy.draw_fn(trainer.generator, trainer.selection_state(), cp))
    step = rounds.build_client_parallel_round(
        lambda p, batch: cnn.cnn_loss(p, batch[0], batch[1]), cfg.lr, cfg.local_epochs
    )
    batches = engine.make_client_batches(cfg, trainer.generator, trainer.client_xs, trainer.client_ys, sel)
    t_local, _ = host_s(lambda: step(trainer.params, batches, trainer.client_sizes[sel.long()]))
    xs_all = trainer.client_xs.reshape((-1,) + trainer.client_xs.shape[2:])
    t_eval, _ = host_s(lambda: cnn.accuracy(trainer.params, xs_all, trainer.client_ys.reshape(-1)))
    print(
        f"round parts (host clock): k-DPP draw {t_sel:.4f} s, local updates of "
        f"{cp} clients {t_local:.4f} s, accuracy over {xs_all.shape[0]} samples {t_eval:.4f} s"
    )

    # ---------------------------------------------------------- 4. results
    main_shape = SHAPES[0]
    sources = {
        "pairwise_dists_stats": (
            "src/repro_torch/kernels/csrc/pairwise_l2.cu",
            "src/repro/kernels/pairwise_l2/pairwise_l2.py:127",
        ),
        "normalized_gram": (
            "src/repro_torch/kernels/csrc/gram.cu",
            "src/repro/kernels/gram/gram.py:104",
        ),
    }
    table = []
    for name, (source, replaces) in sources.items():
        r = rows[name][main_shape]
        table.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
        ))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
