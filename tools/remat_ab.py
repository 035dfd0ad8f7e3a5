#!/usr/bin/env python3
"""Time the LM client path of ``chip_smoke.py``'s phase 5 with ``cfg.remat``
on and off, in turns on one card: on, off, off, on.

    python3 tools/remat_ab.py [--rounds 3] [--steps 6] [--out FILE]

Each turn builds smollm-360m at full width (all 32 layers, bf16, seed 0)
through the launchers' ``build_model``, sets ``remat`` on the config, and
runs phase 5's traffic through ``launch.train.run_fl`` (``--flash``, 10
clients, 4 a round, 16 docs of 512 tokens, 2 local steps of batch 4) and
``run_pretrain`` (Adam, batch 4 x 512).  It prints, per turn, each round's
host seconds split into selection, local updates and refresh, the
pretrain's tok/s over the steps after the first, and the peak of
``torch.cuda.max_memory_allocated`` in each mode; then the medians of the
two turns of each setting side by side, with ``nvidia-smi``'s card name
and power limit.  ``--out`` keeps every turn as JSON lines.  Needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCH, SEQ, CLIENTS, PER_ROUND, DOCS, BATCH = "smollm-360m", 512, 10, 4, 16, 4


def turn(torch, remat: bool, rounds: int, steps: int) -> dict:
    from repro_torch.launch import serve, train

    dev = torch.device("cuda")
    common = ["--arch", ARCH, "--full-width", "--seq", str(SEQ), "--log-every", "1"]
    out = {"remat": remat}
    fl = train.parse_args(["--mode", "fl", "--flash", "--rounds", str(rounds), "--clients", str(CLIENTS),
                           "--per-round", str(PER_ROUND), "--docs-per-client", str(DOCS)] + common)
    cfg, params = serve.build_model(ARCH, 0, full_width=True, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _, outs = train.run_fl(fl, model=(dataclasses.replace(cfg, remat=remat), params))
    torch.cuda.synchronize()
    out["fl_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    out["rounds"] = [{n: float(outs[n][i]) for n in ("t_select", "t_local", "t_refresh")} for i in range(rounds)]
    del outs, params
    torch.cuda.empty_cache()

    pre = train.parse_args(["--mode", "pretrain", "--steps", str(steps), "--local-batch", str(BATCH)] + common)
    cfg, params = serve.build_model(ARCH, 0, full_width=True, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _, _, hist = train.run_pretrain(pre, model=(dataclasses.replace(cfg, remat=remat), params))
    out["pretrain_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    first, end = hist[0], hist[-1]
    out["pretrain_tok_s"] = (end["step"] - first["step"]) * BATCH * SEQ / (end["seconds"] - first["seconds"])
    out["pretrain_first_step_s"] = first["seconds"]
    del params
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    turns = []
    for remat in (True, False, False, True):
        t = turn(torch, remat, args.rounds, args.steps)
        turns.append(t)
        per_round = "; ".join(f"{sum(r.values()):.4f} = {r['t_select']:.4f} + {r['t_local']:.4f} + "
                              f"{r['t_refresh']:.4f}" for r in t["rounds"])
        print(f"remat {'on ' if remat else 'off'}: rounds (s = selection + local + refresh) {per_round}; "
              f"FL peak {t['fl_peak_gib']:.2f} GiB; pretrain {t['pretrain_tok_s']:.1f} tok/s (first step "
              f"{t['pretrain_first_step_s']:.3f} s), peak {t['pretrain_peak_gib']:.2f} GiB", flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(dict(t, card=card)) + "\n")
    for remat in (True, False):
        mine = [t for t in turns if t["remat"] == remat]
        rnd = statistics.median(sum(r.values()) for t in mine for r in t["rounds"][1:] or t["rounds"])
        loc = statistics.median(r["t_local"] for t in mine for r in t["rounds"][1:] or t["rounds"])
        tok = statistics.median(t["pretrain_tok_s"] for t in mine)
        print(f"median, remat {'on ' if remat else 'off'}: round {rnd:.4f} s (local updates {loc:.4f} s), "
              f"pretrain {tok:.1f} tok/s; peaks FL {max(t['fl_peak_gib'] for t in mine):.2f} GiB, pretrain "
              f"{max(t['pretrain_peak_gib'] for t in mine):.2f} GiB ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
