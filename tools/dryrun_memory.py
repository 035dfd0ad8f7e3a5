#!/usr/bin/env python3
"""Where a step's allocations on the card part from the dry run's count.

    python3 tools/dryrun_memory.py [--arch smollm-360m] [--shape train_4k]
        [--batch 2] [--clients 2] [--local-steps 2]

Runs one step of the dry run's case (``launch/dryrun.build_step``) on the
card under ``analysis/ops.StepCounter``, with cuBLAS's workspaces already
allocated (a matmul and its gradient first), and reads
``torch.cuda.memory_allocated`` around every aten op.  It prints the
card's name and power limit; the dry run's peak above the arguments
(fake tensors, on the CPU) beside the counter's on the card and
``max_memory_allocated``'s; the ops whose kernels allocated buffers of
their own while they ran (the most each held, beyond its arguments and
results, with its argument shapes), for comparing with
``analysis/ops.card_temporaries``; and the moments the card's allocation
peaked, with the op, the buffers it held and the counter's live bytes
just before.  Needs a card.
"""

from __future__ import annotations

import argparse
import collections
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()

    import torch

    from repro_torch.analysis.ops import StepCounter
    from repro_torch.launch import dryrun

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    alloc, most = torch.cuda.memory_allocated, torch.cuda.max_memory_allocated
    a = torch.randn(64, 64, device=dev, dtype=torch.bfloat16, requires_grad=True)
    torch.autograd.grad((a @ a).float().sum(), a)  # both threads' cuBLAS workspaces
    torch.cuda.synchronize()

    class Reader(StepCounter):
        """StepCounter that also reads the card's allocation around each op."""

        def __init__(self, base: int, top: int):
            super().__init__()
            self.base, self.top, self.n, self.moments = base, top, 0, []
            self.held = collections.defaultdict(lambda: [0, 0, None])  # most held, ops that held any, shapes

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before, live = alloc(), self.live
            torch.cuda.reset_peak_memory_stats()
            out = super().__torch_dispatch__(func, types, args, kwargs)
            inside, after = most(), alloc()
            self.n += 1
            held = inside - max(before, after)
            if held > 0:
                rec = self.held[str(func)]
                rec[1] += 1
                if held > rec[0]:
                    rec[0] = held
                    rec[2] = [tuple(t.shape) + (str(t.dtype), t.is_contiguous())
                              for t in args if isinstance(t, torch.Tensor)][:3]
            self.moments.append((inside - self.base, self.n, str(func), held, live))
            if len(self.moments) > 4096:
                self.moments = sorted(self.moments, reverse=True)[: self.top]
            return out

    case = dryrun.DryRunCase(args.arch, args.shape, batch=args.batch, clients=args.clients,
                             local_steps=args.local_steps)
    rec = dryrun.run_case(case)
    if not rec["ok"]:
        raise SystemExit(rec["error"])
    step, step_args, _ = dryrun.build_step(case, dev)
    torch.cuda.synchronize()
    base = alloc()
    reader = Reader(base, args.top)
    reader.hold(step_args)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with reader:
        step(*step_args)
    torch.cuda.synchronize()
    real = max(m[0] for m in reader.moments)
    print(f"{args.arch} {args.shape} batch {args.batch}, {args.clients} clients, {args.local_steps} local steps: "
          f"{reader.n:,} aten ops in {time.perf_counter() - t0:.1f} s; peak above the arguments: dry run "
          f"{rec['step_peak']:,}, counter on the card {reader.peak:,}, the card's allocation {real:,} bytes")
    print("ops whose kernels held buffers of their own (most bytes, ops that held any, first argument shapes):")
    for name, (held, n, shapes) in sorted(reader.held.items(), key=lambda kv: -kv[1][0])[: args.top]:
        print(f"  {name}: {held:,} bytes, {n} ops, {shapes}")
    print("the card's peak moments (bytes above the arguments, op index, op, its own buffers, counter live before):")
    for m in sorted(reader.moments, reverse=True)[: args.top]:
        print(f"  {m[0]:,} at #{m[1]} {m[2]}: {m[3]:,} held, {m[4]:,} live")


if __name__ == "__main__":
    main()
