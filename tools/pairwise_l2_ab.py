#!/usr/bin/env python3
"""Time K1 (``pairwise_dists_stats``) and K3 (``pairwise_sq_dists``) of two
trees of the port on one card, in turns: parent, change, change, parent.

    python3 tools/pairwise_l2_ab.py --parent PARENT_ROOT [--out FILE]

``PARENT_ROOT`` is the root of another checkout (``git archive`` of the
parent commit, unpacked); the change is this checkout.  Each turn is a
process of its own that builds the tree's ``pairwise_l2.cu`` alone (with
K1's host binding, where the tree has one) and
times every shape of ``chip_smoke.py``'s ``SHAPES`` (K1) and ``K3_SHAPES``
(K3): the wrapper's time (CUDA events around back-to-back calls, median of
5 runs), that of ``torch.cdist(f, f)`` (K1) or its square (K3) on fp32
profiles, and the kernel's device time per call from torch.profiler, hot
and cold (256 MB written before each call).  Prints one line per turn,
kernel and shape, then the medians of each tree's two turns side by side,
with ``nvidia-smi``'s card name and power limit; ``--out`` keeps every
turn as JSON lines.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one_turn(src: Path, label: str) -> list:
    """Time K1 and K3 of the port under ``src``; returns one dict a shape."""
    import torch

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(src))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.pairwise_l2 import ops

    _build.SOURCES = ("pairwise_l2",)  # build this kernel's library alone
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    out = []
    for name, fn, shapes in (("K1", ops.pairwise_dists_stats, cs.SHAPES),
                             ("K3", ops.pairwise_sq_dists, cs.K3_SHAPES)):
        for c, q, kind in shapes:
            g = torch.Generator().manual_seed(c * 7919 + q)
            f = torch.randn(c, q, generator=g).to(dtypes[kind]).cuda()
            call = lambda: fn(f)  # noqa: E731
            lib = (lambda: torch.cdist(f, f)) if name == "K1" else (lambda: torch.cdist(f, f).square())
            out.append(dict(
                tree=label, kernel=name, c=c, q=q, kind=kind,
                ms=cs.time_ms(torch, call),
                # the library call beside the wrapper (fp32: cdist's bf16 support varies)
                lib=cs.time_ms(torch, lib) if kind == "fp32" else None,
                hot=cs.device_ms(torch, call, "pairwise"),
                cold=cs.device_ms(torch, call, "pairwise", cold=True),
            ))
            r = out[-1]
            print(f"{label} {name} ({c}, {q}) {kind}: ms {r['ms']:.5f} library {cs.fmt_ms(r['lib'])} "
                  f"device_ms cold {cs.fmt_ms(r['cold'])} hot {cs.fmt_ms(r['hot'])}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="root of the parent's checkout")
    ap.add_argument("--out", type=Path, help="JSON lines of every turn")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)  # a turn: the tree's src
    ap.add_argument("--label", default="change", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        print("RESULT " + json.dumps(one_turn(args.one, args.label)))
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    rows = []
    for label, root in (("parent", args.parent), ("change", ROOT), ("change", ROOT), ("parent", args.parent)):
        proc = subprocess.run(
            [sys.executable, __file__, "--one", str(Path(root).resolve() / "src"), "--label", label],
            capture_output=True, text=True,
        )
        sys.stdout.write("".join(line for line in proc.stdout.splitlines(True) if not line.startswith("RESULT ")))
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            return proc.returncode
        rows += json.loads(proc.stdout.split("RESULT ", 1)[1])
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))

    def med(tree, kernel, c, q, kind, key):
        vals = [r[key] for r in rows if (r["tree"], r["kernel"], r["c"], r["q"], r["kind"]) ==
                (tree, kernel, c, q, kind) and r[key] is not None]
        return statistics.median(vals) if vals else None

    print(f"medians of two turns each, {smi}: parent -> change (change / parent)")
    seen = []
    for r in rows:
        key = (r["kernel"], r["c"], r["q"], r["kind"])
        if key in seen:
            continue
        seen.append(key)
        cells = []
        for what in ("ms", "lib", "cold", "hot"):
            a, b = med("parent", *key, what), med("change", *key, what)
            ratio = "" if a is None or b is None else f" ({b / a:.3f})"
            fa = "n/a" if a is None else f"{a:.5f}"
            fb = "n/a" if b is None else f"{b:.5f}"
            cells.append(f"{what} {fa} -> {fb}{ratio}")
        print(f"{key[0]} ({key[1]}, {key[2]}) {key[3]}: " + "; ".join(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main())
