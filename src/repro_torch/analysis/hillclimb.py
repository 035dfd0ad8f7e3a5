"""Hillclimb: evaluate sharding and config variants of one (arch ×
shape) pair on the 16 × 16 mesh against the three roofline terms on the
H100.

    PYTHONPATH=src python -m repro_torch.analysis.hillclimb --pair rwkv6-7b:train_4k
    PYTHONPATH=src python -m repro_torch.analysis.hillclimb --all

Each variant is (name, train-rule overrides, serve-rule overrides, model
config overrides, FL overrides), the JAX package's own list
(``_variants``); ``v0-baseline`` is always first.  ``eval_variant`` runs
one device's share of the step through the port's sharded dry run
(``launch/dryrun.py`` on the ``fake``-backend mesh: FLOPs, bytes and
collectives counted on the device's local tensors), takes the roofline's
three terms on the H100 (``analysis/roofline.step_terms``: compute at the
dtype's peak, memory at the HBM bandwidth, each mesh axis's collective
bytes over the link it crosses) and the useful ratio ``model_flops /
(per-device flops × devices)``, and appends the record to
``results/hillclimb_torch.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

from repro_torch.analysis.roofline import model_flops
from repro_torch.configs import get_arch

__all__ = ["OUT", "PAIRS", "eval_variant", "run_pair"]

OUT = "results/hillclimb_torch.jsonl"


def _variants(arch: str, shape: str):
    """Ordered candidate list per pair: (name, rules_t, rules_s, cfg, fl)."""
    v = [("v0-baseline", {}, {}, {}, {})]
    if arch == "rwkv6-7b":
        # H1: Mode-A activation constraints must not claim the data axis for
        # the inner batch (the client axis already owns it)
        v.append(("v1-modeA-act-batch-free", {"act_batch": None}, {}, {}, {}))
        # H2: co-shard the decay and group-norm path with att_w so the wkv
        # inputs r/k/v/w keep one head sharding end to end
        v.append((
            "v2-headsharded-decay",
            {"act_batch": None, "att_vec_w": "model", "act_rwkv_h": "model"},
            {}, {}, {},
        ))
        # H3: the paper's lever: more local steps amortise the round's sync
        v.append((
            "v3-v2+E8",
            {"act_batch": None, "att_vec_w": "model", "act_rwkv_h": "model"},
            {}, {}, {"local_steps": 8},
        ))
    if arch == "mixtral-8x7b":
        # H1: move the experts' second shard axis from d_ff to d_model
        v.append((
            "v1-expert-embed-sharded",
            {}, {"expert_mlp_w": None, "expert_embed_w": "model"}, {}, {},
        ))
        # H2: keep d_ff tensor-parallel, shard the attention heads explicitly
        v.append((
            "v2-attn-head-constraint",
            {}, {"act_attn_h": "model"}, {}, {},
        ))
    if arch == "musicgen-medium":
        # H1: 24 heads do not shard 16 ways: batch-parallel attention over
        # the model axis, its weights replicated
        v.append((
            "v1-batch-parallel-attn",
            {"act_attn_b": "model", "attn_in_w": None, "attn_out_w": None},
            {}, {}, {},
        ))
        # H2: v1 with Mode A's inner-batch axis freed
        v.append((
            "v2-v1+act-batch-free",
            {"act_attn_b": "model", "attn_in_w": None, "attn_out_w": None,
             "act_batch": None},
            {}, {}, {},
        ))
    return v


def eval_variant(arch: str, shape: str, name: str, rules_t: Optional[Dict] = None, rules_s: Optional[Dict] = None,
                 cfg_over: Optional[Dict] = None, fl_over: Optional[Dict] = None, reduced: bool = False) -> Dict:
    """One variant's record: the sharded dry run's per-device counts on the
    16 × 16 mesh, the three roofline terms, the useful ratio (None for a
    reduced config, whose model FLOPs the full config's law does not
    give).  ``reduced`` takes the reduced config and shapes (a quick
    check); ``cfg_over`` fields replace the model config's."""
    from repro_torch.launch import dryrun

    t0 = time.time()
    rec: Dict = {"arch": arch, "shape": shape, "variant": name, "rules_t": rules_t, "rules_s": rules_s,
                 "cfg": cfg_over, "fl": fl_over, "mesh": "16x16", "reduced": reduced}
    case = dryrun.DryRunCase(arch, shape, reduced=reduced, multi_pod=False, rules_t=rules_t or None,
                             rules_s=rules_s or None, fl_over=fl_over or None, cfg_over=cfg_over or None)
    r = dryrun.run_case(case)
    if r["ok"]:
        spec = dryrun.case_config(case)[0]
        mf = None if reduced else model_flops(arch, shape, r["fl_mode"], spec.fl.local_steps)
        rec.update(
            ok=True, t_compute=r["t_compute"], t_memory=r["t_memory"], t_collective=r["t_collective"],
            collectives=r["collectives"], flops=r["flops"], bytes=r["bytes_moved"], peak_bytes=r["peak_bytes"],
            devices=r["devices"], useful_ratio=mf / (r["flops"] * r["devices"]) if mf and r["flops"] else None,
        )
    else:
        rec.update(ok=False, error=r["error"], traceback=r.get("traceback", ""))
    rec["wall_s"] = round(time.time() - t0, 1)
    return rec


def _eval(args) -> Dict:
    return eval_variant(*args[:7], reduced=args[7])


def run_pair(arch: str, shape: str, out: str = OUT, reduced: bool = False, jobs: int = 1) -> List[Dict]:
    """Every variant of the pair, in ``jobs`` worker processes (each its
    own fake process group) or in this one, appended to ``out`` in order."""
    todo = [(arch, shape) + v + (reduced,) for v in _variants(arch, shape)]
    if jobs > 1:
        import multiprocessing

        with multiprocessing.get_context("spawn").Pool(min(jobs, len(todo))) as pool:
            records = pool.map(_eval, todo)
    else:
        records = map(_eval, todo)
    rows = []
    for (_, _, name, *_), rec in zip(todo, records):
        rows.append(rec)
        if rec["ok"]:
            ratio = "" if rec["useful_ratio"] is None else f" ratio {rec['useful_ratio']:.3f}"
            print(f"{arch} {shape} {name:28s} compute {rec['t_compute']:.4e}s memory {rec['t_memory']:.4e}s "
                  f"coll {rec['t_collective']:.4e}s{ratio}  ({rec['wall_s']}s)", flush=True)
        else:
            print(f"{arch} {shape} {name:28s} FAIL {rec['error'][:160]}", flush=True)
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return rows


PAIRS = [
    ("rwkv6-7b", "train_4k"),  # most collective-bound
    ("mixtral-8x7b", "prefill_32k"),  # collective-bound serving
    ("musicgen-medium", "train_4k"),  # worst roofline fraction, Mode A (the paper's)
]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--pair", help="arch:shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--reduced", action="store_true", help="reduced configs and shapes (a quick check)")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--jobs", type=int, default=1, help="variants evaluated at once, a worker process each")
    args = ap.parse_args(argv)
    if not (args.all or args.pair):
        ap.error("--pair arch:shape or --all")
    pairs = PAIRS if args.all else [tuple(args.pair.split(":"))]
    for arch, shape in pairs:
        get_arch(arch)  # an unknown arch fails here, before any variant runs
        run_pair(arch, shape, args.out, args.reduced, args.jobs)


if __name__ == "__main__":
    main()
