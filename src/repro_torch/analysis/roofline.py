"""Roofline terms of the dry run's steps on NVIDIA H100s.

For each full-width (arch × input shape) record of ``launch/dryrun.py``,
one device's step (the one card's, or rank 0's on a production mesh):

    compute    = flops / peak FLOP/s of the model's dtype   (HW.PEAK_FLOPS)
    memory     = bytes_moved / HBM bandwidth                (HW.HBM_BW)
    collective = Σ over mesh axes of the axis's collective bytes (JAX's
                 per-device estimators, ``analysis/ops.collective_bytes``)
                 over the bandwidth of the link it crosses (``axis_link``:
                 NVLink inside an 8-card board, InfiniBand between boards);
                 0 on one card

``flops`` is ``FlopCounterMode``'s count of the step's matmuls plus the
model kernels' analytic FLOPs; ``bytes_moved`` is every dispatched op's
argument and result bytes plus the kernels' (``analysis/ops.py``): the
eager port's traffic, op by op, without fusion.

MODEL_FLOPS is the analytic "useful" count, the JAX package's (the whole
step's, so on a mesh ``useful_ratio`` = MODEL_FLOPS / (flops × devices)):
    train:   6·N_active·tokens + 3·attn_flops(S)
    prefill: 2·N_active·tokens + attn_flops(S)
    decode:  2·N_active·batch + attn_kv_flops(S_cache)
with N_active the non-embedding active params and the LM head (MoE: k of
E routed experts and the shared one).  ``useful_ratio`` = MODEL_FLOPS /
flops falls below 1 by remat's recompute and by attention over the whole
masked square.

    PYTHONPATH=src python -m repro_torch.analysis.roofline --inp build/dryrun.jsonl --out build/roofline.md
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import Dict, List, Sequence

from repro_torch.configs import get_arch
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.models.transformer import vocab_padded

__all__ = ["HW", "active_param_count", "analyse", "model_flops", "peak_flops", "render_markdown"]


class HW:
    """One NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W), and the
    links a collective between such cards crosses (NVIDIA's H100 and DGX
    H100 data sheets)."""

    NAME = "NVIDIA H100 80GB HBM3"
    HBM_BW = 3.35e12  # bytes/s
    # NVLink 4 inside an 8-card HGX board: 900 GB/s a card, both ways
    NVLINK_BW = 450e9  # bytes/s a card, one way
    # InfiniBand NDR between boards: one 400 Gb/s ConnectX-7 port a card
    IB_BW = 50e9  # bytes/s a card, one way
    CARDS_PER_BOARD = 8
    HBM_BYTES = 80 * 2**30
    # cuBLAS's workspace, which PyTorch allocates on sm_90 for each thread
    # that runs a matmul on the card (read back by chip_smoke.py phase 7)
    CUBLAS_WORKSPACE = 32 * 2**20
    # fp32 on the CUDA cores; TF32 and bf16 on the tensor cores
    PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}


def _layer_param_counts(cfg) -> Dict[str, float]:
    d, f = cfg.d_model, cfg.d_ff
    qd, kvd = cfg.q_dim, cfg.kv_dim
    dr = cfg.rnn_width or d
    mlp = 3 * d * f if cfg.mlp_variant in ("swiglu", "geglu") else 2 * d * f
    return {
        "attn": d * qd + 2 * d * kvd + qd * d,
        "mlp": mlp,
        "moe_total": cfg.num_experts * 3 * d * f + (mlp if cfg.shared_expert else 0),
        "moe_active": cfg.experts_per_token * 3 * d * f + (mlp if cfg.shared_expert else 0),
        "rglru": 3 * d * dr + 2 * dr * dr + 5 * dr,
        "rwkv_tmix": 5 * d * d + 2 * d * 32,
        "rwkv_cmix": 2 * d * f + d * d,
    }


def active_param_count(cfg, total: bool = False) -> float:
    """Non-embedding params; MoE layers count active (or total) experts."""
    lc = _layer_param_counts(cfg)
    n = 0.0
    for btype in cfg.layer_types():
        mixer, ffn = btype.split("+")
        n += {"attn": lc["attn"], "swa": lc["attn"], "local": lc["attn"],
              "rglru": lc["rglru"], "rwkv": lc["rwkv_tmix"]}[mixer]
        n += {"mlp": lc["mlp"], "cmix": lc["rwkv_cmix"],
              "moe": lc["moe_total"] if total else lc["moe_active"]}[ffn]
    n += cfg.d_model * vocab_padded(cfg)  # lm head (tied or not, the matmul runs)
    return n


def _attn_flops(cfg, batch: int, s_q: int, s_kv: int) -> float:
    """2 matmuls (qk, pv), 2 flops/MAC, causal halves the square case."""
    per_layer = 4.0 * batch * s_q * s_kv * cfg.num_heads * cfg.head_dim
    if s_q == s_kv:
        per_layer *= 0.5  # causal
    n_attn = sum(1 for b in cfg.layer_types() if b.split("+")[0] in ("attn", "swa", "local"))
    return per_layer * n_attn


def model_flops(arch: str, shape: str, fl_mode: str, local_steps: int = 4) -> float:
    spec = get_arch(arch)
    cfg = spec.long_context_model() if shape == "long_500k" else spec.model
    ishape = INPUT_SHAPES[shape]
    n_act = active_param_count(cfg)
    b, s = ishape.global_batch, ishape.seq_len
    if ishape.kind == "train":
        steps = local_steps if fl_mode == "client_parallel" else 1
        tokens = b * s * steps
        return 6.0 * n_act * tokens + 3.0 * steps * _attn_flops(cfg, b, s, s)
    if ishape.kind == "prefill":
        return 2.0 * n_act * b * s + _attn_flops(cfg, b, s, s)
    # decode: one token against the cache (window-clamped for swa/local)
    win = {"swa": cfg.window, "local": cfg.local_window}
    kv = min(s, max((win.get(bt.split("+")[0], s) for bt in cfg.layer_types()), default=s))
    return 2.0 * n_act * b + _attn_flops(cfg, b, 1, kv)


def _wkv_flops_correction(arch: str, shape: str, chips: int, fl_mode: str, local_steps: int) -> float:
    """The WKV recurrence's FLOPs per card, the JAX package's count:
    ~8·hd² flops per head per token per layer (state update + readout),
    three times for a training pass.  The port counts K7's calls with the
    same law (``kernels.rwkv6_scan.ops.wkv6_flops``)."""
    if arch != "rwkv6-7b":
        return 0.0
    cfg = get_arch(arch).model
    ishape = INPUT_SHAPES[shape]
    heads = cfg.d_model // cfg.rwkv_head_dim
    tokens = ishape.global_batch * (ishape.seq_len if ishape.kind != "decode" else 1)
    if ishape.kind == "train":
        tokens *= local_steps if fl_mode == "client_parallel" else 1
        mult = 3.0  # fwd + bwd
    else:
        mult = 1.0
    per_layer = 8.0 * cfg.rwkv_head_dim**2 * heads * tokens
    return mult * per_layer * cfg.num_layers / chips


def peak_flops(dtype: str) -> float:
    """The card's peak FLOP/s for a model of ``dtype``: bf16 on the tensor
    cores, fp32 on the CUDA cores (the port keeps TF32 off)."""
    return HW.PEAK_FLOPS["bf16" if dtype == "bfloat16" else "fp32"]


def axis_link(shape: Sequence[int], axes: Sequence[str], axis: str) -> str:
    """The link a collective over mesh axis ``axis`` crosses: ranks are
    numbered row-major over ``shape`` (the last axis fastest) and placed
    ``HW.CARDS_PER_BOARD`` to a board in order, so an axis whose group
    lies on one board talks over NVLink and any other over InfiniBand
    (its ring's slowest hop)."""
    i = list(axes).index(axis)
    stride = math.prod(shape[i + 1 :])
    return "nvlink" if (shape[i] - 1) * stride < HW.CARDS_PER_BOARD else "infiniband"


def step_terms(rec: Dict, mesh=None) -> Dict[str, float]:
    """The three roofline terms of one device's step (a dry-run record):
    its FLOPs over the peak of the model's dtype, its bytes over the HBM
    bandwidth, and each mesh axis's collective bytes over the link that
    axis crosses (:func:`axis_link`; ``mesh`` is (shape, axis names), None
    on one card, where the term is 0)."""
    t_coll = 0.0
    if mesh is not None:
        shape, axes = mesh
        bw = {"nvlink": HW.NVLINK_BW, "infiniband": HW.IB_BW}
        for axis, b in rec.get("collectives", {}).get("by_axis", {}).items():
            t_coll += b / bw[axis_link(shape, axes, axis)]
    return dict(t_compute=rec["flops"] / peak_flops(rec["dtype"]), t_memory=rec["bytes_moved"] / HW.HBM_BW,
                t_collective=t_coll)


def analyse(records: List[Dict]) -> List[Dict]:
    """One row per full-width record that ran: the three terms of one
    device's step, the dominant one, MODEL_FLOPS and the useful ratio, the
    fit, and the record's mesh ("1": one card)."""
    out = []
    for r in records:
        if not r.get("ok") or r.get("reduced") or r.get("case", "arch") != "arch":
            continue
        mesh = r.get("mesh", "1")
        dims = None if mesh == "1" else (tuple(int(n) for n in mesh.split("x")),
                                         ("pod", "data", "model") if mesh.count("x") == 2 else ("data", "model"))
        terms = step_terms(r, dims)
        dominant = max(("compute", "memory", "collective"), key=lambda k: terms[f"t_{k}"])
        mf = model_flops(r["arch"], r["shape"], r["fl_mode"], get_arch(r["arch"]).fl.local_steps)
        mf *= r.get("scan_rounds", 1)
        devices = r.get("devices", 1)
        out.append(dict(
            arch=r["arch"], shape=r["shape"], fl_mode=r["fl_mode"], card=HW.NAME, mesh=mesh, devices=devices,
            **terms, dominant=dominant, model_flops=mf, flops=r["flops"],
            useful_ratio=mf / (r["flops"] * devices) if r["flops"] else float("nan"),
            peak_bytes=r["peak_bytes"], fits_one_card=r["peak_bytes"] <= HW.HBM_BYTES,
            cards_needed=math.ceil(r["peak_bytes"] / HW.HBM_BYTES),
        ))
    return out


_SUGGEST = {
    "compute": "cut remat's recompute, a fused attention for the masked square",
    "memory": "fuse the elementwise passes, a kernel where the plain path runs",
    "collective": "shard to cut cross-card traffic",
}


def render_markdown(rows: List[Dict]) -> str:
    """One table a mesh: one card's, then each production mesh's per-device
    rows."""
    meshes = sorted({r.get("mesh", "1") for r in rows}, key=lambda m: (m != "1", m))
    return "\n\n".join(_table([r for r in rows if r.get("mesh", "1") == m], m) for m in meshes)


def _table(rows: List[Dict], mesh: str) -> str:
    where = ("One" if mesh == "1" else f"Each device of the {mesh} mesh, one") + f" {HW.NAME}"
    lines = [
        f"{where} (700 W data-sheet peaks; collective term 0 on one card, else NVLink "
        f"{HW.NVLINK_BW / 1e9:.0f} GB/s or InfiniBand {HW.IB_BW / 1e9:.0f} GB/s a card by the axis).",
        "",
        "| arch | shape | mode | compute s | memory s | collective s | dominant | "
        "MODEL_FLOPS | useful ratio | peak GiB | fits one card | cards needed | what moves the dominant term |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(rows, key=lambda x: (x["arch"], x["shape"])):
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['fl_mode']} "
            f"| {r['t_compute']:.3e} | {r['t_memory']:.3e} | {r['t_collective']:.3e} "
            f"| **{r['dominant']}** | {r['model_flops']:.2e} | {r['useful_ratio']:.2f} "
            f"| {r['peak_bytes'] / 2**30:.1f} | {'yes' if r['fits_one_card'] else 'no'} | {r['cards_needed']} "
            f"| {_SUGGEST[r['dominant']]} |"
        )
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--inp", default="build/dryrun.jsonl", help="the dry run's JSONL records")
    ap.add_argument("--out", default="build/roofline.md", help="the table (and its rows as .json beside it)")
    args = ap.parse_args(argv)
    with open(args.inp) as f:
        records = [json.loads(line) for line in f if line.strip()]
    rows = analyse(records)
    md = render_markdown(rows)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(md + "\n")
    with open(os.path.splitext(args.out)[0] + ".json", "w") as f:
        json.dump(rows, f, indent=1)
    print(md)


if __name__ == "__main__":
    main()
