"""A readable run summary from a telemetry JSONL file.

    PYTHONPATH=src python -m repro_torch.analysis.report runs/train.jsonl

Reads the streams of both engines, written by this package or by the JAX
package: the manifest's header, a convergence table sampled from the
``fl_round`` events (round, loss, accuracy, GEMD and whichever diagnostics
the config produced), robustness totals, reprofile and checkpoint counts,
and the serving tables (TTFT and end-to-end percentiles, decode tok/s over
the chunks, occupancy, queue depth).  Standard library and numpy only, so
it runs wherever the file lands.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Sequence

import numpy as np

from repro_torch.obs.sink import load_events

__all__ = ["load_events", "summarize"]

# the manifest keys shown, this package's and the JAX package's
MANIFEST_KEYS = (
    "config_hash", "git_sha", "jax_version", "torch_version", "cuda_version", "backend",
    "device_count", "device_kind", "mesh", "mode", "arch",
)


def _fmt(v: Any) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _table(headers: Sequence[str], rows: List[Sequence[Any]]) -> List[str]:
    cells = [[_fmt(c) for c in row] for row in rows]
    widths = [max(len(h), *(len(r[i]) for r in cells)) if cells else len(h) for i, h in enumerate(headers)]

    def line(r):
        return "  " + "  ".join(c.rjust(w) for c, w in zip(r, widths))

    return [line(headers), line(["-" * w for w in widths])] + [line(r) for r in cells]


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


def _manifest_lines(man: Dict[str, Any]) -> List[str]:
    return ["run manifest"] + [f"  {k}: {man[k]}" for k in MANIFEST_KEYS if man.get(k) is not None]


def _train_lines(rounds: List[Dict[str, Any]], max_rows: int) -> List[str]:
    lines = [f"training: {len(rounds)} rounds"]
    cols = ["round", "loss", "acc", "gemd"]
    for extra in ("sim_time", "staleness", "survivors", "flagged", "quarantined", "cache_age",
                  "spectrum_erank", "avail_frac"):
        if any(r.get(extra) is not None for r in rounds):
            cols.append(extra)
    step = max(1, len(rounds) // max_rows)
    idx = sorted(set(range(0, len(rounds), step)) | {len(rounds) - 1})
    lines += _table(cols, [[rounds[i].get(c) for c in cols] for i in idx])
    ident = sum(int(r.get("identity_round") or 0) for r in rounds)
    if ident:
        lines.append(f"  identity rounds (survivors floor): {ident}")
    gemds = [r["gemd"] for r in rounds if r.get("gemd") is not None]
    if len(gemds) > 1:
        lines.append(f"  mean |GEMD drift| per round: {float(np.mean(np.abs(np.diff(gemds)))):.4g}")
    return lines


def _serve_lines(events: List[Dict[str, Any]]) -> List[str]:
    admits = [e for e in events if e["event"] == "serve_admit"]
    chunks = [e for e in events if e["event"] == "serve_chunk"]
    finishes = [e for e in events if e["event"] == "serve_finish"]
    lines = [f"serving: {len(finishes)} finished seqs, {len(admits)} admissions, {len(chunks)} decode chunks"]
    rows = []
    ttft = [e["ttft_s"] for e in admits if e.get("ttft_s") is not None]
    if ttft:
        rows.append(["TTFT (s)", _pct(ttft, 50), _pct(ttft, 90), _pct(ttft, 99), max(ttft)])
    lat = [e["latency_s"] for e in finishes if e.get("latency_s") is not None]
    if lat:
        rows.append(["latency (s)", _pct(lat, 50), _pct(lat, 90), _pct(lat, 99), max(lat)])
    if rows:
        lines += _table(["metric", "p50", "p90", "p99", "max"], rows)
    if chunks:
        toks = sum(e.get("tokens", 0) for e in chunks)
        secs = sum(e.get("dt_s", 0.0) for e in chunks)
        occ = [e["active_slots"] / e["batch"] for e in chunks if e.get("batch")]
        qd = [e.get("queue_depth", 0) for e in chunks]
        lines.append(
            f"  decode: {toks} tokens in {secs:.3f} s ({toks / max(secs, 1e-9):,.0f} tok/s aggregate), "
            f"mean occupancy {np.mean(occ):.0%}, max queue depth {max(qd)}"
        )
    return lines


def summarize(events: List[Dict[str, Any]], max_rows: int = 12) -> str:
    """The whole report as one string ("no telemetry events" for none)."""
    lines: List[str] = []
    man = next((e for e in events if e["event"] == "manifest"), None)
    if man is not None:
        lines += _manifest_lines(man)
    rounds = [e for e in events if e["event"] == "fl_round"]
    if rounds:
        lines += [""] + _train_lines(rounds, max_rows)
    reprofiles = [e for e in events if e["event"] == "fl_reprofile"]
    if reprofiles:
        lines.append(f"  reprofile boundaries: {len(reprofiles)}")
    ckpts = [e for e in events if e["event"] == "fl_checkpoint"]
    if ckpts:
        lines.append(f"  checkpoints: {len(ckpts)} (last at round {ckpts[-1].get('round')})")
    if any(e["event"].startswith("serve_") for e in events):
        lines += [""] + _serve_lines(events)
    if not lines:
        return "no telemetry events"
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("path", help="telemetry JSONL file")
    ap.add_argument("--max-rows", type=int, default=12, help="most rows of the convergence table (sampled evenly)")
    args = ap.parse_args(argv)
    print(summarize(load_events(args.path), max_rows=args.max_rows))


if __name__ == "__main__":
    main()
