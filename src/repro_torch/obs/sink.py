"""Host-side telemetry sink: JSONL events and the run manifest.

One event per line, strict JSON (NaN and Inf become ``null``, so any
consumer reads the file back).  Every event carries::

    {"event": <type>, "t": <seconds since the sink was made, perf_counter>,
     "wall": <unix seconds>, ...payload}

The engines hand events to the sink only at segment, admission, harvest
and decode-chunk boundaries, never from inside a round: a round's outputs
stay on the device until its segment ends, and the sink reads them then.
The event envelope and the JSON rules are the JAX package's, so one report
reads the files of both.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import subprocess
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

__all__ = [
    "TelemetrySink",
    "config_hash",
    "drain_fl_outputs",
    "load_events",
    "run_manifest",
]


def _host(v: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bf16 and fp16 as fp32 (numpy
    has no bf16)."""
    v = v.detach().cpu()
    if v.dtype in (torch.bfloat16, torch.float16):
        v = v.float()
    return v.numpy()


def _jsonable(v: Any) -> Any:
    """Numpy and torch scalars and arrays as strict-JSON values.

    Plain scalars come first: the drain passes many already-converted
    values through here, so the common case is a couple of isinstance
    checks."""
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, float):  # np.float64 too (a float subclass)
        return float(v) if math.isfinite(v) else None
    if isinstance(v, torch.Tensor):
        v = _host(v)
    if isinstance(v, (np.generic, np.ndarray)):
        v = np.asarray(v)
        return _jsonable(v.item() if v.ndim == 0 else v.tolist())
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return v


def config_hash(config: Any) -> str:
    """Short stable hash of a config (dataclass or plain dict): canonical
    JSON (sorted keys), sha256.  The same config gives the same hash in
    any process, and in the JAX package for a config of the same values."""
    if dataclasses.is_dataclass(config) and not isinstance(config, type):
        config = dataclasses.asdict(config)
    blob = json.dumps(_jsonable(config), sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _git_sha() -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
    except (OSError, subprocess.SubprocessError):  # no git where the run is deployed
        return None
    return (out.stdout.strip() or None) if out.returncode == 0 else None


def run_manifest(
    config: Any = None,
    extra: Optional[Dict[str, Any]] = None,
    device: Optional[Any] = None,
    mesh: Optional[Any] = None,
) -> Dict[str, Any]:
    """The run's identity: torch and CUDA versions, the backend and card,
    host cores, git SHA, and the config with its hash.

    ``device`` is where the run computes (default: ``cuda`` when a card is
    present, else the CPU); ``device_kind`` is the card's name, or ``cpu``.
    With a client ``mesh`` (``launch/mesh.ClientMesh``) a ``mesh`` entry
    gives JAX's ``axes`` and ``devices`` and the ranks, the collective's
    backend and the writing rank's device.  Written once per run as the
    sink's first event, so every JSONL file says what produced it."""
    dev = torch.device(device if device is not None else ("cuda" if torch.cuda.is_available() else "cpu"))
    on_card = dev.type == "cuda"
    man: Dict[str, Any] = {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": dev.type,
        "device_count": torch.cuda.device_count() if on_card else 1,
        "device_kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "host_cores": os.cpu_count(),
        "git_sha": _git_sha(),
    }
    if config is not None:
        if dataclasses.is_dataclass(config) and not isinstance(config, type):
            config = dataclasses.asdict(config)
        man["config"] = _jsonable(config)
        man["config_hash"] = config_hash(config)
    if mesh is not None:
        man["mesh"] = {
            "axes": {"clients": int(mesh.size)},
            "devices": int(mesh.size),
            "ranks": int(mesh.size),
            "backend": mesh.backend,
            "device": str(mesh.device),
        }
    if extra:
        man.update(_jsonable(extra))
    return man


class TelemetrySink:
    """Append-only JSONL event writer.

    Lines go through the file's buffer and reach the disk at
    :meth:`flush` and :meth:`close` (and after every event with
    ``line_buffered``), so a crashed run keeps everything up to its last
    drain.  A context manager; ``event_counts`` keeps totals per event
    type for a summary at the end of a run without reading the file."""

    def __init__(self, path: str, line_buffered: bool = False):
        self.path = str(path)
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        self._f = open(self.path, "a", encoding="utf-8")
        self._t0 = time.perf_counter()
        self._line_buffered = line_buffered
        self.event_counts: Dict[str, int] = {}

    def emit(self, event: str, **payload: Any) -> None:
        rec = {
            "event": event,
            "t": round(time.perf_counter() - self._t0, 6),
            "wall": round(time.time(), 3),
        }
        for k, v in payload.items():
            rec[k] = _jsonable(v)
        self._f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self.event_counts[event] = self.event_counts.get(event, 0) + 1
        if self._line_buffered:
            self._f.flush()

    def emit_many(self, event: str, records: List[Dict[str, Any]]) -> None:
        """Write records that are already strict JSON (the segment drain).
        They share one timestamp pair: they all land at one boundary."""
        if not records:
            return
        t = round(time.perf_counter() - self._t0, 6)
        wall = round(time.time(), 3)
        lines = []
        for payload in records:
            rec = {"event": event, "t": t, "wall": wall}
            rec.update(payload)
            lines.append(json.dumps(rec, separators=(",", ":")))
        self._f.write("\n".join(lines) + "\n")
        self.event_counts[event] = self.event_counts.get(event, 0) + len(records)
        if self._line_buffered:
            self._f.flush()

    def write_manifest(
        self,
        config: Any = None,
        extra: Optional[Dict[str, Any]] = None,
        device: Optional[Any] = None,
        mesh: Optional[Any] = None,
    ) -> Dict[str, Any]:
        man = run_manifest(config=config, extra=extra, device=device, mesh=mesh)
        self.emit("manifest", **man)
        self.flush()
        return man

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self) -> "TelemetrySink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _column(v: Any) -> List[Any]:
    """A stacked column as strict-JSON values: one vectorised check where
    the dtype cannot hold NaN or Inf or every value is finite, and the
    per-value sanitiser only otherwise."""
    a = _host(v) if isinstance(v, torch.Tensor) else np.asarray(v)
    if a.dtype.kind in "iub":
        return a.tolist()
    if a.dtype.kind == "f" and bool(np.isfinite(a).all()):
        return a.tolist()
    return _jsonable(a.tolist())


def drain_fl_outputs(sink: TelemetrySink, outputs: Dict[str, Any]) -> int:
    """One ``fl_round`` event per round of a segment's stacked outputs.
    The ``telemetry`` subtree (a :class:`~repro_torch.obs.telemetry.Telemetry`)
    joins the same event under its field names; the per-client ``avail``
    mask is left out (its mean is ``avail_frac``).  Returns the number of
    rounds drained."""
    host: Dict[str, Any] = {k: _column(v) for k, v in outputs.items() if k not in ("telemetry", "avail")}
    tel = outputs.get("telemetry")
    if tel is not None:
        for f in dataclasses.fields(tel):
            v = getattr(tel, f.name)
            if v is not None:
                host[f.name] = _column(v)
    if not host:
        return 0
    n = len(next(iter(host.values())))
    sink.emit_many("fl_round", [{k: v[i] for k, v in host.items()} for i in range(n)])
    sink.flush()
    return n


def load_events(path: str) -> List[Dict[str, Any]]:
    """A telemetry JSONL file as a list of event dicts."""
    events = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events
