"""Structured telemetry for both engines.

Three layers, kept apart so that none of them changes what a round or a
decode step computes:

* :mod:`repro_torch.obs.telemetry`: the :class:`Telemetry` record of
  per-round diagnostics that rides a federation round's outputs when, and
  only when, ``FLConfig.telemetry`` is set; with it off the outputs have
  no ``telemetry`` key.
* :mod:`repro_torch.obs.sink`: the host side, a JSONL event writer
  (:class:`TelemetrySink`) and the run manifest (config and its hash,
  torch, CUDA and card, git SHA).  The engines hand it events at segment,
  admission, harvest and decode-chunk boundaries only.
* :mod:`repro_torch.obs.tracing`: ``torch.profiler`` wrappers
  (:func:`trace`, :func:`annotate`).

The package imports only torch, numpy and the standard library: ``fl/``
and ``serve/`` import it, never the reverse.
"""

from repro_torch.obs.sink import (
    TelemetrySink,
    config_hash,
    drain_fl_outputs,
    load_events,
    run_manifest,
)
from repro_torch.obs.telemetry import Telemetry, round_telemetry
from repro_torch.obs.tracing import annotate, trace

__all__ = [
    "Telemetry",
    "TelemetrySink",
    "annotate",
    "config_hash",
    "drain_fl_outputs",
    "load_events",
    "round_telemetry",
    "trace",
]
