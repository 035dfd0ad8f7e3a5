"""Profiler hooks over ``torch.profiler``.

* :func:`trace` profiles the enclosed block, host and card, and writes a
  Chrome trace (``*.pt.trace.json``, loadable in TensorBoard's profiler
  plugin, Perfetto or ``chrome://tracing``) into a directory when the
  block ends; a ``None`` directory is a no-op, so a launcher passes
  ``--profile-dir`` through as it is.
* :func:`annotate` is a named host span (``torch.profiler.record_function``)
  around the boundaries that matter: segments of rounds, reprofiles,
  admissions and decode chunks.  A span records only while a trace is
  active, and adds no device synchronise.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

__all__ = ["annotate", "trace"]


@contextlib.contextmanager
def trace(profile_dir: Optional[str]) -> Iterator[None]:
    """Profile the enclosed block into ``profile_dir`` (no-op when None):
    CPU activity always, CUDA activity when a card is present."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(profile_dir))):
        yield


def annotate(name: str) -> torch.profiler.record_function:
    """A named span in the active trace (none is recorded without one)."""
    return torch.profiler.record_function(name)
