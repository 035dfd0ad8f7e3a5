"""Continuous-batching serving engine."""

from repro_torch.serve.engine import (
    DecodeState,
    Finished,
    ServeConfig,
    ServeEngine,
    init_decode_state,
    make_admit_fn,
    make_decode_fn,
    run_scan,
    run_while,
)
from repro_torch.serve.sampling import gumbel_rows, sample_tokens, slot_noise

__all__ = [
    "DecodeState",
    "Finished",
    "ServeConfig",
    "ServeEngine",
    "init_decode_state",
    "make_admit_fn",
    "make_decode_fn",
    "run_scan",
    "run_while",
    "gumbel_rows",
    "sample_tokens",
    "slot_noise",
]
