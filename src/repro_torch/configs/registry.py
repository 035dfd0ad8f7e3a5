"""Registry of the assigned architectures, by the JAX package's names.

``get_arch(name)`` returns the ``ArchSpec`` of an arch whose mixers, FFNs
and position encoding the port runs (the dense ``attn+mlp`` family and the
RWKV-6 ``rwkv+cmix`` family).  For the others it raises
``NotImplementedError`` naming what is missing and the ROADMAP slice that
brings it.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import FLRunConfig, ModelConfig

__all__ = ["ArchSpec", "get_arch", "ARCH_NAMES"]

ARCH_NAMES = [
    "granite-3-2b",
    "qwen2-vl-2b",
    "internlm2-20b",
    "smollm-360m",
    "gemma-7b",
    "recurrentgemma-9b",
    "llama4-maverick-400b-a17b",
    "rwkv6-7b",
    "mixtral-8x7b",
    "musicgen-medium",
]

# arch -> what the port does not run yet (ROADMAP Queue 1, Slice 2 item 8)
NOT_PORTED = {
    "qwen2-vl-2b": "M-RoPE positions",
    "recurrentgemma-9b": "RG-LRU mixers",
    "llama4-maverick-400b-a17b": "MoE FFNs",
    "mixtral-8x7b": "MoE FFNs",
    "musicgen-medium": "sinusoidal positions",
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """An arch's published model configuration, its FL run settings and its
    pretrain optimizer (the JAX package's spec without the sharding rules
    and notes)."""

    model: ModelConfig
    fl: FLRunConfig = FLRunConfig()
    optimizer: str = "adam"  # Mode-B / pretrain optimizer


def get_arch(name: str) -> ArchSpec:
    if name not in ARCH_NAMES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name} needs {NOT_PORTED[name]}, which the port does not run yet "
            "(ROADMAP Queue 1, Slice 2 item 8)"
        )
    module = importlib.import_module("repro_torch.configs." + name.replace("-", "_"))
    return module.spec()
