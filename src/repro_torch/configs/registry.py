"""Registry of the assigned architectures, by the JAX package's names.

``get_arch(name)`` returns the arch's ``ArchSpec``: its published model
configuration, FL run settings, pretrain optimizer and long-context form.
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


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """An arch's published model configuration, its FL run settings, its
    pretrain optimizer and how it reaches the long_500k shape (the JAX
    package's spec without the sharding rules and notes)."""

    model: ModelConfig
    fl: FLRunConfig = FLRunConfig()
    optimizer: str = "adam"  # Mode-B / pretrain optimizer
    long_context: str = "swa_variant"  # native | swa_variant

    def long_context_model(self) -> ModelConfig:
        """Model config used for the long_500k shape: the model itself when
        ``native``, else every full-attention block made sliding-window."""
        if self.long_context == "native":
            return self.model
        pattern = tuple(b.replace("attn+", "swa+") for b in self.model.block_pattern)
        return dataclasses.replace(self.model, block_pattern=pattern)


def get_arch(name: str) -> ArchSpec:
    if name not in ARCH_NAMES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    module = importlib.import_module("repro_torch.configs." + name.replace("-", "_"))
    return module.spec()
