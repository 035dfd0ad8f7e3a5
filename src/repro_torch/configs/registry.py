"""Registry of the assigned architectures, by the JAX package's names.

``get_arch(name)`` returns the arch's ``ArchSpec``: its published model
configuration, FL run settings, logical-axis sharding rules, pretrain
optimizer and long-context form.
"""

from __future__ import annotations

import dataclasses
import importlib

from typing import Dict, Optional

from repro_torch.configs.base import FLRunConfig, ModelConfig

__all__ = ["ArchSpec", "get_arch", "ARCH_NAMES", "SERVE_RULES", "TRAIN_RULES"]

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


# Baseline logical -> mesh-axis rules (``launch/sharding.py``), the JAX
# package's; arch modules override entries.  'data' widens to ('pod',
# 'data') on the multi-pod mesh.
SERVE_RULES: Dict[str, Optional[str]] = {
    "act_batch": "data",
    "act_seq": None,
    "act_embed": None,
    "embed_w": None,
    "embed_w_vec": None,
    "vocab_w": "model",
    "heads_w": "model",
    "attn_in_w": None,
    "attn_out_w": None,
    "kv_w": None,  # most archs have fewer than 16 kv heads: replicated
    "mlp_w": "model",
    "att_w": "model",
    "rnn_w": "model",
    "experts_w": None,
    "expert_embed_w": None,
    "expert_mlp_w": "model",
    "cache_seq": "model",
    "embed_act": None,
    "rwkv_heads": "model",
    "act_experts": None,
    # axes the hillclimb's variants set (analysis/hillclimb.py); None keeps
    # the baseline layout
    "att_vec_w": None,  # rwkv decay and group-norm vectors beside att_w
    "act_rwkv_h": None,  # head sharding of the wkv inputs r/k/v/w
    "act_attn_b": None,  # batch-parallel attention (heads that cannot shard)
    "act_attn_h": None,  # head sharding of q
    "act_attn_kv": None,  # head sharding of k and v
    "act_inner_b": None,  # Mode A's per-client local batch
}

TRAIN_RULES: Dict[str, Optional[str]] = dict(
    SERVE_RULES,
    embed_w="data",  # FSDP-style second axis on the big matrices
    attn_in_w="data",
    attn_out_w="data",
    expert_embed_w=None,
)


def _train_rules() -> Dict[str, Optional[str]]:
    return dict(TRAIN_RULES)


def _serve_rules() -> Dict[str, Optional[str]]:
    return dict(SERVE_RULES)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """An arch's published model configuration, its FL run settings, its
    sharding rules for training and serving, its pretrain optimizer and
    how it reaches the long_500k shape (the JAX package's spec without its
    notes)."""

    model: ModelConfig
    fl: FLRunConfig = FLRunConfig()
    train_rules: Dict[str, Optional[str]] = dataclasses.field(default_factory=_train_rules)
    serve_rules: Dict[str, Optional[str]] = dataclasses.field(default_factory=_serve_rules)
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
