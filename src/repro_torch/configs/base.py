"""Model and FL-run configuration of the port's decoder LMs.

The port's own copies of ``ModelConfig`` (the JAX package's field names and
defaults, ``q_dim``, ``kv_dim``, ``layer_types`` and ``reduced``), of
``FLRunConfig`` and of the dry run's four ``INPUT_SHAPES``.  The sharding
rules live beside each arch's spec (``registry.SERVE_RULES`` and
``TRAIN_RULES``, read by ``launch/sharding.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["FLRunConfig", "INPUT_SHAPES", "InputShape", "ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # the repeating unit of "mixer+ffn" layer specs; layers =
    # pattern * (num_layers // len(pattern)) + pattern[:remainder].
    # mixers: attn | swa | local | rglru | rwkv;  ffns: mlp | moe | cmix.
    block_pattern: Tuple[str, ...] = ("attn+mlp",)
    mlp_variant: str = "swiglu"  # swiglu | geglu | gelu
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    pos_style: str = "rope"  # rope | mrope | sinusoidal | none
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    window: int = 4096  # window of "swa" blocks
    # query-chunked attention (exact): live scores are (B, Hk, G, chunk, Skv)
    # instead of (..., Sq, Skv); chunk >= Sq is the single-block path
    attention_chunk: Optional[int] = 512
    embed_scale: bool = False  # gemma: scale embeddings by sqrt(d_model)
    logits_soft_cap: Optional[float] = None
    tie_embeddings: bool = True
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    router_type: str = "softmax"
    shared_expert: bool = False
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # RWKV
    rwkv_head_dim: int = 64
    # hybrid (recurrentgemma)
    rnn_width: Optional[int] = None
    local_window: int = 2048  # window of "local" blocks
    # numerics
    param_dtype: str = "float32"
    dtype: str = "float32"  # activation and cache dtype
    remat: bool = False
    scan_unroll: object = 1
    loss_chunk: int = 512
    loss_unroll: object = 1

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def layer_types(self) -> Tuple[str, ...]:
        p = self.block_pattern
        reps, rem = divmod(self.num_layers, len(p))
        return p * reps + p[:rem]

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-sized variant of the same family (<=2 repeat units,
        d_model<=256, <=4 heads, <=4 experts)."""
        small: Dict = dict(
            num_layers=min(self.num_layers, 2 * len(self.block_pattern)),
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=64,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            rnn_width=None if self.rnn_width is None else 256,
            rwkv_head_dim=min(self.rwkv_head_dim, 64),
            window=min(self.window, 64),
            local_window=min(self.local_window, 64),
        )
        if self.num_experts:
            small["num_experts"] = min(self.num_experts, 4)
            small["experts_per_token"] = min(self.experts_per_token, 2)
        if self.pos_style == "mrope":
            old_d2 = sum(self.mrope_sections)
            new_d2 = small["head_dim"] // 2
            t = max(1, self.mrope_sections[0] * new_d2 // old_d2)
            h = max(1, self.mrope_sections[1] * new_d2 // old_d2)
            small["mrope_sections"] = (t, h, new_d2 - t - h)
        # kv heads must divide q heads
        if small["num_heads"] % small["num_kv_heads"]:
            small["num_kv_heads"] = 1
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class FLRunConfig:
    """How FL rounds execute for an architecture, the JAX package's fields
    and defaults.  The launchers read ``lr``; the dry run
    (``launch/dryrun.py``) reads all five: ``mode`` picks Mode A
    (``build_client_parallel_round`` with ``local_steps`` and
    ``micro_batches``) or Mode B (``build_fedsgd_step`` with the arch's
    ``optimizer`` and ``micro_batches``)."""

    mode: str = "client_parallel"  # client_parallel (Mode A) | fedsgd_fsdp (Mode B)
    local_steps: int = 4  # E (Mode A); Mode B is inherently E = 1
    lr: float = 1e-2
    optimizer: str = "sgd"  # Mode-B server optimizer: sgd | adam | adafactor
    micro_batches: int = 4  # grad accumulation within each local step (exact)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
