"""rwkv6-7b [ssm]: 32L d_model=4096 (attention-free) d_ff=14336
vocab=65536 — Finch, data-dependent decay [arXiv:2404.05892].

64 WKV heads of dim 64; the decode state is constant in the sequence
length (tm_x, cm_x and an fp32 (H, 64, 64) WKV state per layer)."""

from repro_torch.configs.base import FLRunConfig, ModelConfig
from repro_torch.configs.registry import SERVE_RULES, TRAIN_RULES, ArchSpec


def spec() -> ArchSpec:
    model = ModelConfig(
        name="rwkv6-7b",
        arch_type="ssm",
        num_layers=32,
        d_model=4096,
        num_heads=64,  # wkv heads (d_model / rwkv_head_dim)
        num_kv_heads=64,
        head_dim=64,
        d_ff=14_336,
        vocab_size=65_536,
        block_pattern=("rwkv+cmix",),
        pos_style="none",
        rwkv_head_dim=64,
        tie_embeddings=False,
        param_dtype="bfloat16",
        dtype="bfloat16",
        remat=True,
    )
    rules_t, rules_s = dict(TRAIN_RULES), dict(SERVE_RULES)
    return ArchSpec(
        model=model,
        fl=FLRunConfig(mode="client_parallel", local_steps=2, lr=2e-3),
        train_rules=rules_t,
        serve_rules=rules_s,
        optimizer="adam",
        long_context="native",
    )
