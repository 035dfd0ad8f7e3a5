"""granite-3-2b [dense]: 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155 — GQA [hf:ibm-granite/granite-3.0-2b-base]."""

from repro_torch.configs.base import FLRunConfig, ModelConfig
from repro_torch.configs.registry import SERVE_RULES, TRAIN_RULES, ArchSpec


def spec() -> ArchSpec:
    model = ModelConfig(
        name="granite-3-2b",
        arch_type="dense",
        num_layers=40,
        d_model=2048,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab_size=49_155,
        block_pattern=("attn+mlp",),
        mlp_variant="swiglu",
        rope_theta=10_000.0,
        tie_embeddings=True,
        param_dtype="bfloat16",
        dtype="bfloat16",
        remat=True,
    )
    rules_t, rules_s = dict(TRAIN_RULES), dict(SERVE_RULES)
    return ArchSpec(
        model=model,
        fl=FLRunConfig(mode="client_parallel", local_steps=4, lr=3e-3),
        train_rules=rules_t,
        serve_rules=rules_s,
        optimizer="adam",
        long_context="swa_variant",
    )
