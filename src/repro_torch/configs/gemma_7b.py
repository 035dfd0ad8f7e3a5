"""gemma-7b [dense]: 28L d_model=3072 16H (kv=16, i.e. MHA) d_ff=24576
vocab=256000 — GeGLU, head_dim=256 [arXiv:2403.08295].

Gemma particulars: GeGLU MLP, embeddings scaled by sqrt(d_model), q/k/v
projected to 16·256 = 4096 (≠ d_model), logits over a 256k vocab."""

from repro_torch.configs.base import FLRunConfig, ModelConfig
from repro_torch.configs.registry import SERVE_RULES, TRAIN_RULES, ArchSpec


def spec() -> ArchSpec:
    model = ModelConfig(
        name="gemma-7b",
        arch_type="dense",
        num_layers=28,
        d_model=3072,
        num_heads=16,
        num_kv_heads=16,
        head_dim=256,
        d_ff=24_576,
        vocab_size=256_000,
        block_pattern=("attn+mlp",),
        mlp_variant="geglu",
        embed_scale=True,
        rope_theta=10_000.0,
        tie_embeddings=True,
        param_dtype="bfloat16",
        dtype="bfloat16",
        remat=True,
    )
    rules_t = dict(TRAIN_RULES, kv_w="model")  # MHA: kv heads shard too
    rules_s = dict(SERVE_RULES, kv_w="model")
    return ArchSpec(
        model=model,
        fl=FLRunConfig(mode="client_parallel", local_steps=4, lr=2e-3),
        train_rules=rules_t,
        serve_rules=rules_s,
        optimizer="adam",
        long_context="swa_variant",
    )
