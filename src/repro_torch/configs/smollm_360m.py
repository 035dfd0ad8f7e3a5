"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560
vocab=49152 — llama-arch small [hf:HuggingFaceTB/SmolLM-135M]."""

from repro_torch.configs.base import FLRunConfig, ModelConfig
from repro_torch.configs.registry import SERVE_RULES, TRAIN_RULES, ArchSpec


def spec() -> ArchSpec:
    model = ModelConfig(
        name="smollm-360m",
        arch_type="dense",
        num_layers=32,
        d_model=960,
        num_heads=15,
        num_kv_heads=5,
        head_dim=64,
        d_ff=2560,
        vocab_size=49_152,
        block_pattern=("attn+mlp",),
        mlp_variant="swiglu",
        rope_theta=10_000.0,
        tie_embeddings=True,
        param_dtype="bfloat16",
        dtype="bfloat16",
        remat=True,
    )
    # 15 heads and 5 kv heads divide neither 16 nor 32: the attention
    # projections shard on their embed dims (960 = 16·60 = 32·30)
    rules_t = dict(TRAIN_RULES, heads_w=None, attn_in_w="model")
    rules_s = dict(SERVE_RULES, heads_w=None, attn_in_w="model", attn_out_w="model")
    return ArchSpec(
        model=model,
        fl=FLRunConfig(mode="client_parallel", local_steps=8, lr=5e-3),
        train_rules=rules_t,
        serve_rules=rules_s,
        optimizer="adam",
        long_context="swa_variant",
    )
