"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — M-RoPE, dynamic resolution [arXiv:2409.12191].

The vision tower and projector are a stub, as in the JAX package: the
language decoder takes precomputed embeddings (B, S, d_model)
(``transformer.forward(embeds=...)``) with the (3, B, S) M-RoPE position
streams (temporal, height, width); for text the three are equal."""

from repro_torch.configs.base import FLRunConfig, ModelConfig
from repro_torch.configs.registry import SERVE_RULES, TRAIN_RULES, ArchSpec


def spec() -> ArchSpec:
    model = ModelConfig(
        name="qwen2-vl-2b",
        arch_type="vlm",
        num_layers=28,
        d_model=1536,
        num_heads=12,
        num_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab_size=151_936,
        block_pattern=("attn+mlp",),
        mlp_variant="swiglu",
        pos_style="mrope",
        mrope_sections=(16, 24, 24),  # t/h/w frequency sections (sum = hd/2)
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        param_dtype="bfloat16",
        dtype="bfloat16",
        remat=True,
    )
    # 12 heads do not divide the 16-way model axis, and sharding the fused
    # 12·128 head dim would split heads: the attention projections shard
    # on their embed dims (1536 = 16·96 = 32·48)
    rules_t = dict(TRAIN_RULES, heads_w=None, attn_in_w="model")
    rules_s = dict(SERVE_RULES, heads_w=None, attn_in_w="model", attn_out_w="model")
    return ArchSpec(
        model=model,
        fl=FLRunConfig(mode="client_parallel", local_steps=4, lr=3e-3),
        train_rules=rules_t,
        serve_rules=rules_s,
        optimizer="adam",
        long_context="swa_variant",
    )
