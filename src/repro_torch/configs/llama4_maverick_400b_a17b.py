"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1
[hf:meta-llama/Llama-4-Scout-17B-16E].

Maverick interleaves MoE every other layer (period 2), with a shared
expert beside the 128 routed experts and a sigmoid top-1 router:
24 MoE layers × 128 × 3 × 5120 × 8192 ≈ 386 B routed parameters, about
400 B in all and ~17 B active per token.  The vocabulary pads to
202,112."""

from repro_torch.configs.base import FLRunConfig, ModelConfig
from repro_torch.configs.registry import SERVE_RULES, TRAIN_RULES, ArchSpec


def spec() -> ArchSpec:
    model = ModelConfig(
        name="llama4-maverick-400b-a17b",
        arch_type="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202_048,
        block_pattern=("attn+mlp", "attn+moe"),  # MoE every other layer
        mlp_variant="swiglu",
        rope_theta=500_000.0,
        num_experts=128,
        experts_per_token=1,
        router_type="sigmoid",
        shared_expert=True,
        capacity_factor=1.25,
        tie_embeddings=False,
        param_dtype="bfloat16",
        dtype="bfloat16",
        remat=True,
    )
    # 40 heads do not divide 16: attention shards on its embed dims; the
    # experts shard over both axes (128 over data, d_ff over model)
    rules_t = dict(
        TRAIN_RULES, heads_w=None, attn_in_w="model", experts_w="data", expert_mlp_w="model", act_experts="data"
    )
    rules_s = dict(
        SERVE_RULES, heads_w=None, attn_in_w="model", attn_out_w="model", experts_w="data",
        expert_mlp_w="model", act_experts="data",
    )
    return ArchSpec(
        model=model,
        fl=FLRunConfig(mode="fedsgd_fsdp", local_steps=1, lr=1e-3, micro_batches=8),
        train_rules=rules_t,
        serve_rules=rules_s,
        optimizer="adafactor",
        long_context="swa_variant",
    )
