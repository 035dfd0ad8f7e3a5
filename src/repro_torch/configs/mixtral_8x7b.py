"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, 8 experts top-2, sliding-window attention [arXiv:2401.04088].

Every layer is SWA (window 4096) + MoE, with softmax-over-top-2 routing.
Its windowed attention reaches no kernel (K5 and K6 take attention
without a window)."""

from repro_torch.configs.base import FLRunConfig, ModelConfig
from repro_torch.configs.registry import SERVE_RULES, TRAIN_RULES, ArchSpec


def spec() -> ArchSpec:
    model = ModelConfig(
        name="mixtral-8x7b",
        arch_type="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14_336,
        vocab_size=32_000,
        block_pattern=("swa+moe",),
        mlp_variant="swiglu",
        rope_theta=1_000_000.0,
        window=4096,
        num_experts=8,
        experts_per_token=2,
        router_type="softmax",
        capacity_factor=1.25,
        tie_embeddings=False,
        param_dtype="bfloat16",
        dtype="bfloat16",
        remat=True,
    )
    # 8 experts < the 16-way model axis: experts replicate and d_ff shards;
    # training puts the FSDP axis on the experts' embed dim
    rules_t = dict(TRAIN_RULES, experts_w=None, expert_embed_w="data", expert_mlp_w="model")
    rules_s = dict(SERVE_RULES, experts_w=None, expert_mlp_w="model")
    return ArchSpec(
        model=model,
        fl=FLRunConfig(mode="client_parallel", local_steps=2, lr=2e-3),
        train_rules=rules_t,
        serve_rules=rules_s,
        optimizer="adafactor",
        long_context="native",
    )
