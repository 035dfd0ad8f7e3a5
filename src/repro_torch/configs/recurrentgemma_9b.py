"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (kv=1, MQA) d_ff=12288
vocab=256000 — RG-LRU + local attention, 2 recurrent : 1 local
[arXiv:2402.19427].

Griffin's block pattern (rglru, rglru, local) × 12 plus 2 recurrent
layers = 38.  The local attention's window is 2048, and the RG-LRU state
is constant in the sequence length.  Neither reaches a kernel."""

from repro_torch.configs.base import FLRunConfig, ModelConfig
from repro_torch.configs.registry import SERVE_RULES, TRAIN_RULES, ArchSpec


def spec() -> ArchSpec:
    model = ModelConfig(
        name="recurrentgemma-9b",
        arch_type="hybrid",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        head_dim=256,
        d_ff=12_288,
        vocab_size=256_000,
        block_pattern=("rglru+mlp", "rglru+mlp", "local+mlp"),
        mlp_variant="geglu",
        embed_scale=True,
        rope_theta=10_000.0,
        local_window=2048,
        rnn_width=4096,
        tie_embeddings=True,
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
