"""internlm2-20b [dense]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544 — GQA [arXiv:2403.17297]."""

from repro_torch.configs.base import FLRunConfig, ModelConfig
from repro_torch.configs.registry import SERVE_RULES, TRAIN_RULES, ArchSpec


def spec() -> ArchSpec:
    model = ModelConfig(
        name="internlm2-20b",
        arch_type="dense",
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16_384,
        vocab_size=92_544,
        block_pattern=("attn+mlp",),
        mlp_variant="swiglu",
        rope_theta=1_000_000.0,
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
        long_context="swa_variant",
    )
