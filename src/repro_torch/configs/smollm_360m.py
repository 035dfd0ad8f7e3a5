"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560
vocab=49152 — llama-arch small [hf:HuggingFaceTB/SmolLM-135M]."""

from repro_torch.configs.base import FLRunConfig, ModelConfig
from repro_torch.configs.registry import ArchSpec


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
    return ArchSpec(
        model=model,
        fl=FLRunConfig(mode="client_parallel", local_steps=8, lr=5e-3),
        optimizer="adam",
        long_context="swa_variant",
    )
