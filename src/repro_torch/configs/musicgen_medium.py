"""musicgen-medium [audio]: 48L d_model=1536 24H (kv=24, MHA) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens [arXiv:2306.05284].

The EnCodec codec is a stub, as in the JAX package: the decoder takes
codebook token ids (vocab 2048), or precomputed embeddings; LayerNorm,
GELU and sinusoidal absolute positions, MHA."""

from repro_torch.configs.base import FLRunConfig, ModelConfig
from repro_torch.configs.registry import SERVE_RULES, TRAIN_RULES, ArchSpec


def spec() -> ArchSpec:
    model = ModelConfig(
        name="musicgen-medium",
        arch_type="audio",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        head_dim=64,
        d_ff=6144,
        vocab_size=2048,
        block_pattern=("attn+mlp",),
        mlp_variant="gelu",
        norm_type="layernorm",
        pos_style="sinusoidal",
        tie_embeddings=False,
        param_dtype="bfloat16",
        dtype="bfloat16",
        remat=True,
    )
    # 24 heads do not divide 16: attention shards on embed (1536 = 16·96);
    # the 2048-entry vocabulary is replicated
    rules_t = dict(TRAIN_RULES, heads_w=None, attn_in_w="model", vocab_w=None)
    rules_s = dict(SERVE_RULES, heads_w=None, attn_in_w="model", attn_out_w="model", vocab_w=None)
    return ArchSpec(
        model=model,
        fl=FLRunConfig(mode="client_parallel", local_steps=8, lr=3e-3),
        train_rules=rules_t,
        serve_rules=rules_s,
        optimizer="adam",
        long_context="swa_variant",
    )
