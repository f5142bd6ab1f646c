"""olmo-1b [dense]: 16L d_model=2048 16H (kv=16, i.e. MHA) d_ff=8192
vocab=50304 — non-parametric LayerNorm.  [arXiv:2402.00838]
Full attention => long_500k SKIPPED.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmo_1b",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=8192,
        vocab_size=50304,
        block_pattern=("attn",),
        norm_type="nonparam_ln",
        tie_embeddings=True,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="olmo_1b_reduced",
        num_layers=4,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        block_pattern=("attn",),
        norm_type="nonparam_ln",
        tie_embeddings=True,
        dtype="float32",
    )
