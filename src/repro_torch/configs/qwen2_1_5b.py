"""qwen2-1.5b [dense]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — QKV bias, tied embeddings.  [arXiv:2407.10671]
Full attention => long_500k SKIPPED.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2_1_5b",
        num_layers=28,
        d_model=1536,
        num_heads=12,
        num_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab_size=151_936,
        block_pattern=("attn",),
        qkv_bias=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2_1_5b_reduced",
        num_layers=4,
        d_model=96,
        num_heads=6,
        num_kv_heads=2,
        head_dim=16,
        d_ff=192,
        vocab_size=512,
        block_pattern=("attn",),
        qkv_bias=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        dtype="float32",
    )
