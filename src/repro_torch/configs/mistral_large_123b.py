"""mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8)
d_ff=28672 vocab=32768.  [hf:mistralai/Mistral-Large-Instruct-2407]

Full attention (no sliding window in the 2407 config) => long_500k SKIPPED
(pure full-attention rule; see DESIGN.md §Arch-applicability).
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral_large_123b",
        num_layers=88,
        d_model=12288,
        num_heads=96,
        num_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=32768,
        block_pattern=("attn",),
        rope_theta=1_000_000.0,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="mistral_large_123b_reduced",
        num_layers=4,
        d_model=128,
        num_heads=8,
        num_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab_size=512,
        block_pattern=("attn",),
        rope_theta=1_000_000.0,
        dtype="float32",
    )
