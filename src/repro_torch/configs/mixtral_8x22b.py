"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768 — 8 experts top-2, SWA.  [arXiv:2401.04088]
SWA => runs long_500k.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral_8x22b",
        num_layers=56,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=32768,
        block_pattern=("swa",),
        sliding_window=4096,
        moe_num_experts=8,
        moe_top_k=2,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral_8x22b_reduced",
        num_layers=4,
        d_model=192,
        num_heads=6,
        num_kv_heads=2,
        head_dim=32,
        d_ff=384,
        vocab_size=512,
        block_pattern=("swa",),
        sliding_window=16,
        moe_num_experts=4,
        moe_top_k=2,
        moe_capacity_factor=2.0,
        dtype="float32",
    )
