"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000 — 8 experts top-2, sliding-window attention everywhere.
[arXiv:2401.04088]
SWA(4096) => sub-quadratic => runs long_500k.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral_8x7b",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32000,
        block_pattern=("swa",),
        sliding_window=4096,
        moe_num_experts=8,
        moe_top_k=2,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral_8x7b_reduced",
        num_layers=4,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        block_pattern=("swa",),
        sliding_window=16,
        moe_num_experts=4,
        moe_top_k=2,
        moe_capacity_factor=2.0,
        dtype="float32",
    )
