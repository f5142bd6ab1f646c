"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2 — Mamba:attention 7:1 interleave, MoE
every 2nd layer.  [arXiv:2403.19887]

32 layers = 4 × 8-layer superblocks; attention sits at position 3 (the
paper places one attention layer per 8).  SSM-dominated => runs long_500k.
"""
from repro_torch.models.common import ModelConfig

_PATTERN = ("mamba", "mamba", "mamba", "attn",
            "mamba", "mamba", "mamba", "mamba")


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba_v01_52b",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        block_pattern=_PATTERN,
        moe_num_experts=16,
        moe_top_k=2,
        moe_layer_period=2,
        mamba_d_state=16,
        mamba_d_conv=4,
        mamba_expand=2,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="jamba_v01_52b_reduced",
        num_layers=8,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        block_pattern=_PATTERN,
        moe_num_experts=4,
        moe_top_k=2,
        moe_capacity_factor=2.0,
        moe_layer_period=2,
        mamba_d_state=8,
        mamba_d_conv=4,
        mamba_expand=2,
        dtype="float32",
    )
