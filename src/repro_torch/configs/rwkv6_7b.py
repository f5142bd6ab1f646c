"""rwkv6-7b [ssm]: 32L d_model=4096 (attention-free) d_ff=14336 vocab=65536
— Finch: data-dependent decay WKV recurrence.  [arXiv:2404.05892]
Attention-free => runs long_500k (O(1) state).
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6_7b",
        num_layers=32,
        d_model=4096,
        num_heads=64,           # 4096 / rwkv_head_dim(64)
        num_kv_heads=64,
        head_dim=64,
        d_ff=14336,
        vocab_size=65536,
        block_pattern=("rwkv",),
        norm_type="layernorm",
        embed_norm=True,
        rwkv_head_dim=64,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6_7b_reduced",
        num_layers=4,
        d_model=128,
        num_heads=8,
        num_kv_heads=8,
        head_dim=16,
        d_ff=256,
        vocab_size=512,
        block_pattern=("rwkv",),
        norm_type="layernorm",
        embed_norm=True,
        rwkv_head_dim=16,
        dtype="float32",
    )
