"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000 — local/global alternating attention, logit softcaps,
sandwich norms, scaled embeddings.  [arXiv:2408.00118]

46 layers = 23 × (local SWA-4096, global) superblocks.  Half the layers are
sliding-window => runs long_500k (not pure full attention).
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2_27b",
        num_layers=46,
        d_model=4608,
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,
        d_ff=36864,
        vocab_size=256_000,
        block_pattern=("swa", "attn"),
        sliding_window=4096,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        query_scale=144.0 ** -0.5,   # query_pre_attn_scalar = d_model/heads
        scale_embeddings=True,
        post_block_norm=True,
        tie_embeddings=True,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2_27b_reduced",
        num_layers=4,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        block_pattern=("swa", "attn"),
        sliding_window=16,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        query_scale=32.0 ** -0.5,
        scale_embeddings=True,
        post_block_norm=True,
        tie_embeddings=True,
        dtype="float32",
    )
