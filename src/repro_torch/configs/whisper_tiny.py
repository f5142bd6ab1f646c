"""whisper-tiny [audio]: 4L enc + 4L dec, d_model=384 6H (MHA) d_ff=1536
vocab=51865 — encoder-decoder; conv/log-mel frontend STUB (input_specs()
provides precomputed frame embeddings).  [arXiv:2212.04356]
Decoder is full attention => long_500k SKIPPED (also beyond the arch's
positional design).
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper_tiny",
        num_layers=4,                # decoder layers
        encoder_layers=4,
        encoder_seq=1500,
        d_model=384,
        num_heads=6,
        num_kv_heads=6,
        head_dim=64,
        d_ff=1536,
        vocab_size=51865,
        block_pattern=("attn",),
        norm_type="layernorm",
        tie_embeddings=True,
        input_mode="embeds",         # frame embeddings for the encoder
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="whisper_tiny_reduced",
        num_layers=2,
        encoder_layers=2,
        encoder_seq=50,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        block_pattern=("attn",),
        norm_type="layernorm",
        tie_embeddings=True,
        input_mode="embeds",
        dtype="float32",
    )
