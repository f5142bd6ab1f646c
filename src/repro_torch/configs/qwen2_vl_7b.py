"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — M-RoPE (t/h/w sections), dynamic-resolution vision frontend
STUBBED: input_specs() provides precomputed patch/token embeddings plus the
(3, B, S) multimodal position ids.  [arXiv:2409.12191]
Full attention => long_500k SKIPPED.
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2_vl_7b",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152_064,
        block_pattern=("attn",),
        qkv_bias=True,
        rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),   # t/h/w frequency sections (sum=Dh/2)
        input_mode="embeds",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2_vl_7b_reduced",
        num_layers=4,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        block_pattern=("attn",),
        qkv_bias=True,
        mrope_sections=(6, 5, 5),
        input_mode="embeds",
        dtype="float32",
    )
