"""The model zoo (port of ``repro.models``): decoder-only LMs of
``"attn"``, ``"swa"``, ``"mamba"`` and ``"rwkv"`` layers, dense or MoE,
and the encoder-decoder whisper."""
from repro_torch.models.common import ModelConfig  # noqa: F401
from repro_torch.models.registry import (  # noqa: F401
    Arch, LONG_CONTEXT_SKIP, SHAPES)
