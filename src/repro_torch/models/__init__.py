"""The model zoo's attention family: decoder-only transformers of
``"attn"`` / ``"swa"`` layers, dense or MoE (port of ``repro.models``)."""
from repro_torch.models.common import ModelConfig  # noqa: F401
from repro_torch.models.registry import (  # noqa: F401
    Arch, LONG_CONTEXT_SKIP, SHAPES)
