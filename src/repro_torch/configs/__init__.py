"""The ten architecture configs of the reference (``repro.configs``), each
with its full-size ``config()`` and its reduced same-family
``reduced_config()``.  ``get_config(name)`` / ``list_archs()``."""
from __future__ import annotations

import importlib

ARCHS = [
    "mistral_large_123b",
    "gemma2_27b",
    "olmo_1b",
    "qwen2_1_5b",
    "jamba_v01_52b",
    "qwen2_vl_7b",
    "mixtral_8x7b",
    "mixtral_8x22b",
    "rwkv6_7b",
    "whisper_tiny",
]

ALIASES = {a.replace("_", "-"): a for a in ARCHS}
ALIASES.update({
    "mistral-large-123b": "mistral_large_123b",
    "gemma2-27b": "gemma2_27b",
    "olmo-1b": "olmo_1b",
    "qwen2-1.5b": "qwen2_1_5b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "mixtral-8x22b": "mixtral_8x22b",
    "rwkv6-7b": "rwkv6_7b",
    "whisper-tiny": "whisper_tiny",
})


def get_config(name: str, reduced: bool = False):
    """Full-size config, or the reduced same-family smoke config."""
    mod_name = ALIASES.get(name, name)
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.reduced_config() if reduced else mod.config()


def list_archs():
    return list(ARCHS)
