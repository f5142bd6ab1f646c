"""Carry the reference model's parameters into the port.

The reference's ``init_params`` returns a pytree whose layers are stacked
on a leading axis: a decoder-only LM's ``params["blocks"][i]`` holds
pattern position i's leaves (attention, Mamba or RWKV mixers, MLP, MoE or
channel mix) over the R superblocks, whisper's ``params["enc"]`` and
``params["dec"]`` hold each stack over its layers.  The port holds one
dict a layer: ``params["blocks"][r][i]``, ``params["enc"][l]``,
``params["dec"][l]``.  ``params_from_reference`` takes the reference's
tree as numpy arrays (the caller applies ``np.asarray`` to every leaf) and
splits it, so that both packages compute one function on one set of
weights.  Every other leaf has the same name and shape in both.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.common import ModelConfig


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=device)


def _take(tree, r: int, device):
    """Layer (or superblock) r's slice of a stacked subtree."""
    if isinstance(tree, dict):
        return {k: _take(v, r, device) for k, v in tree.items()}
    return _tensor(np.asarray(tree)[r], device)


def _whole(tree, device):
    if isinstance(tree, dict):
        return {k: _whole(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def params_from_reference(cfg: ModelConfig, tree: dict, device=None) -> dict:
    """The port's parameters (on ``device``, CUDA unless named) from the
    reference's ``init_params(cfg, key)[0]`` as numpy arrays."""
    device = resolve_device(device)
    stacks = {"enc": cfg.encoder_layers, "dec": cfg.num_layers} \
        if cfg.encoder_layers > 0 else {}
    out = {k: _whole(v, device) for k, v in tree.items()
           if k != "blocks" and k not in stacks}
    for k, n in stacks.items():
        out[k] = [_take(tree[k], l, device) for l in range(n)]
    if stacks:
        return out
    stacked = tree["blocks"]
    if len(stacked) != len(cfg.block_pattern):
        raise ValueError(f"{len(stacked)} stacked blocks for the pattern "
                         f"{cfg.block_pattern}")
    out["blocks"] = [[_take(stacked[i], r, device)
                      for i in range(len(cfg.block_pattern))]
                     for r in range(cfg.num_superblocks)]
    return out
