"""Carry the reference model's parameters into the port.

The reference's ``init_params`` returns a pytree whose blocks are stacked
over the superblocks: ``params["blocks"][i]`` holds pattern position i's
leaves with a leading axis R.  The port holds one dict a layer,
``params["blocks"][r][i]``.  ``params_from_reference`` takes the
reference's tree as numpy arrays (the caller applies ``np.asarray`` to
every leaf) and splits it, so that both packages compute one function on
one set of weights.  Every other leaf has the same name and shape in both.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import check_ported


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=device)


def _take(tree, r: int, device):
    """Superblock r's slice of a stacked subtree."""
    if isinstance(tree, dict):
        return {k: _take(v, r, device) for k, v in tree.items()}
    return _tensor(np.asarray(tree)[r], device)


def params_from_reference(cfg: ModelConfig, tree: dict, device=None) -> dict:
    """The port's parameters (on ``device``, CUDA unless named) from the
    reference's ``init_params(cfg, key)[0]`` as numpy arrays."""
    check_ported(cfg)
    device = resolve_device(device)
    out = {k: ({kk: _tensor(vv, device) for kk, vv in v.items()}
               if isinstance(v, dict) else _tensor(v, device))
           for k, v in tree.items() if k != "blocks"}
    stacked = tree["blocks"]
    if len(stacked) != len(cfg.block_pattern):
        raise ValueError(f"{len(stacked)} stacked blocks for the pattern "
                         f"{cfg.block_pattern}")
    out["blocks"] = [[_take(stacked[i], r, device)
                      for i in range(len(cfg.block_pattern))]
                     for r in range(cfg.num_superblocks)]
    return out
