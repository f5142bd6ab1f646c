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

``reference_leaves`` walks a port tree (parameters, gradients, optimiser
moments: any tree of the parameters' structure) in the reference's
``jax.tree.leaves`` order: dict keys sorted, and each stacked leaf one
entry whose parts are its R superblocks' (whisper: its layers') tensors.
Whatever the reference computes per leaf (the gradient monitor's
per-leaf norms, Adafactor's factored moments and update clip, the int8
compression's per-leaf scale) the port computes per entry of this walk.
``params_to_reference`` stacks a port tree back into the reference's
layout, as numpy.
"""
from __future__ import annotations

from typing import NamedTuple

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


# top-level subtrees the reference stacks over its layers (the decoder-only
# LM's "blocks" is a list of pattern positions, each stacked over the
# superblocks; the port holds it per superblock, ``blocks[r][i]``)
STACKED = ("enc", "dec")


class RefLeaf(NamedTuple):
    """One leaf of the reference's tree: its path (``blocks/0/mixer/wq``),
    the port's tensors that make it up (R of them when ``stacked``, the
    reference's leading axis; else one)."""
    name: str
    parts: list
    stacked: bool


def reference_leaves(tree: dict) -> list[RefLeaf]:
    """The leaves of a port tree in the reference's ``jax.tree.leaves``
    order (see the module docstring)."""
    out: list[RefLeaf] = []

    def walk(nodes, path, stacked):
        first = nodes[0]
        if first is None:
            return
        if isinstance(first, dict):
            for k in sorted(first):
                walk([n[k] for n in nodes], path + [str(k)], stacked)
        elif type(first) in (list, tuple):    # a PartitionSpec is a leaf
            for i in range(len(first)):
                walk([n[i] for n in nodes], path + [str(i)], stacked)
        else:
            out.append(RefLeaf("/".join(path), list(nodes), stacked))

    for k in sorted(tree):
        v = tree[k]
        if k == "blocks":
            for i in range(len(v[0])):
                walk([row[i] for row in v], [k, str(i)], True)
        elif k in STACKED:
            walk(list(v), [k], True)
        else:
            walk([v], [k], False)
    return out


def params_to_reference(tree: dict) -> dict:
    """A port tree (parameters or gradients) in the reference's layout as
    numpy arrays: ``blocks`` a list over pattern positions, every stacked
    leaf one array with the superblocks (whisper: the layers) leading;
    empty dicts (a non-parametric norm) kept."""
    def host(t):
        return t.detach().cpu().numpy()

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return np.stack([host(n) for n in nodes])

    def whole(v):
        return ({k: whole(x) for k, x in v.items()} if isinstance(v, dict)
                else host(v))

    out: dict = {}
    for k, v in tree.items():
        if k == "blocks":
            out[k] = [stack([row[i] for row in v]) for i in range(len(v[0]))]
        elif k in STACKED:
            out[k] = stack(list(v))
        else:
            out[k] = whole(v)
    return out
