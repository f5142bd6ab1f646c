"""GPipe-style pipeline parallelism over a ``pipe`` mesh axis — port of
``repro.dist.pipeline``.

Each rank owns one stage's parameters (the leading stage dim of the
params split over ``pipe``) and activations hop stage → stage + 1 around
a ring (``collectives.permute``): the classic bubble schedule, S + M − 1
ticks for S stages and M microbatches, bubble fraction (S−1)/(S+M−1).
The last stage's outputs are then broadcast to every rank.

Framework plumbing rather than paper math: ACE itself never needs
pipelining (the sketch is MBs), but the models it guards do.
"""
from __future__ import annotations

import torch

from repro_torch.dist import collectives as col
from repro_torch.models.registry import tree_map


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """Idle fraction of the GPipe schedule: (S−1)/(S+M−1)."""
    return (num_stages - 1) / (num_stages + num_microbatches - 1)


def pipeline_apply(layer_fn, params, x: torch.Tensor, *, mesh,
                   num_stages: int, num_microbatches: int,
                   axis: str = "pipe") -> torch.Tensor:
    """Run ``x`` through ``num_stages`` stages of ``layer_fn`` as a
    pipeline.

    layer_fn: (stage_params, h) -> h, applied by each rank to its stage.
    params:   tree whose leaves have a leading stage dim (S, ...); each
              rank reads its own stage's slice.
    x:        (M, mb, ...) microbatched input, the same on every rank.

    Returns (M, mb, ...): the output of stage S−1 for every microbatch, on
    every rank.  The sequential composition of the stages, in the same
    float operations.
    """
    S, M = num_stages, num_microbatches
    if x.shape[0] != M:
        raise ValueError(f"x has {x.shape[0]} microbatches, expected {M}")
    idx = mesh.get_local_rank(axis)
    p = tree_map(lambda a: a[idx], params)
    outputs = torch.zeros_like(x)
    recv = torch.zeros_like(x[0])
    for t in range(M + S - 1):
        mb = t - idx                        # this stage's microbatch
        if 0 <= mb < M:
            y = layer_fn(p, x[mb] if idx == 0 else recv)
            if idx == S - 1:
                outputs[mb] = y
        else:
            y = torch.zeros_like(recv)      # a bubble: nothing to pass on
        recv = col.permute(y, mesh, axis)
    return col.broadcast(outputs, mesh, axis, src=S - 1)
