"""Gradient compression — port of ``repro.train.compression``.

int8 stochastic-rounding quantisation with a per-leaf scale and error
feedback (the residual carried from step to step): a cross-pod gradient
all-reduce would move a quarter of the bytes, and the quantisation error
goes back into the next step's gradient, which keeps the scheme
convergent (Karimireddy et al., 2019).

The reference's leaves are its stacked ones, so a leaf's scale is the
largest magnitude over all its superblocks; here each entry of
``models.convert.reference_leaves`` takes one scale over its parts, and
every part's scale in the returned tree is that shared tensor.

The noise of the stochastic rounding is ``jax.random.uniform(key) − 0.5``
in the reference, which torch cannot reproduce.  Here it is an explicit
operand of ``quantise_int8``, and ``compress_grads_with_ef`` draws it with
``uniform_noise`` from a ``torch.Generator`` (the train state's), part by
part in ``reference_leaves`` order; a test can hand the reference's draw
in its place.  ``torch.round`` rounds half to even, as ``jnp.round``
does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.dist import collectives as col
from repro_torch.dist.mesh import global_shape, local_block
from repro_torch.models.convert import reference_leaves
from repro_torch.models.registry import leaves, tree_map, unflatten
from repro_torch.train.optim import leaf_axes
from repro_torch.train.schedule import scalar_div

F32 = torch.float32


class EfState(NamedTuple):
    residual: dict   # tree matching grads, float32


def init_error_feedback(grads_shape_tree) -> EfState:
    return EfState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=F32, device=g.device),
        grads_shape_tree))


def uniform_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """U[−0.5, 0.5) float32 noise on the generator's device."""
    return torch.rand(shape, generator=generator, dtype=F32,
                      device=generator.device) - 0.5


def int8_scale(parts, mesh=None, axes=()) -> torch.Tensor:
    """max(max |x| over every part, 1e-12) / 127: one leaf's scale; the
    largest magnitude all-reduced (max) over ``axes`` of ``mesh``, the
    axes that split the leaf, when its parts are blocks."""
    amax = torch.max(torch.stack([torch.max(torch.abs(x)) for x in parts]))
    if axes:
        amax = col.all_reduce(amax, mesh, axes, op=dist.ReduceOp.MAX)
    return scalar_div(torch.clamp_min(amax, 1e-12), 127.0)


def quantise_int8(x: torch.Tensor, noise: torch.Tensor,
                  scale: torch.Tensor | None = None):
    """Stochastic-rounding int8 with a per-tensor scale (``scale``: a
    leaf's shared one, else the tensor's own).  Returns (q, scale)."""
    x32 = x.to(F32)
    if scale is None:
        scale = int8_scale([x32])
    q = torch.clamp(torch.round(x32 / scale + noise), -127, 127)
    return q.to(torch.int8), scale


def dequantise_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def compress_grads_with_ef(grads, ef: EfState, generator: torch.Generator,
                           mesh=None, specs=None):
    """Returns (quantised tree, scales tree, new EfState).

    The residual (what int8 could not represent) feeds back next step.
    With a ``mesh`` the trees are this rank's blocks under ``specs`` (the
    module docstring)."""
    qs, scales, new_res = {}, {}, {}
    refs = reference_leaves(specs) if mesh is not None else None
    for i, (gl, rl) in enumerate(zip(reference_leaves(grads),
                                     reference_leaves(ef.residual))):
        corrected = [g.to(F32) + r for g, r in zip(gl.parts, rl.parts)]
        ps = refs[i].parts[0] if refs is not None else None
        axes = () if ps is None else leaf_axes(refs[i], mesh)
        scale = int8_scale(corrected, mesh, axes)
        for g, c in zip(gl.parts, corrected):
            if c.is_meta:                   # shapes only: no draw
                noise = torch.empty_like(c)
            elif axes:
                noise = local_block(uniform_noise(
                    global_shape(c.shape, ps, mesh), generator), ps, mesh)
            else:
                noise = uniform_noise(c.shape, generator)
            q, _ = quantise_int8(c, noise, scale)
            qs[id(g)], scales[id(g)] = q, scale
            new_res[id(g)] = c - dequantise_int8(q, scale)
    order = [id(g) for g in leaves(grads)]
    return (unflatten(grads, [qs[i] for i in order]),
            unflatten(grads, [scales[i] for i in order]),
            EfState(residual=unflatten(grads, [new_res[i] for i in order])))


def decompress_grads(qs, scales):
    return tree_map(dequantise_int8, qs, scales)


def compression_ratio(grads) -> float:
    """Bytes(int8 + one float32 scale a leaf) / bytes(float32), over the
    reference's leaves."""
    total = sum(g.numel() for g in leaves(grads))
    n_leaves = len(reference_leaves(grads))
    return (total * 1 + n_leaves * 4) / (total * 4)
