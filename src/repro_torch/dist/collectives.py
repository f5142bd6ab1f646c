"""Every collective of ``repro_torch.dist``, with a tally of the bytes each
moves — the port's counterpart of ``repro.dist.hlo_analysis
.collective_bytes_by_kind``, which reads the same numbers out of compiled
HLO text.

Each wrapper runs one ``torch.distributed`` call over one named axis of a
live ``DeviceMesh`` (an axis of size 1 is the identity and moves nothing)
and adds to ``TALLY`` the bytes of its result — the per-rank payload, the
quantity the reference's tally counts: an all-reduce its tensor, an
all-gather its gathered output, a reduce-scatter its local block, a
permute or a broadcast its tensor (``call_bytes``).

Over a shape-only ``MeshShape`` the wrappers take ``meta`` tensors: each
call is tallied as on a live mesh (rank 0's view) and returns an empty
tensor of its result's shape, and nothing is communicated.  The same
program run that way — a sharded train step on ``meta``
(``train.sharded.step_on_meta``), the dry run's cells
(``launch.dryrun``) — gives its collectives call for call, which take
the place of the reference's HLO analysis.

The ``gloo`` backend stages CUDA tensors through the host for some
collectives and refuses others.  Where it refuses (``GLOO_HOST_STAGED``,
found on the card), the wrapper copies the tensor to the host, runs the
collective there and copies the result back: explicitly, only for that
backend, and counted in the tally (``host_staged_bytes``: the bytes
copied each way).  No other path is ever taken quietly.  Under NCCL, one
rank a card, nothing is staged.
"""
from __future__ import annotations

import collections
import contextlib
import math

import torch
import torch.distributed as dist

from repro_torch.dist.mesh import MeshShape, axis_sizes

# The collectives ``gloo`` does not run on CUDA tensors: on an H100 with
# torch 2.11's gloo, all-reduce, all-gather, reduce-scatter, broadcast and
# all-to-all take CUDA tensors, while point-to-point sends read the device
# pointer as host memory ("writev: Bad address") and kill the job.  These
# go through a host copy.
GLOO_HOST_STAGED = frozenset({"collective-permute"})


class Tally:
    """Bytes and calls by kind (the reference's HLO opcode names) and by
    mesh axis (the whole job's broadcast under ``"*"``), plus the bytes
    copied through the host for ``gloo``."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.by_kind = collections.defaultdict(lambda: {"bytes": 0,
                                                        "count": 0})
        self.by_axis = collections.defaultdict(int)
        self.host_staged_bytes = 0

    def add(self, kind: str, nbytes: int, axis: str) -> None:
        slot = self.by_kind[kind]
        slot["bytes"] += int(nbytes)
        slot["count"] += 1
        self.by_axis[axis] += int(nbytes)

    def snapshot(self) -> dict:
        """``{kind: {"bytes", "count"}, ..., "total_bytes", "by_axis",
        "host_staged_bytes"}`` (the reference's dict, plus the axes and
        the staging)."""
        out = {k: dict(v) for k, v in self.by_kind.items()}
        out["total_bytes"] = sum(v["bytes"] for v in self.by_kind.values())
        out["by_axis"] = dict(self.by_axis)
        out["host_staged_bytes"] = self.host_staged_bytes
        return out


TALLY = Tally()


def call_bytes(kind: str, numel: int, itemsize: int, n: int) -> int:
    """The bytes one call of ``kind`` adds to a tally, given its input's
    element count and size and the ``n`` ranks of its axis: an all-gather
    its gathered output, a reduce-scatter its block of the input, every
    other kind its input."""
    if kind == "all-gather":
        return n * numel * itemsize
    if kind == "reduce-scatter":
        return numel // n * itemsize
    return numel * itemsize


@contextlib.contextmanager
def tallied():
    """Reset the tally, yield it, and leave its counts in place."""
    TALLY.reset()
    yield TALLY


def axis_size(mesh, axis: str) -> int:
    return axis_sizes(mesh).get(axis, 1)


def shape_only(mesh, x: torch.Tensor) -> bool:
    """True when ``mesh`` is a shape-only ``MeshShape``: the call is
    tallied and nothing communicated.  Its tensors must lie on ``meta``
    (a shape-only result holds no values)."""
    if not isinstance(mesh, MeshShape):
        return False
    if x.device.type != "meta":
        raise ValueError("a shape-only mesh runs on meta tensors, not on "
                         f"{x.device}")
    return True


def _group(mesh, axis: str):
    """The process group of ``axis`` through this rank, or None when the
    axis has one rank (or the mesh none)."""
    if mesh is None or axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _add(kind: str, x: torch.Tensor, mesh, axis: str) -> None:
    """Tally one call of ``kind`` on input ``x`` over ``axis``."""
    TALLY.add(kind, call_bytes(kind, x.numel(), x.element_size(),
                               axis_size(mesh, axis)), axis)


def _staged(kind: str, group, x: torch.Tensor) -> bool:
    return (x.is_cuda and kind in GLOO_HOST_STAGED
            and dist.get_backend(group) == "gloo")


def all_reduce(x: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """``x`` summed (``op``) over every rank of the named axes, in place;
    one call an axis of more than one rank.  Returns ``x``."""
    for axis in (axes,) if isinstance(axes, str) else tuple(axes):
        if mesh is None or axis_size(mesh, axis) == 1:
            continue
        if not shape_only(mesh, x):
            dist.all_reduce(x, op=op, group=_group(mesh, axis))
        _add("all-reduce", x, mesh, axis)
    return x


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0
               ) -> torch.Tensor:
    """The blocks of ``x`` of every rank of ``axis``, concatenated along
    ``dim`` in axis order."""
    if mesh is None or axis_size(mesh, axis) == 1:
        return x
    n = axis_size(mesh, axis)
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    if not shape_only(mesh, x):
        dist.all_gather_into_tensor(out, x, group=_group(mesh, axis))
    _add("all-gather", x, mesh, axis)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int = 0
                   ) -> torch.Tensor:
    """``x`` summed over the ranks of ``axis``; this rank keeps its block
    (chunk ``get_local_rank(axis)`` of ``dim``)."""
    if mesh is None or axis_size(mesh, axis) == 1:
        return x
    n = axis_size(mesh, axis)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    if not shape_only(mesh, src):
        dist.reduce_scatter_tensor(out, src, group=_group(mesh, axis))
    _add("reduce-scatter", src, mesh, axis)
    return out.movedim(0, dim)


def broadcast(x: torch.Tensor, mesh=None, axis: str | None = None,
              src: int = 0) -> torch.Tensor:
    """``x`` from rank ``src`` of ``axis`` (of the whole job when ``axis``
    is None) to every rank of it, in place."""
    if axis is None:
        if mesh is not None and shape_only(mesh, x):
            n = math.prod(axis_sizes(mesh).values())
        elif dist.is_initialized():
            n = dist.get_world_size()
        else:
            n = 1
        if n == 1:
            return x
        if not isinstance(mesh, MeshShape):
            dist.broadcast(x, src=src)
        TALLY.add("broadcast", call_bytes("broadcast", x.numel(),
                                          x.element_size(), n), "*")
        return x
    if mesh is None or axis_size(mesh, axis) == 1:
        return x
    if not shape_only(mesh, x):
        g = _group(mesh, axis)
        dist.broadcast(x, src=dist.get_global_rank(g, src), group=g)
    _add("broadcast", x, mesh, axis)
    return x


def permute(x: torch.Tensor, mesh, axis: str, shift: int = 1
            ) -> torch.Tensor:
    """The ring shift of ``axis``: rank i sends ``x`` to rank i + shift and
    returns what rank i − shift sent (modulo the axis size)."""
    if mesh is None or axis_size(mesh, axis) == 1:
        return x
    if shape_only(mesh, x):
        _add("collective-permute", x, mesh, axis)
        return torch.empty_like(x)
    g = _group(mesh, axis)
    n = axis_size(mesh, axis)
    i = mesh.get_local_rank(axis)
    src = x.contiguous()
    staged = _staged("collective-permute", g, src)
    if staged:
        src = src.cpu()
        TALLY.host_staged_bytes += 2 * _nbytes(src)
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src,
                      dist.get_global_rank(g, (i + shift) % n), g),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(g, (i - shift) % n), g)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    _add("collective-permute", src, mesh, axis)
    return out.to(x.device) if staged else out
