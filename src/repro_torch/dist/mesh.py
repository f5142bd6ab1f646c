"""Device meshes, logical-axis rules and sketch sharding layouts — port of
``repro.dist.mesh``.

A live mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dims (``"data"``, ``"model"``, ``"pipe"``, ``"pod"``): one process a rank,
each rank one card (or, with the ``gloo`` backend, several ranks on one
card or the CPU).  A mesh with more ranks than the process group has —
the 16×16 production mesh on a smaller job — is a shape-only
``MeshShape``, never a live mesh: the pure helpers below read only its
axis names and sizes.  ``axis_sizes`` reads either, and the reference's
test stubs (``axis_names`` + ``devices.shape``) as well.

A layout is the reference's pspec tuple, held in this module's own
``PartitionSpec``: entry i names the mesh axis (or tuple of axes, major
first) that dim i is split over, None for no split.  ``local_block``
resolves one against a live mesh into this rank's block of a global
tensor; ``repro_torch.dist.collectives`` gathers it back.

Sketch layouts (paper §3.3: the sketch is L independent count arrays, so
L is the natural shard axis once L × 2^K outgrows one card):

* ``replicated``     — every rank holds all (L, 2^K) counts.
* ``table_sharded``  — counts split over L across the ``model`` axis;
                       inserts need no collective on that axis and a
                       score one (B,) all-reduce.
* fleets add ``tenant_sharded`` and ``tenant_table_sharded``
  (``fleet_pspecs``).
"""
from __future__ import annotations

import dataclasses
import math

import torch


class PartitionSpec(tuple):
    """``PartitionSpec(*entries)``: one entry a dim, each a mesh axis
    name, a tuple of them or None (the reference's ``jax.sharding.P``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec({', '.join(map(repr, self))})"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh by its shape alone: axis names and sizes, no ranks.  It
    stands for rank 0's view (``get_local_rank`` is 0 on every axis), so a
    program run on ``meta`` tensors against it takes rank 0's blocks, and
    ``repro_torch.dist.collectives`` tallies its calls without
    communicating."""

    shape: tuple
    axis_names: tuple

    def get_local_rank(self, axis: str) -> int:
        return 0


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``, a ``MeshShape`` or any object
    with ``axis_names`` and ``devices.shape`` (a jax mesh, a test stub)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def axis_names(mesh) -> tuple:
    return tuple(axis_sizes(mesh))


def make_mesh(shape: tuple, names: tuple, device_type: str | None = None):
    """A live ``DeviceMesh`` of ``shape`` when the default process group has
    exactly that many ranks, else a shape-only ``MeshShape``.
    ``device_type`` defaults to ``"cuda"`` when there is a card."""
    import torch.distributed as dist
    shape, names = tuple(shape), tuple(names)
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() == math.prod(shape):
        from torch.distributed.device_mesh import init_device_mesh
        if device_type is None:
            device_type = "cuda" if torch.cuda.is_available() else "cpu"
        return init_device_mesh(device_type, shape, mesh_dim_names=names)
    return MeshShape(shape, names)


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, names)


def make_debug_mesh(data: int = 2, model: int = 2, pod: int | None = None,
                    device_type: str | None = None):
    """Small (data, model) or (pod, data, model) mesh: live over the
    process group when it has data·model(·pod) ranks."""
    if pod:
        return make_mesh((pod, data, model), ("pod", "data", "model"),
                         device_type)
    return make_mesh((data, model), ("data", "model"), device_type)


def make_host_local_mesh(table_axis: str = "model"):
    """A mesh over THIS process's devices only (``repro_torch.cluster``):
    a process drives one card, so the mesh is the trivial (1,) mesh and
    every layout collapses to replicated.  Tenant-sharded fleets need no
    collective across tenants, so a multi-host cluster keeps every
    hot-path program host-local and its only cross-host traffic is the
    epoch-boundary gossip."""
    return MeshShape((1,), (table_axis,))


def rules_for(mesh, *, long_context: bool = False) -> dict:
    """Logical-axis -> mesh-axis rules for this mesh.

    long_context (batch=1 decode): batch cannot shard, so the KV-cache
    SEQUENCE axis takes the data dims and activations stay replicated on
    batch.  The ACE logical axes ride along: ``tables`` (the L axis of the
    sketch) maps to the tensor-parallel axis, ``buckets`` never shards.
    """
    batch_axes = ("pod", "data") if "pod" in axis_sizes(mesh) \
        else ("data",)
    return {
        "batch": None if long_context else batch_axes,
        "cache_seq": batch_axes if long_context else None,
        "capacity": batch_axes,
        "heads": "model",
        "kv_heads": "model",
        "ff": "model",
        "vocab": "model",
        "tables": "model",
        "buckets": None,
    }


# ---------------------------------------------------------------------------
# Sketch pytree layouts (raw tuples in the states' field order).
# ---------------------------------------------------------------------------

def _layout_error(layout: str):
    return ValueError(f"unknown sketch layout {layout!r} "
                      "(want 'replicated' or 'table_sharded')")


def sketch_pspecs(layout: str = "replicated", table_axis: str = "model"):
    """``(counts, n, welford_mean, welford_m2)`` specs of a flat sketch."""
    if layout == "replicated":
        counts = P()
    elif layout == "table_sharded":
        counts = P(table_axis, None)
    else:
        raise _layout_error(layout)
    return (counts, P(), P(), P())


def window_pspecs(layout: str = "replicated", table_axis: str = "model"):
    """``(counts, n, welford_mean, welford_m2, tail, ssq, cursor, tick)``
    specs of an epoch ring: the (E, L, 2^K) ring and the (L, 2^K) tail
    split their L axis like the flat sketch, the epoch axis never."""
    if layout == "replicated":
        counts, tail = P(), P()
    elif layout == "table_sharded":
        counts, tail = P(None, table_axis, None), P(table_axis, None)
    else:
        raise _layout_error(layout)
    return (counts, P(), P(), P(), tail, P(), P(), P())


FLEET_LAYOUTS = ("replicated", "table_sharded", "tenant_sharded",
                 "tenant_table_sharded")


def fleet_pspecs(layout: str = "replicated", table_axis: str = "model",
                 tenant_axis: str = "data"):
    """``(counts, n, welford_mean, welford_m2)`` specs of a (T, L, 2^K)
    fleet.  Tenants never couple, so the tenant axis shards every leaf
    and needs no collective; it composes with the table split."""
    if layout == "replicated":
        counts, stats = P(), P()
    elif layout == "table_sharded":
        counts, stats = P(None, table_axis, None), P()
    elif layout == "tenant_sharded":
        counts, stats = P(tenant_axis, None, None), P(tenant_axis)
    elif layout == "tenant_table_sharded":
        counts, stats = P(tenant_axis, table_axis, None), P(tenant_axis)
    else:
        raise ValueError(
            f"unknown fleet layout {layout!r} (want 'replicated', "
            "'table_sharded', 'tenant_sharded' or 'tenant_table_sharded')")
    return (counts, stats, stats, stats)


# ---------------------------------------------------------------------------
# Per-leaf pspec policy.
# ---------------------------------------------------------------------------

def _entry_size(entry, sizes: dict) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        return math.prod(sizes[e] for e in entry)
    return sizes[entry]


def sanitize_pspec(ps, shape: tuple, mesh) -> PartitionSpec:
    """Drop mesh axes that do not divide the corresponding dim (qwen2's 2
    KV heads on a 16-way model axis replicate; an L = 50 sketch stays off
    a 16-way tables axis): uneven sharding would pad and waste the mesh."""
    sizes = axis_sizes(mesh)
    out = []
    for i, entry in enumerate(ps):
        if i >= len(shape):
            out.append(None)
            continue
        out.append(entry if entry is None
                   or shape[i] % _entry_size(entry, sizes) == 0 else None)
    return P(*out)


def apply_fsdp(ps, shape: tuple, mesh, axis: str = "data") -> PartitionSpec:
    """ZeRO/FSDP: additionally shard the largest free dim of a parameter
    over ``axis`` (when it divides), composed with the model-axis
    assignments; parameters stay replicated across ``pod``."""
    sizes = axis_sizes(mesh)
    if axis not in sizes:
        return ps
    n = sizes[axis]
    entries = list(ps) + [None] * (len(shape) - len(ps))
    for e in entries:
        if axis in (e if isinstance(e, (tuple, list)) else (e,)):
            return ps
    best, best_dim = 0, -1
    for i, (e, d) in enumerate(zip(entries, shape)):
        if e is None and d % n == 0 and d > best:
            best, best_dim = d, i
    if best_dim < 0:
        return ps
    entries[best_dim] = axis
    return P(*entries)


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def map_specs(fn, spec_tree, *rest):
    """``fn(spec, *leaves)`` over a tree of PartitionSpecs (dicts, lists,
    tuples) and trees of the same structure in ``rest``."""
    if is_spec(spec_tree):
        return fn(spec_tree, *rest)
    if spec_tree is None:
        return None
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, v, *(r[k] for r in rest))
                for k, v in spec_tree.items()}
    out = [map_specs(fn, v, *(r[i] for r in rest))
           for i, v in enumerate(spec_tree)]
    return type(spec_tree)(*out) if hasattr(spec_tree, "_fields") \
        else type(spec_tree)(out)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape)


def fsdp_tree(pspec_tree, shape_tree, mesh, axis: str = "data"):
    """``apply_fsdp`` over a tree of specs and the aligned tree of
    tensors (or anything with ``.shape``)."""
    return map_specs(lambda ps, s: apply_fsdp(ps, _shape(s), mesh, axis),
                     pspec_tree, shape_tree)


def sharding_tree_for(mesh, pspec_tree, shape_tree):
    """Specs with per-leaf divisibility sanitisation: each leaf's
    placement on ``mesh``."""
    return map_specs(lambda ps, s: sanitize_pspec(ps, _shape(s), mesh),
                     pspec_tree, shape_tree)


# ---------------------------------------------------------------------------
# A spec resolved against a live mesh.
# ---------------------------------------------------------------------------

def dim_axes(entry) -> tuple:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def local_shape(shape: tuple, ps, mesh) -> tuple:
    """This rank's block shape of a global ``shape`` under spec ``ps``."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for i, entry in enumerate(ps):
        out[i] //= _entry_size(entry, sizes) if entry is not None else 1
    return tuple(out)


def split_axes(ps, dim: int, mesh) -> tuple:
    """The axes of more than one rank that split dim ``dim`` under ``ps``
    (a dim past the spec's end is never split)."""
    sizes = axis_sizes(mesh)
    entry = ps[dim] if dim < len(ps) else None
    return tuple(a for a in dim_axes(entry) if sizes.get(a, 1) > 1)


def global_shape(shape: tuple, ps, mesh) -> tuple:
    """The global shape whose block under ``ps`` has ``shape``."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for i, entry in enumerate(ps):
        out[i] *= _entry_size(entry, sizes) if entry is not None else 1
    return tuple(out)


def local_block(x: torch.Tensor, ps, mesh) -> torch.Tensor:
    """This rank's block of a global tensor under spec ``ps`` (a
    contiguous copy; the tensor itself where nothing splits)."""
    sizes = axis_sizes(mesh)
    for i, entry in enumerate(ps):
        for a in dim_axes(entry):
            if sizes[a] == 1:
                continue
            if x.shape[i] % sizes[a]:
                raise ValueError(f"dim {i} of {tuple(x.shape)} does not "
                                 f"split over {a}={sizes[a]}")
            x = torch.chunk(x, sizes[a], dim=i)[mesh.get_local_rank(a)]
    return x.contiguous()
