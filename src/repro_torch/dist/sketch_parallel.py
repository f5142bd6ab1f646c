"""Distributed ACE sketches: replicated, table-sharded and tenant-sharded
layouts — port of ``repro.dist.sketch_parallel``.

The multi-device story of paper §3.3–§3.4 (the sketch is a commutative
monoid under count addition) and the §4 privacy claim at datacenter
scale: only counts of hashes ever cross the network, never raw data.

The reference has two execution modes: explicit ``shard_map``
collectives, and jit/SPMD, where GSPMD places the state and inserts the
collectives.  PyTorch has no GSPMD, so the port has the first mode only:
every function here is what ONE rank runs on ITS block of the state, and
every collective is an explicit call of ``repro_torch.dist.collectives``
over a named axis of a live ``DeviceMesh``.  The reference's jit/SPMD
entry points (``Guardrail(mesh=…)``, ``StreamRunner(mesh=…)``,
``make_train_step(sketch_layout=…)``) run on ``ShardedSketch`` below.
A ``make_*`` builder returns such a function bound to its mesh: it takes
this rank's blocks (``place`` cuts them from a global state) and its
slice of the batch where ``data_axes`` split it.

Each rank's work runs through the port's kernels: ``srp_hash`` (or
``srht_hash``) for the bucket ids, ``ace_update`` on the local block (its
row mask for the masked insert), ``ace_query_sum`` for the local
UNSCALED partial sum.  Like the kernel path of ``repro_torch.kernels
.ops``, the inserts update the counts IN PLACE.

Layouts (``repro_torch.dist.mesh``):

* **replicated**: every rank holds all (L, 2^K) counts.  Each data shard
  histograms its slice of the batch; one all-reduce over the data axes
  gives the global histogram.  Scoring needs no collective.
* **table_sharded**: counts split over the L axis across ``table_axis``,
  so sketches past one card's memory (K = 18+, L = 200+) are servable.
  The L arrays are independent (paper §3.1), so an insert needs no
  collective on that axis, a score ONE (B,) float all-reduce of the
  partial sums, then × float32(1/L): 4·B bytes a batch, whatever K and
  L.  Every rank hashes ALL L tables and keeps its slice: hashing only
  its columns of W would change the hash kernel's plan, and with it the
  float order of the projections.  μ sums Σ‖A_j‖² exactly per rank
  (``sketch.sq_sum``, int64) and all-reduces it.  The partial sums are
  integers below 2^24, so insert, score, μ and (with no data axis) the
  Welford stream are BITWISE the single card's.
* **tenant_sharded** / **tenant_table_sharded** (fleets): each rank owns
  a block of tenants, which never couple: the rank runs the fleet ops on
  its block with the tenant ids made local, with no collective on the
  tenant axis; the second composes the table split.

Degraded (table-masked) scoring and the health audit run on every
layout (``ShardedSketch``): every rank keeps the whole health mask ((L,),
or its tenants' (T_local, L)), the kernel sums the rank's healthy
tables, the partial sums are all-reduced and scaled by 1/num_healthy of
the whole mask, and the masked μ reduces the all-gathered per-table
Σc² as one card does; the audit's verdicts are ANDed over the replicas
and all-gathered whole.

Quantized sketches (``esc_capacity > 0``) are refused outside the
replicated layout, as in the reference.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import sketch as sk
from repro_torch.core.sketch import AceConfig, AceState
from repro_torch.dist import collectives as col
from repro_torch.dist.mesh import (P, axis_sizes, dim_axes, fleet_pspecs,
                                   local_block, map_specs, sketch_pspecs,
                                   window_pspecs)
from repro_torch.fleet import state as fl
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ace_query import ace_query_sum, num_healthy
from repro_torch.kernels.ace_update import ace_update
from repro_torch.quantile import moments
from repro_torch.window import ring

F32 = torch.float32


def _no_quantized(state, what: str) -> None:
    """Overflow-promoted (quantized) sketches are wired for the replicated
    layout only: the sharded blocks do not carry the escalation table."""
    if getattr(state, "esc", None) is not None:
        raise NotImplementedError(
            f"{what} does not support quantized sketches "
            "(esc_capacity > 0); use the replicated layout or an "
            "unquantized narrow-dtype sketch")


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes or ())


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=F32, device=like.device)


# ---------------------------------------------------------------------------
# Replicated layout.
# ---------------------------------------------------------------------------

def local_histogram(x: torch.Tensor, w: torch.Tensor,
                    cfg: AceConfig) -> torch.Tensor:
    """Histogram of the local batch shard: (B_local, d) -> (L, 2^K)."""
    hist = torch.zeros((cfg.num_tables, cfg.num_buckets),
                       dtype=cfg.torch_dtype, device=x.device)
    return ace_update(hist, kops.hash_dispatch(x, w, cfg.srp))


def update_global(state: AceState, x: torch.Tensor, w: torch.Tensor,
                  cfg: AceConfig, axis_names=(), mesh=None) -> AceState:
    """Insert a batch split over the ``axis_names`` ranks of ``mesh`` into
    a replicated sketch: this rank's histogram, all-reduced over those
    axes, added to every rank's counts; the Welford stream folds the
    post-insert scores of the local items with all-reduced batch sums
    (the reference's shard_map formula)."""
    axes = _axes(axis_names)
    if axes:
        _no_quantized(state, "update_global over data axes")
    elif state.esc is not None:
        return sk.insert_buckets(state, kops.hash_dispatch(x, w, cfg.srp),
                                 cfg)
    buckets = kops.hash_dispatch(x, w, cfg.srp)
    hist = torch.zeros_like(state.counts)
    ace_update(hist, buckets)
    counts = state.counts.add_(col.all_reduce(hist, mesh, axes))
    scores = ace_query_sum(counts, buckets)

    b = col.all_reduce(_scalar(scores.shape[0], scores), mesh, axes)
    n = state.n
    tot = n + b
    rates = scores / torch.clamp_min(tot, 1.0)
    sum_s = col.all_reduce(torch.sum(rates), mesh, axes)
    sum_s2 = col.all_reduce(torch.sum(rates * rates), mesh, axes)
    mean_b = sum_s / torch.clamp_min(b, 1.0)
    m2_b = torch.clamp_min(sum_s2 - b * mean_b * mean_b, 0.0)
    new_mean, new_m2 = sk.welford_fold(state.welford_mean, state.welford_m2,
                                       n, b, tot, mean_b, m2_b,
                                       cfg.welford_min_n)
    return state._replace(counts=counts, n=tot, welford_mean=new_mean,
                          welford_m2=new_m2)


def _reducer(mesh, axes):
    return (lambda v: col.all_reduce(v, mesh, axes)) if axes else None


def update_global_masked(state: AceState, x: torch.Tensor, w: torch.Tensor,
                         mask: torch.Tensor, cfg: AceConfig, axis_names=(),
                         mesh=None) -> AceState:
    """Masked insert into a replicated sketch (the guardrail's fixed-shape
    insert): the 0/1-weighted histogram all-reduced over ``axis_names``,
    the Welford fold through ``sketch.masked_batch_welford`` with its
    partial sums all-reduced — bitwise the single card with no axes."""
    axes = _axes(axis_names)
    if axes:
        _no_quantized(state, "update_global_masked over data axes")
    buckets = kops.hash_dispatch(x, w, cfg.srp)
    if state.esc is not None:
        return sk.insert_buckets_masked(state, buckets, mask, cfg)
    if axes:
        hist = torch.zeros_like(state.counts)
        ace_update(hist, buckets, row_mask=mask)
        counts = state.counts.add_(col.all_reduce(hist, mesh, axes))
    else:
        counts = ace_update(state.counts, buckets, row_mask=mask)
    scores = ace_query_sum(counts, buckets)
    tot, new_mean, new_m2 = sk.masked_batch_welford(
        state, scores, mask.to(F32), cfg.welford_min_n,
        reduce=_reducer(mesh, axes))
    return state._replace(counts=counts, n=tot, welford_mean=new_mean,
                          welford_m2=new_m2)


def score_global(state: AceState, q: torch.Tensor, w: torch.Tensor,
                 cfg: AceConfig) -> torch.Tensor:
    """Score a query batch against the replicated sketch: no collective."""
    return kops.ace_query(state, kops.hash_dispatch(q, w, cfg.srp))


def make_shardmap_update(mesh, cfg: AceConfig, data_axes=("data",)):
    """(state, x_local, w) -> state: the batch split over ``data_axes``,
    the sketch replicated."""
    def upd(state, x, w):
        return update_global(state, x, w, cfg, axis_names=data_axes,
                             mesh=mesh)
    return upd


def make_masked_update(mesh, cfg: AceConfig, data_axes=()):
    """(state, x, w, mask) -> state: the replicated MASKED insert; with
    ``data_axes`` empty every rank applies the same add."""
    def upd(state, x, w, mask):
        return update_global_masked(state, x, w, mask, cfg,
                                    axis_names=data_axes, mesh=mesh)
    return upd


def sketch_shardings(mesh) -> AceState:
    """The replicated sketch's specs (``AceState``-shaped)."""
    del mesh
    return AceState(P(), P(), P(), P())


# ---------------------------------------------------------------------------
# Table-sharded layout: counts split over L across ``table_axis``.
# ---------------------------------------------------------------------------

def table_shard_info(cfg: AceConfig, mesh, table_axis: str) -> int:
    sizes = axis_sizes(mesh)
    if table_axis not in sizes:
        raise ValueError(f"mesh has no axis {table_axis!r} "
                         f"(axes: {tuple(sizes)})")
    shards = sizes[table_axis]
    if cfg.num_tables % shards != 0:
        raise ValueError(
            f"L={cfg.num_tables} tables do not divide over "
            f"{table_axis}={shards} shards; pick L a multiple of the axis "
            "(sanitize_pspec would silently fall back to replicated)")
    return shards


def _table_range(cfg: AceConfig, mesh, table_axis: str,
                 num_shards: int | None = None) -> tuple[int, int]:
    """(first table, tables) of this rank's block."""
    shards = num_shards or table_shard_info(cfg, mesh, table_axis)
    l_local = cfg.num_tables // shards
    index = mesh.get_local_rank(table_axis) if shards > 1 else 0
    return index * l_local, l_local


def _local_buckets(x: torch.Tensor, w: torch.Tensor, cfg: AceConfig,
                   mesh, table_axis: str, num_shards: int | None = None):
    """Bucket ids of this rank's tables: all L hashed, (B, L_local) kept."""
    start, l_local = _table_range(cfg, mesh, table_axis, num_shards)
    buckets = kops.hash_dispatch(x, w, cfg.srp)
    return buckets[:, start:start + l_local].contiguous()


def _table_scores(counts: torch.Tensor, buckets: torch.Tensor,
                  cfg: AceConfig, mesh, table_axis: str,
                  row_base: torch.Tensor | None = None) -> torch.Tensor:
    """Local unscaled partial sums, ONE (B,) all-reduce over the table
    axis, then the literal float32(1/L)."""
    partial = ace_query_sum(counts, buckets, row_base, scale="sum")
    return col.all_reduce(partial, mesh, table_axis) \
        * sk.reciprocal(cfg.num_tables).to(partial.device)


def update_table_sharded(state: AceState, x: torch.Tensor, w: torch.Tensor,
                         cfg: AceConfig, *, mesh, table_axis: str,
                         num_shards: int | None = None,
                         data_axes=()) -> AceState:
    """Insert into this rank's (L_local, 2^K) block.  No collective on the
    table axis for the counts; one (B,) all-reduce for the Welford score
    stream and, when the batch is split over ``data_axes``, the local
    histogram's all-reduce over them."""
    _no_quantized(state, "update_table_sharded")
    axes = _axes(data_axes)
    lb = _local_buckets(x, w, cfg, mesh, table_axis, num_shards)
    if axes:
        hist = torch.zeros_like(state.counts)
        ace_update(hist, lb)
        counts = state.counts.add_(col.all_reduce(hist, mesh, axes))
    else:
        counts = ace_update(state.counts, lb)
    scores = _table_scores(counts, lb, cfg, mesh, table_axis)

    b = col.all_reduce(_scalar(scores.shape[0], scores), mesh, axes)
    n = state.n
    tot = n + b
    rates = scores / torch.clamp_min(tot, 1.0)
    if axes:
        sum_s = col.all_reduce(torch.sum(rates), mesh, axes)
        mean_b = sum_s / torch.clamp_min(b, 1.0)
        m2_b = col.all_reduce(torch.sum((rates - mean_b) ** 2), mesh, axes)
    else:
        # sketch.insert_buckets' batch statistics, in its order
        mean_b = torch.mean(rates)
        m2_b = torch.sum((rates - mean_b) ** 2)
    new_mean, new_m2 = sk.welford_fold(state.welford_mean, state.welford_m2,
                                       n, b, tot, mean_b, m2_b,
                                       cfg.welford_min_n)
    return state._replace(counts=counts, n=tot, welford_mean=new_mean,
                          welford_m2=new_m2)


def update_table_sharded_masked(state: AceState, x: torch.Tensor,
                                w: torch.Tensor, mask: torch.Tensor,
                                cfg: AceConfig, *, mesh, table_axis: str,
                                num_shards: int | None = None,
                                data_axes=()) -> AceState:
    """The guardrail's masked insert, table-sharded: the admitted rows'
    ids go into this rank's tables (``ace_update``'s row mask), then the
    (B,) score all-reduce and ``sketch.masked_batch_welford`` (its sums
    all-reduced over ``data_axes``).  With no data axis this is bitwise
    ``sketch.insert_buckets_masked``."""
    _no_quantized(state, "update_table_sharded_masked")
    axes = _axes(data_axes)
    lb = _local_buckets(x, w, cfg, mesh, table_axis, num_shards)
    if axes:
        hist = torch.zeros_like(state.counts)
        ace_update(hist, lb, row_mask=mask)
        counts = state.counts.add_(col.all_reduce(hist, mesh, axes))
    else:
        counts = ace_update(state.counts, lb, row_mask=mask)
    scores = _table_scores(counts, lb, cfg, mesh, table_axis)
    tot, new_mean, new_m2 = sk.masked_batch_welford(
        state, scores, mask.to(F32), cfg.welford_min_n,
        reduce=_reducer(mesh, axes))
    return state._replace(counts=counts, n=tot, welford_mean=new_mean,
                          welford_m2=new_m2)


def score_table_sharded(state: AceState, q: torch.Tensor, w: torch.Tensor,
                        cfg: AceConfig, *, mesh, table_axis: str,
                        num_shards: int | None = None) -> torch.Tensor:
    """Ŝ(q, D): local partial sum, one (B,) all-reduce (4·B bytes, whatever
    K and L), × float32(1/L)."""
    _no_quantized(state, "score_table_sharded")
    lb = _local_buckets(q, w, cfg, mesh, table_axis, num_shards)
    return _table_scores(state.counts, lb, cfg, mesh, table_axis)


def mean_mu_table_sharded(state: AceState, cfg: AceConfig, *, mesh,
                          table_axis: str) -> torch.Tensor:
    """Exact μ (Eq. 11 closed form): each rank's exact Σ‖A_j‖²
    (``sketch.sq_sum``, int64) all-reduced over the table axis, rounded to
    float32 once."""
    _no_quantized(state, "mean_mu_table_sharded")
    ssq = col.all_reduce(sk.sq_sum(state.counts), mesh, table_axis).to(F32)
    return ssq / (torch.clamp_min(state.n, 1.0) * cfg.num_tables)


def make_table_sharded_update(mesh, cfg: AceConfig, *,
                              table_axis: str = "model", data_axes=()):
    """(state block, x, w) -> state: the table-sharded insert."""
    shards = table_shard_info(cfg, mesh, table_axis)

    def upd(state, x, w):
        return update_table_sharded(state, x, w, cfg, mesh=mesh,
                                    table_axis=table_axis,
                                    num_shards=shards, data_axes=data_axes)
    return upd


def make_table_sharded_masked_update(mesh, cfg: AceConfig, *,
                                     table_axis: str = "model",
                                     data_axes=()):
    """(state block, x, w, mask) -> state: the table-sharded MASKED
    insert."""
    shards = table_shard_info(cfg, mesh, table_axis)

    def upd(state, x, w, mask):
        return update_table_sharded_masked(
            state, x, w, mask, cfg, mesh=mesh, table_axis=table_axis,
            num_shards=shards, data_axes=data_axes)
    return upd


def make_table_sharded_score(mesh, cfg: AceConfig, *,
                             table_axis: str = "model"):
    """(state block, q, w) -> (B,) scores, the same on every rank."""
    shards = table_shard_info(cfg, mesh, table_axis)

    def scr(state, q, w):
        return score_table_sharded(state, q, w, cfg, mesh=mesh,
                                   table_axis=table_axis, num_shards=shards)
    return scr


def make_table_sharded_mean_mu(mesh, cfg: AceConfig, *,
                               table_axis: str = "model"):
    """(state block,) -> exact μ."""
    table_shard_info(cfg, mesh, table_axis)

    def mu(state):
        return mean_mu_table_sharded(state, cfg, mesh=mesh,
                                     table_axis=table_axis)
    return mu


def table_sharded_mean_mu(mesh, cfg: AceConfig, state: AceState,
                          table_axis: str = "model") -> torch.Tensor:
    """One-shot exact μ of this rank's block of a table-sharded state."""
    return make_table_sharded_mean_mu(mesh, cfg, table_axis=table_axis)(state)


def score_window_table_sharded(counts: torch.Tensor, weights: torch.Tensor,
                               buckets: torch.Tensor, cfg: AceConfig, *,
                               mesh, table_axis: str) -> torch.Tensor:
    """Windowed Ŝ(q) from this rank's (E, L_local, 2^K) ring block:
    per-epoch local partial sums, ONE (E, B) all-reduce, then the
    γ-weighted combine in ring-index order and × float32(1/L).  The
    all-reduce comes BEFORE the weights: the partial sums are integers
    below 2^24, so the reduction is exact and the weighting the same float
    sequence as ``window.ring.score_window``'s — bitwise for every γ
    (weighting first would need w·(a+b) ≡ w·a + w·b)."""
    E, l_local, nbuckets = counts.shape
    bases = (torch.arange(E, device=buckets.device, dtype=torch.int32)
             * l_local)
    partial = torch.stack([
        ace_query_sum(counts.view(E * l_local, nbuckets), buckets,
                      bases[e].expand(buckets.shape[0]).contiguous(),
                      scale="sum") for e in range(E)])
    total = col.all_reduce(partial, mesh, table_axis)
    acc = torch.zeros(buckets.shape[:1], dtype=F32, device=buckets.device)
    for e in range(E):
        acc = acc + weights[e] * total[e]
    return acc * sk.reciprocal(cfg.num_tables).to(acc.device)


def make_table_sharded_window_score(mesh, cfg: AceConfig, *,
                                    table_axis: str = "model"):
    """(ring block (E, L_local, 2^K), weights (E,), q, w) -> (B,) scores:
    4·E·B bytes a batch, one (E, B) all-reduce."""
    shards = table_shard_info(cfg, mesh, table_axis)

    def scr(counts, weights, q, w):
        lb = _local_buckets(q, w, cfg, mesh, table_axis, shards)
        return score_window_table_sharded(counts, weights, lb, cfg,
                                          mesh=mesh, table_axis=table_axis)
    return scr


# ---------------------------------------------------------------------------
# Layouts resolved to specs (validated), and a state's blocks.
# ---------------------------------------------------------------------------

def table_sharded_shardings(mesh, table_axis: str = "model") -> AceState:
    """The table-sharded sketch's specs (``AceState``-shaped)."""
    del mesh
    return AceState(*sketch_pspecs("table_sharded", table_axis))


def _sketch_error(layout: str):
    return ValueError(f"unknown sketch layout {layout!r} "
                      "(want 'replicated' or 'table_sharded')")


def shardings_for_layout(cfg: AceConfig, mesh, layout: str,
                         table_axis: str = "model", quantile: bool = False,
                         attr: bool = False) -> AceState:
    """The validated specs of a flat sketch under a named layout: the one
    place the layout names resolve, with the divisibility check.  The
    (NUM_BINS,) rate histogram and the attribution planes are small and
    read whole, so they replicate under every layout."""
    if layout == "table_sharded":
        if cfg.esc_capacity > 0:
            raise NotImplementedError(
                "quantized sketches (esc_capacity > 0) only support the "
                "replicated layout; the table-sharded blocks do not carry "
                "the escalation table")
        table_shard_info(cfg, mesh, table_axis)
        tree = table_sharded_shardings(mesh, table_axis)
    elif layout == "replicated":
        tree = sketch_shardings(mesh)
        if cfg.esc_capacity > 0:
            from repro_torch.core.quantize import EscTable
            tree = tree._replace(esc=EscTable(P(), P(), P()))
    else:
        raise _sketch_error(layout)
    if quantile:
        tree = tree._replace(qhist=P())
    if attr:
        tree = tree._replace(attr=P())
    return tree


def window_shardings_for_layout(cfg: AceConfig, mesh, num_epochs: int,
                                layout: str, table_axis: str = "model",
                                quantile: bool = False, attr: bool = False):
    """The validated specs of an epoch ring: its (E, L, 2^K) counts and
    (L, 2^K) tail split L like the flat sketch, the epoch axis never; the
    per-epoch histograms and planes replicate."""
    del num_epochs
    if layout == "table_sharded":
        table_shard_info(cfg, mesh, table_axis)
    elif layout != "replicated":
        raise _sketch_error(layout)
    tree = ring.WindowedAceState(*window_pspecs(layout, table_axis))
    if quantile:
        tree = tree._replace(qhist=P())
    if attr:
        tree = tree._replace(attr=P())
    return tree


TENANT_LAYOUTS = ("tenant_sharded", "tenant_table_sharded")


def fleet_shardings_for_layout(cfg: AceConfig, mesh, num_tenants: int,
                               layout: str, table_axis: str = "model",
                               tenant_axis: str = "data",
                               quantile: bool = False, attr: bool = False):
    """The validated specs of a (T, L, 2^K) fleet under the four fleet
    layouts: T must divide over ``tenant_axis`` and L over ``table_axis``
    where they split (no silent fallback to replicated).  Under the
    tenant layouts every leaf splits its tenant axis, the per-tenant
    histograms and planes included."""
    specs = fleet_pspecs(layout, table_axis, tenant_axis)
    sizes = axis_sizes(mesh)
    if layout in TENANT_LAYOUTS:
        if tenant_axis not in sizes:
            raise ValueError(f"mesh has no axis {tenant_axis!r} "
                             f"(axes: {tuple(sizes)})")
        shards = sizes[tenant_axis]
        if num_tenants % shards != 0:
            raise ValueError(
                f"T={num_tenants} tenants do not divide over "
                f"{tenant_axis}={shards} shards; pick T a multiple of the "
                "axis (sanitize_pspec would silently fall back to "
                "replicated)")
    if layout in ("table_sharded", "tenant_table_sharded"):
        table_shard_info(cfg, mesh, table_axis)
    tree = fl.FleetState(*specs)
    per_tenant = P(tenant_axis) if layout in TENANT_LAYOUTS else P()
    if quantile:
        tree = tree._replace(qhist=per_tenant)
    if attr:
        tree = tree._replace(attr=per_tenant)
    return tree


def place(state, specs, mesh):
    """This rank's blocks of a global state under a spec tree of the same
    structure (``*_shardings_for_layout``); a leaf the tree leaves None
    stays None."""
    def one(ps, leaf):
        if isinstance(leaf, torch.Tensor):
            return local_block(leaf, ps, mesh)
        return map_specs(lambda p2, x: local_block(x, p2, mesh), ps, leaf)
    return type(state)(*(None if (leaf is None or ps is None)
                         else one(ps, leaf)
                         for leaf, ps in zip(state, specs)))


def gather_block(x: torch.Tensor, ps, mesh) -> torch.Tensor:
    """The global tensor of this rank's block under spec ``ps``: an
    all-gather along each split dim, minor axis first."""
    for i, entry in enumerate(ps):
        for a in reversed(dim_axes(entry)):
            x = col.all_gather(x, mesh, a, dim=i)
    return x


def gather(state, specs, mesh):
    """The global state of this rank's blocks (every rank gets it)."""
    return type(state)(*(leaf if (leaf is None or ps is None
                                  or not isinstance(leaf, torch.Tensor))
                         else gather_block(leaf, ps, mesh)
                         for leaf, ps in zip(state, specs)))


# ---------------------------------------------------------------------------
# The entry points' hooks under a mesh.
# ---------------------------------------------------------------------------

class ShardedSketch:
    """A sketch layout resolved on a live mesh for this rank: the hooks
    that ``Guardrail(mesh=…)`` and the filters under
    ``StreamRunner(mesh=…)`` hand to ``repro_torch.kernels.ops``'s admissions and thresholds as
    ``shard``: the hash's slice, the table axis's sums and gathers (a
    health mask's block and its whole healthy count), μ (masked or not)
    and the rotation's and repair's ssq over the whole sketch, and the
    audit made whole (``whole_audit``).

    ``kind`` is ``"flat"``, ``"window"`` or ``"fleet"``.  Every rank of a
    table group scores and inserts the same batch; ranks along a fleet's
    tenant axis serve different batches, each of its own tenants (global
    ids, made local by ``local_tenants``).  W is replicated: callers
    broadcast rank 0's.
    """

    def __init__(self, cfg: AceConfig, mesh, layout: str, *,
                 kind: str = "flat", table_axis: str = "model",
                 tenant_axis: str = "data", num_tenants: int = 1,
                 num_epochs: int = 1, quantile: bool = False,
                 attr: bool = False):
        self.cfg, self.mesh, self.layout, self.kind = cfg, mesh, layout, kind
        self.table_axis, self.tenant_axis = table_axis, tenant_axis
        if kind == "fleet":
            self.specs = fleet_shardings_for_layout(
                cfg, mesh, num_tenants, layout, table_axis, tenant_axis,
                quantile=quantile, attr=attr)
        elif kind == "window":
            self.specs = window_shardings_for_layout(
                cfg, mesh, num_epochs, layout, table_axis,
                quantile=quantile, attr=attr)
        elif kind == "flat":
            self.specs = shardings_for_layout(cfg, mesh, layout, table_axis,
                                              quantile=quantile, attr=attr)
        else:
            raise ValueError(f"unknown sketch kind {kind!r}")
        sizes = axis_sizes(mesh)
        table_split = layout in ("table_sharded", "tenant_table_sharded")
        self.table_shards = sizes[table_axis] if table_split else 1
        self.table_start, self.l_local = _table_range(
            cfg, mesh, table_axis, self.table_shards)
        self.tenant_shards = sizes[tenant_axis] \
            if layout in TENANT_LAYOUTS else 1
        self.t_local = num_tenants // self.tenant_shards
        self.tenant_start = (mesh.get_local_rank(tenant_axis) * self.t_local
                             if self.tenant_shards > 1 else 0)

    # -- placement ----------------------------------------------------------
    def place(self, state):
        """This rank's blocks of a global state."""
        return place(state, self.specs, self.mesh)

    def gather(self, state):
        """The global state (along the table axis; under the tenant layouts
        the tenant axis too)."""
        return gather(state, self.specs, self.mesh)

    def local_tenants(self, tenant_ids: torch.Tensor) -> torch.Tensor:
        """Global tenant ids of this rank's block -> local ids (int32)."""
        return (tenant_ids - self.tenant_start).to(torch.int32).contiguous()

    def owns(self, tenant_ids) -> bool:
        lo, hi = self.tenant_start, self.tenant_start + self.t_local
        return bool(((tenant_ids >= lo) & (tenant_ids < hi)).all())

    def tenant_block(self, x):
        """This rank's tenants' rows of a (T, …) tensor or array (all of
        them off the tenant layouts)."""
        if self.tenant_shards == 1:
            return x
        return x[self.tenant_start:self.tenant_start + self.t_local]

    def table_block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's tables of a (…, L) tensor (a health mask)."""
        if self.table_shards == 1:
            return x
        return x[..., self.table_start:self.table_start + self.l_local] \
            .contiguous()

    # -- the pieces -----------------------------------------------------------
    def buckets(self, q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """ALL L tables hashed, this rank's (B, L_local) kept."""
        b = kops.hash_dispatch(q, w, self.cfg.srp)
        if self.table_shards == 1:
            return b
        return b[:, self.table_start:self.table_start + self.l_local] \
            .contiguous()

    def table_sum(self, x: torch.Tensor) -> torch.Tensor:
        return col.all_reduce(x, self.mesh, self.table_axis) \
            if self.table_shards > 1 else x

    def gather_tables(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The (…, L, …) whole of this rank's (…, L_local, …) block."""
        if self.table_shards == 1:
            return x
        return col.all_gather(x, self.mesh, self.table_axis,
                              dim=dim).contiguous()

    def whole_planes(self, x: torch.Tensor) -> torch.Tensor:
        """The whole (L, 2^K) of this rank's (L_local, 2^K) float planes
        (a ring's tail, or tail + live epoch): one all-gather of 4·L·2^K
        bytes, so their ‖·‖² is the single card's sum."""
        return self.gather_tables(x, dim=-2)

    def scores(self, counts: torch.Tensor, buckets: torch.Tensor,
               row_base: torch.Tensor | None = None, *,
               table_mask: torch.Tensor | None = None,
               tenant_ids: torch.Tensor | None = None) -> torch.Tensor:
        """(B,) means over the tables: this rank's unscaled partial sums,
        ONE (B,) all-reduce over the table axis, × float32(1/L).  With a
        health mask ((L,), or this rank's tenants' (T_local, L) routed by
        the local ``tenant_ids``) the kernel sums this rank's healthy
        tables and the all-reduced sum is scaled by 1/num_healthy of the
        WHOLE mask, computed here: the kernel's own ``"mean"`` would divide
        by this rank's count."""
        if table_mask is None:
            return self.table_sum(ace_query_sum(counts, buckets, row_base,
                                                scale="sum")) \
                * sk.reciprocal(self.cfg.num_tables).to(counts.device)
        part = ace_query_sum(counts, buckets, row_base,
                             table_mask=self.table_block(table_mask),
                             tenant_ids=tenant_ids, scale="sum")
        return self.table_sum(part) * (1.0 / num_healthy(table_mask,
                                                         tenant_ids))

    def masked_sums(self, counts: torch.Tensor, buckets: torch.Tensor,
                    row_base: torch.Tensor | None, table_mask: torch.Tensor,
                    tenant_ids: torch.Tensor | None = None):
        """(masked, unmasked) unscaled sums of the gathered counters: one
        ``ace_query_sum`` launch with ``with_unmasked`` on this rank's
        block of the mask, both partial sums all-reduced in ONE (2, B)
        call."""
        both = torch.stack(ace_query_sum(
            counts, buckets, row_base, table_mask=self.table_block(table_mask),
            tenant_ids=tenant_ids, scale="sum", with_unmasked=True))
        both = self.table_sum(both)
        return both[0], both[1]

    def sq_sum(self, counts: torch.Tensor, dim=None) -> torch.Tensor:
        return self.table_sum(sk.sq_sum(counts, dim)).to(F32)

    # -- the statistics the thresholds read -----------------------------------
    def mean_mu(self, state, table_mask: torch.Tensor | None = None,
                gamma: float = 1.0) -> torch.Tensor:
        """μ of the whole sketch: () for a flat sketch or a ring (μ_w at
        ``gamma``), (T_local,) for this rank's tenants of a fleet.  With
        no mask Σc² is summed exactly over the table axis (a ring's ssq is
        already the whole ring's).  With a health mask ((L,), or the
        rank's tenants' (T_local, L)) each table's float32 Σc² (of the
        γ-combined ring) is taken on its rank and the (…, L) vector
        all-gathered over the table axis inside the single card's own
        function, so μ is the single card's.  A quantized (replicated)
        plane takes ``sketch.mean_mu``."""
        L = self.cfg.num_tables
        whole = lambda x: self.gather_tables(x, dim=-1)     # noqa: E731
        if self.kind == "window":
            return ring.mean_mu_windowed(state, gamma, table_mask, L, whole)
        if self.kind == "fleet":
            if table_mask is not None:
                return fl.mean_mu_fleet(state, table_mask, whole)
            return self.sq_sum(state.counts, (1, 2)) / (
                torch.clamp_min(state.n, 1.0) * L)
        if table_mask is not None or state.esc is not None:
            return sk.mean_mu(state, table_mask, whole)
        return self.sq_sum(state.counts) / (torch.clamp_min(state.n, 1.0)
                                            * L)

    def falpha(self, counts: torch.Tensor, n: torch.Tensor,
               table_mask: torch.Tensor | None = None) -> torch.Tensor:
        """``falpha_index`` of the whole sketch: the per-table indices
        gathered over the table axis, then their mean (over the healthy
        tables of ``table_mask``, (L,) or the rank's tenants' (T_local,
        L))."""
        per_table = self.gather_tables(moments.falpha_per_table(counts, n),
                                       dim=-1)
        return moments.table_mean(per_table, table_mask)

    def maybe_rotate(self, wstate, rotate_every: int, gamma: float = 1.0):
        """``ring.maybe_rotate`` on this rank's ring block: the rotated
        candidate's ssq = ‖tail‖² over the tail all-gathered whole (one
        all-gather of 4·L·2^K bytes a call), the single card's sum."""
        return ring.maybe_rotate(wstate, rotate_every, gamma,
                                 whole=self.whole_planes)

    # -- the audit ------------------------------------------------------------
    def replica_axes(self) -> tuple:
        """The mesh axes along which ranks hold the same block: every axis
        the layout does not split (all of them when replicated)."""
        split = set()
        if self.table_shards > 1:
            split.add(self.table_axis)
        if self.tenant_shards > 1:
            split.add(self.tenant_axis)
        return tuple(a for a in axis_sizes(self.mesh) if a not in split)

    def whole_audit(self, block: torch.Tensor, table_cols: int):
        """A rank's packed audit block made whole.  ``block`` is float32
        (rows, table_cols·L_local + s): one row a tenant of the rank's
        (one for a flat sketch or a ring), first ``table_cols`` per-table
        fields of its L_local tables (the verdicts, then the repair
        offsets), then s per-row scalars (the moment and structure
        verdicts, n).  Replicas AND their verdicts in one all-reduce (MIN:
        the offsets and n they hold alike); the block is then
        all-gathered over the table axis, its per-table fields put in
        table order, and over the tenant axis under the tenant layouts.
        Returns (the ANDed block, the whole (T or 1, table_cols·L + s)
        matrix), both on the device."""
        block = col.all_reduce(block, self.mesh, self.replica_axes(),
                               op=dist.ReduceOp.MIN)
        whole = block
        if self.table_shards > 1:
            rows, lt = block.shape[0], self.l_local
            g = col.all_gather(block[None], self.mesh, self.table_axis,
                               dim=0)                  # (shards, rows, C)
            per_table = g[:, :, :table_cols * lt].reshape(
                self.table_shards, rows, table_cols, lt).permute(1, 2, 0, 3)
            whole = torch.cat([per_table.reshape(rows, -1),
                               g[0, :, table_cols * lt:]], dim=1)
        if self.tenant_shards > 1:
            whole = col.all_gather(whole, self.mesh, self.tenant_axis, dim=0)
        return block, whole
