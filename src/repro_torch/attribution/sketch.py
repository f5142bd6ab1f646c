"""Heavy-hitter attribution: signed count-sketch + dyadic drill-down — port
of ``repro.attribution.sketch``.

The ACE tier flags anomalies; this tier says what drives them.  Per row r
a bucket hash h_r(i) and a ±1 sign s_r(i) give the signed count-sketch
(Charikar–Chen–Farach-Colton)

    sketch[r, h_r(i)] += s_r(i) · v_i,
    v̂_i = median_r( s_r(i) · sketch[r, h_r(i)] ).

Both hash families come from the SRP stack the ACE tables use: the bucket
column of node k is ``pack_buckets`` of the sign bits of projection ROW k
(hashing a one-hot input is a row read), the ±1 sign a 1-bit SRP bank of
its own.  One plane per level of a static binary tree over the padded
coordinate space: node k at depth d covers coordinates
[k·2^(NL−d), (k+1)·2^(NL−d)); depth NL nodes are coordinates.

The hash tables are an explicit operand (``AttrTables``), the way W is for
``hash_buckets``.  The port draws them with its own ``make_projections``
from the reference's seeds (``seed·7919 + 2ℓ + 1`` and ``+ 2``), which is
not the reference's ``jax.random`` draw; to run both packages on the same
tables, carry the reference's across with
``repro_torch.core.convert.attr_tables_from_numpy``.  The filters own
theirs (``filt.attr_tables``), made once per config and device.

Plane layout (the ``attr`` state leaf): (2, NL, R, C) float32 — channel 0
accumulates all finite traffic's per-coordinate energy Σ x_i², channel 1
only the flagged anomalies'; windowed states carry (E, 2, NL, R, C) rings
(live row at the cursor, zeroed at rotation like the counts), fleets
(T, ...) stacks.

Every function is plain PyTorch with fixed shapes and no host sync.  The
point estimates (``estimate_level``, ``estimate``) go through
``repro_torch.kernels.ops.attr_estimate``, the ``attr_estimate`` CUDA
kernel on CUDA tensors, and the whole ``find_hh`` drill-down through
``ops.attr_find_hh``, one launch of that source's second kernel where the
reference runs one ``lax.scan`` over an inline gather.  Sketching
is deterministic on every device: node sums per level, then a gather of
each plane cell's nodes from a host-built table and a sum in a fixed
order — no atomics, so a fleet of one tenant gives the flat path's bits
and the planes do not change from run to run.  Its summation order is not
the reference's scatter order: planes agree with the reference to float
tolerance.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.srp import SrpConfig, make_projections, pack_buckets
from repro_torch.fleet.state import segment_sum, tenant_onehot
from repro_torch.kernels import attr_estimate as _ae
from repro_torch.kernels import ops
from repro_torch.kernels.attr_estimate import median_lastaxis as \
    _median_lastaxis   # the one shared median


@dataclasses.dataclass(frozen=True)
class AttrConfig:
    """Static configuration of one attribution hierarchy
    (``repro.attribution.AttrConfig``).

    dim:  number of attributable coordinates (the filter's feature dim).
    rows: R — independent signed rows (median over R; odd R gives the
          middle order statistic, even R the midpoint of the two middles).
    bits: bucket-space log2 — each row is ``1 << bits`` wide.
    seed: seed the per-level SRP banks derive from.
    """

    dim: int
    rows: int = 5
    bits: int = 8
    seed: int = 0

    def __post_init__(self):
        if self.dim < 1:
            raise ValueError(f"dim must be >= 1, got {self.dim}")
        if self.rows < 1:
            raise ValueError(f"rows must be >= 1, got {self.rows}")
        if not 1 <= self.bits <= 20:
            raise ValueError(f"bits must be in [1, 20], got {self.bits}")

    @property
    def width(self) -> int:
        return 1 << self.bits

    @property
    def num_levels(self) -> int:
        """NL — dyadic tree depth: ceil(log2(dim)), at least 1."""
        return max(1, (self.dim - 1).bit_length())

    @property
    def padded_dim(self) -> int:
        """2^NL — the padded leaf space (coords >= dim are never valid)."""
        return 1 << self.num_levels

    def plane_shape(self) -> tuple:
        """The flat-state ``attr`` leaf: (2 channels, NL, R, C)."""
        return (2, self.num_levels, self.rows, self.width)

    def memory_bytes(self) -> int:
        return 2 * self.num_levels * self.rows * self.width * 4


class AttrTables(NamedTuple):
    """The hash tables of one hierarchy, on one device.

    cols:       (NL, 2^NL, R) int32 bucket column of node k at level ℓ
                (level ℓ hosts the depth-(ℓ+1) nodes).
    signs:      (NL, 2^NL, R) float32 ±1 sign of node k at level ℓ.
    cell_nodes: (NL, R, C, M) int64 — the nodes hashed to each plane
                cell, in node order, as indices into the per-level node
                sums laid end to end (level ℓ starts at 2^(ℓ+1) − 2); the
                padding points at a trailing zero.
    cell_signs: (NL, R, C, M) float32 — their signs, 0 on the padding.
    """

    cols: torch.Tensor
    signs: torch.Tensor
    cell_nodes: torch.Tensor
    cell_signs: torch.Tensor


# ---------------------------------------------------------------------------
# Hash tables — drawn on the host, once per config.
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _level_tables_np(cfg: AttrConfig):
    """The port's draw of the node tables: cols (NL, 2^NL, R) int32 in
    [0, C), signs (NL, 2^NL, R) float32 ±1, from explicitly seeded
    ``torch.Generator``s with the reference's per-level seeds."""
    nl, d2, r = cfg.num_levels, cfg.padded_dim, cfg.rows
    cols = np.empty((nl, d2, r), np.int32)
    sgns = np.empty((nl, d2, r), np.float32)
    for lvl in range(nl):
        ccfg = SrpConfig(dim=d2, num_bits=cfg.bits, num_tables=r,
                         seed=cfg.seed * 7919 + 2 * lvl + 1)
        w = make_projections(ccfg, generator=torch.Generator()
                             .manual_seed(ccfg.seed))
        bits = (w >= 0).to(torch.int32)[:, :ccfg.num_projections]
        cols[lvl] = pack_buckets(bits, ccfg).numpy()
        scfg = SrpConfig(dim=d2, num_bits=1, num_tables=r,
                         seed=cfg.seed * 7919 + 2 * lvl + 2)
        ws = make_projections(scfg, generator=torch.Generator()
                              .manual_seed(scfg.seed))
        sgns[lvl] = 2.0 * (ws >= 0).numpy().astype(np.float32)[:, :r] - 1.0
    return cols, sgns


def _coord_tables_np(cfg: AttrConfig, cols: np.ndarray, sgns: np.ndarray):
    """Coordinate-granular scatter tables (the reference's
    ``_coord_tables_np`` arithmetic): off (NL, dim, R) int32 flat element
    offsets into a (NL·R·C,) plane view, sg (NL, dim, R) float32 signs.
    Coordinate i lives in node ``i >> (NL−1−ℓ)`` at level ℓ."""
    nl, r, c, d = cfg.num_levels, cfg.rows, cfg.width, cfg.dim
    off = np.empty((nl, d, r), np.int32)
    sg = np.empty((nl, d, r), np.float32)
    coords = np.arange(d)
    for lvl in range(nl):
        node = coords >> (nl - 1 - lvl)
        off[lvl] = (lvl * r + np.arange(r)[None, :]) * c + cols[lvl][node]
        sg[lvl] = sgns[lvl][node]
    return off, sg


def _cell_tables_np(cfg: AttrConfig, cols: np.ndarray, sgns: np.ndarray):
    """(cell_nodes, cell_signs) of ``AttrTables``: for each level and row,
    the real nodes (first coordinate < dim) grouped by the cell the
    coordinate tables put them in, in node order."""
    nl, r, c, d = cfg.num_levels, cfg.rows, cfg.width, cfg.dim
    off, sg = _coord_tables_np(cfg, cols, sgns)
    groups = []
    for lvl in range(nl):
        shift = nl - 1 - lvl
        nodes = np.arange(((d - 1) >> shift) + 1)
        first = nodes << shift                 # each node's first coord
        for row in range(r):
            cell = off[lvl, first, row] - (lvl * r + row) * c
            order = np.argsort(cell, kind="stable")
            counts = np.bincount(cell, minlength=c)
            starts = np.cumsum(counts) - counts
            pos = np.arange(nodes.size) - starts[cell[order]]
            groups.append((lvl, row, cell[order], pos, order,
                           sg[lvl, first[order], row]))
    m = max(int(g[3].max()) + 1 for g in groups)
    sentinel = (2 << nl) - 2
    cell_nodes = np.full((nl, r, c, m), sentinel, np.int64)
    cell_signs = np.zeros((nl, r, c, m), np.float32)
    for lvl, row, cell, pos, node, s in groups:
        cell_nodes[lvl, row, cell, pos] = (2 << lvl) - 2 + node
        cell_signs[lvl, row, cell, pos] = s
    return cell_nodes, cell_signs


def make_tables(cfg: AttrConfig, device, cols=None,
                signs=None) -> AttrTables:
    """``AttrTables`` on ``device`` from the node tables ``cols``/``signs``
    ((NL, 2^NL, R) numpy arrays), by default the port's own draw."""
    if cols is None:
        cols, signs = _level_tables_np(cfg)
    shape = (cfg.num_levels, cfg.padded_dim, cfg.rows)
    cols = np.asarray(cols, np.int32)
    signs = np.asarray(signs, np.float32)
    if cols.shape != shape or signs.shape != shape:
        raise ValueError(f"attribution tables: want {shape}, got "
                         f"{cols.shape} and {signs.shape}")
    cell_nodes, cell_signs = _cell_tables_np(cfg, cols, signs)
    return AttrTables(*(torch.as_tensor(x, device=device) for x in
                        (cols, signs, cell_nodes, cell_signs)))


@lru_cache(maxsize=None)
def _tables_cached(cfg: AttrConfig, device: torch.device) -> AttrTables:
    return make_tables(cfg, device)


def level_tables(cfg: AttrConfig, device) -> AttrTables:
    """The port's tables for ``cfg`` on ``device``, made once per config
    and device."""
    return _tables_cached(cfg, torch.device(device))


def init_plane(cfg: AttrConfig, device) -> torch.Tensor:
    """Zero flat-state attribution plane: (2, NL, R, C) float32."""
    return torch.zeros(cfg.plane_shape(), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Sketching: dense vectors -> signed hierarchies; chunk observation.
# ---------------------------------------------------------------------------

def sketch_vectors(cfg: AttrConfig, tables: AttrTables,
                   v: torch.Tensor) -> torch.Tensor:
    """Sketch a batch of dense (M, dim) vectors into (M, NL, R, C) signed
    hierarchies.  Node sums per level (pairwise from the leaves up, over
    the zero-padded leaf space), then each cell sums its nodes' signed
    sums from the ``cell_nodes`` gather: fixed shapes, a fixed order."""
    m = v.shape[0]
    nl = cfg.num_levels
    leaves = torch.zeros((m, cfg.padded_dim), dtype=torch.float32,
                         device=v.device)
    leaves[:, :cfg.dim] = v.to(torch.float32)
    levels = [leaves]
    for _ in range(nl - 1):
        levels.append(levels[-1].reshape(m, -1, 2).sum(dim=-1))
    # level ℓ holds 2^(ℓ+1) nodes: the coarsest first, then a zero pad
    sums = torch.cat(levels[::-1] + [leaves.new_zeros((m, 1))], dim=1)
    idx = tables.cell_nodes
    g = sums.index_select(1, idx.reshape(-1)).reshape((m,) + idx.shape)
    return torch.sum(g * tables.cell_signs, dim=-1)


def sketch_vector(cfg: AttrConfig, tables: AttrTables,
                  v: torch.Tensor) -> torch.Tensor:
    """Sketch one dense (dim,) vector into its (NL, R, C) hierarchy."""
    return sketch_vectors(cfg, tables, v[None])[0]


def chunk_energy(feat: torch.Tensor, margins: torch.Tensor,
                 num_tenants: int, tenant_ids: torch.Tensor | None = None):
    """Per-tenant per-coordinate energy split of one chunk.

    ``feat`` (N, dim) sanitized features (quarantined rows zeroed),
    ``margins`` (N,) float32 under the runner's sentinel protocol: −inf =
    quarantined (in neither channel), +inf = warmup (background only),
    finite < 0 = flagged anomaly.  Returns (e_all (T, dim), e_anom
    (T, dim), n_all (T,), n_anom (T,)).

    Each tenant's row is a masked column sum over the chunk (one-hot
    weights, masked-out entries exact zeros), not a scatter: no atomics.
    The flat path calls with ``num_tenants=1``, ``tenant_ids=None`` — the
    same program with T = 1, which makes a fleet of one bitwise the flat
    path.
    """
    n = feat.shape[0]
    tids = (torch.zeros((n,), dtype=torch.int32, device=feat.device)
            if tenant_ids is None else tenant_ids.reshape(-1))
    allf = (~torch.isneginf(margins)).to(torch.float32)
    anomf = allf * (margins < 0.0).to(torch.float32)
    onehot = tenant_onehot(tids, num_tenants)                   # (T, N)
    sq = feat.to(torch.float32) ** 2

    def energy(wts):
        return torch.stack([torch.sum(sq * w[:, None], dim=0) for w in wts])
    e_all = energy(onehot * allf)
    e_anom = energy(onehot * anomf)
    return (e_all, e_anom, segment_sum(onehot, allf),
            segment_sum(onehot, anomf))


def chunk_planes(cfg: AttrConfig, tables: AttrTables, e_all: torch.Tensor,
                 e_anom: torch.Tensor) -> torch.Tensor:
    """(T, dim) background + anomaly energies -> (T, 2, NL, R, C)
    two-channel sketch contributions (one chunk's worth)."""
    t = e_all.shape[0]
    sk = sketch_vectors(cfg, tables, torch.cat([e_all, e_anom]))
    return sk.reshape((2, t) + sk.shape[1:]).transpose(0, 1)


def drift_vector(e_all: torch.Tensor, e_anom: torch.Tensor,
                 n_all: torch.Tensor, n_anom: torch.Tensor) -> torch.Tensor:
    """Chunk-global drift: mean anomaly energy − mean background energy
    per coordinate, (dim,).  Tenant rows are summed first, in the flat
    (T = 1) and fleet paths alike."""
    ea = torch.sum(e_all, dim=0)
    ex = torch.sum(e_anom, dim=0)
    na = torch.sum(n_all)
    nx = torch.sum(n_anom)
    return ex / torch.clamp_min(nx, 1.0) - ea / torch.clamp_min(na, 1.0)


def tenant_drift_l2(e_all: torch.Tensor, e_anom: torch.Tensor,
                    n_all: torch.Tensor, n_anom: torch.Tensor
                    ) -> torch.Tensor:
    """(T,) exact per-tenant drift magnitudes ‖Δ_t‖₂."""
    d = e_anom / torch.clamp_min(n_anom, 1.0)[:, None] \
        - e_all / torch.clamp_min(n_all, 1.0)[:, None]
    return torch.sqrt(torch.sum(d * d, dim=-1))


# -- state-plane observation (one call per chunk, fixed shapes) -------------

def observe_flat(attr: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """Flat state: attr (2, NL, R, C) + the chunk's T = 1 planes row."""
    return attr + planes[0]


def observe_fleet(attr: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """Fleet state: attr (T, 2, NL, R, C) + per-tenant chunk planes."""
    return attr + planes


def observe_window(attr: torch.Tensor, planes: torch.Tensor,
                   cursor: torch.Tensor) -> torch.Tensor:
    """Windowed state: the live row of attr (E, 2, NL, R, C) + the chunk
    plane (2, NL, R, C), at the device cursor (no host sync)."""
    return attr.index_add(0, cursor.reshape(1).long(), planes[None])


def observe_fleet_window(attr: torch.Tensor, planes: torch.Tensor,
                         cursor: torch.Tensor) -> torch.Tensor:
    """Fleet×window: attr (T, E, 2, NL, R, C), planes (T, 2, NL, R, C),
    cursor (T,) — each tenant's live row, rows t·E + cursor[t] of the
    (T·E, ...) stack (distinct rows: every cell takes one add)."""
    t, e = attr.shape[0], attr.shape[1]
    rows = torch.arange(t, device=attr.device) * e + cursor.long()
    flat = attr.reshape((t * e,) + attr.shape[2:])
    return flat.index_add(0, rows, planes).reshape(attr.shape)


# ---------------------------------------------------------------------------
# Estimation: point queries, L2, and the fixed-shape findHH drill-down.
# ---------------------------------------------------------------------------

def estimate_level(cfg: AttrConfig, tables: AttrTables, plane: torch.Tensor,
                   nodes: torch.Tensor, level: int,
                   use_kernels: bool = True) -> torch.Tensor:
    """Median-of-rows point estimates of node ids at one static level:
    plane (NL, R, C) single-channel hierarchy, nodes (B,) -> (B,) signed
    estimates.  Node ids are clamped into [0, 2^NL), as the reference's
    gather clamps.  ``use_kernels`` picks ``ops.attr_estimate`` (the
    kernel on CUDA tensors) or the plain version."""
    return _ae.level_estimate(
        plane, tables.cols, tables.signs, nodes, level,
        ops.attr_estimate if use_kernels else _ae.attr_estimate_plain)


def estimate(cfg: AttrConfig, tables: AttrTables, plane: torch.Tensor,
             coords: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
    """Batch point estimates of LEAF coordinates: plane (NL, R, C), coords
    (B,) in [0, dim) -> (B,) v̂, the post-mortem batch query."""
    return estimate_level(cfg, tables, plane, coords, cfg.num_levels - 1,
                          use_kernels)


def l2estimate(plane: torch.Tensor) -> torch.Tensor:
    """Median-of-rows ‖v‖₂ estimate per level: (NL, R, C) -> (NL,)."""
    return _median_lastaxis(torch.sqrt(torch.sum(plane * plane, dim=-1)))


def find_hh(cfg: AttrConfig, tables: AttrTables, plane: torch.Tensor,
            topk: int, use_kernels: bool = True):
    """Dyadic findHH drill-down with a fixed beam (no data-dependent
    shapes, no host sync).

    ``plane`` (NL, R, C) is a single-channel signed hierarchy (the sketch
    of a drift vector).  A beam of W = max(2·topk, 8) nodes descends: each
    depth expands every candidate into its two children, masks those
    outside the tree or past ``dim``, estimates |v̂| at the level and keeps
    the top W.  After the leaf level the beam is ranked once more.
    ``use_kernels`` takes ``ops.attr_find_hh`` (on CUDA tensors the whole
    drill-down is one kernel launch), else the plain loop.  Returns
    (coords (topk,) int32, ests (topk,) float32 signed estimates, valid
    (topk,) bool — False lanes are beam padding)."""
    fn = ops.attr_find_hh if use_kernels else _ae.attr_find_hh_plain
    return fn(plane.contiguous(), tables.cols, tables.signs, cfg.dim, topk)
