"""Sketch health invariants and table repair — port of
``repro.resilience.health``.

Every ACE state carries enough redundancy to audit itself on the device:
inserts are unit scatter-adds, so each table's counts sum to exactly the
number of items inserted; Welford M2 is a sum of squares; ring cursors
and ticks live in known ranges; escalation tables keep their sorted,
live-slot invariants.  ``health_check`` evaluates all of them with
device ops only and returns a :class:`HealthReport` of bool tensors (a
per-table mask, never a host branch), so the serving stack decides when
to bring it to the host.

=====================  ====================================================
invariant              definition
=====================  ====================================================
count conservation     Σ_b counts[j, b] == n  per table j (per tenant, per
                       epoch), up to the repair offset / quantized ``lost``
                       slack (flat: n − lost ≤ Σ ≤ n; fleet: ==; windows:
                       Σ ≤ n, one-sided)
count range            every counter ≥ 0
moment sanity          n, welford_mean finite; welford_m2 finite and ≥ 0;
                       n ≥ 0
tail/ssq sanity        tail finite per table; ssq finite and ≥ 0
cursor/tick bounds     0 ≤ cursor < E; tick ≥ 0
esc consistency        offs sorted; live slots have vals > 0, free
                       (SENTINEL) slots vals == 0; lost finite and ≥ 0
=====================  ====================================================

The conservation sums are float32, as the reference's are: each row of
counters is cast and summed a block of rows at a time, so the windowed
fleet's ring is never copied whole.  While every counter is ≥ 0 and the
table sums stay below 2^24 every partial sum is an exact integer, in any
order of reduction; a flip that pushes a sum past 2^24 leaves it past
2^24 in any order, and a negative counter fails the range check whatever
its table sums to, so the verdicts are the reference's whenever n < 2^24.

Each check reads whole tables only, so it runs unchanged on a
table-sharded or tenant-sharded rank's block (``repro_torch.dist``):
the per-table sums stay local, and ``Guardrail`` makes the block's
report whole (``ShardedSketch.whole_audit``).

Repair (``repair_*``) zeroes the corrupted tables' planes while the
healthy L − k keep serving.  Flat and fleet sketches return a repair
offset per table — the n at repair time — since their counts never
expire; window rings need none: a zeroed table passes the one-sided
conservation at once and its deficit expires with its epochs.
``repair_moments`` restarts poisoned Welford streams (the exact μ never
reads them).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import quantize as qz
from repro_torch.core.sketch import AceState
from repro_torch.fleet.state import FleetState
from repro_torch.fleet.window import WindowedFleetState
from repro_torch.window.ring import WindowedAceState

# rows of counters cast to float32 at a time by the conservation sums
_SUM_ROWS = 64


class HealthReport(NamedTuple):
    """Health verdicts, bool tensors (numpy arrays once on the host).

    table_ok:   per-table conservation + range mask — (L,) for flat and
                windowed sketches, (T, L) for fleets: the serving mask
                (``serving_mask`` makes it the scoring ops' float
                ``table_mask``).
    moments_ok: () or (T,) — finite n/mean/M2, M2 ≥ 0, n ≥ 0.
    struct_ok:  () or (T,) — cursor/tick bounds, tail/ssq sanity,
                escalation-table slot consistency.
    ok:         all of the above, () or (T,).
    """

    table_ok: torch.Tensor
    moments_ok: torch.Tensor
    struct_ok: torch.Tensor
    ok: torch.Tensor


def _rows(x: torch.Tensor, fn) -> torch.Tensor:
    """``fn`` over the last axis of ``x``, ``_SUM_ROWS`` rows at a time:
    (..., B) -> (...)."""
    flat = x.reshape(-1, x.shape[-1])
    out = torch.cat([fn(flat[i:i + _SUM_ROWS])
                     for i in range(0, flat.shape[0], _SUM_ROWS)])
    return out.reshape(x.shape[:-1])


def _table_sums(counts: torch.Tensor) -> torch.Tensor:
    """Float32 sum of each row of counters, (..., B) -> (...)."""
    return _rows(counts, lambda r: torch.sum(r.to(torch.float32), dim=-1))


def _row_nonneg(counts: torch.Tensor) -> torch.Tensor:
    """Whether every counter of a row is ≥ 0 (False for a NaN), (...)."""
    return _rows(counts, lambda r: torch.amin(r, dim=-1)) >= 0


def _row_finite(x: torch.Tensor) -> torch.Tensor:
    return _rows(x, lambda r: torch.all(torch.isfinite(r), dim=-1))


def _finite(*xs) -> torch.Tensor:
    acc = torch.ones((), dtype=torch.bool, device=xs[0].device)
    for x in xs:
        acc = acc & torch.all(torch.isfinite(x))
    return acc


def _esc_ok(esc: Optional[qz.EscTable], device) -> torch.Tensor:
    """Escalation-table slot invariants (True when there is no table)."""
    if esc is None:
        return torch.ones((), dtype=torch.bool, device=device)
    offs, vals = esc.offs, esc.vals
    sorted_ok = torch.all(offs[1:] >= offs[:-1])
    live = offs != qz.SENTINEL
    slots_ok = torch.all(torch.where(live, vals > 0, vals == 0))
    lost_ok = torch.isfinite(esc.lost) & (esc.lost >= 0.0)
    return sorted_ok & slots_ok & lost_ok


def check_ace(state: AceState,
              repair_offsets: torch.Tensor | None = None) -> HealthReport:
    """Health of a flat ``AceState``: (L,) table mask + scalar verdicts.

    ``repair_offsets`` (L,) float32 — the n at each table's repair (0
    where never repaired); conservation then reads Σ counts[j] == n −
    offset[j].  Quantized planes audit the densified logical counts, with
    ``esc.lost`` as downward slack (dropped excess leaves the plane).
    """
    L = state.counts.shape[0]
    if state.esc is not None:
        dense = qz.densify(state.counts, state.esc)
        slack = state.esc.lost
    else:
        dense = state.counts
        slack = torch.zeros((), dtype=torch.float32,
                            device=state.counts.device)
    sums = _table_sums(dense)                                     # (L,)
    expected = state.n - (repair_offsets if repair_offsets is not None
                          else torch.zeros((L,), dtype=torch.float32,
                                           device=state.n.device))
    conserve = (sums <= expected) & (sums >= expected - slack)
    table_ok = conserve & _row_nonneg(dense)
    moments_ok = _finite(state.n, state.welford_mean, state.welford_m2) \
        & (state.welford_m2 >= 0.0) & (state.n >= 0.0)
    struct_ok = _esc_ok(state.esc, state.counts.device)
    ok = torch.all(table_ok) & moments_ok & struct_ok
    return HealthReport(table_ok=table_ok, moments_ok=moments_ok,
                        struct_ok=struct_ok, ok=ok)


def check_window(state: WindowedAceState) -> HealthReport:
    """Health of a ``WindowedAceState`` ring: (L,) table mask.

    Conservation holds per table per epoch (Σ ≤ the epoch's n); a table
    is healthy only if every epoch of it conserves.  No repair offsets:
    a zeroed table's deficit expires with its epochs."""
    E = state.counts.shape[0]
    sums = _table_sums(state.counts)                              # (E, L)
    conserve = torch.all(sums <= state.n[:, None], dim=0)        # (L,)
    nonneg = torch.all(_row_nonneg(state.counts), dim=0)         # (L,)
    table_ok = conserve & nonneg & _row_finite(state.tail)
    moments_ok = _finite(state.n, state.welford_mean, state.welford_m2) \
        & torch.all(state.welford_m2 >= 0.0) & torch.all(state.n >= 0.0)
    struct_ok = (state.cursor >= 0) & (state.cursor < E) \
        & (state.tick >= 0) & torch.isfinite(state.ssq) & (state.ssq >= 0.0)
    ok = torch.all(table_ok) & moments_ok & struct_ok
    return HealthReport(table_ok=table_ok, moments_ok=moments_ok,
                        struct_ok=struct_ok, ok=ok)


def check_fleet(state: FleetState,
                repair_offsets: torch.Tensor | None = None) -> HealthReport:
    """Health of a ``FleetState``: (T, L) table mask + (T,) verdicts."""
    T, L, _ = state.counts.shape
    sums = _table_sums(state.counts)                              # (T, L)
    expected = state.n[:, None] - (
        repair_offsets if repair_offsets is not None
        else torch.zeros((T, L), dtype=torch.float32, device=state.n.device))
    table_ok = (sums == expected) & _row_nonneg(state.counts)
    moments_ok = torch.isfinite(state.n) & torch.isfinite(state.welford_mean) \
        & torch.isfinite(state.welford_m2) & (state.welford_m2 >= 0.0) \
        & (state.n >= 0.0)                                       # (T,)
    struct_ok = torch.ones((T,), dtype=torch.bool, device=state.n.device)
    ok = torch.all(table_ok, dim=1) & moments_ok & struct_ok
    return HealthReport(table_ok=table_ok, moments_ok=moments_ok,
                        struct_ok=struct_ok, ok=ok)


def check_fleet_window(state: WindowedFleetState) -> HealthReport:
    """Health of a ``WindowedFleetState``: (T, L) table mask + (T,)."""
    E = state.counts.shape[1]
    sums = _table_sums(state.counts)                              # (T, E, L)
    conserve = torch.all(sums <= state.n[:, :, None], dim=1)     # (T, L)
    nonneg = torch.all(_row_nonneg(state.counts), dim=1)         # (T, L)
    table_ok = conserve & nonneg & _row_finite(state.tail)
    moments_ok = torch.all(torch.isfinite(state.n), dim=1) \
        & torch.all(torch.isfinite(state.welford_mean), dim=1) \
        & torch.all(torch.isfinite(state.welford_m2), dim=1) \
        & torch.all(state.welford_m2 >= 0.0, dim=1) \
        & torch.all(state.n >= 0.0, dim=1)                       # (T,)
    struct_ok = (state.cursor >= 0) & (state.cursor < E) \
        & (state.tick >= 0) & torch.isfinite(state.ssq) & (state.ssq >= 0.0)
    ok = torch.all(table_ok, dim=1) & moments_ok & struct_ok
    return HealthReport(table_ok=table_ok, moments_ok=moments_ok,
                        struct_ok=struct_ok, ok=ok)


def health_check(state, repair_offsets: torch.Tensor | None = None
                 ) -> HealthReport:
    """The invariant audit of any state type (dispatch on the class, the
    windowed fleet first, as the reference's order)."""
    if isinstance(state, WindowedFleetState):
        return check_fleet_window(state)
    if isinstance(state, FleetState):
        return check_fleet(state, repair_offsets)
    if isinstance(state, WindowedAceState):
        return check_window(state)
    if isinstance(state, AceState):
        return check_ace(state, repair_offsets)
    raise TypeError(f"health_check: unknown state type {type(state)!r}")


def serving_mask(report: HealthReport) -> torch.Tensor:
    """The report's table mask as the float32 ``table_mask`` every scoring
    op takes ((L,) or (T, L))."""
    return report.table_ok.to(torch.float32)


# ---------------------------------------------------------------------------
# Repair: re-zero corrupted tables; the healthy L − k keep serving.
# ---------------------------------------------------------------------------

def repair_ace(state: AceState, table_ok: torch.Tensor,
               repair_offsets: torch.Tensor | None = None):
    """Zero the corrupted tables of a flat sketch.

    Returns ``(new_state, new_offsets)``: the corrupted tables' planes are
    zeroed (their escalation slots freed, the table re-sorted), and their
    repair offset becomes the current n; healthy tables, n and the
    moments are bitwise untouched."""
    L = state.counts.shape[0]
    okf = table_ok.to(state.counts.dtype)
    new_counts = state.counts * okf[:, None]
    old = (repair_offsets if repair_offsets is not None
           else torch.zeros((L,), dtype=torch.float32, device=state.n.device))
    new_offsets = torch.where(table_ok, old, state.n)
    esc = state.esc
    if esc is not None:
        # free every slot whose offset lands in a zeroed table (offset //
        # 2^K is the table of a flat plane)
        nbuckets = state.counts.shape[1]
        slot_table = torch.clamp(esc.offs // nbuckets, 0, L - 1)
        keep = (esc.offs == qz.SENTINEL) | table_ok[slot_table.long()]
        offs = torch.where(keep, esc.offs, qz.SENTINEL)
        vals = torch.where(keep, esc.vals, 0)
        offs, order = torch.sort(offs, stable=True)
        esc = qz.EscTable(offs=offs, vals=vals[order], lost=esc.lost)
    return state._replace(counts=new_counts, esc=esc), new_offsets


def _live(counts: torch.Tensor, cursor: torch.Tensor) -> torch.Tensor:
    """The live epoch of an (E, ...) ring at a device cursor, clamped into
    [0, E) as the reference's dynamic index is (no host sync)."""
    idx = torch.clamp(cursor, 0, counts.shape[0] - 1).long().reshape(1)
    return torch.index_select(counts, 0, idx)[0]


def repair_window(state: WindowedAceState, table_ok: torch.Tensor,
                  whole=None) -> WindowedAceState:
    """Zero the corrupted tables of a window ring — every epoch and the
    tail row — and re-anchor ssq from the surviving planes.  ``whole``
    maps a table-sharded rank's (L_local, 2^K) tail + live plane to the
    whole (L, 2^K) one, whose ‖·‖² is the ring's ssq (``ring.rotate``'s
    argument)."""
    okc = table_ok.to(state.counts.dtype)
    new_counts = state.counts * okc[None, :, None]
    new_tail = state.tail * table_ok.to(torch.float32)[:, None]
    cw = new_tail + _live(new_counts, state.cursor).to(torch.float32)
    if whole is not None:
        cw = whole(cw)
    return state._replace(counts=new_counts, tail=new_tail,
                          ssq=torch.sum(cw * cw))


def repair_fleet(state: FleetState, table_ok: torch.Tensor,
                 repair_offsets: torch.Tensor | None = None):
    """Zero corrupted (tenant, table) planes of a fleet; returns
    ``(new_state, new_offsets)`` with (T, L) offsets."""
    T, L, _ = state.counts.shape
    okf = table_ok.to(state.counts.dtype)
    new_counts = state.counts * okf[:, :, None]
    old = (repair_offsets if repair_offsets is not None
           else torch.zeros((T, L), dtype=torch.float32,
                            device=state.n.device))
    new_offsets = torch.where(table_ok, old, state.n[:, None])
    return state._replace(counts=new_counts), new_offsets


def repair_fleet_window(state: WindowedFleetState,
                        table_ok: torch.Tensor) -> WindowedFleetState:
    """Zero corrupted (tenant, table) ring planes and tail rows and
    re-anchor each tenant's ssq (see :func:`repair_window`)."""
    T, E = state.counts.shape[:2]
    okc = table_ok.to(state.counts.dtype)
    new_counts = state.counts * okc[:, None, :, None]
    new_tail = state.tail * table_ok.to(torch.float32)[:, :, None]
    tidx = torch.arange(T, device=state.cursor.device)
    live = new_counts[tidx, torch.clamp(state.cursor, 0, E - 1).long()]
    cw = new_tail + live.to(torch.float32)
    return state._replace(counts=new_counts, tail=new_tail,
                          ssq=torch.sum(cw * cw, dim=(1, 2)))


def repair_moments(state):
    """Re-zero poisoned Welford streams (any state type); n is kept, so
    the cold-start gate does not re-arm and the exact μ is untouched."""
    return state._replace(welford_mean=torch.zeros_like(state.welford_mean),
                          welford_m2=torch.zeros_like(state.welford_m2))
