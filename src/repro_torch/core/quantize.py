"""Quantized count planes: narrow (int8/int16) counters plus an exact
overflow escalation table (port of ``repro.core.quantize``).

* the **narrow plane** stores ``min(count, CAP)`` per bucket in int8 or
  int16, CAP = 127 / 32767 (the dtype max, so promotion fires at exactly
  the saturation boundary);
* the **escalation table** (:class:`EscTable`) holds the excess
  ``count − CAP`` of the few promoted buckets as a fixed-capacity sorted
  array of flat element offsets;
* the **logical value** of a bucket is ``narrow + excess`` wherever a
  count is read (scores, μ, merges), so estimates stay exact past the
  dtype max while the promoted set fits ``esc_capacity``; excess that
  finds no slot is counted in ``lost``.

Below saturation the narrow plane IS the count array: every insert,
delete, merge, score and μ is bitwise the int32 sketch's.  Every function
here is plain PyTorch and functional, as the reference runs this path in
jnp outside any kernel: a narrow plane WITH promotion never reaches a
kernel (``repro_torch.kernels.ops`` dispatches on ``state.esc``), while a
narrow plane without it goes through the kernels, whose adds wrap past
the dtype max as the reference's narrow ``.add`` does.

:func:`quantized_scatter` is the one nontrivial op.  The reference forms
a (B, B, L) equality mask to find each offset's within-batch collisions;
here the same per-offset sums and first active items come from one sort
of the batch's offsets and two scatters over the runs of equal ones,
O(B·L log(B·L)) and no (B, B, L) tensor.  No function here waits on the
device (no data-dependent shape), so a filter step on a quantized plane
keeps the stream's no-sync contract.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# Free escalation slots carry this offset: int32 max sorts after every
# real flat offset (planes are checked flat-addressable), so the live
# entries stay first and lookups stay a binary search.
SENTINEL = 2**31 - 1

_NARROW = (torch.int8, torch.int16)
_NAMES = {"int8": torch.int8, "int16": torch.int16}


def _dtype(dtype) -> torch.dtype:
    return _NAMES.get(dtype, dtype) if isinstance(dtype, str) else dtype


def is_narrow(dtype) -> bool:
    """True for the count dtypes that can saturate (int8/int16; a name or
    a ``torch.dtype``)."""
    return _dtype(dtype) in _NARROW


def cap_for(dtype) -> int:
    """The saturation cap of a narrow plane: the dtype max itself."""
    return int(torch.iinfo(_dtype(dtype)).max)


class EscTable(NamedTuple):
    """Fixed-capacity overflow side table.

    offs: (C,) int32 — sorted flat element offsets of promoted buckets;
          free slots hold :data:`SENTINEL` (sorted last).
    vals: (C,) int32 — excess above the narrow cap (> 0 live, 0 free).
    lost: () float32 — excess dropped because the table was full.
    """

    offs: torch.Tensor
    vals: torch.Tensor
    lost: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.offs.shape[0]


def init_esc(capacity: int, device=None) -> EscTable:
    if capacity < 1:
        raise ValueError(f"esc capacity must be >= 1, got {capacity}")
    return EscTable(
        offs=torch.full((capacity,), SENTINEL, dtype=torch.int32,
                        device=device),
        vals=torch.zeros((capacity,), dtype=torch.int32, device=device),
        lost=torch.zeros((), dtype=torch.float32, device=device))


def _slots(esc: EscTable, offs: torch.Tensor):
    """(slot, hit): the left ``searchsorted`` slot of each offset,
    clamped into [0, C), and whether that slot holds the offset."""
    C = esc.offs.shape[0]
    idx = torch.searchsorted(esc.offs, offs.to(torch.int32).contiguous())
    idx = idx.clamp(0, C - 1)
    return idx, esc.offs[idx] == offs


def esc_lookup(esc: EscTable, offs: torch.Tensor) -> torch.Tensor:
    """Excess at each flat offset (0 where not promoted): int32, the
    shape of ``offs``."""
    idx, hit = _slots(esc, offs)
    return torch.where(hit, esc.vals[idx], 0)


def gather_logical(plane: torch.Tensor, esc: EscTable,
                   offs: torch.Tensor) -> torch.Tensor:
    """Exact logical counts at flat element offsets, narrow + excess:
    int32, the shape of ``offs``."""
    nar = plane.reshape(-1)[offs.long()].to(torch.int32)
    return nar + esc_lookup(esc, offs)


def flat_offsets(buckets: torch.Tensor, nbuckets: int) -> torch.Tensor:
    """(B, L) bucket ids -> (B, L) int32 flat offsets j·2^K + bucket."""
    rows = torch.arange(buckets.shape[-1], dtype=torch.int32,
                        device=buckets.device)[None, :]
    return (buckets.to(torch.int32) + rows * nbuckets).to(torch.int32)


def batch_scores_logical(plane: torch.Tensor, esc: EscTable,
                         buckets: torch.Tensor,
                         table_mask: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """``sketch.batch_scores`` over the exact logical counts: the row sum
    times float32(1/L), or the mean over the healthy tables of
    ``table_mask``; below saturation bitwise ``batch_scores``."""
    from repro_torch.core import sketch as sk
    L, nbuckets = plane.shape
    g = gather_logical(plane, esc, flat_offsets(buckets, nbuckets)) \
        .to(torch.float32)
    if table_mask is None:
        return torch.sum(g, dim=-1) * sk.reciprocal(L)
    return sk.masked_table_mean(g, table_mask)


def quantized_scatter(plane: torch.Tensor, esc: EscTable,
                      offs: torch.Tensor, w: torch.Tensor):
    """Exact saturating weighted scatter into a narrow plane.

    plane (R, 2^K) narrow; offs (B, L) int32 flat element offsets, column
    l's in its own row l (``flat_offsets``); w (B,) integer weights (0
    masked out, +1 insert, −1 delete).  Returns ``(new_plane, new_esc,
    post)``, ``post`` (B, L) int32 being each item's exact logical value
    at its offsets after the scatter (masked-out items included), as
    ``repro.core.quantize.quantized_scatter`` returns them, bitwise.

    1. Each offset's batch delta ``madd`` = Σ of the weights of the items
       that hold it: the offsets sorted, each run of equal ones a segment,
       one ``index_add`` of the weights over the segment ids.
    2. ``post = pre_narrow + pre_excess + madd``, the same for every
       item of an offset, so the narrow write sets
       ``clamp(post, dtype_min, CAP)`` (duplicates write equal values).
    3. The first active item of each touched offset (its leader: the
       smallest item index, by ``scatter_reduce("amin")``) keeps the
       escalation table: excess ``max(post − CAP, 0)`` overwrites the
       offset's live slot (0 frees it), new promotions claim free slots
       in (item, table) order, and excess that finds none goes to
       ``lost``; the table is sorted again.

    Every shape is fixed by (B, L, C): no step waits on the device (the
    scatters that drop an entry send it to a spare slot C, cut off after).
    """
    dtype = plane.dtype
    cap = cap_for(dtype)
    lo = int(torch.iinfo(dtype).min)
    B, L = offs.shape
    n = B * L
    C = esc.offs.shape[0]
    dev = plane.device
    flat = plane.reshape(-1)
    offs_f = offs.reshape(-1).to(torch.int32)
    w_i = w.to(torch.int32)
    active = w_i != 0
    w_f = w_i[:, None].expand(B, L).reshape(-1)
    act_f = active[:, None].expand(B, L).reshape(-1)
    b_f = torch.arange(B, dtype=torch.int32, device=dev)[:, None] \
        .expand(B, L).reshape(-1)

    # segments of equal offsets: sort, mark each run's start, number them
    order = torch.argsort(offs_f, stable=True)
    srt = offs_f[order]
    start = torch.ones(n, dtype=torch.bool, device=dev)
    start[1:] = srt[1:] != srt[:-1]
    seg = torch.empty(n, dtype=torch.int64, device=dev).scatter_(
        0, order, torch.cumsum(start.to(torch.int64), 0) - 1)
    madd = torch.zeros(n, dtype=torch.int32, device=dev) \
        .index_add_(0, seg, w_f)[seg]
    first = torch.full((n,), B, dtype=torch.int32, device=dev).scatter_reduce_(
        0, seg, torch.where(act_f, b_f, B), "amin")[seg]
    lead_f = act_f & (first == b_f)

    post_f = flat[offs_f.long()].to(torch.int32) + esc_lookup(esc, offs_f) \
        + madd
    new_flat = flat.clone()
    new_flat[offs_f.long()] = post_f.clamp(lo, cap).to(dtype)
    exc_f = (post_f.clamp_min(0) - cap).clamp_min(0)

    def spare(x):           # a copy of x with a spare slot C for drops
        return torch.cat([x, x.new_zeros(1)])

    # 1) overwrite live slots (excess 0 frees the slot)
    idx, hit = _slots(esc, offs_f)
    upd = lead_f & hit
    new_vals = spare(esc.vals).scatter_(0, torch.where(upd, idx, C),
                                        exc_f)[:C]
    new_offs = torch.where(new_vals > 0, esc.offs, SENTINEL)

    # 2) free slots for fresh promotions, in rank order
    need = lead_f & ~hit & (exc_f > 0)
    free = new_vals == 0
    rank = torch.cumsum(need.to(torch.int64), 0) - 1
    free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
    slot_of_rank = torch.full((C + 1,), C, dtype=torch.int64,
                              device=dev).scatter_(
        0, torch.where(free, free_rank, C),
        torch.arange(C, dtype=torch.int64, device=dev))[:C]
    ok = need & (rank < torch.sum(free))
    dest = torch.where(ok, slot_of_rank[rank.clamp(0, C - 1)], C)
    new_offs = spare(new_offs).scatter_(0, dest, offs_f)[:C]
    new_vals = spare(new_vals).scatter_(0, dest, exc_f)[:C]
    dropped = torch.sum(torch.where(need & ~ok, exc_f, 0)
                        .to(torch.float32))

    # 3) restore the sorted invariant (free SENTINEL slots sort last)
    order = torch.argsort(new_offs, stable=True)
    new_esc = EscTable(offs=new_offs[order], vals=new_vals[order],
                       lost=esc.lost + dropped)
    return new_flat.reshape(plane.shape), new_esc, post_f.reshape(B, L)


def densify(plane: torch.Tensor, esc: EscTable) -> torch.Tensor:
    """Exact int32 logical plane: narrow + scattered excess (the merge and
    diagnostic path, O(plane))."""
    dense = plane.to(torch.int32).reshape(-1).clone()
    occ = esc.offs != SENTINEL
    dense.index_add_(0, torch.where(occ, esc.offs, 0).long(),
                     torch.where(occ, esc.vals, 0))
    return dense.reshape(plane.shape)


def sq_sum(plane: torch.Tensor, esc: EscTable) -> torch.Tensor:
    """Σ logical² over the plane, the numerator of Eq. 11's closed form: a
    narrow-plane sweep plus a per-slot correction (nar + exc)² − nar²,
    which is an exact float 0 below saturation."""
    c = plane.to(torch.float32)
    base = torch.sum(c * c)
    flat = plane.reshape(-1)
    occ = esc.offs != SENTINEL
    safe = torch.where(occ, esc.offs, 0).clamp(0, flat.shape[0] - 1)
    nar = flat[safe.long()].to(torch.float32)
    tot = nar + esc.vals.to(torch.float32)
    return base + torch.sum(torch.where(occ, tot * tot - nar * nar, 0.0))


def requantize(dense: torch.Tensor, capacity: int, dtype):
    """int32 logical plane -> (narrow plane, EscTable): the ``capacity``
    largest excesses win slots, ties to the lower offset (``lax.top_k``'s
    order: a stable sort by −excess); the rest lands in ``lost``."""
    dtype = _dtype(dtype)
    cap = cap_for(dtype)
    lo = int(torch.iinfo(dtype).min)
    flat = dense.reshape(-1)
    excess = (flat - cap).clamp_min(0)
    idx = torch.argsort(-excess, stable=True)[:capacity]
    vals = excess[idx]
    keep = vals > 0
    offs = torch.where(keep, idx.to(torch.int32), SENTINEL)
    vals = torch.where(keep, vals, 0).to(torch.int32)
    order = torch.argsort(offs, stable=True)
    lost = torch.sum(excess.to(torch.float32)) \
        - torch.sum(vals.to(torch.float32))
    narrow = flat.clamp(lo, cap).to(dtype).reshape(dense.shape)
    return narrow, EscTable(offs=offs[order], vals=vals[order], lost=lost)
