"""ACE query kernel, two entry points on one source
(``csrc/ace_query.cu``).

* ``ace_query_sum`` — what every main path launches: each row's gathered
  counters of the healthy tables summed as an exact integer, converted to
  fp32 once and scaled as the caller scales (``SCALES``), (B,) out.  One
  launch where the caller took the gather plus two to seven PyTorch ops,
  and the (B, L) matrix is never written.  While a row's sum is below
  2^24, fp32 sums of integer-valued floats are exact in any order, so the
  bits are those of the gather-then-reduce it replaces; above it, kernel
  and plain version agree on the exactly rounded sum.
* ``ace_query`` — gathered[b, j] = counts[j, buckets[b, j]] as fp32, (B, L),
  kept, as the reference keeps it, so that diagnostics can see the
  per-table counts.

Either reads counts[row_base[b] + j, buckets[b, j]] of a stacked (R, 2^K)
table with the optional per-row base row (``ace_update`` says why it
exists).  Replaces the TPU kernel ``repro.kernels.ace_query.ace_query``
(Pallas, in ``src/repro/kernels/ace_query.py``) and the mean over L that
``repro.kernels.ops`` takes after it.

Bound on the H100: memory — the (B, L) ids, the (B,) base rows and
results, and one read of each counter touched (the (L, 2^K) table stays
in L2 between calls).  What a gather waits on is three dependent loads
(base row, id, counter), so the sum takes one warp a row, lanes over
tables: the row's ids are one coalesced run, the base row and tenant id
one load broadcast by shuffle, both counter loads of a lane in flight at
once, the integer sum two ``redux.sync`` adds and the healthy count a
ballot.  Rows, ids and tenant ids outside the table are clamped into it,
as the reference's gather clamps.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import sketch as sk
from repro_torch.kernels import build
from repro_torch.kernels.ace_update import (MAX_TABLES, check_rows,
                                            gather_rows, table_rows)

# How ``ace_query_sum`` scales a row's sum s over nh healthy tables (nh = L
# without a mask, at least 1 with one): "sum" gives s; "mean" s · (1/nh),
# with no mask s · float32(1/L) (``sketch.reciprocal``), the port's table
# mean and what ``torch.mean`` computes on a CUDA tensor.
SCALES = ("sum", "mean")

# Every main path's gather-and-sum; its count is the module's launches.
KERNEL = build.Kernel("ace_query", "repro_ace_query_sum",
                      [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                      + [ctypes.c_longlong] + [ctypes.c_int] * 2)
# The (B, L) gather, for diagnostics.
GATHER_KERNEL = build.Kernel("ace_query", "repro_ace_query",
                             [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                             + [ctypes.c_longlong])


def ace_query_plain(counts: torch.Tensor, buckets: torch.Tensor,
                    row_base: torch.Tensor | None = None) -> torch.Tensor:
    """The same function in plain PyTorch (``repro.kernels.ref.ace_query_ref``)."""
    return gather_rows(counts, buckets, row_base).to(torch.float32)


def ace_query(counts: torch.Tensor, buckets: torch.Tensor,
              row_base: torch.Tensor | None = None) -> torch.Tensor:
    """counts (R, 2^K) int32, buckets (B, L) int32 -> gathered (B, L) fp32;
    item b's table j is row ``row_base[b] + j`` ((B,) int32) or j."""
    R, nbuckets = counts.shape
    B, L = buckets.shape
    build.check(counts, "counts", torch.int32, (R, nbuckets))
    operands = [counts, buckets]
    check_rows(counts, buckets, row_base, operands)
    if build.on_cpu(*operands):
        return ace_query_plain(counts, buckets, row_base)
    out = torch.empty((B, L), dtype=torch.float32, device=counts.device)
    if B:
        GATHER_KERNEL(counts.device, counts.data_ptr(), buckets.data_ptr(),
                      None if row_base is None else row_base.data_ptr(),
                      out.data_ptr(), B, L, R, nbuckets)
    return out


def healthy_tables(table_mask: torch.Tensor,
                   tenant_ids: torch.Tensor | None) -> torch.Tensor:
    """The bool health of each table, (L,), or each item's row of a (T, L)
    mask, (B, L), at its tenant id clamped into [0, T)."""
    healthy = table_mask != 0
    if healthy.dim() == 1:
        return healthy
    return healthy[tenant_ids.long().clamp(0, healthy.shape[0] - 1)]


def ace_query_sum_plain(counts: torch.Tensor, buckets: torch.Tensor,
                        row_base: torch.Tensor | None = None, *,
                        table_mask: torch.Tensor | None = None,
                        tenant_ids: torch.Tensor | None = None,
                        scale: str = "mean", with_unmasked: bool = False):
    """The same function in plain PyTorch: the clamped gather summed in
    int64, converted once and scaled as the kernel does."""
    R, nbuckets = counts.shape
    L = buckets.shape[1]
    g = counts[table_rows(buckets, row_base).clamp(0, R - 1),
               buckets.long().clamp(0, nbuckets - 1)].long()
    total = torch.sum(g, dim=-1)
    s, nh = total, None
    if table_mask is not None:
        healthy = healthy_tables(table_mask, tenant_ids)
        s = torch.sum(torch.where(healthy, g, 0), dim=-1)
        nh = torch.clamp_min(torch.sum(healthy, dim=-1).to(torch.float32),
                             1.0)
    out = s.to(torch.float32)
    if scale == "mean":
        out = out * (sk.reciprocal(L) if nh is None else 1.0 / nh)
    return (out, total.to(torch.float32)) if with_unmasked else out


def ace_query_sum(counts: torch.Tensor, buckets: torch.Tensor,
                  row_base: torch.Tensor | None = None, *,
                  table_mask: torch.Tensor | None = None,
                  tenant_ids: torch.Tensor | None = None,
                  scale: str = "mean", with_unmasked: bool = False):
    """counts (R, 2^K) int32, buckets (B, L) int32 -> (B,) fp32: the sum of
    each row's gathered counters over its healthy tables, scaled by
    ``scale`` (``SCALES``).  Item b's table j is row ``row_base[b] + j``
    ((B,) int32) or j.  ``table_mask`` (L,), or (T, L) routed by
    ``tenant_ids`` (B,) int32, marks the healthy tables (nonzero); without
    one every table is.  ``with_unmasked`` also returns the unscaled sum
    over every table, (B,) fp32, as a second result."""
    R, nbuckets = counts.shape
    B, L = buckets.shape
    build.check(counts, "counts", torch.int32, (R, nbuckets))
    operands = [counts, buckets]
    check_rows(counts, buckets, row_base, operands)
    if scale not in SCALES:
        raise ValueError(f"scale must be one of {SCALES}, got {scale!r}")
    if L > MAX_TABLES:
        raise ValueError(f"ace_query_sum: L={L} tables; the kernel takes "
                         f"at most {MAX_TABLES}")
    if table_mask is not None:
        operands.append(table_mask)
        if table_mask.dim() == 1:
            build.check(table_mask, "table_mask", table_mask.dtype, (L,))
        else:
            build.check(table_mask, "table_mask", table_mask.dtype,
                        (table_mask.shape[0], L))
            if tenant_ids is None:
                raise ValueError("a (T, L) table_mask needs tenant_ids")
            build.check(tenant_ids, "tenant_ids", torch.int32, (B,))
            operands.append(tenant_ids)
    if build.on_cpu(*operands):
        return ace_query_sum_plain(counts, buckets, row_base,
                                   table_mask=table_mask,
                                   tenant_ids=tenant_ids, scale=scale,
                                   with_unmasked=with_unmasked)
    dev = counts.device
    out = torch.empty((B,), dtype=torch.float32, device=dev)
    out_all = torch.empty((B,), dtype=torch.float32, device=dev) \
        if with_unmasked else None
    mask, routed, T = None, None, 1
    if table_mask is not None:
        mask = (table_mask != 0).to(torch.uint8)
        if mask.dim() == 2:
            routed, T = tenant_ids, mask.shape[0]
    if B:
        KERNEL(dev, counts.data_ptr(), buckets.data_ptr(),
               None if row_base is None else row_base.data_ptr(),
               None if mask is None else mask.data_ptr(),
               None if routed is None else routed.data_ptr(),
               out.data_ptr(),
               None if out_all is None else out_all.data_ptr(),
               B, L, R, nbuckets, T, SCALES.index(scale))
    return (out, out_all) if with_unmasked else out
