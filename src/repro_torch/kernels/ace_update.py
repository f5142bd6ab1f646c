"""ACE count-array insert kernel: counts[j, buckets[b, j]] += 1, in place,
for every row b or for the rows of an optional row mask; with an optional
per-row base row, item b's table j is row row_base[b] + j of a stacked
(R, 2^K) table (a window ring, a fleet, a windowed fleet).

Replaces the TPU kernel ``repro.kernels.ace_update.ace_update`` (Pallas,
in ``src/repro/kernels/ace_update.py``, both its scalar and one-hot
lowerings).  CUDA source: ``csrc/ace_update.cu``.

Bound on the H100: memory — the (B, L) ids plus one read-modify-write of
each counter the batch touches.  Clustered data sends hundreds of a
batch's items to one counter, and global atomics on one address
serialise, so the kernel adds equal (row, bucket) keys up inside a block
first: a block takes one table and 256 rows, a warp whose 32 lanes all
hold one key adds them with one lane, a warp of mostly distinct keys adds
straight to the counts (nothing to merge), a 512-slot shared-memory hash
table merges the block's other items, and the block then makes one
global ``atomicAdd`` per distinct key (a key that finds no slot goes
global at once).  Integer adds in any order give the same counts, so the TPU's
lowering choice (``choose_mode`` and its break-even constants) is not
carried over.

Counters are int32, int16, int8 or float32 (``build.COUNT_DTYPES``): the
adds are in the plane's own dtype, so a narrow counter wraps past its
max (int8 127 + 1 → −128) as the reference's narrow scatter-add does;
the card has no 8- or 16-bit atomic add, so those are compare-and-swap
loops (``csrc/common.cuh`` ``add_count``).

Unlike the reference, which returns a new array, the update is in place
(the counts tensor passed in is the one returned), on the CPU too.

The base row is the port's way into the live epoch of a ring and the
tenant rows of a fleet without a host sync: the reference slices
``ring[cursor]`` inside its program, and in PyTorch that slice at a
device cursor is either a gather copy or an ``int(cursor)`` sync, while a
(B,) base row computed on the device is neither.  Rows outside [0, R)
are dropped, so a bad base row never writes outside the table.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

KERNEL = build.Kernel("ace_update", "repro_ace_update",
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                      + [ctypes.c_longlong, ctypes.c_int])

# The kernel's constants (csrc/ace_update.cu): rows b a block (of one
# table), the block's shared table of counters and its probes, the hash
# signatures above which a warp counts as spread (adds straight to the
# counts), and the most tables (one grid row each).
BLOCK_ROWS, TABLE_SLOTS, PROBES, SPREAD, MAX_TABLES = 256, 512, 8, 16, 65535


def table_rows(buckets: torch.Tensor,
               row_base: torch.Tensor | None = None) -> torch.Tensor:
    """(…, L) int64 table row of each id: j, or row_base[…] + j."""
    rows = torch.arange(buckets.shape[-1], device=buckets.device)
    return rows if row_base is None else rows + row_base.long()[..., None]


def gather_rows(table: torch.Tensor, buckets: torch.Tensor,
                row_base: torch.Tensor | None = None) -> torch.Tensor:
    """table[row_base[…] + j, b_…j] (or table[j, b_…j]) from a stacked
    (R, 2^K) table, in its own dtype: every routed gather of the plain
    versions (a ring's live epoch or tail, a fleet's tenant rows)."""
    return table[table_rows(buckets, row_base), buckets.long()]


def ace_update_plain(counts: torch.Tensor, buckets: torch.Tensor,
                     row_mask: torch.Tensor | None = None,
                     row_base: torch.Tensor | None = None) -> torch.Tensor:
    """The same function in plain PyTorch (``repro.kernels.ref.ace_update_ref``;
    with a mask, ``repro.core.sketch.insert_buckets_masked``'s scatter),
    in place, adding in the counts' dtype."""
    ones = (torch.ones(buckets.shape, dtype=counts.dtype,
                       device=counts.device) if row_mask is None
            else row_mask.to(counts.dtype)[:, None].expand(buckets.shape))
    return counts.index_put_((table_rows(buckets, row_base),
                              buckets.long()), ones, accumulate=True)


def check_rows(counts: torch.Tensor, buckets: torch.Tensor,
               row_base: torch.Tensor | None, operands: list) -> None:
    """The shape contract shared with ``ace_query``: counts (R, 2^K) and
    buckets (B, L) with R == L, or any R with a (B,) int32 ``row_base``."""
    B, L = buckets.shape
    build.check(buckets, "buckets", torch.int32, (B, L))
    if row_base is None:
        build.check(counts, "counts", counts.dtype, (L, counts.shape[1]))
    else:
        build.check(row_base, "row_base", torch.int32, (B,))
        operands.append(row_base)


def ace_update(counts: torch.Tensor, buckets: torch.Tensor,
               row_mask: torch.Tensor | None = None,
               row_base: torch.Tensor | None = None) -> torch.Tensor:
    """counts (R, 2^K) of any ``build.COUNT_DTYPES`` += histogram of
    buckets (B, L) int32, over the rows where ``row_mask`` (B,) bool is
    True when one is given; item b's table j is row ``row_base[b] + j``
    ((B,) int32) or j.  Returns ``counts``, updated in place."""
    R, nbuckets = counts.shape
    B, L = buckets.shape
    build.check_counts(counts, "counts", (R, nbuckets))
    operands = [counts, buckets]
    check_rows(counts, buckets, row_base, operands)
    if row_mask is not None:
        build.check(row_mask, "row_mask", torch.bool, (B,))
        operands.append(row_mask)
    if build.on_cpu(*operands):
        return ace_update_plain(counts, buckets, row_mask, row_base)
    if L > MAX_TABLES:
        raise ValueError(f"ace_update: L={L} tables; the kernel takes at "
                         f"most {MAX_TABLES}")
    if B and L:
        KERNEL(counts.device, counts.data_ptr(), buckets.data_ptr(),
               None if row_mask is None else row_mask.data_ptr(),
               None if row_base is None else row_base.data_ptr(),
               B, L, R, nbuckets, build.count_code(counts))
    return counts
