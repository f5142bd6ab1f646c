"""ACE count-array insert kernel: counts[j, buckets[b, j]] += 1, in place,
for every row b or for the rows of an optional row mask.

Replaces the TPU kernel ``repro.kernels.ace_update.ace_update`` (Pallas,
in ``src/repro/kernels/ace_update.py``, both its scalar and one-hot
lowerings).  CUDA source: ``csrc/ace_update.cu``.

Bound on the H100: memory — the (B, L) ids plus one read-modify-write of
each counter the batch touches.  The design is one thread per (b, j) and a
global int32 ``atomicAdd``, exact in any order, so the TPU's lowering
choice (``choose_mode`` and its break-even constants) is not carried
over.  Clustered data serialises the atomics on hot buckets; a
shared-memory histogram is the remedy, left for a later change.

Unlike the reference, which returns a new array, the update is in place
(the counts tensor passed in is the one returned), on the CPU too.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

KERNEL = build.Kernel("ace_update", "repro_ace_update",
                      [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3)


def ace_update_plain(counts: torch.Tensor, buckets: torch.Tensor,
                     row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """The same function in plain PyTorch (``repro.kernels.ref.ace_update_ref``;
    with a mask, ``repro.core.sketch.insert_buckets_masked``'s scatter),
    in place."""
    rows = torch.arange(counts.shape[0], device=counts.device)[None, :]
    ones = (torch.ones_like(buckets) if row_mask is None
            else row_mask.to(torch.int32)[:, None].expand(buckets.shape))
    return counts.index_put_((rows, buckets.long()), ones, accumulate=True)


def ace_update(counts: torch.Tensor, buckets: torch.Tensor,
               row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """counts (L, 2^K) int32 += histogram of buckets (B, L) int32, over the
    rows where ``row_mask`` (B,) bool is True when one is given; returns
    ``counts``, updated in place."""
    L, nbuckets = counts.shape
    B = buckets.shape[0]
    build.check(counts, "counts", torch.int32, (L, nbuckets))
    build.check(buckets, "buckets", torch.int32, (B, L))
    operands = [counts, buckets]
    if row_mask is not None:
        build.check(row_mask, "row_mask", torch.bool, (B,))
        operands.append(row_mask)
    if build.on_cpu(*operands):
        return ace_update_plain(counts, buckets, row_mask)
    if B:
        KERNEL(counts.device, counts.data_ptr(), buckets.data_ptr(),
               None if row_mask is None else row_mask.data_ptr(),
               B, L, nbuckets)
    return counts
