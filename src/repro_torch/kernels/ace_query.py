"""ACE query kernel: gathered[b, j] = counts[j, buckets[b, j]] as fp32, or
counts[row_base[b] + j, buckets[b, j]] of a stacked (R, 2^K) table with
the optional per-row base row (``ace_update`` says why it exists).

Replaces the TPU kernel ``repro.kernels.ace_query.ace_query`` (Pallas, in
``src/repro/kernels/ace_query.py``).  CUDA source: ``csrc/ace_query.cu``.

Bound on the H100: memory — the (B, L) ids in, the (B, L) gather out, and
one read of each counter touched (the (L, 2^K) table stays in L2 between
calls).  The design is one thread per (b, j), so the id and output
streams coalesce and only the counter reads scatter.  The mean over L is
taken by the caller (``repro_torch.kernels.ops``), as in the reference.
Rows and ids outside the table are clamped into it, as the reference's
gather clamps.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ace_update import check_rows, gather_rows

KERNEL = build.Kernel("ace_query", "repro_ace_query",
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4)


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
        KERNEL(counts.device, counts.data_ptr(), buckets.data_ptr(),
               None if row_base is None else row_base.data_ptr(),
               out.data_ptr(), B, L, R, nbuckets)
    return out
