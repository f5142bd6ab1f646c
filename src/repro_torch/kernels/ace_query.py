"""ACE query kernel: gathered[b, j] = counts[j, buckets[b, j]] as fp32.

Replaces the TPU kernel ``repro.kernels.ace_query.ace_query`` (Pallas, in
``src/repro/kernels/ace_query.py``).  CUDA source: ``csrc/ace_query.cu``.

Bound on the H100: memory — the (B, L) ids in, the (B, L) gather out, and
one read of each counter touched (the (L, 2^K) table stays in L2 between
calls).  The design is one thread per (b, j), so the id and output
streams coalesce and only the counter reads scatter.  The mean over L is
taken by the caller (``repro_torch.kernels.ops``), as in the reference.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

KERNEL = build.Kernel("ace_query", "repro_ace_query",
                      [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3)


def ace_query_plain(counts: torch.Tensor,
                    buckets: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch (``repro.kernels.ref.ace_query_ref``)."""
    rows = torch.arange(counts.shape[0], device=counts.device)[None, :]
    return counts[rows, buckets.long()].to(torch.float32)


def ace_query(counts: torch.Tensor, buckets: torch.Tensor) -> torch.Tensor:
    """counts (L, 2^K) int32, buckets (B, L) int32 -> gathered (B, L) fp32."""
    L, nbuckets = counts.shape
    B = buckets.shape[0]
    build.check(counts, "counts", torch.int32, (L, nbuckets))
    build.check(buckets, "buckets", torch.int32, (B, L))
    if build.on_cpu(counts, buckets):
        return ace_query_plain(counts, buckets)
    out = torch.empty((B, L), dtype=torch.float32, device=counts.device)
    if B:
        KERNEL(counts.device, counts.data_ptr(), buckets.data_ptr(),
               out.data_ptr(), B, L, nbuckets)
    return out
