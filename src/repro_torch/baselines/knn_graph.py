"""Shared brute-force k-nearest-neighbour graph (the substrate all the
ELKI-style baselines consume, computed once per dataset like ELKI's
index) — port of ``repro.baselines.knn_graph``.

Chunked O(n²·d), exact and memory-bounded: a chunk of 2048 rows holds a
(2048, n) float32 distance block (4.9 GB at the KDD-Cup99 HTTP size,
n = 596,853).  The reference computes it in plain jnp outside any Pallas
kernel, so the product stays ``torch.matmul`` (TF32 off, PyTorch's
default) and the selection ``torch.topk``.  The graph stays on the
device: every scorer of ``neighbors`` and ``cof`` reads it there.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device


def _chunk_topk(chunk: torch.Tensor, data: torch.Tensor,
                data_sq: torch.Tensor, base: int, k: int):
    """Exact k smallest distances of ``chunk`` rows (data[base:base+m])
    against ``data``: (m, k) float32 distances and int64 indices."""
    # squared euclidean via the expansion trick, in the reference's order
    # ((|a|² − 2a·b) + |b|²), in place to keep one (m, n) block
    d2 = chunk @ data.T
    d2.mul_(-2.0).add_(torch.sum(chunk**2, 1)[:, None])
    d2.add_(data_sq[None, :]).clamp_min_(0.0)
    m = chunk.shape[0]
    rows = torch.arange(m, device=chunk.device)
    d2[rows, base + rows] = float("inf")       # mask self-distance
    vals, idx = torch.topk(d2, k, dim=1, largest=False, sorted=True)
    return torch.sqrt(torch.clamp_min(vals, 0.0)), idx


def knn_graph(x, k: int, chunk: int = 2048, device=None):
    """Exact kNN graph of the rows of x (n, d).  Returns (dists (n, k)
    float32, idx (n, k) int64), nearest first, on ``device`` (CUDA unless
    the caller passes another)."""
    dev = resolve_device(device)
    data = torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()
    n = data.shape[0]
    data_sq = torch.sum(data**2, 1)
    dists = torch.empty((n, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n, k), dtype=torch.int64, device=dev)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        dists[s:e], idx[s:e] = _chunk_topk(data[s:e], data, data_sq, s, k)
    return dists, idx


def pairwise_within_neighborhood(x, idx: torch.Tensor,
                                 chunk: int = 65_536) -> torch.Tensor:
    """Pairwise distances inside each {p} ∪ kNN(p) set: (n, k+1, k+1)
    float32 on idx's device, slot 0 being p itself.  Used by COF (MST
    chaining) and LDOF (inner pairwise mean).

    The reference builds the whole (n, k+1, k+1, d) difference block at
    once (10.4 GB at n = 596,853, k = 10, d = 36); here it is built
    ``chunk`` rows at a time, with the same arithmetic for every entry.
    """
    n, k = idx.shape
    data = torch.as_tensor(x, dtype=torch.float32,
                           device=idx.device).contiguous()
    full_idx = torch.cat(
        [torch.arange(n, device=idx.device)[:, None], idx.long()], dim=1)
    out = torch.empty((n, k + 1, k + 1), dtype=torch.float32,
                      device=idx.device)
    for s in range(0, n, chunk):
        pts = data[full_idx[s:s + chunk]]                  # (m, k+1, d)
        diff = pts[:, :, None, :] - pts[:, None, :, :]
        out[s:s + chunk] = torch.sqrt(
            torch.clamp_min(torch.sum(diff**2, -1), 0.0))
    return out
