"""Windowed ACE scoring kernel: the E-way weighted combine of an epoch
ring, score_b = (1/L)·Σ_e w_e·Σ_j C_e[j, b_j], or Σ_e w_e·Σ_j tw_j·C_e[j, b_j]
with ``table_weights`` — (E, L, 2^K) ring + (B, L) ids + (E,) γ^age
weights -> (B,) float32.

Replaces the TPU kernel ``repro.kernels.ace_window_combine
.ace_window_combine`` (Pallas, in ``src/repro/kernels/ace_window_combine.py``,
both its lowerings).  CUDA source: ``csrc/ace_window_combine.cu``.

Bound on the H100: memory — the ids, the scores and one read of each
counter the batch touches in each epoch.  The design is two kernels on one
stream: one thread per (row, epoch, table) gathers into a (B, E, L)
scratch, then one thread per row sums each epoch's gathers in table order,
weights them and accumulates over the epochs in ring-index order, then
multiplies by float32(1/L) — the order of the reference's
``window.ring.score_from_sums``.  The kernel adds and multiplies with
``__fadd_rn``/``__fmul_rn`` and ``ace_window_combine_plain`` runs the same
explicit loops, so the two agree bitwise.  The reference's ``mode``,
``choose_mode`` and ``FLAT_MAX_COLS`` choose between two TPU lowerings from
a budget calibrated on the TPU; one gather kernel serves every E·L here,
and they are not carried over.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import sketch as sk
from repro_torch.kernels import build
from repro_torch.kernels.ace_score_fused import table_order_sum
from repro_torch.kernels.ace_update import gather_rows

KERNEL = build.Kernel("ace_window_combine", "repro_ace_window_combine",
                      [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                      + [ctypes.c_float])


def ring_gather(counts: torch.Tensor, buckets: torch.Tensor) -> torch.Tensor:
    """C_e[j, b_ij] for every epoch: (B, E, L) float32, one gather from
    the (E·L, 2^K) ring at rows e·L + j."""
    E, L, nbuckets = counts.shape
    bases = torch.arange(E, device=buckets.device) * L
    return gather_rows(counts.reshape(E * L, nbuckets), buckets[:, None, :],
                       bases).to(torch.float32)


def ace_window_combine_plain(counts: torch.Tensor, buckets: torch.Tensor,
                             weights: torch.Tensor,
                             table_weights: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """The same function in plain PyTorch, in the kernel's order: table
    order within an epoch, ring-index order across epochs
    (``repro.kernels.ref`` and ``repro.window.ring.score_windowed`` sum
    each epoch in XLA's order instead)."""
    E, L, _ = counts.shape
    g = ring_gather(counts, buckets)
    acc = torch.zeros(g.shape[0], dtype=torch.float32, device=g.device)
    for e in range(E):
        acc = acc + weights[e] * table_order_sum(g[:, e], table_weights)
    return acc if table_weights is not None else acc * sk.reciprocal(L)


def ace_window_combine(counts: torch.Tensor, buckets: torch.Tensor,
                       weights: torch.Tensor,
                       table_weights: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """counts (E, L, 2^K) int32, buckets (B, L) int32, weights (E,) fp32
    -> scores (B,) fp32.  ``table_weights`` (L,) fp32, when given, weighs
    each table's gather and replaces the 1/L mean (the caller bakes the
    health mask and its 1/num_healthy in)."""
    E, L, nbuckets = counts.shape
    B = buckets.shape[0]
    build.check(counts, "counts", torch.int32, (E, L, nbuckets))
    build.check(buckets, "buckets", torch.int32, (B, L))
    build.check(weights, "weights", torch.float32, (E,))
    operands = [counts, buckets, weights]
    if table_weights is not None:
        build.check(table_weights, "table_weights", torch.float32, (L,))
        operands.append(table_weights)
    if build.on_cpu(*operands):
        return ace_window_combine_plain(counts, buckets, weights,
                                        table_weights)
    dev = counts.device
    scores = torch.empty((B,), dtype=torch.float32, device=dev)
    if B:
        gathered = torch.empty((B, E, L), dtype=torch.float32, device=dev)
        KERNEL(dev, counts.data_ptr(), buckets.data_ptr(), weights.data_ptr(),
               None if table_weights is None else table_weights.data_ptr(),
               gathered.data_ptr(), scores.data_ptr(), B, E, L, nbuckets,
               1.0 / L)
    return scores
