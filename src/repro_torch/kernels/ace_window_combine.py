"""Windowed ACE scoring kernel: the E-way weighted combine of an epoch
ring, score_b = (1/L)·Σ_e w_e·Σ_j C_e[j, b_j], or Σ_e w_e·Σ_j tw_j·C_e[j, b_j]
with ``table_weights`` — (E, L, 2^K) ring + (B, L) ids + (E,) γ^age
weights -> (B,) float32.

Replaces the TPU kernel ``repro.kernels.ace_window_combine
.ace_window_combine`` (Pallas, in ``src/repro/kernels/ace_window_combine.py``,
both its lowerings).  CUDA source: ``csrc/ace_window_combine.cu``.

Bound on the H100: memory — the ids, the scores and one read of each
counter the batch touches in each epoch.  The design is one kernel, a
warp a row (``ace_query_sum``'s): a lane loads two tables' ids once and
issues their counter loads in up to 8 epochs at once; each epoch's sum is
exact in int64 and converted once, the epochs are weighted and
accumulated in ring-index order, then × float32(1/L) — the order of the
reference's ``window.ring.score_from_sums`` with each epoch's table sum
exact, which is the bits of a float sum in any order while that sum is
below 2^24.  With ``table_weights`` each epoch adds g_j·tw_j in table
order j = 0..L−1 instead (one lane an epoch, from the products the warp
forms in shared memory), and there is no 1/L.  The kernel adds and
multiplies with ``__fadd_rn``/``__fmul_rn`` and
``ace_window_combine_plain`` runs the same arithmetic, so the two agree
bitwise.  The reference's ``mode``, ``choose_mode`` and ``FLAT_MAX_COLS``
choose between two TPU lowerings from a budget calibrated on the TPU; one
kernel serves every E·L here, and they are not carried over.  Rings are int32, int16, int8 or float32
(``build.COUNT_DTYPES``): narrow counters are read with their sign, and
a float ring's epoch sums are taken in float64, converted once.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import sketch as sk
from repro_torch.kernels import build
from repro_torch.kernels.ace_score_fused import table_order_sum
from repro_torch.kernels.ace_update import MAX_TABLES, gather_rows

KERNEL = build.Kernel("ace_window_combine", "repro_ace_window_combine",
                      [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                      + [ctypes.c_longlong, ctypes.c_int])


def ring_gather(counts: torch.Tensor, buckets: torch.Tensor) -> torch.Tensor:
    """C_e[j, b_ij] for every epoch: (B, E, L) in the ring's dtype, one
    gather from the (E·L, 2^K) ring at rows e·L + j."""
    E, L, nbuckets = counts.shape
    bases = torch.arange(E, device=buckets.device) * L
    return gather_rows(counts.reshape(E * L, nbuckets), buckets[:, None, :],
                       bases)


def ace_window_combine_plain(counts: torch.Tensor, buckets: torch.Tensor,
                             weights: torch.Tensor,
                             table_weights: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """The same function in plain PyTorch, in the kernel's order: each
    epoch's exact integer sum converted once (with ``table_weights``, the
    weighted gathers added in table order), weighted, accumulated in
    ring-index order (``repro.kernels.ref`` and
    ``repro.window.ring.score_windowed`` sum each epoch in float, in XLA's
    order)."""
    E, L, _ = counts.shape
    g = ring_gather(counts, buckets)
    acc = torch.zeros(g.shape[0], dtype=torch.float32, device=g.device)
    for e in range(E):
        if table_weights is None:
            s = torch.sum(g[:, e], dim=-1, dtype=torch.float64
                          if g.is_floating_point() else torch.int64)
            s = s.to(torch.float32)
        else:
            s = table_order_sum(g[:, e].to(torch.float32), table_weights)
        acc = acc + weights[e] * s
    return acc if table_weights is not None else acc * sk.reciprocal(L)


def ace_window_combine(counts: torch.Tensor, buckets: torch.Tensor,
                       weights: torch.Tensor,
                       table_weights: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """counts (E, L, 2^K) of any ``build.COUNT_DTYPES``, buckets (B, L)
    int32, weights (E,) fp32
    -> scores (B,) fp32.  ``table_weights`` (L,) fp32, when given, weighs
    each table's gather and replaces the 1/L mean (the caller bakes the
    health mask and its 1/num_healthy in)."""
    E, L, nbuckets = counts.shape
    B = buckets.shape[0]
    build.check_counts(counts, "counts", (E, L, nbuckets))
    build.check(buckets, "buckets", torch.int32, (B, L))
    build.check(weights, "weights", torch.float32, (E,))
    operands = [counts, buckets, weights]
    if table_weights is not None:
        build.check(table_weights, "table_weights", torch.float32, (L,))
        operands.append(table_weights)
    if L > MAX_TABLES:
        raise ValueError(f"ace_window_combine: L={L} tables; the kernel "
                         f"takes at most {MAX_TABLES}")
    if build.on_cpu(*operands):
        return ace_window_combine_plain(counts, buckets, weights,
                                        table_weights)
    dev = counts.device
    scores = torch.empty((B,), dtype=torch.float32, device=dev)
    if B:
        KERNEL(dev, counts.data_ptr(), buckets.data_ptr(), weights.data_ptr(),
               None if table_weights is None else table_weights.data_ptr(),
               scores.data_ptr(), B, E, L, nbuckets,
               build.count_code(counts))
    return scores
