"""Fused ACE scoring kernel: dense SRP hash -> one row-offset gather ->
the row's exact integer sum × float32(1/L), or Σ_j tw_j·g_j in table
order with ``table_weights``.  (B, d) queries -> (B,) float32 scores.

Replaces the TPU kernel ``repro.kernels.ace_score_fused.ace_score_fused``
(Pallas, in ``src/repro/kernels/ace_score_fused.py``).  CUDA source:
``csrc/ace_score_fused.cu`` with the block hash ``csrc/srp_gemm.cuh``.

Bound on the H100: the hash's fp32 operations, 2·B·d·K·L FLOP at 67
TFLOP/s (at the estimator's B=16,384, d=36, K·L=750: 0.88 GFLOP, 13 µs);
q, W, the counters touched and the scores are a few MB.  The design is
``ace_admit_fused``'s, two kernels on one stream: phase 1 is
``srp_hash``'s register-tiled, cluster-split hash under the same launch
plan (``srp_hash.device_plan``), so its ids are ``srp_hash``'s bits, and
its epilogue gathers each table's counter at j·2^K + b_j into a (B, L)
scratch; phase 2 sums each row, a warp a row (``ace_query_sum``'s
design).  The bucket ids never reach device memory.

The unweighted score takes ``ace_query_sum``'s convention: the exact
integer sum, one conversion, then × float32(1/L) — bitwise
``srp_hash`` + ``ace_query_sum`` (the SRHT branch of ``ops.ace_score``),
and bitwise a float sum in any order while a row's sum is below 2^24.
The weighted form adds g_j·tw_j in table order j = 0..L−1 with
``__fmul_rn``/``__fadd_rn`` (no FMA), as ``ace_score_fused_plain`` does,
so wherever the ids agree the scores are bitwise equal.

Counters are int32, int16, int8 or float32 (``build.COUNT_DTYPES``): the
scratch holds their values as int32 (float32 for float counters) and the
unweighted row sum is ``ace_query_sum``'s, exact in int64 (float64).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.srp import SrpConfig
from repro_torch.kernels import build
from repro_torch.kernels.ace_query import ace_query_sum_plain
from repro_torch.kernels.ace_update import MAX_TABLES
from repro_torch.kernels.srp_hash import (PLAN_ARGTYPES, HashPlan,
                                          check_w_aligned, device_plan,
                                          lane_padded, srp_hash_plain)

KERNEL = build.Kernel("ace_score_fused", "repro_ace_score_fused",
                      [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                      + PLAN_ARGTYPES + [ctypes.c_int])

def gather_dtype(counts: torch.Tensor) -> torch.dtype:
    """The dtype of the fused kernels' (B, L) gather scratch: int32 for
    integer counters (narrow ones widened), float32 for float ones."""
    return torch.float32 if counts.is_floating_point() else torch.int32


def flat_table_gather(counts: torch.Tensor,
                      buckets: torch.Tensor) -> torch.Tensor:
    """counts[j, buckets[:, j]] as one gather from the raveled (L·2^K,)
    counts at j·2^K + b_j (``repro.kernels.ace_score_fused
    .flat_table_gather``): (B, L) ids -> (B, L) float32."""
    L, nbuckets = counts.shape
    offs = buckets.long() + torch.arange(
        L, device=buckets.device)[None, :] * nbuckets
    return counts.reshape(-1)[offs].to(torch.float32)


def table_order_sum(g: torch.Tensor,
                    table_weights: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """(B, L) -> (B,): the L columns (times ``table_weights`` (L,) when
    given) added in table order j = 0..L−1, one add each, as every kernel
    of the port that sums a row of float gathers does (``__fadd_rn``/
    ``__fmul_rn``), so the plain versions give the kernels' bits."""
    s = torch.zeros(g.shape[0], dtype=torch.float32, device=g.device)
    for j in range(g.shape[1]):
        s = s + (g[:, j] if table_weights is None
                 else g[:, j] * table_weights[j])
    return s


def ace_score_fused_plain(counts: torch.Tensor, q: torch.Tensor,
                          w: torch.Tensor, cfg: SrpConfig,
                          table_weights: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """The same function in plain PyTorch: the unweighted score is
    ``ace_query_sum_plain``'s mean of the hash's counters (the exact sum ×
    float32(1/L)), the weighted one the table-order sum
    (``repro.kernels.ref.ace_score_ref`` sums in XLA's order instead)."""
    ids = srp_hash_plain(q, w, cfg)
    if table_weights is None:
        return ace_query_sum_plain(counts, ids)
    return table_order_sum(flat_table_gather(counts, ids), table_weights)


def ace_score_fused(counts: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
                    cfg: SrpConfig,
                    table_weights: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """counts (L, 2^K) of any ``build.COUNT_DTYPES``, q (B, d) fp32, w
    (d, P) fp32 -> scores (B,) fp32.  ``table_weights`` (L,) fp32, when given, replaces the 1/L mean
    with Σ_j tw_j·g_j (the degraded path: the caller bakes the health
    mask and its 1/num_healthy into tw)."""
    return ace_score_fused_planned(counts, q, w, cfg, table_weights, None)


def ace_score_fused_planned(counts: torch.Tensor, q: torch.Tensor,
                            w: torch.Tensor, cfg: SrpConfig,
                            table_weights: torch.Tensor | None,
                            plan: HashPlan | None, *,
                            with_ids: bool = False):
    """``ace_score_fused`` with the hash under a given launch plan (None:
    ``srp_hash.device_plan``'s); ``with_ids`` also returns the (B, L)
    int32 bucket ids the kernel hashed (the plain hash's on the CPU)."""
    L, nbuckets = counts.shape
    B, d = q.shape
    K, P = cfg.num_bits, cfg.padded_projections
    build.check_bits(K)
    if L != cfg.num_tables or nbuckets != cfg.num_buckets:
        raise ValueError(f"counts {tuple(counts.shape)} do not match "
                         f"K={K}, L={cfg.num_tables}")
    if L > MAX_TABLES:
        raise ValueError(f"ace_score_fused: L={L} tables; the kernel takes "
                         f"at most {MAX_TABLES}")
    build.check_counts(counts, "counts", (L, nbuckets))
    build.check(q, "q", torch.float32, (B, d))
    build.check(w, "w", torch.float32, (d, P))
    operands = [counts, q, w]
    if table_weights is not None:
        build.check(table_weights, "table_weights", torch.float32, (L,))
        operands.append(table_weights)
    if build.on_cpu(*operands):
        scores = ace_score_fused_plain(counts, q, w, cfg, table_weights)
        return (scores, srp_hash_plain(q, w, cfg)) if with_ids else scores
    dev = counts.device
    scores = torch.empty((B,), dtype=torch.float32, device=dev)
    ids = torch.empty((B, L), dtype=torch.int32, device=dev) \
        if with_ids else None
    if B:
        w, P = lane_padded(w, cfg)
        check_w_aligned(w)
        plan = plan or device_plan(B, d, K, L, dev)
        gathered = torch.empty((B, L), dtype=gather_dtype(counts),
                               device=dev)
        KERNEL(dev, counts.data_ptr(), q.data_ptr(), w.data_ptr(),
               None if table_weights is None else table_weights.data_ptr(),
               gathered.data_ptr(),
               None if ids is None else ids.data_ptr(), scores.data_ptr(),
               B, d, P, K, L, *plan.args(), build.count_code(counts))
    return (scores, ids) if with_ids else scores
