"""Fused multi-tenant ACE scoring kernel: dense SRP hash -> gather at row
tenant_ids[b]·L + j of the (T·L, 2^K) fleet -> the row's exact integer
sum × float32(1/L).  (B, d) queries + (B,) tenant ids -> (B,) float32
scores, each item against its own tenant's tables.

Replaces the TPU kernel ``repro.kernels.ace_fleet_score.ace_fleet_score``
(Pallas, in ``src/repro/kernels/ace_fleet_score.py``).  CUDA source:
``csrc/ace_fleet_score.cu`` with the block hash ``csrc/srp_gemm.cuh``.

Bound on the H100: the hash's fp32 operations, 2·B·d·K·L FLOP at 67
TFLOP/s (at the guardrail's B=256, d=4097, K·L=750: 1.57 GFLOP, 23 µs).
The design is ``ace_score_fused``'s, two kernels on one stream: phase 1
is ``srp_hash``'s register-tiled, cluster-split hash under the same
launch plan (``srp_hash.device_plan``), so its ids are ``srp_hash``'s
bits, and its epilogue gathers each table's counter at (tid·L + j)·2^K +
b_j into a (B, L) scratch; phase 2 sums each row, a warp a row.  The
bucket ids never reach device memory.

The score takes ``ace_query_sum``'s convention: the exact integer sum,
one conversion, then × float32(1/L) — bitwise ``srp_hash`` + the routed
``ace_query_sum`` (the SRHT and masked branch of ``ops.ace_fleet_score``),
and bitwise a float sum in any order while a row's sum is below 2^24.
Counters are int32, int16, int8 or float32 (``build.COUNT_DTYPES``),
summed as in ``ace_score_fused``.  A row whose tenant id lies outside
[0, T) scores 0 on the card (nothing
outside the fleet is read); the entry points reject such ids on the host.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.srp import SrpConfig
from repro_torch.kernels import build
from repro_torch.kernels.ace_query import ace_query_sum_plain
from repro_torch.kernels.ace_score_fused import gather_dtype
from repro_torch.kernels.ace_update import MAX_TABLES
from repro_torch.kernels.srp_hash import (OPERAND_ARGTYPES, PLAN_ARGTYPES,
                                          HashPlan, check_w_aligned,
                                          device_plan, lane_padded,
                                          srp_hash_plain)

KERNEL = build.Kernel("ace_fleet_score", "repro_ace_fleet_score",
                      [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                      + PLAN_ARGTYPES + [ctypes.c_int] + OPERAND_ARGTYPES)


def ace_fleet_score_plain(counts: torch.Tensor, q: torch.Tensor,
                          tenant_ids: torch.Tensor, w: torch.Tensor,
                          cfg: SrpConfig) -> torch.Tensor:
    """The same function in plain PyTorch: the plain hash, then
    ``fleet_score_from_ids`` (``repro.kernels.ref`` sums each row in
    float, in XLA's order)."""
    return fleet_score_from_ids(counts, srp_hash_plain(q, w, cfg),
                                tenant_ids)


def fleet_score_from_ids(counts: torch.Tensor, buckets: torch.Tensor,
                         tenant_ids: torch.Tensor) -> torch.Tensor:
    """The kernel's scores downstream of given (B, L) bucket ids:
    ``ace_query_sum_plain`` at base rows tid·L of the (T·L, 2^K) fleet,
    the exact row sum × float32(1/L)."""
    T, L, nbuckets = counts.shape
    return ace_query_sum_plain(counts.reshape(T * L, nbuckets), buckets,
                               tenant_ids.long() * L)


def ace_fleet_score(counts: torch.Tensor, q: torch.Tensor,
                    tenant_ids: torch.Tensor, w: torch.Tensor,
                    cfg: SrpConfig) -> torch.Tensor:
    """counts (T, L, 2^K) of any ``build.COUNT_DTYPES``, q (B, d),
    tenant_ids (B,) int32 in [0, T), w (d, P); q and w each of any
    ``build.OPERAND_DTYPES`` -> scores (B,) fp32."""
    return ace_fleet_score_planned(counts, q, tenant_ids, w, cfg, None)


def ace_fleet_score_planned(counts: torch.Tensor, q: torch.Tensor,
                            tenant_ids: torch.Tensor, w: torch.Tensor,
                            cfg: SrpConfig, plan: HashPlan | None, *,
                            with_ids: bool = False):
    """``ace_fleet_score`` with the hash under a given launch plan (None:
    ``srp_hash.device_plan``'s); ``with_ids`` also returns the (B, L)
    int32 bucket ids the kernel hashed (the plain hash's on the CPU)."""
    T, L, nbuckets = counts.shape
    B, d = q.shape
    K, P = cfg.num_bits, cfg.padded_projections
    build.check_bits(K)
    if L != cfg.num_tables or nbuckets != cfg.num_buckets:
        raise ValueError(f"counts {tuple(counts.shape)} do not match "
                         f"K={K}, L={cfg.num_tables}")
    if L > MAX_TABLES:
        raise ValueError(f"ace_fleet_score: L={L} tables; the kernel takes "
                         f"at most {MAX_TABLES}")
    build.check_counts(counts, "counts", (T, L, nbuckets))
    build.check_operand(q, "q", (B, d))
    build.check(tenant_ids, "tenant_ids", torch.int32, (B,))
    build.check_operand(w, "w", (d, P))
    if build.on_cpu(counts, q, tenant_ids, w):
        ids = srp_hash_plain(q, w, cfg)
        scores = fleet_score_from_ids(counts, ids, tenant_ids)
        return (scores, ids) if with_ids else scores
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
               tenant_ids.data_ptr(), gathered.data_ptr(),
               None if ids is None else ids.data_ptr(), scores.data_ptr(),
               B, d, P, K, L, T, *plan.args(), build.count_code(counts),
               build.operand_code(q), build.operand_code(w))
    return (scores, ids) if with_ids else scores
