"""Fused windowed-fleet admission kernel: hash -> tail and live-epoch
gathers -> PRE-insert score (tail + live)·(1/L) -> per-tenant threshold ->
masked insert into each admitted item's tenant's live epoch, the ring
updated in place.

Replaces the TPU kernel ``repro.kernels.ace_fleet_window_admit
.ace_fleet_window_admit_fused`` (→ ``_admit_fused_impl``; Pallas, in
``src/repro/kernels/ace_fleet_window_admit.py``).  CUDA source:
``csrc/ace_fleet_window_admit.cu`` with the block hash
``csrc/srp_gemm.cuh``.

Bound on the H100: the hash's fp32 operations (2·B·d·K·L FLOP; at B=256,
d=4097, K·L=750: 1.57 GFLOP, 23 µs at 67 TFLOP/s).  The design is
``ace_admit_fused``'s, two kernels on one stream: phase 1 is
``srp_hash``'s register-tiled, cluster-split hash under the same launch
plan (``srp_hash.hash_plan``), so its ids are ``srp_hash``'s bits, and its
epilogue gathers every item's tail value at row tid·L + j and live
counter at row (tid·E + cursor[tid])·L + j; phase 2, a warp a row, sums
both in table order in one lane, scores, compares with
``thresholds[tid]`` read on the device, gates on the item mask and
inserts an admitted row into its live epoch with one atomic a lane.  ``ops.ace_fleet_window_admit`` then sums the
post-insert live counters with one ``ace_query_sum`` launch.
Stream order puts every gather before any insert, so every score is
pre-insert, copies of one row to one tenant included.  The cursor is read
inside the kernel: no host sync.  ``ace_fleet_window_admit_fused_plain``
sums in the same order, so everything downstream of one set of ids is
bitwise.  Rings are int32, int16, int8 or float32
(``build.COUNT_DTYPES``): live counters gathered as fp32, inserts in the
ring's own dtype (a narrow counter wraps past its max, as the
reference's does); the tails are fp32 whatever the ring.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import sketch as sk
from repro_torch.core.srp import SrpConfig
from repro_torch.kernels import build
from repro_torch.kernels.ace_score_fused import table_order_sum
from repro_torch.kernels.ace_update import ace_update_plain, gather_rows
from repro_torch.kernels.srp_hash import (OPERAND_ARGTYPES, PLAN_ARGTYPES,
                                          HashPlan, check_w_aligned,
                                          device_plan, lane_padded,
                                          srp_hash_plain)

KERNEL = build.Kernel("ace_fleet_window_admit", "repro_ace_fleet_window_admit",
                      [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7
                      + [ctypes.c_float] + PLAN_ARGTYPES + [ctypes.c_int]
                      + OPERAND_ARGTYPES)


def ace_fleet_window_admit_fused_plain(ring_counts: torch.Tensor,
                                       tail: torch.Tensor,
                                       cursor: torch.Tensor, q: torch.Tensor,
                                       tenant_ids: torch.Tensor,
                                       w: torch.Tensor,
                                       thresholds: torch.Tensor,
                                       cfg: SrpConfig,
                                       item_mask: torch.Tensor | None = None):
    """The same function in plain PyTorch (``repro.kernels.ref``'s
    fleet-window admission oracle, summing in table order as the kernel
    does), updating ``ring_counts`` in place like the kernel."""
    buckets = srp_hash_plain(q, w, cfg)
    scores, admit, tail_sums, live_pre = fleet_window_admit_from_ids(
        ring_counts, tail, cursor, buckets, tenant_ids, thresholds,
        item_mask)
    return ring_counts, scores, admit, buckets, tail_sums, live_pre


def fleet_window_admit_from_ids(ring_counts: torch.Tensor,
                                tail: torch.Tensor, cursor: torch.Tensor,
                                buckets: torch.Tensor,
                                tenant_ids: torch.Tensor,
                                thresholds: torch.Tensor,
                                item_mask: torch.Tensor | None = None):
    """The kernel's admission downstream of given (B, L) bucket ids: tail
    gathers at rows tid·L + j and live gathers at tid·E·L + cursor[tid]·L
    + j, each summed in table order, the score (tail + live)·float32(1/L)
    against ``thresholds[tid]``, the masked insert into ``ring_counts`` in
    place.  Returns (scores, admit, tail_sums, live_pre)."""
    T, E, L, nbuckets = ring_counts.shape
    tids = tenant_ids.long()
    flat = ring_counts.view(T * E * L, nbuckets)
    live_base = (tids * E + cursor.long()[tids]) * L
    tail_sums = table_order_sum(gather_rows(tail.reshape(T * L, nbuckets),
                                            buckets, tids * L))
    live_pre = table_order_sum(gather_rows(flat, buckets, live_base)
                               .to(torch.float32))
    scores = (tail_sums + live_pre) * sk.reciprocal(L)
    admit = scores >= thresholds[tids]
    if item_mask is not None:
        admit = admit & item_mask
    ace_update_plain(flat, buckets, admit, live_base)
    return scores, admit, tail_sums, live_pre


def ace_fleet_window_admit_fused(ring_counts: torch.Tensor,
                                 tail: torch.Tensor, cursor: torch.Tensor,
                                 q: torch.Tensor, tenant_ids: torch.Tensor,
                                 w: torch.Tensor, thresholds: torch.Tensor,
                                 cfg: SrpConfig,
                                 item_mask: torch.Tensor | None = None):
    """One windowed-fleet admission step (the counts half).

    ring_counts (T, E, L, 2^K) of any ``build.COUNT_DTYPES``, tail (T, L, 2^K) fp32, cursor (T,)
    int32, q (B, d), tenant_ids (B,) int32 in [0, T), w (d, P) (q and w
    each of any ``build.OPERAND_DTYPES``),
    thresholds (T,) fp32 (score space, −inf admits all), item_mask (B,)
    bool or None ->
        (ring_counts — the same tensor, + the masked live-epoch inserts,
         scores (B,) fp32 — PRE-insert windowed scores,
         admit (B,) bool,
         buckets (B, L) int32 — the one hash,
         tail_sums (B,) fp32, live_pre (B,) fp32 — the scoring sums, for
         the stats epilogue ``fleet.window.apply_insert_stats``).
    Rows where ``item_mask`` is False neither admit nor insert."""
    return ace_fleet_window_admit_fused_planned(
        ring_counts, tail, cursor, q, tenant_ids, w, thresholds, cfg,
        item_mask, None)


def ace_fleet_window_admit_fused_planned(ring_counts: torch.Tensor,
                                         tail: torch.Tensor,
                                         cursor: torch.Tensor,
                                         q: torch.Tensor,
                                         tenant_ids: torch.Tensor,
                                         w: torch.Tensor,
                                         thresholds: torch.Tensor,
                                         cfg: SrpConfig,
                                         item_mask: torch.Tensor | None,
                                         plan: HashPlan | None):
    """``ace_fleet_window_admit_fused`` with the hash under a given launch
    plan (None: ``srp_hash.device_plan``'s)."""
    T, E, L, nbuckets = ring_counts.shape
    B, d = q.shape
    K, P = cfg.num_bits, cfg.padded_projections
    build.check_bits(K)
    if L != cfg.num_tables or nbuckets != cfg.num_buckets:
        raise ValueError(f"ring {tuple(ring_counts.shape)} does not match "
                         f"K={K}, L={cfg.num_tables}")
    build.check_counts(ring_counts, "ring_counts", (T, E, L, nbuckets))
    build.check(tail, "tail", torch.float32, (T, L, nbuckets))
    build.check(cursor, "cursor", torch.int32, (T,))
    build.check_operand(q, "q", (B, d))
    build.check(tenant_ids, "tenant_ids", torch.int32, (B,))
    build.check_operand(w, "w", (d, P))
    build.check(thresholds, "thresholds", torch.float32, (T,))
    operands = [ring_counts, tail, cursor, q, tenant_ids, w, thresholds]
    if item_mask is not None:
        build.check(item_mask, "item_mask", torch.bool, (B,))
        operands.append(item_mask)
    if build.on_cpu(*operands):
        return ace_fleet_window_admit_fused_plain(
            ring_counts, tail, cursor, q, tenant_ids, w, thresholds, cfg,
            item_mask)
    dev = ring_counts.device
    buckets = torch.empty((B, L), dtype=torch.int32, device=dev)
    tail_g = torch.empty((B, L), dtype=torch.float32, device=dev)
    live_g = torch.empty((B, L), dtype=torch.float32, device=dev)
    scores, tail_sums, live_pre = (
        torch.empty((B,), dtype=torch.float32, device=dev) for _ in range(3))
    admit = torch.empty((B,), dtype=torch.bool, device=dev)
    if B:
        w, P = lane_padded(w, cfg)
        check_w_aligned(w)
        plan = plan or device_plan(B, d, K, L, dev)
        KERNEL(dev, ring_counts.data_ptr(), tail.data_ptr(),
               cursor.data_ptr(), q.data_ptr(), w.data_ptr(),
               tenant_ids.data_ptr(), thresholds.data_ptr(),
               None if item_mask is None else item_mask.data_ptr(),
               buckets.data_ptr(), tail_g.data_ptr(), live_g.data_ptr(),
               scores.data_ptr(), admit.data_ptr(), tail_sums.data_ptr(),
               live_pre.data_ptr(), B, d, P, K, L, E, T, 1.0 / L,
               *plan.args(), build.count_code(ring_counts),
               build.operand_code(q), build.operand_code(w))
    return ring_counts, scores, admit, buckets, tail_sums, live_pre
