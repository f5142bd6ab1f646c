"""Fused multi-tenant ACE scoring kernel: dense SRP hash -> gather at row
tenant_ids[b]·L + j of the (T·L, 2^K) fleet -> sum over the L tables ->
× float32(1/L).  (B, d) queries + (B,) tenant ids -> (B,) float32 scores,
each item against its own tenant's tables.

Replaces the TPU kernel ``repro.kernels.ace_fleet_score.ace_fleet_score``
(Pallas, in ``src/repro/kernels/ace_fleet_score.py``).  CUDA source:
``csrc/ace_fleet_score.cu`` with the shared block hash
``csrc/srp_tile.cuh``.

Bound on the H100: the hash's fp32 operations, 2·B·d·K·L FLOP at 67
TFLOP/s, as for ``ace_score_fused``, whose design this is with a tenant
row offset: phase 1 hashes (rows × table group) blocks and gathers each
table's counter at (tid·L + j)·2^K + b_j, phase 2 sums each row's gathers
in table order.  ``ace_fleet_score_plain`` sums in the same order, so the
scores are bitwise wherever the ids agree.  A row whose tenant id lies
outside [0, T) scores 0 on the card (nothing outside the fleet is read);
the entry points reject such ids on the host.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import sketch as sk
from repro_torch.core.srp import SrpConfig
from repro_torch.kernels import build
from repro_torch.kernels.ace_score_fused import table_order_sum
from repro_torch.kernels.ace_update import gather_rows
from repro_torch.kernels.srp_hash import lane_padded, srp_hash_plain

KERNEL = build.Kernel("ace_fleet_score", "repro_ace_fleet_score",
                      [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                      + [ctypes.c_float])


def ace_fleet_score_plain(counts: torch.Tensor, q: torch.Tensor,
                          tenant_ids: torch.Tensor, w: torch.Tensor,
                          cfg: SrpConfig) -> torch.Tensor:
    """The same function in plain PyTorch, summing in table order as the
    kernel does (``repro.kernels.ref`` sums in XLA's order)."""
    return fleet_score_from_ids(counts, srp_hash_plain(q, w, cfg),
                                tenant_ids)


def fleet_score_from_ids(counts: torch.Tensor, buckets: torch.Tensor,
                         tenant_ids: torch.Tensor) -> torch.Tensor:
    """The kernel's scores downstream of given (B, L) bucket ids: the
    gather at rows tid·L + j, summed in table order, × float32(1/L)."""
    T, L, nbuckets = counts.shape
    g = gather_rows(counts.reshape(T * L, nbuckets), buckets,
                    tenant_ids.long() * L).to(torch.float32)
    return table_order_sum(g) * sk.reciprocal(L)


def ace_fleet_score(counts: torch.Tensor, q: torch.Tensor,
                    tenant_ids: torch.Tensor, w: torch.Tensor,
                    cfg: SrpConfig) -> torch.Tensor:
    """counts (T, L, 2^K) int32, q (B, d) fp32, tenant_ids (B,) int32 in
    [0, T), w (d, P) fp32 -> scores (B,) fp32."""
    T, L, nbuckets = counts.shape
    B, d = q.shape
    K, P = cfg.num_bits, cfg.padded_projections
    build.check_bits(K)
    if L != cfg.num_tables or nbuckets != cfg.num_buckets:
        raise ValueError(f"counts {tuple(counts.shape)} do not match "
                         f"K={K}, L={cfg.num_tables}")
    build.check(counts, "counts", torch.int32, (T, L, nbuckets))
    build.check(q, "q", torch.float32, (B, d))
    build.check(tenant_ids, "tenant_ids", torch.int32, (B,))
    build.check(w, "w", torch.float32, (d, P))
    if build.on_cpu(counts, q, tenant_ids, w):
        return ace_fleet_score_plain(counts, q, tenant_ids, w, cfg)
    dev = counts.device
    scores = torch.empty((B,), dtype=torch.float32, device=dev)
    if B:
        w, P = lane_padded(w, cfg)
        gathered = torch.empty((B, L), dtype=torch.float32, device=dev)
        KERNEL(dev, counts.data_ptr(), q.data_ptr(), w.data_ptr(),
               tenant_ids.data_ptr(), gathered.data_ptr(), scores.data_ptr(),
               B, d, P, K, L, T, 1.0 / L)
    return scores
