"""Fused ACE scoring kernel: dense SRP hash -> one row-offset gather ->
sum over the L tables -> × float32(1/L), or Σ_j tw_j·g_j with
``table_weights``.  (B, d) queries -> (B,) float32 scores.

Replaces the TPU kernel ``repro.kernels.ace_score_fused.ace_score_fused``
(Pallas, in ``src/repro/kernels/ace_score_fused.py``).  CUDA source:
``csrc/ace_score_fused.cu`` with the shared block hash
``csrc/srp_tile.cuh``.

Bound on the H100: the hash's fp32 operations, 2·B·d·K·L FLOP at 67
TFLOP/s (at the estimator's B=16,384, d=36, K·L=750: 0.88 GFLOP, 13 µs);
q, W, the counters touched and the scores are a few MB.  The design is
two kernels on one stream: phase 1 hashes (rows × table group) blocks and
gathers each table's counter at j·2^K + b_j, phase 2 sums each row's
gathers in table order.  The bucket ids never reach device memory; the
(B, L) gathers do, as scratch, because a block holds only a group of
tables.

Both forms are summed in table order j = 0..L−1 by the kernel and by
``ace_score_fused_plain``, so wherever the ids agree the scores are
bitwise equal, the weighted ones too (the kernel multiplies and adds
with ``__fmul_rn``/``__fadd_rn``: no FMA).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.srp import SrpConfig
from repro_torch.kernels import build
from repro_torch.kernels.srp_hash import lane_padded, srp_hash_plain

KERNEL = build.Kernel("ace_score_fused", "repro_ace_score_fused",
                      [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                      + [ctypes.c_float])


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
    of the port that sums a row of gathers does (``__fadd_rn``/
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
    """The same function in plain PyTorch, summing in table order
    j = 0..L−1 as the kernel does (``repro.kernels.ref.ace_score_ref``
    sums in XLA's order instead)."""
    L = counts.shape[0]
    s = table_order_sum(flat_table_gather(counts, srp_hash_plain(q, w, cfg)),
                        table_weights)
    if table_weights is None:
        s = s * torch.tensor(1.0 / L, dtype=torch.float32)
    return s


def ace_score_fused(counts: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
                    cfg: SrpConfig,
                    table_weights: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """counts (L, 2^K) int32, q (B, d) fp32, w (d, P) fp32 -> scores (B,)
    fp32.  ``table_weights`` (L,) fp32, when given, replaces the 1/L mean
    with Σ_j tw_j·g_j (the degraded path: the caller bakes the health
    mask and its 1/num_healthy into tw)."""
    L, nbuckets = counts.shape
    B, d = q.shape
    K, P = cfg.num_bits, cfg.padded_projections
    build.check_bits(K)
    if L != cfg.num_tables or nbuckets != cfg.num_buckets:
        raise ValueError(f"counts {tuple(counts.shape)} do not match "
                         f"K={K}, L={cfg.num_tables}")
    build.check(counts, "counts", torch.int32, (L, nbuckets))
    build.check(q, "q", torch.float32, (B, d))
    build.check(w, "w", torch.float32, (d, P))
    operands = [counts, q, w]
    if table_weights is not None:
        build.check(table_weights, "table_weights", torch.float32, (L,))
        operands.append(table_weights)
    if build.on_cpu(*operands):
        return ace_score_fused_plain(counts, q, w, cfg, table_weights)
    dev = counts.device
    scores = torch.empty((B,), dtype=torch.float32, device=dev)
    if B:
        w, P = lane_padded(w, cfg)
        gathered = torch.empty((B, L), dtype=torch.float32, device=dev)
        KERNEL(dev, counts.data_ptr(), q.data_ptr(), w.data_ptr(),
               None if table_weights is None else table_weights.data_ptr(),
               gathered.data_ptr(), scores.data_ptr(), B, d, P, K, L,
               1.0 / L)
    return scores
