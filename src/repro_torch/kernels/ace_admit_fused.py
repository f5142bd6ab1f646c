"""Fused guardrail admission kernel: hash -> PRE-insert score ->
threshold -> masked insert, counts updated in place.

Replaces the TPU kernel ``repro.kernels.ace_admit_fused.ace_admit_fused``
(Pallas, in ``src/repro/kernels/ace_admit_fused.py``).  CUDA source:
``csrc/ace_admit_fused.cu`` with the block hash ``csrc/srp_gemm.cuh``.

Bound on the H100: the hash's fp32 operations (2·B·d·K·L FLOP; at
B=256, d=4097, K·L=750: 1.57 GFLOP, 23 µs at 67 TFLOP/s).  The design is
two kernels on one stream: phase 1 is ``srp_hash``'s register-tiled,
cluster-split hash under the same launch plan (``srp_hash.hash_plan``),
whose epilogue gathers each bucket's PRE-insert counter; phase 2, a warp
a row, sums the row's gathers in table order in one lane, multiplies by
float32(1/L), compares with the threshold read through a device pointer
(no host sync), gates on the item mask, and inserts an admitted row with
one atomic a lane, its L tables side by side.  Stream order puts
every gather before any insert, which is the reference's contract that
all scores are taken against the pre-insert counts; a single launch with
many blocks could not promise it.  Counters are int32, int16, int8 or
float32 (``build.COUNT_DTYPES``): gathered as fp32, inserted in their own
dtype (a narrow counter wraps past its max, as the reference's does).
q and W of one 2-byte type hash on the tensor-core tile, any other pair as
``srp_hash`` runs it (``srp_hash.hash_tile``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.srp import SrpConfig
from repro_torch.kernels import build
from repro_torch.kernels.srp_hash import (OPERAND_ARGTYPES, PLAN_ARGTYPES,
                                          TILE_ARGTYPES, HashPlan,
                                          check_w_aligned, device_plan,
                                          lane_padded, srp_hash_plain,
                                          tile_code)

KERNEL = build.Kernel("ace_admit_fused", "repro_ace_admit_fused",
                      [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                      + [ctypes.c_longlong, ctypes.c_float] + PLAN_ARGTYPES
                      + [ctypes.c_int] + OPERAND_ARGTYPES + TILE_ARGTYPES)


def ace_admit_fused_plain(counts: torch.Tensor, q: torch.Tensor,
                          w: torch.Tensor, thresh: torch.Tensor,
                          cfg: SrpConfig,
                          item_mask: torch.Tensor | None = None):
    """The same function in plain PyTorch (``repro.kernels.ref.ace_admit_ref``
    plus the item mask), updating ``counts`` in place like the kernel."""
    L = counts.shape[0]
    buckets = srp_hash_plain(q, w, cfg)
    rows = torch.arange(L, device=counts.device)[None, :]
    gathered = counts[rows, buckets.long()].to(torch.float32)
    scores = torch.sum(gathered, dim=-1) * torch.tensor(1.0 / L,
                                                        dtype=torch.float32)
    admit = scores >= thresh
    if item_mask is not None:
        admit = admit & item_mask
    counts.index_put_((rows, buckets.long()),
                      admit.to(counts.dtype)[:, None].expand(buckets.shape),
                      accumulate=True)
    return counts, scores, admit, buckets


def ace_admit_fused(counts: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
                    thresh: torch.Tensor, cfg: SrpConfig,
                    item_mask: torch.Tensor | None = None):
    """One guardrail admission step.

    counts (L, 2^K) of any ``build.COUNT_DTYPES``, q (B, d) and w (d, P)
    each of any ``build.OPERAND_DTYPES`` (hashed on ``hash_tile``'s tile),
    thresh () fp32
    (score space; −inf admits everything), item_mask (B,) bool or None ->
        (counts          — the same tensor, + the masked batch histogram,
         scores (B,) fp32 — PRE-insert Ŝ(q, D),
         admit (B,) bool,
         buckets (B, L) int32 — the one hash, for the Welford epilogue).
    Rows where ``item_mask`` is False neither admit nor insert.
    """
    return ace_admit_fused_planned(counts, q, w, thresh, cfg, item_mask,
                                   None)


def ace_admit_fused_planned(counts: torch.Tensor, q: torch.Tensor,
                            w: torch.Tensor, thresh: torch.Tensor,
                            cfg: SrpConfig, item_mask: torch.Tensor | None,
                            plan: HashPlan | None, tile: str | None = None):
    """``ace_admit_fused`` with the hash under a given launch plan (None:
    ``srp_hash.device_plan``'s) and tile (None: ``hash_tile``'s; see
    ``srp_hash.tile_code``)."""
    L, nbuckets = counts.shape
    B, d = q.shape
    K, P = cfg.num_bits, cfg.padded_projections
    build.check_bits(K)
    if L != cfg.num_tables or nbuckets != cfg.num_buckets:
        raise ValueError(f"counts {tuple(counts.shape)} do not match "
                         f"K={K}, L={cfg.num_tables}")
    build.check_counts(counts, "counts", (L, nbuckets))
    build.check_operand(q, "q", (B, d))
    build.check_operand(w, "w", (d, P))
    build.check(thresh, "thresh", torch.float32, ())
    code = tile_code(tile, q.dtype, w.dtype)
    operands = [counts, q, w, thresh]
    if item_mask is not None:
        build.check(item_mask, "item_mask", torch.bool, (B,))
        operands.append(item_mask)
    if build.on_cpu(*operands):
        return ace_admit_fused_plain(counts, q, w, thresh, cfg, item_mask)
    dev = counts.device
    buckets = torch.empty((B, L), dtype=torch.int32, device=dev)
    gathered = torch.empty((B, L), dtype=torch.float32, device=dev)
    scores = torch.empty((B,), dtype=torch.float32, device=dev)
    admit = torch.empty((B,), dtype=torch.bool, device=dev)
    if B:
        w, P = lane_padded(w, cfg)
        check_w_aligned(w)
        plan = plan or device_plan(B, d, K, L, dev)
        KERNEL(dev, counts.data_ptr(), q.data_ptr(), w.data_ptr(),
               thresh.data_ptr(),
               None if item_mask is None else item_mask.data_ptr(),
               buckets.data_ptr(), gathered.data_ptr(), scores.data_ptr(),
               admit.data_ptr(), B, d, P, K, L, nbuckets, 1.0 / L,
               *plan.args(), build.count_code(counts),
               build.operand_code(q), build.operand_code(w), code)
    return counts, scores, admit, buckets
