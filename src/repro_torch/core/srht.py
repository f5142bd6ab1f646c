"""Fast SRP via the Subsampled Randomized Hadamard Transform (SRHT).

Port of ``repro.core.srht``.  Paper §2.2 cites the Fast-JL transform for
computing m random-projection hashes in O(d log d + m) instead of O(d·m):

    P x = R · H · D2 · H · D1 · x

with D1, D2 random ±1 diagonals, H the Walsh–Hadamard transform and R a
random row sample; the sign of each sampled row is one hash bit.  The
sign diagonals and the row sample come from numpy exactly as in the
reference, so both packages hash with the same function bit for bit, and
the butterflies run in the reference's stage order, so the sums agree bit
for bit too.  The CUDA kernel ``repro_torch.kernels.srht_hash``
implements ``srht_hash_buckets``; this module is the plain path, the
parameter cache and the ``hash_mode="auto"`` rule.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.srp import SrpConfig, pack_buckets


def next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Walsh–Hadamard transform along the last axis (length 2^k).

    Stages h = 1, 2, 4, …; stage h writes element i·2h + p ← a + b and
    i·2h + h + p ← a − b for a = x[i·2h + p], b = x[i·2h + h + p] — the
    reference's order, so every add and subtract meets the same operands.
    """
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"FWHT length must be a power of two, got {n}")
    shape = x.shape
    h = 1
    while h < n:
        y = x.reshape(*shape[:-1], n // (2 * h), 2, h)
        a, b = y[..., 0, :], y[..., 1, :]
        x = torch.cat([a + b, a - b], dim=-1).reshape(shape)
        h *= 2
    return x


class SrhtParams:
    """The SRHT's sign diagonals and row sample, from ``cfg.seed``.

    Host numpy arrays drawn exactly as the reference draws them
    (``repro.core.srht.SrhtParams``); ``tensors(device)`` hands out
    float32/int32 copies on a device, made once per device.
    """

    def __init__(self, cfg: SrpConfig):
        self.cfg = cfg
        d_pad = next_pow2(max(cfg.dim, 2))
        rng = np.random.default_rng(cfg.seed + 0x5A5A)
        self.d_pad = d_pad
        self.signs1 = rng.choice([-1.0, 1.0], size=(d_pad,)).astype(np.float32)
        self.signs2 = rng.choice([-1.0, 1.0], size=(d_pad,)).astype(np.float32)
        m = cfg.num_projections
        # rows with replacement: there may be more projections than d_pad
        self.rows = rng.integers(0, d_pad, size=(m,)).astype(np.int32)
        self._on: dict[torch.device, tuple] = {}

    def tensors(self, device) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
        """(signs1, signs2, rows) on ``device``.  The first call for a
        device copies them there (a host-to-device transfer); later calls
        return the same tensors."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self._on:
            self._on[device] = tuple(
                torch.as_tensor(a, device=device)
                for a in (self.signs1, self.signs2, self.rows))
        return self._on[device]


@functools.lru_cache(maxsize=64)
def srht_params(cfg: SrpConfig) -> SrhtParams:
    """SRHT parameters per (frozen, hashable) config, built once."""
    return SrhtParams(cfg)


def srht_bits(x: torch.Tensor, params: SrhtParams) -> torch.Tensor:
    """(..., d) -> (..., K*L) sign bits via two H·D rounds + row sampling.

    sign(0) is bit 1 (so the −0.0 of a padded lane is bit 1, as +0.0
    is); a NaN is bit 0.
    """
    cfg = params.cfg
    s1, s2, rows = params.tensors(x.device)
    xp = torch.nn.functional.pad(x.to(torch.float32),
                                 (0, params.d_pad - cfg.dim))
    y = fwht(xp * s1)
    y = fwht(y * s2)
    proj = torch.index_select(y, -1, rows)
    return (proj >= 0).to(torch.int32)


def srht_hash_buckets(x: torch.Tensor, params: SrhtParams) -> torch.Tensor:
    """(..., d) -> (..., L) bucket ids, SRHT hash family."""
    return pack_buckets(srht_bits(x, params), params.cfg)


def flops_dense(cfg: SrpConfig, batch: int) -> int:
    """FLOPs of the dense SRP product: 2·B·d·P (P the padded width)."""
    return 2 * batch * cfg.dim * cfg.padded_projections


def flops_srht(cfg: SrpConfig, batch: int) -> int:
    """Operations of the SRHT: two FWHTs, two sign flips, the row gather."""
    d_pad = next_pow2(max(cfg.dim, 2))
    log2d = d_pad.bit_length() - 1
    return batch * (2 * d_pad * log2d + 2 * d_pad + cfg.num_projections)


# ---------------------------------------------------------------------------
# Dense-vs-SRHT break-even for hash_mode="auto".
#
# Raw operation counts are the wrong units to compare: the dense hash is
# fused multiply-adds in a register-tiled product, the SRHT is log2(d)
# shared-memory butterfly passes plus an m-element row gather.  The two
# weights fold that in.  They are fitted on the card: both hash kernels
# timed on an NVIDIA H100 80GB HBM3 (700 W) at the corners of
# benchmarks/stream_throughput.py (K = 15, L = 50, B = 256) gave dense
# 7.3 µs vs SRHT 6.0 µs at d = 64 and dense 60 µs vs SRHT 16 µs at
# d = 4096 (the dense hash of csrc/srp_gemm.cuh; PERF.md), and these
# weights make the rule's cost ratios match those two time ratios (1.22
# and 3.77): it picks SRHT at both corners and dense below d = 53 at that
# K, L (chip_smoke.py phase 8 re-times the corners and checks the picks).
# The reference's weights (32, 16) would pick dense at d = 64, at 1.22x
# the SRHT's time there, and at every width up to d = 463.
# ---------------------------------------------------------------------------

DENSE_MATMUL_SPEEDUP = 15.0   # dense FLOPs per SRHT add of equal cost
GATHER_COST_FACTOR = 6.0      # cost of one gathered row vs one add


def effective_cost_dense(cfg: SrpConfig) -> float:
    """Throughput-weighted per-item cost of the dense hash."""
    return flops_dense(cfg, 1) / DENSE_MATMUL_SPEEDUP


def effective_cost_srht(cfg: SrpConfig) -> float:
    """Throughput-weighted per-item cost of the SRHT hash."""
    d_pad = next_pow2(max(cfg.dim, 2))
    log2d = d_pad.bit_length() - 1
    return (2 * d_pad * log2d + 2 * d_pad
            + GATHER_COST_FACTOR * cfg.num_projections)


def choose_hash_mode(cfg: SrpConfig) -> str:
    """The ``hash_mode="auto"`` rule: the cheaper effective cost wins.
    Both paths are linear in the batch, so the choice depends on the
    static config alone."""
    if effective_cost_srht(cfg) < effective_cost_dense(cfg):
        return "srht"
    return "dense"
