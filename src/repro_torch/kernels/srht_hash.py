"""SRHT meta-hash kernel: two sign-diagonal + Walsh–Hadamard rounds, a row
sample, sign and big-endian K-bit pack -> (B, L) int32 bucket ids.

Replaces the TPU kernel ``repro.kernels.srht_hash.srht_hash`` (Pallas, in
``src/repro/kernels/srht_hash.py``).  CUDA source: ``csrc/srht_hash.cu``.

Bound on the H100: the FWHT's adds — 2·d_pad·log2(d_pad) a row at 33.5 T
adds/s (at B=512, d=4097 → d_pad=8192: 109 M adds, 3.3 µs) — beside 8.4 MB
of x (2.5 µs); no projection matrix is read.  The design keeps whole rows
in shared memory (one row a block from d_pad = 1024 up, dynamic shared
memory above 48 KB), runs the butterfly stages there with a barrier
between stages, and packs the sampled signs with integer shifts; the
(B, d_pad) transform never reaches device memory.  Its ids equal the
plain version's and the reference's bit for bit (the same adds in the
same order; see the source).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.srht import srht_hash_buckets, srht_params
from repro_torch.core.srp import SrpConfig
from repro_torch.kernels import build

MAX_D_PAD = 32768       # 128 KB of shared memory for one row

KERNEL = build.Kernel("srht_hash", "repro_srht_hash",
                      [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5)


class SrhtWidthError(ValueError):
    """The input is wider than one row of the kernel's shared memory
    (d_pad > ``MAX_D_PAD``)."""


def srht_hash_plain(x: torch.Tensor, cfg: SrpConfig) -> torch.Tensor:
    """The same function in plain PyTorch
    (``repro.core.srht.srht_hash_buckets``)."""
    return srht_hash_buckets(x, srht_params(cfg))


def srht_hash(x: torch.Tensor, cfg: SrpConfig) -> torch.Tensor:
    """(B, d) fp32 -> (B, L) int32 bucket ids in [0, 2^K); the sign
    diagonals and row sample come from ``cfg.seed``.  Raises
    ``SrhtWidthError`` when d pads past ``MAX_D_PAD``."""
    B, d = x.shape
    K, L = cfg.num_bits, cfg.num_tables
    build.check_bits(K)
    build.check(x, "x", torch.float32, (B, cfg.dim))
    params = srht_params(cfg)
    if params.d_pad > MAX_D_PAD:
        raise SrhtWidthError(
            f"srht_hash: d={d} pads to {params.d_pad} > {MAX_D_PAD}, more "
            "than one row of shared memory holds")
    if build.on_cpu(x):
        return srht_hash_plain(x, cfg)
    s1, s2, rows = params.tensors(x.device)
    out = torch.empty((B, L), dtype=torch.int32, device=x.device)
    if B:
        KERNEL(x.device, x.data_ptr(), s1.data_ptr(), s2.data_ptr(),
               rows.data_ptr(), out.data_ptr(), B, d,
               params.d_pad.bit_length() - 1, K, L)
    return out
