"""SRHT meta-hash kernel: two sign-diagonal + Walsh–Hadamard rounds, a row
sample, sign and big-endian K-bit pack -> (B, L) int32 bucket ids.

Replaces the TPU kernel ``repro.kernels.srht_hash.srht_hash`` (Pallas, in
``src/repro/kernels/srht_hash.py``).  CUDA source: ``csrc/srht_hash.cu``.

Bound on the H100: the FWHT's adds — 2·d_pad·log2(d_pad) a row at 33.5 T
adds/s (at B=512, d=4097 → d_pad=8192: 109 M adds, 3.3 µs) — beside 8.4 MB
of x (2.5 µs); no projection matrix is read.  The design keeps each row
in the registers of a team of threads (``srht_plan``: 2^E elements a
thread, 32 at d_pad = 8192), runs the butterfly stages in passes of E
between a thread's own registers, and moves the row between passes
through one padded, conflict-free shared-memory exchange (three an FWHT
at d_pad = 8192, where a barrier-per-stage design made 13 round trips);
the sign diagonals arrive as bitmaps (``SrhtParams.sign_words``), the
final signs go to shared memory once, as bytes, and every thread packs.  The (B, d_pad)
transform never reaches device memory.  Its ids equal the plain
version's and the reference's bit for bit (the same adds in the same
order; see the source).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.srht import srht_hash_buckets, srht_params
from repro_torch.core.srp import SrpConfig
from repro_torch.kernels import build

MAX_D_PAD = 32768       # a team of 1024 threads, 32 elements each

KERNEL = build.Kernel("srht_hash", "repro_srht_hash",
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7)

BLOCK_THREADS = 128     # a block's threads when a row's team is smaller
MAX_SAMPLE = 1024       # row-sample indices the kernel keeps in smem


class SrhtPlan(NamedTuple):
    """How ``csrc/srht_hash.cu`` lays out rows of d_pad = 2^log2_pad (its
    ``Shape<N>``, which checks that the two agree at every launch)."""

    log2_pad: int
    elems_log: int      # E: a thread holds 2^E elements of a row
    team: int           # threads a row: 2^(log2_pad - E)
    threads: int        # threads a block
    rows: int           # rows a block (rows * team threads run the FWHT)
    passes: tuple       # lo of each pass: its registers hold bits [lo, lo+E)
    smem_bytes: int     # the block's dynamic shared memory


def srht_plan(d_pad: int) -> SrhtPlan:
    """The kernel's launch shape for rows padded to ``d_pad`` (a power of
    two in [2, ``MAX_D_PAD``]): a thread holds 2^E elements, E = N up to
    d_pad = 32 (one thread a row), ceil(N/2) up to 512 so that small rows
    still spread over threads, 5 from 1024 up; stages in passes of E;
    128 threads a block at least, and teams smaller than a warp fill one
    warp with rows (the other warps only pack); rows padded by one float
    every 32 in shared memory while they move, then one sign byte an
    element, and the row sample's indices."""
    n = d_pad.bit_length() - 1
    if d_pad != 1 << n or not 1 <= n <= MAX_D_PAD.bit_length() - 1:
        raise ValueError(f"srht_plan: d_pad={d_pad} is not a power of two "
                         f"in [2, {MAX_D_PAD}]")
    e = n if n <= 5 else ((n + 1) // 2 if n < 10 else 5)
    team = 1 << (n - e)
    threads = max(team, BLOCK_THREADS)
    rows = 32 // team if team < 32 else threads // team
    npass = -(-n // e)
    passes = tuple(min(p * e, n - e) for p in range(npass))
    stride = d_pad + d_pad // 32 if npass > 1 else 0
    return SrhtPlan(n, e, team, threads, rows, passes,
                    rows * (4 * stride + d_pad) + 4 * MAX_SAMPLE)


class SrhtWidthError(ValueError):
    """The input pads wider than the kernel's widest row
    (d_pad > ``MAX_D_PAD``: one block's 1024 threads)."""


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
            "than the kernel's widest row")
    if build.on_cpu(x):
        return srht_hash_plain(x, cfg)
    _, _, rows = params.tensors(x.device)
    words = params.words(x.device)
    out = torch.empty((B, L), dtype=torch.int32, device=x.device)
    if B:
        plan = srht_plan(params.d_pad)
        KERNEL(x.device, x.data_ptr(), words.data_ptr(), rows.data_ptr(),
               out.data_ptr(), B, d, plan.log2_pad, K, L, plan.elems_log,
               plan.rows)
    return out
