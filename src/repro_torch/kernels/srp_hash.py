"""SRP meta-hash kernel: (B, d) @ (d, P) -> sign -> big-endian K-bit pack
-> (B, L) int32 bucket ids.

Replaces the TPU kernel ``repro.kernels.srp_hash.srp_hash`` (Pallas, in
``src/repro/kernels/srp_hash.py``).  CUDA source: ``csrc/srp_hash.cu``
with the shared block hash ``csrc/srp_tile.cuh``.

Bound on the H100: fp32 operations, 2·B·d·K·L FLOP against 67 TFLOP/s
(at the KDD-Cup99 shape B=4096, d=36, K·L=750: 0.22 GFLOP, 3.3 µs); the
bytes of x, W and the ids are small beside them.  The design is an fp32
FMA product over blocks of (16 rows × a group of whole tables), whose 512
threads (one per column, in four k-groups) split the depth loop, prefetch
the next slice of x and W while computing the current one, and add their
partial sums in a fixed order; sign and pack are fused into the
epilogue, so the (B, K·L) projection never reaches device memory.  No
TF32: it flips sign bits.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.srp import SrpConfig, pack_buckets, srp_bits
from repro_torch.kernels import build

KERNEL = build.Kernel("srp_hash", "repro_srp_hash",
                      [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5)


def srp_hash_plain(x: torch.Tensor, w: torch.Tensor,
                   cfg: SrpConfig) -> torch.Tensor:
    """The same function in plain PyTorch (``repro.kernels.ref.srp_hash_ref``).
    On a CUDA tensor it is only exact with TF32 matmuls off
    (``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default)."""
    return pack_buckets(srp_bits(x, w, cfg), cfg)


def srp_hash(x: torch.Tensor, w: torch.Tensor, cfg: SrpConfig) -> torch.Tensor:
    """(B, d) fp32 @ (d, P) fp32 -> (B, L) int32 bucket ids in [0, 2^K)."""
    B, d = x.shape
    K, L, P = cfg.num_bits, cfg.num_tables, cfg.padded_projections
    build.check_bits(K)
    build.check(x, "x", torch.float32, (B, d))
    build.check(w, "w", torch.float32, (d, P))
    if build.on_cpu(x, w):
        return srp_hash_plain(x, w, cfg)
    out = torch.empty((B, L), dtype=torch.int32, device=x.device)
    if B:
        KERNEL(x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(),
               B, d, P, K, L)
    return out
