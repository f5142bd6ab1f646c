"""Signed Random Projections (SRP) — the LSH family used by ACE.

Port of ``repro.core.srp``.  The paper (§2.1)
uses h_w(x) = sign(w^T x), w ~ N(0, I_d), with collision probability
Pr[h_w(x) = h_w(y)] = 1 − θ(x, y)/π.  ACE takes K·L such bits per input,
grouped into L meta-hashes of K bits, each packed into a bucket id in
[0, 2^K).

The projection matrix keeps the reference's padded width
P = round_up(K·L, 128) (K·L with ``pad_lanes=False``), so a JAX-drawn
``W`` of shape (d, P) carries across unchanged
(``repro_torch.core.convert``); the pad columns are never read.
``SrpConfig.hash_mode`` picks the hash family: ``"dense"`` (this module),
``"srht"`` (the Fast-JL transform of ``repro_torch.core.srht``) or
``"auto"`` (the cheaper of the two for the config,
``srht.choose_hash_mode``, whose weights are the port's own: for some
widths it picks another family than the reference's ``"auto"``, so
every entry point that takes a W checks it against the resolved family,
``check_projections``).  The CUDA kernels ``srp_hash`` and ``srht_hash``
implement ``hash_buckets``; this module is the plain path and the
parameter factory.
"""
from __future__ import annotations

import dataclasses
import math
import warnings

import torch

LANE = 128  # the reference pads K·L to this multiple; kept for W's shape


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


HASH_MODES = ("dense", "srht", "auto")

# The projection dtypes: the reference's, and the operand types of every
# hash kernel, in the order of their codes (csrc/common.cuh OperandCode).
# The kernels widen each element to float32 as they load it, but for x and
# W of one 2-byte type in srp_hash and ace_admit_fused, which run on the
# tensor cores (kernels/srp_hash.py hash_tile).
OPERAND_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


@dataclasses.dataclass(frozen=True)
class SrpConfig:
    """Static configuration of an SRP meta-hash bank (``repro``'s fields)."""

    dim: int
    num_bits: int = 15
    num_tables: int = 50
    seed: int = 0
    pad_lanes: bool = True     # False: W has exactly K·L columns
    hash_mode: str = "dense"

    @property
    def num_projections(self) -> int:
        return self.num_bits * self.num_tables

    @property
    def padded_projections(self) -> int:
        if not self.pad_lanes:
            return self.num_projections
        return _round_up(self.num_projections, LANE)

    @property
    def num_buckets(self) -> int:
        return 1 << self.num_bits


def resolve_hash_mode(cfg: SrpConfig) -> str:
    """``cfg.hash_mode`` as a concrete family ("auto" -> the break-even)."""
    if cfg.hash_mode not in HASH_MODES:
        raise ValueError(f"unknown hash_mode {cfg.hash_mode!r} "
                         f"(want one of {HASH_MODES})")
    if cfg.hash_mode == "auto":
        from repro_torch.core import srht   # srht imports this module
        return srht.choose_hash_mode(cfg)
    return cfg.hash_mode


def check_projections(w: torch.Tensor, cfg: SrpConfig) -> None:
    """Raise ``ValueError`` unless W has the shape the config's resolved
    hash family takes: (d, P) dense, the (d, 0) placeholder under SRHT.

    A W of the other family would otherwise be taken without a word (the
    SRHT never reads W) and the sketch would hash with another function
    than the one that built it.  Under ``"auto"`` this is how a reference
    W meets the port's break-even, which differs from the reference's
    for some widths (``srht.choose_hash_mode``).
    """
    family = resolve_hash_mode(cfg)
    want = (cfg.dim, 0 if family == "srht" else cfg.padded_projections)
    if tuple(w.shape) == want:
        return
    msg = (f"W of shape {tuple(w.shape)} does not fit the {family} hash "
           f"family this config resolves to, which takes W of shape {want}")
    if cfg.hash_mode == "auto":
        msg += ('; hash_mode="auto" resolves by repro_torch\'s own '
                "break-even, and the JAX package's may resolve the same "
                'config differently: pass hash_mode="dense" or "srht"')
    raise ValueError(msg)


def projection_dtype(dtype) -> torch.dtype:
    """The dtype W is drawn in for a requested ``dtype``: float32, bfloat16
    and float16 (the reference's, and every hash kernel's operand dtypes,
    ``OPERAND_DTYPES``) as they are; float64 as float32 with a
    ``UserWarning``, as the reference does without 64-bit JAX
    (``jax.random.normal`` truncates it); anything else raises
    ``TypeError``."""
    if dtype in OPERAND_DTYPES:
        return dtype
    if dtype == torch.float64:
        warnings.warn("make_projections: float64 projections are not "
                      "available and are drawn in float32, as the JAX "
                      "package does without jax_enable_x64", UserWarning,
                      stacklevel=3)
        return torch.float32
    raise TypeError(f"make_projections: dtype {dtype} is not a projection "
                    f"dtype (want one of "
                    f"{', '.join(map(str, OPERAND_DTYPES))})")


def make_projections(cfg: SrpConfig, generator: torch.Generator | None = None,
                     device=None, *, dtype=torch.float32) -> torch.Tensor:
    """Sample the (d, P) Gaussian projection matrix W.

    Column j*K + k is bit k of meta-hash j; columns from K·L on are pad.
    The draw comes from ``generator`` (default: a CPU generator seeded
    with ``cfg.seed``, so the same seed gives the same W on every device)
    and is then moved to ``device``.  It is NOT the reference's
    ``jax.random`` draw for the same seed: to run both packages on the
    same projections, carry the JAX ``W`` across with
    ``repro_torch.core.convert.params_from_numpy``.

    ``dtype`` is float32, bfloat16 or float16 (``projection_dtype``: float64
    gives float32 and a warning, as in the reference).  A narrow W is the
    float32 draw rounded to nearest in the narrow dtype, so one seed gives
    the same directions in every dtype; the hash kernels widen it back to
    float32 as they read it (``srp_hash`` and ``ace_admit_fused`` take it
    and an x of its dtype on the tensor cores).  Under the SRHT family W
    is never read: a (d, 0) placeholder in ``dtype`` keeps every
    ``(state, w, x)`` signature, as in the reference.
    """
    dtype = projection_dtype(dtype)
    if resolve_hash_mode(cfg) == "srht":
        return torch.zeros((cfg.dim, 0), dtype=dtype, device=device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    w = torch.randn((cfg.dim, cfg.padded_projections), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return w.to(device=device if device is not None else generator.device,
                dtype=dtype)


def srp_bits(x: torch.Tensor, w: torch.Tensor, cfg: SrpConfig) -> torch.Tensor:
    """Raw sign bits.  x: (..., d) -> (..., K*L) int32 in {0, 1}.

    sign(0) is +1 (bit 1), as in the reference; a NaN projection gives 0.
    """
    proj = torch.matmul(x, w.to(x.dtype))
    bits = (proj >= 0).to(torch.int32)
    return bits[..., : cfg.num_projections]


def pack_buckets(bits: torch.Tensor, cfg: SrpConfig) -> torch.Tensor:
    """Pack K-bit groups into bucket ids.  (..., K*L) -> (..., L) int32.

    Bit k of meta-hash j is column j*K + k; packing is big-endian on k
    (first bit = MSB) — the reference's persisted-sketch convention.
    """
    K, L = cfg.num_bits, cfg.num_tables
    grouped = bits.reshape(*bits.shape[:-1], L, K)
    weights = torch.bitwise_left_shift(
        torch.ones((), dtype=torch.int32, device=bits.device),
        torch.arange(K - 1, -1, -1, dtype=torch.int32, device=bits.device))
    return torch.sum(grouped * weights, dim=-1, dtype=torch.int32)


def hash_buckets(x: torch.Tensor, w: torch.Tensor,
                 cfg: SrpConfig) -> torch.Tensor:
    """Full SRP meta-hash: (..., d) -> (..., L) bucket ids in [0, 2^K).

    THE hash of every plain path: dispatches on ``cfg.hash_mode`` between
    the dense product and the SRHT (which ignores ``w``).
    """
    if resolve_hash_mode(cfg) == "srht":
        from repro_torch.core import srht   # srht imports this module
        return srht.srht_hash_buckets(x, srht.srht_params(cfg))
    return pack_buckets(srp_bits(x, w, cfg), cfg)


def projection_memory_bytes(cfg: SrpConfig, dtype_bytes: int = 4) -> int:
    """Memory to store the projections (paper §3.4: ~6d KB for K=15,L=50)."""
    return cfg.dim * cfg.padded_projections * dtype_bytes


def seeds_memory_bytes(cfg: SrpConfig) -> int:
    """The paper's alternative: K·L integer seeds, rows regenerated on the
    fly."""
    return cfg.num_projections * 4


def collision_probability(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """p(q, x) = 1 − θ/π for SRP (paper Eq. 1).  Broadcasts over leading dims."""
    qn = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
    xn = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
    cos = torch.clamp(torch.sum(qn * xn, dim=-1), -1.0, 1.0)
    return 1.0 - torch.arccos(cos) / math.pi
