"""Differentially-private ACE (paper §4) — port of ``repro.core.privacy``.

The paper's recipe (via Kenthapadi et al. 2012): add Gaussian noise to the
random projection *before* taking the sign.  sign(Wx + N(0, σ²I)) is a
post-processing of a (ε, δ)-DP release of Wx, so the whole ACE pipeline
(counts, scores, decisions) inherits the privacy guarantee.

σ is calibrated by the Gaussian mechanism for sensitivity
Δ₂ = max_rows ‖W_row‖₂ · ‖x − x'‖₂; with rows ~ N(0, I_d) and unit-norm
inputs the standard bound is σ ≥ Δ₂·sqrt(2 ln(1.25/δ))/ε.

The noise is a ``torch.randn`` draw from the caller's generator on the
projection's device, not the reference's ``jax.random`` draw; everything
after the draw is ``noisy_srp_bits``, which takes the standard-normal
draw ``z`` explicitly, so a test can hand it the reference's own ``z``.
The projection is ``torch.matmul`` in x's dtype (the reference computes
it outside any kernel); its sign bits match another implementation's only
without TF32 (``torch.backends.cuda.matmul.allow_tf32`` False, PyTorch's
default).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.srp import SrpConfig, pack_buckets


def gaussian_sigma(epsilon: float, delta: float,
                   l2_sensitivity: float) -> float:
    """Classic Gaussian-mechanism calibration (Dwork & Roth Thm A.1)."""
    if epsilon <= 0 or not (0 < delta < 1):
        raise ValueError("need epsilon > 0 and 0 < delta < 1")
    return l2_sensitivity * math.sqrt(2.0 * math.log(1.25 / delta)) / epsilon


def projections(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The pre-noise projection x·W over all P columns of W: (..., d) ->
    (..., P), in x's dtype."""
    return torch.matmul(x, w.to(x.dtype))


def noisy_srp_bits(x: torch.Tensor, w: torch.Tensor, cfg: SrpConfig,
                   z: torch.Tensor, sigma: float) -> torch.Tensor:
    """sign(xW + σ·z) for a given standard-normal draw ``z`` of the
    projection's shape (..., P): (..., K·L) int32 bits in {0, 1}."""
    proj = projections(x, w)
    bits = ((proj + sigma * z.to(proj.dtype)) >= 0).to(torch.int32)
    return bits[..., : cfg.num_projections]


def private_srp_bits(x: torch.Tensor, w: torch.Tensor, cfg: SrpConfig,
                     generator: torch.Generator,
                     sigma: float) -> torch.Tensor:
    """sign(Wx + N(0, σ²)) — the DP-SRP of §4, the noise drawn from
    ``generator`` (which must live on x's device)."""
    shape = (*x.shape[:-1], w.shape[-1])
    z = torch.randn(shape, generator=generator, device=x.device,
                    dtype=x.dtype)
    return noisy_srp_bits(x, w, cfg, z, sigma)


def private_hash_buckets(x: torch.Tensor, w: torch.Tensor, cfg: SrpConfig,
                         generator: torch.Generator,
                         sigma: float) -> torch.Tensor:
    """The DP meta-hash: (..., d) -> (..., L) bucket ids in [0, 2^K)."""
    return pack_buckets(private_srp_bits(x, w, cfg, generator, sigma), cfg)


def expected_bit_flip_rate(margin: torch.Tensor,
                           sigma: float) -> torch.Tensor:
    """Pr[sign flips] = Φ(−|margin|/σ): utility-loss diagnostic.

    ``margin`` is the pre-noise projection value w·x.
    """
    if sigma == 0.0:
        return torch.zeros_like(margin)
    z = torch.abs(margin) / sigma
    return 0.5 * torch.special.erfc(z / math.sqrt(2.0))
