"""Estimators of S(q, D) = Σ_i p(q, x_i)^K and their theoretical variances
(port of ``repro.core.estimators``, paper §3.3):

* ``exact_score``   — the O(n·d) oracle;
* ``AceEstimator``  — Algorithm 1 over ``repro_torch.core.sketch``;
* ``rse_score``     — the random-sampling estimator RSE (Eq. 10, Theorem 2);

plus the closed-form variances of Theorems 1 and 2.
"""
from __future__ import annotations

import math

import torch

from repro_torch import resolve_device
from repro_torch.core import sketch as sk
from repro_torch.core.srp import check_projections
from repro_torch.kernels import ops as kops


def collision_probs(q: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """p_i = p(q, x_i).  q: (d,) or (B, d); data: (n, d) -> (n,) or (B, n)."""
    qn = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
    dn = data / (torch.linalg.vector_norm(data, dim=-1, keepdim=True) + 1e-12)
    cos = torch.clamp(qn @ dn.T, -1.0, 1.0)
    return 1.0 - torch.arccos(cos) / math.pi


def exact_score(q: torch.Tensor, data: torch.Tensor, K: int) -> torch.Tensor:
    """S(q, D) = Σ_i p_i^K — the exact (expensive) statistic, paper Eq. 3."""
    return torch.sum(collision_probs(q, data) ** K, dim=-1)


def rse_score(q: torch.Tensor, data: torch.Tensor, K: int, num_samples: int,
              generator: torch.Generator) -> torch.Tensor:
    """Random-sampling estimator (paper Eq. 10): (n/L)·Σ_{x∈S} p(q,x)^K,
    sampling WITHOUT replacement (Theorem 2) from ``generator``.  The draw
    is not the reference's ``jax.random`` permutation; at
    ``num_samples == n`` the two agree up to summation order."""
    n = data.shape[0]
    idx = torch.randperm(n, generator=generator,
                         device=generator.device)[:num_samples]
    p = collision_probs(q, data[idx.to(data.device)]) ** K
    return (n / num_samples) * torch.sum(p, dim=-1)


def ace_variance_leading(p: torch.Tensor, K: int, L: int) -> torch.Tensor:
    """Leading (diagonal) term of Theorem 1: (1/L)·Σ p^K (1 − p^K)."""
    pk = p**K
    return torch.sum(pk * (1.0 - pk), dim=-1) / L


def rse_variance(p: torch.Tensor, K: int, L: int, n: int) -> torch.Tensor:
    """Theorem 2: Var(RSE) = (n/L − 1)·Σ p^{2K}."""
    pk = p**K
    return (n / L - 1.0) * torch.sum(pk * pk, dim=-1)


class AceEstimator:
    """Stateful wrapper over the sketch: fit / update / score / predict.

    ``use_kernels=True`` (the default here; the reference defaults to
    False) runs insert and score through the CUDA kernels
    (``repro_torch.kernels.ops``); False runs the plain sketch functions.
    ``device`` defaults to CUDA and raises when there is none.  ``w``
    carries a given projection matrix (for example the JAX package's,
    through ``repro_torch.core.convert``) instead of drawing one.
    """

    def __init__(self, cfg: sk.AceConfig, use_kernels: bool = True,
                 device=None, w: torch.Tensor | None = None,
                 generator: torch.Generator | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if w is not None:
            check_projections(w, cfg.srp)
        self.w = (sk.make_params(cfg, generator, self.device) if w is None
                  else w.to(self.device, torch.float32).contiguous())
        self.state = sk.init(cfg, self.device)
        self.use_kernels = use_kernels

    def _on_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32,
                               device=self.device).contiguous()

    def update(self, x) -> "AceEstimator":
        x = self._on_device(x)
        if self.use_kernels:
            buckets = kops.hash_dispatch(x, self.w, self.cfg.srp)
            self.state = kops.ace_update(self.state, buckets, self.cfg)
        else:
            self.state = sk.insert(self.state, self.w, x, self.cfg)
        return self

    def fit(self, x, batch: int = 4096) -> "AceEstimator":
        x = self._on_device(x)
        for i in range(0, x.shape[0], batch):
            self.update(x[i: i + batch])
        return self

    def remove(self, x) -> "AceEstimator":
        self.state = sk.delete(self.state, self.w, self._on_device(x),
                               self.cfg)
        return self

    def score(self, q) -> torch.Tensor:
        q = self._on_device(q)
        if self.use_kernels:
            return kops.ace_score(self.state, q, self.w, self.cfg)
        return sk.score(self.state, self.w, q, self.cfg)

    def predict(self, q, alpha: float = 1.0,
                sigma: float | None = None) -> torch.Tensor:
        """Anomaly decision.  With ``sigma`` (absolute-score σ), use it on
        raw scores; else the streaming Welford σ of RATES (score/n)."""
        s = self.score(q)
        if sigma is not None:
            return s < sk.mean_mu(self.state) - alpha * sigma
        n = torch.clamp_min(self.state.n, 1.0)
        return s / n < sk.mean_rate(self.state) \
            - alpha * sk.sigma_welford(self.state)

    @property
    def mu(self) -> torch.Tensor:
        return sk.mean_mu(self.state)

    def memory_bytes(self) -> int:
        return self.cfg.memory_bytes()
