"""The kNN-graph-based baselines of paper §5.2 (ELKI family) — port of
``repro.baselines.neighbors``.

Every scorer takes the precomputed graph (dists, idx) — mirroring how ELKI
amortises one index across algorithms — and returns a (n,) float32 tensor
on the graph's device where **LOW = anomalous** (the paper's μ−σ
thresholding convention; distance-style scores are negated).

Implemented: kNN [28], kNNW [4], LOF [6], LoOP [23], LDOF [40], ODIN [18],
KDEOS [31], LDF [24], INFLO [20].  COF and FastVOA live in their own
modules.  The reverse-neighbour sums of ODIN and INFLO are
``index_add_``: ODIN's counts are exact; INFLO's float32 density sums
depend on the order of the adds, which CUDA's atomics do not fix.
"""
from __future__ import annotations

import math

import torch


def _as_t(dists, idx):
    return (torch.as_tensor(dists, dtype=torch.float32),
            torch.as_tensor(idx).long())


# -- kNN (KNNOutlier, Ramaswamy et al.) ------------------------------------

def knn_score(dists, idx):
    """distance to the k-th NN; high = anomalous -> negated."""
    d, _ = _as_t(dists, idx)
    return -d[:, -1]


# -- kNNW (KNNWeightOutlier, Angiulli & Pizzuti) ----------------------------

def knnw_score(dists, idx):
    """sum of distances to the k NNs."""
    d, _ = _as_t(dists, idx)
    return -torch.sum(d, dim=1)


# -- LOF (Breunig et al.) ---------------------------------------------------

def lof_score(dists, idx):
    d, i = _as_t(dists, idx)
    kdist = d[:, -1]                                    # (n,)
    reach = torch.maximum(kdist[i], d)                  # (n, k)
    lrd = 1.0 / (torch.mean(reach, dim=1) + 1e-12)      # (n,)
    lof = torch.mean(lrd[i], dim=1) / (lrd + 1e-12)
    return -lof


# -- LoOP (Kriegel et al.) --------------------------------------------------

def loop_score(dists, idx, lam: float = 2.0):
    """Local outlier probability in [0, 1]; high = anomalous -> negated.

    The paper's Table 2 lists λ=0.2 for LoOP; the original LoOP paper
    recommends λ≈2–3 (λ multiplies a σ), so it is a parameter.  ``nplof``
    is a mean over all points.
    """
    d, i = _as_t(dists, idx)
    pdist = lam * torch.sqrt(torch.mean(d**2, dim=1) + 1e-12)
    plof = pdist / (torch.mean(pdist[i], dim=1) + 1e-12) - 1.0
    nplof = lam * torch.sqrt(torch.mean(plof**2) + 1e-12)
    loop = torch.clamp_min(
        torch.special.erf(plof / (nplof * math.sqrt(2.0) + 1e-12)), 0.0)
    return -loop


# -- LDOF (Zhang et al.) ------------------------------------------------------

def ldof_score(dists, idx, inner_pairwise):
    """d̄(p→kNN) / D̄(inner pairwise of kNN);  inner_pairwise: (n,k+1,k+1)."""
    d, _ = _as_t(dists, idx)
    k = d.shape[1]
    dbar = torch.mean(d, dim=1)
    inner = torch.as_tensor(inner_pairwise)[:, 1:, 1:]  # exclude p itself
    # mean over ordered pairs a≠b
    s = torch.sum(inner, dim=(1, 2))
    Dbar = s / (k * (k - 1) + 1e-12)
    return -(dbar / (Dbar + 1e-12))


# -- ODIN (Hautamaki et al.) --------------------------------------------------

def odin_score(dists, idx):
    """kNN-graph indegree; LOW indegree = anomalous (already aligned)."""
    _, i = _as_t(dists, idx)
    n = i.shape[0]
    flat = i.reshape(-1)
    return torch.zeros(n, dtype=torch.float32, device=i.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=i.device))


# -- KDEOS (Schubert et al.) --------------------------------------------------

def kdeos_terms(dists, idx, bandwidth: float = 5.0, scale: float = 0.2):
    """KDEOS's parts: each point's Gaussian-KDE density, and the mean and
    spread of its neighbours' (the population std, ``correction=0``, as
    ``jnp.std``).  Where a density sits near its neighbours' mean the
    z-score divides a cancellation by the spread, so its rounding grows
    with (|mean| + |density|) / spread."""
    d, i = _as_t(dists, idx)
    kdist = d[:, -1]
    h = bandwidth * scale * (kdist + 1e-9)              # per-point bandwidth
    dens = torch.mean(torch.exp(-0.5 * (d / h[:, None])**2), dim=1) / h
    mu_nb = torch.mean(dens[i], dim=1)
    sd_nb = torch.std(dens[i], dim=1, correction=0) + 1e-12
    return dens, mu_nb, sd_nb


def kdeos_score(dists, idx, bandwidth: float = 5.0, scale: float = 0.2):
    """Gaussian-KDE density z-scored against the kNN set (k_min=k_max=k)."""
    dens, mu_nb, sd_nb = kdeos_terms(dists, idx, bandwidth, scale)
    z = (mu_nb - dens) / sd_nb                          # high z = low density
    return -z


# -- LDF (Latecki et al.) ------------------------------------------------------

def ldf_score(dists, idx, h: float = 1.0, c: float = 0.1):
    """Kernel-density LOF variant with reachability distances."""
    d, i = _as_t(dists, idx)
    kdist = d[:, -1]
    reach = torch.maximum(kdist[i], d)                  # (n, k)
    width = h * (kdist[:, None] + 1e-9)
    lde = torch.mean(torch.exp(-0.5 * (reach / width)**2) / width, dim=1)
    ldf = torch.mean(lde[i], dim=1) / (lde + c * torch.mean(lde[i], dim=1)
                                       + 1e-12)
    return -ldf


# -- INFLO (Jin et al.) ---------------------------------------------------------

def inflo_score(dists, idx, m: float = 0.5):
    """Influenced outlierness over kNN ∪ RkNN (reverse set via scatter)."""
    d, i = _as_t(dists, idx)
    n, k = i.shape
    density = 1.0 / (d[:, -1] + 1e-12)
    # sum/count of density over the reverse-kNN set, via scatter-add
    flat = i.reshape(-1)
    rev_sum = torch.zeros_like(density).index_add_(
        0, flat, torch.repeat_interleave(density, k))
    rev_cnt = torch.zeros_like(density).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=i.device))
    knn_sum = torch.sum(density[i], dim=1)
    tot = (rev_sum + knn_sum) / (rev_cnt + k)
    inflo = tot / (density + 1e-12)
    return -inflo
