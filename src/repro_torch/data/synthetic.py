"""Synthetic benchmark datasets shaped like the paper's three benchmarks —
a copy of ``repro.data.synthetic`` (numpy only), whose outputs it
reproduces bitwise.

The real files (UCI Statlog Shuttle, ALOI-HSB, KDD-Cup99 HTTP) are not
downloaded, so datasets are generated with the same (n, d, #anomalies)
statistics (paper Table 1) and the same qualitative structure the paper
relies on:

* features are NONNEGATIVE (radiator positions / HSB histograms / traffic
  counts), so inliers occupy a few cones in the positive orthant and
  density differences are *angular* — which is what an SRP-based score sees;
* inliers form a handful of dense clusters (normal operating modes /
  object classes / normal HTTP traffic);
* anomalies are a mix of (a) scattered points in low-density directions and
  (b) a couple of loose rare clusters (the "rare class" style of Shuttle's
  classes 2/3/5/6/7 and KDD's attack bursts).

Every generator is a pure function of its arguments and seed.  With
``seed=None``, ``make_paper_dataset`` seeds from ``hash(name)``, which
Python randomises per process (``PYTHONHASHSEED``), so that dataset is
the same only within one process — the reference's behaviour, kept so
both packages agree in one process (ROADMAP.md queue 3 item 8); pass a
seed for data that is the same across processes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# name -> (n_instances, n_anomalies, dim)   [paper Table 1]
PAPER_STATS = {
    "shuttle": (34_987, 879, 9),
    "aloi": (50_000, 1_508, 27),
    "kddcup99_http": (596_853, 1_055, 36),
}


@dataclasses.dataclass
class Dataset:
    name: str
    x: np.ndarray          # (n, d) float32
    y: np.ndarray          # (n,) int8; 1 = anomaly
    n_anomalies: int

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def dim(self) -> int:
        return self.x.shape[1]

    def bytes(self) -> int:
        return self.x.nbytes


def _unit(v: np.ndarray) -> np.ndarray:
    return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-12)


def make_paper_dataset(name: str, n: int | None = None,
                       seed: int | None = None) -> Dataset:
    """Generate the named benchmark analogue (optionally subsampled to n)."""
    if name not in PAPER_STATS:
        raise KeyError(f"unknown dataset {name!r}; have {list(PAPER_STATS)}")
    n_full, n_anom_full, d = PAPER_STATS[name]
    n = n or n_full
    frac = n / n_full
    n_anom = max(8, int(round(n_anom_full * frac)))
    n_in = n - n_anom
    rng = np.random.default_rng(
        seed if seed is not None else abs(hash(name)) % (2**31))

    # --- inlier clusters: distinct directions in the positive orthant -----
    n_clusters = {9: 4, 27: 6, 36: 5}.get(d, 5)
    centers = rng.gamma(shape=2.0, scale=2.0, size=(n_clusters, d))
    centers *= (rng.uniform(4.0, 9.0, size=(n_clusters, 1))
                / np.linalg.norm(centers, axis=1, keepdims=True))
    # near-balanced cluster masses: heavily skewed masses make the score
    # distribution multimodal with huge σ, which defeats ANY μ−σ rule (the
    # paper's real benchmarks are mass-balanced after its preprocessing)
    weights = rng.dirichlet(np.full(n_clusters, 20.0))
    assign = rng.choice(n_clusters, size=n_in, p=weights)
    # Angular spread matters: near-duplicate clusters (tiny spread) put ACE
    # into its positive-covariance worst case (paper §3.3); real benchmark
    # data has broad within-class variation, which this range mimics.
    spread = rng.uniform(0.4, 1.1, size=(n_clusters,))
    x_in = centers[assign] + rng.normal(
        size=(n_in, d)) * spread[assign][:, None]
    x_in = np.abs(x_in)  # keep the nonnegative-orthant structure

    # --- anomalies: mostly scattered + two loose rare clusters -----------
    # (tight rare clusters would self-mask for every density-style method;
    # the paper's preprocessing — stratified downsampling of rare classes —
    # has the same de-clumping effect.)
    n_scatter = (3 * n_anom) // 4
    dirs = _unit(rng.normal(size=(n_scatter, d)))
    x_scatter = np.abs(dirs) * rng.uniform(6.0, 14.0, size=(n_scatter, 1))
    # push scattered anomalies away from every inlier-cone direction
    x_scatter += rng.exponential(1.0, size=x_scatter.shape)

    n_rare = n_anom - n_scatter
    rare_centers = np.abs(_unit(rng.normal(size=(2, d)))) * 12.0
    rare_assign = rng.choice(2, size=n_rare)
    x_rare = np.abs(rare_centers[rare_assign]
                    + 0.35 * rng.normal(size=(n_rare, d)))

    x = np.concatenate([x_in, x_scatter, x_rare]).astype(np.float32)
    y = np.concatenate([np.zeros(n_in, np.int8),
                        np.ones(n_anom, np.int8)])
    perm = rng.permutation(n)
    return Dataset(name=name, x=x[perm], y=y[perm], n_anomalies=n_anom)


def make_fig1_dataset(seed: int = 0):
    """Paper Figure 1a: inner points, border points, outliers (2-D sim).

    Returns (data, inner_idx, border_idx, outliers) — ``data`` holds inner ∪
    border; outliers are separate query points (as in the paper's plot).
    """
    rng = np.random.default_rng(seed)
    n = 1000
    # dense disk centred off-origin (angular structure for SRP)
    center = np.array([6.0, 6.0])
    r = np.sqrt(rng.uniform(0.0, 1.0, n)) * 2.0
    ang = rng.uniform(0, 2 * np.pi, n)
    pts = center + np.stack([r * np.cos(ang), r * np.sin(ang)], 1)
    radii = np.linalg.norm(pts - center, axis=1)
    inner_idx = np.argsort(radii)[: n // 10]
    border_idx = np.argsort(radii)[-n // 10:]
    outliers = center + np.array([[9.0, -7.5], [10.0, -8.0], [-7.0, 9.5]])
    return (pts.astype(np.float32), inner_idx, border_idx,
            outliers.astype(np.float32))


def make_drift_stream(n_steps: int, batch: int, dim: int, *,
                      shift_step: int, anomaly_every: int = 7,
                      anomaly_frac: float = 0.25, seed: int = 0):
    """Concept-drift stream for windowed-vs-frozen sketch comparisons.

    Yields ``n_steps`` batches of (batch, dim) nonnegative features plus
    per-item anomaly labels.  Three populations, all angularly separated
    (what an SRP score sees):

    * **regime A inliers** — a cone on the first third of the dims; the
      only inlier population before ``shift_step``.
    * **regime B inliers** — a cone on the middle third; replaces A at
      ``shift_step`` (an abrupt shift, the hardest case for a cumulative
      sketch: A's mass never leaves it, so post-shift μ stays pinned to a
      regime that stopped arriving and σ inflates on the A/B mix).
    * **anomalies** — scattered directions on the last third, injected
      into every ``anomaly_every``-th batch at ``anomaly_frac`` of rows,
      SAME distribution throughout (so recall before/after the shift is
      apples-to-apples; only the detector's notion of "normal" moves).

    Returns a list of (x (batch, dim) float32, y (batch,) int8) — pure
    function of the arguments, like every generator in this module.
    """
    rng = np.random.default_rng(seed)
    third = dim // 3
    mu_a = np.zeros(dim)
    mu_a[:third] = 5.0
    mu_b = np.zeros(dim)
    mu_b[third:2 * third] = 5.0
    out = []
    for t in range(n_steps):
        mu = mu_a if t < shift_step else mu_b
        x = np.abs(rng.normal(size=(batch, dim)) * 0.5 + mu)
        y = np.zeros(batch, np.int8)
        if anomaly_every and t % anomaly_every == anomaly_every - 1:
            k = max(1, int(round(batch * anomaly_frac)))
            rows = rng.choice(batch, size=k, replace=False)
            nu = np.zeros(dim)
            nu[2 * third:] = 6.0
            x[rows] = np.abs(rng.normal(size=(k, dim)) * 0.4 + nu)
            y[rows] = 1
        out.append((x.astype(np.float32), y))
    return out


def bias_augment(x: np.ndarray, c: float = 1.0) -> np.ndarray:
    """Append a constant coordinate: makes SRP (angular) sensitive to offsets.

    Classic trick: cos∠([x,c],[y,c]) mixes direction and magnitude, so
    mean-shift anomalies in centred data become angular anomalies.  Used by
    the training-telemetry monitor where features are signed.
    """
    ones = np.full((*x.shape[:-1], 1), c, dtype=x.dtype)
    return np.concatenate([x, ones], axis=-1)
