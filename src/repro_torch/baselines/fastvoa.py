"""FastVOA — near-linear variance-of-angles estimation (Pham & Pagh,
KDD'12) — port of ``repro.baselines.fastvoa``.

The paper's sampling-based competitor (§5.2 item 3).  ABOD's outlier signal
is the *variance* over pairs (a, b) of the angle ∠(a, p, b); outliers see
the world in a narrow cone ⇒ low variance.

FastVOA estimates it with t random hyperplanes and AMS sketches:

* For hyperplane w, sort points by z = X·w.  With l_p = #left and
  r_p = #right of p, MOA1(p) = 2·E[l_p r_p] / ((n−1)(n−2)) estimates the
  mean angle/π.
* For the second moment, ±1 AMS streams s (s2, n): with signed prefix sums
  SL(p) = Σ_{a left} s(a), SR(p) = Σ_{b right} s(b), the products
  P_i = SL_i·SR_i of independent hyperplanes i ≠ j (same signs) give
  E[P_i P_j] ⇒ MOA2.
* VOA(p) = MOA2 − MOA1²;  LOW variance = anomalous (already aligned).

The hyperplanes (t, d) and signs come from a ``torch.Generator`` seeded
with ``seed`` (not the reference's ``jax.random`` draws); the keyword
arguments ``hyperplanes`` and ``signs`` take given ones instead, for
example the reference's carried across as numpy.  Projections run in
blocks; the float64 accumulation over hyperplanes stays on the device, one
hyperplane at a time in the reference's order.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device


def projection_stats(x: torch.Tensor, w: torch.Tensor, signs: torch.Tensor):
    """For each hyperplane of a block w (tb, d): the float32 l·r counts
    (n, tb), the products P = SL·SR (s2, n, tb) and the ranks (n, tb).

    ``signs`` (s2, n) are the AMS ±1 streams — FIXED across all
    hyperplanes (only then does E[P_i·P_j] for i≠j recover the second
    moment).
    """
    n = x.shape[0]
    z = x @ w.T                                          # (n, tb)
    order = torch.argsort(z, dim=0, stable=True)         # ascending
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(n, device=x.device)[:, None].expand_as(order))
    l = rank.to(torch.float32)                  # #points strictly left
    r = (n - 1 - rank).to(torch.float32)        # #points strictly right
    f1 = l * r
    s_sorted = signs[:, order]                           # (s2, n, tb)
    pref = torch.cumsum(s_sorted, dim=1)       # pref[:, i] = Σ first i+1
    total = pref[:, -1:]
    # SL(p) = Σ signs strictly left of p = pref[:, rank[p]] − sign(p)
    at_p = torch.gather(pref, 1, rank[None].expand_as(pref))
    sl = at_p - signs[:, :, None]
    sr = total - at_p
    return f1, sl * sr, rank


def draws(n: int, d: int, t: int, s2: int, seed: int, device):
    """The hyperplanes (t, d) float32 and the shared AMS signs (s2, n)
    float32 in {−1, +1}, from one generator seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    hyperplanes = torch.randn((t, d), generator=gen, device=device)
    signs = (torch.rand((s2, n), generator=gen, device=device) < 0.5) \
        .to(torch.float32) * 2.0 - 1.0
    return hyperplanes, signs


def fastvoa_score(x, t: int = 320, s2: int = 2, seed: int = 0, *,
                  hyperplanes=None, signs=None, block: int = 32,
                  device=None) -> torch.Tensor:
    """Variance-of-angle scores (n,) float32; LOW = anomalous.

    Unbiased throughout: MOA1 from l·r counts; MOA1² and MOA2 from
    cross-products over *independent* hyperplanes.  ``hyperplanes``
    (t, d) and ``signs`` (s2, n) replace the seeded draws when given.
    Runs on ``device`` (CUDA unless the caller passes another).
    """
    dev = resolve_device(device)
    xt = torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()
    n, d = xt.shape
    if hyperplanes is None or signs is None:
        drawn = draws(n, d, t, s2, seed, dev)
    w_all = drawn[0] if hyperplanes is None else torch.as_tensor(
        hyperplanes, dtype=torch.float32, device=dev)
    s_all = drawn[1] if signs is None else torch.as_tensor(
        signs, dtype=torch.float32, device=dev)
    t, s2 = w_all.shape[0], s_all.shape[0]

    # Per-projection l·r and SL·SR are float32 products (rounded past
    # 2^24, as the reference's); the ACCUMULATION is float64 — f1_sum²
    # reaches ~1e15, and the answer is a small difference of such terms.
    f1_sum = torch.zeros(n, dtype=torch.float64, device=dev)
    f1_sq = torch.zeros(n, dtype=torch.float64, device=dev)
    p_sum = torch.zeros((s2, n), dtype=torch.float64, device=dev)
    p_sq = torch.zeros((s2, n), dtype=torch.float64, device=dev)
    for b in range(0, t, block):
        f1, p, _ = projection_stats(xt, w_all[b:b + block], s_all)
        f1, p = f1.double(), p.double()
        for j in range(f1.shape[1]):        # the reference's add order
            f1_sum += f1[:, j]
            f1_sq += f1[:, j] * f1[:, j]
            p_sum += p[:, :, j]
            p_sq += p[:, :, j] * p[:, :, j]

    denom_pairs = (n - 1.0) * (n - 2.0) / 2.0    # unordered (a, b) pairs
    tt = t * (t - 1.0)
    # unbiased square of the first moment: Σ_{i≠j} f1_i f1_j / (t(t−1))
    moa1_sq = (f1_sum**2 - f1_sq) / tt / denom_pairs**2
    # second moment: Σ_{i≠j} P_i P_j / (t(t−1)), averaged over AMS streams
    cross = torch.mean(p_sum**2 - p_sq, dim=0)
    moa2 = cross / tt / denom_pairs
    return (moa2 - moa1_sq).to(torch.float32)
