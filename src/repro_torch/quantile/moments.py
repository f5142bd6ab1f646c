"""α-th frequency-moment skew index over the ACE count planes — port of
``repro.quantile.moments.falpha_index`` (Compressed Counting, Ping Li,
arXiv 1205.2632).

Each ACE table is a materialised 2^K-bucket frequency vector of the
hashed stream, so F_α = Σ_b A[b]^α is computed directly per table and
averaged over the L tables.  The surfaced statistic is the scale-free
index

    I_α = mean_j  F_α(A_j) / (n^α · m^{1−α}),     m = 2^K,

which is exactly 1 for a uniform plane and grows with concentration; the
n^α makes it stationary across stream growth, so a moving I_α is a drift
signal.  ``StreamRunner`` reports it once per chunk.
"""
from __future__ import annotations

import torch


def falpha_per_table(counts: torch.Tensor, n: torch.Tensor,
                     alpha: float = 1.25) -> torch.Tensor:
    """(..., L) per-table indices F_α(A_j) / (n^α · m^{1−α}) of
    ``falpha_index``, before the mean over the tables (a table-sharded
    sketch gathers its ranks' blocks of them)."""
    c = torch.clamp_min(counts.to(torch.float32), 0.0)
    m = c.shape[-1]
    f_alpha = torch.sum(c ** alpha, dim=-1)                       # (L,)
    denom = (torch.clamp_min(n.to(torch.float32), 1.0) ** alpha
             * float(torch.tensor(m ** (1.0 - alpha), dtype=torch.float32)))
    return f_alpha / denom[..., None]


def falpha_index(counts: torch.Tensor, n: torch.Tensor, alpha: float = 1.25,
                 table_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Normalised α-th frequency-moment index of (..., L, M) count planes
    (flat (L, M), fleet (T, L, M)) -> (...,) float32; ``n`` broadcasts
    against the leading axes.  Negative counters (corruption) clamp to 0
    so the fractional power is defined; ``table_mask`` ((L,) or (T, L))
    restricts the table mean to healthy planes."""
    return table_mean(falpha_per_table(counts, n, alpha), table_mask)


def table_mean(per_table: torch.Tensor,
               table_mask: torch.Tensor | None = None) -> torch.Tensor:
    """The mean over the last (table) axis of ``falpha_per_table``'s
    indices, over the healthy tables of ``table_mask`` when one is
    given."""
    if table_mask is None:
        return torch.mean(per_table, dim=-1)
    maskf = table_mask.to(torch.float32)
    nh = torch.clamp_min(torch.sum(maskf, dim=-1), 1.0)
    return torch.sum(per_table * maskf, dim=-1) / nh
