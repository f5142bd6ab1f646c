"""COF — Connectivity-based Outlier Factor (Tang et al., PAKDD'02) — port
of ``repro.baselines.cof``.

COF replaces LOF's density with the *average chaining distance* (ac-dist):
the cost of connecting p to its neighbourhood through a set-based nearest
path (an incremental MST rooted at p).  COF(p) = ac(p) / mean ac(o∈kNN(p)).

Each neighbourhood has only k+1 ≤ 11 points, so Prim's algorithm is k
steps, each batched over all n neighbourhoods at once: a masked
``argmin`` (the first index on ties, as ``jnp.argmin``), then a running
``minimum`` — the reference's ``lax.scan`` under ``vmap``, written out.
"""
from __future__ import annotations

import torch


def ac_dist(pd: torch.Tensor) -> torch.Tensor:
    """Average chaining distance from Prim's order on each (k+1, k+1)
    matrix of pd (n, k+1, k+1), slot 0 the root p: Σ_i w_i·e_i with e_i
    the i-th edge added and w_i = 2(r−i)/(r(r−1)), r = k+1."""
    n, r, _ = pd.shape
    rows = torch.arange(n, device=pd.device)
    in_tree = torch.zeros((n, r), dtype=torch.bool, device=pd.device)
    in_tree[:, 0] = True
    best = pd[:, 0].clone()          # distance of each node to the tree
    costs = []
    for _ in range(1, r):
        masked = torch.where(in_tree, float("inf"), best)
        nxt = torch.argmin(masked, dim=1)
        costs.append(masked[rows, nxt])
        in_tree[rows, nxt] = True
        best = torch.minimum(best, pd[rows, nxt])
    i = torch.arange(1, r, dtype=torch.float32, device=pd.device)
    w = 2.0 * (r - i) / (r * (r - 1.0))
    return torch.sum(w * torch.stack(costs, dim=1), dim=1)


def cof_score(x, idx: torch.Tensor, inner_pairwise) -> torch.Tensor:
    """COF over the whole dataset; LOW = anomalous (negated).  ``x`` is
    not read (the reference's signature).

    inner_pairwise: (n, k+1, k+1) from knn_graph.pairwise_within_neighborhood.
    """
    pd = torch.as_tensor(inner_pairwise, dtype=torch.float32)
    ac = ac_dist(pd)                                     # (n,)
    i = torch.as_tensor(idx, device=pd.device).long()
    cof = ac / (torch.mean(ac[i], dim=1) + 1e-12)
    return -cof
