"""Quickstart on the PyTorch/CUDA port: ACE in five minutes — the paper's
Algorithm 1, end to end.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Builds a sketch over a synthetic benchmark stream, scores queries, applies
the μ−σ decision rule, demonstrates dynamic delete (Eq. 12) and sketch
merging (the multi-pod primitive), and prints the memory receipt.  Runs on
the card (``--device cpu`` for the CPU, where every kernel takes its plain
PyTorch version).
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import convert
from repro_torch.core import sketch as sk
from repro_torch.core.estimators import AceEstimator, exact_score
from repro_torch.data.synthetic import make_paper_dataset

K, L = 15, 50           # the paper's settings (§3.4)


def run(ds, device, w=None) -> dict:
    """The quickstart on dataset ``ds``: build, score and decide, the exact
    statistic beside the estimate, delete + re-insert, shard and merge.
    ``w`` (numpy, (d, P)) carries a projection matrix in, else it is drawn
    from ``cfg.seed``.  Prints the reference's lines; returns their
    figures."""
    X = torch.as_tensor(ds.x, device=device)
    print(f"dataset: {ds.name} n={ds.n} d={ds.dim} "
          f"anomalies={int(ds.y.sum())} ({ds.bytes() / 2**20:.1f} MB raw)")

    # ---- build the sketch at the paper's settings (K=15, L=50, short
    # counters: the 3.2 MB configuration of §3.4) ------------------------
    cfg = sk.AceConfig(dim=ds.dim, num_bits=K, num_tables=L, seed=0,
                       counter_dtype="int16")
    w = (sk.make_params(cfg, device=device) if w is None
         else convert.params_from_numpy(w, device))
    est = AceEstimator(cfg, device=device, w=w).update(X)
    print(f"sketch: {cfg.memory_bytes() / 2**20:.2f} MB of counters "
          f"(paper §3.4: 3.2 MB) — data/sketch = "
          f"{ds.bytes() / cfg.memory_bytes():.2f} (>>1 at KDD-full scale)")

    # ---- score + decide --------------------------------------------------
    scores = est.score(X).cpu().numpy()
    mu, sd = scores.mean(), scores.std()
    flagged = scores < mu - sd
    tp = int((flagged & (ds.y == 1)).sum())
    print(f"μ={mu:.1f} σ={sd:.1f}; flagged {int(flagged.sum())} "
          f"({tp}/{int(ds.y.sum())} true anomalies caught)")

    # ---- the estimator is unbiased: compare with the exact statistic ----
    q = X[:5]
    exact = exact_score(q, X, K).cpu().numpy()
    ace = est.score(q).cpu().numpy()
    print("exact S(q,D):", np.round(exact, 2))
    print("ACE  Ŝ(q,D):", np.round(ace, 2))

    # ---- dynamic updates (paper §3.4.1) ----------------------------------
    before = float(sk.mean_mu(est.state))
    est.remove(X[:1000])
    est.update(X[:1000])
    after = float(sk.mean_mu(est.state))
    inverse = bool(np.isclose(before, after))
    print(f"delete+re-insert 1000 rows: μ {before:.3f} -> {after:.3f} "
          f"(exact inverse: {inverse})")

    # ---- sketches merge (the multi-pod collective is just +) ------------
    half = ds.n // 2
    e1 = AceEstimator(cfg, device=device, w=w).update(X[:half])
    e2 = AceEstimator(cfg, device=device, w=w).update(X[half:])
    merged = sk.merge(e1.state, e2.state)
    same = bool(torch.equal(merged.counts, est.state.counts))
    print("shard-and-merge == bulk build:", same)
    return {"scores": scores, "mu": float(mu), "sd": float(sd),
            "flagged": int(flagged.sum()), "caught": tp, "exact": exact,
            "ace": ace, "mu_before": before, "mu_after": after,
            "exact_inverse": inverse, "merge_equal": same}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)
    run(make_paper_dataset("shuttle", n=20_000, seed=0), device)


if __name__ == "__main__":
    main()
