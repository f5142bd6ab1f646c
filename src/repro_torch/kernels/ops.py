"""Sketch-level operations on the kernels (port of ``repro.kernels.ops``):
what ``AceEstimator(use_kernels=True)`` and the guardrail call.

Each kernel wrapper launches its CUDA kernel for CUDA tensors and takes
its plain PyTorch version for CPU tensors, so these functions run the
same code on both.  They update the counts IN PLACE (the state passed in
shares its counts tensor with the state returned); the plain sketch API
in ``repro_torch.core.sketch`` is the functional one.
"""
from __future__ import annotations

import torch

from repro_torch import not_ported
from repro_torch.core import sketch as _sk
from repro_torch.core.sketch import AceConfig, AceState
from repro_torch.core.srp import SrpConfig, require_dense
from repro_torch.kernels import ace_admit_fused as _a
from repro_torch.kernels import ace_query as _q
from repro_torch.kernels import ace_update as _u
from repro_torch.kernels import srp_hash as _h


def hash_dispatch(x: torch.Tensor, w: torch.Tensor,
                  cfg: SrpConfig) -> torch.Tensor:
    """THE kernel-path hash (dense only in this slice): (B, d) -> (B, L)."""
    require_dense(cfg)
    return _h.srp_hash(x, w, cfg)


def ace_update(state: AceState, buckets: torch.Tensor,
               cfg: AceConfig) -> AceState:
    """Kernel-path insert: the ``ace_update`` kernel adds the batch, then
    the ``ace_query`` kernel gathers the post-insert counts for the
    Welford stream (the reference's formula, with no ``welford_min_n``
    gate, as in ``repro.kernels.ops.ace_update``)."""
    new_counts = _u.ace_update(state.counts, buckets)
    gathered = _q.ace_query(new_counts, buckets)
    scores = torch.mean(gathered, dim=-1)
    b = float(scores.shape[0])
    n = state.n
    tot = n + b
    rates = scores / torch.clamp_min(tot, 1.0)
    mean_b = torch.mean(rates)
    m2_b = torch.sum((rates - mean_b) ** 2)
    delta = mean_b - state.welford_mean
    safe = torch.clamp_min(tot, 1.0)
    return AceState(
        counts=new_counts, n=tot,
        welford_mean=state.welford_mean + delta * b / safe,
        welford_m2=state.welford_m2 + m2_b + delta**2 * n * b / safe)


def ace_query(state: AceState, buckets: torch.Tensor,
              table_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(B, L) bucket ids -> (B,) scores via the gather kernel."""
    if table_mask is not None:
        not_ported("table_mask (degraded scoring)", 10)
    return torch.mean(_q.ace_query(state.counts, buckets), dim=-1)


def ace_score(state: AceState, q: torch.Tensor, w: torch.Tensor,
              cfg: AceConfig,
              table_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Hash + lookup + mean of raw query vectors: the ``srp_hash`` and
    ``ace_query`` kernels, with the row sum times float32(1/L) of the
    fused TPU kernel ``ace_score_fused`` that this stands in for until it
    is ported."""
    if table_mask is not None:
        not_ported("table_mask (degraded scoring)", 10)
    gathered = _q.ace_query(state.counts, hash_dispatch(q, w, cfg.srp))
    return torch.sum(gathered, dim=-1) * _sk.reciprocal(cfg.num_tables)


def ace_admit(state: AceState, q: torch.Tensor, w: torch.Tensor,
              cfg: AceConfig, *, alpha: float, warmup_items: float,
              table_mask: torch.Tensor | None = None,
              item_mask: torch.Tensor | None = None):
    """Fused guardrail admission: ONE hash, no host syncs.

    The μ−ασ threshold is computed on the device from the state scalars
    (−inf during warmup) and read by the ``ace_admit_fused`` kernel
    through a pointer.  The Welford epilogue folds the admitted items'
    POST-insert scores, gathered with the ``ace_query`` kernel from the
    kernel's own bucket ids (no second hash).  Returns (new_state,
    admit (B,) bool).
    """
    require_dense(cfg.srp)
    thresh = _sk.admit_threshold(state, alpha, warmup_items,
                                 table_mask=table_mask)
    new_counts, _scores, admit, buckets = _a.ace_admit_fused(
        state.counts, q, w, thresh, cfg.srp, item_mask=item_mask)
    post = torch.sum(_q.ace_query(new_counts, buckets), dim=-1) \
        * _sk.reciprocal(cfg.num_tables)
    tot, new_mean, new_m2 = _sk.masked_batch_welford(
        state, post, admit.to(torch.float32), cfg.welford_min_n)
    return AceState(new_counts, tot, new_mean, new_m2), admit
