"""Sketch-level operations on the kernels (port of ``repro.kernels.ops``):
what ``AceEstimator(use_kernels=True)``, the data filter and the guardrail
call.

Each kernel wrapper launches its CUDA kernel for CUDA tensors and takes
its plain PyTorch version for CPU tensors, so these functions run the
same code on both.  They update the counts IN PLACE (the state passed in
shares its counts tensor with the state returned); the plain sketch API
in ``repro_torch.core.sketch`` is the functional one.

Hash-family dispatch: ``hash_dispatch`` routes ``SrpConfig.hash_mode``
between the ``srp_hash`` and ``srht_hash`` kernels (``"auto"`` resolves by
``repro_torch.core.srht.choose_hash_mode``).  The fused score and admit
kernels hash densely inside; under ``"srht"`` (and, for admission, with a
table mask) the one hash runs as its own kernel and the gather and
insert as the ``ace_query`` and ``ace_update`` kernels — still one hash a
batch.
"""
from __future__ import annotations

import torch

from repro_torch.core import sketch as _sk
from repro_torch.core.sketch import AceConfig, AceState
from repro_torch.core.srp import SrpConfig, resolve_hash_mode
from repro_torch.kernels import ace_admit_fused as _a
from repro_torch.kernels import ace_query as _q
from repro_torch.kernels import ace_score_fused as _f
from repro_torch.kernels import ace_update as _u
from repro_torch.kernels import srht_hash as _sh
from repro_torch.kernels import srp_hash as _h


def srht_hash(x: torch.Tensor, cfg: SrpConfig) -> torch.Tensor:
    """(B, d) -> (B, L) bucket ids via the SRHT kernel."""
    return _sh.srht_hash(x, cfg)


def hash_dispatch(x: torch.Tensor, w: torch.Tensor,
                  cfg: SrpConfig) -> torch.Tensor:
    """THE kernel-path hash, dense or SRHT by ``cfg.hash_mode``:
    (B, d) -> (B, L).  ``w`` is not read under ``"srht"``."""
    if resolve_hash_mode(cfg) == "srht":
        return srht_hash(x, cfg)
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


def _mask_weights(table_mask: torch.Tensor) -> torch.Tensor:
    """(L,) 0/1 health mask -> the kernel's ``table_weights``: the mask
    times its own 1/num_healthy."""
    maskf = table_mask.to(torch.float32)
    return maskf / torch.clamp_min(torch.sum(maskf), 1.0)


def ace_query(state: AceState, buckets: torch.Tensor,
              table_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(B, L) bucket ids -> (B,) scores via the gather kernel: the sum
    times float32(1/L) (``sketch.reciprocal``, so kernel and plain scores
    agree bitwise), or the mean over the healthy tables of
    ``table_mask``."""
    gathered = _q.ace_query(state.counts, buckets)
    if table_mask is None:
        return torch.sum(gathered, dim=-1) \
            * _sk.reciprocal(state.counts.shape[0])
    return _sk.masked_table_mean(gathered, table_mask)


def ace_score(state: AceState, q: torch.Tensor, w: torch.Tensor,
              cfg: AceConfig,
              table_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Hash + lookup + mean of raw query vectors.

    Dense: one ``ace_score_fused`` call, with the health mask baked into
    its ``table_weights`` when ``table_mask`` is given.  SRHT: the
    ``srht_hash`` kernel, then ``ace_query``.
    """
    if resolve_hash_mode(cfg.srp) == "srht":
        return ace_query(state, hash_dispatch(q, w, cfg.srp),
                         table_mask=table_mask)
    if table_mask is None:
        return _f.ace_score_fused(state.counts, q, w, cfg.srp)
    return _f.ace_score_fused(state.counts, q, w, cfg.srp,
                              table_weights=_mask_weights(table_mask))


def ace_admit_at(state: AceState, q: torch.Tensor, w: torch.Tensor,
                 cfg: AceConfig, thresh: torch.Tensor, *,
                 table_mask: torch.Tensor | None = None,
                 item_mask: torch.Tensor | None = None):
    """Admission against a given score-space threshold: ONE hash, no host
    sync.  ``admit = score >= thresh`` (and ``item_mask``); admitted rows
    are inserted; the Welford stream folds their POST-insert scores.

    Dense with no table mask: the ``ace_admit_fused`` kernel (hash,
    pre-insert score, threshold, masked insert).  SRHT or a table mask:
    ``hash_dispatch``, the ``ace_query`` kernel for the (masked) score,
    the ``ace_update`` kernel with the admit mask as its row mask.  Both
    then gather the post-insert counts with ``ace_query`` from the same
    bucket ids, as ``repro.core.sketch.insert_buckets_masked`` does.
    Returns (new_state, admit (B,) bool, pre-insert scores (B,) f32).
    """
    if resolve_hash_mode(cfg.srp) == "srht" or table_mask is not None:
        buckets = hash_dispatch(q, w, cfg.srp)
        scores = ace_query(state, buckets, table_mask)
        admit = scores >= thresh
        if item_mask is not None:
            admit = admit & item_mask
        new_counts = _u.ace_update(state.counts, buckets, row_mask=admit)
    else:
        new_counts, scores, admit, buckets = _a.ace_admit_fused(
            state.counts, q, w, thresh, cfg.srp, item_mask=item_mask)
    post = ace_query(state._replace(counts=new_counts), buckets)
    tot, new_mean, new_m2 = _sk.masked_batch_welford(
        state, post, admit.to(torch.float32), cfg.welford_min_n)
    return AceState(new_counts, tot, new_mean, new_m2), admit, scores


def ace_admit(state: AceState, q: torch.Tensor, w: torch.Tensor,
              cfg: AceConfig, *, alpha: float, warmup_items: float,
              table_mask: torch.Tensor | None = None,
              item_mask: torch.Tensor | None = None):
    """Guardrail admission: the μ−ασ threshold computed on the device from
    the state scalars (−inf during warmup), then ``ace_admit_at``.
    Returns (new_state, admit (B,) bool)."""
    thresh = _sk.admit_threshold(state, alpha, warmup_items,
                                 table_mask=table_mask)
    new_state, admit, _ = ace_admit_at(state, q, w, cfg, thresh,
                                       table_mask=table_mask,
                                       item_mask=item_mask)
    return new_state, admit
