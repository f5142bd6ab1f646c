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
table mask) the one hash runs as its own kernel and the score and insert
as the ``ace_query_sum`` and ``ace_update`` kernels — still one hash a
batch.

Every gather of counters that a caller reduces over L at once — a
score, a post-insert score, a (masked) live-epoch sum — is one
``ace_query_sum`` launch: the gather, the exact row sum and the caller's
scaling (× float32(1/L), × 1/healthy, or none), with no (B, L)
matrix and no PyTorch reduction after it.  The (B, L) ``ace_query``
gather is not on any path here.

Windows and fleets (``repro_torch.window``, ``repro_torch.fleet``) address
a stacked table — the (E·L, 2^K) ring, the (T·L, 2^K) fleet, the
(T·E·L, 2^K) windowed fleet — through the ``ace_query_sum``/
``ace_update`` kernels' per-item base row (cursor·L, tid·L, tid·E·L +
cursor[tid]·L), computed on the device, so no cursor ever reaches the
host.  The float tail views are gathered and summed with plain PyTorch,
as the reference gathers them with jnp; the stats epilogues are the
plain modules' own (``ring.insert_stats``,
``fleet.state.fleet_masked_welford``, ``fleet.window.apply_insert_stats``).
"""
from __future__ import annotations

import torch

from repro_torch.core import sketch as _sk
from repro_torch.core.sketch import AceConfig, AceState
from repro_torch.core.srp import (SrpConfig, check_projections,
                                  resolve_hash_mode)
from repro_torch.fleet import state as _fls
from repro_torch.fleet import window as _fw
from repro_torch.kernels import ace_admit_fused as _a
from repro_torch.kernels import ace_fleet_score as _fl
from repro_torch.kernels import ace_fleet_window_admit as _fwa
from repro_torch.kernels import ace_query as _q
from repro_torch.kernels import ace_score_fused as _f
from repro_torch.kernels import ace_update as _u
from repro_torch.kernels import ace_window_combine as _wc
from repro_torch.kernels import attr_estimate as _ae
from repro_torch.kernels import srht_hash as _sh
from repro_torch.kernels import srp_hash as _h
from repro_torch.window import ring as _ring


def srp_hash(x: torch.Tensor, w: torch.Tensor,
             cfg: SrpConfig) -> torch.Tensor:
    """(B, d) -> (B, L) bucket ids via the dense-hash kernel."""
    return _h.srp_hash(x, w, cfg)


def srht_hash(x: torch.Tensor, cfg: SrpConfig) -> torch.Tensor:
    """(B, d) -> (B, L) bucket ids via the SRHT kernel."""
    return _sh.srht_hash(x, cfg)


def hash_dispatch(x: torch.Tensor, w: torch.Tensor,
                  cfg: SrpConfig) -> torch.Tensor:
    """THE kernel-path hash, dense or SRHT by ``cfg.hash_mode``:
    (B, d) -> (B, L).  ``w`` is not read under ``"srht"``, but its shape
    must be the resolved family's (``srp.check_projections``)."""
    check_projections(w, cfg)
    if resolve_hash_mode(cfg) == "srht":
        return srht_hash(x, cfg)
    return _h.srp_hash(x, w, cfg)


def attr_estimate(plane: torch.Tensor, cols: torch.Tensor,
                  signs: torch.Tensor) -> torch.Tensor:
    """Signed count-sketch point estimates through the ``attr_estimate``
    kernel: one (R, C) attribution-level plane, (B, R) bucket columns and
    ±1 signs -> (B,) median-of-rows estimates: ``attribution``'s
    ``estimate`` and ``estimate_level`` (the post-mortem query)."""
    return _ae.attr_estimate(plane, cols, signs)


def attr_find_hh(plane: torch.Tensor, cols: torch.Tensor,
                 signs: torch.Tensor, dim: int, topk: int):
    """The whole findHH drill-down of one (NL, R, C) hierarchy through the
    ``attr_find_hh`` kernel, one launch: ``attribution.find_hh`` on the
    stream path.  Returns (coords, ests, valid), each (topk,)."""
    return _ae.attr_find_hh(plane, cols, signs, dim, topk)


def ace_update(state: AceState, buckets: torch.Tensor,
               cfg: AceConfig) -> AceState:
    """Kernel-path insert: the ``ace_update`` kernel adds the batch, then
    one ``ace_query_sum`` launch gives the post-insert means over L (times
    float32(1/L), as ``torch.mean`` computes them on the card and
    ``sketch.insert_buckets`` everywhere) for the Welford stream (the
    reference's formula, with no ``welford_min_n`` gate, as in
    ``repro.kernels.ops.ace_update``)."""
    new_counts = _u.ace_update(state.counts, buckets)
    scores = _q.ace_query_sum(new_counts, buckets)
    b = float(scores.shape[0])
    n = state.n
    tot = n + b
    rates = scores / torch.clamp_min(tot, 1.0)
    mean_b = torch.mean(rates)
    m2_b = torch.sum((rates - mean_b) ** 2)
    delta = mean_b - state.welford_mean
    safe = torch.clamp_min(tot, 1.0)
    return state._replace(
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
    """(B, L) bucket ids -> (B,) scores in one ``ace_query_sum`` launch:
    the sum times float32(1/L) (``sketch.reciprocal``, so kernel and plain
    scores agree bitwise), or the mean over the healthy tables of
    ``table_mask`` (``sketch.masked_table_mean``'s)."""
    return _q.ace_query_sum(state.counts, buckets, table_mask=table_mask)


def ace_score(state: AceState, q: torch.Tensor, w: torch.Tensor,
              cfg: AceConfig,
              table_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Hash + lookup + mean of raw query vectors.

    Dense: one ``ace_score_fused`` call, with the health mask baked into
    its ``table_weights`` when ``table_mask`` is given.  SRHT: the
    ``srht_hash`` kernel, then ``ace_query_sum``.
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
    ``hash_dispatch``, ``ace_query_sum`` for the (masked) score, the
    ``ace_update`` kernel with the admit mask as its row mask.  Both then
    score the post-insert counts with ``ace_query_sum`` from the same
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
    return state._replace(counts=new_counts, n=tot, welford_mean=new_mean,
                          welford_m2=new_m2), admit, scores


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


# ---------------------------------------------------------------------------
# Windows and fleets.
# ---------------------------------------------------------------------------

def _flat(counts: torch.Tensor) -> torch.Tensor:
    """A stacked table (…, L, 2^K) as its (R, 2^K) rows (a view)."""
    return counts.view(-1, counts.shape[-1])


def ace_window_score(wstate, buckets: torch.Tensor, gamma: float,
                     table_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Windowed Ŝ(q) of (B, L) bucket ids against a ``WindowedAceState``
    at any γ: one ``ace_window_combine`` launch (the E-way weighted gather
    and combine), with the health mask baked into its ``table_weights``
    when ``table_mask`` (L,) is given.  The canonical order of
    ``window.ring.score_windowed``."""
    weights = _ring.epoch_weights(wstate.cursor, wstate.num_epochs, gamma)
    if table_mask is None:
        return _wc.ace_window_combine(wstate.counts, buckets, weights)
    return _wc.ace_window_combine(wstate.counts, buckets, weights,
                                  table_weights=_mask_weights(table_mask))


def _window_sums(wstate, buckets: torch.Tensor, rows: torch.Tensor,
                 tail_rows: torch.Tensor | None,
                 table_mask: torch.Tensor | None,
                 tenant_ids: torch.Tensor | None = None):
    """Pre-insert (tail_sums, live_sums) and the masked pair the decision
    uses (the same pair without a mask): the live sums in one
    ``ace_query_sum`` launch at base rows ``rows`` (masked and unmasked
    at once), the float tail gathered and summed in plain PyTorch, as
    ``ring.table_sums`` does.  ``table_mask`` is (L,), or (T, L) routed
    by ``tenant_ids``."""
    flat = _flat(wstate.counts)
    tail_g = _u.gather_rows(_flat(wstate.tail), buckets, tail_rows)
    tail_pre = torch.sum(tail_g, dim=-1)
    if table_mask is None:
        pre = (tail_pre, _q.ace_query_sum(flat, buckets, rows, scale="sum"))
        return pre, pre
    live_dec, live_pre = _q.ace_query_sum(
        flat, buckets, rows, table_mask=table_mask, tenant_ids=tenant_ids,
        scale="sum", with_unmasked=True)
    maskf = table_mask.to(torch.float32)
    if maskf.dim() == 2:
        maskf = maskf[tenant_ids.long()]
    return (tail_pre, live_pre), (torch.sum(tail_g * maskf, dim=-1),
                                  live_dec)


def ace_admit_windowed_at(wstate, q: torch.Tensor, w: torch.Tensor,
                          cfg: AceConfig, thresh: torch.Tensor, *,
                          gamma: float,
                          table_mask: torch.Tensor | None = None,
                          item_mask: torch.Tensor | None = None,
                          masked_sums: bool = True):
    """Windowed admission against a given score-space threshold: ONE hash,
    no host sync.  Scores are tail + live-epoch gathers (masked for the
    decision under ``table_mask``; ``masked_sums=False`` scores the
    unmasked sums over the healthy count instead, as the reference's
    ``WindowedAceFilter.step`` does); admitted rows go into the live epoch
    through ``ace_update`` at base row cursor·L, in place; the post-insert
    live sum (one ``ace_query_sum``) feeds ``ring.insert_stats`` with the
    unmasked scoring sums.  Returns (new_state, admit (B,) bool,
    pre-insert scores (B,))."""
    L = cfg.num_tables
    buckets = hash_dispatch(q, w, cfg.srp)
    rows = _ring.live_rows(wstate, buckets.shape[0])
    (tail_sums, live_pre), dec = _window_sums(
        wstate, buckets, rows, None, table_mask if masked_sums else None)
    scores = _ring.score_live(*dec, L, table_mask=table_mask)
    admit = scores >= thresh
    if item_mask is not None:
        admit = admit & item_mask
    flat = _u.ace_update(_flat(wstate.counts), buckets, row_mask=admit,
                         row_base=rows)
    live_post = _q.ace_query_sum(flat, buckets, rows, scale="sum")
    new_state = _ring.insert_stats(wstate, wstate.counts, admit, cfg, gamma,
                                   tail_sums, live_pre, live_post)
    return new_state, admit, scores


def ace_admit_windowed(wstate, q: torch.Tensor, w: torch.Tensor,
                       cfg: AceConfig, *, gamma: float, alpha: float,
                       warmup_items: float, rotate_every: int = 0,
                       table_mask: torch.Tensor | None = None,
                       item_mask: torch.Tensor | None = None):
    """Kernel-path windowed admission (``repro.kernels.ops
    .ace_admit_windowed``): the window-combined μ−ασ threshold on the
    device, ``ace_admit_windowed_at``, then the epoch clock
    (``ring.maybe_rotate``, a device-side select).  Returns
    (new_state, admit (B,) bool)."""
    thresh = _ring.admit_threshold_windowed(wstate, gamma, alpha,
                                            warmup_items,
                                            table_mask=table_mask)
    new_state, admit, _ = ace_admit_windowed_at(
        wstate, q, w, cfg, thresh, gamma=gamma, table_mask=table_mask,
        item_mask=item_mask)
    return _ring.maybe_rotate(new_state, rotate_every, gamma), admit


def ace_fleet_score(fstate, q: torch.Tensor, tenant_ids: torch.Tensor,
                    w: torch.Tensor, cfg: AceConfig,
                    table_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-tenant scoring of raw queries, each against its own tenant's
    tables, one hash for the batch.  Dense: one ``ace_fleet_score`` call.
    SRHT or a table mask (T, L): the one hash kernel, then one routed
    ``ace_query_sum`` launch (``fleet.state.fleet_combine``'s means)."""
    if resolve_hash_mode(cfg.srp) == "srht" or table_mask is not None:
        buckets = hash_dispatch(q, w, cfg.srp)
        return _q.ace_query_sum(
            _flat(fstate.counts), buckets,
            _fls.tenant_rows(tenant_ids, cfg.num_tables),
            table_mask=table_mask, tenant_ids=tenant_ids)
    return _fl.ace_fleet_score(fstate.counts, q, tenant_ids, w, cfg.srp)


def ace_fleet_admit_at(fstate, q: torch.Tensor, tenant_ids: torch.Tensor,
                       w: torch.Tensor, cfg: AceConfig,
                       thresh: torch.Tensor, *,
                       table_mask: torch.Tensor | None = None,
                       item_mask: torch.Tensor | None = None):
    """Multi-tenant admission against given per-item thresholds (B,): ONE
    hash, the routed ``ace_query_sum`` score at base row tid·L, the
    ``ace_update`` insert of the admitted rows there (in place), the
    post-insert ``ace_query_sum`` for the per-tenant Welford fold.
    Returns (new_state, admit (B,) bool, pre-insert scores (B,))."""
    buckets = hash_dispatch(q, w, cfg.srp)
    rows = _fls.tenant_rows(tenant_ids, cfg.num_tables)
    flat = _flat(fstate.counts)
    scores = _q.ace_query_sum(flat, buckets, rows, table_mask=table_mask,
                              tenant_ids=tenant_ids)
    admit = scores >= thresh
    if item_mask is not None:
        admit = admit & item_mask
    _u.ace_update(flat, buckets, row_mask=admit, row_base=rows)
    post = _q.ace_query_sum(flat, buckets, rows)
    tot, mean, m2 = _fls.fleet_masked_welford(
        fstate, tenant_ids, post, admit.to(torch.float32), cfg.welford_min_n)
    return fstate._replace(n=tot, welford_mean=mean, welford_m2=m2), \
        admit, scores


def ace_fleet_admit(fstate, q: torch.Tensor, tenant_ids: torch.Tensor,
                    w: torch.Tensor, cfg: AceConfig, *, alpha: float,
                    warmup_items: float,
                    table_mask: torch.Tensor | None = None,
                    item_mask: torch.Tensor | None = None):
    """Kernel-path multi-tenant admission (``repro.kernels.ops
    .ace_fleet_admit``): per-tenant μ−ασ thresholds routed to the items,
    then ``ace_fleet_admit_at``.  Returns (new_state, admit (B,) bool)."""
    thresh = _fls.admit_thresholds(fstate, alpha, warmup_items,
                                   table_mask=table_mask)[tenant_ids.long()]
    new_state, admit, _ = ace_fleet_admit_at(
        fstate, q, tenant_ids, w, cfg, thresh, table_mask=table_mask,
        item_mask=item_mask)
    return new_state, admit


def ace_fleet_window_admit(state, q: torch.Tensor, tenant_ids: torch.Tensor,
                           w: torch.Tensor, cfg: AceConfig, *, gamma: float,
                           alpha: float, warmup_items: float,
                           rotate_every: int = 0,
                           table_mask: torch.Tensor | None = None,
                           item_mask: torch.Tensor | None = None):
    """Kernel-path windowed-fleet admission (``repro.kernels.ops
    .ace_fleet_window_admit``): per-tenant windowed thresholds on the
    device, then, dense and healthy, the fused
    ``ace_fleet_window_admit_fused`` kernel (hash, tail and live gathers,
    score, threshold, masked live-epoch insert); under SRHT or a table
    mask (T, L) the one hash kernel with the routed ``ace_query_sum``
    live sums (masked for the decision) and ``ace_update`` insert.  Both
    then sum the post-insert live counters with one ``ace_query_sum`` for
    ``fleet.window.apply_insert_stats`` and run the presence-gated clocks
    (``maybe_rotate_fleet``).  Returns (new_state, admit (B,) bool)."""
    thr_t = _fw.window_admit_thresholds(state, gamma, alpha, warmup_items,
                                        table_mask=table_mask)
    rows = _fw.live_rows_fleet(state, tenant_ids)
    flat = _flat(state.counts)
    if resolve_hash_mode(cfg.srp) == "srht" or table_mask is not None:
        buckets = hash_dispatch(q, w, cfg.srp)
        (tail_sums, live_pre), dec = _window_sums(
            state, buckets, rows, _fls.tenant_rows(tenant_ids,
                                                   cfg.num_tables),
            table_mask, tenant_ids)
        if table_mask is None:
            scores = _ring.score_live(*dec, cfg.num_tables)
        else:
            mask = table_mask.to(torch.float32)[tenant_ids.long()]
            nh = torch.clamp_min(torch.sum(mask, dim=-1), 1.0)
            scores = (dec[0] + dec[1]) * (1.0 / nh)
        admit = scores >= thr_t[tenant_ids.long()]
        if item_mask is not None:
            admit = admit & item_mask
        _u.ace_update(flat, buckets, row_mask=admit, row_base=rows)
    else:
        _, _, admit, buckets, tail_sums, live_pre = \
            _fwa.ace_fleet_window_admit_fused(
                state.counts, state.tail, state.cursor, q, tenant_ids, w,
                thr_t, cfg.srp, item_mask=item_mask)
    live_post = _q.ace_query_sum(flat, buckets, rows, scale="sum")
    new_state = _fw.apply_insert_stats(state, state.counts, tenant_ids,
                                       admit, cfg, gamma, tail_sums,
                                       live_pre, live_post)
    new_state = _fw.maybe_rotate_fleet(new_state, rotate_every, gamma,
                                       tenant_ids=tenant_ids)
    return new_state, admit
