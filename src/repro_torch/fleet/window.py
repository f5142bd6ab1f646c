"""Windowed multi-tenant fleets: T independent epoch rings — port of
``repro.fleet.window``.

    counts        (T, E, L, 2^K)   per-tenant epoch rings
    n / welford_* (T, E)           per-tenant per-epoch moments
    tail          (T, L, 2^K) f32  per-tenant γ-weighted tail views
    ssq           (T,)             per-tenant ‖C_w‖² streams
    cursor        (T,)  int32      per-tenant ring pointers
    tick          (T,)  int32      per-tenant insert-step clocks
    qhist         (T, E, NUM_BINS) f32  per-tenant per-epoch rate
                  histograms when ``threshold_mode="quantile"``
    attr          (T, E, 2, NL, R, C) f32  per-tenant per-epoch
                  attribution planes when ``attr_rows > 0``

Each tenant's tick advances only on batches that held its items, and
``maybe_rotate_fleet`` rotates exactly the tenants whose live epoch just
filled, gated on presence: a tenant parked on a boundary while absent
never re-rotates from its neighbours' traffic (and keeps its histogram
rows).  Routing reuses the flat
offset twice: the live epoch of item i is rows tid·E·L + cursor[tid]·L + j
of the (T·E·L, 2^K) ring, its tail rows tid·L + j of the (T·L, 2^K) tail.

The window statistics and ``rotate`` come from ``repro_torch.window.ring``,
whose functions index the epoch axis from the end and so give the
per-tenant values for this state too.  Functions here are plain PyTorch and
functional; ``repro_torch.kernels.ops.ace_fleet_window_admit`` runs the
fused kernel and shares ``apply_insert_stats`` with ``insert_current_fleet``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import sketch as sk
from repro_torch.core.sketch import AceConfig
from repro_torch.fleet.state import (check_flat_addressable, segment_sum,
                                     tenant_onehot)
from repro_torch.kernels.ace_update import gather_rows, table_rows
from repro_torch.quantile import sketch as qsk
from repro_torch.window import ring
from repro_torch.window.ring import WindowConfig, WindowedAceState


class WindowedFleetState(NamedTuple):
    """T stacked epoch rings (``repro.fleet.window.WindowedFleetState``);
    leaf order mirrors ``WindowedAceState``."""

    counts: torch.Tensor        # (T, E, L, 2^K) int32
    n: torch.Tensor             # (T, E) float32
    welford_mean: torch.Tensor  # (T, E) float32
    welford_m2: torch.Tensor    # (T, E) float32
    tail: torch.Tensor          # (T, L, 2^K) float32
    ssq: torch.Tensor           # (T,) float32
    cursor: torch.Tensor        # (T,) int32
    tick: torch.Tensor          # (T,) int32
    qhist: Optional[torch.Tensor] = None  # (T, E, NUM_BINS) float32
    attr: Optional[torch.Tensor] = None   # (T, E, 2, NL, R, C) float32

    @property
    def num_tenants(self) -> int:
        return self.counts.shape[0]

    @property
    def num_epochs(self) -> int:
        return self.counts.shape[1]


def init_fleet_window(cfg: WindowConfig, num_tenants: int, device,
                      quantile: bool = False) -> WindowedFleetState:
    if num_tenants < 1:
        raise ValueError(f"num_tenants must be >= 1, got {num_tenants}")
    check_flat_addressable(num_tenants * cfg.num_epochs * cfg.ace.num_tables,
                           cfg.ace.num_buckets, "init_fleet_window")
    one = ring.init_window(cfg, "meta")
    state = WindowedFleetState(*(
        None if leaf is None
        else torch.zeros((num_tenants,) + tuple(leaf.shape),
                         dtype=leaf.dtype, device=device)
        for leaf in one))
    if quantile:
        state = state._replace(qhist=qsk.init_hist(
            num_tenants, cfg.num_epochs, device=device))
    return state


def tenant_window_view(state: WindowedFleetState, t: int
                       ) -> WindowedAceState:
    """Tenant t's ring as a plain ``WindowedAceState`` (views)."""
    return WindowedAceState(*(None if leaf is None else leaf[t]
                              for leaf in state))


def set_tenant_window(state: WindowedFleetState, t: int,
                      one: WindowedAceState) -> WindowedFleetState:
    """A copy of the fleet with tenant t's ring replaced by ``one``."""
    out = []
    for leaf, lf in zip(state, one):
        if leaf is None:
            out.append(None)
            continue
        leaf = leaf.clone()
        leaf[t] = lf
        out.append(leaf)
    return WindowedFleetState(*out)


# ---------------------------------------------------------------------------
# Routed scoring: tail + live gathers, both flat-offset.
# ---------------------------------------------------------------------------

def live_rows_fleet(state: WindowedFleetState,
                    tenant_ids: torch.Tensor) -> torch.Tensor:
    """(B,) int32 first ring row of each item's tenant's live epoch,
    tid·E·L + cursor[tid]·L (a device gather of the cursors)."""
    T, E, L, _ = state.counts.shape
    tids = tenant_ids.long()
    return (tids * (E * L) + state.cursor.long()[tids] * L) \
        .to(torch.int32)


def window_table_sums_fleet(state: WindowedFleetState,
                            tenant_ids: torch.Tensor, buckets: torch.Tensor,
                            table_mask: torch.Tensor | None = None):
    """Per-item (tail_sums, live_sums) against each item's own tenant's
    ring; ``table_mask`` (T, L) zeroes each item's masked tables."""
    T, E, L, nbuckets = state.counts.shape
    tail_g = gather_rows(state.tail.reshape(T * L, nbuckets), buckets,
                         tenant_ids.to(torch.int32) * L)
    live_g = gather_rows(state.counts.reshape(T * E * L, nbuckets), buckets,
                         live_rows_fleet(state, tenant_ids)).to(torch.float32)
    mask = None if table_mask is None \
        else table_mask.to(torch.float32)[tenant_ids.long()]
    return ring.table_sums(tail_g, live_g, mask)


def window_fleet_scores(state: WindowedFleetState, tenant_ids: torch.Tensor,
                        buckets: torch.Tensor,
                        table_mask: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """(B,) windowed scores, each item against its own tenant's window."""
    tail_sums, live_sums = window_table_sums_fleet(
        state, tenant_ids, buckets, table_mask=table_mask)
    if table_mask is None:
        return ring.score_live(tail_sums, live_sums, state.counts.shape[2])
    maskf = table_mask.to(torch.float32)[tenant_ids.long()]
    nh = torch.clamp_min(torch.sum(maskf, dim=-1), 1.0)
    return (tail_sums + live_sums) * (1.0 / nh)


def window_admit_thresholds(state: WindowedFleetState, gamma: float,
                            alpha: float, warmup_items: float,
                            table_mask: torch.Tensor | None = None,
                            threshold_mode: str = "mu_sigma",
                            q: float = 0.01) -> torch.Tensor:
    """(T,) per-tenant windowed thresholds: each tenant's
    ``ring.admit_threshold_windowed`` (μ−ασ, or the q-quantile of its own
    γ-combined histogram), as (T,) vectors of its operations."""
    return ring.admit_threshold_windowed(
        state, gamma, alpha, warmup_items, table_mask=table_mask,
        threshold_mode=threshold_mode, q=q)


def observe_current_fleet(state: WindowedFleetState, rates: torch.Tensor,
                          tenant_ids: torch.Tensor,
                          maskf: torch.Tensor) -> WindowedFleetState:
    """Fold a mixed-tenant batch of windowed rates into each item's
    tenant's LIVE epoch histogram row: ONE ``index_add`` at
    tid·E·NUM_BINS + cursor[tid]·NUM_BINS + bin.  ``maskf`` is the OBSERVE
    mask (finite rows), not the admit mask."""
    T, E, nb = state.qhist.shape
    tids = tenant_ids.long()
    offs = tids * (E * nb) + state.cursor.long()[tids] * nb \
        + qsk.bin_index(rates)
    return state._replace(qhist=state.qhist.reshape(-1).index_add(
        0, offs, maskf.to(torch.float32)).reshape(state.qhist.shape))


# ---------------------------------------------------------------------------
# Routed insert + per-tenant clocks.
# ---------------------------------------------------------------------------

def insert_current_fleet(state: WindowedFleetState, tenant_ids: torch.Tensor,
                         buckets: torch.Tensor, mask: torch.Tensor,
                         cfg: AceConfig, gamma: float = 1.0,
                         pre_sums=None) -> WindowedFleetState:
    """Masked mixed-batch insert into each item's tenant's LIVE epoch: one
    scatter on the (T·E·L, 2^K) ring, then ``apply_insert_stats``."""
    T, E, L, nbuckets = state.counts.shape
    if pre_sums is None:
        pre_sums = window_table_sums_fleet(state, tenant_ids, buckets)
    tail_sums, live_pre = pre_sums
    rows = table_rows(buckets, live_rows_fleet(state, tenant_ids))
    w_ctr = mask.to(state.counts.dtype)[:, None].expand(buckets.shape)
    flat = state.counts.reshape(T * E * L, nbuckets).index_put(
        (rows, buckets.long()), w_ctr, accumulate=True)
    live_post = torch.sum(flat[rows, buckets.long()].to(torch.float32),
                          dim=-1)
    return apply_insert_stats(state, flat.reshape(state.counts.shape),
                              tenant_ids, mask, cfg, gamma, tail_sums,
                              live_pre, live_post)


def apply_insert_stats(state: WindowedFleetState, new_ring: torch.Tensor,
                       tenant_ids: torch.Tensor, mask: torch.Tensor,
                       cfg: AceConfig, gamma: float,
                       tail_sums: torch.Tensor, live_pre: torch.Tensor,
                       live_post: torch.Tensor) -> WindowedFleetState:
    """Per-tenant ssq/Welford/tick advance for an already-scattered ring:
    ``ring.insert_stats`` per tenant, its sums taken as (T, B) masked
    segment reductions (bitwise per tenant), in the same association
    order.  Each PRESENT tenant's tick advances by one."""
    T, E, L, _ = state.counts.shape
    tids = tenant_ids.long()
    maskf = mask.to(torch.float32)
    onehot = tenant_onehot(tenant_ids, T)
    present = torch.sum(onehot, dim=1) > 0
    scores = ring.score_live(tail_sums, live_post, L)

    def seg(v):
        return segment_sum(onehot, v)
    new_ssq = state.ssq + 2.0 * seg(tail_sums * maskf)
    new_ssq = new_ssq + seg(live_pre * maskf)
    new_ssq = new_ssq + seg(live_post * maskf)

    b = seg(maskf)
    rows_te = ring.slab_rows(state.cursor, E)
    n_e = ring.epoch_select(state.n, state.cursor)
    tot_e = n_e + b
    n_w = ring.combined_n(state, gamma) + b
    rates = scores / torch.clamp_min(n_w, 1.0)[tids]
    mean_b = seg(rates * maskf) / torch.clamp_min(b, 1.0)
    m2_b = seg(((rates - mean_b[tids]) ** 2) * maskf)
    old_mean = ring.epoch_select(state.welford_mean, state.cursor)
    old_m2 = ring.epoch_select(state.welford_m2, state.cursor)
    new_mean, new_m2 = sk.welford_fold(old_mean, old_m2, n_e, b, tot_e,
                                       mean_b, m2_b, cfg.welford_min_n)
    has = b > 0
    new_mean = torch.where(has, new_mean, old_mean)
    new_m2 = torch.where(has, new_m2, old_m2)

    def put(x, v):
        return x.reshape(-1).index_copy(0, rows_te, v).reshape(T, E)
    return state._replace(
        counts=new_ring, n=put(state.n, tot_e),
        welford_mean=put(state.welford_mean, new_mean),
        welford_m2=put(state.welford_m2, new_m2), ssq=new_ssq,
        tick=state.tick + present.to(torch.int32))


def rotate_fleet(state: WindowedFleetState,
                 gamma: float = 1.0) -> WindowedFleetState:
    """Rotate EVERY tenant's ring once (``ring.rotate`` over the tenant
    axis: each tenant's tail recomputed from its own ring at its own new
    cursor, its new live epoch's histogram row zeroed)."""
    return ring.rotate(state, gamma)


def maybe_rotate_fleet(state: WindowedFleetState, rotate_every: int,
                       gamma: float = 1.0, *,
                       tenant_ids: torch.Tensor) -> WindowedFleetState:
    """Per-tenant rotation clocks: rotate exactly the tenants present in
    this batch whose tick says their live epoch just filled
    (``present ∧ tick > 0 ∧ tick % R == 0``; call after the insert with
    the same ``tenant_ids``).  A device-side select over all T rotated
    candidates, as in the reference: no host sync, one O(T·E·L·2^K) pass
    per call.  ``rotate_every <= 0`` is the identity."""
    if rotate_every <= 0:
        return state
    present = torch.sum(tenant_onehot(tenant_ids, state.num_tenants),
                        dim=1) > 0
    should = present & (state.tick > 0) \
        & (torch.remainder(state.tick, rotate_every) == 0)
    return ring.select(should, rotate_fleet(state, gamma), state)
