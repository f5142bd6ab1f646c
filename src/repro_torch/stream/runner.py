"""Chunked streaming ingest: T batches per device loop, one host transfer
each way per chunk — port of ``repro.stream.runner``.

``StreamRunner.consume`` runs T steps of the filter's ``step`` (hash once
→ score from the same bucket ids → on-device μ−ασ threshold → masked
insert) over a (T, B, d) chunk that is already on the device, with no host
sync inside, and reduces the chunk to a small summary on the device
(kept fraction, per-step anomaly counts, the top-k most anomalous items).
``run`` drives an iterator of batches: per chunk one host-to-device copy
(``_to_device``) and one device-to-host copy of the packed summary
(``_to_host``).  On the kernel path the counts are updated in place
across the whole stream.

The filter decides the mode, as in the reference:

* ``AceDataFilter`` — the flat sketch, ``ChunkSummary``;
* ``WindowedAceFilter`` — the epoch ring; ``rotate_every=R`` (default:
  the filter's own) rotates the ring at segment boundaries of the chunk,
  every R steps when R divides T, or once at the chunk's end when T
  divides R, each time through the tick-gated ``ring.maybe_rotate`` (a
  device-side select: no sync), so rotations land where the per-batch
  drivers' eager clock puts them.  The summary's ``n`` is the ring total
  and its ``falpha`` is taken over the γ-combined counts;
* ``FleetDataFilter`` — the tenant fleet: each chunk carries a (T, B)
  tenant-id plane, checked on the host in ``run`` and sent to the device
  in the same one copy as the features, and the summary is a
  ``FleetChunkSummary`` with per-tenant rows.  A windowed fleet in the
  runner is refused, as in the reference.

Heavy-hitter attribution: when the filter carries attribution planes
(``attr_rows > 0``), ``consume`` ends with the reference's
``_attr_observe`` — the chunk's per-coordinate energy split into
background and flagged channels, sketched into the state's planes (the
live row of a ring, after the chunk's last rotation), and the dyadic
``find_hh`` drill-down on the chunk's drift vector — all on the device,
its results in the summary's ``hh_*`` fields (the same one transfer).

Meshes raise ``NotImplementedError`` naming their ROADMAP.md queue item.
The reference compiles a chunk into one program
(``trace_count``); the port runs it eagerly, and a captured CUDA graph of
the chunk is ROADMAP.md queue 1 item 3's open point.
"""
from __future__ import annotations

from typing import Iterable, NamedTuple

import numpy as np
import torch

from repro_torch import not_ported
from repro_torch.attribution import sketch as at
from repro_torch.fleet.state import check_tenant_ids, per_tenant_counts
from repro_torch.quantile.moments import falpha_index
from repro_torch.window import ring


class ChunkSummary(NamedTuple):
    """Everything the host learns about a chunk (``repro.stream.runner
    .ChunkSummary``'s fields); ``run`` fetches it in ONE transfer.

    kept_frac:   () float32 — fraction of the chunk's T·B items kept.
    anom_counts: (T,) int32 — items flagged per step.
    topk_step:   (k,) int32 — step index of the k most-anomalous items.
    topk_item:   (k,) int32 — row index within that step's batch.
    topk_margin: (k,) float32 — score − threshold (most negative = most
                 anomalous; +inf during warmup).  Ties rank the lower
                 flat index (step·B + row) first, as ``jax.lax.top_k``.
    n:           () float32 — sketch item count after the chunk.
    quarantined: () int32 — non-finite feature rows (margin −inf; counted
                 among the flagged, never inserted).
    degraded:    () bool — True when the chunk was scored with a health
                 mask.
    falpha:      () float32 — the α = 1.25 frequency-moment drift index of
                 the post-chunk planes (``repro_torch.quantile.moments``).
    topk_valid:  (k,) bool — True where the topk row is a genuine flagged
                 anomaly (finite negative margin), False for padding
                 (warmup +inf, quarantined rows, unflagged fill).
    hh_coord/hh_est/hh_valid: (topk,) heavy-hitter attribution — the
                 coordinates on which the chunk's flagged traffic moved
                 most (int32), their signed estimated drift energies
                 (float32) and which lanes are genuine (bool); None unless
                 the filter enables attribution (``attr_rows > 0``).
    """

    kept_frac: torch.Tensor
    anom_counts: torch.Tensor
    topk_step: torch.Tensor
    topk_item: torch.Tensor
    topk_margin: torch.Tensor
    n: torch.Tensor
    quarantined: torch.Tensor
    degraded: torch.Tensor
    falpha: torch.Tensor
    topk_valid: torch.Tensor = None
    hh_coord: torch.Tensor = None
    hh_est: torch.Tensor = None
    hh_valid: torch.Tensor = None


class FleetChunkSummary(NamedTuple):
    """The fleet summary (``repro.stream.runner.FleetChunkSummary``'s
    fields), fetched in the same ONE transfer.  The global fields are
    ``ChunkSummary``'s; per tenant:

    per_tenant_items: (T,) float32 — items routed to each tenant.
    per_tenant_kept:  (T,) float32 — of those, how many were kept.
    n:                (T,) float32 — each tenant's n after the chunk.
    misrouted:        () int32 — items of tenants outside the ownership
                      mask (scored, never kept or inserted); 0 without one.
    falpha:           (T,) float32 — each tenant's drift index.
    hh_coord/hh_est/hh_valid: (topk,) chunk-global heavy hitters, as in
                      ``ChunkSummary``; None without attribution.
    hh_tenant/hh_tenant_est: (min(topk, T),) the tenants whose flagged
                      traffic drifted most (int32) and their exact drift
                      magnitudes ‖Δ_t‖₂ (float32); None without
                      attribution.
    """

    kept_frac: torch.Tensor
    anom_counts: torch.Tensor
    topk_step: torch.Tensor
    topk_item: torch.Tensor
    topk_margin: torch.Tensor
    per_tenant_items: torch.Tensor
    per_tenant_kept: torch.Tensor
    n: torch.Tensor
    quarantined: torch.Tensor
    degraded: torch.Tensor
    misrouted: torch.Tensor
    falpha: torch.Tensor
    topk_valid: torch.Tensor = None
    hh_coord: torch.Tensor = None
    hh_est: torch.Tensor = None
    hh_valid: torch.Tensor = None
    hh_tenant: torch.Tensor = None
    hh_tenant_est: torch.Tensor = None


class StreamRunner:
    """Chunked ingest around an ``AceDataFilter``, a ``WindowedAceFilter``
    or a ``FleetDataFilter``.

    ``consume`` takes one (T, B, d) chunk with T = ``chunk_T`` (and, for a
    fleet, its (T, B) int32 tenant ids); ``return_masks=True`` also
    returns the (T, B) keep mask.
    """

    def __init__(self, filt, chunk_T: int, topk: int = 8,
                 return_masks: bool = False, *, mesh=None,
                 rotate_every: int | None = None):
        if mesh is not None:
            not_ported("sharded stream ingest (mesh)", 13)
        self.filt = filt
        self.chunk_T = int(chunk_T)
        self.topk = int(topk)
        self.return_masks = return_masks
        self.is_fleet = hasattr(filt, "num_tenants")
        self.windowed = hasattr(filt, "num_epochs")
        if rotate_every is None:
            rotate_every = int(getattr(filt, "rotate_every", 0))
        self.rotate_every = int(rotate_every)
        self.attr_cfg = (filt.ace_cfg.attr if hasattr(filt, "ace_cfg")
                         else None)
        R = self.rotate_every
        if self.is_fleet and R:
            raise NotImplementedError(
                "windowed fleets are host-driven (per-tenant clocks via "
                "repro_torch.fleet.window.maybe_rotate_fleet), as in the "
                "reference; the runner consumes flat fleets only")
        if R and not self.windowed:
            raise ValueError("rotate_every needs a windowed filter "
                             "(repro_torch.window.filter.WindowedAceFilter)"
                             "; the flat AceDataFilter has no epoch ring")
        if R and self.chunk_T % R != 0 and R % self.chunk_T != 0:
            raise ValueError(
                f"rotate_every={R} must divide or be a multiple of "
                f"chunk_T={self.chunk_T} so epoch boundaries land "
                "deterministically inside or between chunks")

    def init(self):
        """(state, w) on the filter's device."""
        return self.filt.init()

    def consume(self, state, w: torch.Tensor, feats: torch.Tensor,
                tenant_ids: torch.Tensor | None = None,
                table_mask: torch.Tensor | None = None,
                tenant_mask: torch.Tensor | None = None):
        """One chunk: feats (T, B, d) on the filter's device, plus the
        (T, B) int32 tenant ids of a fleet.  Returns
        (new_state, summary[, keeps]), all still on the device.
        ``table_mask`` ((L,), or (T, L) for a fleet) scores the chunk over
        healthy tables only and sets the summary's ``degraded``;
        ``tenant_mask`` (T,) is a fleet's ownership mask."""
        if feats.ndim != 3 or feats.shape[0] != self.chunk_T:
            raise ValueError(f"want a ({self.chunk_T}, B, d) chunk, got "
                             f"{tuple(feats.shape)}")
        if self.is_fleet:
            if tenant_ids is None or tuple(tenant_ids.shape) \
                    != tuple(feats.shape[:2]):
                raise ValueError("fleet filters need a (T, B) tenant_ids "
                                 "plane")
        elif tenant_ids is not None or tenant_mask is not None:
            raise ValueError("tenant_ids/tenant_mask given but the filter "
                             "is not a fleet")
        T, R = self.chunk_T, self.rotate_every
        gamma = getattr(self.filt, "decay", 1.0)
        keeps, margins = [], []
        for t in range(T):
            if self.is_fleet:
                state, keep, margin = self.filt.step(
                    state, w, feats[t], tenant_ids[t], table_mask=table_mask,
                    tenant_mask=tenant_mask)
            else:
                state, keep, margin = self.filt.step(state, w, feats[t],
                                                     table_mask=table_mask)
            keeps.append(keep)
            margins.append(margin)
            # the tick-gated clock at each segment boundary (R | T) or at
            # the chunk's end (T | R)
            if R and (t + 1) % min(R, T) == 0:
                state = ring.maybe_rotate(state, R, gamma)
        keeps, margins = torch.stack(keeps), torch.stack(margins)
        hh = {}
        if self.attr_cfg is not None:
            # after the chunk's last rotation: a ring observes into the
            # row its cursor then points at, as in the reference
            state, hh = self._attr_observe(
                state, feats, margins.reshape(-1),
                None if tenant_ids is None else tenant_ids.reshape(-1))
        if self.is_fleet:
            summary = self._fleet_summary(state, keeps, margins, tenant_ids,
                                          table_mask, tenant_mask, hh)
        else:
            summary = self._summary(state, keeps, margins, table_mask, hh)
        if self.return_masks:
            return state, summary, keeps
        return state, summary

    def _topk(self, keeps: torch.Tensor, margins: torch.Tensor) -> dict:
        """The fields every summary shares: kept fraction, per-step
        anomaly counts, the top-k most anomalous rows and the quarantine
        count."""
        T, B = keeps.shape
        k = min(self.topk, T * B)
        # quarantined rows carry the −inf sentinel: rank them last, with
        # the warmup +inf rows, so they never displace a real anomaly
        ranked = torch.where(torch.isneginf(margins), float("inf"),
                             margins).reshape(-1)
        # a stable ascending sort: ties keep the lower index first, as
        # jax.lax.top_k orders them (torch.topk does not)
        topk_margin, idx = torch.sort(ranked, stable=True)
        topk_margin, idx = topk_margin[:k], idx[:k]
        return dict(
            kept_frac=torch.mean(keeps.to(torch.float32)),
            anom_counts=torch.sum(~keeps, dim=1, dtype=torch.int32),
            topk_step=torch.div(idx, B, rounding_mode="floor")
            .to(torch.int32),
            topk_item=(idx % B).to(torch.int32),
            topk_margin=topk_margin,
            quarantined=torch.sum(torch.isneginf(margins),
                                  dtype=torch.int32),
            topk_valid=torch.isfinite(topk_margin) & (topk_margin < 0.0))

    def _attr_observe(self, state, feats: torch.Tensor,
                      margins_flat: torch.Tensor,
                      tenant_ids: torch.Tensor | None):
        """Fold one chunk's energy split into the state's attribution
        planes and drill down on the chunk's drift vector (the reference's
        ``_attr_observe``).  The flat path runs the same T = 1 program the
        fleet runs per tenant, so a fleet of one gives the flat path's
        bits.  Returns (state, the summary's ``hh_*`` fields)."""
        acfg, tables = self.attr_cfg, self.filt.attr_tables
        feat = feats.reshape(-1, feats.shape[-1])
        # quarantined rows carry non-finite features: their −inf margin
        # keeps them out of both channels, but inf·0 = nan would poison
        # the sums, so zero them first (the filter step's sanitize)
        finite = torch.all(torch.isfinite(feat), dim=-1)
        feat = torch.where(finite[:, None], feat, 0.0)
        nt = self.filt.num_tenants if self.is_fleet else 1
        split = at.chunk_energy(feat, margins_flat, nt, tenant_ids)
        del feat                      # the chunk-sized copy, before find_hh
        planes = at.chunk_planes(acfg, tables, split[0], split[1])
        if self.is_fleet:
            attr = at.observe_fleet(state.attr, planes)
        elif self.windowed:
            attr = at.observe_window(state.attr, planes[0], state.cursor)
        else:
            attr = at.observe_flat(state.attr, planes)
        drift = at.sketch_vector(acfg, tables, at.drift_vector(*split))
        coord, est, valid = at.find_hh(acfg, tables, drift, self.topk,
                                       use_kernels=self.filt.use_kernels)
        hh = dict(hh_coord=coord, hh_est=est, hh_valid=valid)
        if self.is_fleet:
            # the top min(topk, T) drift magnitudes, ties to the lower
            # tenant id (as jax.lax.top_k): a stable descending sort
            l2, idx = torch.sort(at.tenant_drift_l2(*split), descending=True,
                                 stable=True)
            kt = min(self.topk, nt)
            hh.update(hh_tenant=idx[:kt].to(torch.int32),
                      hh_tenant_est=l2[:kt])
        return state._replace(attr=attr), hh

    def _summary(self, state, keeps: torch.Tensor, margins: torch.Tensor,
                 table_mask, hh: dict | None = None) -> ChunkSummary:
        if self.windowed:
            gamma = self.filt.decay
            n = torch.sum(state.n)                    # the ring total
            falpha = falpha_index(ring.decayed_counts(state, gamma),
                                  ring.combined_n(state, gamma),
                                  table_mask=table_mask)
        else:
            n = state.n
            falpha = falpha_index(state.counts, state.n,
                                  table_mask=table_mask)
        return ChunkSummary(
            n=n, falpha=falpha,
            degraded=torch.full((), table_mask is not None, dtype=torch.bool,
                                device=margins.device),
            **self._topk(keeps, margins), **(hh or {}))

    def _fleet_summary(self, state, keeps: torch.Tensor,
                       margins: torch.Tensor, tenant_ids: torch.Tensor,
                       table_mask, tenant_mask,
                       hh: dict | None = None) -> FleetChunkSummary:
        nt = self.filt.num_tenants
        tids = tenant_ids.reshape(-1)
        dev = margins.device
        misrouted = torch.zeros((), dtype=torch.int32, device=dev) \
            if tenant_mask is None else torch.sum(
                tenant_mask[tids.long()] <= 0, dtype=torch.int32)
        return FleetChunkSummary(
            per_tenant_items=per_tenant_counts(tids, torch.ones_like(tids),
                                               nt),
            per_tenant_kept=per_tenant_counts(tids, keeps.reshape(-1), nt),
            n=state.n, misrouted=misrouted,
            degraded=torch.full((), table_mask is not None, dtype=torch.bool,
                                device=dev),
            falpha=falpha_index(state.counts, state.n,
                                table_mask=table_mask),
            **self._topk(keeps, margins), **(hh or {}))

    def fetch(self, summary):
        """The summary on the host as numpy arrays, in ONE transfer: its
        fields are packed into one byte tensor on the device."""
        names = [f for f in summary._fields
                 if getattr(summary, f) is not None]
        fields = [getattr(summary, f) for f in names]
        packed = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                            for t in fields])
        buf = _to_host(packed)
        out, off = {}, 0
        for name, t in zip(names, fields):
            dtype = np.dtype(str(t.dtype).removeprefix("torch."))
            nbytes = t.numel() * dtype.itemsize
            out[name] = buf[off: off + nbytes].view(dtype) \
                .reshape(tuple(t.shape)).copy()
            off += nbytes
        return type(summary)(**out)

    def run(self, state, w: torch.Tensor, batches: Iterable[np.ndarray],
            tenant_ids=None):
        """Host driver: chunk an iterator of (B, d) feature batches (and,
        for a fleet, an iterable of (B,) tenant ids beside them, each
        checked here to lie in [0, T)) and consume each chunk with one
        copy to the device and one summary copy back.  Returns (final
        state, [host summary per chunk]).  A trailing partial chunk is
        dropped, as in the reference."""
        if self.is_fleet and tenant_ids is None:
            raise ValueError("fleet filters need tenant_ids batches")
        if not self.is_fleet and tenant_ids is not None:
            raise ValueError("tenant_ids given but the filter is not a "
                             "fleet (num_tenants attribute missing)")
        summaries = []
        buf: list[np.ndarray] = []
        tbuf: list[np.ndarray] = []
        tit = iter(tenant_ids) if tenant_ids is not None else None
        for b in batches:
            b = np.asarray(b, np.float32)
            buf.append(b)
            if tit is not None:
                tbuf.append(check_tenant_ids(next(tit), self.filt.num_tenants,
                                             b.shape[:1]))
            if len(buf) < self.chunk_T:
                continue
            if self.is_fleet:
                feats, tids = self._upload_fleet(buf, tbuf)
                tbuf.clear()
                out = self.consume(state, w, feats, tids)
            else:
                out = self.consume(state, w, _to_device(np.stack(buf),
                                                        self.filt.device))
            buf.clear()
            state = out[0]
            summaries.append(self.fetch(out[1]))
        return state, summaries

    def _upload_fleet(self, buf: list[np.ndarray], tbuf: list[np.ndarray]):
        """A fleet chunk's features and tenant ids in ONE host-to-device
        copy: one float32 buffer holding the (T, B, d) features then the
        (T, B) int32 ids' bits, split on the device into two contiguous
        views."""
        T = len(buf)
        B, d = buf[0].shape
        n = T * B * d
        host = np.empty(n + T * B, np.float32)
        feats = host[:n].reshape(T, B, d)
        for t, b in enumerate(buf):
            feats[t] = b
        host[n:].view(np.int32).reshape(T, B)[:] = np.stack(tbuf)
        dev = _to_device(host, self.filt.device)
        return (dev[:n].view(T, B, d),
                dev[n:].view(torch.int32).view(T, B))


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """The ONE host-to-device transfer of a chunk (a named function, so
    tests can count it)."""
    return torch.as_tensor(x, device=device)


def _to_host(x: torch.Tensor) -> np.ndarray:
    """The ONE device-to-host transfer of a chunk's summary (a named
    function, so tests can count it)."""
    return x.cpu().numpy()
