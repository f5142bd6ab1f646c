"""Chunked streaming ingest: T batches per device loop, one host transfer
each way per chunk — port of ``repro.stream.runner`` in flat mode.

``StreamRunner.consume`` runs T steps of ``AceDataFilter.step`` (hash once
→ score from the same bucket ids → on-device μ−ασ threshold → masked
insert) over a (T, B, d) chunk that is already on the device, with no host
sync inside, and reduces the chunk to a small ``ChunkSummary`` on the
device (kept fraction, per-step anomaly counts, the top-k most anomalous
items).  ``run`` drives an iterator of batches: per chunk one stacked
host-to-device copy (``_to_device``) and one device-to-host copy of the
packed summary (``_to_host``).  On the kernel path the counts are updated
in place across the whole stream.

Meshes, fleets, windowed filters (``rotate_every``) and attribution raise
``NotImplementedError`` naming their ROADMAP.md queue item.  The
reference compiles a chunk into one program (``trace_count``); the port
runs it eagerly, and a captured CUDA graph of the chunk is ROADMAP.md
queue 1 item 3's open point.
"""
from __future__ import annotations

from typing import Iterable, NamedTuple

import numpy as np
import torch

from repro_torch import not_ported
from repro_torch.data.pipeline import AceDataFilter
from repro_torch.quantile.moments import falpha_index


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
    hh_coord/hh_est/hh_valid: heavy-hitter attribution; always None here
                 (ROADMAP.md queue 1 item 8).
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


_PACKED = ChunkSummary._fields[:10]     # the fields ``run`` transfers


class StreamRunner:
    """Chunked ingest around an ``AceDataFilter`` (flat mode).

    ``consume`` takes one (T, B, d) chunk with T = ``chunk_T``;
    ``return_masks=True`` also returns the (T, B) keep mask.
    """

    def __init__(self, filt: AceDataFilter, chunk_T: int, topk: int = 8,
                 return_masks: bool = False, *, mesh=None,
                 rotate_every: int | None = None):
        if mesh is not None:
            not_ported("sharded stream ingest (mesh)", 13)
        if hasattr(filt, "num_tenants"):
            not_ported("fleet stream ingest (num_tenants)", 6)
        if rotate_every or hasattr(filt, "num_epochs"):
            not_ported("windowed stream ingest (rotate_every)", 5)
        self.filt = filt
        self.chunk_T = int(chunk_T)
        self.topk = int(topk)
        self.return_masks = return_masks

    def init(self):
        """(state, w) on the filter's device."""
        return self.filt.init()

    def consume(self, state, w: torch.Tensor, feats: torch.Tensor,
                table_mask: torch.Tensor | None = None):
        """One chunk: feats (T, B, d) on the filter's device.  Returns
        (new_state, summary[, keeps]), all still on the device.
        ``table_mask`` (L,) scores the chunk over healthy tables only and
        sets the summary's ``degraded``."""
        if feats.ndim != 3 or feats.shape[0] != self.chunk_T:
            raise ValueError(f"want a ({self.chunk_T}, B, d) chunk, got "
                             f"{tuple(feats.shape)}")
        keeps, margins = [], []
        for t in range(self.chunk_T):
            state, keep, margin = self.filt.step(state, w, feats[t],
                                                 table_mask=table_mask)
            keeps.append(keep)
            margins.append(margin)
        keeps, margins = torch.stack(keeps), torch.stack(margins)
        summary = self._summary(state, keeps, margins, table_mask)
        if self.return_masks:
            return state, summary, keeps
        return state, summary

    def _summary(self, state, keeps: torch.Tensor, margins: torch.Tensor,
                 table_mask) -> ChunkSummary:
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
        dev = margins.device
        return ChunkSummary(
            kept_frac=torch.mean(keeps.to(torch.float32)),
            anom_counts=torch.sum(~keeps, dim=1, dtype=torch.int32),
            topk_step=torch.div(idx, B, rounding_mode="floor")
            .to(torch.int32),
            topk_item=(idx % B).to(torch.int32),
            topk_margin=topk_margin,
            n=state.n,
            quarantined=torch.sum(torch.isneginf(margins),
                                  dtype=torch.int32),
            degraded=torch.full((), table_mask is not None, dtype=torch.bool,
                                device=dev),
            falpha=falpha_index(state.counts, state.n,
                                table_mask=table_mask),
            topk_valid=torch.isfinite(topk_margin) & (topk_margin < 0.0))

    def fetch(self, summary: ChunkSummary) -> ChunkSummary:
        """The summary on the host as numpy arrays, in ONE transfer: its
        fields are packed into one byte tensor on the device."""
        fields = [getattr(summary, f) for f in _PACKED]
        packed = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                            for t in fields])
        buf = _to_host(packed)
        out, off = {}, 0
        for name, t in zip(_PACKED, fields):
            dtype = np.dtype(str(t.dtype).removeprefix("torch."))
            nbytes = t.numel() * dtype.itemsize
            out[name] = buf[off: off + nbytes].view(dtype) \
                .reshape(tuple(t.shape)).copy()
            off += nbytes
        return ChunkSummary(**out)

    def run(self, state, w: torch.Tensor, batches: Iterable[np.ndarray],
            tenant_ids=None):
        """Host driver: chunk an iterator of (B, d) feature batches and
        consume each chunk with one stacked copy to the device and one
        summary copy back.  Returns (final state, [host ChunkSummary per
        chunk]).  A trailing partial chunk (fewer than T batches) is
        dropped, as in the reference."""
        if tenant_ids is not None:
            not_ported("fleet stream ingest (tenant_ids)", 6)
        summaries = []
        buf: list[np.ndarray] = []
        for b in batches:
            buf.append(np.asarray(b, np.float32))
            if len(buf) < self.chunk_T:
                continue
            feats = _to_device(np.stack(buf), self.filt.device)
            buf.clear()
            state, summary = self.consume(state, w, feats)[:2]
            summaries.append(self.fetch(summary))
        return state, summaries


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """The ONE host-to-device transfer of a chunk (a named function, so
    tests can count it)."""
    return torch.as_tensor(x, device=device)


def _to_host(x: torch.Tensor) -> np.ndarray:
    """The ONE device-to-host transfer of a chunk's summary (a named
    function, so tests can count it)."""
    return x.cpu().numpy()
