"""Fixed-shape streaming quantile sketch over collision rates — port of
``repro.quantile.sketch``.

The μ−ασ rule assumes a roughly Gaussian score distribution; on
heavy-tailed traffic one α over-flags some tenants and under-flags
others.  ``threshold_mode="quantile"`` flags the worst q of the traffic
instead: a per-tenant, per-epoch histogram of observed collision RATES
(score/n), whose q-quantile, moved to score space by one multiply by
max(n, 1), is the ONE score-space scalar (per tenant) the admit kernels
already take.

* The histogram is ``NUM_BINS`` float32 bins: bin 0 holds [0, RATE_MIN),
  bins 1..126 are geometric over [RATE_MIN, 1), the last bin rate ≥ 1.
  The edges are the reference's, computed in float64 and rounded to
  float32 (``_edges_np``).
* Observation is one ``index_add`` of 0/1 weights at the rates' bins (a
  fleet's or ring's rows addressed by a flat offset), so a masked-out item
  adds an exact 0.0 and unit-weight histograms stay integers (exact below
  2^24 a bin, whatever order the card's atomics add in).
* Merge is addition; a window's histogram is the γ^age-weighted sum of
  its epochs' rows (``repro_torch.window.ring.combined_qhist``).
* The read-out (``hist_quantile``) is an interpolated inverse CDF built
  from ``torch.cumsum`` and ``torch.searchsorted``, batched over any
  leading axes (the fleet's per-tenant rows), with no host sync.

Every finite item is observed, not only the admitted ones (observing the
admitted only would freeze the rejected tail out and the threshold would
creep), except while the sketch holds fewer than half the warmup
(``calib_mask``): rates against a near-empty sketch say nothing about the
traffic.

The bin table lives on the device once: ``init_hist`` puts it on its
device (cached), so a later read-out copies nothing to it.
"""
from __future__ import annotations

import numpy as np
import torch

NUM_BINS: int = 128
RATE_MIN: float = 1e-6
# bins 1..126 are geometric over [RATE_MIN, 1): 127 inner edges.
_N_INNER = NUM_BINS - 1
_RATIO = float((1.0 / RATE_MIN) ** (1.0 / (_N_INNER - 1)))
_INV_LOG_RATIO = float(1.0 / np.log(_RATIO))


def _edges_np() -> np.ndarray:
    inner = RATE_MIN * _RATIO ** np.arange(_N_INNER, dtype=np.float64)
    inner[-1] = 1.0  # close the geometric ladder exactly at 1
    return np.concatenate([[0.0], inner, [1.5]]).astype(np.float32)


_EDGES_NP = _edges_np()
# each bin's low edge and width, edges[k + 1] − edges[k] in float32 as the
# reference's read-out computes it: one gather gives both
_BINS_NP = np.stack([_EDGES_NP[:-1], _EDGES_NP[1:] - _EDGES_NP[:-1]], 1)
_ON_DEVICE: dict[tuple[str, torch.device], torch.Tensor] = {}

# float32 constants as CPU scalars: an op on a CUDA tensor reads them on
# the host, so no constant is copied to the card
_F32_RATE_MIN = torch.tensor(RATE_MIN, dtype=torch.float32)
_F32_INV_RATE_MIN = torch.tensor(1.0 / RATE_MIN, dtype=torch.float32)
_F32_INV_LOG_RATIO = torch.tensor(_INV_LOG_RATIO, dtype=torch.float32)


def _on_device(name: str, table: np.ndarray, device) -> torch.Tensor:
    """A constant table on ``device`` (default CPU), made there once."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if (name, dev) not in _ON_DEVICE:
        _ON_DEVICE[name, dev] = torch.as_tensor(table, device=dev)
    return _ON_DEVICE[name, dev]


def bin_edges(device=None) -> torch.Tensor:
    """The (NUM_BINS+1,) float32 edge vector [0, RATE_MIN .. 1, 1.5] on
    ``device`` (default CPU), made there once and cached."""
    return _on_device("edges", _EDGES_NP, device)


def init_hist(*lead: int, device=None) -> torch.Tensor:
    """A zero float32 histogram with optional leading axes:
    ``init_hist()`` (NUM_BINS,), ``init_hist(E)`` (E, NUM_BINS),
    ``init_hist(T, E)`` (T, E, NUM_BINS); the read-out's bin table is put
    on ``device`` too, so no later read-out copies anything there."""
    if torch.device("cpu" if device is None else device).type != "meta":
        _on_device("bins", _BINS_NP, device)
    return torch.zeros(tuple(lead) + (NUM_BINS,), dtype=torch.float32,
                       device=device)


def bin_index(rates: torch.Tensor) -> torch.Tensor:
    """Rates (...,) -> int64 bin ids (...,): the reference's
    floor(log(r / RATE_MIN) / log(ratio)) + 1 in float32, bin 0 below
    RATE_MIN, clipped to the last bin."""
    r = rates.to(torch.float32)
    safe = torch.maximum(r, _F32_RATE_MIN)
    k = torch.floor(torch.log(safe * _F32_INV_RATE_MIN)
                    * _F32_INV_LOG_RATIO).to(torch.int64) + 1
    return torch.where(r < _F32_RATE_MIN, 0,
                       torch.clamp(k, 1, NUM_BINS - 1))


def observe_rates(hist: torch.Tensor, rates: torch.Tensor,
                  maskf: torch.Tensor) -> torch.Tensor:
    """Fold a batch of rates into one (NUM_BINS,) histogram (a new
    tensor).  ``maskf`` is the 0/1 OBSERVE mask (finite rows); a
    masked-out item adds an exact 0.0."""
    return hist.index_add(0, bin_index(rates), maskf.to(torch.float32))


def observe_rates_fleet(hist: torch.Tensor, rates: torch.Tensor,
                        tenant_ids: torch.Tensor,
                        maskf: torch.Tensor) -> torch.Tensor:
    """Fold a mixed-tenant batch into a (T, NUM_BINS) histogram stack: ONE
    ``index_add`` at the flat offset tenant·NUM_BINS + bin."""
    offs = tenant_ids.long() * NUM_BINS + bin_index(rates)
    return hist.reshape(-1).index_add(
        0, offs, maskf.to(torch.float32)).reshape(hist.shape)


def calib_mask(maskf: torch.Tensor, n: torch.Tensor,
               warmup_items: float) -> torch.Tensor:
    """The cold-start gate of the calibration stream: ``maskf`` zeroed
    where the PRE-insert count ``n`` (a scalar, or per item for a fleet)
    is below ``warmup_items / 2``, the Welford stream's own floor."""
    armed = n.to(torch.float32) >= 0.5 * float(warmup_items)
    return maskf * armed.to(torch.float32)


def merge_hists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two histograms over disjoint data (addition)."""
    return a + b


def hist_quantile(hist: torch.Tensor, q: float) -> torch.Tensor:
    """The q-quantile rate of (..., NUM_BINS) histograms -> (...,): the
    interpolated inverse CDF of the reference, one row per leading index
    (its ``vmap``), with device ops only.  An empty histogram gives 0.0;
    any nonnegative weighting (γ-decayed rows) is a valid CDF."""
    cdf = torch.cumsum(hist.to(torch.float32), dim=-1)
    total = cdf[..., -1:]
    target = torch.tensor(q, dtype=torch.float32) * total
    idx = torch.clamp_max(torch.searchsorted(cdf, target, side="left"),
                          NUM_BINS - 1)                       # (..., 1)
    # the CDF below the bin: cdf[idx − 1], and 0 below bin 0
    prev = torch.gather(torch.nn.functional.pad(cdf, (1, 0)), -1, idx)
    inbin = torch.gather(cdf, -1, idx) - prev
    frac = torch.clamp((target - prev) / torch.clamp_min(inbin, 1e-30),
                       0.0, 1.0)
    lo_w = _on_device("bins", _BINS_NP, hist.device)[idx]   # (..., 1, 2)
    t = lo_w[..., 0] + frac * lo_w[..., 1]
    return torch.where(total > 0, t, 0.0)[..., 0]


def quantile_threshold(hist: torch.Tensor, n: torch.Tensor, q: float,
                       warmup_items: float) -> torch.Tensor:
    """Score-space threshold from a rate histogram: admit iff
    score >= Q_q(rates)·max(n, 1); −inf while n < ``warmup_items``.
    ``hist`` (..., NUM_BINS) and ``n`` (...,) give one threshold each."""
    t = hist_quantile(hist, q) * torch.clamp_min(n, 1.0)
    return torch.where(n >= warmup_items, t, float("-inf"))
