"""Multi-tenant ACE fleets: T tenants' sketches stacked on a leading axis —
port of ``repro.fleet.state``.

    counts        (T, L, 2^K)   per-tenant count arrays
    n             (T,)          per-tenant item counts
    welford_mean  (T,)          per-tenant streaming rate means
    welford_m2    (T,)          per-tenant streaming rate M2s
    attr          (T, 2, NL, R, C)  per-tenant attribution planes when
                  ``attr_rows > 0`` (``repro_torch.attribution``)

Every tenant shares one hash bank, so a mixed-tenant batch hashes once;
routing is one index computation: the fleet seen as a (T·L, 2^K) matrix
puts item i's table j at row ``tenant_ids[i]·L + j``.  Inserts are one
scatter-add at the same rows; thresholds are (T,) vectors of the same
elementwise operations as ``sketch``'s scalars, routed by
``thresholds[tenant_ids]``.

Contracts held by the tests: a fleet of one tenant is bitwise the
single-tenant ``sketch`` path; a mixed batch is bitwise per-tenant
sequential ingest (the per-tenant moment sums are rows of a (T, B) masked
reduction whose masked-out entries are exact zeros); items of tenant a
touch only tenant a's rows and stats.

Functions here are plain PyTorch and functional; the kernel path
(``repro_torch.kernels.ops.ace_fleet_admit``) gathers and inserts through
the ``ace_query``/``ace_update`` kernels with a per-item base row instead,
in place.  Tenant ids are trusted here: entry points that take them from
the host (``Guardrail.admit``, ``StreamRunner.run``) check their range
with ``check_tenant_ids`` before they reach the device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import not_ported
from repro_torch.core import sketch as sk
from repro_torch.core.sketch import AceConfig, AceState
from repro_torch.kernels.ace_update import gather_rows, table_rows

_INT32_MAX = 2**31 - 1


def check_flat_addressable(n_rows: int, nbuckets: int, what: str) -> None:
    """Raise where the stacked tables' flat space n_rows × 2^K would pass
    the int32 offset range — the reference's cap (T·L·2^K ≤ 2^31 − 1),
    kept so the two packages accept the same fleets (the port's own
    offsets are 64-bit)."""
    if n_rows * nbuckets > _INT32_MAX:
        raise ValueError(
            f"{what}: flat table space {n_rows} rows × {nbuckets} "
            f"buckets = {n_rows * nbuckets} exceeds the int32 offset "
            f"range ({_INT32_MAX}); split the fleet into several "
            "FleetStates")


def check_tenant_ids(tenant_ids, num_tenants: int, shape) -> np.ndarray:
    """Host-side check of routing ids before they go to the device:
    integers of ``shape``, every one in [0, T).  Returns them as int32."""
    tids = np.asarray(tenant_ids)
    if tids.shape != tuple(shape):
        raise ValueError(f"tenant_ids: want shape {tuple(shape)}, got "
                         f"{tids.shape}")
    if tids.size and not np.issubdtype(tids.dtype, np.integer):
        raise TypeError(f"tenant_ids must be integers, got {tids.dtype}")
    if tids.size and (tids.min() < 0 or tids.max() >= num_tenants):
        raise ValueError(f"tenant_ids must lie in [0, {num_tenants}), got "
                         f"[{tids.min()}, {tids.max()}]")
    return tids.astype(np.int32)


class FleetState(NamedTuple):
    """T stacked tenant sketches (``repro.fleet.state.FleetState``)."""

    counts: torch.Tensor        # (T, L, 2^K) int32 (or float32)
    n: torch.Tensor             # (T,) float32
    welford_mean: torch.Tensor  # (T,) float32
    welford_m2: torch.Tensor    # (T,) float32
    qhist: Optional[torch.Tensor] = None
    attr: Optional[torch.Tensor] = None   # (T, 2, NL, R, C) float32

    @property
    def num_tenants(self) -> int:
        return self.counts.shape[0]


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Static fleet configuration: every tenant shares one ``AceConfig``
    (same K, L and seed, hence the same hash functions)."""

    ace: AceConfig
    num_tenants: int

    def __post_init__(self):
        if self.num_tenants < 1:
            raise ValueError(
                f"num_tenants must be >= 1, got {self.num_tenants}")
        check_flat_addressable(self.num_tenants * self.ace.num_tables,
                               self.ace.num_buckets, "FleetConfig")

    def memory_bytes(self) -> int:
        """The fleet's device bill: T × the per-detector table."""
        return self.num_tenants * self.ace.memory_bytes()


def init(cfg: FleetConfig, device, quantile: bool = False) -> FleetState:
    if quantile:
        not_ported("threshold_mode='quantile'", 7)
    T, ace = cfg.num_tenants, cfg.ace
    zeros = torch.zeros((T,), dtype=torch.float32, device=device)
    acfg = ace.attr
    return FleetState(
        counts=torch.zeros((T, ace.num_tables, ace.num_buckets),
                           dtype=ace.torch_dtype, device=device),
        n=zeros, welford_mean=zeros.clone(), welford_m2=zeros.clone(),
        attr=None if acfg is None else torch.zeros(
            (T,) + acfg.plane_shape(), dtype=torch.float32, device=device))


def tenant_view(state: FleetState, t: int) -> AceState:
    """Tenant t's sketch as a plain ``AceState`` (views, no copy)."""
    return AceState(counts=state.counts[t], n=state.n[t],
                    welford_mean=state.welford_mean[t],
                    welford_m2=state.welford_m2[t],
                    attr=None if state.attr is None else state.attr[t])


def set_tenant(state: FleetState, t: int, ace: AceState) -> FleetState:
    """A copy of the fleet with tenant t's sketch replaced by ``ace`` (its
    attribution planes too, when both carry them)."""
    names = ["counts", "n", "welford_mean", "welford_m2"]
    if state.attr is not None and ace.attr is not None:
        names.append("attr")
    out = {}
    for name in names:
        leaf = getattr(state, name).clone()
        leaf[t] = getattr(ace, name)
        out[name] = leaf
    return state._replace(**out)


def merge_fleet(a: FleetState, b: FleetState) -> FleetState:
    """Merge two fleets over disjoint data: ``sketch.merge`` per tenant
    (counts add in int32, the Welford streams by Chan's rule, attribution
    planes add)."""
    if a.counts.shape != b.counts.shape:
        raise ValueError(f"fleet shape mismatch: {tuple(a.counts.shape)} "
                         f"vs {tuple(b.counts.shape)}")
    if (a.attr is None) != (b.attr is None):
        raise ValueError("cannot merge an attribution-tracking fleet with "
                         "a non-tracking one")
    counts = a.counts.to(torch.int32) + b.counts.to(torch.int32)
    delta = b.welford_mean - a.welford_mean
    tot = a.n + b.n
    safe = torch.clamp_min(tot, 1.0)
    return FleetState(
        counts=counts, n=tot,
        welford_mean=a.welford_mean + delta * b.n / safe,
        welford_m2=a.welford_m2 + b.welford_m2
        + delta**2 * a.n * b.n / safe,
        attr=None if a.attr is None else a.attr + b.attr)


def from_states(states: Sequence[AceState]) -> FleetState:
    """Stack single-tenant sketches into a fleet (with attribution planes
    when every one carries them)."""
    attrs = [s.attr for s in states]
    return FleetState(
        *(torch.stack([getattr(s, k) for s in states])
          for k in ("counts", "n", "welford_mean", "welford_m2")),
        attr=(torch.stack(attrs) if all(p is not None for p in attrs)
              else None))


# ---------------------------------------------------------------------------
# Tenant-routed primitives (bucket ids (B, L) + tenant ids (B,)).
# ---------------------------------------------------------------------------

def tenant_rows(tenant_ids: torch.Tensor, rows_per_tenant: int
                ) -> torch.Tensor:
    """(B,) int32 first row of each item's tenant, tid·rows_per_tenant:
    the ``row_base`` operand of the ``ace_query``/``ace_update`` kernels."""
    return (tenant_ids.to(torch.int32) * rows_per_tenant).contiguous()


def fleet_table_gather(counts: torch.Tensor, tenant_ids: torch.Tensor,
                       buckets: torch.Tensor) -> torch.Tensor:
    """counts[tid_i, j, buckets[i, j]] as one gather from the (T·L, 2^K)
    flat fleet at row tid_i·L + j: (B, L) float32."""
    T, L, nbuckets = counts.shape
    check_flat_addressable(T * L, nbuckets, "fleet_table_gather")
    return gather_rows(counts.reshape(T * L, nbuckets), buckets,
                       tenant_rows(tenant_ids, L)).to(torch.float32)


def fleet_combine(gathered: torch.Tensor, tenant_ids: torch.Tensor,
                  table_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(B, L) routed gathers -> (B,) scores: the row sum times
    float32(1/L), or with ``table_mask`` (T, L) the mean over each item's
    own tenant's healthy tables."""
    L = gathered.shape[1]
    if table_mask is None:
        return torch.sum(gathered, dim=-1) * sk.reciprocal(L)
    maskf = table_mask.to(torch.float32)[tenant_ids.long()]
    nh = torch.clamp_min(torch.sum(maskf, dim=-1), 1.0)
    return torch.sum(gathered * maskf, dim=-1) * (1.0 / nh)


def fleet_scores(state: FleetState, tenant_ids: torch.Tensor,
                 buckets: torch.Tensor,
                 table_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Each item's Ŝ(q, D_tenant) against its own tenant's sketch: (B,)."""
    return fleet_combine(fleet_table_gather(state.counts, tenant_ids,
                                            buckets),
                         tenant_ids, table_mask)


def tenant_onehot(tenant_ids: torch.Tensor, num_tenants: int
                  ) -> torch.Tensor:
    """(T, B) float32 routing matrix; row t selects tenant t's items."""
    return (torch.arange(num_tenants, device=tenant_ids.device)[:, None]
            == tenant_ids[None, :]).to(torch.float32)


def segment_sum(onehot: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(T,) per-tenant sums of a (B,) vector: rows of a (T, B) masked
    reduction (masked-out entries are exact zeros)."""
    return torch.sum(onehot * v[None, :], dim=1)


def fleet_masked_welford(state: FleetState, tenant_ids: torch.Tensor,
                         scores: torch.Tensor, maskf: torch.Tensor,
                         min_n: float):
    """Per-tenant masked Welford fold of a mixed batch: the fleet analogue
    of ``sketch.masked_batch_welford``, each item's rate normalised by its
    own tenant's post-batch n.  Tenants with no masked item keep their
    stream.  Returns (n, welford_mean, welford_m2), all (T,)."""
    onehot = tenant_onehot(tenant_ids, state.num_tenants)
    tids = tenant_ids.long()
    b = segment_sum(onehot, maskf)
    n = state.n
    tot = n + b
    rates = scores / torch.clamp_min(tot, 1.0)[tids]
    mean_b = segment_sum(onehot, rates * maskf) / torch.clamp_min(b, 1.0)
    dev = (rates - mean_b[tids]) ** 2 * maskf
    m2_b = segment_sum(onehot, dev)
    new_mean, new_m2 = sk.welford_fold(
        state.welford_mean, state.welford_m2, n, b, tot, mean_b, m2_b, min_n)
    has = b > 0
    return (tot, torch.where(has, new_mean, state.welford_mean),
            torch.where(has, new_m2, state.welford_m2))


def insert_masked(state: FleetState, tenant_ids: torch.Tensor,
                  buckets: torch.Tensor, mask: torch.Tensor,
                  cfg: AceConfig) -> FleetState:
    """Masked insert of a mixed-tenant batch: ONE scatter-add at rows
    tid·L + j of the flat fleet, post-insert scores from the same rows,
    the Welford streams folded per tenant."""
    T, L, nbuckets = state.counts.shape
    rows = table_rows(buckets, tenant_rows(tenant_ids, L))
    w_ctr = mask.to(state.counts.dtype)[:, None].expand(buckets.shape)
    new_counts = state.counts.reshape(T * L, nbuckets).index_put(
        (rows, buckets.long()), w_ctr, accumulate=True) \
        .reshape(state.counts.shape)
    scores = fleet_scores(state._replace(counts=new_counts), tenant_ids,
                          buckets)
    tot, new_mean, new_m2 = fleet_masked_welford(
        state, tenant_ids, scores, mask.to(torch.float32), cfg.welford_min_n)
    return state._replace(counts=new_counts, n=tot, welford_mean=new_mean,
                          welford_m2=new_m2)


# ---------------------------------------------------------------------------
# Per-tenant statistics and thresholds: (T,) vectors of the sketch scalars.
# ---------------------------------------------------------------------------

def mean_mu_fleet(state: FleetState,
                  table_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(T,) exact per-tenant μ = Σ‖A_j‖² / (n·L); ``table_mask`` (T, L)
    means over each tenant's healthy tables."""
    L = state.counts.shape[1]
    c = state.counts.to(torch.float32)
    if table_mask is None:
        return torch.sum(c * c, dim=(1, 2)) \
            / (torch.clamp_min(state.n, 1.0) * L)
    maskf = table_mask.to(torch.float32)
    nh = torch.clamp_min(torch.sum(maskf, dim=1), 1.0)
    per_table = torch.sum(c * c, dim=2)
    return torch.sum(per_table * maskf, dim=1) \
        / (torch.clamp_min(state.n, 1.0) * nh)


def mean_rate_fleet(state: FleetState,
                    table_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(T,) per-tenant mean collision rate μ/n."""
    return mean_mu_fleet(state, table_mask) / torch.clamp_min(state.n, 1.0)


def sigma_welford_fleet(state: FleetState) -> torch.Tensor:
    """(T,) per-tenant streaming σ of collision rates."""
    return torch.sqrt(state.welford_m2
                      / torch.clamp_min(state.n - 1.0, 1.0))


def admit_thresholds(state: FleetState, alpha: float, warmup_items: float,
                     table_mask: torch.Tensor | None = None,
                     threshold_mode: str = "mu_sigma",
                     q: float = 0.01) -> torch.Tensor:
    """(T,) per-tenant score-space thresholds: ``sketch.admit_threshold``
    over the tenant axis (−inf during each tenant's own warmup).  Route
    to items with ``admit_thresholds(...)[tenant_ids]``."""
    if threshold_mode == "quantile":
        not_ported("threshold_mode='quantile'", 7)
    if threshold_mode != "mu_sigma":
        raise ValueError(f"unknown threshold_mode {threshold_mode!r}")
    t = (mean_rate_fleet(state, table_mask) - alpha
         * sigma_welford_fleet(state)) * torch.clamp_min(state.n, 1.0)
    return torch.where(state.n >= warmup_items, t, float("-inf"))


def per_tenant_counts(tenant_ids: torch.Tensor, values: torch.Tensor,
                      num_tenants: int) -> torch.Tensor:
    """(T,) per-tenant sums of a (B,) value vector (one (T, B) reduction)."""
    return segment_sum(tenant_onehot(tenant_ids, num_tenants),
                       values.to(torch.float32))
