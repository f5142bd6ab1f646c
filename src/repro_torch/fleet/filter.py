"""Multi-tenant ACE data filter — port of ``repro.fleet.filter``, the fleet
drop-in for ``AceDataFilter``.

Same step protocol, same single hash per batch, but the state is a
``FleetState`` of T tenant sketches and every batch carries ``tenant_ids``
(B,): each item scores against its own tenant's tables and threshold
(each tenant warms up, drifts and alarms on its own), and the masked
insert scatters the whole mixed batch at once.  With ``num_tenants=1``
(all-zero ids) the filter is bitwise ``AceDataFilter``.  In quantile mode
each tenant thresholds at the ``quantile_q`` quantile of its own rate
histogram, a row of the fleet's (T, NUM_BINS) ``qhist``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.attribution import sketch as at
from repro_torch.core import sketch as sk
from repro_torch.core import srht
from repro_torch.core import srp
from repro_torch.core.sketch import AceConfig
from repro_torch.data.pipeline import mean_embed_features
from repro_torch.fleet import state as fl
from repro_torch.fleet.state import FleetConfig, FleetState
from repro_torch.kernels import ops as kops
from repro_torch.quantile import sketch as qsk


@dataclasses.dataclass(frozen=True)
class FleetDataFilter:
    """ACE anomaly filter over a tenant fleet, with the reference's
    defaults.  ``use_kernels`` and ``device`` as in ``AceDataFilter``."""

    d_model: int
    num_tenants: int = 1
    num_bits: int = 13
    num_tables: int = 32
    alpha: float = 4.0
    warmup_items: float = 512.0
    bias_const: float = 0.25
    hash_mode: str = "dense"
    insert_all: bool = False
    count_dtype: str = "int32"
    threshold_mode: str = "mu_sigma"   # "mu_sigma" | "quantile"
    quantile_q: float = 0.01    # target per-tenant flag rate
    attr_rows: int = 0          # > 0: attribution planes ride the state
    attr_bits: int = 8          # log2 columns per attribution row
    use_kernels: bool = True
    device: torch.device | str | None = None
    # the attribution hash tables on ``device`` (repro_torch.attribution
    # .AttrTables); made from the config when not given
    attr_tables: object = dataclasses.field(default=None, compare=False,
                                            repr=False)

    def __post_init__(self):
        if self.threshold_mode not in ("mu_sigma", "quantile"):
            raise ValueError(f"unknown threshold_mode "
                             f"{self.threshold_mode!r} — expected "
                             "'mu_sigma' or 'quantile'")
        cfg = self.fleet_cfg.ace          # validates T and the planes
        srp.resolve_hash_mode(cfg.srp)
        object.__setattr__(self, "device", resolve_device(self.device))
        acfg = self.ace_cfg.attr
        if acfg is not None and self.attr_tables is None:
            object.__setattr__(self, "attr_tables",
                               at.level_tables(acfg, self.device))

    @property
    def ace_cfg(self) -> AceConfig:
        # the AceDataFilter's sketch, seed included: T = 1 is that filter
        return AceConfig(dim=self.d_model + 1, num_bits=self.num_bits,
                         num_tables=self.num_tables, seed=29,
                         welford_min_n=self.warmup_items / 2,
                         hash_mode=self.hash_mode,
                         counter_dtype=self.count_dtype,
                         attr_rows=self.attr_rows,
                         attr_bits=self.attr_bits)

    @property
    def fleet_cfg(self) -> FleetConfig:
        return FleetConfig(ace=self.ace_cfg, num_tenants=self.num_tenants)

    def init(self):
        """(fleet state, w) on the filter's device, with the (T, NUM_BINS)
        histograms in quantile mode."""
        cfg = self.ace_cfg
        if srp.resolve_hash_mode(cfg.srp) == "srht":
            srht.srht_params(cfg.srp).tensors(self.device)
        return (fl.init(self.fleet_cfg, self.device,
                        quantile=self.threshold_mode == "quantile"),
                sk.make_params(cfg, device=self.device))

    def features(self, embeds: torch.Tensor) -> torch.Tensor:
        """(B, S, D) embeddings -> (B, D+1) features (the shared helper)."""
        return mean_embed_features(embeds, self.bias_const)

    def step(self, state: FleetState, w: torch.Tensor, feat: torch.Tensor,
             tenant_ids: torch.Tensor,
             table_mask: torch.Tensor | None = None,
             tenant_mask: torch.Tensor | None = None, shard=None):
        """Hash ONCE → tenant-routed score → per-tenant threshold → one
        mixed-batch masked insert; in quantile mode every finite item's
        rate (over its tenant's pre-insert n) then goes into its tenant's
        histogram, owned or not, past the half-warmup gate; no host
        sync.

        ``tenant_ids`` (B,) int32 in [0, T) on the filter's device.
        Returns (new_state, keep (B,) bool, margin (B,) float32), with the
        quarantine of non-finite rows of ``AceDataFilter.step``;
        ``table_mask`` (T, L) scores and thresholds each tenant over its
        healthy tables.  ``tenant_mask`` (T,) is the ownership mask:
        items of a tenant this replica does not own are scored (finite
        margin) but neither kept nor inserted.  ``shard`` (a
        ``ShardedSketch``) runs the step on this rank's block of a sharded
        fleet, with ``tenant_ids`` local to it."""
        cfg = self.ace_cfg
        srp.check_projections(w, cfg.srp)
        finite = torch.all(torch.isfinite(feat), dim=-1)
        feat = torch.where(finite[:, None], feat, 0.0)
        tids = tenant_ids.long()
        thresh = kops.admit_thresholds(
            state, self.alpha, self.warmup_items, table_mask=table_mask,
            threshold_mode=self.threshold_mode, q=self.quantile_q,
            shard=shard)[tids]
        owned = None if tenant_mask is None else tenant_mask[tids] > 0
        if self.use_kernels or shard is not None:
            t_ins = torch.full_like(thresh, float("-inf")) \
                if self.insert_all else thresh
            item = finite if owned is None else finite & owned
            new_state, _, scores = kops.ace_fleet_admit_at(
                state, feat, tenant_ids, w, cfg, t_ins,
                table_mask=table_mask, item_mask=item, shard=shard)
            keep = (scores >= thresh) & finite
            if owned is not None:
                keep = keep & owned
        else:
            buckets = srp.hash_buckets(feat, w, cfg.srp)   # the ONE hash
            scores = fl.fleet_scores(state, tenant_ids, buckets,
                                     table_mask=table_mask)
            keep = (scores >= thresh) & finite
            ins = finite if self.insert_all else keep
            if owned is not None:
                keep, ins = keep & owned, ins & owned
            new_state = fl.insert_masked(state, tenant_ids, buckets, ins,
                                         cfg)
        if self.threshold_mode == "quantile":
            n_t = state.n[tids]                             # pre-insert
            new_state = new_state._replace(qhist=qsk.observe_rates_fleet(
                new_state.qhist, scores / torch.clamp_min(n_t, 1.0),
                tenant_ids, qsk.calib_mask(finite.to(torch.float32), n_t,
                                           self.warmup_items)))
        margin = torch.where(finite, scores - thresh, float("-inf"))
        return new_state, keep, margin

    def __call__(self, state, w: torch.Tensor, embeds: torch.Tensor,
                 mask: torch.Tensor, tenant_ids: torch.Tensor):
        """Score + filter + update a mixed-tenant batch.  Returns
        (new_state, new_mask, frac_kept); mask is the (B, S) loss mask."""
        new_state, keep, _ = self.step(state, w, self.features(embeds),
                                       tenant_ids)
        new_mask = mask * keep[:, None].to(mask.dtype)
        return new_state, new_mask, torch.mean(keep.to(torch.float32))
