"""Multi-tenant ACE data filter — port of ``repro.fleet.filter``, the fleet
drop-in for ``AceDataFilter``.

Same step protocol, same single hash per batch, but the state is a
``FleetState`` of T tenant sketches and every batch carries ``tenant_ids``
(B,): each item scores against its own tenant's tables and threshold
(each tenant warms up, drifts and alarms on its own), and the masked
insert scatters the whole mixed batch at once.  With ``num_tenants=1``
(all-zero ids) the filter is bitwise ``AceDataFilter``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import not_ported, resolve_device
from repro_torch.attribution import sketch as at
from repro_torch.core import sketch as sk
from repro_torch.core import srht
from repro_torch.core import srp
from repro_torch.core.sketch import AceConfig
from repro_torch.data.pipeline import mean_embed_features
from repro_torch.fleet import state as fl
from repro_torch.fleet.state import FleetConfig, FleetState
from repro_torch.kernels import ops as kops


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
    threshold_mode: str = "mu_sigma"
    attr_rows: int = 0          # > 0: attribution planes ride the state
    attr_bits: int = 8          # log2 columns per attribution row
    use_kernels: bool = True
    device: torch.device | str | None = None
    # the attribution hash tables on ``device`` (repro_torch.attribution
    # .AttrTables); made from the config when not given
    attr_tables: object = dataclasses.field(default=None, compare=False,
                                            repr=False)

    def __post_init__(self):
        if self.threshold_mode == "quantile":
            not_ported("threshold_mode='quantile'", 7)
        if self.threshold_mode != "mu_sigma":
            raise ValueError(f"unknown threshold_mode "
                             f"{self.threshold_mode!r} — expected "
                             "'mu_sigma' or 'quantile'")
        cfg = self.fleet_cfg.ace          # validates T and the planes
        srp.resolve_hash_mode(cfg.srp)
        if self.use_kernels and cfg.counter_dtype != "int32":
            raise ValueError("the kernels take int32 counts; use "
                             "use_kernels=False for float32 counts")
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
        """(fleet state, w) on the filter's device."""
        cfg = self.ace_cfg
        if srp.resolve_hash_mode(cfg.srp) == "srht":
            srht.srht_params(cfg.srp).tensors(self.device)
        return (fl.init(self.fleet_cfg, self.device),
                sk.make_params(cfg, device=self.device))

    def features(self, embeds: torch.Tensor) -> torch.Tensor:
        """(B, S, D) embeddings -> (B, D+1) features (the shared helper)."""
        return mean_embed_features(embeds, self.bias_const)

    def step(self, state: FleetState, w: torch.Tensor, feat: torch.Tensor,
             tenant_ids: torch.Tensor,
             table_mask: torch.Tensor | None = None,
             tenant_mask: torch.Tensor | None = None):
        """Hash ONCE → tenant-routed score → per-tenant μ−ασ threshold →
        one mixed-batch masked insert; no host sync.

        ``tenant_ids`` (B,) int32 in [0, T) on the filter's device.
        Returns (new_state, keep (B,) bool, margin (B,) float32), with the
        quarantine of non-finite rows of ``AceDataFilter.step``;
        ``table_mask`` (T, L) scores and thresholds each tenant over its
        healthy tables.  ``tenant_mask`` (T,) is the ownership mask:
        items of a tenant this replica does not own are scored (finite
        margin) but neither kept nor inserted."""
        cfg = self.ace_cfg
        finite = torch.all(torch.isfinite(feat), dim=-1)
        feat = torch.where(finite[:, None], feat, 0.0)
        tids = tenant_ids.long()
        thresh = fl.admit_thresholds(state, self.alpha, self.warmup_items,
                                     table_mask=table_mask)[tids]
        owned = None if tenant_mask is None else tenant_mask[tids] > 0
        if self.use_kernels:
            t_ins = torch.full_like(thresh, float("-inf")) \
                if self.insert_all else thresh
            item = finite if owned is None else finite & owned
            new_state, _, scores = kops.ace_fleet_admit_at(
                state, feat, tenant_ids, w, cfg, t_ins,
                table_mask=table_mask, item_mask=item)
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
