"""Windowed ACE data filter — port of ``repro.window.filter``, the
drift-tracking drop-in for ``AceDataFilter``.

Same step protocol (``init``, ``features``, ``step``, ``__call__``,
``ace_cfg``), same single hash per batch, but the state is a
``WindowedAceState`` ring and every statistic (score, μ, σ, threshold) is
window-combined, so the filter forgets: a stale regime ages out in
``num_epochs × rotate_every`` steps.  Rotation is not done in ``step``: it
belongs to whoever drives the stream clock (``StreamRunner(rotate_every)``
at segment boundaries, the ``Guardrail`` per admit, ``__call__`` here), so
one step is one insert tick everywhere.  With ``num_epochs=1`` the filter
is bitwise ``AceDataFilter`` (in quantile mode too: the live epoch's
histogram row is the flat filter's histogram).
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
from repro_torch.kernels import ops as kops
from repro_torch.quantile import sketch as qsk
from repro_torch.window import ring
from repro_torch.window.ring import WindowConfig, WindowedAceState


@dataclasses.dataclass(frozen=True)
class WindowedAceFilter:
    """ACE anomaly filter over a sliding epoch ring, with the reference's
    defaults.  ``use_kernels`` and ``device`` as in ``AceDataFilter``.
    ``count_dtype`` (not a field of the reference's filter, whose ring is
    int32) narrows the ring to int16 or int8 as the windowed
    ``Guardrail``'s ``count_dtype`` does; rings take no promotion."""

    d_model: int
    num_bits: int = 13
    num_tables: int = 32
    alpha: float = 4.0
    warmup_items: float = 512.0
    bias_const: float = 0.25
    hash_mode: str = "dense"
    insert_all: bool = False
    num_epochs: int = 4
    decay: float = 1.0          # γ; 1.0 = hard window
    rotate_every: int = 0       # steps per epoch (driver-enforced clock)
    threshold_mode: str = "mu_sigma"   # "mu_sigma" | "quantile": Q_q of
                                # the γ-combined window rate histogram
    quantile_q: float = 0.01    # target flag rate for quantile mode
    attr_rows: int = 0          # > 0: attribution planes ride the state
    attr_bits: int = 8          # log2 columns per attribution row
    count_dtype: str = "int32"  # the ring's counters (int16/int8 narrow)
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
        srp.resolve_hash_mode(self.window_cfg.ace.srp)   # validates all
        object.__setattr__(self, "device", resolve_device(self.device))
        acfg = self.ace_cfg.attr
        if acfg is not None and self.attr_tables is None:
            object.__setattr__(self, "attr_tables",
                               at.level_tables(acfg, self.device))

    @property
    def ace_cfg(self) -> AceConfig:
        # the AceDataFilter's sketch, seed included: E = 1 is that filter
        return AceConfig(dim=self.d_model + 1, num_bits=self.num_bits,
                         num_tables=self.num_tables, seed=29,
                         welford_min_n=self.warmup_items / 2,
                         hash_mode=self.hash_mode,
                         counter_dtype=self.count_dtype,
                         attr_rows=self.attr_rows,
                         attr_bits=self.attr_bits)

    @property
    def window_cfg(self) -> WindowConfig:
        return WindowConfig(ace=self.ace_cfg, num_epochs=self.num_epochs,
                            decay=self.decay,
                            rotate_every=self.rotate_every)

    def init(self):
        """(ring state, w) on the filter's device, with the (E, NUM_BINS)
        histogram ring in quantile mode (SRHT parameters and bin table put
        there now, so no step copies anything to the device)."""
        cfg = self.ace_cfg
        if srp.resolve_hash_mode(cfg.srp) == "srht":
            srht.srht_params(cfg.srp).tensors(self.device)
        return (ring.init_window(self.window_cfg, self.device,
                                 quantile=self.threshold_mode == "quantile"),
                sk.make_params(cfg, device=self.device))

    def features(self, embeds: torch.Tensor) -> torch.Tensor:
        """(B, S, D) embeddings -> (B, D+1) features (the shared helper)."""
        return mean_embed_features(embeds, self.bias_const)

    def step(self, state: WindowedAceState, w: torch.Tensor,
             feat: torch.Tensor, table_mask: torch.Tensor | None = None,
             shard=None):
        """Hash ONCE → window-combined score → window-combined threshold →
        masked insert into the live epoch; in quantile mode every finite
        item's rate (score over the pre-insert n_w) then goes into the live
        epoch's histogram row, past the half-warmup gate; no host sync.

        Returns (new_state, keep (B,) bool, margin (B,) float32), with the
        quarantine of non-finite rows of ``AceDataFilter.step``.
        ``table_mask`` (L,) takes the masked threshold and divides the
        score's unmasked sums by the healthy count, as the reference's
        step does (its ``ops.ace_admit_windowed`` and ``Guardrail`` mask
        the sums too — ROADMAP.md queue 3); the insert's ssq increment
        keeps the true unmasked sums.  ``shard`` (a ``ShardedSketch``)
        runs the step on this rank's block of a sharded ring."""
        cfg = self.ace_cfg
        srp.check_projections(w, cfg.srp)
        finite = torch.all(torch.isfinite(feat), dim=-1)
        feat = torch.where(finite[:, None], feat, 0.0)
        thresh = kops.admit_threshold_windowed(
            state, self.decay, self.alpha, self.warmup_items,
            table_mask=table_mask, threshold_mode=self.threshold_mode,
            q=self.quantile_q, shard=shard)
        if self.use_kernels or shard is not None:
            t_ins = (torch.full((), float("-inf"), device=thresh.device)
                     if self.insert_all else thresh)
            new_state, _, scores = kops.ace_admit_windowed_at(
                state, feat, w, cfg, t_ins, gamma=self.decay,
                table_mask=table_mask, item_mask=finite, masked_sums=False,
                shard=shard)
            keep = (scores >= thresh) & finite
        else:
            buckets = srp.hash_buckets(feat, w, cfg.srp)   # the ONE hash
            pre = ring.window_table_sums(state, buckets)
            scores = ring.score_live(*pre, cfg.num_tables,
                                     table_mask=table_mask)
            keep = (scores >= thresh) & finite
            new_state = ring.insert_current(
                state, buckets, finite if self.insert_all else keep, cfg,
                gamma=self.decay, pre_sums=pre)
        if self.threshold_mode == "quantile":
            n_w = ring.combined_n(state, self.decay)    # pre-insert
            new_state = ring.observe_current(
                new_state, scores / torch.clamp_min(n_w, 1.0),
                qsk.calib_mask(finite.to(torch.float32), n_w,
                               self.warmup_items))
        margin = torch.where(finite, scores - thresh, float("-inf"))
        return new_state, keep, margin

    def __call__(self, state, w: torch.Tensor, embeds: torch.Tensor,
                 mask: torch.Tensor):
        """Score + filter + update, then the rotation clock (the insert
        that fills an epoch rotates the ring on its way out).  Returns
        (new_state, new_mask, frac_kept)."""
        new_state, keep, _ = self.step(state, w, self.features(embeds))
        new_state = ring.maybe_rotate(new_state, self.rotate_every,
                                      self.decay)
        new_mask = mask * keep[:, None].to(mask.dtype)
        return new_state, new_mask, torch.mean(keep.to(torch.float32))
