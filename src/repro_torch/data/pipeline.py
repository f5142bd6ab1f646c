"""The ACE data filter — port of ``repro.data.pipeline``'s
``mean_embed_features`` and ``AceDataFilter``.

The paper's own deployment surface: a high-rate stream where each record
is scored in O(K·L) against the sketch BEFORE it reaches the expensive
consumer.  Per-sequence feature = mean embedding plus a bias coordinate;
items below μ − α·σ are flagged (and, in filter mode, never inserted);
the sketch updates online with the items it keeps.  ``step`` is the body
of ``repro_torch.stream.StreamRunner``'s chunk loop.

``DataStream``/``synth_batch`` and the training loop that consumes the
filter belong to later slices (ROADMAP.md queue 1 item 12).
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
from repro_torch.kernels import ops as kops


def mean_embed_features(embeds: torch.Tensor,
                        bias_const: float) -> torch.Tensor:
    """(B, S, D) embeddings -> (B, D+1) unit-mean + bias features.

    Unit-normalised mean embedding + a bias coordinate: direction drift is
    what the angular SRP sees; the bias re-encodes magnitude at a
    controlled weight.
    """
    f = torch.mean(embeds.to(torch.float32), dim=1)
    f = f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-9)
    bias = torch.full((f.shape[0], 1), bias_const, dtype=torch.float32,
                      device=f.device)
    return torch.cat([f, bias], dim=-1)


@dataclasses.dataclass(frozen=True)
class AceDataFilter:
    """The flat, single-tenant, ``mu_sigma`` ACE filter with the
    reference's defaults (``repro.data.pipeline.AceDataFilter``).

    ``insert_all=True`` is detector mode: items are still flagged
    (keep=False) but every finite item is inserted.  ``use_kernels=True``
    (the default here; the reference filter has no kernel path) runs each
    step through ``repro_torch.kernels.ops``; False runs the plain sketch
    functions.  ``device`` defaults to CUDA and raises when there is none.
    ``attr_rows > 0`` puts attribution planes on the state
    (``repro_torch.attribution``, ``attr_bits`` wide rows); the
    ``StreamRunner`` fills them and names each chunk's heavy hitters.
    """

    d_model: int
    num_bits: int = 13
    num_tables: int = 32
    alpha: float = 4.0
    warmup_items: float = 512.0
    bias_const: float = 0.25
    hash_mode: str = "dense"     # "dense" | "srht" | "auto"
    insert_all: bool = False
    count_dtype: str = "int32"
    esc_capacity: int = 0
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
        cfg = self.ace_cfg          # raises for narrow planes
        srp.resolve_hash_mode(cfg.srp)      # raises for an unknown mode
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
        return AceConfig(dim=self.d_model + 1, num_bits=self.num_bits,
                         num_tables=self.num_tables, seed=29,
                         welford_min_n=self.warmup_items / 2,
                         hash_mode=self.hash_mode,
                         counter_dtype=self.count_dtype,
                         esc_capacity=self.esc_capacity,
                         attr_rows=self.attr_rows,
                         attr_bits=self.attr_bits)

    def init(self):
        """(state, w) on the filter's device.  Under the SRHT family the
        sign diagonals and row sample are put there now, so no step
        copies anything to the device."""
        cfg = self.ace_cfg
        if srp.resolve_hash_mode(cfg.srp) == "srht":
            srht.srht_params(cfg.srp).tensors(self.device)
        return (sk.init(cfg, self.device),
                sk.make_params(cfg, device=self.device))

    def features(self, embeds: torch.Tensor) -> torch.Tensor:
        """(B, S, D) embeddings -> (B, D+1) features."""
        return mean_embed_features(embeds, self.bias_const)

    def step(self, state, w: torch.Tensor, feat: torch.Tensor,
             table_mask: torch.Tensor | None = None):
        """One filter step over (B, D+1) features: hash ONCE, score from the
        same bucket ids against the PRE-insert counts, threshold on the
        device, masked insert; no host sync.

        Returns (new_state, keep (B,) bool, margin (B,) float32) where
        ``margin = score − threshold`` (+inf during warmup, when the
        threshold is −inf).  Rows with non-finite features are zeroed
        before hashing, never kept, never inserted (even under
        ``insert_all``) and get ``margin = −inf``, so drivers can count
        them as quarantined.  ``table_mask`` (L,) scores and thresholds
        over the healthy tables only.
        """
        cfg = self.ace_cfg
        finite = torch.all(torch.isfinite(feat), dim=-1)
        feat = torch.where(finite[:, None], feat, 0.0)
        thresh = sk.admit_threshold(state, self.alpha, self.warmup_items,
                                    table_mask=table_mask)
        if self.use_kernels:
            t_ins = (torch.full((), float("-inf"), device=thresh.device)
                     if self.insert_all else thresh)
            new_state, _, scores = kops.ace_admit_at(
                state, feat, w, cfg, t_ins, table_mask=table_mask,
                item_mask=finite)
            keep = (scores >= thresh) & finite
        else:
            buckets = srp.hash_buckets(feat, w, cfg.srp)   # the ONE hash
            scores = sk.lookup(state, buckets, table_mask=table_mask)
            keep = (scores >= thresh) & finite
            new_state = sk.insert_buckets_masked(
                state, buckets, finite if self.insert_all else keep, cfg)
        margin = torch.where(finite, scores - thresh, float("-inf"))
        return new_state, keep, margin

    def __call__(self, state, w: torch.Tensor, embeds: torch.Tensor,
                 mask: torch.Tensor):
        """Score + filter + update.  Returns (new_state, new_mask,
        frac_kept); mask is the (B, S) loss mask, zeroed on flagged rows."""
        new_state, keep, _ = self.step(state, w, self.features(embeds))
        new_mask = mask * keep[:, None].to(mask.dtype)
        return new_state, new_mask, torch.mean(keep.to(torch.float32))
