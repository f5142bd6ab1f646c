"""The ACE request guardrail: out-of-distribution requests are rejected in
O(K·L) before they reach the model (the paper's query phase as an
admission filter).  Port of ``repro.serve.engine`` for the flat,
single-tenant, ``mu_sigma``, int32 guardrail, under either hash family
(``hash_mode`` "dense", "srht" or "auto").

``ServeEngine`` and the model zoo are not ported yet (ROADMAP.md queue 1
item 12); windows, fleets, quantile thresholds, quantized planes,
health/repair and meshes raise ``NotImplementedError`` naming the queue
item that brings them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import not_ported, resolve_device
from repro_torch.core import sketch as sk
from repro_torch.core.sketch import AceConfig
from repro_torch.core.srp import hash_buckets
from repro_torch.data.pipeline import mean_embed_features
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class GuardrailConfig:
    """The fields of ``repro.serve.engine.GuardrailConfig`` that this slice
    reads or refuses, with the reference's defaults."""

    d_model: int
    num_bits: int = 13
    num_tables: int = 32
    alpha: float = 4.0
    warmup_items: float = 256.0
    bias_const: float = 0.25
    hash_mode: str = "dense"
    window_epochs: int = 1
    num_tenants: int = 1
    count_dtype: str = "int32"
    esc_capacity: int = 0
    threshold_mode: str = "mu_sigma"
    fail_policy: str = "fail_open"


class Guardrail:
    """ACE admission filter over request embeddings (stateful host wrapper).

    ``admit`` featurises a (B, S, D) batch, quarantines rows whose
    features are non-finite, hashes once, scores against the PRE-insert
    counts, compares with the on-device μ−ασ score threshold (−inf during
    warmup), and inserts the admitted rows — with ``use_kernels=True``
    (the default here; the reference defaults to False) all of it in the
    fused ``ace_admit_fused`` kernel plus the ``ace_query`` gather of the
    Welford epilogue (under ``hash_mode="srht"``: the ``srht_hash``,
    ``ace_query`` and ``ace_update`` kernels, ``ops.ace_admit_at``).
    The only device→host transfer of a call is the
    packed (2, B) verdict + quarantine block (``_to_host``).

    ``device`` defaults to CUDA and raises when there is none; ``w``
    carries a given projection matrix (d_model + 1, P; (d_model + 1, 0)
    under SRHT) instead of
    drawing one.
    """

    def __init__(self, gcfg: GuardrailConfig, *, use_kernels: bool = True,
                 device=None, w: torch.Tensor | None = None, mesh=None):
        if gcfg.window_epochs > 1:
            not_ported("windowed guardrails (window_epochs > 1)", 5)
        if gcfg.num_tenants > 1:
            not_ported("multi-tenant guardrails (num_tenants > 1)", 6)
        if gcfg.threshold_mode == "quantile":
            not_ported("threshold_mode='quantile'", 7)
        if gcfg.threshold_mode != "mu_sigma":
            raise ValueError(f"unknown threshold_mode "
                             f"{gcfg.threshold_mode!r} — expected "
                             "'mu_sigma' or 'quantile'")
        if mesh is not None:
            not_ported("sharded guardrails (mesh)", 13)
        if gcfg.fail_policy not in ("fail_open", "fail_closed"):
            raise ValueError(f"unknown fail_policy {gcfg.fail_policy!r} — "
                             "expected 'fail_open' or 'fail_closed'")
        self.gcfg = gcfg
        self.ace_cfg = AceConfig(dim=gcfg.d_model + 1,
                                 num_bits=gcfg.num_bits,
                                 num_tables=gcfg.num_tables, seed=41,
                                 welford_min_n=gcfg.warmup_items / 2,
                                 hash_mode=gcfg.hash_mode,
                                 counter_dtype=gcfg.count_dtype,
                                 esc_capacity=gcfg.esc_capacity)
        if use_kernels and gcfg.count_dtype != "int32":
            raise ValueError("the kernels take int32 counts; use "
                             "use_kernels=False for float32 counts")
        self.device = resolve_device(device)
        self.state = sk.init(self.ace_cfg, self.device)
        self.w = (sk.make_params(self.ace_cfg, device=self.device) if w is None
                  else w.to(self.device, torch.float32).contiguous())
        self.use_kernels = use_kernels
        self._fail_open = gcfg.fail_policy == "fail_open"
        self.quarantined = 0          # total non-finite rows seen

    def _admit_device(self, embeds: torch.Tensor) -> torch.Tensor:
        """The admission step on the device; returns the packed (2, B)
        bool block [verdicts, finite]."""
        feat = mean_embed_features(embeds, self.gcfg.bias_const)
        finite = torch.all(torch.isfinite(feat), dim=-1)          # (B,)
        feat = torch.where(finite[:, None], feat, 0.0)
        cfg = self.ace_cfg
        if self.use_kernels:
            self.state, admit = kops.ace_admit(
                self.state, feat, self.w, cfg, alpha=self.gcfg.alpha,
                warmup_items=self.gcfg.warmup_items, item_mask=finite)
        else:
            buckets = hash_buckets(feat, self.w, cfg.srp)   # the ONE hash
            scores = sk.lookup(self.state, buckets)
            admit = scores >= sk.admit_threshold(
                self.state, self.gcfg.alpha, self.gcfg.warmup_items)
            admit = admit & finite
            self.state = sk.insert_buckets_masked(self.state, buckets,
                                                  admit, cfg)
        final = torch.where(finite, admit, self._fail_open)
        return torch.stack([final, finite])

    def admit(self, embeds) -> np.ndarray:
        """(B, S, D) request embeddings -> (B,) bool admitted; admitted rows
        update the sketch.  Non-finite rows are quarantined (never scored
        against real counts, never inserted, counted in
        ``self.quarantined``) and answered by ``gcfg.fail_policy``."""
        embeds = torch.as_tensor(embeds, device=self.device)
        out = _to_host(self._admit_device(embeds))   # the ONE transfer
        self.quarantined += int((~out[1]).sum())
        return out[0].astype(bool)

    def health_check(self):
        not_ported("Guardrail.health_check", 10)

    def repair(self):
        not_ported("Guardrail.repair", 10)


def _to_host(x: torch.Tensor) -> np.ndarray:
    """The ONE device→host transfer of an ``admit`` call.

    A named function, not an inline ``.cpu()``, so the one-transfer
    contract is a single call site that tests can count.
    """
    return x.cpu().numpy()
