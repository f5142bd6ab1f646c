"""Fault tolerance — port of ``repro.train.fault``: the ACE gradient
monitor (``MonitorState``, ``GradMonitor``) and the host-side straggler
timer (``StepTimer``).

The per-step gradient-statistics vector (the log1p of each leaf's
gradient norm, the log1p of |loss|, a bias coordinate) is streamed into
an ACE sketch.  A healthy run concentrates in a cone of that feature
space; a corrupted step (flipped bits, a poisoned batch, an optimiser
blow-up) lands outside it, and its collision rate falls below μ − α·σ.
Policy on anomaly: skip the step (the train loop keeps the old parameters
and optimiser state) and do not insert it; ``rollback_needed`` trips after
``max_consecutive`` anomalies in a row, and the train loop restores the
last intact checkpoint (``train.checkpoint``).

The leaves are the reference's (``models.convert.reference_leaves``):
each stacked leaf's norm is over all its superblocks, in the reference's
order, so the features are the reference's.

``step`` stays on the device: no ``.item()`` and no Python branch on the
verdict.  With ``use_kernels`` (always, for CUDA tensors) it hashes once
with the ``srp_hash`` kernel, scores the pre-insert counts with one
``ace_query_sum``, decides in rate space as the reference does, inserts
with the ``ace_update`` kernel under the row mask ``~is_anom`` (the kernel
writes the counts in place, so "insert, then select the old state" is not
possible: the old counts are gone), and folds the post-insert score
(another ``ace_query_sum``) into the Welford stream through
``sketch.masked_batch_welford`` with the ``welford_min_n`` gate of the
reference's ``insert``.  Without kernels it is the plain ``sketch.score``
and ``sketch.insert``, then a select of the old state where anomalous.
Both give the same verdicts and the same integer counts.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.core import sketch as sk
from repro_torch.core.sketch import AceConfig, AceState
from repro_torch.kernels import ace_update as _u
from repro_torch.kernels import ops as kops
from repro_torch.models.convert import reference_leaves

F32 = torch.float32


class MonitorState(NamedTuple):
    ace: AceState
    anomalies: torch.Tensor       # () f32 — total anomalous steps
    consecutive: torch.Tensor     # () f32 — current anomalous run length
    warmup_left: torch.Tensor     # () f32 — steps before decisions arm


@dataclasses.dataclass(frozen=True)
class GradMonitor:
    """ACE-based training-step anomaly detector, with the reference's
    defaults (``seed=17``, ``welford_min_n = warmup``).  ``device``
    defaults to CUDA; ``use_kernels`` as in the data filters."""

    feature_dim: int
    num_bits: int = 12
    num_tables: int = 32
    alpha: float = 4.0            # μ/n − α·σ_rate decision threshold
    warmup: int = 20              # steps before decisions arm
    bias_const: float = 1.0
    max_consecutive: int = 3
    use_kernels: bool = True
    device: torch.device | str | None = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def ace_cfg(self) -> AceConfig:
        return AceConfig(dim=self.feature_dim + 1, num_bits=self.num_bits,
                         num_tables=self.num_tables, seed=17,
                         welford_min_n=float(self.warmup))

    def init(self) -> tuple[MonitorState, torch.Tensor]:
        cfg, dev = self.ace_cfg, self.device
        return MonitorState(
            ace=sk.init(cfg, dev),
            anomalies=torch.zeros((), dtype=F32, device=dev),
            consecutive=torch.zeros((), dtype=F32, device=dev),
            warmup_left=torch.full((), float(self.warmup), dtype=F32,
                                   device=dev),
        ), sk.make_params(cfg, device=dev)

    def features(self, grads, loss: torch.Tensor) -> torch.Tensor:
        """The log1p of each reference leaf's float32 gradient norm (one
        ``_foreach_norm`` over every part, a stacked leaf's norm the root
        of its parts' squared norms), truncated or zero-padded to
        ``feature_dim − 1``, then log1p|loss| and the bias: (feature_dim
        + 1,)."""
        groups = reference_leaves(grads)[: self.feature_dim - 1]
        parts = [g.to(F32) for leaf in groups for g in leaf.parts]
        norms = torch.stack(torch._foreach_norm(parts))
        return self.features_from_sq(norms * norms, groups, loss)

    def features_from_sq(self, sq: torch.Tensor, groups, loss: torch.Tensor
                         ) -> torch.Tensor:
        """``features`` from the squared norm of every part of the first
        ``feature_dim − 1`` reference leaves (``groups``), (parts,) in
        their order: a sharded step's norms, summed over the ranks."""
        sizes = [len(leaf.parts) for leaf in groups]
        vec = torch.log1p(torch.sqrt(torch.stack(
            [torch.sum(s) for s in torch.split(sq, sizes)])))
        pad = self.feature_dim - 1 - vec.shape[0]
        dev = vec.device
        return torch.cat([
            vec, torch.zeros((pad,), dtype=F32, device=dev),
            torch.log1p(torch.abs(loss.to(F32)))[None],
            torch.full((1,), self.bias_const, dtype=F32, device=dev)])

    def step(self, state: MonitorState, w: torch.Tensor, grads,
             loss: torch.Tensor):
        """Score this step's features, decide, insert the non-anomalous
        one.  Returns (new_state, is_anomaly (bool 0-d), score)."""
        return self.step_features(state, w, self.features(grads, loss)[None])

    def step_features(self, state: MonitorState, w: torch.Tensor,
                      feat: torch.Tensor, kernels: bool | None = None,
                      shard=None):
        """``step`` on a (1, feature_dim + 1) feature row.  ``kernels``
        None takes the kernels when ``use_kernels`` or on a CUDA tensor;
        False takes the plain sketch functions on any device, the version
        the kernel path is held against on the card.  ``shard`` (a
        ``repro_torch.dist.sketch_parallel.ShardedSketch``) runs the
        kernel path on this rank's block of a sharded monitor sketch."""
        cfg = self.ace_cfg
        ace = state.ace
        if kernels is None:
            kernels = self.use_kernels or feat.is_cuda or shard is not None
        if shard is not None:
            buckets = shard.buckets(feat, w)                   # the ONE hash
            score = shard.scores(ace.counts, buckets)[0]
            mu_rate = shard.mean_mu(ace) / torch.clamp_min(ace.n, 1.0)
        elif kernels:
            buckets = kops.srp_hash(feat, w, cfg.srp)          # the ONE hash
            score = kops.ace_query(ace, buckets)[0]
            mu_rate = sk.mean_rate(ace)
        else:
            score = sk.score(ace, w, feat, cfg)[0]
            mu_rate = sk.mean_rate(ace)
        # rate space: stationary stream -> meaningful σ (see sketch.py)
        rate = score / torch.clamp_min(ace.n, 1.0)
        sigma = sk.sigma_welford(ace)
        armed = state.warmup_left <= 0.0
        is_anom = armed & (rate < mu_rate - self.alpha * sigma)

        # anomalous steps are NOT inserted — they must not poison the sketch
        if kernels:
            keep = ~is_anom.reshape(1)
            counts = _u.ace_update(ace.counts, buckets, row_mask=keep)
            post = (kops.ace_query(ace._replace(counts=counts), buckets)
                    if shard is None else shard.scores(counts, buckets))
            n, mean, m2 = sk.masked_batch_welford(
                ace, post, keep.to(F32), cfg.welford_min_n)
            new_ace = ace._replace(counts=counts, n=n, welford_mean=mean,
                                   welford_m2=m2)
        else:
            ins = sk.insert(ace, w, feat, cfg)
            new_ace = ace._replace(**{
                f: torch.where(is_anom, getattr(ace, f), getattr(ins, f))
                for f in ("counts", "n", "welford_mean", "welford_m2")})
        new_state = MonitorState(
            ace=new_ace,
            anomalies=state.anomalies + is_anom.to(F32),
            consecutive=torch.where(is_anom, state.consecutive + 1.0, 0.0),
            warmup_left=torch.clamp_min(state.warmup_left - 1.0, 0.0),
        )
        return new_state, is_anom, score

    def rollback_needed(self, state: MonitorState) -> torch.Tensor:
        return state.consecutive >= self.max_consecutive


@dataclasses.dataclass
class StepTimer:
    """Host-side straggler detector: flags steps breaching the SLO."""
    slo_seconds: float
    _last: float = dataclasses.field(default_factory=time.perf_counter)
    breaches: int = 0

    def tick(self) -> bool:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        if dt > self.slo_seconds:
            self.breaches += 1
            return True
        return False
