"""The ACE request guardrail: out-of-distribution requests are rejected in
O(K·L) before they reach the model (the paper's query phase as an
admission filter).  Port of ``repro.serve.engine``'s ``Guardrail`` with
int32, int16, int8 or float32 counts (``count_dtype``; the flat sketch
also with exact overflow promotion, ``esc_capacity > 0``), under either
hash family (``hash_mode`` "dense", "srht" or
"auto") and either threshold rule (``threshold_mode`` "mu_sigma" or
"quantile"), in its four flavours: the flat sketch, the sliding window
(``window_epochs > 1``), the tenant fleet (``num_tenants > 1``) and the
windowed fleet (both).  Each flavour audits its own sketch
(``health_check``), serves degraded over its healthy tables only, repairs
the corrupted ones and re-warms them (``repair``), as
``repro.resilience`` wires them into the reference's.

With a ``mesh`` the sketch is sharded over ranks
(``repro_torch.dist.sketch_parallel``): replicated, table-sharded, and
for fleets tenant-sharded or both.

``ServeEngine`` generates greedily with any model of the zoo
(``repro_torch.models``) behind an optional guardrail, and
``decode_throughput`` times its decode step.
"""
from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from repro_torch import resilience as rz, resolve_device
from repro_torch.core import capture, sketch as sk
from repro_torch.core.sketch import AceConfig
from repro_torch.core.srp import check_projections, hash_buckets
from repro_torch.data.pipeline import mean_embed_features
from repro_torch.dist import collectives as col
from repro_torch.dist.sketch_parallel import ShardedSketch
from repro_torch.fleet import state as fl
from repro_torch.fleet import window as fw
from repro_torch.kernels import ops as kops
from repro_torch.models.registry import Arch
from repro_torch.quantile import sketch as qsk
from repro_torch.window import ring


@dataclasses.dataclass(frozen=True)
class GuardrailConfig:
    """The fields of ``repro.serve.engine.GuardrailConfig`` that the port
    reads or refuses, with the reference's defaults.

    ``window_epochs > 1`` makes the sketch an epoch ring of that many
    epochs, weighted γ^age by ``window_decay`` and rotated every
    ``rotate_every`` admit calls; ``num_tenants > 1`` stacks that many
    tenant sketches (``admit`` then takes tenant ids); ``fail_policy`` is
    one policy or, for a fleet, a tuple of one per tenant.
    ``threshold_mode="quantile"`` admits iff a request's score is at
    least the ``quantile_q`` quantile of its sketch's (tenant's, window's)
    rate histogram: it flags a rate of the traffic, whatever the shape of
    the score distribution."""

    d_model: int
    num_bits: int = 13
    num_tables: int = 32
    alpha: float = 4.0
    warmup_items: float = 256.0
    bias_const: float = 0.25
    hash_mode: str = "dense"
    window_epochs: int = 1
    window_decay: float = 1.0
    rotate_every: int = 0
    num_tenants: int = 1
    count_dtype: str = "int32"  # "float32" | "int32" | "int16" | "int8"
    esc_capacity: int = 0       # > 0: exact promotion (flat sketch only)
    threshold_mode: str = "mu_sigma"   # "mu_sigma" | "quantile"
    quantile_q: float = 0.01    # target flag rate for quantile mode
    fail_policy: str | tuple = "fail_open"


class Guardrail:
    """ACE admission filter over request embeddings (stateful host wrapper).

    ``admit`` featurises a (B, S, D) batch, quarantines rows whose
    features are non-finite, hashes once, scores against the PRE-insert
    counts, compares with the on-device score threshold (μ−ασ or the
    rate quantile; −inf during warmup), and inserts the admitted rows; in
    quantile mode every finite row's pre-insert rate then goes into the
    histogram (before the rotation clock of a window).  With
    ``use_kernels=True`` (the default here; the reference defaults to
    False) the flat sketch runs the fused ``ace_admit_fused`` kernel plus
    the ``ace_query`` gather of the Welford epilogue (``ops.ace_admit``);
    the window
    ``ops.ace_admit_windowed``, the fleet ``ops.ace_fleet_admit`` and the
    windowed fleet the fused ``ace_fleet_window_admit_fused`` kernel
    (``ops.ace_fleet_window_admit``).  The only device→host transfer of a
    call is the packed (2, B) verdict + quarantine block (``_to_host``).

    Windowed (``window_epochs > 1``): the threshold comes from the
    window-combined μ/σ, admits insert into the live epoch, and every
    ``rotate_every`` admit calls the ring rotates: the reference's eager
    clock, ``ring.maybe_rotate`` (a windowed fleet's presence-gated
    per-tenant clocks: ``fleet.window.maybe_rotate_fleet``), a device-side
    select, so no admit syncs on the clock.

    Fleet (``num_tenants > 1``): ``admit(embeds, tenant_ids)`` routes each
    request to its own tenant's sketch; the ids are checked on the host
    (shape, integer, in [0, T)) before they go to the device.

    Degraded (``degraded``): after ``health_check`` finds a table failing
    its invariants, or while a repaired table re-warms, every branch
    scores and thresholds over the healthy tables only (a device float
    mask, (L,) or (T, L), handed to the same ops; the kernel branches then
    take their unfused route), still with one transfer an admit.

    ``device`` defaults to CUDA and raises when there is none; ``w``
    carries a given projection matrix (d_model + 1, P; (d_model + 1, 0)
    under SRHT) instead of drawing one.

    Compile once (``core.capture``): the admission step is one captured
    CUDA graph a signature (batch shape and dtype, tenant ids present,
    degraded or not), replayed from static buffers; ``trace_count``
    counts the programs built, as the reference's jitted admit does.  The
    state is donated: after an admit ``self.state`` is the program's
    static buffers, which the next admit of that signature overwrites,
    and a state assigned to ``self.state`` is copied in.  A host array of
    embeds (the front end's page-locked staging) is copied straight into
    the static buffer.

    Sharded (``mesh``, a live ``DeviceMesh``; one process a rank):
    ``sketch_layout`` ``"replicated"`` or ``"table_sharded"`` (the L axis
    over ``table_axis``), and for a flat fleet also ``"tenant_sharded"``
    and ``"tenant_table_sharded"`` (tenants over the ``"data"`` axis).
    Each rank holds its block of the state and admits through the
    ``repro_torch.kernels.ops`` admissions with ``shard``, the layout's
    ``ShardedSketch``: the hash, ``ace_query_sum`` partial sums with one
    (B,) all-reduce over the table axis, ``ace_update`` on its block.
    Every rank of a table group takes the same batch and returns the same
    mask, with one transfer an admit; under the tenant layouts each rank
    takes requests of its own tenants only.  W is drawn on rank 0 and
    broadcast.  The fused single-card admission is refused under a mesh,
    as the reference refuses its kernels: ``use_kernels`` defaults to None
    (the fused route without a mesh, the sharded one with it), True
    with a mesh raises and False with one takes the sharded route too.
    Sharded windowed fleets and quantized planes outside
    ``"replicated"`` are refused, as in the reference.  The audit runs on
    each rank's block: ranks holding the same tables (replicas) AND their
    verdicts in one all-reduce, the block's verdicts, repair offsets and
    n are all-gathered over the table (and tenant) axes, and every rank
    returns the whole report from the one transfer of ``health_check``.
    Each rank keeps the serving mask whole ((L,), or its tenants'
    (T_local, L)) and serves degraded with the same one transfer an
    admit; ``repair`` zeroes the rank's own corrupted tables (a ring's
    ssq re-anchored over its planes gathered whole).
    """

    def __init__(self, gcfg: GuardrailConfig, *,
                 use_kernels: bool | None = None, device=None,
                 w: torch.Tensor | None = None, mesh=None,
                 sketch_layout: str = "replicated",
                 table_axis: str = "model"):
        if gcfg.threshold_mode not in ("mu_sigma", "quantile"):
            raise ValueError(f"unknown threshold_mode "
                             f"{gcfg.threshold_mode!r} — expected "
                             "'mu_sigma' or 'quantile'")
        if mesh is not None and use_kernels:
            raise ValueError("use_kernels admission is single-device; "
                             "drop the mesh or use the jnp path")
        self.gcfg = gcfg
        self.ace_cfg = AceConfig(dim=gcfg.d_model + 1,
                                 num_bits=gcfg.num_bits,
                                 num_tables=gcfg.num_tables, seed=41,
                                 welford_min_n=gcfg.warmup_items / 2,
                                 hash_mode=gcfg.hash_mode,
                                 counter_dtype=gcfg.count_dtype,
                                 esc_capacity=gcfg.esc_capacity)
        self.windowed = gcfg.window_epochs > 1
        self.multi_tenant = gcfg.num_tenants > 1
        pol = gcfg.fail_policy
        if isinstance(pol, str):
            pol = (pol,) * max(gcfg.num_tenants, 1)
        if len(pol) != max(gcfg.num_tenants, 1):
            raise ValueError(f"fail_policy tuple has {len(pol)} entries for "
                             f"{gcfg.num_tenants} tenants")
        bad = [p for p in pol if p not in ("fail_open", "fail_closed")]
        if bad:
            raise ValueError(f"unknown fail_policy {bad[0]!r} — expected "
                             "'fail_open' or 'fail_closed'")
        self.device = resolve_device(device)
        if self.windowed:
            if gcfg.rotate_every <= 0:
                raise ValueError(
                    "windowed guardrail (window_epochs > 1) needs "
                    "rotate_every > 0 — without a rotation clock the ring "
                    "never expires and behaves like the frozen sketch")
            wcfg = ring.WindowConfig(ace=self.ace_cfg,
                                     num_epochs=gcfg.window_epochs,
                                     decay=gcfg.window_decay,
                                     rotate_every=gcfg.rotate_every)
        quantile = gcfg.threshold_mode == "quantile"
        if self.multi_tenant and self.windowed:
            state = fw.init_fleet_window(wcfg, gcfg.num_tenants, self.device,
                                         quantile=quantile)
        elif self.multi_tenant:
            state = fl.init(fl.FleetConfig(ace=self.ace_cfg,
                                           num_tenants=gcfg.num_tenants),
                            self.device, quantile=quantile)
        elif self.windowed:
            state = ring.init_window(wcfg, self.device, quantile=quantile)
        else:
            state = sk.init(self.ace_cfg, self.device)
            if quantile:
                state = state._replace(qhist=qsk.init_hist(
                    device=self.device))
        if w is not None:
            check_projections(w, self.ace_cfg.srp)
        self.w = (sk.make_params(self.ace_cfg, device=self.device) if w is None
                  else w.to(self.device, torch.float32).contiguous())
        # under a mesh the kernel path is the sharded one (``ops`` with
        # ``shard``), whatever ``use_kernels`` says short of True
        self.use_kernels = use_kernels is None or use_kernels \
            or mesh is not None
        self._shard = None
        if mesh is not None:
            if self.multi_tenant and self.windowed:
                raise NotImplementedError(
                    "sharded windowed fleets are not wired yet — "
                    "drop the mesh or use window_epochs=1")
            kind = ("fleet" if self.multi_tenant
                    else "window" if self.windowed else "flat")
            self._shard = ShardedSketch(
                self.ace_cfg, mesh, sketch_layout, kind=kind,
                table_axis=table_axis, num_tenants=gcfg.num_tenants,
                num_epochs=gcfg.window_epochs, quantile=quantile)
            state = self._shard.place(state)
            col.broadcast(self.w)     # rank 0's W: the ranks cannot drift
        self.state = state
        # one captured program a signature (the reference's jitted,
        # state-donating admit); a mesh's collectives stage through the
        # host, so a sharded guardrail runs it uncaptured
        self._program = capture.Program(
            self._admit_impl, self.device, name="Guardrail.admit",
            capture=mesh is None, consts=(0,))
        # the policy twice: on the host for the front end's sheds
        # (``fail_open_mask``, read with no device access) and on the
        # device for the quarantine select inside ``admit``
        self._fail_open_host = np.array([p == "fail_open" for p in pol])
        self._fail_open = torch.tensor(self._fail_open_host,
                                       device=self.device)
        self.quarantined = 0          # total non-finite rows seen
        # health state (repro.resilience): the serving table mask is None
        # while healthy, a device float32 (L,) / (T, L) mask while degraded
        # (under a tenant layout the rows of this rank's tenants)
        self._table_mask = None
        self._repair_offsets = None   # flat/fleet per-table n at repair
        self._rewarm_admits = 0       # windowed re-warm countdown (admits)
        self._rewarming = None        # host bool mask of re-warming tables

    @property
    def trace_count(self) -> int:
        """Admission programs built so far: one a signature (batch shape
        and dtype, tenant ids present, degraded or not), as the
        reference's jitted admit traces once a signature."""
        return self._program.trace_count

    def _admit_device(self, embeds: torch.Tensor,
                      tids: torch.Tensor | None) -> torch.Tensor:
        """The admission step on the device, through the signature's
        captured program (``core.capture``); updates ``self.state`` (the
        program's static buffers) and returns the packed (2, B) bool block
        [verdicts, finite]."""
        self.state, packed = self._program(
            self.state, self.w, embeds, tids, self._table_mask,
            flags=(self.use_kernels,))
        return packed

    def _admit_impl(self, state, w, embeds, tids, table_mask):
        """The whole admission step as one program: featurise, quarantine
        non-finite rows, admit through the flavour's branch, and answer
        quarantined rows by their fail policy.  Returns (new state, the
        packed (2, B) block)."""
        feat = mean_embed_features(embeds, self.gcfg.bias_const)
        finite = torch.all(torch.isfinite(feat), dim=-1)          # (B,)
        feat = torch.where(finite[:, None], feat, 0.0)
        state, admit = self._admit_branches(state, w, feat, finite, tids,
                                            table_mask)
        fail_open = self._fail_open[0] if tids is None \
            else self._fail_open[tids.long()]
        final = torch.where(finite, admit, fail_open)
        return state, torch.stack([final, finite])

    def _admit_branches(self, st, w, feat, finite, tids, table_mask):
        """Score → threshold → masked insert (→ in quantile mode the
        observation of every finite row's pre-insert rate) → rotation
        clock, for every sketch flavour; ``finite`` is the item mask
        (quarantined rows never admit and never insert).  ``table_mask``
        (None while healthy) restricts scores and thresholds to the
        healthy tables; a window's insert keeps the unmasked sums for its
        ssq.  Returns (new state, the admit mask)."""
        g, cfg, sh = self.gcfg, self.ace_cfg, self._shard
        gamma = g.window_decay
        mode = dict(table_mask=table_mask, threshold_mode=g.threshold_mode,
                    q=g.quantile_q)
        kmode = dict(table_mask=table_mask, item_mask=finite,
                     threshold_mode=g.threshold_mode, quantile_q=g.quantile_q)
        quantile = g.threshold_mode == "quantile"
        if self.multi_tenant and self.windowed:
            if self.use_kernels:
                st, admit = kops.ace_fleet_window_admit(
                    st, feat, tids, w, cfg, gamma=gamma, alpha=g.alpha,
                    warmup_items=g.warmup_items, rotate_every=g.rotate_every,
                    **kmode)
            else:
                buckets = hash_buckets(feat, w, cfg.srp)
                pre = fw.window_table_sums_fleet(st, tids, buckets)
                if table_mask is None:
                    scores = ring.score_live(*pre, cfg.num_tables)
                else:
                    scores = fw.window_fleet_scores(st, tids, buckets,
                                                    table_mask=table_mask)
                admit = scores >= fw.window_admit_thresholds(
                    st, gamma, g.alpha, g.warmup_items,
                    **mode)[tids.long()]
                admit = admit & finite
                new = fw.insert_current_fleet(st, tids, buckets, admit, cfg,
                                              gamma=gamma, pre_sums=pre)
                if quantile:
                    n_w = ring.combined_n(st, gamma)[tids.long()]
                    new = fw.observe_current_fleet(
                        new, scores / torch.clamp_min(n_w, 1.0), tids,
                        qsk.calib_mask(finite.to(torch.float32), n_w,
                                       g.warmup_items))
                st = fw.maybe_rotate_fleet(new, g.rotate_every, gamma,
                                           tenant_ids=tids)
        elif self.multi_tenant:
            if self.use_kernels:
                st, admit = kops.ace_fleet_admit(
                    st, feat, tids if sh is None else sh.local_tenants(tids),
                    w, cfg, alpha=g.alpha, warmup_items=g.warmup_items,
                    shard=sh, **kmode)
            else:
                buckets = hash_buckets(feat, w, cfg.srp)
                scores = fl.fleet_scores(st, tids, buckets,
                                         table_mask=table_mask)
                admit = scores >= fl.admit_thresholds(
                    st, g.alpha, g.warmup_items, **mode)[tids.long()]
                admit = admit & finite
                new = fl.insert_masked(st, tids, buckets, admit, cfg)
                if quantile:
                    n_t = st.n[tids.long()]
                    new = new._replace(qhist=qsk.observe_rates_fleet(
                        new.qhist, scores / torch.clamp_min(n_t, 1.0), tids,
                        qsk.calib_mask(finite.to(torch.float32), n_t,
                                       g.warmup_items)))
                st = new
        elif self.windowed:
            if self.use_kernels:
                st, admit = kops.ace_admit_windowed(
                    st, feat, w, cfg, gamma=gamma, alpha=g.alpha,
                    warmup_items=g.warmup_items, rotate_every=g.rotate_every,
                    shard=sh, **kmode)
            else:
                buckets = hash_buckets(feat, w, cfg.srp)
                pre = ring.window_table_sums(st, buckets)
                dec = pre if table_mask is None else ring.window_table_sums(
                    st, buckets, table_mask=table_mask)
                scores = ring.score_live(*dec, cfg.num_tables,
                                         table_mask=table_mask)
                admit = scores >= ring.admit_threshold_windowed(
                    st, gamma, g.alpha, g.warmup_items, **mode)
                admit = admit & finite
                new = ring.insert_current(st, buckets, admit, cfg,
                                          gamma=gamma, pre_sums=pre)
                if quantile:
                    n_w = ring.combined_n(st, gamma)
                    new = ring.observe_current(
                        new, scores / torch.clamp_min(n_w, 1.0),
                        qsk.calib_mask(finite.to(torch.float32), n_w,
                                       g.warmup_items))
                st = ring.maybe_rotate(new, g.rotate_every, gamma)
        elif self.use_kernels:
            st, admit = kops.ace_admit(
                st, feat, w, cfg, alpha=g.alpha,
                warmup_items=g.warmup_items, shard=sh, **kmode)
        else:
            buckets = hash_buckets(feat, w, cfg.srp)   # the ONE hash
            scores = sk.lookup(st, buckets, table_mask)
            admit = scores >= sk.admit_threshold(st, g.alpha,
                                                 g.warmup_items, **mode)
            admit = admit & finite
            new = sk.insert_buckets_masked(st, buckets, admit, cfg)
            if quantile:
                new = new._replace(qhist=qsk.observe_rates(
                    new.qhist, scores / torch.clamp_min(st.n, 1.0),
                    qsk.calib_mask(finite.to(torch.float32), st.n,
                                   g.warmup_items)))
            st = new
        return st, admit

    def admit(self, embeds, tenant_ids=None) -> np.ndarray:
        """(B, S, D) request embeddings -> (B,) bool admitted; admitted rows
        update the sketch.  A fleet takes ``tenant_ids`` (B,) integers in
        [0, num_tenants), checked here on the host.  Non-finite rows are
        quarantined (never scored against real counts, never inserted,
        counted in ``self.quarantined``) and answered by the fail policy
        (of their tenant).  While ``degraded`` the decision runs over the
        healthy tables only, with no more transfers."""
        if not isinstance(embeds, torch.Tensor):
            # a host array stays on the host: the program copies it into
            # its static buffer (without a wait from page-locked memory)
            embeds = torch.as_tensor(embeds)
        tids = None
        if self.multi_tenant:
            if tenant_ids is None:
                raise ValueError("multi-tenant guardrail needs tenant_ids")
            ids = fl.check_tenant_ids(tenant_ids, self.gcfg.num_tenants,
                                      embeds.shape[:1])
            if self._shard is not None and not self._shard.owns(ids):
                raise ValueError(
                    "tenant ids outside this rank's tenants "
                    f"[{self._shard.tenant_start}, "
                    f"{self._shard.tenant_start + self._shard.t_local}) "
                    f"under the {self._shard.layout!r} layout")
            # copied in by the program: from page-locked memory without a
            # wait on the card
            tids = torch.as_tensor(ids)
            if self.device.type == "cuda":
                tids = tids.pin_memory()
        elif tenant_ids is not None:
            raise ValueError("tenant_ids given but num_tenants == 1")
        out = _to_host(self._admit_device(embeds, tids))  # the ONE transfer
        self.quarantined += int((~out[1]).sum())
        if self._rewarm_admits > 0:
            self._rewarm_admits -= 1      # host arithmetic, no sync
        return out[0].astype(bool)

    @property
    def degraded(self) -> bool:
        """True while the serving mask excludes any table (``health_check``
        found corruption, or a repaired table is still re-warming).  Reads
        host state only."""
        return self._table_mask is not None

    @property
    def fail_open_mask(self) -> np.ndarray:
        """(T,) host bool, (1,) for one tenant: True where the tenant's
        policy is fail_open (a shed or quarantined request is admitted),
        False for fail_closed (rejected).  The open-loop front end
        (``repro_torch.serve.frontend``) answers every shed request from
        it, so it is a host array and a shed touches no device memory; a
        copy, so a caller cannot change the policy."""
        return self._fail_open_host.copy()

    def memory_bytes(self) -> int:
        """The device bill of the sketch state, from the reference's
        config formulas: the flat sketch's ``AceConfig.memory_bytes``
        (narrow planes and the escalation table included), the window's
        ``WindowConfig.memory_bytes`` (E epochs + the fp32 tail), the
        fleet's ``FleetConfig.memory_bytes``, and T windows for the
        windowed fleet."""
        g = self.gcfg
        if self.windowed:
            wcfg = ring.WindowConfig(ace=self.ace_cfg,
                                     num_epochs=g.window_epochs,
                                     decay=g.window_decay,
                                     rotate_every=g.rotate_every)
            return max(g.num_tenants, 1) * wcfg.memory_bytes()
        if self.multi_tenant:
            return fl.FleetConfig(ace=self.ace_cfg,
                                  num_tenants=g.num_tenants).memory_bytes()
        return self.ace_cfg.memory_bytes()

    def _audit(self):
        """The invariant audit on the device and its report on the host:
        (device table verdicts of this rank's block, host
        ``HealthReport`` of numpy arrays, host n, host repair offsets or
        None), in one packed transfer.  The report's verdicts, the repair
        offsets and n are packed as float32 rows, one a tenant (one for a
        flat sketch or a ring): per-table fields, then per-row scalars;
        under a mesh ``ShardedSketch.whole_audit`` ANDs them over the
        replicas and gathers them whole."""
        report = rz.health_check(self.state, self._repair_offsets)
        offs = self._repair_offsets
        rows = report.table_ok.reshape(-1, report.table_ok.shape[-1])
        per_table = [report.table_ok] + ([] if offs is None else [offs])
        per_row = [report.moments_ok, report.struct_ok] \
            + ([] if offs is None else [self.state.n])
        block = torch.cat([p.reshape(rows.shape[0], -1).to(torch.float32)
                           for p in per_table + per_row], dim=1)
        whole = block
        if self._shard is not None:
            block, whole = self._shard.whole_audit(block, len(per_table))
        table_ok = (block[:, :rows.shape[1]] > 0).reshape(
            report.table_ok.shape)
        host = _to_host(whole)                          # the ONE transfer
        L = self.gcfg.num_tables
        shape = (-1,) if self.multi_tenant else ()
        tables = host[:, :L] > 0
        moments_ok, struct_ok = (host[:, len(per_table) * L + i] > 0
                                 for i in range(2))
        report = rz.HealthReport(*(x.reshape(shape + x.shape[1:]) for x in (
            tables, moments_ok, struct_ok,
            tables.all(axis=1) & moments_ok & struct_ok)))
        if offs is None:
            return table_ok, report, None, None
        return (table_ok, report, host[:, -1].reshape(shape),
                host[:, L:2 * L].reshape(shape + (L,)))

    def health_check(self):
        """Audit the sketch invariants (``resilience.health_check``) and
        refresh the serving table mask.  A control-plane call: it brings
        the report to the host in one transfer (``admit`` never does).

        Returns the host ``HealthReport``.  Tables failing their
        invariants, and repaired tables still re-warming, are left out of
        scoring by later ``admit`` calls; once every table passes again
        (and the re-warm has elapsed) the mask drops back to None and the
        healthy route resumes."""
        _, host, n, offs = self._audit()
        serving = host.table_ok.copy()
        if offs is not None:
            # flat/fleet re-warm gate: a repaired table rejoins once it has
            # absorbed a warmup's worth of the live stream
            seen = (n[..., None] if offs.ndim == n.ndim + 1 else n) - offs
            serving &= (offs == 0) | (seen >= self.gcfg.warmup_items)
        if self._rewarm_admits > 0:
            # windowed re-warm gate: repaired ring tables stay masked until
            # the zeroed epochs have expired
            serving &= ~self._rewarming
        if serving.all():
            self._table_mask = None
        else:
            if self._shard is not None:   # the rows of this rank's tenants
                serving = self._shard.tenant_block(serving)
            self._table_mask = torch.as_tensor(serving, dtype=torch.float32,
                                               device=self.device)
        return host

    def repair(self):
        """Zero every table failing its invariants (and restart any
        poisoned Welford stream) while the healthy tables keep serving —
        the ``resilience`` repair op of this flavour.  Control-plane: the
        repaired tables stay masked until they re-warm (flat and fleet: a
        warmup's worth of stream past the repair offsets; windowed:
        ``window_epochs × rotate_every`` admits).  Returns the host
        pre-repair ``HealthReport``."""
        table_ok, host, _, _ = self._audit()
        sh = self._shard
        if self.multi_tenant and self.windowed:
            self.state = rz.repair_fleet_window(self.state, table_ok)
        elif self.multi_tenant:
            self.state, self._repair_offsets = rz.repair_fleet(
                self.state, table_ok, self._repair_offsets)
        elif self.windowed:
            self.state = rz.repair_window(
                self.state, table_ok,
                whole=None if sh is None else sh.whole_planes)
        else:
            self.state, self._repair_offsets = rz.repair_ace(
                self.state, table_ok, self._repair_offsets)
        if self.windowed and not host.table_ok.all():
            self._rewarm_admits = (self.gcfg.window_epochs
                                   * self.gcfg.rotate_every)
            self._rewarming = ~host.table_ok
        if not host.moments_ok.all():
            self.state = rz.repair_moments(self.state)
        self.health_check()
        return host


def _to_host(x: torch.Tensor) -> np.ndarray:
    """The ONE device→host transfer of an ``admit`` call (of a
    ``health_check``, outside the hot path: the packed report; and of a
    ``ServeEngine.generate``: its tokens).

    A named function, not an inline ``.cpu()``, so the one-transfer
    contract is a single call site that tests can count.
    """
    return x.cpu().numpy()


class ServeEngine:
    """Greedy generation over a fixed batch, the serving path the guardrail
    stands in front of.  Port of the reference's ``ServeEngine``; runs on
    ``device`` (CUDA unless the caller names another), where ``params``
    and the guardrail live.

    Compile once (``core.capture``): the prefill and the decode step are
    each one program, one captured CUDA graph a signature, as the
    reference jits both (``_prefill``, ``_decode``).  The prefill's key is
    the weights' and the batch's shapes (a new prompt length or batch size
    is one more program); the decode step's the cache's, the weights', the
    step's tokens and ``pos``.  The weights are adopted: the graphs read
    the caller's tensors where they lie, never cloned and never written,
    and new weights of the same shapes elsewhere are captured again with
    no new program counted, as jit does not retrace for new values.  The
    decode step's cache is its donated state; the prefill's cache (a
    clone of the graph's) is copied into it at the first step.  The two
    programs share one graph memory pool."""

    def __init__(self, arch: Arch, s_max: int = 256,
                 guardrail: Guardrail | None = None, device=None):
        self.arch = arch
        self.s_max = s_max
        self.guardrail = guardrail
        self.device = resolve_device(device)
        pool = capture.Pool()
        self._prefill = capture.Program(
            self._prefill_impl, self.device, name="ServeEngine.prefill",
            adopt=(0,), pool=pool)
        self._decode = capture.Program(
            self._decode_impl, self.device, name="ServeEngine.decode",
            adopt=(0,), pool=pool)

    @property
    def trace_counts(self) -> tuple:
        """(prefill, decode) programs built so far, as the reference's
        ``_prefill._cache_size()`` and ``_decode._cache_size()``."""
        return self._prefill.trace_count, self._decode.trace_count

    @torch.no_grad()
    def _prefill_impl(self, state, params, batch):
        return None, self.arch.prefill(params, batch, s_max=self.s_max)

    def _decode_impl(self, cache, params, batch, pos):
        return _decode_step(self.arch, cache, params, batch, pos)

    @torch.no_grad()
    def generate(self, params, batch, num_new_tokens: int,
                 prompt_len: int) -> np.ndarray:
        """Greedy decode.  Returns (B, num_new_tokens) int32.

        With a guardrail, a batch of tokens is first screened:
        ``guardrail.admit`` runs on the prompts' embedding rows
        (``params["embed"][tokens]``) and updates its sketch, but its
        verdict is not used, as in the reference (the whole batch is
        generated; ROADMAP.md queue 3 item 11).  A batch that carries
        ``"embeds"`` (whisper's {"embeds": frames, "tokens": prompts}) is
        never screened, the reference's rule (queue 3 item 14).  Then the
        prefill's program and the decode step's, once a token, run with no
        host sync: the tokens stay on the device and leave through the one
        ``_to_host`` at the end.  A decoder-only model fed embeddings
        (qwen2_vl, ``input_mode="embeds"``) cannot decode: the step feeds
        tokens, and ``embed_inputs`` raises ``KeyError: 'embeds'`` from
        the decode step's warm-up, as the reference's does (queue 3 item
        12)."""
        cfg = self.arch.cfg
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}
        if self.guardrail is not None and "embeds" not in batch:
            self.guardrail.admit(params["embed"][batch["tokens"].long()])
        _, (logits, cache) = self._prefill(None, params, batch)
        B = logits.shape[0]
        tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        toks = [tok]
        for i in range(1, num_new_tokens):
            pos = torch.full((B,), prompt_len + i - 1, dtype=torch.int32,
                             device=self.device)
            if cfg.mrope_sections is not None:
                pos = pos[None].expand(3, B)
            cache, logits = self._decode(cache, params,
                                         {"tokens": tok[:, None]}, pos)
            tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
            toks.append(tok)
        return _to_host(torch.stack(toks, dim=1))    # the ONE transfer


@torch.no_grad()
def _decode_step(arch: Arch, cache, params, batch, pos):
    """One decode step as a program's function: (new cache, logits)."""
    logits, cache = arch.decode_step(params, batch, cache, pos)
    return cache, logits


def decode_throughput(arch: Arch, params, cache, batch, pos,
                      iters: int = 8) -> float:
    """Tokens a second of ``arch.decode_step`` as one program
    (``core.capture``, built for this call, as the reference jits the step
    it times) on the host clock: the build (a warm-up step and the
    capture), then ``iters`` replays ended by a synchronise.  ``cache`` is
    read, never written: the program's state starts as the warm-up's new
    cache."""
    def wait(t):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)

    program = capture.Program(functools.partial(_decode_step, arch),
                              pos.device, name="decode_throughput",
                              adopt=(0,))
    cache, logits = program(cache, params, batch, pos)
    wait(logits)
    t0 = time.perf_counter()
    for _ in range(iters):
        cache, logits = program(cache, params, batch, pos)
    wait(logits)
    dt = (time.perf_counter() - t0) / iters
    return batch[next(iter(batch))].shape[0] / dt
