"""Sliding-window ACE: a device-resident ring of sketch epochs — port of
``repro.window.ring``.

Counts are an additive monoid, so a window is a SUM OF EPOCH SKETCHES and
expiry is zeroing one epoch.  ``WindowedAceState`` holds E epoch sketches
on a leading axis plus a maintained γ-weighted TAIL view, so the hot path
never recombines epochs:

    counts        (E, L, 2^K)   per-epoch count arrays
    n             (E,)          per-epoch item counts
    welford_mean  (E,)          per-epoch streaming rate mean
    welford_m2    (E,)          per-epoch streaming rate M2
    tail          (L, 2^K) f32  Σ_{e≠cursor} γ^age · C_e  (maintained)
    ssq           ()       f32  ‖C_w‖², C_w = tail + C_cursor
    cursor        ()  int32     index of the LIVE epoch
    tick          ()  int32     insert steps since init (drives rotation)

An insert is one scatter into the live epoch (rows cursor·L + j of the
ring seen as an (E·L, 2^K) matrix); a windowed score is the live gather
plus one gather of the frozen tail.  ``rotate`` moves the cursor, zeroes
the epoch it moves into and recomputes the tail from the epochs once per
epoch.

Every function here is plain PyTorch and functional, reads the cursor as
a device tensor (index ops, never ``int(cursor)``) and so never syncs with
the host.  The kernel path (``repro_torch.kernels.ops.ace_admit_windowed``)
gathers and inserts through the kernels instead and shares the stats
epilogue ``insert_stats`` with ``insert_current``.

The window statistics (``epoch_weights``, ``combined_n``,
``combined_qhist``, ``decayed_counts``, ``combined_moments``,
``mean_mu_windowed``, ``sigma_windowed``, ``admit_threshold_windowed``)
and ``rotate`` index the epoch axis from the end, so they take a
``WindowedFleetState`` (``repro_torch.fleet.window``, a (T,) leading
tenant axis) as well and give the per-tenant values with the same
elementwise operations — the port's counterpart of the reference's
``vmap``.  Sums over the E epochs
are explicit loops in ring-index order, so a fleet of one tenant and a
single ring give the same bits on any device.

γ < 1 makes the tail a float combination, recomputed here in ring-index
order (Σ_e w_e·C_e as E multiply-adds), while the reference contracts with
XLA's ``tensordot``: the two agree to float tolerance at γ < 1 and bitwise
at γ = 1, where every value is an integer below 2^24.

``qhist`` is the (E, NUM_BINS) ring of rate histograms of
``threshold_mode="quantile"`` (``init(..., quantile=True)``): callers
observe into the live row (``observe_current``), the window's histogram
is the γ^age-weighted sum of the rows (``combined_qhist``), and
``rotate`` zeroes the row it moves into.  ``attr`` is the
(E, 2, NL, R, C) ring of attribution planes when ``attr_rows > 0``
(``repro_torch.attribution``): the runner adds a chunk's planes to the
live row, and ``rotate`` zeroes the row it moves into, as it zeroes the
counts.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import sketch as sk
from repro_torch.core.sketch import AceConfig, AceState
from repro_torch.kernels.ace_update import gather_rows, table_rows
from repro_torch.quantile import sketch as qsk


class WindowedAceState(NamedTuple):
    """Ring of E epoch sketches + the maintained γ-weighted tail view
    (``repro.window.ring.WindowedAceState``'s fields)."""

    counts: torch.Tensor        # (E, L, 2^K) int32, int16, int8 or float32
    n: torch.Tensor             # (E,) float32
    welford_mean: torch.Tensor  # (E,) float32
    welford_m2: torch.Tensor    # (E,) float32
    tail: torch.Tensor          # (L, 2^K) float32
    ssq: torch.Tensor           # () float32
    cursor: torch.Tensor        # () int32
    tick: torch.Tensor          # () int32
    qhist: Optional[torch.Tensor] = None  # (E, NUM_BINS) float32
    attr: Optional[torch.Tensor] = None   # (E, 2, NL, R, C) float32

    @property
    def num_epochs(self) -> int:
        return self.counts.shape[-3]


@dataclasses.dataclass(frozen=True)
class WindowConfig:
    """Static window configuration (``repro.window.ring.WindowConfig``).

    decay γ weighs epoch e by γ^age in the window combine (1 = the hard
    window); rotate_every is the number of insert steps per epoch (0 =
    never rotate)."""

    ace: AceConfig
    num_epochs: int = 4
    decay: float = 1.0
    rotate_every: int = 0

    def __post_init__(self):
        if self.num_epochs < 1:
            raise ValueError(f"num_epochs must be >= 1, got {self.num_epochs}")
        if not (0.0 < self.decay <= 1.0):
            raise ValueError(f"decay must be in (0, 1], got {self.decay}")
        if self.ace.esc_capacity > 0:
            raise NotImplementedError(
                "overflow promotion (esc_capacity > 0) is wired for the "
                "flat sketch only; window rings take narrow count dtypes "
                "without an escalation table (exact below saturation). "
                "See docs/ARCHITECTURE.md §7.")

    def memory_bytes(self) -> int:
        """The window's device bill: E epochs + the f32 tail view."""
        ace = self.ace
        tail = ace.num_tables * ace.num_buckets * 4
        return self.num_epochs * ace.memory_bytes() + tail


def init(cfg: AceConfig, num_epochs: int, device,
         quantile: bool = False) -> WindowedAceState:
    if num_epochs < 1:
        raise ValueError(f"num_epochs must be >= 1, got {num_epochs}")
    if cfg.esc_capacity > 0:
        raise NotImplementedError(
            "overflow promotion (esc_capacity > 0) is flat-sketch only; "
            "window rings take narrow count dtypes without promotion")
    shape = (cfg.num_tables, cfg.num_buckets)

    def zeros(*s, dtype=torch.float32):
        return torch.zeros(s, dtype=dtype, device=device)
    acfg = cfg.attr
    return WindowedAceState(
        counts=zeros(num_epochs, *shape, dtype=cfg.torch_dtype),
        n=zeros(num_epochs), welford_mean=zeros(num_epochs),
        welford_m2=zeros(num_epochs), tail=zeros(*shape), ssq=zeros(),
        cursor=zeros(dtype=torch.int32), tick=zeros(dtype=torch.int32),
        qhist=qsk.init_hist(num_epochs, device=device) if quantile
        else None,
        attr=None if acfg is None else zeros(num_epochs,
                                             *acfg.plane_shape()))


def init_window(cfg: WindowConfig, device,
                quantile: bool = False) -> WindowedAceState:
    return init(cfg.ace, cfg.num_epochs, device, quantile=quantile)


# ---------------------------------------------------------------------------
# Helpers shared with the fleet.
# ---------------------------------------------------------------------------

def slab_rows(cursor: torch.Tensor, num_epochs: int) -> torch.Tensor:
    """Flat indices of the epoch each ring's ``cursor`` points at, in the
    ring's epochs stacked on one axis: (1,) for a single ring, (T,) for a
    fleet (tenant t's epoch c is slab t·E + c).  int64, on the device."""
    c = cursor.reshape(-1).long()
    return torch.arange(c.shape[0], device=c.device) * num_epochs + c


def epoch_select(x: torch.Tensor, cursor: torch.Tensor) -> torch.Tensor:
    """x[..., cursor] for a per-epoch vector (E,) or (T, E): the live
    epoch's entry, () or (T,), as a gather (no host sync)."""
    E = x.shape[-1]
    return x.reshape(-1).index_select(0, slab_rows(cursor, E)) \
        .reshape(cursor.shape)


def select(should: torch.Tensor, new, old):
    """Leaf-wise ``where(should, new, old)`` of two states of one type;
    ``should`` is () for a ring, (T,) for a fleet."""
    out = []
    for a, b in zip(new, old):
        if b is None:
            out.append(None)
            continue
        sel = should.reshape(should.shape + (1,) * (b.ndim - should.ndim))
        out.append(torch.where(sel, a, b))
    return type(old)(*out)


def decay_sum(w: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Σ_e w[..., e] · C[..., e, :, :] as float32, accumulated in
    ring-index order e = 0..E−1 (one multiply and one add per epoch)."""
    E = counts.shape[-3]
    acc = torch.zeros(counts.shape[:-3] + counts.shape[-2:],
                      dtype=torch.float32, device=counts.device)
    for e in range(E):
        acc = acc + w[..., e, None, None] * counts[..., e, :, :].to(
            torch.float32)
    return acc


# ---------------------------------------------------------------------------
# Ring mechanics.
# ---------------------------------------------------------------------------

def rotate(state, gamma: float = 1.0, whole=None):
    """Advance the ring (every ring of a fleet): the oldest epoch expires
    and becomes the new live epoch (zeroed counts, moments and, when the
    state carries them, rate histogram and attribution planes — that row
    only), and the tail is recomputed from the updated ring,
    tail' = Σ_e γ^age'·C'_e (the zeroed new-live slab contributes
    nothing), with ssq = ‖tail'‖².  The zeroing is an ``index_fill`` at a
    device index: no host sync.  Applied E times this returns the ring to
    all zeros with the cursor back where it started.  ``whole`` maps a
    table-sharded rank's tail block to the whole (L, 2^K) tail, whose
    ‖·‖² is the ring's ssq."""
    E = state.num_epochs
    new_cursor = torch.remainder(state.cursor + 1, E).to(torch.int32)
    rows = slab_rows(new_cursor, E)
    slab = state.counts.shape[-2:]
    counts = state.counts.reshape((-1,) + slab).index_fill(0, rows, 0) \
        .reshape(state.counts.shape)

    def clear(x):
        return x.reshape(-1).index_fill(0, rows, 0.0).reshape(x.shape)
    qhist, attr = state.qhist, state.attr
    if qhist is not None:
        qhist = qhist.reshape(-1, qhist.shape[-1]).index_fill(0, rows, 0.0) \
            .reshape(qhist.shape)
    if attr is not None:
        plane = attr.shape[-4:]
        attr = attr.reshape((-1,) + plane).index_fill(0, rows, 0.0) \
            .reshape(attr.shape)
    tail = decay_sum(epoch_weights(new_cursor, E, gamma), counts)
    whole_tail = tail if whole is None else whole(tail)
    return state._replace(
        counts=counts, n=clear(state.n), qhist=qhist, attr=attr,
        welford_mean=clear(state.welford_mean),
        welford_m2=clear(state.welford_m2), tail=tail,
        ssq=torch.sum(whole_tail * whole_tail, dim=(-2, -1)),
        cursor=new_cursor)


def maybe_rotate(state: WindowedAceState, rotate_every: int,
                 gamma: float = 1.0, whole=None) -> WindowedAceState:
    """Rotate when the tick says the live epoch is full (call AFTER an
    insert step): ``tick > 0 ∧ tick % R == 0``.  A device-side select
    over a rotated candidate, so no host sync.  ``rotate_every <= 0`` is
    the identity; ``whole`` as in ``rotate``."""
    if rotate_every <= 0:
        return state
    should = (state.tick > 0) & (torch.remainder(state.tick,
                                                 rotate_every) == 0)
    return select(should, rotate(state, gamma, whole), state)


def live_epoch(state: WindowedAceState) -> AceState:
    """The live epoch as a plain ``AceState`` (a gather copy), with its
    attribution planes when the ring carries them."""
    rows = slab_rows(state.cursor, state.num_epochs)
    slab = state.counts.shape[-2:]
    attr = state.attr
    if attr is not None:
        attr = attr.index_select(0, rows)[0]
    return AceState(
        counts=state.counts.reshape((-1,) + slab).index_select(
            0, rows).reshape(slab),
        n=epoch_select(state.n, state.cursor),
        welford_mean=epoch_select(state.welford_mean, state.cursor),
        welford_m2=epoch_select(state.welford_m2, state.cursor), attr=attr)


def live_rows(state: WindowedAceState, batch: int) -> torch.Tensor:
    """(B,) int32 first ring row of the live epoch, cursor·L, for every
    item: the ``row_base`` operand of the ``ace_query``/``ace_update``
    kernels on the (E·L, 2^K) ring."""
    L = state.counts.shape[1]
    return (state.cursor * L).to(torch.int32).expand(batch).contiguous()


def table_sums(tail_g: torch.Tensor, live_g: torch.Tensor,
               table_mask: torch.Tensor | None = None):
    """Row sums of the (B, L) tail and live gathers, over the tables of
    ``table_mask`` (L,) or per-item (B, L) when one is given."""
    if table_mask is not None:
        maskf = table_mask.to(torch.float32)
        tail_g, live_g = tail_g * maskf, live_g * maskf
    return torch.sum(tail_g, dim=-1), torch.sum(live_g, dim=-1)


def window_table_sums(state: WindowedAceState, buckets: torch.Tensor,
                      table_mask: torch.Tensor | None = None):
    """Hot-path windowed table sums, split by provenance:
    tail_sums[i] = Σ_j tail[j, b_ij], live_sums[i] = Σ_j C_cursor[j, b_ij]
    (pre-insert), both (B,) float32; ``table_mask`` (L,) zeroes the
    masked tables out of both."""
    E, L, nbuckets = state.counts.shape
    B = buckets.shape[0]
    live_g = gather_rows(state.counts.reshape(E * L, nbuckets), buckets,
                         live_rows(state, B)).to(torch.float32)
    return table_sums(gather_rows(state.tail, buckets), live_g, table_mask)


def score_live(tail_sums: torch.Tensor, live_sums: torch.Tensor,
               num_tables: int,
               table_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(tail_sums, live_sums) -> (B,) windowed scores: one add, one
    multiply by float32(1/L) (E = 1 is ``batch_scores`` bitwise).  With
    ``table_mask`` the sums are the masked ones and the multiplier is
    1/num_healthy."""
    if table_mask is None:
        return (tail_sums + live_sums) * sk.reciprocal(num_tables)
    nh = torch.clamp_min(torch.sum(table_mask.to(torch.float32)), 1.0)
    return (tail_sums + live_sums) * (1.0 / nh)


def score_combined(state: WindowedAceState,
                   buckets: torch.Tensor) -> torch.Tensor:
    """Hot-path windowed Ŝ(q) at the ring's own γ (tail + live gathers)."""
    tail_sums, live_sums = window_table_sums(state, buckets)
    return score_live(tail_sums, live_sums, state.counts.shape[1])


def insert_current(state: WindowedAceState, buckets: torch.Tensor,
                   mask: torch.Tensor, cfg: AceConfig, gamma: float = 1.0,
                   pre_sums=None) -> WindowedAceState:
    """Masked insert into the LIVE epoch (one scatter at rows
    cursor·L + j); bumps the tick.  ``pre_sums = (tail_sums, live_sums)``
    passes the scoring gathers the caller already has."""
    E, L, nbuckets = state.counts.shape
    B = buckets.shape[0]
    if pre_sums is None:
        pre_sums = window_table_sums(state, buckets)
    tail_sums, live_pre = pre_sums
    rows = table_rows(buckets, live_rows(state, B))
    w_ctr = mask.to(state.counts.dtype)[:, None].expand(buckets.shape)
    flat = state.counts.reshape(E * L, nbuckets).index_put(
        (rows, buckets.long()), w_ctr, accumulate=True)
    live_post = torch.sum(flat[rows, buckets.long()].to(torch.float32),
                          dim=-1)
    return insert_stats(state, flat.reshape(state.counts.shape), mask, cfg,
                        gamma, tail_sums, live_pre, live_post)


def insert_stats(state: WindowedAceState, new_ring: torch.Tensor,
                 mask: torch.Tensor, cfg: AceConfig, gamma: float,
                 tail_sums: torch.Tensor, live_pre: torch.Tensor,
                 live_post: torch.Tensor) -> WindowedAceState:
    """The stats half of ``insert_current`` for an already-scattered ring,
    shared with the kernel path: ssq advances by the windowed Eq. 11
    increment Δ‖C_w‖² = 2·m_tail + m_pre + m_post (masked sums of the
    pre/post gathers), and the live epoch's Welford stream folds the
    post-insert windowed rates score_w/n_w (``sketch.masked_batch_welford``
    term for term, with the epoch's own n as the stream length).  The
    sums are over all ``cfg.num_tables`` tables (a table-sharded ring's
    summed over its ranks)."""
    L = cfg.num_tables
    maskf = mask.to(torch.float32)
    scores = score_live(tail_sums, live_post, L)
    m_tail = torch.sum(tail_sums * maskf)
    m_pre = torch.sum(live_pre * maskf)
    m_post = torch.sum(live_post * maskf)
    new_ssq = state.ssq + 2.0 * m_tail + m_pre + m_post

    c = state.cursor
    b = torch.sum(maskf)
    n_e = epoch_select(state.n, c)
    tot_e = n_e + b
    n_w = combined_n(state, gamma) + b
    rates = scores / torch.clamp_min(n_w, 1.0)
    mean_b = torch.sum(rates * maskf) / torch.clamp_min(b, 1.0)
    m2_b = torch.sum(((rates - mean_b) ** 2) * maskf)
    old_mean = epoch_select(state.welford_mean, c)
    old_m2 = epoch_select(state.welford_m2, c)
    new_mean, new_m2 = sk.welford_fold(old_mean, old_m2, n_e, b, tot_e,
                                       mean_b, m2_b, cfg.welford_min_n)
    has = b > 0
    new_mean = torch.where(has, new_mean, old_mean)
    new_m2 = torch.where(has, new_m2, old_m2)
    rows = slab_rows(c, state.num_epochs)

    def put(x, v):
        return x.index_copy(0, rows, v.reshape(1))
    return state._replace(
        counts=new_ring, n=put(state.n, tot_e),
        welford_mean=put(state.welford_mean, new_mean),
        welford_m2=put(state.welford_m2, new_m2),
        ssq=new_ssq, tick=state.tick + 1)


# ---------------------------------------------------------------------------
# Window-combined views: weights, counts, scores, moments, threshold.
# ---------------------------------------------------------------------------

def epoch_weights(cursor: torch.Tensor, num_epochs: int,
                  gamma: float) -> torch.Tensor:
    """float32 query-time weights γ^age, age = (cursor − e) mod E: (E,)
    for a () cursor, (T, E) for a fleet's (T,) cursors.  The live epoch
    weighs exactly 1.0."""
    ages = torch.remainder(
        cursor[..., None] - torch.arange(num_epochs, dtype=torch.int32,
                                         device=cursor.device), num_epochs)
    # a device fill, not a tensor copied from the host (no sync)
    base = torch.full((), gamma, dtype=torch.float32, device=cursor.device)
    return torch.pow(base, ages.to(torch.float32))


def decayed_counts(state, gamma: float) -> torch.Tensor:
    """γ-weighted combined counts recomputed from the epochs,
    C_w = Σ_e γ^age·C_e: (L, 2^K) float32 ((T, L, 2^K) for a fleet)."""
    return decay_sum(epoch_weights(state.cursor, state.num_epochs, gamma),
                     state.counts)


def epoch_table_sums(state: WindowedAceState,
                     buckets: torch.Tensor) -> torch.Tensor:
    """Per-epoch table sums t[e, i] = Σ_j C_e[j, b_ij]: (E, B) float32,
    one gather for all E epochs of the (E·L, 2^K) ring."""
    E, L, nbuckets = state.counts.shape
    bases = torch.arange(E, device=buckets.device)[:, None] * L
    g = gather_rows(state.counts.reshape(E * L, nbuckets), buckets[None],
                    bases)
    return torch.sum(g.to(torch.float32), dim=-1)


def score_from_sums(sums: torch.Tensor, cursor: torch.Tensor, gamma: float,
                    num_tables: int) -> torch.Tensor:
    """(E, B) per-epoch table sums -> (B,) windowed scores:
    Σ_e w_e·t_e in ring-index order, then × float32(1/L)."""
    E = sums.shape[0]
    w = epoch_weights(cursor, E, gamma)
    acc = torch.zeros(sums.shape[1:], dtype=torch.float32,
                      device=sums.device)
    for e in range(E):
        acc = acc + w[e] * sums[e]
    return acc * sk.reciprocal(num_tables)


def score_windowed(state: WindowedAceState, buckets: torch.Tensor,
                   gamma: float) -> torch.Tensor:
    """Query-time E-way windowed Ŝ(q) at any γ, reading every epoch:
    (1/L)·Σ_e γ^age_e·Σ_j C_e[j, H_j(q)]."""
    return score_from_sums(epoch_table_sums(state, buckets), state.cursor,
                           gamma, state.counts.shape[1])


def ring_sum(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Σ_e w[..., e]·x[..., e] in ring-index order, starting from epoch
    0's product (so E = 1 is that product exactly)."""
    acc = w[..., 0] * x[..., 0]
    for e in range(1, x.shape[-1]):
        acc = acc + w[..., e] * x[..., e]
    return acc


def combined_n(state, gamma: float) -> torch.Tensor:
    """Effective window item count n_w = Σ_e γ^age·n_e."""
    return ring_sum(epoch_weights(state.cursor, state.num_epochs, gamma),
                    state.n)


def combined_qhist(state, gamma: float) -> torch.Tensor:
    """γ-weighted window rate histogram H_w = Σ_e γ^age·H_e: (NUM_BINS,)
    for a ring, (T, NUM_BINS) for a fleet; explicit float32 multiply-adds
    in ring-index order from epoch 0's product (exact at γ = 1, where
    every bin is an integer).  A rotated-out epoch's row is zero, so its
    rates leave the window quantile with its counts."""
    if state.qhist is None:
        raise ValueError("window has no qhist leaf (threshold_mode="
                         "'quantile' needs init_window(..., quantile=True))")
    w = epoch_weights(state.cursor, state.num_epochs, gamma)
    h = state.qhist
    acc = w[..., 0, None] * h[..., 0, :]
    for e in range(1, h.shape[-2]):
        acc = acc + w[..., e, None] * h[..., e, :]
    return acc


def observe_current(state: WindowedAceState, rates: torch.Tensor,
                    maskf: torch.Tensor) -> WindowedAceState:
    """Fold a batch of windowed rates into the LIVE epoch's histogram row:
    one ``index_add`` at cursor·NUM_BINS + bin of the flat (E·NUM_BINS)
    ring.  ``maskf`` is the OBSERVE mask (finite rows), not the admit
    mask."""
    nb = state.qhist.shape[-1]
    offs = state.cursor.long() * nb + qsk.bin_index(rates)
    return state._replace(qhist=state.qhist.reshape(-1).index_add(
        0, offs, maskf.to(torch.float32)).reshape(state.qhist.shape))


def combined_moments(state, gamma: float):
    """Window-combined Welford stream (n_w, mean_w, m2_w): Chan's merge
    folded across epochs in ring-index order, epoch e entering at weight
    γ^age (n_e → γ^age·n_e, M2_e → γ^age·M2_e), starting from epoch 0's
    own moments so E = 1 returns that epoch's scalars bitwise."""
    w = epoch_weights(state.cursor, state.num_epochs, gamma)
    n, mean, m2 = state.n, state.welford_mean, state.welford_m2
    n_acc = w[..., 0] * n[..., 0]
    mean_acc = mean[..., 0]
    m2_acc = w[..., 0] * m2[..., 0]
    for e in range(1, state.num_epochs):
        n_b = w[..., e] * n[..., e]
        delta = mean[..., e] - mean_acc
        tot = n_acc + n_b
        safe = torch.clamp_min(tot, 1.0)
        mean_acc = mean_acc + delta * n_b / safe
        m2_acc = m2_acc + w[..., e] * m2[..., e] \
            + delta**2 * n_acc * n_b / safe
        n_acc = tot
    return n_acc, mean_acc, m2_acc


def mean_mu_windowed(state, gamma: float,
                     table_mask: torch.Tensor | None = None,
                     num_tables: int | None = None,
                     whole=None) -> torch.Tensor:
    """γ-generalised Eq. 11 closed form μ_w = ‖C_w‖² / (n_w·L) from the
    maintained ssq (exact at γ = 1).  ``table_mask`` ((L,), or (T, L) for
    a fleet) recomputes per-table squared norms from ``decayed_counts``
    and means over the healthy tables.  ``num_tables`` is L when the
    state holds only some of the tables (a table-sharded rank's block,
    whose ssq is the whole ring's); ``whole`` then maps its per-table
    norms to all L tables' (``ShardedSketch.mean_mu``)."""
    L = num_tables or state.counts.shape[-2]
    n_w = torch.clamp_min(combined_n(state, gamma), 1.0)
    if table_mask is None:
        return state.ssq / (n_w * L)
    maskf = table_mask.to(torch.float32)
    nh = torch.clamp_min(torch.sum(maskf, dim=-1), 1.0)
    cw = decayed_counts(state, gamma)
    per_table = torch.sum(cw * cw, dim=-1)
    if whole is not None:
        per_table = whole(per_table)
    return torch.sum(per_table * maskf, dim=-1) / (n_w * nh)


def sigma_windowed(state, gamma: float) -> torch.Tensor:
    """Window σ of windowed-score rates from the combined Welford stream."""
    n_w, _, m2_w = combined_moments(state, gamma)
    return torch.sqrt(m2_w / torch.clamp_min(n_w - 1.0, 1.0))


def admit_threshold_windowed(state, gamma: float, alpha: float,
                             warmup_items: float,
                             table_mask: torch.Tensor | None = None,
                             threshold_mode: str = "mu_sigma",
                             q: float = 0.01,
                             mu: torch.Tensor | None = None) -> torch.Tensor:
    """Score-space admission threshold from WINDOW-combined statistics:
    ``sketch.admit_threshold`` with every statistic swapped for its window
    counterpart — μ−ασ: (rate_w − α·σ_w)·max(n_w, 1); quantile: the
    q-quantile of ``combined_qhist`` times max(n_w, 1) — −inf while n_w is
    below ``warmup_items``.  () for a ring, (T,) for a fleet; device ops
    only.  ``mu`` passes a μ_w computed elsewhere (a table-sharded ring's,
    over all its ranks' tables)."""
    n_w = combined_n(state, gamma)
    if threshold_mode == "quantile":
        t = qsk.hist_quantile(combined_qhist(state, gamma), q) \
            * torch.clamp_min(n_w, 1.0)
        return torch.where(n_w >= warmup_items, t, float("-inf"))
    if threshold_mode != "mu_sigma":
        raise ValueError(f"unknown threshold_mode {threshold_mode!r}")
    if mu is None:
        mu = mean_mu_windowed(state, gamma, table_mask=table_mask)
    rate = mu / torch.clamp_min(n_w, 1.0)
    t = (rate - alpha * sigma_windowed(state, gamma)) \
        * torch.clamp_min(n_w, 1.0)
    return torch.where(n_w >= warmup_items, t, float("-inf"))


def combined_ace(state: WindowedAceState) -> AceState:
    """Hard-window (γ = 1) combine into ONE plain ``AceState``:
    ``sketch.merge`` folded over the epochs (attribution planes, when the
    ring carries them, add up with the counts)."""
    def epoch(e):
        return AceState(counts=state.counts[e], n=state.n[e],
                        welford_mean=state.welford_mean[e],
                        welford_m2=state.welford_m2[e],
                        attr=None if state.attr is None else state.attr[e])
    out = epoch(0)
    for e in range(1, state.num_epochs):
        out = sk.merge(out, epoch(e))
    return out
