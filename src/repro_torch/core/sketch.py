"""The ACE sketch: L count arrays of size 2^K + streaming statistics.

Port of ``repro.core.sketch`` for int32, int16, int8 and float32 counts
(paper Algorithm 1, batch-parallel):

* state  = counts (L, 2^K) + n (items inserted) + the Welford stream of
  insert-time collision rates; no data point is stored;
* insert = scatter-add of the batch bucket histogram (order-invariant);
* score  = mean over L of counts[j, H_j(q)]  (Theorem 1);
* mean   = the closed form μ = Σ_j Σ_b A_j[b]² / (n·L) of Eq. 11.

Every function here is plain PyTorch and functional: it returns new
tensors and leaves its inputs as they were.  The kernel path
(``repro_torch.kernels.ops``) updates counts in place instead.

Narrow (int8/int16) planes without promotion add and wrap in their own
dtype, as the reference's do.  With ``esc_capacity > 0`` the ``esc`` leaf
of ``AceState`` is the overflow table of ``repro_torch.core.quantize``,
and every count read and write below goes through it (``lookup``,
``insert_buckets``, ``insert_buckets_masked``, ``delete_buckets``,
``merge``, ``mean_mu``), so counts stay exact past the dtype max.
``qhist`` is the
(NUM_BINS,) rate histogram of ``threshold_mode="quantile"``
(``repro_torch.quantile.sketch``; its callers observe into it) and
``attr`` the (2, NL, R, C) attribution plane when
``AceConfig.attr_rows > 0`` (``repro_torch.attribution``): every function
here that rebuilds a state carries both unchanged, and ``merge`` adds
them.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import quantize as qz
from repro_torch.core.srp import SrpConfig, hash_buckets, make_projections
from repro_torch.quantile import sketch as qsk

COUNT_DTYPES = {"int32": torch.int32, "int16": torch.int16,
                "int8": torch.int8, "float32": torch.float32}


class AceState(NamedTuple):
    """Dynamic sketch state (``repro.core.sketch.AceState``'s fields).

    counts: (L, 2^K) int32, int16, int8 or float32 counters.
    n:      () float32 — number of items represented (exact up to 2^24).
    welford_mean / welford_m2: () float32 — streaming mean/M2 of the
            insert-time collision RATES score/n (the σ of the threshold).
    esc:    the overflow table (``quantize.EscTable``) of a narrow plane
            with ``esc_capacity > 0``, else None.
    qhist:  (NUM_BINS,) float32 collision-rate histogram for
            ``threshold_mode="quantile"``, or None.
    attr:   (2, NL, R, C) float32 signed count-sketch attribution planes
            (``repro_torch.attribution``) when ``attr_rows > 0``, else None.
    """

    counts: torch.Tensor
    n: torch.Tensor
    welford_mean: torch.Tensor
    welford_m2: torch.Tensor
    esc: Optional[qz.EscTable] = None
    qhist: Optional[torch.Tensor] = None
    attr: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class AceConfig:
    """Static ACE configuration (``repro.core.sketch.AceConfig``'s fields)."""

    dim: int
    num_bits: int = 15          # K
    num_tables: int = 50        # L
    seed: int = 0
    counter_dtype: str = "int32"  # "int16" is the paper's 2x saving
    welford_min_n: float = 0.0  # skip σ-stream updates below this n
    hash_mode: str = "dense"
    esc_capacity: int = 0       # > 0: exact overflow promotion (narrow)
    attr_rows: int = 0          # > 0: attribution planes with that many rows
    attr_bits: int = 8          # log2 columns per attribution row

    def __post_init__(self):
        if self.esc_capacity < 0:
            raise ValueError("esc_capacity must be >= 0, got "
                             f"{self.esc_capacity}")
        if self.attr_rows < 0:
            raise ValueError("attr_rows must be >= 0, got "
                             f"{self.attr_rows}")
        if self.attr_rows > 0:
            self.attr                   # AttrConfig checks dim/rows/bits
        if self.counter_dtype not in COUNT_DTYPES:
            raise ValueError(f"unknown counter_dtype {self.counter_dtype!r}")
        if self.esc_capacity > 0:
            if not qz.is_narrow(self.counter_dtype):
                raise ValueError(
                    "esc_capacity > 0 (overflow promotion) requires a "
                    "narrow count_dtype (int8/int16); got "
                    f"{self.counter_dtype!r}")
            if self.num_tables * (1 << self.num_bits) > qz.SENTINEL:
                raise ValueError(
                    "quantized planes must stay int32 flat-addressable: "
                    f"L·2^K = {self.num_tables * (1 << self.num_bits)}")

    @property
    def srp(self) -> SrpConfig:
        return SrpConfig(dim=self.dim, num_bits=self.num_bits,
                         num_tables=self.num_tables, seed=self.seed,
                         hash_mode=self.hash_mode)

    @property
    def attr(self):
        """The attribution hierarchy's ``AttrConfig``, or None when
        ``attr_rows`` is 0."""
        if self.attr_rows <= 0:
            return None
        from repro_torch.attribution.sketch import AttrConfig
        return AttrConfig(dim=self.dim, rows=self.attr_rows,
                          bits=self.attr_bits, seed=self.seed)

    @property
    def num_buckets(self) -> int:
        return 1 << self.num_bits

    @property
    def torch_dtype(self) -> torch.dtype:
        return COUNT_DTYPES[self.counter_dtype]

    @property
    def count_dtype(self) -> str:
        """The reference's alias of ``counter_dtype``."""
        return self.counter_dtype

    @property
    def quantized(self) -> bool:
        """True when the sketch carries an overflow escalation table."""
        return self.esc_capacity > 0

    def memory_bytes(self) -> int:
        """The paper's headline number: L × 2^K × sizeof(counter), plus
        the escalation table (8 bytes a slot and ``lost``) and the
        attribution planes when there are any (the reference's sum)."""
        itemsize = torch.empty((), dtype=self.torch_dtype).element_size()
        base = self.num_tables * self.num_buckets * itemsize
        base += self.esc_capacity * 8 + (4 if self.quantized else 0)
        acfg = self.attr
        return base + (acfg.memory_bytes() if acfg is not None else 0)


def init(cfg: AceConfig, device) -> AceState:
    # imported here: the attribution module imports the kernels, which
    # import this one
    from repro_torch.attribution.sketch import init_plane
    zero = torch.zeros((), dtype=torch.float32, device=device)
    acfg = cfg.attr
    return AceState(
        counts=torch.zeros((cfg.num_tables, cfg.num_buckets),
                           dtype=cfg.torch_dtype, device=device),
        n=zero, welford_mean=zero.clone(), welford_m2=zero.clone(),
        esc=qz.init_esc(cfg.esc_capacity, device) if cfg.quantized else None,
        attr=None if acfg is None else init_plane(acfg, device))


def make_params(cfg: AceConfig, generator: torch.Generator | None = None,
                device=None, *, dtype=torch.float32) -> torch.Tensor:
    """The SRP projection matrix W (d, KL_padded) in ``dtype`` (float32,
    bfloat16 or float16); see ``srp.make_projections`` for how the draw
    relates to the reference's."""
    return make_projections(cfg.srp, generator=generator, device=device,
                            dtype=dtype)


def _rows(buckets: torch.Tensor) -> torch.Tensor:
    """(1, L) table index broadcasting against (B, L) bucket ids."""
    return torch.arange(buckets.shape[-1], device=buckets.device)[None, :]


def reciprocal(L: int) -> torch.Tensor:
    """float32(1/L): every mean over L is this reciprocal multiply, never a
    bare ``/ L``, as in the reference (``repro.core.sketch.batch_scores``)
    and in the kernels, so that scores agree bitwise."""
    return torch.tensor(1.0 / L, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Bucket-level primitives (input: precomputed bucket ids (B, L)).
# ---------------------------------------------------------------------------

def batch_scores(counts: torch.Tensor, buckets: torch.Tensor,
                 table_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Scores of a batch of bucket ids vs a counts array: (B, L) -> (B,).

    ``table_mask`` (L,) 0/1 restricts the mean to the healthy tables
    (``masked_table_mean``); None keeps the plain mean over L.
    """
    gathered = counts[_rows(buckets), buckets.long()].to(torch.float32)
    if table_mask is None:
        return torch.sum(gathered, dim=-1) * reciprocal(counts.shape[0])
    return masked_table_mean(gathered, table_mask)


def masked_table_mean(gathered: torch.Tensor,
                      table_mask: torch.Tensor) -> torch.Tensor:
    """Mean of a (..., L) gather over the healthy tables only: the masked
    sum times the reciprocal of the healthy-table count (the degraded-mode
    combine of ``repro.core.sketch.masked_table_mean``).  A masked table
    contributes an exact 0.0, so the survivors sum as if it never
    existed."""
    maskf = table_mask.to(torch.float32)
    nh = torch.clamp_min(torch.sum(maskf), 1.0)
    return torch.sum(gathered * maskf, dim=-1) * (1.0 / nh)


def lookup(state: AceState, buckets: torch.Tensor,
           table_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Ŝ(q, D) of Algorithm 1 (query phase): (B, L) -> (B,) float32,
    over the healthy tables only when ``table_mask`` is given; through the
    escalation table when the state has one."""
    if state.esc is not None:
        return qz.batch_scores_logical(state.counts, state.esc, buckets,
                                       table_mask)
    return batch_scores(state.counts, buckets, table_mask)


def histogram(buckets: torch.Tensor, cfg: AceConfig) -> torch.Tensor:
    """Batch bucket histogram: (B, L) ids -> (L, 2^K) counts of this batch."""
    zero = torch.zeros((cfg.num_tables, cfg.num_buckets),
                       dtype=cfg.torch_dtype, device=buckets.device)
    return _scatter_add(zero, buckets, torch.ones(
        buckets.shape, dtype=cfg.torch_dtype, device=buckets.device))


def _scatter_add(counts: torch.Tensor, buckets: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """counts with weights[b, j] added at [j, buckets[b, j]] (a new tensor)."""
    return counts.index_put((_rows(buckets), buckets.long()),
                            weights.to(counts.dtype), accumulate=True)


def welford_fold(welford_mean, welford_m2, n, b, tot, mean_b, m2_b,
                 min_n: float):
    """Fold one batch's rate statistics into the Welford stream.

    The cold-start gate (``min_n``) restarts the stream on the first gated
    batch, as in the reference.
    """
    delta = mean_b - welford_mean
    gate = n >= min_n
    eff_n = torch.where(gate, n, 0.0)
    safe = torch.clamp_min(tot, 1.0)
    new_mean = torch.where(gate, welford_mean + delta * b / safe, mean_b)
    new_m2 = torch.where(gate, welford_m2 + m2_b + delta**2 * eff_n * b / safe,
                         m2_b)
    return new_mean, new_m2


def insert_buckets(state: AceState, buckets: torch.Tensor,
                   cfg: AceConfig) -> AceState:
    """Insert a batch.  Order-invariant; exact for any batch size.

    Welford stats take the post-insert score of each item (its own count
    included), Algorithm 1 line 12's convention.  A quantized plane inserts
    through the saturating scatter, whose exact post-insert values are
    the gather the scores need.
    """
    new_esc = None
    if state.esc is not None:
        new_counts, new_esc, post = _quantized(
            state, buckets, torch.ones(buckets.shape[0], dtype=torch.int32,
                                       device=buckets.device))
        scores = torch.sum(post.to(torch.float32), dim=-1) \
            * reciprocal(cfg.num_tables)
    else:
        new_counts = _scatter_add(state.counts, buckets,
                                  torch.ones_like(buckets))
        scores = batch_scores(new_counts, buckets)
    b = float(buckets.shape[0])
    tot = state.n + b
    rates = scores / torch.clamp_min(tot, 1.0)
    mean_b = torch.mean(rates)
    m2_b = torch.sum((rates - mean_b) ** 2)
    new_mean, new_m2 = welford_fold(state.welford_mean, state.welford_m2,
                                    state.n, b, tot, mean_b, m2_b,
                                    cfg.welford_min_n)
    return state._replace(counts=new_counts, n=tot, welford_mean=new_mean,
                          welford_m2=new_m2, esc=new_esc)


def _quantized(state: AceState, buckets: torch.Tensor, w: torch.Tensor):
    """``quantize.quantized_scatter`` of weights ``w`` (B,) at the flat
    offsets of (B, L) ids: (new_counts, new_esc, post)."""
    return qz.quantized_scatter(
        state.counts, state.esc,
        qz.flat_offsets(buckets, state.counts.shape[1]), w)


def masked_batch_welford(state: AceState, scores: torch.Tensor,
                         maskf: torch.Tensor, min_n: float, reduce=None):
    """Welford fold over only the masked items of a fixed-shape batch.

    ``scores`` are post-insert scores of ALL items (B,); ``maskf`` is the
    0/1 float admit mask.  Returns (n, welford_mean, welford_m2); an
    all-zero mask leaves the stream untouched.  ``reduce`` (optional) is
    applied to each scalar partial sum (count, rate sum, M2 sum): the
    all-reduce over the data axes when the batch is split over ranks
    (``repro_torch.dist.sketch_parallel``), the identity otherwise.
    """
    if reduce is None:
        def reduce(v):
            return v
    b = reduce(torch.sum(maskf))
    tot = state.n + b
    rates = scores / torch.clamp_min(tot, 1.0)
    mean_b = reduce(torch.sum(rates * maskf)) / torch.clamp_min(b, 1.0)
    m2_b = reduce(torch.sum(((rates - mean_b) ** 2) * maskf))
    new_mean, new_m2 = welford_fold(state.welford_mean, state.welford_m2,
                                    state.n, b, tot, mean_b, m2_b, min_n)
    has = b > 0
    return (tot, torch.where(has, new_mean, state.welford_mean),
            torch.where(has, new_m2, state.welford_m2))


def insert_buckets_masked(state: AceState, buckets: torch.Tensor,
                          mask: torch.Tensor, cfg: AceConfig) -> AceState:
    """Masked (0/1-weighted) insert: insert only the items where ``mask``.

    Equivalent to ``insert_buckets(state, buckets[mask], cfg)`` exactly for
    counts/n/μ and up to float summation order for the Welford stream,
    with fixed shapes (the serving guardrail's insert).
    """
    new_esc = None
    if state.esc is not None:
        # post holds every item's exact post-scatter counts, masked-out
        # items included: the gather of the unquantized branch
        new_counts, new_esc, post = _quantized(state, buckets,
                                               mask.to(torch.int32))
        scores = torch.sum(post.to(torch.float32), dim=-1) \
            * reciprocal(cfg.num_tables)
    else:
        w_ctr = mask.to(state.counts.dtype)[:, None].expand(buckets.shape)
        new_counts = _scatter_add(state.counts, buckets, w_ctr)
        scores = batch_scores(new_counts, buckets)
    tot, new_mean, new_m2 = masked_batch_welford(
        state, scores, mask.to(torch.float32), cfg.welford_min_n)
    return state._replace(counts=new_counts, n=tot, welford_mean=new_mean,
                          welford_m2=new_m2, esc=new_esc)


def delete_buckets(state: AceState, buckets: torch.Tensor,
                   cfg: AceConfig) -> AceState:
    """Remove previously inserted items (paper §3.4.1, Eq. 12).  The Welford
    stream is not un-merged; μ is a pure function of the counts.  A
    quantized plane deletes through the saturating scatter with weight −1:
    a promoted bucket that drops back to the cap frees its slot."""
    n = state.n - float(buckets.shape[0])
    if state.esc is not None:
        new_counts, new_esc, _ = _quantized(
            state, buckets, torch.full((buckets.shape[0],), -1,
                                       dtype=torch.int32,
                                       device=buckets.device))
        return state._replace(counts=new_counts, esc=new_esc, n=n)
    new_counts = _scatter_add(state.counts, buckets,
                              torch.full_like(buckets, -1))
    return state._replace(counts=new_counts, n=n)


def merge(a: AceState, b: AceState) -> AceState:
    """Merge two sketches over disjoint data: counts add, the Welford
    streams merge by Chan's parallel rule, quantile histograms and
    attribution planes add (both are linear).  Quantized sketches densify
    to int32, add and requantize, ``lost`` summed.  A state with a
    histogram (planes, an escalation table) and one without do not
    merge."""
    if (a.esc is None) != (b.esc is None):
        raise ValueError("cannot merge a quantized sketch with an "
                         "unquantized one")
    if a.esc is not None:
        if (a.esc.capacity != b.esc.capacity
                or a.counts.dtype != b.counts.dtype):
            raise ValueError("quantized merge requires matching "
                             "count_dtype and esc_capacity")
        counts, esc = qz.requantize(
            qz.densify(a.counts, a.esc) + qz.densify(b.counts, b.esc),
            a.esc.capacity, a.counts.dtype)
        esc = esc._replace(lost=esc.lost + a.esc.lost + b.esc.lost)
    else:
        counts, esc = a.counts + b.counts, None
    if (a.qhist is None) != (b.qhist is None):
        raise ValueError("cannot merge a quantile-tracking sketch with a "
                         "non-tracking one")
    if (a.attr is None) != (b.attr is None):
        raise ValueError("cannot merge an attribution-tracking sketch "
                         "with a non-tracking one")
    delta = b.welford_mean - a.welford_mean
    tot = a.n + b.n
    safe = torch.clamp_min(tot, 1.0)
    return AceState(
        counts=counts,
        n=tot,
        welford_mean=a.welford_mean + delta * b.n / safe,
        welford_m2=a.welford_m2 + b.welford_m2 + delta**2 * a.n * b.n / safe,
        esc=esc,
        qhist=None if a.qhist is None else a.qhist + b.qhist,
        attr=None if a.attr is None else a.attr + b.attr)


# ---------------------------------------------------------------------------
# Statistics of the sketch.
# ---------------------------------------------------------------------------

def sq_sum(counts: torch.Tensor, dim=None) -> torch.Tensor:
    """Σ c² over ``dim`` (all of it when None), exact: in int64 for integer
    counters, float64 for float ones, so the sum is the same whatever
    order it is taken in — a table-sharded sketch's partial sums add up
    to the single card's bits (``repro_torch.dist.sketch_parallel``)."""
    wide = counts.to(torch.float64 if counts.is_floating_point()
                     else torch.int64, copy=True).square_()
    return torch.sum(wide) if dim is None else torch.sum(wide, dim=dim)


def mean_mu(state: AceState, table_mask: torch.Tensor | None = None,
            whole=None) -> torch.Tensor:
    """Exact dataset mean score μ = Σ‖A_j‖² / (n·L)  (≡ paper Eq. 11),
    Σ‖A_j‖² summed exactly (``sq_sum``) and rounded to float32 once.

    ``table_mask`` (L,) restricts it to the healthy tables:
    Σ_{j healthy} ‖A_j‖² / (n · num_healthy).  A quantized plane sums
    its logical counts (``quantize.sq_sum``; densified under a mask).
    ``whole`` maps a table-sharded rank's per-table ‖A_j‖² to all L
    tables' (``ShardedSketch.mean_mu``).
    """
    L = state.counts.shape[0]
    if table_mask is None:
        denom = torch.clamp_min(state.n, 1.0) * L
        if state.esc is not None:
            return qz.sq_sum(state.counts, state.esc) / denom
        return sq_sum(state.counts).to(torch.float32) / denom
    c = (qz.densify(state.counts, state.esc) if state.esc is not None
         else state.counts).to(torch.float32)
    maskf = table_mask.to(torch.float32)
    nh = torch.clamp_min(torch.sum(maskf), 1.0)
    per_table = torch.sum(c * c, dim=1)                          # (L,)
    if whole is not None:
        per_table = whole(per_table)
    return torch.sum(per_table * maskf) / (torch.clamp_min(state.n, 1.0)
                                           * nh)


def mu_sequential_increment(state: AceState, buckets_one: torch.Tensor,
                            cfg: AceConfig):
    """One step of the paper's literal Eq. 11 (sequential, for testing).

    Returns (new_state, new_mu) for a SINGLE item with bucket ids (L,).
    """
    L = cfg.num_tables
    rows = torch.arange(L, device=buckets_one.device)
    b1 = buckets_one.long()
    old_mu = mean_mu(state)
    n = state.n
    new_counts = state.counts.index_put(
        (rows, b1), torch.ones(L, dtype=state.counts.dtype,
                               device=b1.device), accumulate=True)
    incr = torch.sum(
        (2.0 * new_counts[rows, b1].to(torch.float32) - 1.0) / L)
    new_mu = (n * old_mu + incr) / (n + 1.0)
    return state._replace(counts=new_counts, n=n + 1.0), new_mu


def mean_rate(state: AceState,
              table_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Exact mean collision RATE μ/n (scale-free across stream growth)."""
    return mean_mu(state, table_mask) / torch.clamp_min(state.n, 1.0)


def sigma_welford(state: AceState) -> torch.Tensor:
    """Streaming σ of collision RATES (score/n) from the insert-time stream."""
    return torch.sqrt(state.welford_m2 / torch.clamp_min(state.n - 1.0, 1.0))


def sigma_cubic_proxy(state: AceState) -> torch.Tensor:
    """Per-array second-moment proxy: E_i[A²] per array = Σ_b A³ / n.

    Var_proxy = mean_j Σ_b A_j[b]³/n − μ² upper-bounds the true score
    variance when arrays are independent (Jensen); a diagnostic beside
    the Welford stream (``repro.core.sketch.sigma_cubic_proxy``).
    """
    c = state.counts.to(torch.float32)
    n = torch.clamp_min(state.n, 1.0)
    second = torch.mean(torch.sum(c**3, dim=1)) / n
    return torch.sqrt(torch.clamp_min(second - mean_mu(state) ** 2, 0.0))


def admit_threshold(state: AceState, alpha: float, warmup_items: float,
                    table_mask: torch.Tensor | None = None,
                    threshold_mode: str = "mu_sigma",
                    q: float = 0.01,
                    mu: torch.Tensor | None = None) -> torch.Tensor:
    """Score-space admission threshold: admit iff score >= threshold.

    ``"mu_sigma"``: the μ−ασ rule in rate space, multiplied through by
    max(n, 1) so the decision is one compare against ONE device scalar
    (what the fused admit kernel reads through a pointer).
    ``"quantile"``: the q-quantile of the rate histogram ``state.qhist``
    times the same max(n, 1) (``quantile.sketch.quantile_threshold``).
    −inf during warmup (n < warmup_items).  Device ops only: no host
    sync.  ``table_mask`` takes μ over the same healthy tables the masked
    scores average over (the Welford σ and the histogram are over table
    means and need no mask).  ``mu`` passes a μ computed elsewhere (a
    table-sharded sketch's, summed over the ranks).
    """
    if threshold_mode == "quantile":
        if state.qhist is None:
            raise ValueError("threshold_mode='quantile' needs a sketch "
                             "with an attached qhist leaf "
                             "(see repro_torch.quantile.sketch.init_hist)")
        return qsk.quantile_threshold(state.qhist, state.n, q, warmup_items)
    if threshold_mode != "mu_sigma":
        raise ValueError(f"unknown threshold_mode {threshold_mode!r}")
    if mu is None:
        mu = mean_mu(state, table_mask)
    t = (mu / torch.clamp_min(state.n, 1.0) - alpha * sigma_welford(state)) \
        * torch.clamp_min(state.n, 1.0)
    return torch.where(state.n >= warmup_items, t, float("-inf"))


# ---------------------------------------------------------------------------
# Vector-level API (hashing included).
# ---------------------------------------------------------------------------

def insert(state: AceState, w: torch.Tensor, x: torch.Tensor,
           cfg: AceConfig) -> AceState:
    """Insert raw vectors x (B, d)."""
    return insert_buckets(state, hash_buckets(x, w, cfg.srp), cfg)


def delete(state: AceState, w: torch.Tensor, x: torch.Tensor,
           cfg: AceConfig) -> AceState:
    return delete_buckets(state, hash_buckets(x, w, cfg.srp), cfg)


def score(state: AceState, w: torch.Tensor, q: torch.Tensor,
          cfg: AceConfig) -> torch.Tensor:
    """Ŝ(q, D) for raw queries q (B, d) -> (B,)."""
    return lookup(state, hash_buckets(q, w, cfg.srp))


def is_anomaly(state: AceState, w: torch.Tensor, q: torch.Tensor,
               cfg: AceConfig, alpha: float = 1.0) -> torch.Tensor:
    """Algorithm 1 line 22 with the μ − α·σ threshold, in RATE space."""
    r = score(state, w, q, cfg) / torch.clamp_min(state.n, 1.0)
    return r < mean_rate(state) - alpha * sigma_welford(state)
