"""The port's CUDA kernels and entry points on the card, each against its
plain PyTorch version on the same CUDA tensors, at awkward shapes as well
as the main path's.  Every test here is marked ``gpu`` and skips where
``torch.cuda.is_available()`` is false; on a machine with a card run

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

(the first test builds the kernels with nvcc, a few seconds).  This file
imports neither JAX nor ``repro``, so it runs where only PyTorch is
installed.

Tolerances, as in ``chip_smoke.py``: bucket ids agree >= 0.999 with TF32
off for the plain hash (the kernels use none); everything downstream of
one set of bucket ids (counts, gathers, pre-insert scores, admit masks)
bitwise; Welford mean/M2 rtol 1e-5.  The fleet score and the unweighted
window combine sum each row (each epoch) as an exact integer, converted
once, as ``ace_query_sum`` does; the weighted combine and the
windowed-fleet admission sum in table order with no FMA, as their plain
versions do; so all are bitwise (the admission's tail sums included, at
fractional tail values).  SRHT ids bitwise, against the plain
version on the card and on the CPU; fused scores bitwise wherever the
ids agree, the weighted form too (both sum in table order, no FMA).
Attribution point estimates equal by value (an empty cell gives ±0.0, and
which zero a median of zeros returns may differ); the attribution planes
and heavy hitters of a fleet of one tenant equal the flat path's bitwise.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro_torch.core import sketch as sk  # noqa: E402
from repro_torch.core.estimators import AceEstimator  # noqa: E402
from repro_torch.core.srp import SrpConfig, make_projections  # noqa: E402
from repro_torch.kernels import ace_admit_fused as A  # noqa: E402
from repro_torch.data.pipeline import (AceDataFilter,  # noqa: E402
                                       mean_embed_features)
from repro_torch.fleet.filter import FleetDataFilter  # noqa: E402
from repro_torch.kernels import ace_fleet_score as FS  # noqa: E402
from repro_torch.kernels import ace_fleet_window_admit as FWA  # noqa: E402
from repro_torch.kernels import ace_query as Q  # noqa: E402
from repro_torch.kernels import ace_window_combine as WC  # noqa: E402
from repro_torch.kernels import ace_score_fused as F  # noqa: E402
from repro_torch.kernels import attr_estimate as AE  # noqa: E402
from repro_torch.kernels import ace_update as U  # noqa: E402
from repro_torch.kernels import srht_hash as SH  # noqa: E402
from repro_torch.kernels import srp_hash as H  # noqa: E402
from repro_torch.serve.engine import Guardrail, GuardrailConfig  # noqa: E402
from repro_torch.stream.runner import StreamRunner  # noqa: E402
from repro_torch.window.filter import WindowedAceFilter  # noqa: E402

pytestmark = pytest.mark.gpu

HASH_AGREEMENT = 0.999


@pytest.fixture
def cuda():
    """The card, with TF32 matmuls off for the plain hash; skips without
    one (decided here, never at import: every worker collects alike)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run with -m gpu on a GPU machine")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _agreement(a, b) -> float:
    return float((a == b).double().mean())


def _counts(L, K, device, seed=1):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, 9, size=(L, 1 << K)),
                           dtype=torch.int32, device=device)


def _ids(B, K, L, device, seed=2, repeat=1):
    ids = np.random.default_rng(seed).integers(0, 1 << K, size=(B, L))
    return torch.as_tensor(np.concatenate([ids] * repeat), dtype=torch.int32,
                           device=device)


# (B, d, K, L): one of everything; depth below, at and across the 64-deep
# x slice; K = 1, 16 (tables straddle no block) and 31 (4 tables a block);
# L not a multiple of the tables a block holds; the three main-path shapes
# (fit, admit, stream step); a depth of 5 and rows across two row tiles.
HASH_SHAPES = [(1, 1, 1, 1), (7, 9, 4, 3), (17, 64, 7, 19), (33, 130, 31, 5),
               (5, 65, 16, 9), (4096, 36, 15, 50), (256, 4097, 15, 50),
               (512, 4097, 13, 32), (70, 5, 13, 32)]

# (B, d, K, L, tables, splits) under a forced launch plan: depths with
# fewer slices than splits (d = 1, 5) or split unevenly (d = 33, 130),
# d = 4097 at the largest S, K = 31 with one table a group, K = 13 groups
# whose tiles start off a 4-column boundary, cluster sizes that do not
# divide the 64 rows (S = 3, 5, 6, 7).
FORCED_PLANS = [(70, 1, 13, 32, None, 8), (70, 5, 13, 32, None, 4),
                (9, 5, 15, 50, 3, 8), (130, 33, 15, 50, None, 2),
                (65, 130, 7, 19, 5, 4), (512, 4097, 13, 32, None, 8),
                (40, 130, 31, 9, 1, 4), (65, 4097, 31, 7, 1, 8),
                (3, 4097, 13, 32, 2, 8), (512, 4097, 13, 32, None, 7),
                (70, 33, 15, 50, None, 3), (130, 130, 31, 9, 1, 5),
                (100, 200, 12, 20, None, 6)]


def _forced_plan(B, d, K, L, tables, splits):
    return H.make_plan(B, d, K, L, tables or H.tables_per_group(K, L),
                       splits)


@pytest.mark.parametrize("B,d,K,L", HASH_SHAPES)
def test_srp_hash_matches_plain(cuda, B, d, K, L):
    cfg = SrpConfig(dim=d, num_bits=K, num_tables=L, seed=B)
    w = make_projections(cfg, device=cuda)
    x = torch.randn((B, d), generator=torch.Generator().manual_seed(d)) \
        .to(cuda)
    before = H.KERNEL.launches
    got = H.srp_hash(x, w, cfg)
    assert H.KERNEL.launches == before + 1
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, L)
    assert bool(((got >= 0) & (got.long() < (1 << K))).all())
    assert _agreement(got, H.srp_hash_plain(x, w, cfg)) >= HASH_AGREEMENT


@pytest.mark.parametrize("B,d,K,L,tables,splits", FORCED_PLANS)
def test_srp_hash_under_forced_plans(cuda, B, d, K, L, tables, splits):
    cfg = SrpConfig(dim=d, num_bits=K, num_tables=L, seed=B + d)
    w = make_projections(cfg, device=cuda)
    x = torch.randn((B, d), generator=torch.Generator().manual_seed(d)) \
        .to(cuda)
    plan = _forced_plan(B, d, K, L, tables, splits)
    before = H.KERNEL.launches
    got = H.srp_hash_planned(x, w, cfg, plan)
    assert H.KERNEL.launches == before + 1
    assert bool(((got >= 0) & (got.long() < (1 << K))).all())
    assert _agreement(got, H.srp_hash_plain(x, w, cfg)) >= HASH_AGREEMENT


def test_dense_hash_is_deterministic(cuda):
    """The depth splits add their partial tiles in rank order, so two
    calls give the same bits (stream step shape, S = 8)."""
    cfg = SrpConfig(dim=4097, num_bits=13, num_tables=32, seed=9)
    w = make_projections(cfg, device=cuda)
    x = torch.randn((512, 4097), generator=torch.Generator().manual_seed(9)) \
        .to(cuda)
    assert H.device_plan(512, 4097, 13, 32, cuda).splits > 1
    first = H.srp_hash(x, w, cfg)
    assert torch.equal(first, H.srp_hash(x, w, cfg))
    counts = _counts(32, 13, cuda)
    t = torch.tensor(float("-inf"), device=cuda)
    a = A.ace_admit_fused(counts.clone(), x, w, t, cfg)
    b = A.ace_admit_fused(counts.clone(), x, w, t, cfg)
    assert torch.equal(a[3], first) and torch.equal(b[3], first)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_dense_hash_takes_x_off_a_16_byte_boundary(cuda):
    """x rows are read in 4-byte copies: a contiguous view 4 bytes into
    its buffer hashes to the same bits as an aligned copy."""
    B, d = 100, 4097
    cfg = SrpConfig(dim=d, num_bits=15, num_tables=50, seed=4)
    w = make_projections(cfg, device=cuda)
    buf = torch.randn((B * d + 1,), generator=torch.Generator()
                      .manual_seed(4)).to(cuda)
    x = buf[1:1 + B * d].view(B, d)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    want = H.srp_hash(x.clone(), w, cfg)
    assert torch.equal(H.srp_hash(x, w, cfg), want)
    assert _agreement(want, H.srp_hash_plain(x, w, cfg)) >= HASH_AGREEMENT
    counts = _counts(50, 15, cuda)
    t = torch.tensor(float("-inf"), device=cuda)
    got = A.ace_admit_fused(counts.clone(), x, w, t, cfg)
    assert torch.equal(got[3], want)


def test_dense_hash_refuses_a_misaligned_w_or_a_foreign_plan(cuda):
    cfg = SrpConfig(dim=8, num_bits=5, num_tables=3)
    w = make_projections(cfg, device=cuda)
    x = torch.randn((4, 8), device=cuda)
    buf = torch.zeros((w.numel() + 1,), device=cuda)
    w_off = buf[1:].view(w.shape)
    with pytest.raises(ValueError, match="16-byte"):
        H.srp_hash(x, w_off, cfg)
    before = H.KERNEL.launches
    with pytest.raises(RuntimeError, match="repro_srp_hash"):
        H.srp_hash_planned(x, w, cfg, H.make_plan(4, 9, 5, 3, 3, 1))
    assert H.KERNEL.launches == before


def test_srp_hash_zero_row_is_all_ones(cuda):
    """sign(0) gives bit 1, so a zero row lands in bucket 2^K − 1."""
    cfg = SrpConfig(dim=70, num_bits=15, num_tables=50)
    got = H.srp_hash(torch.zeros((3, 70), device=cuda),
                     make_projections(cfg, device=cuda), cfg)
    assert bool((got == (1 << 15) - 1).all())


def test_empty_batches_launch_nothing(cuda):
    cfg = SrpConfig(dim=8, num_bits=5, num_tables=3)
    w = make_projections(cfg, device=cuda)
    counts = _counts(3, 5, cuda)
    ids = torch.zeros((0, 3), dtype=torch.int32, device=cuda)
    kernels = (H.KERNEL, U.KERNEL, Q.KERNEL, Q.GATHER_KERNEL)
    before = [k.launches for k in kernels]
    assert tuple(H.srp_hash(torch.zeros((0, 8), device=cuda), w,
                            cfg).shape) == (0, 3)
    assert torch.equal(U.ace_update(counts.clone(), ids), counts)
    assert tuple(Q.ace_query(counts, ids).shape) == (0, 3)
    assert tuple(Q.ace_query_sum(counts, ids).shape) == (0,)
    assert [k.launches for k in kernels] == before


@pytest.mark.parametrize("B,K,L,repeat", [(40, 4, 3, 1), (30, 6, 10, 4),
                                          (4096, 15, 50, 1), (64, 3, 50, 64)])
def test_ace_update_matches_plain(cuda, B, K, L, repeat):
    """Repeated rows and tiny bucket spaces make the atomics collide."""
    counts, ids = _counts(L, K, cuda), _ids(B, K, L, cuda, repeat=repeat)
    c = counts.clone()
    got = U.ace_update(c, ids)
    assert got is c, "the update is in place"
    assert torch.equal(got, U.ace_update_plain(counts.clone(), ids))


def test_update_and_query_sum_at_k_31(cuda):
    """2^31 counters a table, a count past a 32-bit int: ids at both ends
    of the range insert and gather at 64-bit offsets (two tables of 8.6
    GB, and a copy for the plain version)."""
    K, L, B = 31, 2, 256
    gen = torch.Generator(cuda).manual_seed(31)
    ids = torch.randint((1 << 31) - 500, (1 << 31) - 1, (B, L),
                        dtype=torch.int32, device=cuda, generator=gen)
    ids[::4] = torch.randint(0, 500, (B // 4, L), dtype=torch.int32,
                             device=cuda, generator=gen)
    counts = torch.zeros((L, 1 << K), dtype=torch.int32, device=cuda)
    got = U.ace_update(counts, ids)
    want = U.ace_update_plain(torch.zeros_like(counts), ids)
    assert torch.equal(got, want) and int(got.sum()) == B * L
    del want
    assert torch.equal(Q.ace_query_sum(got, ids),
                       Q.ace_query_sum_plain(got, ids))
    assert torch.equal(Q.ace_query(got, ids), Q.ace_query_plain(got, ids))
    del got, counts
    torch.cuda.empty_cache()


def test_admit_and_window_combine_at_k_31(cuda):
    """The fused admission and the window combine at 2^31 counters a table
    (17 GB each): every item admitted at a -inf threshold adds one at each
    of its ids, pre-insert scores are the gathered means, and the combine
    equals its plain version at ids at both ends of the range."""
    K, L, B, d = 31, 2, 64, 40
    cfg = SrpConfig(dim=d, num_bits=K, num_tables=L, seed=9)
    w = make_projections(cfg, device=cuda)
    gen = torch.Generator(cuda).manual_seed(9)
    q = torch.randn((B, d), generator=gen, device=cuda)
    counts = torch.randint(0, 9, (L, 1 << K), dtype=torch.int32,
                           device=cuda, generator=gen)
    ids = H.srp_hash(q, w, cfg)
    rows = torch.arange(L, device=cuda)[None, :]
    before = counts[rows, ids.long()].clone()
    total = int(counts.sum(dtype=torch.int64))
    _, scores, admit, got_ids = A.ace_admit_fused(
        counts, q, w, torch.tensor(float("-inf"), device=cuda), cfg)
    assert torch.equal(got_ids, ids) and bool(admit.all())
    assert torch.equal(scores, before.float().sum(-1)
                       * torch.tensor(1.0 / L, dtype=torch.float32))
    hits = torch.zeros_like(before)
    for j in range(L):
        _, inv, n = torch.unique(ids[:, j], return_inverse=True,
                                 return_counts=True)
        hits[:, j] = n[inv].to(torch.int32)
    assert torch.equal(counts[rows, ids.long()], before + hits)
    assert int(counts.sum(dtype=torch.int64)) == total + B * L
    ring = counts.view(2, 1, 1 << K)               # E = 2 epochs of L = 1
    top = torch.randint((1 << 31) - 300, (1 << 31) - 1, (B, 1),
                        dtype=torch.int32, device=cuda, generator=gen)
    top[::3] = ids[::3, :1]
    ew = torch.tensor([0.5, 1.0], device=cuda)
    assert torch.equal(WC.ace_window_combine(ring, top, ew),
                       WC.ace_window_combine_plain(ring, top, ew))
    del counts, ring
    torch.cuda.empty_cache()


@pytest.mark.parametrize("B,K,L", [(40, 4, 3), (33, 12, 50), (4096, 15, 50)])
def test_ace_query_matches_plain(cuda, B, K, L):
    counts, ids = _counts(L, K, cuda), _ids(B, K, L, cuda, repeat=2)
    got = Q.ace_query(counts, ids)
    assert got.dtype == torch.float32
    assert torch.equal(got, Q.ace_query_plain(counts, ids))


def _query_sum_cases(B, L, device, T=5, K=10, seed=3):
    """(row_base, table_mask, tenant_ids) operand sets for ``ace_query_sum``
    over a stacked (3L, 2^K) table: none; base rows partly outside
    [0, 3L); an (L,) mask; a (T, L) mask routed by tenant ids partly
    outside [0, T), one tenant with every table masked; every table
    masked."""
    gen = torch.Generator().manual_seed(seed)
    base = torch.randint(-L, 3 * L, (B,), generator=gen, dtype=torch.int32)
    tids = torch.randint(-1, T + 1, (B,), generator=gen, dtype=torch.int32)
    mask = (torch.rand((L,), generator=gen) < 0.7).float()
    routed = (torch.rand((T, L), generator=gen) < 0.7).float()
    routed[1] = 0.0
    cases = [(None, None, None), (base, None, None), (None, mask, None),
             (base, routed, tids), (None, torch.zeros(L), None)]
    return [tuple(None if t is None else t.to(device) for t in c)
            for c in cases]


@pytest.mark.parametrize("L", [1, 31, 32, 33, 50, 64, 65])
@pytest.mark.parametrize("B", [0, 1, 33, 4096])
def test_ace_query_sum_matches_plain_bitwise(cuda, B, L):
    """Every scale, with and without the unmasked sum, over every operand
    set of ``_query_sum_cases``: bitwise; one launch a call (none at
    B = 0)."""
    K = 10
    counts = _counts(3 * L, K, cuda, seed=L)
    ids = _ids(B, K, L, cuda, seed=B)
    for base, mask, tids in _query_sum_cases(B, L, cuda):
        table = counts if base is not None else counts[:L]
        for scale in Q.SCALES:
            kw = dict(table_mask=mask, tenant_ids=tids, scale=scale)
            before = Q.KERNEL.launches
            got = Q.ace_query_sum(table, ids, base, **kw)
            assert Q.KERNEL.launches == before + (B > 0)
            assert got.dtype == torch.float32 and tuple(got.shape) == (B,)
            assert torch.equal(got, Q.ace_query_sum_plain(table, ids, base,
                                                          **kw))
        got, every = Q.ace_query_sum(table, ids, base, table_mask=mask,
                                     tenant_ids=tids, scale="sum",
                                     with_unmasked=True)
        want = Q.ace_query_sum_plain(table, ids, base, table_mask=mask,
                                     tenant_ids=tids, scale="sum",
                                     with_unmasked=True)
        assert torch.equal(got, want[0]) and torch.equal(every, want[1])


@pytest.mark.parametrize("scale", Q.SCALES)
def test_ace_query_sum_past_2_24_bitwise(cuda, scale):
    """Counters near 2^20 and at both int32 ends on 50 tables: every row
    sum passes 2^24 (or 2^31), and the kernel's exactly rounded integer
    sum equals the plain version's."""
    L, K, B = 50, 12, 4096
    gen = torch.Generator().manual_seed(7)
    counts = torch.randint((1 << 20) - 999, (1 << 20) + 999, (L, 1 << K),
                           generator=gen, dtype=torch.int32) | 1
    counts[:, :8] = 2**31 - 1
    counts[:, 8:16] = -2**31
    counts = counts.to(cuda)
    ids = _ids(B, K, L, cuda, seed=8)
    ids[:64] %= 16                       # rows on the extreme counters
    got = Q.ace_query_sum(counts, ids, scale=scale)
    assert torch.equal(got, Q.ace_query_sum_plain(counts, ids, scale=scale))


@pytest.mark.parametrize("thresh", ["median", "-inf", "+inf"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("B,d,K,L,repeat", [(16, 32, 8, 10, 1),
                                            (8, 36, 15, 50, 4),
                                            (6, 9, 3, 4, 3),
                                            (32, 4097, 15, 50, 8),
                                            (512, 4097, 13, 32, 1)])
def test_ace_admit_fused_matches_plain(cuda, B, d, K, L, repeat, thresh,
                                       masked):
    """Warmup (−inf), armed (median) and reject-all thresholds, with and
    without the quarantine mask, on batches of repeated rows: every copy
    of a row must score against the PRE-insert counts."""
    cfg = SrpConfig(dim=d, num_bits=K, num_tables=L, seed=3)
    w = make_projections(cfg, device=cuda)
    gen = torch.Generator().manual_seed(B + d)
    q = torch.randn((B, d), generator=gen).repeat(repeat, 1).to(cuda)
    n = B * repeat
    counts = _counts(L, K, cuda)
    rows = torch.arange(L, device=cuda)[None, :]
    recip = torch.tensor(1.0 / L, dtype=torch.float32)
    pre = H.srp_hash_plain(q, w, cfg)
    t = {"median": torch.median(counts[rows, pre.long()].float().sum(-1)
                                * recip),
         "-inf": torch.tensor(float("-inf"), device=cuda),
         "+inf": torch.tensor(float("inf"), device=cuda)}[thresh]
    mask = (torch.rand((n,), generator=gen) < 0.7).to(cuda) if masked \
        else None
    before = A.KERNEL.launches
    c = counts.clone()
    got_c, got_s, got_a, got_b = A.ace_admit_fused(c, q, w, t, cfg,
                                                   item_mask=mask)
    assert A.KERNEL.launches == before + 1
    assert got_c is c, "counts are updated in place"
    _, _, _, plain_b = A.ace_admit_fused_plain(counts.clone(), q, w, t, cfg,
                                               item_mask=mask)
    assert _agreement(got_b, plain_b) >= HASH_AGREEMENT
    # downstream of the kernel's own bucket ids: bitwise
    ref_s = counts[rows, got_b.long()].float().sum(-1) * recip
    ref_a = ref_s >= t
    if mask is not None:
        ref_a &= mask
    ref_c = counts.clone().index_put_(
        (rows, got_b.long()), ref_a.to(torch.int32)[:, None].expand(n, L),
        accumulate=True)
    assert torch.equal(got_s, ref_s)
    assert torch.equal(got_a, ref_a)
    assert torch.equal(got_c, ref_c)
    if repeat > 1:
        s = got_s.view(repeat, B)
        assert torch.equal(s, s[:1].expand_as(s)), "copies score alike"


# The admission's forced plans: K <= 15, so each (L, 2^K) counts table
# stays small (K = 31 is covered by the hash alone).
ADMIT_FORCED_PLANS = [p for p in FORCED_PLANS if p[2] <= 15]


@pytest.mark.parametrize("B,d,K,L,tables,splits", ADMIT_FORCED_PLANS)
def test_ace_admit_fused_under_forced_plans(cuda, B, d, K, L, tables,
                                            splits):
    """The admission's hash under the forced plans: ids within the floor,
    scores, verdicts and counts bitwise downstream of its own ids."""
    cfg = SrpConfig(dim=d, num_bits=K, num_tables=L, seed=B)
    w = make_projections(cfg, device=cuda)
    q = torch.randn((B, d), generator=torch.Generator().manual_seed(B)) \
        .to(cuda)
    counts = _counts(L, K, cuda)
    rows = torch.arange(L, device=cuda)[None, :]
    recip = torch.tensor(1.0 / L, dtype=torch.float32)
    pre = H.srp_hash_plain(q, w, cfg)
    t = torch.median(counts[rows, pre.long()].float().sum(-1) * recip)
    plan = _forced_plan(B, d, K, L, tables, splits)
    got_c, got_s, got_a, got_b = A.ace_admit_fused_planned(
        counts.clone(), q, w, t, cfg, None, plan)
    assert _agreement(got_b, pre) >= HASH_AGREEMENT
    ref_s = counts[rows, got_b.long()].float().sum(-1) * recip
    ref_a = ref_s >= t
    ref_c = counts.clone().index_put_(
        (rows, got_b.long()), ref_a.to(torch.int32)[:, None].expand(B, L),
        accumulate=True)
    assert torch.equal(got_s, ref_s)
    assert torch.equal(got_a, ref_a)
    assert torch.equal(got_c, ref_c)


def test_wrappers_refuse_mixed_devices(cuda):
    cfg = SrpConfig(dim=8, num_bits=5, num_tables=3)
    w = make_projections(cfg, device="cpu")
    with pytest.raises(ValueError, match="different devices"):
        H.srp_hash(torch.zeros((2, 8), device=cuda), w, cfg)
    with pytest.raises(ValueError, match="different devices"):
        Q.ace_query(_counts(3, 5, cuda), torch.zeros((2, 3),
                                                     dtype=torch.int32))


def _guardrail_batches(n, d, seed=11, b=64, s=4):
    """Request embeddings around a few topics, one NaN row each, an
    off-topic share from the middle on."""
    rng = np.random.default_rng(seed)
    topics = rng.normal(size=(4, d))
    for i in range(n):
        e = topics[rng.integers(0, 4, b)][:, None, :] \
            + 0.3 * rng.normal(size=(b, s, d))
        if i >= n // 2:
            e[: 8 * (i - n // 2 + 1)] = rng.normal(size=(8 * (i - n // 2 + 1),
                                                         s, d)) * 3.0
        e[i % b, i % s, 0] = np.nan
        yield e.astype(np.float32)


def test_guardrail_kernels_match_plain_path(cuda):
    """``Guardrail.admit`` through the kernels against the plain path on
    the card, same W: masks differ in under 1% (hash flips at |proj| ~ 0);
    with none differing, counts and n bitwise and Welford at rtol 1e-5."""
    gcfg = GuardrailConfig(d_model=96, num_bits=10, num_tables=20,
                           warmup_items=64.0, alpha=2.0)
    gk = Guardrail(gcfg, use_kernels=True, device=cuda)
    gp = Guardrail(gcfg, use_kernels=False, device=cuda, w=gk.w)
    before = (A.KERNEL.launches, Q.KERNEL.launches)
    mismatch = total = 0
    for e in _guardrail_batches(8, 96):
        mk, mp = gk.admit(e), gp.admit(e)
        mismatch += int((mk != mp).sum())
        total += mk.size
    assert (A.KERNEL.launches, Q.KERNEL.launches) == (before[0] + 8,
                                                      before[1] + 8)
    assert mismatch / total < 0.01
    assert gk.quarantined == gp.quarantined == 8
    assert 0 < float(gk.state.n) < 8 * 64
    if mismatch == 0:
        assert torch.equal(gk.state.counts, gp.state.counts)
        assert float(gk.state.n) == float(gp.state.n)
        for k in ("welford_mean", "welford_m2"):
            np.testing.assert_allclose(float(getattr(gk.state, k)),
                                       float(getattr(gp.state, k)), rtol=1e-5)


def test_estimator_kernels_match_plain_path(cuda):
    """``AceEstimator`` fit/score/predict through the kernels against the
    plain sketch path on the card, same W."""
    cfg = sk.AceConfig(dim=16, num_bits=12, num_tables=30, seed=5)
    rng = np.random.default_rng(0)
    x = (rng.normal(size=16) + 0.4 * rng.normal(size=(3000, 16))) \
        .astype(np.float32)
    q = np.concatenate([x[:100], 2.0 * rng.normal(size=(20, 16))]) \
        .astype(np.float32)
    ek = AceEstimator(cfg, use_kernels=True, device=cuda)
    ep = AceEstimator(cfg, use_kernels=False, device=cuda, w=ek.w)
    before = [m.KERNEL.launches for m in (H, U, Q)]
    ek.fit(x, batch=512)
    ep.fit(x, batch=512)
    assert [m.KERNEL.launches for m in (H, U, Q)] == [b + 6 for b in before]
    assert float(ek.state.n) == 3000
    assert bool((ek.state.counts.sum(dim=1) == 3000).all())
    pts = torch.as_tensor(np.concatenate([x, q]), device=cuda)
    kid = H.srp_hash(pts, ek.w, cfg.srp)
    pid = H.srp_hash_plain(pts, ek.w, cfg.srp)
    assert _agreement(kid, pid) >= HASH_AGREEMENT
    scores = ek.score(q)
    assert scores.shape == (120,) and bool(torch.isfinite(scores).all())
    if torch.equal(kid, pid):
        assert torch.equal(ek.state.counts, ep.state.counts)
        for k in ("welford_mean", "welford_m2"):
            np.testing.assert_allclose(float(getattr(ek.state, k)),
                                       float(getattr(ep.state, k)), rtol=1e-5)
        np.testing.assert_allclose(float(ek.mu), float(ep.mu), rtol=1e-5)
        assert torch.equal(scores, ep.score(q))
        assert torch.equal(ek.predict(q), ep.predict(q))


# d -> d_pad: 1 -> 2, 36 -> 64, 4097 -> 8192, 9000 -> 16384, 12289 ->
# 16384 (dynamic shared memory above 48 KB), 32768 -> 32768 (128 KB).
SRHT_SHAPES = [(3, 1, 5, 4), (37, 36, 15, 50), (512, 4097, 13, 32),
               (9, 9000, 15, 50), (5, 12289, 13, 32), (2, 32768, 31, 3)]


@pytest.mark.parametrize("B,d,K,L", SRHT_SHAPES)
def test_srht_hash_matches_plain_bitwise(cuda, B, d, K, L):
    cfg = SrpConfig(dim=d, num_bits=K, num_tables=L, seed=d,
                    hash_mode="srht")
    x = torch.randn((B, d), generator=torch.Generator().manual_seed(d))
    x[0] = 0.0                       # padded −0.0 lanes: bucket 2^K − 1
    before = SH.KERNEL.launches
    got = SH.srht_hash(x.to(cuda), cfg)
    assert SH.KERNEL.launches == before + 1
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, L)
    assert torch.equal(got, SH.srht_hash_plain(x.to(cuda), cfg))
    assert torch.equal(got.cpu(), SH.srht_hash_plain(x, cfg))
    assert bool((got[0] == (1 << K) - 1).all())


def test_srht_hash_refuses_wider_rows(cuda):
    d = SH.MAX_D_PAD + 1
    cfg = SrpConfig(dim=d, num_bits=4, num_tables=2, hash_mode="srht")
    before = SH.KERNEL.launches
    with pytest.raises(SH.SrhtWidthError):
        SH.srht_hash(torch.zeros((1, d), device=cuda), cfg)
    assert SH.KERNEL.launches == before


# Around the kernel's layouts (srht_plan): d_pad 1024, a row in one warp,
# against 2048, a row across warps; exact powers of two (64, 1024, 2048,
# 4096); m = K·L above d_pad, so the row sample repeats rows (d = 36 and
# 16 at K·L = 750 and 93); blocks of several rows cut short (B not a
# multiple of the rows a block).
SRHT_EDGES = [(130, 1000, 13, 32), (65, 1024, 13, 32), (33, 1025, 15, 50),
              (17, 2048, 13, 32), (5, 4096, 15, 50), (300, 64, 15, 50),
              (129, 36, 15, 50), (40, 16, 31, 3), (3, 2049, 7, 5)]


@pytest.mark.parametrize("B,d,K,L", SRHT_EDGES)
def test_srht_hash_edges_bitwise(cuda, B, d, K, L):
    """Ids bitwise against the plain version on the card and on the CPU,
    with an all-zero row (every padded −0.0 lane is bit 1: bucket
    2^K − 1) and a NaN row (the transform spreads it to every element:
    bucket 0)."""
    cfg = SrpConfig(dim=d, num_bits=K, num_tables=L, seed=d + 1,
                    hash_mode="srht")
    params = SH.srht_params(cfg)
    x = torch.randn((B, d), generator=torch.Generator().manual_seed(d))
    x[0] = 0.0
    x[1, d // 2] = float("nan")
    got = SH.srht_hash(x.to(cuda), cfg)
    assert torch.equal(got, SH.srht_hash_plain(x.to(cuda), cfg))
    assert torch.equal(got.cpu(), SH.srht_hash_plain(x, cfg))
    assert bool((got[0] == (1 << K) - 1).all()) and bool((got[1] == 0).all())
    if K * L > params.d_pad:
        assert len(np.unique(params.rows)) < K * L   # rows sampled twice


def _dropping(counts, ids, mask, base):
    """counts + the items whose id is in [0, 2^K) and row in [0, R), as
    the reference's scatter drops the others (the plain version's
    ``index_put_`` raises on them)."""
    R, nb = counts.shape
    rows = np.arange(ids.shape[1])[None, :] + base[:, None].astype(np.int64)
    keep = (ids >= 0) & (ids < nb) & (rows >= 0) & (rows < R) & mask[:, None]
    out = counts.astype(np.int64)
    np.add.at(out, (rows[keep], ids[keep]), 1)
    return out.astype(np.int32)


def test_ace_update_every_id_in_one_bucket(cuda):
    """B = 4096, L = 50: 4096 items on each of 50 counters, merged in the
    warp and the block (16 atomics a counter) before they go global."""
    counts = _counts(50, 15, cuda)
    ids = torch.full((4096, 50), 777, dtype=torch.int32, device=cuda)
    got = U.ace_update(counts.clone(), ids)
    assert torch.equal(got, U.ace_update_plain(counts.clone(), ids))
    assert bool(((got - counts)[:, 777] == 4096).all())


def _colliding_ids(n, nb):
    """n distinct ids whose keys in table 0 share the kernel's first probe
    (Fibonacci hashing into ``TABLE_SLOTS`` slots)."""
    bits = U.TABLE_SLOTS.bit_length() - 1
    slot = ((np.arange(nb, dtype=np.uint64) * 0x9E3779B1) & 0xFFFFFFFF) \
        >> (32 - bits)
    first = np.bincount(slot.astype(np.int64)).argmax()
    return np.flatnonzero(slot == first)[:n].astype(np.int32)


def test_ace_update_all_distinct_ids(cuda):
    """All-distinct ids at K = 15, the stream step's and admit's kind of
    batch: every warp spread, every block adds straight to the counts."""
    B, L = 4096, 50
    rng = np.random.default_rng(3)
    ids = np.stack([rng.permutation(1 << 15)[:B] for _ in range(L)], 1)
    ids = torch.as_tensor(ids, dtype=torch.int32, device=cuda)
    counts = _counts(L, 15, cuda)
    got = U.ace_update(counts.clone(), ids)
    assert torch.equal(got, U.ace_update_plain(counts.clone(), ids))
    assert int((got - counts).sum()) == B * L


def test_ace_update_overflows_the_shared_table(cuda):
    """A clustered block (rows 24-255 of table 0 on four ids, so it takes
    the shared table) whose first 24 rows hold distinct ids on one first
    probe: at most ``PROBES`` of those find a slot, the rest go straight
    to global atomics; the other tables all-distinct."""
    B, L = 300, 20
    rng = np.random.default_rng(4)
    ids = np.stack([rng.permutation(1 << 15)[:B] for _ in range(L)], 1)
    hot = _colliding_ids(24, 1 << 15)
    ids[:24, 0] = hot
    ids[24:256, 0] = rng.choice(np.setdiff1d(np.arange(64), hot), 4)[
        rng.integers(0, 4, 232)]
    ids = torch.as_tensor(ids, dtype=torch.int32, device=cuda)
    counts = _counts(L, 15, cuda)
    got = U.ace_update(counts.clone(), ids)
    assert torch.equal(got, U.ace_update_plain(counts.clone(), ids))
    assert int((got - counts).sum()) == B * L


def test_ace_update_mask_and_base_rows_into_a_stacked_table(cuda):
    """A fleet of 8 tenants' stacked (8·50, 2^15) table, half the rows
    masked, colliding rows, each at its tenant's base row."""
    T, L, K, B = 8, 50, 15, 300
    counts = torch.zeros((T * L, 1 << K), dtype=torch.int32, device=cuda)
    ids = _ids(B, K, L, cuda, repeat=3)
    g = torch.Generator().manual_seed(5)
    base = (torch.randint(0, T, (B,), generator=g, dtype=torch.int32)
            * L).repeat(3).to(cuda)
    mask = torch.rand((3 * B,), generator=g).to(cuda) < 0.5
    got = U.ace_update(counts.clone(), ids, row_mask=mask, row_base=base)
    assert torch.equal(got, U.ace_update_plain(counts.clone(), ids, mask,
                                               base))
    assert int(got.sum()) == L * int(mask.sum())


def test_ace_update_drops_ids_and_rows_out_of_range(cuda):
    rng = np.random.default_rng(6)
    R, L, K, B = 40, 7, 6, 301
    ids = rng.integers(0, 1 << K, size=(B, L)).astype(np.int32)
    ids[::17, 3] = 1 << K
    ids[::23, 1] = -1
    base = rng.integers(0, R - L + 1, size=B).astype(np.int32)
    base[::29] = R - 2               # rows j >= 2 fall off the table
    base[::31] = -3                  # rows j < 3 fall before it
    mask = rng.random(B) < 0.6
    counts = rng.integers(0, 9, size=(R, 1 << K)).astype(np.int32)
    got = U.ace_update(torch.as_tensor(counts, device=cuda),
                       torch.as_tensor(ids, device=cuda),
                       row_mask=torch.as_tensor(mask, device=cuda),
                       row_base=torch.as_tensor(base, device=cuda))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _dropping(counts, ids, mask, base))


@pytest.mark.parametrize("B,d,K,L", [(256, 4097, 15, 50), (33, 36, 15, 50),
                                     (7, 9, 4, 3)])
def test_unpadded_w_through_the_dense_kernels(cuda, B, d, K, L):
    """``pad_lanes=False``: W of exactly K·L columns (a row stride the
    16-byte W copies cannot read) is re-padded for the kernels; ids agree
    with the plain path on the same W, and the fused score is bitwise the
    table-order mean of the kernel's own ids."""
    cfg = SrpConfig(dim=d, num_bits=K, num_tables=L, pad_lanes=False)
    w = make_projections(cfg, device=cuda)
    assert tuple(w.shape) == (d, K * L)
    x = torch.randn((B, d), generator=torch.Generator().manual_seed(d)) \
        .to(cuda)
    got = H.srp_hash(x, w, cfg)
    assert _agreement(got, H.srp_hash_plain(x, w, cfg)) >= HASH_AGREEMENT
    counts = _counts(L, K, cuda)
    scores = F.ace_score_fused(counts, x, w, cfg)
    want = F.ace_score_fused_plain(counts, x, w, cfg)
    same = (got == H.srp_hash_plain(x, w, cfg)).all(dim=1)
    assert torch.equal(scores[same], want[same])


# K = 1, 16 and 31 (two tables of 2^31 counters: 17 GB); L not a multiple
# of the tables a block holds (128 // K); the estimator's score shape.
SCORE_SHAPES = [(7, 9, 1, 130), (33, 64, 16, 9), (17, 40, 31, 2),
                (16384, 36, 15, 50)]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("B,d,K,L", SCORE_SHAPES)
def test_ace_score_fused_matches_plain(cuda, B, d, K, L, weighted):
    cfg = SrpConfig(dim=d, num_bits=K, num_tables=L, seed=7)
    w = make_projections(cfg, device=cuda)
    q = torch.randn((B, d), generator=torch.Generator().manual_seed(B)) \
        .to(cuda)
    counts = torch.randint(0, 1 << 20, (L, 1 << K), dtype=torch.int32,
                           device=cuda,
                           generator=torch.Generator(cuda).manual_seed(K))
    tw = None
    if weighted:
        m = torch.ones(L, device=cuda)
        m[0] = 0.0
        m[L // 2] = 0.0
        tw = m / torch.clamp_min(m.sum(), 1.0)
    before = F.KERNEL.launches
    got = F.ace_score_fused(counts, q, w, cfg, table_weights=tw)
    assert F.KERNEL.launches == before + 1
    ids = H.srp_hash(q, w, cfg)
    plain_ids = H.srp_hash_plain(q, w, cfg)
    assert _agreement(ids, plain_ids) >= HASH_AGREEMENT
    if tw is None:      # ace_query_sum's convention: exact sum, one scale
        ref = Q.ace_query_sum(counts, ids)
    else:               # table order, no FMA
        g = F.flat_table_gather(counts, ids)
        ref = torch.zeros(B, device=cuda)
        for j in range(L):
            ref = ref + g[:, j] * tw[j]
    assert torch.equal(got, ref), "bitwise, downstream of the kernel's ids"
    same = (ids == plain_ids).all(dim=1)
    plain = F.ace_score_fused_plain(counts, q, w, cfg, table_weights=tw)
    assert torch.equal(got[same], plain[same])
    del counts
    torch.cuda.empty_cache()


def test_ace_score_fused_empty_batch(cuda):
    cfg = SrpConfig(dim=8, num_bits=5, num_tables=3)
    before = F.KERNEL.launches
    got = F.ace_score_fused(_counts(3, 5, cuda), torch.zeros((0, 8),
                                                             device=cuda),
                            make_projections(cfg, device=cuda), cfg)
    assert tuple(got.shape) == (0,) and F.KERNEL.launches == before


def test_ace_update_row_mask_matches_plain(cuda):
    counts, ids = _counts(10, 6, cuda), _ids(64, 6, 10, cuda, repeat=4)
    mask = torch.rand((256,), generator=torch.Generator().manual_seed(1)) \
        .to(cuda) < 0.5
    got = U.ace_update(counts.clone(), ids, row_mask=mask)
    assert torch.equal(got, U.ace_update_plain(counts.clone(), ids, mask))


@pytest.mark.parametrize("mode", ["dense", "srht"])
def test_stream_consume_has_no_host_sync(cuda, mode):
    """``StreamRunner.consume`` under sync-debug "error": any host sync
    inside the chunk raises.  The chunk then equals the plain path's:
    bitwise under SRHT, within the dense ids floor otherwise."""
    kw = dict(d_model=96, num_bits=10, num_tables=20, warmup_items=200.0,
              hash_mode=mode)
    fk = AceDataFilter(**kw, device=cuda)
    fp = AceDataFilter(**kw, use_kernels=False, device=cuda)
    runner = StreamRunner(fk, 4)
    sk_, w = fk.init()
    sp = fp.init()[0]
    rng = np.random.default_rng(0)
    for c in range(3):
        f = rng.normal(size=(4, 64, 97)).astype(np.float32)
        f[:, 0, 0] = np.nan
        chunk = torch.as_tensor(f, device=cuda)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            sk_, summary = runner.consume(sk_, w, chunk)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        for t in range(4):
            sp, _, _ = fp.step(sp, w, chunk[t])
    host = runner.fetch(summary)
    assert int(host.quarantined) == 4 and float(host.n) == float(sk_.n)
    if mode == "srht":
        for k in ("counts", "n", "welford_mean", "welford_m2"):
            assert torch.equal(getattr(sk_, k), getattr(sp, k)), k
    else:
        moved = int((sk_.counts - sp.counts).abs().sum()) // 2
        assert moved <= 1e-3 * float(sp.n) * 20


def test_estimator_srht_kernels_match_plain_path(cuda):
    cfg = sk.AceConfig(dim=40, num_bits=12, num_tables=30, seed=5,
                       hash_mode="srht")
    rng = np.random.default_rng(0)
    x = (rng.normal(size=40) + 0.4 * rng.normal(size=(2000, 40))) \
        .astype(np.float32)
    ek = AceEstimator(cfg, use_kernels=True, device=cuda)
    ep = AceEstimator(cfg, use_kernels=False, device=cuda, w=ek.w)
    before = SH.KERNEL.launches
    ek.fit(x, batch=500)
    ep.fit(x, batch=500)
    assert SH.KERNEL.launches == before + 4
    assert torch.equal(ek.state.counts, ep.state.counts)
    assert torch.equal(ek.score(x[:50]), ep.score(x[:50]))


# ---------------------------------------------------------------------------
# Windows and fleets: the per-item base row, the three kernels of the slice,
# and the windowed and fleet entry points.
# ---------------------------------------------------------------------------

def _base_rows(R, L, B, device, seed=4):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, R - L + 1, (B,), generator=g,
                         dtype=torch.int32).to(device)


@pytest.mark.parametrize("masked", ["none", "half", "all"])
@pytest.mark.parametrize("R,K,L,B,repeat", [(40, 6, 8, 1, 1),
                                            (120, 10, 12, 301, 3),
                                            (65535, 15, 50, 257, 2)])
def test_row_base_update_and_query_match_plain(cuda, R, K, L, B, repeat,
                                               masked):
    """B = 1, B off the block size, colliding rows, every row masked, and
    a (65535, 2^15) table (2^31 − 2^15 counters: 64-bit offsets)."""
    counts = torch.zeros((R, 1 << K), dtype=torch.int32, device=cuda)
    counts[: min(R, 64)] = _counts(min(R, 64), K, cuda)
    ids = _ids(B, K, L, cuda, repeat=repeat)
    base = _base_rows(R, L, B, cuda).repeat(repeat)
    if R > 1000:
        base[:B // 2] = R - L            # the last rows of the table
    mask = {"none": None,
            "half": torch.arange(B * repeat, device=cuda) % 2 == 0,
            "all": torch.zeros(B * repeat, dtype=torch.bool, device=cuda)
            }[masked]
    before = (U.KERNEL.launches, Q.GATHER_KERNEL.launches)
    got = U.ace_update(counts.clone(), ids, row_mask=mask, row_base=base)
    want = U.ace_update_plain(counts.clone(), ids, mask, base)
    assert torch.equal(got, want)
    if masked == "all":
        assert torch.equal(got, counts)
    assert torch.equal(Q.ace_query(got, ids, row_base=base),
                       Q.ace_query_plain(got, ids, base))
    assert (U.KERNEL.launches, Q.GATHER_KERNEL.launches) == (before[0] + 1,
                                                             before[1] + 1)
    del counts, got, want
    torch.cuda.empty_cache()


def _window_ref(counts, ids, w, tw):
    """The combine's convention, written out: each epoch's exact int64 sum
    converted once (weighted: tw_j·g_j added in table order), weighted by
    w_e, accumulated in ring-index order, × float32(1/L) unweighted."""
    E, L, _ = counts.shape
    rows = torch.arange(L, device=counts.device)[None, :]
    acc = torch.zeros(ids.shape[0], device=counts.device)
    for e in range(E):
        g = counts[e][rows, ids.long()]
        if tw is None:
            s = g.long().sum(-1).float()
        else:
            s = torch.zeros_like(acc)
            for j in range(L):
                s = s + g[:, j].float() * tw[j]
        acc = acc + w[e] * s
    return acc if tw is not None else acc * torch.tensor(1.0 / L)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("E,L,K,B,repeat", [(1, 5, 4, 1, 1),
                                            (4, 50, 15, 300, 1),
                                            (3, 7, 3, 64, 8),
                                            (2, 33, 25, 5, 1),
                                            (9, 130, 6, 33, 1),
                                            (17, 2, 3, 9, 1)])
def test_ace_window_combine_matches_plain(cuda, E, L, K, B, repeat,
                                          weighted):
    """One launch a call, E = 1, B = 1 and off the block size, colliding
    rows, a ring of 2·33·2^25 > 2^31 counters (64-bit offsets), more
    epochs than one pass of 8 and more tables than one of 64: bitwise the
    plain version and the exact-sum convention written out (counters up
    to 2^20, so an epoch of 50 tables sums past 2^24)."""
    g = torch.Generator(cuda).manual_seed(E + L)
    counts = torch.randint(0, 1 << 20, (E, L, 1 << K), dtype=torch.int32,
                           device=cuda, generator=g)
    ids = _ids(B, K, L, cuda, repeat=repeat)
    w = 0.9 ** torch.arange(E, dtype=torch.float32, device=cuda)
    tw = None
    if weighted:
        m = torch.ones(L, device=cuda)
        m[0] = 0.0
        tw = m / m.sum()
    before = WC.KERNEL.launches
    got = WC.ace_window_combine(counts, ids, w, tw)
    assert WC.KERNEL.launches == before + 1
    assert torch.equal(got, WC.ace_window_combine_plain(counts, ids, w, tw))
    assert torch.equal(got, _window_ref(counts, ids, w, tw))
    if repeat > 1:
        s = got.view(repeat, B)
        assert torch.equal(s, s[:1].expand_as(s))
    del counts
    torch.cuda.empty_cache()


@pytest.mark.parametrize("T,B,d,K,L", [(3, 1, 9, 4, 3), (8, 257, 4097, 15, 50),
                                       (1310, 64, 36, 15, 50)])
def test_ace_fleet_score_matches_plain(cuda, T, B, d, K, L):
    """B = 1 and off the block size, the guardrail's width, and a fleet of
    1310 × 50 × 2^15 counters (the int32 offset cap: 64-bit offsets); the
    counters reach 2^20, so rows of 50 sum past 2^24: the exact int64 sum
    rounded once, × float32(1/L)."""
    cfg = SrpConfig(dim=d, num_bits=K, num_tables=L, seed=5)
    w = make_projections(cfg, device=cuda)
    q = torch.randn((B, d), generator=torch.Generator().manual_seed(d)) \
        .to(cuda)
    counts = torch.randint(0, 1 << 20, (T, L, 1 << K), dtype=torch.int32,
                           device=cuda,
                           generator=torch.Generator(cuda).manual_seed(T))
    tids = torch.randint(0, T, (B,), generator=torch.Generator()
                         .manual_seed(B), dtype=torch.int32).to(cuda)
    tids[0] = T - 1
    before = FS.KERNEL.launches
    got = FS.ace_fleet_score(counts, q, tids, w, cfg)
    assert FS.KERNEL.launches == before + 1
    ids = H.srp_hash(q, w, cfg)
    plain_ids = H.srp_hash_plain(q, w, cfg)
    assert _agreement(ids, plain_ids) >= HASH_AGREEMENT
    rows = tids.long()[:, None] * L + torch.arange(L, device=cuda)[None, :]
    gth = counts.view(T * L, -1)[rows, ids.long()]
    ref = gth.long().sum(-1).float() * torch.tensor(1.0 / L)
    assert torch.equal(got, ref)
    same = (ids == plain_ids).all(dim=1)
    plain = FS.ace_fleet_score_plain(counts, q, tids, w, cfg)
    assert torch.equal(got[same], plain[same])
    del counts
    torch.cuda.empty_cache()


@pytest.mark.parametrize("splits", [1, None])
@pytest.mark.parametrize("B", [1, 65, 256])
def test_ace_fleet_score_ids_and_scores_are_the_composition(cuda, B, splits):
    """At the guardrail's d = 4097, K = 15, L = 50, T = 8, under S = 1 and
    the card's own plan: the fleet score's ids are ``srp_hash``'s under
    the same plan bitwise (>= 0.999 with the plain hash), and its scores
    are ``srp_hash`` + the routed ``ace_query_sum`` of those ids bitwise
    (the branch ``ops.ace_fleet_score`` takes for SRHT or a mask), past
    2^24 a row too."""
    T, d, K, L = 8, 4097, 15, 50
    cfg = SrpConfig(dim=d, num_bits=K, num_tables=L, seed=B + 7)
    w = make_projections(cfg, device=cuda)
    gen = torch.Generator(cuda).manual_seed(B)
    q = torch.randn((B, d), generator=gen, device=cuda)
    counts = torch.randint(0, 1 << 20, (T, L, 1 << K), dtype=torch.int32,
                           device=cuda, generator=gen)
    tids = (torch.arange(B, device=cuda) % T).to(torch.int32)
    plan = _forced_plan(B, d, K, L, None, 1) if splits \
        else H.device_plan(B, d, K, L, cuda)
    before = FS.KERNEL.launches
    got, ids = FS.ace_fleet_score_planned(counts, q, tids, w, cfg, plan,
                                          with_ids=True)
    assert FS.KERNEL.launches == before + 1
    assert torch.equal(ids, H.srp_hash_planned(q, w, cfg, plan))
    assert _agreement(ids, H.srp_hash_plain(q, w, cfg)) >= HASH_AGREEMENT
    assert torch.equal(got, Q.ace_query_sum(
        counts.view(T * L, -1), ids, (tids * L).contiguous()))
    assert torch.equal(got, FS.fleet_score_from_ids(counts, ids, tids))
    del counts
    torch.cuda.empty_cache()


def _fwa_from_ids(ring, tail, cursor, tids, ids, thr, mask):
    """The windowed-fleet admission downstream of a given set of ids, in
    table order (what the kernel must produce from its own ids)."""
    T, E, L, nb = ring.shape
    t = tids.long()
    iota = torch.arange(L, device=ring.device)[None, :]
    tg = tail.view(T * L, nb)[t[:, None] * L + iota, ids.long()]
    rows = (t * E + cursor.long()[t])[:, None] * L + iota
    lg = ring.view(-1, nb)[rows, ids.long()].float()
    ts = torch.zeros(len(t), device=ring.device)
    ls = torch.zeros_like(ts)
    for j in range(L):
        ts, ls = ts + tg[:, j], ls + lg[:, j]
    s = (ts + ls) * torch.tensor(1.0 / L)
    a = s >= thr[t]
    if mask is not None:
        a &= mask
    r = ring.clone()
    r.view(-1, nb).index_put_((rows, ids.long()),
                              a.int()[:, None].expand(ids.shape),
                              accumulate=True)
    return r, s, a, ts, ls


@pytest.mark.parametrize("thresh", ["spread", "-inf", "+inf"])
@pytest.mark.parametrize("masked", ["none", "some", "all"])
@pytest.mark.parametrize("T,E,B,d,K,L,repeat", [(3, 1, 1, 9, 4, 3, 1),
                                                (8, 4, 32, 4097, 15, 50, 8),
                                                (5, 3, 301, 64, 10, 20, 1),
                                                (327, 4, 64, 36, 15, 50, 2)])
def test_ace_fleet_window_admit_matches_plain(cuda, T, E, B, d, K, L,
                                              repeat, masked, thresh):
    """E = 1, B = 1 and off the block size, 8 copies of each row sent to
    one tenant (every copy must score pre-insert), every row masked, and
    a ring of 327·4·50·2^15 counters (64-bit offsets)."""
    cfg = SrpConfig(dim=d, num_bits=K, num_tables=L, seed=2)
    w = make_projections(cfg, device=cuda)
    gen = torch.Generator().manual_seed(T + B)
    q = torch.randn((B, d), generator=gen).repeat(repeat, 1).to(cuda)
    n = B * repeat
    gc = torch.Generator(cuda).manual_seed(E)
    ring = torch.randint(0, 9, (T, E, L, 1 << K), dtype=torch.int32,
                         device=cuda, generator=gc)
    tail = torch.randint(0, 20, (T, L, 1 << K), device=cuda,
                         generator=gc).float() * 0.37
    cursor = torch.randint(0, E, (T,), generator=gen,
                           dtype=torch.int32).to(cuda)
    tids = torch.randint(0, T, (B,), generator=gen,
                         dtype=torch.int32).repeat(repeat).to(cuda)
    thr = {"spread": torch.linspace(2.0, 12.0, T),
           "-inf": torch.full((T,), float("-inf")),
           "+inf": torch.full((T,), float("inf"))}[thresh].to(cuda)
    mask = {"none": None,
            "some": (torch.rand((n,), generator=gen) < 0.7).to(cuda),
            "all": torch.zeros(n, dtype=torch.bool, device=cuda)}[masked]
    before = FWA.KERNEL.launches
    r = ring.clone()
    got = FWA.ace_fleet_window_admit_fused(r, tail, cursor, q, tids, w, thr,
                                           cfg, item_mask=mask)
    assert FWA.KERNEL.launches == before + 1
    assert got[0] is r, "the ring is updated in place"
    plain = FWA.ace_fleet_window_admit_fused_plain(
        ring.clone(), tail, cursor, q, tids, w, thr, cfg, item_mask=mask)
    assert _agreement(got[3], plain[3]) >= HASH_AGREEMENT
    ref_r, ref_s, ref_a, ref_t, ref_l = _fwa_from_ids(
        ring, tail, cursor, tids, got[3], thr, mask)
    assert torch.equal(got[1], ref_s) and torch.equal(got[2], ref_a)
    assert torch.equal(got[4], ref_t) and torch.equal(got[5], ref_l)
    assert torch.equal(r, ref_r)
    if masked == "all" or thresh == "+inf":
        assert torch.equal(r, ring) and not bool(got[2].any())
    if repeat > 1:
        s = got[1].view(repeat, B)
        assert torch.equal(s, s[:1].expand_as(s)), "copies score alike"
    if torch.equal(got[3], plain[3]):
        for a, b in zip(got, plain):
            assert torch.equal(a, b)
    del ring, tail, r, plain
    torch.cuda.empty_cache()


@pytest.mark.parametrize("splits", [1, None])
def test_ace_fleet_window_admit_ids_are_srp_hash_ids(cuda, splits):
    """At the admit shape (T = 8, E = 4, B = 256, d = 4097, K = 15,
    L = 50), at S = 1 and at the card's own plan: the fused admission's
    ids are ``srp_hash``'s under the same plan bitwise, agree with the
    plain hash >= 0.999, and everything downstream of them is bitwise."""
    T, E, B, d, K, L = 8, 4, 256, 4097, 15, 50
    cfg = SrpConfig(dim=d, num_bits=K, num_tables=L, seed=41)
    w = make_projections(cfg, device=cuda)
    gen = torch.Generator(cuda).manual_seed(5)
    q = torch.randn((B, d), generator=gen, device=cuda)
    ring = torch.randint(0, 9, (T, E, L, 1 << K), dtype=torch.int32,
                         device=cuda, generator=gen)
    tail = torch.randint(0, 20, (T, L, 1 << K), device=cuda,
                         generator=gen).float() * 0.37
    cursor = torch.randint(0, E, (T,), generator=gen, dtype=torch.int32,
                           device=cuda)
    tids = (torch.arange(B, device=cuda) % T).to(torch.int32)
    thr = torch.linspace(2.0, 12.0, T, device=cuda)
    plan = _forced_plan(B, d, K, L, None, 1) if splits \
        else H.device_plan(B, d, K, L, cuda)
    r = ring.clone()
    got = FWA.ace_fleet_window_admit_fused_planned(
        r, tail, cursor, q, tids, w, thr, cfg, None, plan)
    assert torch.equal(got[3], H.srp_hash_planned(q, w, cfg, plan))
    assert _agreement(got[3], H.srp_hash_plain(q, w, cfg)) >= HASH_AGREEMENT
    ref_r, ref_s, ref_a, ref_t, ref_l = _fwa_from_ids(
        ring, tail, cursor, tids, got[3], thr, None)
    assert torch.equal(got[1], ref_s) and torch.equal(got[2], ref_a)
    assert torch.equal(got[4], ref_t) and torch.equal(got[5], ref_l)
    assert torch.equal(r, ref_r)
    del ring, tail, r, ref_r
    torch.cuda.empty_cache()


def test_new_kernels_launch_nothing_on_empty_batches(cuda):
    cfg = SrpConfig(dim=8, num_bits=5, num_tables=3)
    w = make_projections(cfg, device=cuda)
    ring = torch.zeros((2, 2, 3, 32), dtype=torch.int32, device=cuda)
    none = torch.zeros((0,), dtype=torch.int32, device=cuda)
    ids = torch.zeros((0, 3), dtype=torch.int32, device=cuda)
    q = torch.zeros((0, 8), device=cuda)
    before = [m.KERNEL.launches for m in (WC, FS, FWA)]
    assert WC.ace_window_combine(ring[0], ids, torch.ones(2, device=cuda)) \
        .shape == (0,)
    assert FS.ace_fleet_score(ring[0], q, none, w, cfg).shape == (0,)
    out = FWA.ace_fleet_window_admit_fused(
        ring, ring[:, 0].float(), torch.zeros(2, dtype=torch.int32,
                                              device=cuda), q, none, w,
        torch.zeros(2, device=cuda), cfg)
    assert out[1].shape == (0,)
    assert [m.KERNEL.launches for m in (WC, FS, FWA)] == before


def _guard_pair(cuda, **kw):
    gcfg = GuardrailConfig(d_model=96, num_bits=10, num_tables=20,
                           warmup_items=64.0, alpha=2.0, **kw)
    gk = Guardrail(gcfg, use_kernels=True, device=cuda)
    return gk, Guardrail(gcfg, use_kernels=False, device=cuda, w=gk.w)


@pytest.mark.parametrize("kw,kernels", [
    (dict(window_epochs=3, rotate_every=2, window_decay=0.9),
     ("srp_hash", "ace_query", "ace_update")),
    (dict(num_tenants=4), ("srp_hash", "ace_query", "ace_update")),
    (dict(num_tenants=4, window_epochs=3, rotate_every=2, window_decay=0.9),
     ("ace_fleet_window_admit", "ace_query"))])
def test_window_and_fleet_guardrails_match_plain_path(cuda, kw, kernels):
    """The three new guardrail flavours through the kernels against their
    plain paths on the card, same W: masks differ in under 1% (hash flips
    at |proj| ~ 0); with none differing, counts and ticks bitwise."""
    mods = {"srp_hash": H, "ace_query": Q, "ace_update": U,
            "ace_fleet_window_admit": FWA}
    gk, gp = _guard_pair(cuda, **kw)
    before = {k: mods[k].KERNEL.launches for k in kernels}
    rng = np.random.default_rng(3)
    mismatch = total = 0
    for e in _guardrail_batches(8, 96):
        t = rng.integers(0, 4, len(e)) if "num_tenants" in kw else None
        mk, mp = gk.admit(e, t), gp.admit(e, t)
        mismatch += int((mk != mp).sum())
        total += mk.size
    for k in kernels:
        assert mods[k].KERNEL.launches >= before[k] + 8, k
    assert mismatch / total < 0.01
    assert gk.quarantined == gp.quarantined == 8
    if mismatch == 0:
        assert torch.equal(gk.state.counts, gp.state.counts)
        assert torch.equal(gk.state.n, gp.state.n)
        if "window_epochs" in kw:
            assert torch.equal(gk.state.cursor, gp.state.cursor)
            assert torch.equal(gk.state.tick, gp.state.tick)


@pytest.mark.parametrize("fleet", [False, True])
def test_window_and_fleet_consume_have_no_host_sync(cuda, fleet):
    """``StreamRunner.consume`` of a windowed filter rotating inside the
    chunk, and of a fleet filter, under sync-debug "error"; the chunk
    then equals the sequential steps bitwise."""
    kw = dict(d_model=96, num_bits=10, num_tables=20, warmup_items=200.0,
              device=cuda)
    filt = FleetDataFilter(**kw, num_tenants=4) if fleet \
        else WindowedAceFilter(**kw, rotate_every=2, decay=0.9)
    runner = StreamRunner(filt, 4)
    s, w = filt.init()
    seq = filt.init()[0]
    rng = np.random.default_rng(0)
    for c in range(3):
        f = rng.normal(size=(4, 64, 97)).astype(np.float32)
        f[:, 0, 0] = np.nan
        chunk = torch.as_tensor(f, device=cuda)
        tids = torch.as_tensor(rng.integers(0, 4, (4, 64)), dtype=torch.int32,
                               device=cuda) if fleet else None
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            s, summary = runner.consume(s, w, chunk, tids)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        for t in range(4):
            if fleet:
                seq, _, _ = filt.step(seq, w, chunk[t], tids[t])
            else:
                seq, _, _ = filt.step(seq, w, chunk[t])
                from repro_torch.window import ring
                seq = ring.maybe_rotate(seq, 2, 0.9)
    host = runner.fetch(summary)
    assert int(host.quarantined) == 4
    for a, b in zip(s, seq):
        if b is not None:
            assert torch.equal(a, b)


# (B, R, C): one query; R = 1 and 2; the beam's 2W; every leaf coordinate
# of d = 4097 at the default R = 5, C = 256; R = 8, the last register
# sort; R = 9 and 33, the rank selection past it; a tiny C.
@pytest.mark.parametrize("B,R,C", [(1, 1, 8), (1, 2, 8), (32, 5, 256),
                                   (4097, 5, 256), (300, 4, 64),
                                   (64, 8, 256), (129, 9, 32), (200, 33, 16),
                                   (50, 6, 1)])
def test_attr_estimate_matches_plain(cuda, B, R, C):
    """Columns at 0, C − 1 and past the plane (clamped), signs ±1, empty
    cells (±0 values) and repeated values: equal by value."""
    rng = np.random.default_rng(B * 7 + R)
    plane = rng.normal(size=(R, C)).astype(np.float32)
    plane[:, : max(1, C // 8)] = 0.0
    plane[:, -1] = 1.5                           # ties across rows
    cols = rng.integers(0, C, size=(B, R)).astype(np.int32)
    cols[0, 0] = 0
    cols[-1, -1] = C - 1
    cols[B // 2, 0] = C + 3
    signs = rng.choice([-1.0, 1.0], size=(B, R)).astype(np.float32)
    args = [torch.as_tensor(a, device=cuda) for a in (plane, cols, signs)]
    before = AE.KERNEL.launches
    got = AE.attr_estimate(*args)
    torch.cuda.synchronize()
    assert AE.KERNEL.launches == before + 1
    want = AE.attr_estimate_plain(*args)
    assert torch.equal(got, want)
    cpu = AE.attr_estimate(*(a.cpu() for a in args))
    assert torch.equal(got.cpu(), cpu)


def test_attr_estimate_zero_plane_and_empty_batch(cuda):
    plane = torch.zeros((5, 256), device=cuda)
    cols = torch.randint(0, 256, (64, 5), dtype=torch.int32, device=cuda)
    signs = torch.ones((64, 5), device=cuda)
    signs[::2] = -1.0
    got = AE.attr_estimate(plane, cols, signs)
    assert torch.equal(got, torch.zeros(64, device=cuda))
    before = AE.KERNEL.launches
    assert AE.attr_estimate(plane, cols[:0], signs[:0]).shape == (0,)
    assert AE.KERNEL.launches == before


def _attr_filters(kind, cuda, use_kernels=True):
    kw = dict(d_model=96, num_bits=10, num_tables=20, warmup_items=200.0,
              attr_rows=5, attr_bits=8, use_kernels=use_kernels, device=cuda)
    if kind == "window":
        return WindowedAceFilter(**kw, rotate_every=2)
    if kind == "fleet":
        return FleetDataFilter(**kw, num_tenants=4)
    return AceDataFilter(**kw, hash_mode=kind)


@pytest.mark.parametrize("kind", ["dense", "srht", "window", "fleet"])
def test_attribution_consume_has_no_host_sync(cuda, kind):
    """An attribution chunk (energy split, planes, find_hh through its
    one-launch kernel) under sync-debug "error"; the drift planted in the
    last chunk is named, and the kernel path's heavy hitters equal the
    plain path's."""
    from repro_torch.attribution import sketch as at
    fk, fp = _attr_filters(kind, cuda), _attr_filters(kind, cuda, False)
    rk, rp = StreamRunner(fk, 4, topk=3), StreamRunner(fp, 4, topk=3)
    (sk_, w), sp = fk.init(), fp.init()[0]
    rng = np.random.default_rng(0)
    tids = torch.as_tensor(rng.integers(0, 4, (4, 64)), dtype=torch.int32,
                           device=cuda) if kind == "fleet" else None
    before = AE.KERNEL.launches, AE.FIND_HH_KERNEL.launches
    for c in range(4):
        f = (rng.normal(size=(4, 64, 97)) * 0.3).astype(np.float32)
        f[..., :32] += 1.0
        if c == 3:
            f[:, :8, :32] = 0.1
            f[:, :8, [5, 40, 77]] = 8.0
        f[:, 0, 0] = np.nan
        chunk = torch.as_tensor(f, device=cuda)
        extra = () if tids is None else (tids,)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            sk_, summary = rk.consume(sk_, w, chunk, *extra)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        sp, plain = rp.consume(sp, w, chunk, *extra)
    # one drill-down launch a chunk, no per-level estimate
    assert (AE.KERNEL.launches - before[0],
            AE.FIND_HH_KERNEL.launches - before[1]) == (0, 4)
    host, hp = rk.fetch(summary), rp.fetch(plain)
    assert {5, 40, 77} <= set(host.hh_coord[host.hh_valid].tolist())
    if kind == "srht":
        np.testing.assert_array_equal(host.hh_coord, hp.hh_coord)
        np.testing.assert_array_equal(host.hh_est, hp.hh_est)
        assert torch.equal(sk_.attr, sp.attr)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_attribution_fleet_of_one_is_flat_on_the_card(cuda, use_kernels):
    kw = dict(d_model=96, num_bits=10, num_tables=20, warmup_items=200.0,
              attr_rows=5, use_kernels=use_kernels, device=cuda)
    flat, fleet = AceDataFilter(**kw), FleetDataFilter(**kw, num_tenants=1)
    r1, rf = StreamRunner(flat, 4, topk=4), StreamRunner(fleet, 4, topk=4)
    (s1, w), sf = flat.init(), fleet.init()[0]
    tids = torch.zeros((4, 64), dtype=torch.int32, device=cuda)
    rng = np.random.default_rng(1)
    for c in range(3):
        f = rng.normal(size=(4, 64, 97)).astype(np.float32)
        f[:, :4, 7] += 6.0 * c
        chunk = torch.as_tensor(f, device=cuda)
        s1, a = r1.consume(s1, w, chunk)
        sf, b = rf.consume(sf, w, chunk, tids)
        for k in ("hh_coord", "hh_est", "hh_valid"):
            assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert torch.equal(s1.attr, sf.attr[0])


# ---------------------------------------------------------------------------
# attr_find_hh: the one-launch drill-down, bitwise its plain version.
# ---------------------------------------------------------------------------

def _same_values(a, b) -> bool:
    """Equal by value, NaN equal to NaN (an estimate may be ±0.0)."""
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _find_hh_case(dim, R, bits, seed, plane_kind="normal"):
    """(plane (NL, R, C), cols, signs (NL, 2^NL, R)) from numpy: random
    node tables and a plane with a few heavy cells, or an all-zero plane,
    a plane of few distinct values (tied estimates) or one with a NaN
    cell."""
    from repro_torch.kernels.attr_estimate import num_levels
    nl, C = num_levels(dim), 1 << bits
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, C, size=(nl, 1 << nl, R)).astype(np.int32)
    signs = rng.choice([-1.0, 1.0], size=(nl, 1 << nl, R)).astype(np.float32)
    plane = rng.normal(size=(nl, R, C)).astype(np.float32)
    plane[:, :, rng.integers(0, C, size=3)] *= 40.0
    if plane_kind == "zero":
        plane[:] = 0.0
    elif plane_kind == "tied":
        plane = rng.integers(-2, 3, size=(nl, R, C)).astype(np.float32)
    elif plane_kind == "nan":
        plane[:, :, 3] = np.nan
    return plane, cols, signs


# topk 1, the default 8, the 72 children of 18 (shared-memory ranking),
# 300 (1200 children: threads loop past 1024); R 1 and 2, the default 5,
# 8 (the last register sort), 9 (rank selection); bits 4, 8 and 11 (a
# plane of 13 levels that does not fit shared memory at R >= 3).
@pytest.mark.parametrize("bits", [4, 8, 11])
@pytest.mark.parametrize("R", [1, 2, 5, 8, 9])
@pytest.mark.parametrize("topk", [1, 8, 18, 300])
def test_attr_find_hh_matches_plain(cuda, topk, R, bits):
    dim = 4097
    args = [torch.as_tensor(a, device=cuda)
            for a in _find_hh_case(dim, R, bits, seed=topk * 31 + R + bits)]
    before = AE.KERNEL.launches, AE.FIND_HH_KERNEL.launches
    got = AE.attr_find_hh(*args, dim, topk)
    torch.cuda.synchronize()
    assert (AE.KERNEL.launches, AE.FIND_HH_KERNEL.launches) == (
        before[0], before[1] + 1)
    want = AE.attr_find_hh_plain(*args, dim, topk)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape == (topk,)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert _same_values(got[1], want[1])
    cpu = AE.attr_find_hh(*(a.cpu() for a in args), dim, topk)
    assert torch.equal(got[0].cpu(), cpu[0])
    assert _same_values(got[1].cpu(), cpu[1])


# topk 3000: a beam of W = 6000 lanes (264 KB) past a block's shared
# memory, so the kernel keeps it in its device workspace; bits 4 and 11
# (a plane of 13 levels past a block's shared memory; every plane is read
# from global memory); a NaN cell and tied estimates on the small plane
@pytest.mark.parametrize("bits,kind", [(4, "normal"), (4, "nan"),
                                       (4, "tied"), (11, "normal")])
@pytest.mark.parametrize("R", [5, 9])
def test_attr_find_hh_beam_in_workspace_matches_plain(cuda, R, bits, kind):
    dim, topk = 4097, 3000
    args = [torch.as_tensor(a, device=cuda)
            for a in _find_hh_case(dim, R, bits, seed=R + bits,
                                   plane_kind=kind)]
    assert not AE.beam_in_smem(topk)
    before = AE.FIND_HH_KERNEL.launches
    got = AE.attr_find_hh(*args, dim, topk)
    torch.cuda.synchronize()
    assert AE.FIND_HH_KERNEL.launches == before + 1
    want = AE.attr_find_hh_plain(*args, dim, topk)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert _same_values(got[1], want[1])


# an all-zero plane (every estimate ±0: ties to the lower index), few
# distinct values (tied estimates), a NaN cell (NaN ranks first); dims
# with one level, a power of two and one past it
@pytest.mark.parametrize("kind", ["zero", "tied", "nan"])
@pytest.mark.parametrize("dim,topk", [(2, 3), (13, 8), (48, 18),
                                      (4097, 8)])
def test_attr_find_hh_edges_match_plain(cuda, kind, dim, topk):
    args = [torch.as_tensor(a, device=cuda)
            for a in _find_hh_case(dim, 5, 8, seed=dim, plane_kind=kind)]
    got = AE.attr_find_hh(*args, dim, topk)
    want = AE.attr_find_hh_plain(*args, dim, topk)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert _same_values(got[1], want[1])
    cpu = AE.attr_find_hh(*(a.cpu() for a in args), dim, topk)
    assert torch.equal(got[0].cpu(), cpu[0])
    assert torch.equal(got[2].cpu(), cpu[2])


def test_attr_find_hh_is_the_old_per_level_composition(cuda):
    """The kernel equals the per-level loop of ``attr_estimate`` launches
    it replaced, on the card, and gives the same bits twice."""
    args = [torch.as_tensor(a, device=cuda)
            for a in _find_hh_case(4097, 5, 8, seed=7)]
    got = AE.attr_find_hh(*args, 4097, 8)
    old = AE.attr_find_hh_plain(*args, 4097, 8, estimator=AE.attr_estimate)
    assert torch.equal(got[0], old[0]) and torch.equal(got[2], old[2])
    assert _same_values(got[1], old[1])
    again = AE.attr_find_hh(*args, 4097, 8)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# ---------------------------------------------------------------------------
# ace_score_fused on srp_gemm.cuh: ids srp_hash's, scores ace_query_sum's.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("splits", [1, None])
@pytest.mark.parametrize("B", [1, 63, 64, 65, 16384])
def test_ace_score_fused_ids_and_scores_are_the_composition(cuda, B, splits):
    """At the fit's d = 36, K = 15, L = 50, under S = 1 and the card's own
    plan: the fused score's ids are ``srp_hash``'s under the same plan
    bitwise (>= 0.999 with the plain hash), its unweighted scores are
    ``ace_query_sum`` of those ids bitwise, and its
    weighted scores bitwise the plain version's where the ids agree."""
    d, K, L = 36, 15, 50
    cfg = SrpConfig(dim=d, num_bits=K, num_tables=L, seed=B)
    w = make_projections(cfg, device=cuda)
    gen = torch.Generator(cuda).manual_seed(B)
    q = torch.randn((B, d), generator=gen, device=cuda).abs()
    counts = torch.randint(0, 1 << 20, (L, 1 << K), dtype=torch.int32,
                           device=cuda, generator=gen)
    plan = _forced_plan(B, d, K, L, None, 1) if splits \
        else H.device_plan(B, d, K, L, cuda)
    before = F.KERNEL.launches
    got, ids = F.ace_score_fused_planned(counts, q, w, cfg, None, plan,
                                         with_ids=True)
    assert F.KERNEL.launches == before + 1
    assert torch.equal(ids, H.srp_hash_planned(q, w, cfg, plan))
    plain_ids = H.srp_hash_plain(q, w, cfg)
    assert _agreement(ids, plain_ids) >= HASH_AGREEMENT
    assert torch.equal(got, Q.ace_query_sum(counts, ids))
    m = torch.ones(L, device=cuda)
    m[[3, 31]] = 0.0
    tw = m / m.sum()
    weighted = F.ace_score_fused_planned(counts, q, w, cfg, tw, plan)
    same = (ids == plain_ids).all(dim=1)
    plain = F.ace_score_fused_plain(counts, q, w, cfg, table_weights=tw)
    assert torch.equal(weighted[same], plain[same])
    g = F.flat_table_gather(counts, ids)
    ref = torch.zeros(B, device=cuda)
    for j in range(L):
        ref = ref + g[:, j] * tw[j]
    assert torch.equal(weighted, ref)


def test_ace_score_fused_past_2_24_is_exact(cuda):
    """Rows whose counters sum past 2^24: the int64 sum, rounded once,
    × float32(1/L), as ``ace_query_sum`` and its plain version give it."""
    d, K, L = 36, 10, 50
    cfg = SrpConfig(dim=d, num_bits=K, num_tables=L, seed=3)
    w = make_projections(cfg, device=cuda)
    gen = torch.Generator(cuda).manual_seed(3)
    q = torch.randn((300, d), generator=gen, device=cuda)
    counts = torch.randint((1 << 25) - 99, 1 << 25, (L, 1 << K),
                           dtype=torch.int32, device=cuda, generator=gen)
    got, ids = F.ace_score_fused_planned(counts, q, w, cfg, None, None,
                                         with_ids=True)
    want = (counts[torch.arange(L, device=cuda)[None, :], ids.long()]
            .long().sum(-1).float() * torch.tensor(1.0 / L))
    assert torch.equal(got, want)
    assert torch.equal(got, Q.ace_query_sum_plain(counts, ids))


# ---------------------------------------------------------------------------
# Quantile-calibrated admission (repro_torch.quantile.sketch) on the card.
# ---------------------------------------------------------------------------

def _quantile_hists():
    """(N, NUM_BINS) histograms: unit-weight ones from rates, a weighted
    one, an empty one, all mass in one bin (first, middle, last) and a
    tail mostly in the overflow bin."""
    from repro_torch.quantile import sketch as qsk
    rng = np.random.default_rng(5)
    nb = qsk.NUM_BINS
    rows = []
    for r in (rng.uniform(0.0, 1.0, 500),
              np.minimum(rng.lognormal(-8.0, 4.0, 500), 1.2),
              np.minimum(rng.pareto(1.1, 500) * 1e-3, 1.2)):
        h = np.zeros(nb, np.float32)
        np.add.at(h, qsk.bin_index(torch.as_tensor(r.astype(np.float32)))
                  .numpy(), 1.0)
        rows.append(h)
    rows.append(np.zeros(nb, np.float32))
    for b in (0, 60, nb - 1):
        h = np.zeros(nb, np.float32)
        h[b] = 37.0
        rows.append(h)
    tail = rows[0].copy()
    tail[nb - 1] += 900.0
    rows.append(tail)
    weighted = rows[0] * rng.uniform(0.0, 3.0, nb).astype(np.float32)
    return np.stack(rows), weighted


def test_hist_quantile_and_thresholds_match_the_cpu(cuda):
    """The inverse CDF and the thresholds on the card against the CPU:
    bitwise on unit-weight histograms (integer cumulative sums), rtol 1e-6
    on a weighted one; batched rows as one call each."""
    from repro_torch.quantile import sketch as qsk
    stack, weighted = _quantile_hists()
    n = np.linspace(0.0, 3000.0, stack.shape[0]).astype(np.float32)
    for q in (0.001, 0.01, 0.02, 0.5, 0.99, 1.0):
        got = qsk.hist_quantile(torch.as_tensor(stack, device=cuda), q)
        want = qsk.hist_quantile(torch.as_tensor(stack), q)
        assert torch.equal(got.cpu(), want)
        for warmup in (0.0, 1500.0):
            t = qsk.quantile_threshold(torch.as_tensor(stack, device=cuda),
                                       torch.as_tensor(n, device=cuda), q,
                                       warmup)
            assert torch.equal(t.cpu(), qsk.quantile_threshold(
                torch.as_tensor(stack), torch.as_tensor(n), q, warmup))
        np.testing.assert_allclose(
            float(qsk.hist_quantile(torch.as_tensor(weighted, device=cuda),
                                    q)),
            float(qsk.hist_quantile(torch.as_tensor(weighted), q)),
            rtol=1e-6)


def test_bin_index_and_observe_fleet_match_the_cpu(cuda):
    """``bin_index`` on the card against the CPU, ±1 bin only for a rate
    within 4 ulp of an edge (CUDA's ``logf`` may differ by an ulp); then
    ``observe_rates_fleet`` bitwise the CPU's on rates clear of the
    edges (the atomics add unit weights, exact in any order)."""
    from repro_torch.quantile import sketch as qsk
    rng = np.random.default_rng(6)
    L = 50
    k = rng.integers(0, 4096 * L, 200_000)
    r = ((k.astype(np.float32) * np.float32(1.0 / L))
         / np.float32(4096.0)).astype(np.float32)
    got = qsk.bin_index(torch.as_tensor(r, device=cuda)).cpu().numpy()
    want = qsk.bin_index(torch.as_tensor(r)).numpy()
    bad = got != want
    if bad.any():
        gap = np.min(np.abs(qsk._EDGES_NP[None, :] - r[bad][:, None]), 1)
        assert (np.abs(got[bad] - want[bad]) <= 1).all()
        assert (gap <= 4 * np.spacing(r[bad])).all()
    edges = qsk._EDGES_NP.astype(np.float64)
    b = rng.integers(1, qsk.NUM_BINS - 1, 100_000)
    mid = np.sqrt(edges[b] * edges[b + 1]).astype(np.float32)
    T = 7
    tids = rng.integers(0, T, mid.size).astype(np.int32)
    mask = (rng.uniform(size=mid.size) < 0.8).astype(np.float32)
    out = qsk.observe_rates_fleet(
        qsk.init_hist(T, device=cuda), torch.as_tensor(mid, device=cuda),
        torch.as_tensor(tids, device=cuda),
        torch.as_tensor(mask, device=cuda))
    assert torch.equal(out.cpu(), qsk.observe_rates_fleet(
        qsk.init_hist(T), torch.as_tensor(mid), torch.as_tensor(tids),
        torch.as_tensor(mask)))


QUANTILE_GUARDS = {"flat": {}, "window": dict(window_epochs=3,
                                              window_decay=0.9,
                                              rotate_every=2),
                   "fleet": dict(num_tenants=4),
                   "fleet_window": dict(num_tenants=4, window_epochs=3,
                                        window_decay=0.9, rotate_every=2)}


@pytest.mark.parametrize("kind", sorted(QUANTILE_GUARDS))
def test_quantile_guardrail_kernels_match_plain_path(cuda, kind):
    """Each flavour's quantile admit through the kernels against the
    plain path on the card, from the same state before every admit:
    verdicts equal on every row whose ids agree, and when all agree the
    histograms, counts and n bitwise."""
    gcfg = GuardrailConfig(d_model=96, num_bits=10, num_tables=20,
                           warmup_items=64.0, threshold_mode="quantile",
                           quantile_q=0.05, **QUANTILE_GUARDS[kind])
    gk = Guardrail(gcfg, use_kernels=True, device=cuda)
    gp = Guardrail(gcfg, use_kernels=False, device=cuda, w=gk.w)
    T = gcfg.num_tenants if gcfg.num_tenants > 1 else None
    rng = np.random.default_rng(3)
    all_agree = True
    for e in _guardrail_batches(8, 96):
        t = None if T is None else rng.integers(0, T, 64).astype(np.int32)
        gp.state = type(gk.state)(*(None if x is None else x.clone()
                                    for x in gk.state))
        f = mean_embed_features(torch.as_tensor(e, device=cuda),
                                gcfg.bias_const)
        f = torch.where(torch.isfinite(f).all(dim=1)[:, None], f, 0.0)
        ids_k = H.srp_hash(f, gk.w, gk.ace_cfg.srp)
        ids_p = H.srp_hash_plain(f, gk.w, gk.ace_cfg.srp)
        agree = (ids_k == ids_p).all(dim=1).cpu().numpy()
        all_agree &= bool(agree.all())
        mk, mp = gk.admit(e, t), gp.admit(e, t)
        np.testing.assert_array_equal(mk[agree], mp[agree])
        if agree.all():
            assert torch.equal(gk.state.qhist, gp.state.qhist)
            assert torch.equal(gk.state.counts, gp.state.counts)
            assert torch.equal(gk.state.n, gp.state.n)
    assert float(gk.state.qhist.sum()) > 0
    assert gk.quarantined == gp.quarantined == 8


@pytest.mark.parametrize("kind", ["flat", "window", "fleet"])
def test_quantile_consume_has_no_host_sync(cuda, kind):
    """A quantile ``StreamRunner.consume`` under sync-debug "error": the
    threshold's inverse CDF and the histogram's observation sync nothing
    with the host."""
    kw = dict(d_model=96, num_bits=10, num_tables=20, warmup_items=200.0,
              threshold_mode="quantile", quantile_q=0.02, device=cuda)
    filt = {"flat": lambda: AceDataFilter(**kw),
            "window": lambda: WindowedAceFilter(**kw, num_epochs=3,
                                                rotate_every=2),
            "fleet": lambda: FleetDataFilter(**kw, num_tenants=4)}[kind]()
    runner = StreamRunner(filt, 4)
    st, w = runner.init()
    rng = np.random.default_rng(0)
    for c in range(3):
        f = rng.normal(size=(4, 64, 97)).astype(np.float32)
        f[:, 0, 0] = np.nan
        chunk = torch.as_tensor(f, device=cuda)
        tids = (torch.as_tensor(rng.integers(0, 4, (4, 64)), dtype=torch.int32,
                                device=cuda) if kind == "fleet" else None)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            st, summary = runner.consume(st, w, chunk, tids)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert int(runner.fetch(summary).quarantined) == 4
    assert 0 < float(st.qhist.sum()) <= 3 * 4 * 63


# ---------------------------------------------------------------------------
# Count dtypes: int16, int8 and float32 counters through the seven kernels
# that read or add them.
# ---------------------------------------------------------------------------

COUNT_DTYPES = [torch.int16, torch.int8, torch.float32]


def _plane(shape, dtype, device, seed=1, hi=9):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, hi, size=shape),
                           device=device).to(dtype)


@pytest.mark.parametrize("dtype", COUNT_DTYPES)
@pytest.mark.parametrize("B,K,L,repeat", [(1, 2, 1, 1), (40, 4, 3, 4),
                                          (257, 15, 50, 2)])
def test_count_dtypes_update_and_query_match_plain(cuda, dtype, B, K, L,
                                                   repeat):
    """``ace_update`` (with and without a row mask), the (B, L) gather and
    ``ace_query_sum`` in every scale on a narrow or float plane, bitwise
    the plain versions, repeated rows included (int8 and int16 counters
    of one 32-bit word retried against each other)."""
    ids = _ids(B, K, L, cuda, seed=3, repeat=repeat)
    mask = torch.rand(ids.shape[0], device=cuda) < 0.6
    for m in (None, mask):
        c = _plane((L, 1 << K), dtype, cuda)
        got = U.ace_update(c.clone(), ids, row_mask=m)
        assert torch.equal(got, U.ace_update_plain(c.clone(), ids, m))
    assert torch.equal(Q.ace_query(got, ids), Q.ace_query_plain(got, ids))
    tm = (torch.arange(L, device=cuda) % 3 != 1).float()
    for scale in Q.SCALES:
        for t in (None, tm):
            assert torch.equal(
                Q.ace_query_sum(got, ids, table_mask=t, scale=scale),
                Q.ace_query_sum_plain(got, ids, table_mask=t, scale=scale))


@pytest.mark.parametrize("dtype", [torch.int16, torch.int8])
def test_narrow_adds_wrap_and_contend_like_plain(cuda, dtype):
    """From the cap a narrow counter wraps, add for add; 4096 rows on the
    four neighbouring int8 buckets of one word (or two int16 ones) all
    land."""
    cap = torch.iinfo(dtype).max
    B, L, K = 4096, 3, 10
    c = _plane((L, 1 << K), dtype, cuda)
    c[:, 5] = cap
    hot = torch.full((B, L), 5, dtype=torch.int32, device=cuda)
    got = U.ace_update(c.clone(), hot)
    want = (c[:, 5].long() + B).to(dtype)
    assert torch.equal(got[:, 5], want)
    assert torch.equal(got, U.ace_update_plain(c.clone(), hot))
    word = (8 + torch.arange(B, device=cuda) % 4)[:, None].expand(B, L) \
        .to(torch.int32).contiguous()
    mask = torch.rand(B, device=cuda) < 0.5
    for m in (None, mask):
        assert torch.equal(U.ace_update(c.clone(), word, row_mask=m),
                           U.ace_update_plain(c.clone(), word, m))


def test_narrow_plane_off_a_word_boundary_refused(cuda):
    """The narrow add is a compare-and-swap of the aligned word: a plane
    that does not start 4-byte aligned is refused, not half-written."""
    c = torch.zeros(4 * 16 + 1, dtype=torch.int8, device=cuda)[1:].view(4, 16)
    with pytest.raises(ValueError, match="aligned"):
        U.ace_update(c, torch.zeros((2, 4), dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("dtype", COUNT_DTYPES)
def test_count_dtypes_fused_kernels_match_plain(cuda, dtype):
    """The four hash-fused kernels and the window combine on a narrow or
    float plane: bitwise their plain versions downstream of the kernel's
    own ids, colliding copies included."""
    B, d, K, L, T, E = 65, 36, 12, 20, 3, 2
    cfg = SrpConfig(dim=d, num_bits=K, num_tables=L, seed=5)
    w = make_projections(cfg, device=cuda)
    x = torch.randn((B, d), device=cuda)
    x = torch.cat([x, x[:16]]).contiguous()
    Bx = x.shape[0]
    counts = _plane((L, 1 << K), dtype, cuda, seed=6)
    thresh = torch.tensor(2.0, device=cuda)
    c, s, a, b = A.ace_admit_fused(counts.clone(), x, w, thresh, cfg)
    rows = torch.arange(L, device=cuda)[None, :]
    ref_s = counts[rows, b.long()].float().sum(-1) \
        * torch.tensor(1.0 / L, dtype=torch.float32)
    assert torch.equal(s, ref_s) and torch.equal(a, ref_s >= thresh)
    assert torch.equal(c, counts.clone().index_put_(
        (rows, b.long()), a.to(dtype)[:, None].expand(b.shape),
        accumulate=True))
    s, ids = F.ace_score_fused_planned(counts, x, w, cfg, None, None,
                                       with_ids=True)
    assert torch.equal(s, Q.ace_query_sum(counts, ids))
    tids = (torch.arange(Bx, device=cuda) % T).to(torch.int32)
    fleet = _plane((T, L, 1 << K), dtype, cuda, seed=7)
    s, fids = FS.ace_fleet_score_planned(fleet, x, tids, w, cfg, None,
                                         with_ids=True)
    assert torch.equal(s, FS.fleet_score_from_ids(fleet, fids, tids))
    ring = _plane((T, E, L, 1 << K), dtype, cuda, seed=8)
    tail = _plane((T, L, 1 << K), torch.float32, cuda, seed=9, hi=30) * 0.5
    cursor = torch.tensor([1, 0, 1], dtype=torch.int32, device=cuda)
    thr = torch.tensor([3.0, 5.0, float("-inf")], device=cuda)
    r = ring.clone()
    out = FWA.ace_fleet_window_admit_fused(r, tail, cursor, x, tids, w, thr,
                                           cfg)
    r_ref = ring.clone()
    ref = FWA.fleet_window_admit_from_ids(r_ref, tail, cursor, out[3], tids,
                                          thr)
    assert torch.equal(r, r_ref)
    for got, want in zip((out[1], out[2], out[4], out[5]), ref):
        assert torch.equal(got, want)
    weights = torch.tensor([1.0, 0.7], device=cuda)
    for tw in (None, torch.full((L,), 1.0 / L, device=cuda)):
        assert torch.equal(
            WC.ace_window_combine(ring[0], ids, weights, tw),
            WC.ace_window_combine_plain(ring[0], ids, weights, tw))


def test_quantized_consume_has_no_host_sync(cuda):
    """An int8 filter with promotion under sync-debug "error": the exact
    saturating scatter (``core.quantize``) has fixed shapes and syncs
    nothing with the host, and counters pass 127 into the table."""
    kw = dict(d_model=96, num_bits=3, num_tables=8, warmup_items=1e9,
              count_dtype="int8", esc_capacity=64, device=cuda)
    runner = StreamRunner(AceDataFilter(**kw), 4)
    st, w = runner.init()
    rng = np.random.default_rng(0)
    for c in range(3):
        chunk = torch.as_tensor(rng.normal(size=(4, 64, 97))
                                .astype(np.float32), device=cuda)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            st, summary = runner.consume(st, w, chunk)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    from repro_torch.core import quantize as qz
    assert float(runner.fetch(summary).n) == 3 * 4 * 64
    assert int((st.esc.offs != qz.SENTINEL).sum()) > 0
    assert float(st.esc.lost) == 0.0
    assert int(qz.densify(st.counts, st.esc).sum(1)[0]) == 3 * 4 * 64


# ---------------------------------------------------------------------------
# Resilience: degraded admission, an all-masked tenant, the audit of the
# full ring, and no sync inside a degraded admit.
# ---------------------------------------------------------------------------

def _degrade(g, seed=7, tables=(1, 5)):
    """Flip two bits in each of ``tables`` of the guardrail's counts and
    audit it; returns the host report."""
    from repro_torch import resilience as rz
    counts = g.state.counts
    for t in tables:
        gen = torch.Generator(device=counts.device).manual_seed(seed + t)
        counts = rz.flip_count_bits(counts, gen, num_flips=2, tables=(t,))
    g.state = g.state._replace(counts=counts)
    return g.health_check()


def _mirror(dst, src):
    """``dst`` takes ``src``'s state (cloned) and health state."""
    dst.state = type(src.state)(*(None if x is None else x.clone()
                                  for x in src.state))
    dst._table_mask = None if src._table_mask is None \
        else src._table_mask.clone()
    dst._repair_offsets = None if src._repair_offsets is None \
        else src._repair_offsets.clone()
    dst._rewarm_admits = src._rewarm_admits
    dst._rewarming = src._rewarming


@pytest.mark.parametrize("kind", sorted(QUANTILE_GUARDS))
def test_degraded_guardrail_kernels_match_plain_path(cuda, kind):
    """Each flavour degraded (bit flips found by ``health_check``):
    through the kernels against the plain path from the same state before
    every admit, verdicts equal on every row whose ids agree; the degraded
    route launches the hash, the masked sum and the insert, never the
    fused admissions; ``repair`` then re-warms it back to the healthy
    route."""
    gcfg = GuardrailConfig(d_model=96, num_bits=10, num_tables=20,
                           warmup_items=64.0, **QUANTILE_GUARDS[kind])
    gk = Guardrail(gcfg, use_kernels=True, device=cuda)
    gp = Guardrail(gcfg, use_kernels=False, device=cuda, w=gk.w)
    T = gcfg.num_tenants if gcfg.num_tenants > 1 else None
    t = None if T is None else np.arange(64, dtype=np.int32) % T
    batches = [next(g) for g in [_guardrail_batches(48, 96)]
               for _ in range(24)]             # the on-topic half
    for e in batches[:6]:
        gk.admit(np.nan_to_num(e), t)
    rep = _degrade(gk)
    assert gk.degraded and not rep.table_ok.all()
    kernels = (H.KERNEL, Q.KERNEL, U.KERNEL, A.KERNEL, FWA.KERNEL)
    for e in batches[6:12]:
        _mirror(gp, gk)
        f = mean_embed_features(torch.as_tensor(e, device=cuda),
                                gcfg.bias_const)
        f = torch.where(torch.isfinite(f).all(dim=1)[:, None], f, 0.0)
        agree = (H.srp_hash(f, gk.w, gk.ace_cfg.srp)
                 == H.srp_hash_plain(f, gk.w, gk.ace_cfg.srp)).all(
                     dim=1).cpu().numpy()
        before = [k.launches for k in kernels]
        mk = gk.admit(e, t)
        got = [k.launches - b for k, b in zip(kernels, before)]
        mp = gp.admit(e, t)
        np.testing.assert_array_equal(mk[agree], mp[agree])
        assert got[0] == 1 and got[1] >= 1 and got[2] == 1, got
        assert got[3] == 0 and got[4] == 0, "no fused admission degraded"
        assert gk.degraded and gp.degraded
    _mirror(gp, gk)
    assert rep.table_ok.shape == gp.health_check().table_ok.shape
    pre = gk.repair()
    # (a window may have rotated the flipped epochs out already)
    assert gk.degraded == (not pre.table_ok.all())
    for e in batches[12:]:
        gk.admit(np.nan_to_num(e), t)
        gk.health_check()
        if not gk.degraded:
            break
    assert not gk.degraded
    before = [k.launches for k in kernels]
    gk.admit(np.nan_to_num(batches[0]), t)
    fused = {"flat": 3, "fleet_window": 4}.get(kind)
    if fused is not None:
        assert kernels[fused].launches == before[fused] + 1


@pytest.mark.parametrize("windowed", [False, True])
def test_all_masked_tenant_kernels_match_plain_path(cuda, windowed):
    """A fleet tenant with every table masked: the masked means and the
    thresholds divide by a clamped healthy count; kernel ≡ plain on the
    card and ≡ the CPU's plain path on the same state."""
    kw = dict(num_tenants=4) if not windowed else QUANTILE_GUARDS[
        "fleet_window"]
    gcfg = GuardrailConfig(d_model=96, num_bits=10, num_tables=20,
                           warmup_items=64.0, **kw)
    gk = Guardrail(gcfg, use_kernels=True, device=cuda)
    t = np.arange(64, dtype=np.int32) % 4
    batches = list(_guardrail_batches(8, 96))
    for e in batches[:4]:
        gk.admit(e, t)
    mask = torch.ones((4, 20), device=cuda)
    mask[2] = 0.0
    mask[0, :7] = 0.0
    gk._table_mask = mask
    gp = Guardrail(gcfg, use_kernels=False, device=cuda, w=gk.w)
    gc = Guardrail(gcfg, use_kernels=False, device="cpu", w=gk.w.cpu())
    for e in batches[4:]:
        _mirror(gp, gk)
        gc.state = type(gk.state)(*(None if x is None
                                    else x.to("cpu", copy=True)
                                    for x in gk.state))
        gc._table_mask = mask.cpu()
        f = mean_embed_features(torch.as_tensor(e, device=cuda),
                                gcfg.bias_const)
        f = torch.where(torch.isfinite(f).all(dim=1)[:, None], f, 0.0)
        agree = (H.srp_hash(f, gk.w, gk.ace_cfg.srp)
                 == H.srp_hash_plain(f, gk.w, gk.ace_cfg.srp)).all(
                     dim=1).cpu().numpy()
        mk, mp, mc = gk.admit(e, t), gp.admit(e, t), gc.admit(e, t)
        np.testing.assert_array_equal(mk[agree], mp[agree])
        np.testing.assert_array_equal(mp, mc)
    assert gk.degraded


def test_health_check_of_the_full_ring_matches_the_cpu(cuda):
    """The windowed fleet's full (8, 4, 50, 2^15) int32 ring (210 MB)
    audited on the card equals the CPU's audit of the same state, before
    and after flips (the float32 conservation sums a block of rows at a
    time), and its repair likewise (ssq rtol 1e-6)."""
    from repro_torch import resilience as rz
    from repro_torch.fleet import window as fw
    from repro_torch.window import ring
    wcfg = ring.WindowConfig(ace=sk.AceConfig(dim=8, num_bits=15,
                                              num_tables=50),
                             num_epochs=4, decay=0.9, rotate_every=4)
    st = fw.init_fleet_window(wcfg, 8, cuda)
    rng = np.random.default_rng(0)
    counts = torch.as_tensor(rng.integers(0, 3, size=st.counts.shape,
                                          dtype=np.int32), device=cuda)
    n = counts.sum(dim=-1, dtype=torch.int64).amax(dim=-1).float()
    st = st._replace(counts=counts, n=n,
                     tail=torch.as_tensor(rng.random(st.tail.shape,
                                                     dtype=np.float32),
                                          device=cuda))
    gen = torch.Generator(device=cuda).manual_seed(1)
    for c in (st.counts, rz.flip_count_bits(st.counts, gen, num_flips=40,
                                            tables=(3, 17, 44))):
        s = st._replace(counts=c)
        got = rz.health_check(s)
        cpu = type(s)(*(None if x is None else x.cpu() for x in s))
        want = rz.health_check(cpu)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
        fixed = rz.repair_fleet_window(s, got.table_ok)
        ref = rz.repair_fleet_window(cpu, want.table_ok)
        assert torch.equal(fixed.counts.cpu(), ref.counts)
        assert torch.equal(fixed.tail.cpu(), ref.tail)
        torch.testing.assert_close(fixed.ssq.cpu(), ref.ssq, rtol=1e-6,
                                   atol=0.0)
    assert not bool(got.ok.all())


@pytest.mark.parametrize("kind", sorted(QUANTILE_GUARDS))
def test_degraded_admit_has_no_host_sync(cuda, kind):
    """The degraded admission on the device under sync-debug "error": the
    health mask is a device operand; the only sync of an admit is its one
    transfer, outside."""
    gcfg = GuardrailConfig(d_model=96, num_bits=10, num_tables=20,
                           warmup_items=64.0, **QUANTILE_GUARDS[kind])
    g = Guardrail(gcfg, device=cuda)
    T = gcfg.num_tenants if gcfg.num_tenants > 1 else None
    t = None if T is None else np.arange(64, dtype=np.int32) % T
    batches = list(_guardrail_batches(6, 96))
    for e in batches[:4]:
        g.admit(e, t)
    _degrade(g)
    assert g.degraded
    dt = None if t is None else torch.as_tensor(t, device=cuda)
    for e in batches[4:]:
        emb = torch.as_tensor(e, device=cuda)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            packed = g._admit_device(emb, dt)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert packed.shape == (2, 64)


class _Recorder:
    """A guardrail behind a front end that also feeds every padded batch
    to a twin guardrail, keeping the twin's verdicts of the non-pad rows
    in service order."""

    def __init__(self, g, twin):
        self.g, self.twin, self.twin_rows = g, twin, []

    multi_tenant = property(lambda self: self.g.multi_tenant)
    fail_open_mask = property(lambda self: self.g.fail_open_mask)

    def admit(self, embeds, tenants=None):
        args = (embeds,) if tenants is None else (embeds, tenants)
        v = self.g.admit(*args)
        real = ~np.isnan(embeds[:, 0, 0])
        self.twin_rows.extend(self.twin.admit(*args)[real].tolist())
        return v


@pytest.mark.parametrize("kind", sorted(QUANTILE_GUARDS))
def test_frontend_lockstep_and_no_sync_shed(cuda, kind):
    """The front end over each guardrail flavour on the card: the served
    tickets' verdicts are bitwise a twin guardrail's (same W, same initial
    state) fed the same padded batches; every shed answers its tenant's
    policy; pads are the only quarantined rows; and a full-queue burst
    plus deadline sheds run under sync-debug "error" (a shed reads the
    host policy only)."""
    from repro_torch.serve.frontend import FrontEnd, FrontEndConfig
    kw = QUANTILE_GUARDS[kind]
    T = kw.get("num_tenants", 1)
    pol = tuple("fail_open" if t % 2 == 0 else "fail_closed"
                for t in range(T))
    gcfg = GuardrailConfig(d_model=96, num_bits=10, num_tables=20,
                           warmup_items=64.0, fail_policy=pol, **kw)
    g = Guardrail(gcfg, device=cuda)
    twin = Guardrail(gcfg, device=cuda, w=g.w.clone())
    rec = _Recorder(g, twin)
    fe = FrontEnd(rec, FrontEndConfig(batch_size=64, seq=4, d_model=96,
                                      max_queue=128))
    rng = np.random.default_rng(3)
    pool = list(_guardrail_batches(16, 96))          # (64, 4, 96) each
    tickets = []
    for k in range(700):
        tickets.append(fe.submit(np.nan_to_num(pool[k % 16][k % 64]),
                                 tenant=int(rng.integers(0, T)),
                                 deadline=None if k % 9 else -1.0))
        if fe.ready():
            fe.pump()
    fe.drain()
    served = [t.admitted for t in tickets if t.status == "served"]
    assert served == rec.twin_rows and len(served) > 0
    mask = g.fail_open_mask
    for t in tickets:
        if t.status == "shed":
            assert t.admitted is bool(mask[t.tenant if T > 1 else 0])
    assert g.quarantined == fe.pad_rows
    m = fe.metrics()
    assert m["served"] + m["shed_queue_full"] + m["shed_deadline"] == 700
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        burst = [fe.submit(pool[0][i % 64], tenant=i % T, deadline=-1.0)
                 for i in range(300)]
        assert fe.pump() == 0                   # every queued one sheds
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(t.status == "shed" for t in burst)
    assert fe.queue_len == 0


def test_private_hash_at_sigma_zero_is_the_srp_hash_kernel(cuda):
    """σ = 0: the private ids (the plain projection, TF32 off) agree with
    the ``srp_hash`` kernel's on >= 0.999 of them, at the KDD width."""
    from repro_torch.core import privacy
    cfg = SrpConfig(dim=37, num_bits=15, num_tables=50)
    w = make_projections(cfg, device=cuda)
    x = torch.rand((20_000, 37), generator=torch.Generator(
        device=cuda).manual_seed(2), device=cuda)
    before = H.KERNEL.launches
    want = H.srp_hash(x, w, cfg)
    assert H.KERNEL.launches == before + 1
    got = privacy.private_hash_buckets(
        x, w, cfg, torch.Generator(device=cuda).manual_seed(0), 0.0)
    assert _agreement(got, want) >= HASH_AGREEMENT


def test_knn_graph_on_the_card_matches_the_cpu(cuda):
    """The chunked kNN graph at n = 5000 (three chunks and a ragged one)
    on the card and on the CPU, each held to a float64 witness: every
    distance within the expansion's forward error of |a − b| computed
    directly in float64 — γ_{d+2}·(|a| + |b|)² / |a − b| from the norms'
    and dot products' rounding in any order, through the square root,
    plus the root's own u·|a − b| — so a failure names the side that is
    off; indices equal on >= 0.999 of the entries (a near tie may swap
    two neighbours)."""
    from repro_torch.baselines.knn_graph import knn_graph
    rng = np.random.default_rng(4)
    x = np.abs(rng.normal(size=(5000, 36)) + 1.0).astype(np.float32)
    dg, ig = knn_graph(x, 10, chunk=1536, device=cuda)
    dc, ic = knn_graph(x, 10, chunk=1536, device="cpu")
    u = 2.0**-24
    gamma = (x.shape[1] + 2) * u / (1 - (x.shape[1] + 2) * u)
    x64 = x.astype(np.float64)
    norm = np.linalg.norm(x64, axis=1)
    for side, d, i in (("card", dg.cpu().numpy(), ig.cpu().numpy()),
                       ("cpu", dc.numpy(), ic.numpy())):
        exact = np.linalg.norm(x64[:, None, :] - x64[i], axis=-1)
        bound = gamma * (norm[:, None] + norm[i])**2 / exact + u * exact
        ratio = np.abs(d - exact) / bound
        assert ratio.max() <= 1.0, (side, float(ratio.max()),
                                    int((ratio > 1.0).sum()))
    assert _agreement(ig.cpu(), ic) >= 0.999


# ---------------------------------------------------------------------------
# The model zoo's attention family (repro_torch.models) on the card against
# the CPU, in float32 with TF32 off: logits within rtol / atol 2e-4 (the
# reference's model bound, tests/test_archs.py:122), greedy tokens, MoE
# routing and drops exact.
# ---------------------------------------------------------------------------

def _model_on_both(cuda, name, **kw):
    """A reduced Arch with ``kw`` and its weights (drawn on the CPU) on the
    card and on the CPU."""
    import dataclasses
    from repro_torch.models import Arch
    a = Arch(name, reduced=True)
    a.cfg = dataclasses.replace(a.cfg, **kw)
    cpu = a.init_params(7, device="cpu")
    if "rwkv" in a.cfg.block_pattern:
        _redraw_rwkv_zeros(cpu)

    def move(tree):
        if isinstance(tree, torch.Tensor):
            return tree.to(cuda)
        if isinstance(tree, dict):
            return {k: move(v) for k, v in tree.items()}
        return [move(v) for v in tree]

    return a, move(cpu), cpu


def _redraw_rwkv_zeros(params, seed=11):
    """RWKV's time-mix ``wo`` and channel-mix ``wv`` are zeros at init, so
    every block would add exactly 0: redraw them, std 1/√fan-in."""
    gen = torch.Generator().manual_seed(seed)
    for row in params["blocks"]:
        for b in row:
            for d, name in (b["mixer"], "wo"), (b["mlp"], "wv"):
                d[name] = torch.randn(d[name].shape, generator=gen) \
                    / d[name].shape[0] ** 0.5


def _decode_both(cuda, a, card, cpu, prompt, pos, s_max):
    """Prefill ``prompt`` then one decode step at ``pos`` on both devices:
    the (prefill, decode) logits of each and the decode caches."""
    out = []
    for dev, p in ((cuda, card), (torch.device("cpu"), cpu)):
        toks = torch.as_tensor(prompt, device=dev)
        last, cache = a.prefill(p, {"tokens": toks}, s_max=s_max)
        nxt = torch.argmax(last[:, -1], dim=-1).to(torch.int32)
        step, cache = a.decode_step(
            p, {"tokens": nxt[:, None]}, cache,
            torch.full((toks.shape[0],), pos, dtype=torch.int32, device=dev))
        out.append((last.cpu(), step.cpu(), cache))
    return out


def test_model_decode_ring_wrap_card_vs_cpu(cuda):
    """GQA (8 heads on 2 kv heads) with every layer "swa" and a ring
    cache of the window's 8 slots: a prompt of 6, then one step at
    position 13, past the ring's wrap (slot 5; the slots of positions
    6-12 never written)."""
    a, card, cpu = _model_on_both(cuda, "mixtral_8x7b", num_heads=8,
                                  num_kv_heads=2, head_dim=16,
                                  sliding_window=8)
    prompt = np.random.default_rng(1).integers(
        0, a.cfg.vocab_size, (3, 6)).astype(np.int32)
    (gl, gs, gc), (cl, cs, cc) = _decode_both(cuda, a, card, cpu, prompt,
                                              13, 8)
    torch.testing.assert_close(gl, cl, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(gs, cs, rtol=2e-4, atol=2e-4)
    assert torch.equal(gs.argmax(-1), cs.argmax(-1))
    for g_row, c_row in zip(gc, cc):
        for g, c in zip(g_row, c_row):
            torch.testing.assert_close(g.k.cpu(), c.k, rtol=1e-5, atol=1e-5)
            assert bool((g.k[:, 6:] == 0).all())    # slots never written


def test_model_moe_drops_card_vs_cpu(cuda):
    """Mixtral's reduced MoE at capacity factor 1.0 (tokens dropped) with
    two router columns equal (ties): the routing, ``keep`` and
    ``moe_drop_frac`` exact, the forward's logits within 2e-4."""
    from repro_torch.models import mlp
    a, card, cpu = _model_on_both(cuda, "mixtral_8x7b",
                                  moe_capacity_factor=1.0)
    for p in (card, cpu):
        r = p["blocks"][0][0]["mlp"]["router"]
        r[:, 3] = r[:, 2]
    toks = np.random.default_rng(2).integers(
        0, a.cfg.vocab_size, (4, 16)).astype(np.int32)
    outs = []
    for dev, p in ((cuda, card), (torch.device("cpu"), cpu)):
        t = torch.as_tensor(toks, device=dev)
        logits, aux = a.forward(p, {"tokens": t})
        x = p["embed"][t.long()].reshape(1, -1, a.cfg.d_model)
        route = mlp.route(p["blocks"][0][0]["mlp"], x, a.cfg,
                          mlp.capacity(a.cfg, x.shape[1]))
        outs.append((logits.cpu(), float(aux["moe_drop_frac"]),
                     route.top_idx.cpu(), route.keep.cpu()))
    (gl, gd, gi, gk), (cl, cd, ci, ck) = outs
    assert torch.equal(gi, ci) and torch.equal(gk, ck)
    assert not bool(ck.all()), "capacity 1.0 drops here"
    assert gd == cd and cd > 0
    torch.testing.assert_close(gl, cl, rtol=2e-4, atol=2e-4)


def test_model_gemma2_softcaps_and_sandwich_card_vs_cpu(cuda):
    """gemma2's reduced model (local "swa" + global "attn", logit softcaps
    50 and 30, sandwich norms, scaled and tied embeddings): prefill and
    one decode step on both, logits within 2e-4 and inside the final
    cap."""
    a, card, cpu = _model_on_both(cuda, "gemma2_27b")
    prompt = np.random.default_rng(3).integers(
        0, a.cfg.vocab_size, (2, 20)).astype(np.int32)
    (gl, gs, _), (cl, cs, _) = _decode_both(cuda, a, card, cpu, prompt,
                                            20, 24)
    torch.testing.assert_close(gl, cl, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(gs, cs, rtol=2e-4, atol=2e-4)
    assert float(gs.abs().max()) <= a.cfg.final_logit_softcap


def _greedy(a, p, batch, new, s_max):
    """Prefill, then greedy decode keeping every step's logits: (tokens
    (B, new), logits (B, new, V))."""
    logits, cache = a.prefill(p, batch, s_max=s_max)
    B, P = batch["tokens"].shape
    outs, toks = [logits[:, -1]], []
    for i in range(new):
        toks.append(torch.argmax(outs[-1], dim=-1).to(torch.int32))
        if i == new - 1:
            break
        pos = torch.full((B,), P + i, dtype=torch.int32,
                         device=toks[-1].device)
        logits, cache = a.decode_step(p, {"tokens": toks[-1][:, None]},
                                      cache, pos)
        outs.append(logits[:, -1])
    return torch.stack(toks, 1), torch.stack(outs, 1)


@pytest.mark.parametrize("name", ["jamba_v01_52b", "rwkv6_7b",
                                  "whisper_tiny"])
def test_model_zoo_family_card_vs_cpu(cuda, name):
    """The reduced jamba (Mamba scan and steps, MoE, one attention layer),
    rwkv6 (``wo`` and ``wv`` redrawn) and whisper (encoder over 50 frames,
    cross-attention): prefill of 12 tokens and 8 greedy steps on the card
    against the CPU, logits within 2e-4 and tokens equal."""
    a, card, cpu = _model_on_both(cuda, name)
    gen = torch.Generator().manual_seed(8)
    batch = {"tokens": torch.randint(0, a.cfg.vocab_size, (3, 12),
                                     generator=gen, dtype=torch.int32)}
    if a.cfg.encoder_layers:
        batch["embeds"] = torch.randn((3, a.cfg.encoder_seq, a.cfg.d_model),
                                      generator=gen)
    ctoks, clogits = _greedy(a, cpu, batch, 8, 20)
    gtoks, glogits = _greedy(a, card, {k: v.to(cuda)
                                       for k, v in batch.items()}, 8, 20)
    torch.testing.assert_close(glogits.cpu(), clogits, rtol=2e-4, atol=2e-4)
    assert torch.equal(gtoks.cpu(), ctoks)


# bf16 and fp16 hash operands: (x dtype, W dtype) pairs with a narrow one.
NARROW_PAIRS = [(torch.bfloat16, torch.bfloat16),
                (torch.float32, torch.bfloat16),
                (torch.float16, torch.float16),
                (torch.float16, torch.float32)]


def _narrow_case(B, d, K, L, xdt, wdt, device, seed=0):
    cfg = SrpConfig(dim=d, num_bits=K, num_tables=L, seed=seed + d)
    w = make_projections(cfg, device=device, dtype=wdt)
    x = torch.randn((B, d), generator=torch.Generator().manual_seed(seed)) \
        .to(device=device, dtype=xdt)
    return cfg, x, w


@pytest.mark.parametrize("splits", range(1, H.MAX_SPLITS + 1))
@pytest.mark.parametrize("B", [1, 63, 64, 65])
@pytest.mark.parametrize("xdt,wdt", NARROW_PAIRS, ids=str)
def test_dense_hash_narrow_operands(cuda, xdt, wdt, B, splits):
    """Narrow x and W at d = 4097 (a 2-byte x row starts only 2-byte
    aligned) under every cluster size: the kernel widens each element as
    it stages it, so its ids are the float32 kernel's on the widened
    operands, bitwise, and agree with the plain version at >= 0.999."""
    d, K, L = 4097, 15, 50
    cfg, x, w = _narrow_case(B, d, K, L, xdt, wdt, cuda, seed=B)
    plan = H.make_plan(B, d, K, L, H.tables_per_group(K, L), splits)
    before = H.KERNEL.launches
    got = H.srp_hash_planned(x, w, cfg, plan)
    assert H.KERNEL.launches == before + 1
    assert torch.equal(got, H.srp_hash_planned(x.float(), w.float(), cfg,
                                               plan))
    assert _agreement(got, H.srp_hash_plain(x, w, cfg)) >= HASH_AGREEMENT


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("d", [1, 5, 17, 4097])
@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float16], ids=str)
def test_dense_hash_narrow_x_off_a_word(cuda, xdt, d, splits):
    """A 2-byte x whose first element sits 2 bytes past a 4-byte boundary
    (a view one element into its buffer): the kernel copies each row's
    aligned words and takes its elements from the row's skew, so its ids
    are still the float32 kernel's on x.float(), bitwise."""
    B, K, L = 65, 15, 50
    cfg, _, w = _narrow_case(B, d, K, L, xdt, torch.bfloat16, cuda, seed=d)
    buf = torch.randn(B * d + 1, generator=torch.Generator().manual_seed(d))
    x = buf.to(device=cuda, dtype=xdt)[1:].view(B, d)
    assert x.data_ptr() % 4 == 2
    plan = H.make_plan(B, d, K, L, H.tables_per_group(K, L), splits)
    got = H.srp_hash_planned(x, w, cfg, plan)
    assert torch.equal(got, H.srp_hash_planned(x.float(), w.float(), cfg,
                                               plan))
    assert _agreement(got, H.srp_hash_plain(x, w, cfg)) >= HASH_AGREEMENT


@pytest.mark.parametrize("xdt,wdt", NARROW_PAIRS, ids=str)
def test_fused_hash_kernels_take_narrow_operands(cuda, xdt, wdt):
    """``ace_admit_fused``, ``ace_score_fused``, ``ace_fleet_score`` and
    the windowed-fleet admission hash narrow operands to ``srp_hash``'s
    ids, and everything downstream equals their plain versions on the
    card (the plain versions widen the operands too)."""
    B, d, K, L, T, E = 65, 4097, 15, 50, 3, 2
    cfg, x, w = _narrow_case(B, d, K, L, xdt, wdt, cuda, seed=7)
    ids = H.srp_hash(x, w, cfg)
    counts = _counts(L, K, cuda)
    t = torch.tensor(float(L), device=cuda)       # some admit, some not
    got = A.ace_admit_fused(counts.clone(), x, w, t, cfg)
    want = A.ace_admit_fused_plain(counts.clone(), x, w, t, cfg)
    assert torch.equal(got[3], ids)
    scores, sids = F.ace_score_fused_planned(counts, x, w, cfg, None, None,
                                             with_ids=True)
    assert torch.equal(sids, ids)
    if torch.equal(want[3], ids):     # the plain hash agrees on every row
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert torch.equal(scores, F.ace_score_fused_plain(counts, x, w,
                                                           cfg))
    rng = np.random.default_rng(3)
    fleet = torch.as_tensor(rng.integers(0, 9, size=(T, L, 1 << K)),
                            dtype=torch.int32, device=cuda)
    tids = torch.as_tensor(rng.integers(0, T, size=B), dtype=torch.int32,
                           device=cuda)
    scores, fids = FS.ace_fleet_score_planned(fleet, x, tids, w, cfg, None,
                                              with_ids=True)
    assert torch.equal(fids, ids)
    assert torch.equal(scores, FS.fleet_score_from_ids(fleet, ids, tids))
    ring = torch.as_tensor(rng.integers(0, 9, size=(T, E, L, 1 << K)),
                           dtype=torch.int32, device=cuda)
    tail = torch.as_tensor(rng.integers(0, 20, size=(T, L, 1 << K)),
                           dtype=torch.float32, device=cuda)
    cursor = torch.zeros((T,), dtype=torch.int32, device=cuda)
    thr = torch.full((T,), float(L), device=cuda)
    got = FWA.ace_fleet_window_admit_fused(ring.clone(), tail, cursor, x,
                                           tids, w, thr, cfg)
    want = FWA.ace_fleet_window_admit_fused_plain(ring.clone(), tail,
                                                  cursor, x, tids, w, thr,
                                                  cfg)
    assert torch.equal(got[3], ids)
    if torch.equal(want[3], ids):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("B,d,K,L", SRHT_SHAPES[:4])
def test_srht_hash_narrow_x_bitwise(cuda, B, d, K, L, xdt):
    """The SRHT kernel widens a narrow x as it loads it: ids bitwise the
    kernel's on x.float() and the plain version's."""
    cfg = SrpConfig(dim=d, num_bits=K, num_tables=L, seed=d,
                    hash_mode="srht")
    x = torch.randn((B, d), generator=torch.Generator().manual_seed(d)) \
        .to(device=cuda, dtype=xdt)
    got = SH.srht_hash(x, cfg)
    assert torch.equal(got, SH.srht_hash(x.float(), cfg))
    assert torch.equal(got, SH.srht_hash_plain(x, cfg))


# ---------------------------------------------------------------------------
# The compile-once contract: one captured CUDA graph a signature
# (``core.capture``) for ``Guardrail.admit`` and ``StreamRunner.consume``.
# ---------------------------------------------------------------------------

CAPTURE_GUARDS = {"flat": {}, "window": dict(window_epochs=3, rotate_every=2),
                  "fleet": dict(num_tenants=3),
                  "fleet_window": dict(num_tenants=3, window_epochs=3,
                                       rotate_every=2)}


def _replays_count_their_tally(program, run, n=3):
    """``run`` n times, each a replay of the entry it last built or used,
    under sync-debug "error": each kernel's ``launches`` grows by n × the
    capture's tally, and nothing syncs."""
    run()
    torch.cuda.synchronize()
    before = {k: k.launches for e in program._entries.values()
              for k in e.tally}
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(n):
            run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    grown = {k: k.launches - b for k, b in before.items()}
    return grown


@pytest.mark.parametrize("mode", ["mu_sigma", "quantile"])
@pytest.mark.parametrize("kind", sorted(CAPTURE_GUARDS))
def test_captured_admit_is_the_eager_twin(cuda, kind, mode):
    """Each flavour, healthy, degraded and healthy again: the captured
    admits' verdicts and states bitwise those of a twin run under
    ``capture.disabled()``; two graphs (healthy, degraded); a replay
    syncs nothing and adds its capture's tally to every kernel's
    ``launches``."""
    from repro_torch.core import capture
    kw = dict(d_model=64, num_bits=10, num_tables=16, warmup_items=64.0,
              threshold_mode=mode, quantile_q=0.05, **CAPTURE_GUARDS[kind])
    g = Guardrail(GuardrailConfig(**kw), device=cuda)
    twin = Guardrail(GuardrailConfig(**kw), device=cuda, w=g.w)
    T = kw.get("num_tenants")
    gen = torch.Generator(device=cuda).manual_seed(5)

    def batch(i):
        e = torch.randn((64, 4, 64), generator=gen, device=cuda)
        e[: 16 * (i > 8)] += 3.0
        e[i % 64, 0, 0] = float("nan")
        t = None if T is None else ((np.arange(64) + i) % T).astype(np.int32)
        return e, t

    for i in range(14):
        if i in (6, 11):
            mask = None
            if i == 6:
                mask = torch.ones((T, 16) if T else (16,), device=cuda)
                mask[..., 2] = mask[..., 5] = 0.0
            for x in (g, twin):
                x._table_mask = None if mask is None else mask.clone()
        e, t = batch(i)
        got = g.admit(e, t)
        with capture.disabled():
            want = twin.admit(e, t)
        np.testing.assert_array_equal(got, want)
        assert all(torch.equal(a, b) for a, b in zip(g.state, twin.state)
                   if a is not None)
    assert g.trace_count == 2 and twin.trace_count == 0
    entries = list(g._program._entries.values())
    assert all(e.graph is not None for e in entries)
    e, t = batch(20)
    tdev = None if t is None else torch.as_tensor(t, device=cuda)
    grown = _replays_count_their_tally(
        g._program, lambda: g._admit_device(e, tdev))
    healthy = entries[0]
    assert healthy.tally and all(grown[k] == 3 * n
                                 for k, n in healthy.tally.items())


CAPTURE_STREAMS = ("dense", "srht", "window", "fleet", "attr_fleet",
                   "quantile_fleet", "masks")


@pytest.mark.parametrize("kind", CAPTURE_STREAMS)
def test_captured_consume_is_the_eager_twin(cuda, kind):
    """Each stream kind over four chunks, the third scored with a health
    mask: summaries, keep masks and states bitwise those of a twin runner
    under ``capture.disabled()``; two graphs; a replay syncs nothing and
    adds its capture's tally to every kernel's ``launches``."""
    from repro_torch.core import capture
    kw = dict(d_model=64, num_bits=10, num_tables=16, warmup_items=128.0,
              device=cuda)
    fleet = "fleet" in kind
    if fleet:
        filt = FleetDataFilter(num_tenants=4, **kw, **(
            dict(attr_rows=4, attr_bits=6) if kind == "attr_fleet" else
            dict(threshold_mode="quantile", quantile_q=0.05)
            if kind == "quantile_fleet" else {}))
    elif kind == "window":
        filt = WindowedAceFilter(num_epochs=3, rotate_every=2, **kw)
    else:
        filt = AceDataFilter(hash_mode="srht" if kind == "srht" else "dense",
                             **kw)
    masks = kind == "masks"
    r = StreamRunner(filt, 4, return_masks=masks)
    twin = StreamRunner(filt, 4, return_masks=masks)
    s, w = r.init()
    ts = capture.tree_map(torch.clone, s)
    rng = np.random.default_rng(3)
    tmask = torch.ones((4, 16) if fleet else (16,), device=cuda)
    tmask[..., 7] = 0.0

    def chunk(c):
        f = rng.normal(size=(4, 128, 65)).astype(np.float32)
        f[:, c, 0] = np.nan
        tids = (torch.as_tensor(rng.integers(0, 4, (4, 128)),
                                dtype=torch.int32, device=cuda)
                if fleet else None)
        return torch.as_tensor(f, device=cuda), tids

    for c in range(4):
        f, tids = chunk(c)
        m = tmask if c == 2 else None
        out = r.consume(s, w, f, tids, table_mask=m)
        with capture.disabled():
            tout = twin.consume(ts, w, f, tids, table_mask=m)
        s, ts = out[0], tout[0]
        for a, b in zip(capture.leaves(out[1:]), capture.leaves(tout[1:])):
            assert (a is None and b is None) or torch.equal(a, b)
        assert all(torch.equal(a, b) for a, b in zip(
            capture.leaves(s), capture.leaves(ts)) if a is not None)
    assert r.trace_count == 2 and twin.trace_count == 0
    entries = list(r._program._entries.values())
    assert all(e.graph is not None for e in entries)
    f, tids = chunk(5)
    grown = _replays_count_their_tally(
        r._program, lambda: r.consume(s, w, f, tids))
    healthy = entries[0]
    assert healthy.tally and all(grown[k] == 3 * n
                                 for k, n in healthy.tally.items())


CAPTURE_SERVE = ("mixtral_8x7b", "jamba_v01_52b", "rwkv6_7b", "whisper_tiny")


@pytest.mark.parametrize("name", CAPTURE_SERVE)
def test_captured_serve_is_the_eager_twin(cuda, name, monkeypatch):
    """``ServeEngine.generate`` through its captured prefill and decode
    programs at each family's reduced size (Mixtral: MoE and sliding
    windows; Jamba: Mamba, MoE and attention; RWKV-6; whisper): tokens,
    the prefill's logits and one decode step's bitwise those of the eager
    twin (``capture.disabled()``); one graph each (``trace_counts`` (1,
    1)); the weights adopted (the graphs read the caller's ``data_ptr``s);
    a generate of replays syncs nothing before its one transfer, the
    tokens.  Then the CPU test's sequence on the card — a new prompt
    length, a new batch size, the first shape again, other weights of the
    same shapes, the first weights again — so that the shared graph pool
    holds three prefill and two decode graphs replayed out of capture
    order, and the weights' keys are built again: every generate bitwise
    its eager twin, neither set of weights written."""
    from repro_torch.core import capture
    from repro_torch.serve import engine as E
    a, card, _ = _model_on_both(cuda, name)
    eng = E.ServeEngine(a, s_max=24, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(9)

    def batch_of(B, P):
        batch = {"tokens": torch.randint(0, a.cfg.vocab_size, (B, P),
                                         generator=gen, device=cuda,
                                         dtype=torch.int32)}
        if a.cfg.encoder_layers:
            batch["embeds"] = torch.randn(
                (B, a.cfg.encoder_seq, a.cfg.d_model), generator=gen,
                device=cuda)
        return batch

    batch = batch_of(3, 12)
    toks = eng.generate(card, batch, num_new_tokens=8, prompt_len=12)
    with capture.disabled():
        want = eng.generate(card, batch, num_new_tokens=8, prompt_len=12)
    np.testing.assert_array_equal(toks, want)
    assert eng.trace_counts == (1, 1)
    programs = (eng._prefill, eng._decode)
    assert all(e.graph is not None for p in programs
               for e in p._entries.values())
    ptrs = [t.data_ptr() for t in capture.leaves(card)]
    assert all([w[0] for w in p._last.where[0]] == ptrs for p in programs)

    calls, to_host = [], E._to_host

    def counted(x):
        torch.cuda.set_sync_debug_mode(0)
        calls.append(tuple(x.shape))
        return to_host(x)

    monkeypatch.setattr(E, "_to_host", counted)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = eng.generate(card, batch, num_new_tokens=8, prompt_len=12)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert calls == [(3, 8)]
    np.testing.assert_array_equal(got, want)
    assert eng.trace_counts == (1, 1)
    monkeypatch.setattr(E, "_to_host", to_host)

    other = capture.tree_map(lambda t: t.flip(-1).contiguous(), card)
    kept = [capture.tree_map(torch.clone, p) for p in (card, other)]
    for B, P, new, p in [(3, 10, 6, card), (2, 10, 6, card),
                         (3, 12, 8, card), (3, 12, 8, other),
                         (2, 10, 6, other), (3, 12, 8, card)]:
        b = batch if (B, P) == (3, 12) else batch_of(B, P)
        got = eng.generate(p, b, num_new_tokens=new, prompt_len=P)
        with capture.disabled():
            want = eng.generate(p, b, num_new_tokens=new, prompt_len=P)
        np.testing.assert_array_equal(got, want, err_msg=f"B {B}, P {P}")
    assert eng.trace_counts == (3, 2)
    assert all(e.graph is not None for p in programs
               for e in p._entries.values())
    for p, k in zip((card, other), kept):
        assert all(torch.equal(x, y) for x, y in zip(capture.leaves(p),
                                                      capture.leaves(k)))

    _, (logits, cache) = eng._prefill(None, card, batch)
    with capture.disabled():
        _, (elogits, ecache) = eng._prefill(None, card, batch)
    assert torch.equal(logits, elogits)
    assert all(torch.equal(x, y) for x, y in zip(capture.leaves(cache),
                                                  capture.leaves(ecache)))
    step = {"tokens": torch.argmax(elogits[:, -1], -1).to(torch.int32)[:, None]}
    pos = torch.full((3,), 12, dtype=torch.int32, device=cuda)
    state, dlogits = eng._decode(ecache, card, step, pos)
    with capture.disabled():
        estate, delogits = eng._decode(ecache, card, step, pos)
    assert torch.equal(dlogits, delogits)
    assert all(torch.equal(x, y) for x, y in zip(capture.leaves(state),
                                                  capture.leaves(estate)))


@pytest.mark.parametrize("chunk", [0, 2])
def test_captured_train_is_the_eager_twin(cuda, chunk, tmp_path, monkeypatch):
    """``train`` on reduced olmo_1b (AdamW, filter, monitor and int8
    compression on; the in-step filter, or the chunked prefilter at T = 2
    with a tail) through its captured step, chunk-features and tail
    programs, against the eager twin (``capture.disabled()``) from the
    same initial state: 2 steps that checkpoint, then a run that restores
    that checkpoint, trips the monitor's rollback at once (restoring it
    again) and goes on for 2 (chunked: 3) steps.  Every metric, the
    parameters, moments, sketches, residual and the generator's state
    bitwise; one program a function (neither the restore nor the
    rollback adds one), each a captured graph; each kernel launched as
    often as in the twin."""
    from repro_torch.core import capture
    from repro_torch.data.pipeline import DataStream, StreamConfig
    from repro_torch.models.registry import Arch, leaves
    from repro_torch.train import fault
    from repro_torch.train import train_loop as tl
    arch = Arch("olmo_1b", reduced=True)
    scfg = StreamConfig(vocab_size=arch.cfg.vocab_size, seq_len=16,
                        global_batch=8, seed=5)
    kernels = (H.KERNEL, Q.KERNEL, U.KERNEL, A.KERNEL)
    made = []

    class Recorded(capture.Program):
        def __init__(self, fn, *a, **k):
            super().__init__(fn, *a, **k)
            made.append(self)

    monkeypatch.setattr(capture, "Program", Recorded)

    def run(where, eager):
        tcfg = tl.TrainConfig(
            optimizer="adamw", peak_lr=1e-3, warmup_steps=1, total_steps=16,
            grad_compression=True, filter_chunk=chunk, ckpt_interval=2,
            max_rollbacks=1, ckpt_dir=str(tmp_path / where), seed=5,
            device="cuda")
        before = [k.launches for k in kernels]
        with (capture.disabled() if eager else contextlib.nullcontext()):
            _, first = tl.train(arch, tcfg, DataStream(scfg), 2, log_every=0)
            del made[:]
            with monkeypatch.context() as m:
                m.setattr(fault.GradMonitor, "rollback_needed",
                          lambda self, st: torch.ones_like(
                              st.anomalies, dtype=torch.bool))
                state, hist = tl.train(arch, tcfg, DataStream(scfg),
                                       3 if chunk else 2, log_every=0)
        torch.cuda.synchronize()
        programs = {p.fn.__name__: p for p in made
                    if getattr(p.fn, "__name__", "").startswith(
                        ("train_step", "chunk_features", "tail_step"))}
        return (state, first + hist, programs,
                [k.launches - b for k, b in zip(kernels, before)])

    state, hist, programs, launches = run("captured", eager=False)
    twin, twin_hist, twin_programs, twin_launches = run("eager", eager=True)
    assert [h["rollback"] for h in hist[2:4]] == [1.0, 0.0]
    assert hist == twin_hist
    for f in ("params", "opt_state", "monitor", "filter_state", "ef"):
        for x, y in zip(leaves(getattr(state, f)), leaves(getattr(twin, f))):
            assert torch.equal(x, y), f
    assert torch.equal(state.rng.get_state(), twin.rng.get_state())
    assert launches == twin_launches and all(launches)
    want = {"train_step": 1, **({"chunk_features": 2, "tail_step": 1}
                                if chunk else {})}
    assert {k: p.trace_count for k, p in programs.items()} == want
    assert all(e.graph is not None for p in programs.values()
               for e in p._entries.values())
    assert all(p.trace_count == 0 for p in twin_programs.values())


def test_gemma2_ring_and_captured_decode(cuda):
    """gemma2 at reduced width on the card (local "swa" + global "attn",
    softcaps 50 and 30, sandwich norms, scaled tied embeddings): the
    generate through the captured programs bitwise its eager twin —
    tokens, the prefill's logits and one decode step's — with every
    logit inside the final cap; then its local layers alone (the global
    ones keep a full cache by design) with a ring cache of the window's
    16 slots against a full one of 32, greedy over 24 tokens that wrap
    it: tokens equal, logits within 2e-4."""
    from repro_torch.core import capture
    from repro_torch.serve import engine as E
    a, card, _ = _model_on_both(cuda, "gemma2_27b")
    gen = torch.Generator(device=cuda).manual_seed(12)
    batch = {"tokens": torch.randint(0, a.cfg.vocab_size, (3, 20),
                                     generator=gen, device=cuda,
                                     dtype=torch.int32)}
    eng = E.ServeEngine(a, s_max=32, device=cuda)
    toks = eng.generate(card, batch, num_new_tokens=8, prompt_len=20)
    with capture.disabled():
        want = eng.generate(card, batch, num_new_tokens=8, prompt_len=20)
    np.testing.assert_array_equal(toks, want)
    assert eng.trace_counts == (1, 1)
    _, (logits, cache) = eng._prefill(None, card, batch)
    with capture.disabled():
        _, (elogits, ecache) = eng._prefill(None, card, batch)
    assert torch.equal(logits, elogits)
    step = {"tokens": torch.argmax(elogits[:, -1], -1)
            .to(torch.int32)[:, None]}
    pos = torch.full((3,), 20, dtype=torch.int32, device=cuda)
    _, dlogits = eng._decode(ecache, card, step, pos)
    with capture.disabled():
        _, delogits = eng._decode(ecache, card, step, pos)
    assert torch.equal(dlogits, delogits)
    cap = a.cfg.final_logit_softcap
    assert float(logits.abs().max()) <= cap
    assert float(dlogits.abs().max()) <= cap

    import copy
    import dataclasses
    local = copy.copy(a)
    local.cfg = dataclasses.replace(a.cfg, block_pattern=("swa",),
                                    num_layers=a.cfg.num_superblocks)
    lp = {**card, "blocks": [[row[0]] for row in card["blocks"]]}
    window = a.cfg.sliding_window
    prompt = batch["tokens"][:, :8]
    ring_toks, ring_logits = _greedy(local, lp, {"tokens": prompt}, 24,
                                     window)
    full_toks, full_logits = _greedy(local, lp, {"tokens": prompt}, 24,
                                     2 * window)
    assert torch.equal(ring_toks, full_toks)
    torch.testing.assert_close(ring_logits, full_logits, rtol=2e-4,
                               atol=2e-4)


def test_qwen2_vl_embeds_prefill_captured(cuda):
    """qwen2_vl at reduced width on the card: the engine's prefill of
    embeddings with M-RoPE positions whose three sections differ, through
    its captured program, bitwise the eager twin (logits and cache); the
    decode step feeds tokens, so ``generate`` raises the reference's
    ``KeyError``."""
    from repro_torch.core import capture
    from repro_torch.serve import engine as E
    a, card, _ = _model_on_both(cuda, "qwen2_vl_7b")
    gen = torch.Generator(device=cuda).manual_seed(13)
    i = torch.arange(12, dtype=torch.int32, device=cuda)
    batch = {"embeds": torch.randn((3, 12, a.cfg.d_model), generator=gen,
                                   device=cuda),
             "positions": torch.stack([i, i // 4, i % 4])[:, None]
             .expand(3, 3, 12).contiguous()}
    eng = E.ServeEngine(a, s_max=24, device=cuda)
    for _ in range(2):                  # the build, then a replay
        _, (logits, cache) = eng._prefill(None, card, batch)
    with capture.disabled():
        _, (elogits, ecache) = eng._prefill(None, card, batch)
    assert torch.equal(logits, elogits)
    assert all(torch.equal(x, y) for x, y in zip(capture.leaves(cache),
                                                  capture.leaves(ecache)))
    assert eng.trace_counts == (1, 0)
    with pytest.raises(KeyError, match="embeds"):
        eng.generate(card, batch, num_new_tokens=2, prompt_len=12)
