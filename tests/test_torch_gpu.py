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
bitwise; Welford mean/M2 rtol 1e-5.  The window combine, the fleet score
and the windowed-fleet admission sum in table order with no FMA, as their
plain versions do, so they are bitwise too (the admission's tail sums
included, at fractional tail values).  SRHT ids bitwise, against the plain
version on the card and on the CPU; fused scores bitwise wherever the
ids agree, the weighted form too (both sum in table order, no FMA).
Attribution point estimates equal by value (an empty cell gives ±0.0, and
which zero a median of zeros returns may differ); the attribution planes
and heavy hitters of a fleet of one tenant equal the flat path's bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro_torch.core import sketch as sk  # noqa: E402
from repro_torch.core.estimators import AceEstimator  # noqa: E402
from repro_torch.core.srp import SrpConfig, make_projections  # noqa: E402
from repro_torch.kernels import ace_admit_fused as A  # noqa: E402
from repro_torch.data.pipeline import AceDataFilter  # noqa: E402
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


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("E,L,K,B,repeat", [(1, 5, 4, 1, 1),
                                            (4, 50, 15, 300, 1),
                                            (3, 7, 3, 64, 8),
                                            (2, 33, 25, 5, 1)])
def test_ace_window_combine_matches_plain(cuda, E, L, K, B, repeat,
                                          weighted):
    """E = 1, B = 1 and off the block size, colliding rows, and a ring of
    2·33·2^25 > 2^31 counters (64-bit offsets): bitwise."""
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
    if repeat > 1:
        s = got.view(repeat, B)
        assert torch.equal(s, s[:1].expand_as(s))
    del counts
    torch.cuda.empty_cache()


@pytest.mark.parametrize("T,B,d,K,L", [(3, 1, 9, 4, 3), (8, 257, 4097, 15, 50),
                                       (1310, 64, 36, 15, 50)])
def test_ace_fleet_score_matches_plain(cuda, T, B, d, K, L):
    """B = 1 and off the block size, the guardrail's width, and a fleet of
    1310 × 50 × 2^15 counters (the int32 offset cap: 64-bit offsets)."""
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
    gth = counts.view(T * L, -1)[rows, ids.long()].float()
    ref = torch.zeros(B, device=cuda)
    for j in range(L):
        ref = ref + gth[:, j]
    assert torch.equal(got, ref * torch.tensor(1.0 / L))
    same = (ids == plain_ids).all(dim=1)
    plain = FS.ace_fleet_score_plain(counts, q, tids, w, cfg)
    assert torch.equal(got[same], plain[same])
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
    from repro_torch.kernels.attr_estimate import find_hh_layout
    dim = 4097
    args = [torch.as_tensor(a, device=cuda)
            for a in _find_hh_case(dim, R, bits, seed=topk * 31 + R + bits)]
    stage, _ = find_hh_layout(13, R, 1 << bits, topk)
    if bits == 11:
        assert not stage or R < 3
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
# memory, so the kernel keeps it in its device workspace; bits 4 with the
# plane staged beside it, bits 11 with the plane read from global memory;
# a NaN cell and tied estimates on the small plane
@pytest.mark.parametrize("bits,kind", [(4, "normal"), (4, "nan"),
                                       (4, "tied"), (11, "normal")])
@pytest.mark.parametrize("R", [5, 9])
def test_attr_find_hh_beam_in_workspace_matches_plain(cuda, R, bits, kind):
    from repro_torch.kernels.attr_estimate import find_hh_layout
    dim, topk = 4097, 3000
    args = [torch.as_tensor(a, device=cuda)
            for a in _find_hh_case(dim, R, bits, seed=R + bits,
                                   plane_kind=kind)]
    stage, beam_in_smem = find_hh_layout(13, R, 1 << bits, topk)
    assert not beam_in_smem and stage == (bits == 4)
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
