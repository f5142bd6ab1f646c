"""The launch plan of the port's dense SRP hash
(``repro_torch.kernels.srp_hash.hash_plan``), on the CPU.

The kernels ``srp_hash`` and ``ace_admit_fused`` (``csrc/srp_gemm.cuh``)
only read the plan, so what they rely on is checked here: every
(row, table) is covered by exactly one block, the depth splits partition
[0, d) in order, a cluster is at most 8 blocks and tiles the grid, a
group's K·L columns fit one 128-column tile from a 4-column boundary,
the main-path shapes fill 132 SMs, and the cluster size is the largest
whose clusters the card runs at once (on the H100's table and others).
A numpy model of the kernel's
epilogue (the per-row sign mask words and the funnel-shift pack) is held
bitwise against the port's ``pack_buckets`` on the same projections, and
one of its staging of a 2-byte x (raw aligned words, the row's skew)
against the rows it must stage.
No JAX here: the plan has no counterpart in the reference.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro_torch.core.srp import SrpConfig, pack_buckets  # noqa: E402
from repro_torch.kernels import srp_hash as H  # noqa: E402

H100_SMS = 132

# (B, d, K, L) of the main paths: the estimator's fit batch, the
# guardrails' admit, the stream step.
MAIN_SHAPES = {"fit": (4096, 36, 15, 50), "admit": (256, 4097, 15, 50),
               "stream": (512, 4097, 13, 32)}

# Edge shapes: one of everything, the GPU tests' shapes, the estimator's
# score batch, the auto corner at d = 64, wide L at small and large K.
SHAPES = [*MAIN_SHAPES.values(), (1, 1, 1, 1), (7, 9, 4, 3),
          (17, 64, 7, 19), (33, 130, 31, 5), (5, 65, 16, 9), (70, 5, 13, 32),
          (16384, 36, 15, 50), (256, 64, 15, 50), (3, 100, 3, 200),
          (100, 1000, 31, 40), (1, 4097, 1, 1000), (129, 17, 17, 23)]


def all_plans(B, d, K, L):
    """The plan ``hash_plan`` picks and every forced plan: each cluster
    size with one table a group and with the most that fit."""
    yield H.hash_plan(B, d, K, L, H.H100_CLUSTERS)
    for s, t in itertools.product(range(1, H.MAX_SPLITS + 1),
                                  sorted({1, H.tables_per_group(K, L)})):
        yield H.make_plan(B, d, K, L, t, s)


def shape_id(shape):
    return "B{}-d{}-K{}-L{}".format(*shape)


@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
def test_every_row_and_table_is_covered_once(shape):
    B, d, K, L = shape
    for plan in all_plans(B, d, K, L):
        hits = np.zeros((plan.row_tiles * plan.rows, L), dtype=np.int64)
        gx, gy = plan.grid
        for bx, by in itertools.product(range(gx), range(gy)):
            if bx % plan.splits:
                continue            # the tile's rank 0 stands for its cluster
            tile = bx // plan.splits
            t0 = by * plan.tables
            hits[tile * plan.rows:(tile + 1) * plan.rows,
                 t0:min(L, t0 + plan.tables)] += 1
        assert (hits[:B] == 1).all(), plan
        assert plan.row_tiles == -(-B // plan.rows)
        # rank s of a cluster packs rows [s·rows/S, (s+1)·rows/S): together
        # every row once
        S = plan.splits
        assert sorted(r for s in range(S)
                      for r in range(s * plan.rows // S,
                                     (s + 1) * plan.rows // S)) \
            == list(range(plan.rows))


@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
def test_splits_partition_the_depth_in_order(shape):
    B, d, K, L = shape
    for plan in all_plans(B, d, K, L):
        b = plan.bounds
        assert len(b) == plan.splits + 1
        assert b[0] == 0 and b[-1] == d
        assert all(lo <= hi for lo, hi in zip(b, b[1:]))
        # every split but the last is a whole number of staged slices
        assert all(x % H.SLICE == 0 for x in b[:-1])


@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
def test_clusters_are_portable_and_tile_the_grid(shape):
    B, d, K, L = shape
    for plan in all_plans(B, d, K, L):
        gx, gy = plan.grid
        assert 1 <= plan.splits <= 8
        assert gx % plan.splits == 0
        assert gx * gy == plan.blocks
        assert gy <= 65535
        args = plan.args()
        assert len(args) == len(H.PLAN_ARGTYPES)
        assert args[5:6 + plan.splits] == plan.bounds


@pytest.mark.parametrize("K", range(1, 32))
def test_columns_never_straddle_a_group(K):
    for L in (1, 2, 3, 7, 32, 50, 129, 1000):
        t = H.tables_per_group(K, L)
        assert 1 <= t <= L
        groups = -(-L // t)
        owned = []
        for g in range(groups):
            start, stop = H.group_columns(g, t, K, L)
            assert start % K == 0 and stop % K == 0    # whole tables
            a0 = start & ~3                            # the tile's start
            assert a0 % 4 == 0 and stop - a0 <= H.COLS
            owned.extend(range(start, stop))
        assert owned == list(range(K * L))
        if t < L:      # the most that fit: one more table overflows a tile
            assert not all(H.group_fits(g, t + 1, K, L)
                           for g in range(-(-L // (t + 1))))


def plan_of(path):
    return H.hash_plan(*MAIN_SHAPES[path], H.H100_CLUSTERS)


@pytest.mark.parametrize("path", sorted(MAIN_SHAPES))
def test_main_path_shapes_fill_the_card(path):
    plan = plan_of(path)
    assert plan.blocks >= H100_SMS, plan.describe()


def test_plans_of_the_main_paths():
    """The skinny d = 4097 shapes split their depth across a cluster; the
    fit's 448 (row tile, group) units are more than the card runs at once
    even one block a cluster, so it takes S = 1.  The stream step's 32
    clusters are two more than the H100 runs at once as 8-block clusters
    two blocks an SM, so it takes S = 7, whose 32 fit."""
    fit, admit, stream = (plan_of(k) for k in ("fit", "admit", "stream"))
    assert (fit.splits, fit.groups, fit.row_tiles) == (1, 7, 64)
    assert (admit.splits, admit.groups, admit.row_tiles) == (8, 7, 4)
    assert (stream.splits, stream.groups, stream.row_tiles) == (7, 4, 8)
    assert stream.tables == 9          # 117 of 128 columns at K = 13


@pytest.mark.parametrize("path", ["admit", "stream"])
def test_skinny_plans_run_every_cluster_at_once(path):
    """At d = 4097 the picked S runs all its clusters in one wave, at most
    two blocks an SM, on the H100's cluster geometry."""
    plan = plan_of(path)
    units = plan.row_tiles * plan.groups
    assert units <= H.H100_CLUSTERS[plan.splits - 1]


@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
def test_split_rule_is_the_largest_that_fits(shape):
    """S is the largest cluster size with a slice for every split whose
    clusters the card runs at once; a grid past the card takes S = 1."""
    B, d, K, L = shape
    plan = H.hash_plan(B, d, K, L, H.H100_CLUSTERS)
    units = plan.row_tiles * plan.groups
    slices = -(-d // H.SLICE)
    fits = [s for s in range(1, H.MAX_SPLITS + 1)
            if s <= slices and units <= H.H100_CLUSTERS[s - 1]]
    assert plan.splits == (max(fits) if fits else 1)
    assert plan.splits <= slices


def test_small_depth_splits_to_one_slice_each():
    """The auto corner at d = 64 (four slices, 28 units) takes S = 4, one
    slice a split, so its 112 blocks are not left at two slices each."""
    plan = H.hash_plan(256, 64, 15, 50, H.H100_CLUSTERS)
    assert (plan.splits, plan.blocks) == (4, 112)
    assert plan.bounds == (0, 16, 32, 48, 64)


@pytest.mark.parametrize("clusters,want", [
    ((132, 66, 39, 31, 23, 19, 16, 15), 4),     # a card of half the GPCs
    ((27,) * 8, 1),                             # 28 units: past the card
    ((28,) * 8, 8)], ids=["half-card", "past-the-card", "exact-fit"])
def test_split_rule_follows_the_card(clusters, want):
    """The admit shape's 28 clusters on other cluster geometries: the
    largest S whose clusters all run at once, else S = 1."""
    assert H.hash_plan(*MAIN_SHAPES["admit"], clusters).splits == want


def test_make_plan_refuses_what_the_kernel_cannot_run():
    with pytest.raises(ValueError, match="splits"):
        H.make_plan(8, 100, 13, 32, 9, 9)
    with pytest.raises(ValueError, match="splits"):
        H.make_plan(8, 100, 13, 32, 9, 0)
    with pytest.raises(ValueError, match="do not fit"):
        H.make_plan(8, 100, 13, 32, 10, 1)
    with pytest.raises(ValueError, match="do not fit"):
        H.make_plan(8, 100, 13, 32, 0, 1)
    with pytest.raises(ValueError, match="no plan"):
        H.make_plan(0, 100, 13, 32, 9, 1)
    with pytest.raises(ValueError, match="num_bits"):
        H.make_plan(8, 100, 32, 3, 1, 1)


def model_ids(proj: np.ndarray, K: int, L: int, plan) -> np.ndarray:
    """The bucket ids the kernel's epilogue makes from a (B, K·L)
    projection under ``plan``: per block, columns from the last 4-column
    boundary (those past K·L zero-filled), each rank's rows as sign masks
    of 4 + 1 words (column c at bit 31 - c % 32 of word c // 32), then a
    funnel shift per (row, table).  Ids written twice raise."""
    B, KL = proj.shape
    out = np.full((B, L), -1, dtype=np.int64)
    S = plan.splits
    for tile, g in itertools.product(range(plan.row_tiles),
                                     range(plan.groups)):
        t0 = g * plan.tables
        ntab = min(plan.tables, L - t0)
        a0 = (t0 * K) & ~3
        shift = t0 * K - a0
        cols = np.zeros((plan.rows, H.COLS))
        rows = proj[tile * plan.rows:(tile + 1) * plan.rows]
        live = rows[:, a0:min(KL, a0 + H.COLS)]
        cols[:live.shape[0], :live.shape[1]] = live
        bits = (cols >= 0).astype(np.uint64)
        words = np.zeros((plan.rows, 5), dtype=np.uint64)
        for c in range(H.COLS):
            words[:, c // 32] |= bits[:, c] << np.uint64(31 - c % 32)
        for rank in range(S):
            for r, t in itertools.product(range(rank * plan.rows // S,
                                                (rank + 1) * plan.rows // S),
                                          range(ntab)):
                row = tile * plan.rows + r
                if row >= B:
                    continue
                s = shift + t * K
                hi, lo = int(words[r, s // 32]), int(words[r, s // 32 + 1])
                top = ((hi << (s % 32)) | (lo >> (32 - s % 32))) \
                    & 0xFFFFFFFF
                assert out[row, t0 + t] == -1, "covered twice"
                out[row, t0 + t] = top >> (32 - K)
    return out


@pytest.mark.parametrize("B,K,L", [(70, 13, 32), (9, 15, 50), (5, 31, 9),
                                   (3, 1, 200), (66, 3, 50), (2, 17, 23)])
def test_epilogue_model_packs_like_pack_buckets(B, K, L):
    """Sign masks and funnel shifts give the port's big-endian pack,
    zeros (sign(0) = bit 1) and NaN (bit 0) included, under every plan."""
    rng = np.random.default_rng(B * K + L)
    proj = rng.normal(size=(B, K * L))
    proj[0] = 0.0
    proj[1, ::3] = np.nan
    cfg = SrpConfig(dim=8, num_bits=K, num_tables=L)
    want = pack_buckets(torch.as_tensor((proj >= 0).astype(np.int32)),
                        cfg).numpy()
    assert (want[0] == (1 << K) - 1).all()
    for plan in all_plans(B, 8, K, L):
        assert np.array_equal(model_ids(proj, K, L, plan), want), \
            plan.describe()


X_WORDS = H.SLICE // 2 + 1    # srp_gemm.cuh kXWords


def model_narrow_x_slice(mem: np.ndarray, base: int, B: int, d: int,
                         row0: int, k_begin: int, kb: int,
                         k_end: int) -> np.ndarray:
    """The (SLICE, ROWS) x slice ``srp_gemm.cuh`` stages from a 2-byte x
    that starts at half ``base`` of ``mem`` (whose half 0 is 4-byte
    aligned), as raw bits: each row's X_WORDS aligned 4-byte words from
    the one holding its first element (the row's skew from the kernel's
    parity rule, which must be its first element's address parity), the
    bytes past the slice's last element (or of a row past B) zero-filled,
    then element k read at half skew + k of the row's words.  Reading
    outside x's elements other than the dropped half before a row's first
    one raises."""
    live = min(H.SLICE, k_end - kb)
    raw = np.zeros((H.ROWS, 2 * X_WORDS), dtype=np.uint16)
    skew = np.zeros(H.ROWS, dtype=np.int64)
    x_par = (base + k_begin) & 1
    for r in range(min(H.ROWS, B - row0)):
        e0 = base + (row0 + r) * d + kb
        skew[r] = (x_par + ((row0 + r) & d)) & 1
        assert skew[r] == e0 & 1
        for q in range(X_WORDS):
            first = 2 * q - skew[r]
            n = 2 if first + 1 < live else 1 if first < live else 0
            for h in range(n):
                at = e0 + first + h
                assert base - 1 <= at < base + B * d, "read outside x"
                assert at >= base or first + h == -1
                raw[r, 2 * q + h] = mem[at]
    return np.stack([raw[np.arange(H.ROWS), skew + k]
                     for k in range(H.SLICE)])


@pytest.mark.parametrize("base", [0, 1], ids=["aligned", "skewed"])
@pytest.mark.parametrize("B,d", [(1, 1), (65, 2), (65, 5), (1, 16),
                                 (65, 17), (3, 33), (2, 4097)])
def test_narrow_x_staging_model_reads_each_element_once(B, d, base):
    """A 2-byte x row starts on any 2-byte boundary (d odd, or a view 2
    bytes off a word): the raw words and the skew give every block's x
    slice the row's elements in order, zeros past the split's depth and
    past row B, under every plan of the shape, from a base on a word or 2
    bytes past it."""
    rng = np.random.default_rng(B * d + base)
    x = rng.integers(1, 1 << 16, size=(B, d), dtype=np.uint16)
    mem = np.concatenate([np.full(base, 0xFFFF, np.uint16), x.ravel(),
                          np.full(2, 0xFFFF, np.uint16)])
    for plan in all_plans(B, d, 15, 50):
        for tile, split in itertools.product(range(plan.row_tiles),
                                             range(plan.splits)):
            row0 = tile * plan.rows
            lo, hi = plan.bounds[split], plan.bounds[split + 1]
            for kb in range(lo, hi, H.SLICE):
                want = np.zeros((H.SLICE, H.ROWS), dtype=np.uint16)
                rows = x[row0:row0 + H.ROWS, kb:min(kb + H.SLICE, hi)]
                want[:rows.shape[1], :rows.shape[0]] = rows.T
                got = model_narrow_x_slice(mem, base, B, d, row0, lo, kb,
                                           hi)
                assert np.array_equal(got, want), (plan.describe(), kb)
