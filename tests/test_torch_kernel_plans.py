"""The launch plans and index maps of the port's SRHT hash and count
insert kernels (``csrc/srht_hash.cu``, ``csrc/ace_update.cu``), on the
CPU, where neither kernel can run.

SRHT (``kernels/srht_hash.srht_plan``): every shape fits the card (threads,
shared memory), the passes cover the stages in order with each pass's
stages in a thread's own registers, every layout is a bijection onto the
row, the padded shared-memory offset splits into the per-thread base and
per-register offset the kernel adds, the exchanges of the main path's
widths are free of bank conflicts, and a numpy model of the kernel's data
flow (register butterflies, padded exchanges, sign bytes, both packs) is
bitwise equal to ``srht_hash_plain``.

Insert: a numpy model of the kernel's block aggregation (one table and 256
rows a block, a warp of one key merged in one lane, a warp of mostly
distinct keys straight to the counts, the 512-slot table with linear
probing, the overflow to global atomics) gives the plain version's
counts exactly, for hot buckets, random ids, a table that overflows,
masks, base rows and dropped ids and rows.  No JAX here: neither plan has a
counterpart in the reference.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro_torch.core.srht import srht_params  # noqa: E402
from repro_torch.core.srp import SrpConfig  # noqa: E402
from repro_torch.kernels import ace_update as U  # noqa: E402
from repro_torch.kernels import srht_hash as SH  # noqa: E402

SMEM_PER_BLOCK = 232_448          # an H100 block's shared memory, bytes
LOG2_PADS = list(range(1, SH.MAX_D_PAD.bit_length()))


# ---------------------------------------------------------------------------
# srht_hash
# ---------------------------------------------------------------------------

def _elem(t, r, lo, e):
    """Element of the row that thread t of a team holds in register r
    when its registers hold bits [lo, lo + e)."""
    return (t & ((1 << lo) - 1)) | (r << lo) | ((t >> lo) << (lo + e))


def _pad(i, s):
    return i + (i >> s)


def _base(t, lo, e, s):       # the kernel's padded(thread_bits(t, lo, e))
    return _pad((t & ((1 << lo) - 1)) | ((t >> lo) << (lo + e)), s)


def _grid(plan):
    t = np.arange(plan.team)[:, None]
    r = np.arange(1 << plan.elems_log)[None, :]
    return t, r


@pytest.mark.parametrize("n", LOG2_PADS)
def test_plan_fits_the_card(n):
    plan = SH.srht_plan(1 << n)
    e = plan.elems_log
    assert plan.log2_pad == n and plan.team << e == 1 << n
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    fwht = plan.rows * plan.team                  # threads of the FWHT
    assert fwht == (32 if plan.team < 32 else plan.threads)
    assert plan.team <= 32 and 32 % plan.team == 0 or plan.team % 32 == 0
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert e <= 5                       # the kernel's butterflies go to 2^5


@pytest.mark.parametrize("n", LOG2_PADS)
def test_passes_cover_the_stages_in_order(n):
    plan = SH.srht_plan(1 << n)
    e, lo = plan.elems_log, plan.passes
    assert lo[0] == 0 and lo[-1] == n - e
    assert list(lo) == sorted(set(lo))
    stages = []
    for p, low in enumerate(lo):
        own = range(p * e, min((p + 1) * e, n))
        assert all(low <= s < low + e for s in own)
        stages += own
    assert stages == list(range(n))


@pytest.mark.parametrize("n", LOG2_PADS)
def test_layouts_are_bijections_and_offsets_split(n):
    plan = SH.srht_plan(1 << n)
    e = plan.elems_log
    t, r = _grid(plan)
    for lo in plan.passes:
        i = _elem(t, r, lo, e)
        assert sorted(i.ravel()) == list(range(1 << n))
        for s in range(1, 9):           # the split holds for any padding
            np.testing.assert_array_equal(
                _base(t, lo, e, s) + _pad(r << lo, s), _pad(i, s))
    # the load and sign layouts: element t | (r << last)
    np.testing.assert_array_equal(_elem(t, r, n - e, e), t | (r << (n - e)))


def _conflicts(plan, lo):
    """The worst bank conflict of one register's store or load of an
    exchange in layout lo, over the block's warps."""
    e, s = plan.elems_log, 5
    stride = (1 << plan.log2_pad) + ((1 << plan.log2_pad) >> s)
    tid = np.arange(plan.rows * plan.team)       # the FWHT's threads
    rloc, t = tid // plan.team, tid % plan.team
    worst = 1
    for r in range(1 << e):
        addr = rloc * stride + _base(t, lo, e, s) + _pad(r << lo, s)
        for w in range(len(tid) // 32):
            banks = addr[32 * w: 32 * w + 32] % 32
            worst = max(worst, int(np.bincount(banks).max()))
    return worst


@pytest.mark.parametrize("n", [n for n in LOG2_PADS if n > 5])
def test_exchanges_are_conflict_free_on_the_main_widths(n):
    """From d_pad = 1024 up (the guardrail's and streams' 8192 among them)
    no exchange has a bank conflict; below, where a warp holds several
    rows, one layout of d_pad = 64 (the d = 36 fit, the d = 64 corner)
    takes four ways, 128 and 256 two.  Rows of 32 or fewer elements are
    never exchanged (one thread holds a row)."""
    plan = SH.srht_plan(1 << n)
    worst = max(_conflicts(plan, lo) for lo in plan.passes)
    assert worst == {6: 4, 7: 2, 8: 2}.get(n, 1)


def srht_model(x: np.ndarray, cfg: SrpConfig) -> np.ndarray:
    """The kernel's data flow in numpy float32: x read in the last pass's
    layout; each FWHT as passes of register butterflies with a padded
    shared-memory exchange before each, its diagonal applied from the
    bitmap in the first pass's layout; sign bytes in the last layout, then
    the pack (both of the kernel's packs give these bits)."""
    params = srht_params(cfg)
    plan = SH.srht_plan(params.d_pad)
    n, e = plan.log2_pad, plan.elems_log
    E, last, ps = 1 << e, n - e, 5
    B, d = x.shape
    K, L = cfg.num_bits, cfg.num_tables
    t, r = _grid(plan)
    il = t | (r << last)
    xp = np.zeros((B, 1 << n), np.float32)
    xp[:, :d] = x
    v = xp[:, il]
    stride = (1 << n) + ((1 << n) >> ps)
    words = params.sign_words.view(np.uint32).astype(np.int64)
    first = t << e                      # thread t's first-pass elements

    def signed_fwht(v, diag):
        for p, lo in enumerate(plan.passes):
            if len(plan.passes) > 1:
                frm = last if p == 0 else plan.passes[p - 1]
                sm = np.full((B, stride), np.nan, np.float32)
                sm[:, _base(t, frm, e, ps) + _pad(r << frm, ps)] = v
                v = sm[:, _base(t, lo, e, ps) + _pad(r << lo, ps)]
            if p == 0:                  # the diagonal, from its bitmap
                neg = (words[diag][first >> 5] >> (first & 31) >> r) & 1
                v = v * np.where(neg == 1, -1.0, 1.0).astype(np.float32)
            for k in range(p * e - lo, min((p + 1) * e, n) - lo):
                a_r = [q for q in range(E) if not q & (1 << k)]
                b_r = [q | (1 << k) for q in a_r]
                a, b = v[:, :, a_r], v[:, :, b_r]
                v = v.copy()
                v[:, :, a_r], v[:, :, b_r] = a + b, a - b
        return v

    v = signed_fwht(signed_fwht(v, 0), 1)
    signs = np.zeros((B, 1 << n), np.uint8)
    signs[:, il] = v >= 0
    rows = params.rows.reshape(L, K)
    out = np.zeros((B, L), np.int64)
    for k in range(K):       # both packs: bit k of table j is the MSB-first
        out = (out << 1) | signs[:, rows[:, k]]
    return out.astype(np.int32)


@pytest.mark.parametrize("B,d,K,L", [(3, 1, 5, 4), (9, 2, 3, 7),
                                     (37, 36, 15, 50), (5, 64, 15, 50),
                                     (6, 300, 6, 9), (4, 1024, 13, 32),
                                     (3, 1025, 13, 32), (2, 4097, 13, 32),
                                     (2, 9000, 4, 3)])
def test_numpy_model_of_the_kernel_is_bitwise_plain(B, d, K, L):
    cfg = SrpConfig(dim=d, num_bits=K, num_tables=L, seed=d,
                    hash_mode="srht")
    x = np.random.default_rng(d).normal(size=(B, d)).astype(np.float32)
    x[0] = 0.0                               # −0.0 pad lanes: all ones
    if B > 2:
        x[1, d // 2] = np.nan                # a NaN row
    got = srht_model(x, cfg)
    want = SH.srht_hash_plain(torch.from_numpy(x), cfg).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0] == (1 << K) - 1).all()


# ---------------------------------------------------------------------------
# ace_update
# ---------------------------------------------------------------------------

EMPTY = 0xFFFFFFFF


def _slot(key: int) -> int:
    """The kernel's first probe for a 32-bit key: Fibonacci hashing into
    ``TABLE_SLOTS`` slots."""
    bits = U.TABLE_SLOTS.bit_length() - 1
    return ((key * 0x9E3779B1) & EMPTY) >> (32 - bits)


def _signatures(keys) -> set:
    """The 5-bit hash signatures a warp's keys take (the top bits of the
    same product as the slot)."""
    return {((int(q) * 0x9E3779B1) & EMPTY) >> 27 for q in keys}


def colliding_ids(n: int, nb: int) -> np.ndarray:
    """n distinct ids in [0, nb) whose keys in table 0 (the id itself)
    all hash to one slot: more than ``PROBES`` of them in one block
    overflow the block's table."""
    by_slot = {}
    for i in range(nb):
        by_slot.setdefault(_slot(i), []).append(i)
        if len(by_slot[_slot(i)]) == n:
            return np.array(by_slot[_slot(i)], np.int32)
    raise ValueError(f"no {n} ids of {nb} share a slot")


def update_model(counts, buckets, row_mask=None, row_base=None):
    """csrc/ace_update.cu's bookkeeping, block by block (one table, 256
    rows) and warp by warp: returns the counts, how many items or merged
    warps went straight to global atomics because the table had no slot
    for them within ``PROBES``, how many warps held one key (merged in one
    lane) or more than ``SPREAD`` signatures, and how many blocks added
    straight to the counts (half their warps spread or empty)."""
    counts = counts.astype(np.int64).copy()
    R, nb = counts.shape
    B, L = buckets.shape
    flat = counts.reshape(-1)
    overflow = merged = spread = directs = 0

    def add(keys, hits, key, n):
        s = _slot(key)
        for _ in range(U.PROBES):
            if keys[s] in (EMPTY, key):
                keys[s] = key
                hits[s] += n
                return True
            s = (s + 1) % U.TABLE_SLOTS
        return False

    for j in range(L):
        for b0 in range(0, B, U.BLOCK_ROWS):
            keys = np.full(U.TABLE_SLOTS, EMPTY, np.int64)
            hits = np.zeros(U.TABLE_SLOTS, np.int64)
            b = b0 + np.arange(U.BLOCK_ROWS)
            live = b < B
            bl = np.minimum(b, B - 1)
            valid = live & (True if row_mask is None else row_mask[bl])
            row = j + (0 if row_base is None else row_base[bl].astype(
                np.int64))
            ids = buckets[bl, j].astype(np.int64)
            valid &= (row >= 0) & (row < R) & (ids >= 0) & (ids < nb)
            key = row * nb + ids
            fits = valid & (key < EMPTY)
            warps = []
            for w in range(0, U.BLOCK_ROWS, 32):
                wk = key[w:w + 32][fits[w:w + 32]]
                same = len(wk) > 0 and (wk == wk[0]).all()
                wide = not same and len(_signatures(wk)) > U.SPREAD
                warps.append((w, wk, same, wide))
            idle = sum(wide or not len(wk) for _, wk, _, wide in warps)
            direct = 2 * idle >= U.BLOCK_ROWS // 32
            for w, wk, same, wide in warps:
                if same:
                    merged += 1
                spread += wide
                if direct or wide:                      # straight to counts
                    np.add.at(flat, wk, 1)
                elif same:                              # one lane adds all
                    if not add(keys, hits, int(wk[0]), len(wk)):
                        flat[wk[0]] += len(wk)
                        overflow += 1
                else:
                    for q in wk:
                        if not add(keys, hits, int(q), 1):
                            flat[q] += 1
                            overflow += 1
                for i in range(w, w + 32):
                    if valid[i] and not fits[i]:
                        flat[key[i]] += 1
            directs += direct
            for s in np.flatnonzero(keys != EMPTY):      # the flush
                flat[keys[s]] += hits[s]
    return counts.astype(np.int32), overflow, merged, spread, directs


def _plain(counts, buckets, row_mask=None, row_base=None):
    t = (lambda a: None if a is None else torch.from_numpy(a))
    return U.ace_update_plain(torch.from_numpy(counts.copy()),
                              torch.from_numpy(buckets), t(row_mask),
                              t(row_base)).numpy()


def _dropping(counts, buckets, row_mask, row_base):
    """The reference's scatter, which drops ids outside [0, 2^K) and rows
    outside [0, R) (the plain version's ``index_put_`` raises on them)."""
    R, nb = counts.shape
    rows = np.arange(buckets.shape[1])[None, :] + row_base[:, None]
    keep = ((buckets >= 0) & (buckets < nb) & (rows >= 0) & (rows < R)
            & row_mask[:, None])
    out = counts.astype(np.int64)
    np.add.at(out, (rows[keep], buckets[keep]), 1)
    return out.astype(np.int32)


def test_update_model_hot_bucket():
    """Every id in one bucket at B = 4096, L = 50: each warp's 32 rows merge
    in one lane, one slot a block."""
    counts = np.zeros((50, 1 << 15), np.int32)
    ids = np.full((4096, 50), 12345, np.int32)
    got, overflow, merged, spread, directs = update_model(counts, ids)
    np.testing.assert_array_equal(got, _plain(counts, ids))
    assert (overflow, merged, spread, directs) == (0, 4096 // 32 * 50, 0, 0)
    assert (got[:, 12345] == 4096).all()


def test_update_model_overflows_the_table_exactly():
    """A clustered block of table 0 (rows 24-255 on four ids) whose first
    twenty-four rows hold distinct ids on one first probe: at most
    ``PROBES`` of those find a slot, the rest go global; the other tables
    all-distinct (their blocks add straight to the counts); exact."""
    rng = np.random.default_rng(0)
    B, L = 300, 20
    ids = np.stack([rng.permutation(1 << 15)[:B] for _ in range(L)], 1)
    hot = colliding_ids(24, 1 << 15)
    ids[:24, 0] = hot
    ids[24:256, 0] = rng.choice(np.setdiff1d(np.arange(64), hot), 4)[
        rng.integers(0, 4, 232)]
    ids = ids.astype(np.int32)
    counts = rng.integers(0, 9, size=(L, 1 << 15)).astype(np.int32)
    got, overflow, _, _, directs = update_model(counts, ids)
    assert overflow >= 24 - U.PROBES
    assert directs == 2 * L - 1          # every block but table 0's first
    np.testing.assert_array_equal(got, _plain(counts, ids))


@pytest.mark.parametrize("B,L,K", [(512, 32, 13), (256, 50, 15)])
def test_update_model_spread_warps_go_straight(B, L, K):
    """Random ids at the stream step's and the admit's shapes: nearly every
    warp takes more than ``SPREAD`` signatures, so every block adds
    straight to the counts; exact either way."""
    rng = np.random.default_rng(B)
    ids = rng.integers(0, 1 << K, size=(B, L)).astype(np.int32)
    counts = np.zeros((L, 1 << K), np.int32)
    got, overflow, merged, spread, directs = update_model(counts, ids)
    warps = B // 32 * L
    assert spread >= 0.9 * warps and merged == 0 and overflow == 0
    assert directs == -(-B // U.BLOCK_ROWS) * L
    np.testing.assert_array_equal(got, _plain(counts, ids))


def test_update_model_masks_base_rows_and_drops():
    rng = np.random.default_rng(1)
    R, L, K, B = 40, 7, 6, 301
    ids = rng.integers(0, 1 << K, size=(B, L)).astype(np.int32)
    ids[::17, 3] = 1 << K            # out of range ids
    ids[::23, 1] = -1
    base = rng.integers(0, R - L + 1, size=B).astype(np.int32)
    base[::29] = R - 2               # rows j >= 2 fall off the table
    base[::31] = -3                  # rows j < 3 fall before it
    mask = rng.random(B) < 0.6
    counts = rng.integers(0, 9, size=(R, 1 << K)).astype(np.int32)
    got = update_model(counts, ids, mask, base)[0]
    np.testing.assert_array_equal(got, _dropping(counts, ids, mask, base))
    ok = ((ids >= 0) & (ids < 1 << K)).all(1) & (base >= 0) & (base <= R - L)
    np.testing.assert_array_equal(
        update_model(counts, ids[ok], mask[ok], base[ok])[0],
        _plain(counts, ids[ok], mask[ok], base[ok]))


def test_update_model_merges_a_warp_of_one_counter():
    """Clustered rows: a warp whose 32 rows of a table hit one counter adds
    them with one lane; mixed warps add lane by lane through the table;
    2^K = 2 so every slot is contended."""
    rng = np.random.default_rng(2)
    ids = np.repeat(rng.integers(0, 2, size=(24, 3)), 32, axis=0)
    ids[::7, 1] ^= 1                       # some warps mixed
    ids = ids.astype(np.int32)
    counts = np.zeros((3, 2), np.int32)
    got, overflow, merged, spread, directs = update_model(counts, ids)
    assert overflow == spread == directs == 0 and 0 < merged < 72
    assert int(got.sum()) == ids.size
    np.testing.assert_array_equal(got, _plain(counts, ids))


def test_update_refuses_more_tables_than_grid_rows():
    """One block row a table: the kernel path takes at most 65535 tables
    and refuses more before it launches (the check sits after the CPU's
    plain path, so only a CUDA tensor reaches it)."""
    assert U.MAX_TABLES == 65535
    assert U.TABLE_SLOTS >= 2 * U.BLOCK_ROWS     # load factor <= 1/2
