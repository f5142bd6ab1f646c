"""The exact-sum convention of the window combine and the fleet score
(``repro_torch.kernels.ace_window_combine`` and ``ace_fleet_score``), on
CPU tensors, where each wrapper takes its plain version.

* ``ace_fleet_score``: each row's gathered counters summed as an exact
  integer, converted once, × float32(1/L) — ``ace_query_sum``'s
  convention — so its dense branch in ``ops.ace_fleet_score`` and the
  SRHT / masked branch (the hash, then the routed ``ace_query_sum``) give
  the same bits on the same ids, past 2^24 too.
* ``ace_window_combine``: each epoch's exact integer sum converted once,
  weighted, accumulated in ring-index order, × float32(1/L); with table
  weights each epoch adds tw_j·g_j in table order instead.  A numpy model
  of the CUDA kernel's data flow (8 epochs and 64 tables a pass, the
  weighted products summed one lane an epoch) holds the kernel's
  arithmetic bitwise against the plain version here, where no card runs
  it.

Tolerances: bitwise throughout (integer sums are exact; the float adds
and multiplies run in one stated order on both sides), and the
reference's ``ring.score_windowed`` within rtol 1e-6 below 2^24, as
``chip_smoke.py`` holds the kernel on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro.window import ring as jring  # noqa: E402
from repro_torch.core import sketch as sk  # noqa: E402
from repro_torch.core.srp import make_projections  # noqa: E402
from repro_torch.fleet import state as fl  # noqa: E402
from repro_torch.kernels import ace_fleet_score as FS  # noqa: E402
from repro_torch.kernels import ace_query as Q  # noqa: E402
from repro_torch.kernels import ace_window_combine as WC  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.window import ring  # noqa: E402

CPU = torch.device("cpu")
F32 = np.float32


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _big_counts(shape, seed):
    """Counters near 2^20, so that a row of 50 sums past 2^24."""
    rng = np.random.default_rng(seed)
    return rng.integers((1 << 20) - 999, 1 << 20, size=shape).astype(np.int32)


def _table_order(g, tw=None):
    """(B, L) float32 added column by column, in table order."""
    s = np.zeros(g.shape[0], F32)
    for j in range(g.shape[1]):
        s = (s + (g[:, j] if tw is None else g[:, j] * tw[j])).astype(F32)
    return s


# ---------------------------------------------------------------------------
# ace_fleet_score
# ---------------------------------------------------------------------------

def _fleet(T, B, d, K, L, seed, big=True, mode="dense"):
    cfg = sk.AceConfig(dim=d, num_bits=K, num_tables=L, seed=seed,
                       hash_mode=mode)
    w = make_projections(cfg.srp, device=CPU)
    rng = np.random.default_rng(seed)
    counts = (_big_counts((T, L, 1 << K), seed) if big else
              rng.integers(0, 9, size=(T, L, 1 << K)).astype(np.int32))
    q = rng.normal(size=(B, d)).astype(np.float32)
    tids = rng.integers(0, T, size=B).astype(np.int32)
    return cfg, w, counts, _t(q), _t(tids)


@pytest.mark.parametrize("T,B,d,K,L", [(3, 40, 16, 8, 50), (1, 7, 9, 4, 3),
                                       (5, 33, 36, 10, 65)])
def test_fleet_score_is_the_exact_row_sum(T, B, d, K, L):
    """Past 2^24 a row: the int64 sum of the routed gathers rounded once,
    × float32(1/L); ``ace_query_sum`` of the same ids at base rows tid·L
    bitwise; the table-order float sum it replaced differs."""
    cfg, w, counts, q, tids = _fleet(T, B, d, K, L, seed=T + L)
    got, ids = FS.ace_fleet_score_planned(_t(counts), q, tids, w, cfg.srp,
                                          None, with_ids=True)
    rows = tids.numpy().astype(np.int64)[:, None] * L + np.arange(L)
    g = counts.reshape(T * L, -1)[rows, ids.numpy()]
    exact = g.astype(np.int64).sum(-1).astype(F32) * F32(1.0 / L)
    np.testing.assert_array_equal(got.numpy(), exact)
    assert torch.equal(got, Q.ace_query_sum(
        _t(counts.reshape(T * L, -1)), ids, fl.tenant_rows(tids, L)))
    assert torch.equal(got, FS.fleet_score_from_ids(_t(counts), ids, tids))
    if L >= 50:
        old = _table_order(g.astype(F32)) * F32(1.0 / L)
        assert (old != exact).any(), "past 2^24 the float order shows"


@pytest.mark.parametrize("big", [False, True])
def test_fleet_score_below_2_24_is_any_float_order(big):
    """Below 2^24 the exact sum is the table-order float sum and
    ``fleet.state.fleet_scores`` (``torch.sum``) bitwise: the old
    convention's bits are kept where they were exact."""
    cfg, w, counts, q, tids = _fleet(4, 64, 12, 9, 50, seed=3, big=big)
    got, ids = FS.ace_fleet_score_planned(_t(counts), q, tids, w, cfg.srp,
                                          None, with_ids=True)
    g = fl.fleet_table_gather(_t(counts), tids, ids).numpy()
    old = _table_order(g) * F32(1.0 / 50)
    if big:
        assert not np.array_equal(got.numpy(), old)
    else:
        np.testing.assert_array_equal(got.numpy(), old)
        state = fl.init(fl.FleetConfig(ace=cfg, num_tenants=4), CPU)
        state = state._replace(counts=_t(counts))
        assert torch.equal(got, fl.fleet_scores(state, tids, ids))


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("T,L", [(4, 50), (1, 6), (3, 33)])
def test_ops_dense_branch_is_the_masked_branch(T, L, big):
    """``ops.ace_fleet_score``'s dense branch (``ace_fleet_score``) and
    its masked branch (the same dense hash, then the routed
    ``ace_query_sum``) under an all-healthy (T, L) mask: bitwise."""
    cfg, w, counts, q, tids = _fleet(T, 48, 24, 8, L, seed=T * L, big=big)
    state = fl.init(fl.FleetConfig(ace=cfg, num_tenants=T), CPU)
    state = state._replace(counts=_t(counts))
    dense = ops.ace_fleet_score(state, q, tids, w, cfg)
    masked = ops.ace_fleet_score(state, q, tids, w, cfg,
                                 table_mask=torch.ones((T, L)))
    assert torch.equal(dense, masked)


@pytest.mark.parametrize("big", [False, True])
def test_ops_srht_branch_is_the_dense_function_of_its_ids(big):
    """The SRHT branch of ``ops.ace_fleet_score`` equals the dense
    kernel's function downstream of the SRHT ids bitwise: one convention
    for both hash families."""
    T, L = 5, 50
    cfg, w, counts, q, tids = _fleet(T, 40, 36, 10, L, seed=8, big=big,
                                     mode="srht")
    state = fl.init(fl.FleetConfig(ace=cfg, num_tenants=T), CPU)
    state = state._replace(counts=_t(counts))
    got = ops.ace_fleet_score(state, q, tids, w, cfg)
    ids = ops.hash_dispatch(q, w, cfg.srp)
    assert torch.equal(got, FS.fleet_score_from_ids(_t(counts), ids, tids))


# ---------------------------------------------------------------------------
# ace_window_combine
# ---------------------------------------------------------------------------

def _ring(E, L, K, B, seed, big=True):
    rng = np.random.default_rng(seed)
    counts = (_big_counts((E, L, 1 << K), seed) if big else
              rng.integers(0, 999, size=(E, L, 1 << K)).astype(np.int32))
    ids = rng.integers(0, 1 << K, size=(B, L)).astype(np.int32)
    w = (0.9 ** rng.permutation(E)).astype(F32)
    m = np.ones(L, F32)
    m[[0, L // 2]] = 0.0
    tw = (m / max(m.sum(), 1.0)).astype(F32)
    return counts, ids, w, tw


def _epoch_gathers(counts, ids):
    E, L, _ = counts.shape
    return np.stack([counts[e, np.arange(L), ids] for e in range(E)], 1)


def _kernel_model(counts, ids, w, tw=None, epochs=8, tables=64):
    """``csrc/ace_window_combine.cu``'s data flow in numpy, a row at a
    time: epochs ``epochs`` at a time, tables ``tables`` a pass; the
    unweighted epoch sums in int64, the weighted ones one running float
    sum an epoch over the pass's products; the fold in ring order."""
    E, L, _ = counts.shape
    g = _epoch_gathers(counts, ids)                       # (B, E, L)
    out = np.zeros(len(ids), F32)
    for b in range(len(ids)):
        acc = F32(0)
        for e0 in range(0, E, epochs):
            ne = min(epochs, E - e0)
            part = np.zeros(ne, np.int64)
            run = np.zeros(ne, F32)
            for j0 in range(0, L, tables):
                blk = g[b, e0:e0 + ne, j0:j0 + tables]
                if tw is None:
                    part += blk.astype(np.int64).sum(-1)
                    continue
                prod = (blk.astype(F32) * tw[j0:j0 + tables]).astype(F32)
                for k in range(ne):
                    for p in prod[k]:
                        run[k] = F32(run[k] + p)
            for k in range(ne):
                s = run[k] if tw is not None else F32(part[k])
                acc = F32(acc + F32(w[e0 + k] * s))
        out[b] = acc if tw is not None else F32(acc * F32(1.0 / L))
    return out


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("E,L,K,B", [(4, 50, 6, 9), (1, 5, 4, 3),
                                     (9, 130, 5, 4), (8, 64, 4, 2),
                                     (2, 65, 7, 5), (17, 1, 3, 6)])
def test_window_combine_is_the_kernel_model(E, L, K, B, weighted):
    """The plain version against the numpy model of the kernel, bitwise,
    past 2^24 an epoch: E = 1, more epochs than one pass holds (9, 17), L
    at and past one pass of 64 tables, L = 1."""
    counts, ids, w, tw = _ring(E, L, K, B, seed=E * 100 + L)
    tw = tw if weighted else None
    got = WC.ace_window_combine(_t(counts), _t(ids), _t(w),
                                None if tw is None else _t(tw))
    np.testing.assert_array_equal(got.numpy(),
                                  _kernel_model(counts, ids, w, tw))


@pytest.mark.parametrize("E,L", [(4, 50), (3, 7)])
def test_window_combine_epoch_sum_is_exact_past_2_24(E, L):
    """Unweighted, past 2^24 an epoch: each epoch's int64 sum rounded once,
    then the ring-order fold; the old table-order float sum differs."""
    counts, ids, w, _ = _ring(E, L, 6, 64, seed=E + L)
    got = WC.ace_window_combine(_t(counts), _t(ids), _t(w)).numpy()
    g = _epoch_gathers(counts, ids)
    acc = np.zeros(len(ids), F32)
    old = np.zeros(len(ids), F32)
    for e in range(E):
        s = g[:, e].astype(np.int64).sum(-1).astype(F32)
        acc = (acc + (w[e] * s).astype(F32)).astype(F32)
        so = _table_order(g[:, e].astype(F32))
        old = (old + (w[e] * so).astype(F32)).astype(F32)
    np.testing.assert_array_equal(got, acc * F32(1.0 / L))
    if L == 50:
        assert (got != old * F32(1.0 / L)).any(), "the float order shows"


def test_window_combine_weighted_keeps_table_order_past_2_24():
    """Weighted, past 2^24 an epoch: each epoch's tw_j·g_j added in table
    order j = 0..L−1, as before this convention changed (not the exact
    sum)."""
    E, L = 3, 50
    counts, ids, w, tw = _ring(E, L, 6, 32, seed=21)
    tw = np.full(L, F32(1.0), F32)           # weights 1: sums past 2^24
    got = WC.ace_window_combine(_t(counts), _t(ids), _t(w), _t(tw)).numpy()
    g = _epoch_gathers(counts, ids).astype(F32)
    acc = np.zeros(len(ids), F32)
    for e in range(E):
        acc = (acc + (w[e] * _table_order(g[:, e], tw)).astype(F32)) \
            .astype(F32)
    np.testing.assert_array_equal(got, acc)


@pytest.mark.parametrize("gamma", [1.0, 0.9, 0.5])
def test_window_score_within_the_reference_below_2_24(gamma):
    """``ops.ace_window_score`` against the reference's
    ``ring.score_windowed`` on the same ring (carried across), below
    2^24: rtol 1e-6; at γ = 1 (integer epoch sums) bitwise."""
    E, L, K, B = 4, 50, 6, 40
    counts, ids, _, _ = _ring(E, L, K, B, seed=5, big=False)
    cfg = sk.AceConfig(dim=8, num_bits=K, num_tables=L)
    st = ring.init(cfg, E, CPU)
    st = st._replace(counts=_t(counts),
                     cursor=torch.tensor(2, dtype=torch.int32))
    got = ops.ace_window_score(st, _t(ids), gamma).numpy()
    from repro.core import sketch as jsk
    jst = jring.init(jsk.AceConfig(dim=8, num_bits=K, num_tables=L), E)
    jst = jst._replace(counts=jnp.asarray(counts),
                       cursor=jnp.asarray(2, jnp.int32))
    want = np.asarray(jring.score_windowed(jst, jnp.asarray(ids), gamma))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if gamma == 1.0:
        np.testing.assert_array_equal(got, want)
    assert torch.equal(torch.from_numpy(got), ring.score_windowed(
        st, _t(ids), gamma))
