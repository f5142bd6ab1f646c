"""``ace_query_sum``, the one-launch gather and row sum of
``repro_torch.kernels.ace_query``, on CPU tensors (where the wrapper takes
its plain version), against the reference on the same numpy-made inputs:
``repro.kernels.ops``'s scores and Welford stream (its Pallas gather in
interpret mode), the fleet's routed scores and the ring's live sums; and
against the gather-then-reduce compositions each ``ops`` call site took
before it, which it must equal bitwise while a row's sum stays below
2^24.  A monkeypatched count shows that every ``ops`` function launches
one ``ace_query_sum`` a gather and never the (B, L) ``ace_query``.

Tolerances:
* against the old compositions, the fleet's and the ring's integer sums:
  bitwise (integer-valued float32 sums below 2^24 are exact in any order);
* against ``jnp.mean`` and the reference's Welford stream: rtol 1e-6,
  the port's existing tolerance for its ``ops`` (a multiply by
  float32(1/L) where XLA divides; batch sums in another order);
* above 2^24: the exactly rounded integer sum, bitwise, and the
  reference within rtol 1e-6.

The CUDA kernel is held against the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro.core import sketch as jsk  # noqa: E402
from repro.fleet import state as jfl  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.window import ring as jring  # noqa: E402
from repro_torch.core import sketch as sk  # noqa: E402
from repro_torch.core.convert import tree_from_numpy  # noqa: E402
from repro_torch.core.srp import make_projections  # noqa: E402
from repro_torch.fleet import state as fl  # noqa: E402
from repro_torch.fleet import window as fw  # noqa: E402
from repro_torch.kernels import ace_query as Q  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.window import ring  # noqa: E402
from repro_torch.window.ring import WindowConfig  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _counts(R, K, seed, high=1000):
    return np.random.default_rng(seed).integers(
        0, high, size=(R, 1 << K)).astype(np.int32)


def _ids(B, K, L, seed):
    return np.random.default_rng(seed).integers(
        0, 1 << K, size=(B, L)).astype(np.int32)


def _mask(L, kind):
    m = np.ones(L, np.float32)
    if kind == "two":
        m[[0, L // 2]] = 0.0
    elif kind == "all":
        m[:] = 0.0
    return m


MASKS = ["none", "two", "all"]


def js_cfg(K, L):
    return jsk.AceConfig(dim=4, num_bits=K, num_tables=L)


class TestAgainstReference:
    @pytest.mark.parametrize("mask", MASKS)
    @pytest.mark.parametrize("B,K,L", [(33, 8, 10), (7, 5, 50), (40, 6, 65)])
    def test_scores_match_reference_ops(self, B, K, L, mask):
        """The "mean" scale against the reference's ``ops.ace_query`` (its
        Pallas gather in interpret mode, then ``jnp.mean`` or
        ``masked_table_mean``); every table masked scores 0 (nh clamps to
        1)."""
        counts, ids = _counts(L, K, 7), _ids(B, K, L, 8)
        m = None if mask == "none" else _mask(L, mask)
        js = jsk.init(js_cfg(K, L))._replace(counts=jnp.asarray(counts))
        want = np.asarray(jops.ace_query(
            js, jnp.asarray(ids), table_mask=None if m is None
            else jnp.asarray(m)))
        got = Q.ace_query_sum(_t(counts), _t(ids),
                              table_mask=None if m is None else _t(m))
        assert got.dtype == torch.float32 and tuple(got.shape) == (B,)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        if mask == "all":
            assert not got.any()

    @pytest.mark.parametrize("steps", [1, 4])
    def test_welford_stream_matches_reference_ace_update(self, steps):
        """``ops.ace_update``'s post-insert means (the "mean" scale) fold
        into the same Welford stream as the reference's kernel-path
        insert."""
        K, L = 7, 12
        js = jsk.init(js_cfg(K, L))
        cfg = sk.AceConfig(dim=4, num_bits=K, num_tables=L)
        ps = sk.init(cfg, CPU)
        for s in range(steps):
            ids = _ids(29 + s, K, L, 20 + s)
            js = jops.ace_update(js, jnp.asarray(ids), js_cfg(K, L))
            ps = ops.ace_update(ps, _t(ids), cfg)
        np.testing.assert_array_equal(ps.counts.numpy(),
                                      np.asarray(js.counts))
        assert float(ps.n) == float(js.n)
        for k in ("welford_mean", "welford_m2"):
            np.testing.assert_allclose(float(getattr(ps, k)),
                                       float(getattr(js, k)), rtol=1e-6)

    @pytest.mark.parametrize("masked", [False, True])
    def test_fleet_scores_with_a_routed_mask(self, masked):
        """At base rows tid·L with a (T, L) mask routed by the tenant ids:
        the reference's ``fleet_scores`` bitwise, a tenant with no healthy
        table included."""
        T, K, L, B = 4, 7, 6, 23
        rng = np.random.default_rng(6)
        js = jfl.init(jfl.FleetConfig(ace=js_cfg(K, L), num_tenants=T))
        for _ in range(3):
            js = jfl.insert_masked(
                js, jnp.asarray(rng.integers(0, T, 30), jnp.int32),
                jnp.asarray(_ids(30, K, L, int(rng.integers(1 << 20)))),
                jnp.ones(30, bool), js_cfg(K, L))
        ps = tree_from_numpy(fl.FleetState, js, CPU)
        tm = np.ones((T, L), np.float32)
        tm[1, 2] = tm[3, 0] = 0.0
        tm[2] = 0.0                          # a tenant with none healthy
        tids = rng.integers(0, T, B).astype(np.int32)
        ids = _ids(B, K, L, 9)
        pm, jm = (_t(tm), jnp.asarray(tm)) if masked else (None, None)
        got = Q.ace_query_sum(
            ps.counts.view(T * L, -1), _t(ids),
            fl.tenant_rows(_t(tids), L), table_mask=pm, tenant_ids=_t(tids))
        want = np.asarray(jfl.fleet_scores(js, jnp.asarray(tids),
                                           jnp.asarray(ids), jm))
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("masked", [False, True])
    def test_ring_live_sums(self, masked):
        """The "sum" scale at the live epoch's rows cursor·L, with the
        unmasked sum beside it: the live half of the reference's
        ``window_table_sums`` bitwise."""
        E, K, L, B = 3, 6, 8, 17
        rng = np.random.default_rng(4)
        jcfg = js_cfg(K, L)
        js = jring.init(jcfg, E)
        for _ in range(4):
            js = jring.maybe_rotate(jring.insert_current(
                js, jnp.asarray(_ids(20, K, L, int(rng.integers(99)))),
                jnp.asarray(rng.random(20) < 0.7), jcfg), 1)
        ps = tree_from_numpy(ring.WindowedAceState, js, CPU)
        ids = _ids(B, K, L, 5)
        m = _mask(L, "two") if masked else None
        live, every = Q.ace_query_sum(
            ps.counts.view(E * L, -1), _t(ids), ring.live_rows(ps, B),
            table_mask=None if m is None else _t(m), scale="sum",
            with_unmasked=True)
        want = jring.window_table_sums(
            js, jnp.asarray(ids), None if m is None else jnp.asarray(m))
        np.testing.assert_array_equal(live.numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(
            every.numpy(), np.asarray(jring.window_table_sums(
                js, jnp.asarray(ids))[1]))


class TestOldCompositions:
    """Each ``ops`` call site's old gather + PyTorch reduction, bitwise."""

    @pytest.mark.parametrize("mask", MASKS)
    @pytest.mark.parametrize("scale", Q.SCALES)
    @pytest.mark.parametrize("based", [False, True])
    def test_each_scale_equals_its_composition(self, scale, mask, based):
        K, L, B = 9, 50, 64
        R = 3 * L if based else L
        counts, ids = _t(_counts(R, K, 1)), _t(_ids(B, K, L, 2))
        base = _t(np.random.default_rng(3).integers(0, 3, B) * L) \
            .to(torch.int32) if based else None
        g = Q.ace_query_plain(counts, ids, base)
        m = None if mask == "none" else _t(_mask(L, mask))
        if m is None:
            want = {"sum": torch.sum(g, dim=-1),
                    "mean": torch.sum(g, dim=-1) * sk.reciprocal(L)}[scale]
        else:
            want = {"sum": torch.sum(g * m, dim=-1),
                    "mean": sk.masked_table_mean(g, m)}[scale]
        got = Q.ace_query_sum(counts, ids, base, table_mask=m, scale=scale)
        assert torch.equal(got, want)
        assert torch.equal(got, Q.ace_query_sum_plain(
            counts, ids, base, table_mask=m, scale=scale))

    @pytest.mark.parametrize("masked", [False, True])
    def test_routed_mask_equals_fleet_combine(self, masked):
        T, K, L, B = 5, 7, 9, 41
        rng = np.random.default_rng(11)
        counts = _t(_counts(T * L, K, 12))
        ids, tids = _t(_ids(B, K, L, 13)), _t(
            rng.integers(0, T, B).astype(np.int32))
        tm = _t((rng.random((T, L)) < 0.7).astype(np.float32)) \
            if masked else None
        rows = fl.tenant_rows(tids, L)
        want = fl.fleet_combine(Q.ace_query_plain(counts, ids, rows), tids,
                                tm)
        got = Q.ace_query_sum(counts, ids, rows, table_mask=tm,
                              tenant_ids=tids)
        assert torch.equal(got, want)

    @pytest.mark.parametrize("mask", MASKS)
    def test_mean_is_the_plain_sketch_score(self, mask):
        """The "mean" scale is ``sketch.batch_scores``, the plain path's
        score (so ``ops.ace_update``'s Welford rates are the plain
        insert's)."""
        counts, ids = _t(_counts(12, 7, 4)), _t(_ids(30, 7, 12, 5))
        m = None if mask == "none" else _t(_mask(12, mask))
        assert torch.equal(Q.ace_query_sum(counts, ids, table_mask=m),
                           sk.batch_scores(counts, ids, m))

    def test_bool_and_float_masks_agree(self):
        counts, ids = _t(_counts(8, 6, 1)), _t(_ids(10, 6, 8, 2))
        m = _mask(8, "two")
        assert torch.equal(
            Q.ace_query_sum(counts, ids, table_mask=_t(m)),
            Q.ace_query_sum(counts, ids, table_mask=_t(m).bool()))


class TestAbove2To24:
    @pytest.mark.parametrize("scale", Q.SCALES)
    def test_row_sum_past_2_24_is_rounded_once(self, scale):
        """Counters near 2^20 on 50 tables: each row's sum passes 2^24, and
        the result is the exact integer sum rounded once, then scaled."""
        K, L, B = 5, 50, 12
        rng = np.random.default_rng(5)
        counts = rng.integers((1 << 20) - 999, (1 << 20) + 999,
                              size=(L, 1 << K)).astype(np.int32) | 1
        ids = _ids(B, K, L, 6)
        exact = counts[np.arange(L)[None, :], ids].astype(np.int64).sum(-1)
        assert (exact > 1 << 24).all()
        s = exact.astype(np.float32)
        want = {"sum": s, "mean": s * np.float32(1.0 / L)}[scale]
        got = Q.ace_query_sum(_t(counts), _t(ids), scale=scale).numpy()
        np.testing.assert_array_equal(got, want.astype(np.float32))
        js = jsk.init(js_cfg(K, L))._replace(counts=jnp.asarray(counts))
        ref = np.asarray(jops.ace_query(js, jnp.asarray(ids)))
        np.testing.assert_allclose(
            got * {"sum": np.float32(1.0 / L), "mean": 1.0}[scale], ref,
            rtol=1e-6)

    def test_negative_and_extreme_counters_sum_exactly(self):
        """int32 counters at both ends: the int64 sum is exact."""
        counts = np.array([[2**31 - 1, -2**31, 5, -7]] * 3, np.int32)
        ids = np.array([[0, 0, 0], [1, 1, 1], [2, 3, 0]], np.int32)
        got = Q.ace_query_sum(_t(counts), _t(ids), scale="sum").numpy()
        exact = counts[np.arange(3)[None, :], ids].astype(np.int64).sum(-1)
        np.testing.assert_array_equal(got, exact.astype(np.float32))


class TestContract:
    def test_clamps_rows_ids_and_tenants(self):
        """Out-of-range base rows, ids and tenant ids clamp into the table,
        as the kernel clamps."""
        counts = _t(_counts(6, 4, 1))
        ids = _t(np.array([[-3, 99], [1, 2]], np.int32))
        base = _t(np.array([-5, 17], np.int32))
        tm = _t(np.array([[1, 0], [0, 1]], np.float32))
        got = Q.ace_query_sum(counts, ids, base, table_mask=tm,
                              tenant_ids=_t(np.array([-1, 9], np.int32)),
                              scale="sum")
        c = counts.numpy()
        np.testing.assert_array_equal(
            got.numpy(), [c[0, 0], c[5, 2]])

    def test_refuses_bad_operands(self):
        counts, ids = _t(_counts(4, 3, 1)), _t(_ids(5, 3, 4, 2))
        with pytest.raises(ValueError, match="scale"):
            Q.ace_query_sum(counts, ids, scale="median")
        with pytest.raises(ValueError, match="tenant_ids"):
            Q.ace_query_sum(counts, ids, table_mask=torch.ones(2, 4))
        with pytest.raises(ValueError):
            Q.ace_query_sum(counts, ids, table_mask=torch.ones(3))
        with pytest.raises(TypeError):
            Q.ace_query_sum(counts, ids, table_mask=torch.ones(2, 4),
                            tenant_ids=torch.zeros(5, dtype=torch.int64))
        with pytest.raises(ValueError):
            Q.ace_query_sum(counts, ids[:, :3])      # R != L needs row_base

    def test_empty_batch(self):
        counts = _t(_counts(4, 3, 1))
        ids = torch.zeros((0, 4), dtype=torch.int32)
        assert tuple(Q.ace_query_sum(counts, ids).shape) == (0,)


# ---------------------------------------------------------------------------
# Every rewired ops function: one ace_query_sum a gather, no (B, L) gather.
# ---------------------------------------------------------------------------

@pytest.fixture
def calls(monkeypatch):
    n = {"sum": 0, "gather": 0}
    real_sum, real_gather = Q.ace_query_sum, Q.ace_query

    def count_sum(*a, **k):
        n["sum"] += 1
        return real_sum(*a, **k)

    def count_gather(*a, **k):
        n["gather"] += 1
        return real_gather(*a, **k)
    monkeypatch.setattr(Q, "ace_query_sum", count_sum)
    monkeypatch.setattr(Q, "ace_query", count_gather)
    return n


def _cfg(mode):
    return sk.AceConfig(dim=12, num_bits=6, num_tables=8, seed=2,
                        hash_mode=mode)


MASK = _t(_mask(8, "two"))
TMASK = _t(np.array([[1, 1, 0, 1, 1, 1, 1, 1],
                     [1, 1, 1, 1, 1, 1, 0, 0],
                     [1] * 8], np.float32))


def _q():
    return _t(np.random.default_rng(1).normal(size=(16, 12))
              .astype(np.float32))


def _tids():
    return _t(np.random.default_rng(2).integers(0, 3, 16).astype(np.int32))


@pytest.mark.parametrize("mode", ["dense", "srht"])
@pytest.mark.parametrize("masked", [False, True])
class TestOneLaunchPerGather:
    def _w(self, cfg):
        return make_projections(cfg.srp, device=CPU)

    def test_ace_update_and_query(self, calls, mode, masked):
        cfg = _cfg(mode)
        st = sk.init(cfg, CPU)
        ids = ops.hash_dispatch(_q(), self._w(cfg), cfg.srp)
        st = ops.ace_update(st, ids, cfg)
        assert calls == {"sum": 1, "gather": 0}
        ops.ace_query(st, ids, MASK if masked else None)
        assert calls == {"sum": 2, "gather": 0}

    def test_ace_score(self, calls, mode, masked):
        cfg = _cfg(mode)
        ops.ace_score(sk.init(cfg, CPU), _q(), self._w(cfg), cfg,
                      MASK if masked else None)
        # dense: the fused score kernel gathers; SRHT: one sum
        assert calls == {"sum": int(mode == "srht"), "gather": 0}

    def test_ace_admit_at(self, calls, mode, masked):
        cfg = _cfg(mode)
        ops.ace_admit_at(sk.init(cfg, CPU), _q(), self._w(cfg), cfg,
                         torch.tensor(float("-inf")),
                         table_mask=MASK if masked else None)
        # the fused dense admission gathers its own pre-insert counts
        fused = mode == "dense" and not masked
        assert calls == {"sum": 1 if fused else 2, "gather": 0}

    def test_ace_admit_windowed_at(self, calls, mode, masked):
        cfg = _cfg(mode)
        ws = ring.init(cfg, 3, CPU)
        for masked_sums in (True, False):
            ops.ace_admit_windowed_at(
                ws, _q(), self._w(cfg), cfg, torch.tensor(float("-inf")),
                gamma=0.9, table_mask=MASK if masked else None,
                masked_sums=masked_sums)
        assert calls == {"sum": 4, "gather": 0}

    def test_ace_fleet_score_and_admit(self, calls, mode, masked):
        cfg = _cfg(mode)
        fs = fl.init(fl.FleetConfig(ace=cfg, num_tenants=3), CPU)
        tm = TMASK if masked else None
        ops.ace_fleet_score(fs, _q(), _tids(), self._w(cfg), cfg, tm)
        fused = mode == "dense" and not masked   # the fused fleet score
        assert calls == {"sum": 0 if fused else 1, "gather": 0}
        before = calls["sum"]
        ops.ace_fleet_admit_at(fs, _q(), _tids(), self._w(cfg), cfg,
                               torch.full((16,), float("-inf")),
                               table_mask=tm)
        assert calls == {"sum": before + 2, "gather": 0}

    def test_ace_fleet_window_admit(self, calls, mode, masked):
        cfg = _cfg(mode)
        st = fw.init_fleet_window(WindowConfig(ace=cfg, num_epochs=3), 3,
                                  CPU)
        ops.ace_fleet_window_admit(
            st, _q(), _tids(), self._w(cfg), cfg, gamma=0.9, alpha=2.0,
            warmup_items=64.0, table_mask=TMASK if masked else None)
        fused = mode == "dense" and not masked   # the fused admission
        assert calls == {"sum": 1 if fused else 2, "gather": 0}
