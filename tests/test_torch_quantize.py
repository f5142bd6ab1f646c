"""The port's quantized count planes (``repro_torch.core.quantize`` and the
narrow count dtypes through every state, kernel, filter, runner and
``Guardrail``) against the reference's (``repro.core.quantize``), class
for class after tests/test_quantized_counts.py, on the same numpy-made
inputs and the same JAX-drawn W, on the CPU (every kernel wrapper takes
its plain version; the reference's Pallas kernels run in interpret mode).

Tolerances:
* narrow planes, escalation tables (offs, vals, lost), post-scatter
  values, logical gathers, scores, masks, n: bitwise — below saturation,
  wrap for wrap past it without promotion, exact past it with promotion;
* Σ logical² (``sq_sum``) and μ: bitwise where every partial sum stays
  below 2^24 (int8), rtol 1e-6 for int16 planes near their cap (float32
  sums of ~2^30 run in another order); Welford streams rtol 1e-5, as the
  existing parity tests;
* float32 counts through the kernels' plain versions: the reference's
  own rtol 1e-6 (integer-valued here, so in fact exact).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro.core import quantize as jqz  # noqa: E402
from repro.core import sketch as jsk  # noqa: E402
from repro.fleet import state as jfl  # noqa: E402
from repro.window import ring as jring  # noqa: E402
from repro_torch.core import quantize as qz  # noqa: E402
from repro_torch.core import sketch as sk  # noqa: E402
from repro_torch.core.convert import (state_from_numpy,  # noqa: E402
                                      state_to_numpy, tree_from_numpy)
from repro_torch.fleet import state as fl  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.window import ring  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

CPU = torch.device("cpu")
NARROW = ("int8", "int16")


def _t(a):
    return torch.from_numpy(np.array(a))


def _cap(dt):
    return int(np.iinfo(dt).max)


def _eq(port, ref, what=""):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref), err_msg=what)


def _esc_eq(pe, je):
    for k in ("offs", "vals", "lost"):
        _eq(getattr(pe, k), getattr(je, k), k)


def _flat_offs(ids, nb):
    return (ids + np.arange(ids.shape[1], dtype=np.int32)[None] * nb) \
        .astype(np.int32)


# ---------------------------------------------------------------------------
# Every quantize function against the reference's.
# ---------------------------------------------------------------------------

def _scenario(name, dt, rng):
    """(L, K, capacity, the starting plane, [(ids, weights), ...])."""
    cap = _cap(dt)

    def ids(B, nb, L, fixed=None):
        if fixed is not None:
            return np.full((B, L), fixed, np.int32)
        return rng.integers(0, nb, size=(B, L)).astype(np.int32)
    if name == "below":                       # far below the cap
        L, K, C = 3, 4, 4
        plane = np.zeros((L, 1 << K), dt)
        steps = [(ids(20, 16, L), np.ones(20, np.int32)),
                 (ids(20, 16, L), rng.integers(0, 2, 20).astype(np.int32))]
    elif name == "at_max":                    # promotion at exactly the cap
        L, K, C = 2, 2, 4
        plane = np.zeros((L, 1 << K), dt)
        plane[:, 0] = cap - 16
        steps = [(ids(16, 4, L, 0), np.ones(16, np.int32)),
                 (ids(1, 4, L, 0), np.ones(1, np.int32))]
    elif name == "past":                      # excess past the cap
        L, K, C = 2, 3, 8
        plane = rng.integers(cap - 3, cap + 1, size=(L, 1 << K)).astype(dt)
        steps = [(ids(30, 8, L), np.ones(30, np.int32)) for _ in range(3)]
    elif name == "delete":                    # a delete that un-promotes
        L, K, C = 1, 2, 4
        plane = np.zeros((L, 1 << K), dt)
        plane[0, 0] = cap
        steps = [(ids(10, 4, L, 0), np.ones(10, np.int32)),
                 (ids(15, 4, L, 0), np.full(15, -1, np.int32))]
    elif name == "lost":                      # a full table counts lost
        L, K, C = 2, 2, 1
        plane = np.zeros((L, 1 << K), dt)
        plane[:, 0] = cap
        steps = [(ids(5, 4, L, 0), np.ones(5, np.int32)),
                 (ids(3, 4, L, 0), np.ones(3, np.int32))]
    else:                                     # "mixed": ±1 and 0 weights
        L, K, C = 3, 3, 3
        plane = rng.integers(cap - 5, cap + 1, size=(L, 1 << K)).astype(dt)
        steps = [(ids(25, 8, L), rng.integers(-1, 2, 25).astype(np.int32))
                 for _ in range(3)]
    return L, K, C, plane, steps


class TestQuantizeFunctions:
    """Each function of ``repro_torch.core.quantize`` bitwise the
    reference's, step by step."""

    @pytest.mark.parametrize("dt", NARROW)
    @pytest.mark.parametrize("name", ["below", "at_max", "past", "delete",
                                      "lost", "mixed"])
    def test_scatter_and_reads_match_reference(self, name, dt):
        rng = np.random.default_rng(hash((name, dt)) % 2**32)
        L, K, C, plane, steps = _scenario(name, dt, rng)
        assert qz.cap_for(dt) == jqz.cap_for(dt) == _cap(dt)
        assert qz.is_narrow(dt) and not qz.is_narrow("int32")
        jp, je = jnp.asarray(plane), jqz.init_esc(C)
        pp, pe = _t(plane), qz.init_esc(C)
        _esc_eq(pe, je)
        for ids, w in steps:
            offs = _flat_offs(ids, 1 << K)
            jp, je, jpost = jqz.quantized_scatter(jp, je, jnp.asarray(offs),
                                                  jnp.asarray(w))
            pp, pe, ppost = qz.quantized_scatter(pp, pe, _t(offs), _t(w))
            _eq(pp, jp, "plane")
            _eq(ppost, jpost, "post")
            _esc_eq(pe, je)
        probe = rng.integers(0, 1 << K, size=(9, L)).astype(np.int32)
        probe[0] = 0
        poffs = _flat_offs(probe, 1 << K)
        _eq(qz.esc_lookup(pe, _t(poffs)), jqz.esc_lookup(je, poffs))
        _eq(qz.gather_logical(pp, pe, _t(poffs)),
            jqz.gather_logical(jp, je, poffs))
        _eq(qz.batch_scores_logical(pp, pe, _t(probe)),
            jqz.batch_scores_logical(jp, je, jnp.asarray(probe)))
        mask = np.ones(L, np.float32)
        mask[0] = 0.0
        _eq(qz.batch_scores_logical(pp, pe, _t(probe), _t(mask)),
            jqz.batch_scores_logical(jp, je, jnp.asarray(probe),
                                     jnp.asarray(mask)))
        dense = qz.densify(pp, pe)
        _eq(dense, jqz.densify(jp, je))
        np.testing.assert_allclose(float(qz.sq_sum(pp, pe)),
                                   float(jqz.sq_sum(jp, je)),
                                   rtol=0 if dt == "int8" else 1e-6)
        for c in sorted({1, C}):
            pn, pq_ = qz.requantize(dense, c, dt)
            jn, jq_ = jqz.requantize(jnp.asarray(dense.numpy()), c,
                                     jnp.dtype(dt))
            _eq(pn, jn, "requantized plane")
            _esc_eq(pq_, jq_)
        if name == "at_max":
            assert int(pp[0, 0]) == _cap(dt)
            assert int((pe.offs != qz.SENTINEL).sum()) == 2
        if name == "lost":
            assert float(pe.lost) == 5.0 + 3.0

    @pytest.mark.parametrize("dt", NARROW)
    def test_requantize_ties_keep_the_lower_offsets(self, dt):
        """Equal excesses compete for fewer slots: ``lax.top_k`` keeps the
        lower offsets, and so does the port's stable sort."""
        cap = _cap(dt)
        dense = np.full((2, 8), cap - 1, np.int32)
        dense[0, [1, 3, 6]] = cap + 5
        dense[1, [0, 2]] = cap + 5
        dense[1, 7] = cap + 9
        for c in (1, 2, 3, 4, 6):
            pn, pe = qz.requantize(_t(dense), c, dt)
            jn, je = jqz.requantize(jnp.asarray(dense), c, jnp.dtype(dt))
            _eq(pn, jn)
            _esc_eq(pe, je)
        assert pe.offs.tolist()[:6] == [1, 3, 6, 8, 10, 15]

    def test_init_esc_refuses_no_capacity(self):
        with pytest.raises(ValueError, match="capacity"):
            qz.init_esc(0)


# ---------------------------------------------------------------------------
# The sketch below saturation: narrow ≡ the reference's, ≡ int32 widened.
# ---------------------------------------------------------------------------

def _cfgs(dt, esc, K=5, L=4, **kw):
    kw = dict(dim=6, num_bits=K, num_tables=L, seed=0, counter_dtype=dt,
              esc_capacity=esc, **kw)
    wide = {**kw, "counter_dtype": "int32", "esc_capacity": 0}
    return sk.AceConfig(**kw), jsk.AceConfig(**kw), sk.AceConfig(**wide)


def _ids(rng, B, cfg):
    return rng.integers(0, cfg.num_buckets,
                        size=(B, cfg.num_tables)).astype(np.int32)


def _assert_sketch(ps, js, exact_mu=True):
    got = state_to_numpy(ps)
    np.testing.assert_array_equal(got["counts"], np.asarray(js.counts))
    assert got["counts"].dtype == np.asarray(js.counts).dtype
    assert float(ps.n) == float(js.n)
    for k in ("welford_mean", "welford_m2"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(js, k)),
                                   rtol=1e-5, atol=1e-12)
    assert (ps.esc is None) == (js.esc is None)
    if js.esc is not None:
        _esc_eq(ps.esc, js.esc)
    np.testing.assert_allclose(float(sk.mean_mu(ps)), float(jsk.mean_mu(js)),
                               rtol=0 if exact_mu else 1e-6)


def _widened(ps):
    return (ps.counts if ps.esc is None
            else qz.densify(ps.counts, ps.esc)).to(torch.int32)


ESC = [0, 8]


class TestBelowSaturationParity:
    """Every sketch op on narrow planes ≡ the reference's (bitwise), and ≡
    the port's int32 sketch widened, while counts stay below the cap."""

    @pytest.mark.parametrize("esc", ESC)
    @pytest.mark.parametrize("dt", NARROW)
    def test_insert_lookup_and_mu(self, dt, esc):
        cq, jq, cw = _cfgs(dt, esc)
        rng = np.random.default_rng(1)
        ps, js, pw = sk.init(cq, CPU), jsk.init(jq), sk.init(cw, CPU)
        for B in (11, 30):
            b = _ids(rng, B, cq)
            ps = sk.insert_buckets(ps, _t(b), cq)
            js = jsk.insert_buckets(js, jnp.asarray(b), jq)
            pw = sk.insert_buckets(pw, _t(b), cw)
        _assert_sketch(ps, js)
        assert torch.equal(_widened(ps), pw.counts)
        probe = _ids(rng, 7, cq)
        _eq(sk.lookup(ps, _t(probe)), jsk.lookup(js, jnp.asarray(probe)))
        assert torch.equal(sk.lookup(ps, _t(probe)),
                           sk.lookup(pw, _t(probe)))
        mask = np.array([1, 0, 1, 1], np.float32)
        _eq(sk.lookup(ps, _t(probe), _t(mask)),
            jsk.lookup(js, jnp.asarray(probe), jnp.asarray(mask)))
        np.testing.assert_allclose(
            float(sk.mean_mu(ps, _t(mask))),
            float(jsk.mean_mu(js, jnp.asarray(mask))), rtol=1e-6)

    @pytest.mark.parametrize("esc", ESC)
    @pytest.mark.parametrize("dt", NARROW)
    def test_masked_insert_and_delete(self, dt, esc):
        cq, jq, cw = _cfgs(dt, esc)
        rng = np.random.default_rng(2)
        b = _ids(rng, 24, cq)
        mask = rng.integers(0, 2, 24) > 0
        ps = sk.insert_buckets_masked(sk.init(cq, CPU), _t(b), _t(mask), cq)
        js = jsk.insert_buckets_masked(jsk.init(jq), jnp.asarray(b),
                                       jnp.asarray(mask), jq)
        pw = sk.insert_buckets_masked(sk.init(cw, CPU), _t(b), _t(mask), cw)
        _assert_sketch(ps, js)
        assert torch.equal(_widened(ps), pw.counts)
        keep = b[mask][:5]
        ps = sk.delete_buckets(ps, _t(keep), cq)
        js = jsk.delete_buckets(js, jnp.asarray(keep), jq)
        _assert_sketch(ps, js)

    @pytest.mark.parametrize("esc", ESC)
    @pytest.mark.parametrize("dt", NARROW)
    def test_merge(self, dt, esc):
        cq, jq, _ = _cfgs(dt, esc)
        rng = np.random.default_rng(3)
        b1, b2 = _ids(rng, 13, cq), _ids(rng, 16, cq)
        ps = sk.merge(sk.insert_buckets(sk.init(cq, CPU), _t(b1), cq),
                      sk.insert_buckets(sk.init(cq, CPU), _t(b2), cq))
        js = jsk.merge(jsk.insert_buckets(jsk.init(jq), jnp.asarray(b1), jq),
                       jsk.insert_buckets(jsk.init(jq), jnp.asarray(b2), jq))
        _assert_sketch(ps, js)

    def test_merge_requires_matching_quantization(self):
        cq, _, _ = _cfgs("int8", 4)
        co = sk.AceConfig(dim=6, num_bits=5, num_tables=4,
                          counter_dtype="float32")
        with pytest.raises(ValueError, match="merge"):
            sk.merge(sk.init(cq, CPU), sk.init(co, CPU))
        c16, _, _ = _cfgs("int16", 4)
        with pytest.raises(ValueError, match="matching"):
            sk.merge(sk.init(cq, CPU), sk.init(c16, CPU))

    @pytest.mark.parametrize("dt", NARROW)
    def test_mixed_tenant_ingest(self, dt):
        """Fleet tables take narrow dtypes without promotion: the mixed
        ingest ≡ the reference's and ≡ the int32 fleet widened."""
        cq, jq, cw = _cfgs(dt, 0, K=4, L=3)
        fq = fl.init(fl.FleetConfig(ace=cq, num_tenants=3), CPU)
        fw_ = fl.init(fl.FleetConfig(ace=cw, num_tenants=3), CPU)
        jf = jfl.init(jfl.FleetConfig(ace=jq, num_tenants=3))
        rng = np.random.default_rng(4)
        for _ in range(3):
            b = _ids(rng, 20, cq)
            tids = rng.integers(0, 3, 20).astype(np.int32)
            m = rng.integers(0, 2, 20) > 0
            fq = fl.insert_masked(fq, _t(tids), _t(b), _t(m), cq)
            fw_ = fl.insert_masked(fw_, _t(tids), _t(b), _t(m), cw)
            jf = jfl.insert_masked(jf, jnp.asarray(tids), jnp.asarray(b),
                                   jnp.asarray(m), jq)
        _eq(fq.counts, jf.counts)
        assert torch.equal(fq.counts.to(torch.int32), fw_.counts)
        for k in ("n", "welford_mean", "welford_m2"):
            np.testing.assert_allclose(getattr(fq, k).numpy(),
                                       np.asarray(getattr(jf, k)), rtol=1e-6)

    @pytest.mark.parametrize("dt", NARROW)
    def test_window_rotate(self, dt):
        """Narrow rings: insert/rotate cycles ≡ the reference's ring (the
        tail fold reads the ring as float), ≡ the int32 ring widened."""
        cq, jq, cw = _cfgs(dt, 0, K=4, L=3)
        rq, rw, jr = ring.init(cq, 3, CPU), ring.init(cw, 3, CPU), \
            jring.init(jq, 3)
        rng = np.random.default_rng(5)
        for step in range(7):
            b = _ids(rng, 12, cq)
            m = rng.integers(0, 2, 12) > 0
            rq = ring.insert_current(rq, _t(b), _t(m), cq)
            rw = ring.insert_current(rw, _t(b), _t(m), cw)
            jr = jring.insert_current(jr, jnp.asarray(b), jnp.asarray(m), jq)
            if step % 2:
                rq, rw = ring.rotate(rq, 0.5), ring.rotate(rw, 0.5)
                jr = jring.rotate(jr, gamma=0.5)
        _eq(rq.counts, jr.counts)
        assert torch.equal(rq.counts.to(torch.int32), rw.counts)
        assert torch.equal(rq.tail, rw.tail) and torch.equal(rq.ssq, rw.ssq)
        np.testing.assert_allclose(rq.tail.numpy(), np.asarray(jr.tail),
                                   rtol=1e-6)
        assert int(rq.cursor) == int(jr.cursor)


# ---------------------------------------------------------------------------
# Past saturation: promotion keeps every count exact; no promotion wraps.
# ---------------------------------------------------------------------------

def _same(B, cfg, bucket=0):
    return np.full((B, cfg.num_tables), bucket, np.int32)


class TestOverflowPromotion:
    def test_promotion_fires_at_exactly_dtype_max(self):
        cq, jq, _ = _cfgs("int8", 4, K=2, L=1)
        ps, js = sk.init(cq, CPU), jsk.init(jq)
        for B in (16,) * 7 + (15, 1):         # 127 = 7·16 + 15, then one
            ps = sk.insert_buckets(ps, _t(_same(B, cq)), cq)
            js = jsk.insert_buckets(js, jnp.asarray(_same(B, cq)), jq)
            _assert_sketch(ps, js)
            if int(ps.n) == 127:
                assert int((ps.esc.offs != qz.SENTINEL).sum()) == 0
        assert int(ps.counts[0, 0]) == 127
        assert int(qz.densify(ps.counts, ps.esc)[0, 0]) == 128

    @pytest.mark.parametrize("dt", NARROW)
    def test_estimates_exact_past_saturation(self, dt):
        cq, jq, _ = _cfgs(dt, 4, K=2, L=1)
        cap = _cap(dt)
        plane = np.zeros((1, 4), dt)
        plane[0, 0] = cap
        ps = sk.init(cq, CPU)._replace(counts=_t(plane))
        js = jsk.init(jq)._replace(counts=jnp.asarray(plane))
        for B in (16, 16, 9):
            ps = sk.insert_buckets(ps, _t(_same(B, cq)), cq)
            js = jsk.insert_buckets(js, jnp.asarray(_same(B, cq)), jq)
        _assert_sketch(ps, js, exact_mu=dt == "int8")
        assert float(sk.lookup(ps, _t(_same(1, cq)))[0]) == cap + 41
        assert float(ps.esc.lost) == 0.0

    def test_delete_unpromotes(self):
        cq, jq, _ = _cfgs("int8", 4, K=2, L=1)
        plane = np.zeros((1, 4), np.int8)
        plane[0, 0] = 127
        ps = sk.init(cq, CPU)._replace(counts=_t(plane))
        js = jsk.init(jq)._replace(counts=jnp.asarray(plane))
        ps = sk.insert_buckets(ps, _t(_same(10, cq)), cq)
        js = jsk.insert_buckets(js, jnp.asarray(_same(10, cq)), jq)
        assert int((ps.esc.offs != qz.SENTINEL).sum()) == 1
        ps = sk.delete_buckets(ps, _t(_same(15, cq)), cq)
        js = jsk.delete_buckets(js, jnp.asarray(_same(15, cq)), jq)
        _assert_sketch(ps, js)
        assert int((ps.esc.offs != qz.SENTINEL).sum()) == 0
        assert int(ps.counts[0, 0]) == 122

    def test_esc_overflow_counts_lost_mass(self):
        cq, jq, _ = _cfgs("int8", 1, K=2, L=2)
        plane = np.zeros((2, 4), np.int8)
        plane[:, 0] = 127
        ps = sk.init(cq, CPU)._replace(counts=_t(plane))
        js = jsk.init(jq)._replace(counts=jnp.asarray(plane))
        ps = sk.insert_buckets(ps, _t(_same(5, cq)), cq)
        js = jsk.insert_buckets(js, jnp.asarray(_same(5, cq)), jq)
        _assert_sketch(ps, js)
        assert float(ps.esc.lost) == 5.0
        # and the merge adds both sides' losses to its own
        pm = sk.merge(ps, ps)
        jm = jsk.merge(js, js)
        _assert_sketch(pm, jm)
        assert float(pm.esc.lost) == float(jm.esc.lost)

    @pytest.mark.parametrize("dt", NARROW)
    def test_no_promotion_wraps_like_the_reference(self, dt):
        """Without promotion a narrow plane wraps past its max, add for
        add as the reference's scatter does (int8 127 + 1 → −128)."""
        cq, jq, _ = _cfgs(dt, 0, K=2, L=2)
        plane = np.zeros((2, 4), dt)
        plane[:, 0] = _cap(dt)
        ps = sk.init(cq, CPU)._replace(counts=_t(plane))
        js = jsk.init(jq)._replace(counts=jnp.asarray(plane))
        ps = sk.insert_buckets(ps, _t(_same(1, cq)), cq)
        js = jsk.insert_buckets(js, jnp.asarray(_same(1, cq)), jq)
        assert int(ps.counts[0, 0]) == int(np.iinfo(dt).min)
        _assert_sketch(ps, js)


class TestConvertRoundTrip:
    """The narrow dtype and the escalation table come across whole, in
    both directions, promoted slots included."""

    @pytest.mark.parametrize("dt", NARROW)
    def test_promoted_state_round_trips(self, dt):
        cq, jq, _ = _cfgs(dt, 4, K=3, L=2)
        rng = np.random.default_rng(6)
        js = jsk.insert_buckets(jsk.init(jq), jnp.asarray(_ids(rng, 20, cq)),
                                jq)
        js = js._replace(counts=js.counts.at[0, 0].set(_cap(dt)))
        js = jsk.insert_buckets(js, jnp.asarray(_same(3, cq)), jq)
        assert int(jnp.sum(js.esc.offs != jqz.SENTINEL)) >= 1
        ps = state_from_numpy(js.counts, js.n, js.welford_mean,
                              js.welford_m2, CPU, esc=js.esc)
        ps2 = tree_from_numpy(sk.AceState, js, CPU)
        for p in (ps, ps2):
            got = state_to_numpy(p)
            assert got["counts"].dtype == np.dtype(dt)
            np.testing.assert_array_equal(got["counts"], np.asarray(js.counts))
            for k in ("offs", "vals", "lost"):
                np.testing.assert_array_equal(got[f"esc.{k}"],
                                              np.asarray(getattr(js.esc, k)))
            probe = _same(1, cq)
            assert float(sk.lookup(p, _t(probe))[0]) == float(
                jsk.lookup(js, jnp.asarray(probe))[0])
        back = jqz.EscTable(*(jnp.asarray(got[f"esc.{k}"])
                              for k in ("offs", "vals", "lost")))
        assert float(jsk.lookup(js._replace(esc=back),
                                jnp.asarray(_same(1, cq)))[0]) == float(
            sk.lookup(ps, _t(_same(1, cq)))[0])

    def test_unquantized_state_has_no_esc_leaves(self):
        got = state_to_numpy(sk.init(sk.AceConfig(dim=6, num_bits=3,
                                                  num_tables=2), CPU))
        assert not any(k.startswith("esc") for k in got)


class TestConfigGuards:
    def test_esc_requires_narrow_dtype(self):
        for dt in ("int32", "float32"):
            with pytest.raises(ValueError, match="narrow"):
                sk.AceConfig(dim=6, num_bits=3, counter_dtype=dt,
                             esc_capacity=4)
        with pytest.raises(ValueError, match="counter_dtype"):
            sk.AceConfig(dim=6, counter_dtype="int64")

    def test_negative_capacity_rejected(self):
        with pytest.raises(ValueError, match="esc_capacity"):
            sk.AceConfig(dim=6, num_bits=3, counter_dtype="int8",
                         esc_capacity=-1)

    def test_window_and_fleet_reject_promotion(self):
        cfg = sk.AceConfig(dim=6, num_bits=3, num_tables=2,
                           counter_dtype="int8", esc_capacity=2)
        with pytest.raises(NotImplementedError, match="flat"):
            ring.WindowConfig(ace=cfg)
        with pytest.raises(NotImplementedError, match="flat"):
            ring.init(cfg, 2, CPU)
        with pytest.raises(NotImplementedError, match="flat"):
            fl.FleetConfig(ace=cfg, num_tenants=2)
        for kw in (dict(window_epochs=2, rotate_every=1),
                   dict(num_tenants=2),
                   dict(window_epochs=2, rotate_every=1, num_tenants=2)):
            with pytest.raises(NotImplementedError, match="flat"):
                engine.Guardrail(engine.GuardrailConfig(
                    d_model=4, count_dtype="int16", esc_capacity=4, **kw),
                    device="cpu")

    @pytest.mark.parametrize("dt,esc", [("int32", 0), ("float32", 0),
                                        ("int16", 0), ("int16", 64),
                                        ("int8", 0), ("int8", 3)])
    def test_memory_bytes_match_reference(self, dt, esc):
        kw = dict(dim=6, num_bits=8, num_tables=4, counter_dtype=dt,
                  esc_capacity=esc)
        p, j = sk.AceConfig(**kw), jsk.AceConfig(**kw)
        assert p.memory_bytes() == j.memory_bytes()
        assert p.quantized == j.quantized and p.count_dtype == dt
        if esc == 0:
            assert ring.WindowConfig(ace=p, num_epochs=3).memory_bytes() \
                == jring.WindowConfig(ace=j, num_epochs=3).memory_bytes()
            assert fl.FleetConfig(ace=p, num_tenants=5).memory_bytes() \
                == jfl.FleetConfig(ace=j, num_tenants=5).memory_bytes()

    def test_paper_sketch_is_under_4_mb_in_int16(self):
        cfg = sk.AceConfig(dim=36, counter_dtype="int16")
        assert cfg.memory_bytes() == 3_276_800 < 4 * 2**20
