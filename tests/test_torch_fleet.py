"""The port's fleets (``repro_torch.fleet``: the stacked state and its
routed ops, the windowed fleet with per-tenant clocks, the
``FleetDataFilter``, the fleet ``StreamRunner`` and the fleet and
windowed-fleet ``Guardrail``, ``ops.ace_fleet_score``) against the
reference's (``repro.fleet`` and its drivers) on the same numpy-made
inputs and the same JAX-drawn W, on the CPU, where every kernel wrapper
takes its plain version — and against the port's own single-tenant code
(fleet of one, mixed batch ≡ per-tenant sequential, tenant isolation).

Tolerances:
* counts, n, cursors, ticks, keep and admit masks, per-tenant item and
  kept counts: exact;
* at γ = 1 the tails, ssq and scores are integer-valued float32 below
  2^24 and exact; at γ < 1 rtol 1e-6 (the port sums the decay in
  ring-index order, the reference with XLA's ``einsum``);
* Welford streams, thresholds and falpha: rtol 1e-6 (1e-5 for falpha),
  thresholds and margins with an absolute 1e-6·n — batch sums run in
  PyTorch's order here and XLA's there;
* inside the port (fleet of one ≡ single tenant, mixed batch ≡ per-tenant
  sequential, kernel path ≡ plain path, chunk ≡ sequential steps):
  bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro.core import sketch as jsk  # noqa: E402
from repro.fleet import FleetDataFilter as JFilter  # noqa: E402
from repro.fleet import state as jfl  # noqa: E402
from repro.fleet import window as jfw  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.stream.runner import StreamRunner as JRunner  # noqa: E402
from repro.window import ring as jring  # noqa: E402
from repro_torch.core import sketch as sk  # noqa: E402
from repro_torch.core.convert import (params_from_numpy,  # noqa: E402
                                      tree_from_numpy, state_to_numpy)
from repro_torch.data.pipeline import AceDataFilter  # noqa: E402
from repro_torch.fleet import state as fl  # noqa: E402
from repro_torch.fleet import window as fw  # noqa: E402
from repro_torch.fleet.filter import FleetDataFilter  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.stream import runner as runner_mod  # noqa: E402
from repro_torch.stream.runner import (FleetChunkSummary,  # noqa: E402
                                       StreamRunner)
from repro_torch.window import ring  # noqa: E402
from test_torch_window import assert_window  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

CPU = torch.device("cpu")
KW = dict(dim=16, num_bits=7, num_tables=6, seed=3, welford_min_n=4.0)
CFG, JCFG = sk.AceConfig(**KW), jsk.AceConfig(**KW)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ids(rng, n):
    return rng.integers(0, 1 << 7, size=(n, 6)).astype(np.int32)


def _assert_leaves(got, want, exact=("counts", "n")):
    for k, v in state_to_numpy(got).items():
        w = np.asarray(getattr(want, k))
        assert v.dtype == w.dtype and v.shape == w.shape, k
        if k in exact:
            np.testing.assert_array_equal(v, w, err_msg=k)
        else:
            np.testing.assert_allclose(v, w, rtol=1e-6, atol=0, err_msg=k)


def _filled(rng, T, steps=3, B=13):
    """A port fleet filled by mixed batches, and the same batches through
    T single-tenant sketches with per-tenant sub-masks."""
    fs = fl.init(fl.FleetConfig(ace=CFG, num_tenants=T), CPU)
    singles = [sk.init(CFG, CPU) for _ in range(T)]
    for _ in range(steps):
        b = _t(_ids(rng, B))
        tids = _t(rng.integers(0, T, size=B).astype(np.int32))
        mask = _t(rng.random(B) < 0.8)
        fs = fl.insert_masked(fs, tids, b, mask, CFG)
        for t in range(T):
            singles[t] = sk.insert_buckets_masked(singles[t], b,
                                                  mask & (tids == t), CFG)
    return fs, singles


class TestFleetState:
    def test_mixed_batch_equals_per_tenant_sequential(self):
        """One mixed-batch insert ≡ per-tenant ``insert_buckets_masked``:
        counts, n, μ and the Welford stream bitwise."""
        rng = np.random.default_rng(2)
        fs, singles = _filled(rng, 5)
        mus = fl.mean_mu_fleet(fs)
        th = fl.admit_thresholds(fs, 2.0, 8.0)
        for t in range(5):
            tv = fl.tenant_view(fs, t)
            for a, b in zip(tv[:4], singles[t][:4]):
                assert torch.equal(a, b), t
            assert torch.equal(mus[t], sk.mean_mu(singles[t]))
            assert torch.equal(th[t], sk.admit_threshold(singles[t], 2.0,
                                                         8.0))

    def test_scores_route_each_item_to_its_tenant(self):
        rng = np.random.default_rng(4)
        fs, singles = _filled(rng, 5)
        b = _t(_ids(rng, 19))
        tids = _t(rng.integers(0, 5, size=19).astype(np.int32))
        got = fl.fleet_scores(fs, tids, b)
        for i in range(19):
            assert torch.equal(got[i], sk.lookup(singles[int(tids[i])],
                                                 b[i:i + 1])[0]), i

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_insert_leaves_other_tenants_bitwise_unchanged(self, seed):
        rng = np.random.default_rng(seed)
        fs, _ = _filled(rng, 4, steps=2)
        a = int(rng.integers(0, 4))
        n = int(rng.integers(1, 30))
        fs2 = fl.insert_masked(fs, torch.full((n,), a, dtype=torch.int32),
                               _t(_ids(rng, n)), _t(rng.random(n) < 0.9),
                               CFG)
        for t in range(4):
            if t != a:
                for x, y in zip(fl.tenant_view(fs, t)[:4],
                                fl.tenant_view(fs2, t)[:4]):
                    assert torch.equal(x, y), t

    @pytest.mark.parametrize("masked", [False, True])
    def test_ops_match_reference(self, masked):
        """insert_masked, fleet_scores, μ, σ, thresholds and per-tenant
        counts against the reference on the same inputs."""
        rng = np.random.default_rng(6)
        T = 4
        js = jfl.init(jfl.FleetConfig(ace=JCFG, num_tenants=T))
        ps = fl.init(fl.FleetConfig(ace=CFG, num_tenants=T), CPU)
        for _ in range(4):
            b = _ids(rng, 17)
            tids = rng.integers(0, T, size=17).astype(np.int32)
            m = rng.random(17) < 0.8
            js = jfl.insert_masked(js, jnp.asarray(tids), jnp.asarray(b),
                                   jnp.asarray(m), JCFG)
            ps = fl.insert_masked(ps, _t(tids), _t(b), _t(m), CFG)
        _assert_leaves(ps, js)
        tm = np.ones((T, 6), np.float32)
        if masked:
            tm[1, 2] = tm[3, 0] = 0.0
        jm, pm = (jnp.asarray(tm), _t(tm)) if masked else (None, None)
        b = _ids(rng, 23)
        tids = rng.integers(0, T, size=23).astype(np.int32)
        np.testing.assert_array_equal(
            fl.fleet_scores(ps, _t(tids), _t(b), pm).numpy(),
            np.asarray(jfl.fleet_scores(js, jnp.asarray(tids),
                                        jnp.asarray(b), jm)))
        for got, want in (
                (fl.mean_mu_fleet(ps, pm), jfl.mean_mu_fleet(js, jm)),
                (fl.sigma_welford_fleet(ps), jfl.sigma_welford_fleet(js)),
                (fl.admit_thresholds(ps, 1.5, 10.0, pm),
                 jfl.admit_thresholds(js, 1.5, 10.0, jm)),
                (fl.per_tenant_counts(_t(tids), _t(b[:, 0]), T),
                 jfl.per_tenant_counts(jnp.asarray(tids),
                                       jnp.asarray(b[:, 0]), T))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6 * 60)

    def test_merge_set_and_stack(self):
        rng = np.random.default_rng(8)
        a, sa = _filled(rng, 3)
        b, sb = _filled(rng, 3)
        m = fl.merge_fleet(a, b)
        for t in range(3):
            for x, y in zip(fl.tenant_view(m, t)[:4],
                            sk.merge(sa[t], sb[t])[:4]):
                assert torch.equal(x, y)
        stacked = fl.from_states(sa)
        for x, y in zip(stacked[:4], a[:4]):
            assert torch.equal(x, y)
        c = fl.set_tenant(a, 1, sk.init(CFG, CPU))
        assert float(c.n[1]) == 0 and torch.equal(c.counts[0], a.counts[0])
        assert float(a.n[1]) > 0, "set_tenant copies"

    def test_flat_offset_overflow_raises(self):
        paper = sk.AceConfig(dim=30, num_bits=15, num_tables=50)
        fl.FleetConfig(ace=paper, num_tenants=1310)
        with pytest.raises(ValueError, match="int32 offset"):
            fl.FleetConfig(ace=paper, num_tenants=2048)
        with pytest.raises(ValueError, match="int32 offset"):
            fw.init_fleet_window(ring.WindowConfig(
                ace=paper, num_epochs=4, rotate_every=2), 512, "meta")

    def test_tenant_ids_checked_on_the_host(self):
        assert fl.check_tenant_ids([0, 2, 1], 3, (3,)).dtype == np.int32
        with pytest.raises(ValueError, match=r"\[0, 3\)"):
            fl.check_tenant_ids([0, 3], 3, (2,))
        with pytest.raises(ValueError, match=r"\[0, 3\)"):
            fl.check_tenant_ids([-1, 0], 3, (2,))
        with pytest.raises(ValueError, match="shape"):
            fl.check_tenant_ids([0, 1, 2], 3, (2,))
        with pytest.raises(TypeError, match="integers"):
            fl.check_tenant_ids([0.0, 1.5], 3, (2,))


# ---------------------------------------------------------------------------
# The windowed fleet.
# ---------------------------------------------------------------------------

def _wcfg(gamma, ace=CFG):
    return ring.WindowConfig(ace=ace, num_epochs=3, decay=gamma,
                             rotate_every=2)


class TestWindowedFleet:
    @pytest.mark.parametrize("gamma", [1.0, 0.8])
    def test_fleet_of_one_is_the_ring_bitwise(self, gamma):
        rng = np.random.default_rng(1)
        fs = fw.init_fleet_window(_wcfg(gamma), 1, CPU)
        one = ring.init_window(_wcfg(gamma), CPU)
        tids = torch.zeros(15, dtype=torch.int32)
        for _ in range(7):
            b, m = _t(_ids(rng, 15)), _t(rng.random(15) < 0.8)
            fs = fw.maybe_rotate_fleet(fw.insert_current_fleet(
                fs, tids, b, m, CFG, gamma=gamma), 2, gamma,
                tenant_ids=tids)
            one = ring.maybe_rotate(ring.insert_current(
                one, b, m, CFG, gamma=gamma), 2, gamma)
        for a, b_ in zip(fw.tenant_window_view(fs, 0), one):
            if b_ is not None:
                assert torch.equal(a, b_)

    @pytest.mark.parametrize("gamma", [1.0, 0.7])
    def test_mixed_batch_equals_per_tenant_sequential(self, gamma):
        """Mixed-batch inserts with per-tenant clocks ≡ per-tenant
        sequential ring ops (absent tenants do not tick): every leaf
        bitwise."""
        rng = np.random.default_rng(5)
        T = 4
        fs = fw.init_fleet_window(_wcfg(gamma), T, CPU)
        singles = [ring.init_window(_wcfg(gamma), CPU) for _ in range(T)]
        for _ in range(9):
            b = _t(_ids(rng, 17))
            tids = _t(rng.integers(0, T, size=17).astype(np.int32))
            m = _t(rng.random(17) < 0.8)
            fs = fw.maybe_rotate_fleet(fw.insert_current_fleet(
                fs, tids, b, m, CFG, gamma=gamma), 2, gamma,
                tenant_ids=tids)
            for t in range(T):
                if bool((tids == t).any()):
                    singles[t] = ring.maybe_rotate(ring.insert_current(
                        singles[t], b, m & (tids == t), CFG, gamma=gamma),
                        2, gamma)
        th = fw.window_admit_thresholds(fs, gamma, 2.0, 8.0)
        for t in range(T):
            for a, b_ in zip(fw.tenant_window_view(fs, t), singles[t]):
                if b_ is not None:
                    assert torch.equal(a, b_), t
            assert torch.equal(th[t], ring.admit_threshold_windowed(
                singles[t], gamma, 2.0, 8.0))

    @pytest.mark.parametrize("gamma", [1.0, 0.7])
    def test_sequence_matches_reference(self, gamma):
        """Inserts, routed scores and presence-gated rotations against
        ``repro.fleet.window``; then the thresholds, with and without a
        table mask."""
        rng = np.random.default_rng(7)
        T = 3
        js = jfw.init_fleet_window(jring.WindowConfig(
            ace=JCFG, num_epochs=3, decay=gamma, rotate_every=2), T)
        ps = fw.init_fleet_window(_wcfg(gamma), T, CPU)
        for _ in range(8):
            b = _ids(rng, 12)
            tids = rng.integers(0, T - 1, size=12).astype(np.int32)
            m = rng.random(12) < 0.8
            jb, jt, jm = jnp.asarray(b), jnp.asarray(tids), jnp.asarray(m)
            np.testing.assert_allclose(
                fw.window_fleet_scores(ps, _t(tids), _t(b)).numpy(),
                np.asarray(jfw.window_fleet_scores(js, jt, jb)),
                rtol=1e-6, atol=0)
            js = jfw.maybe_rotate_fleet(jfw.insert_current_fleet(
                js, jt, jb, jm, JCFG, gamma=gamma), 2, gamma, tenant_ids=jt)
            ps = fw.maybe_rotate_fleet(fw.insert_current_fleet(
                ps, _t(tids), _t(b), _t(m), CFG, gamma=gamma), 2, gamma,
                tenant_ids=_t(tids))
        assert_window(ps, js, gamma)
        assert int(ps.tick[T - 1]) == 0, "the absent tenant never ticked"
        tm = np.ones((T, 6), np.float32)
        tm[0, 1] = 0.0
        for mask in (None, tm):
            got = fw.window_admit_thresholds(
                ps, gamma, 2.0, 8.0, None if mask is None else _t(mask))
            want = jfw.window_admit_thresholds(
                js, gamma, 2.0, 8.0, None if mask is None
                else jnp.asarray(mask))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6 * 100)

    def test_tenant_isolation_and_clocks(self):
        """Tenant a's traffic and the rotations its clock fires leave
        tenant b bitwise untouched."""
        rng = np.random.default_rng(3)
        fs = fw.init_fleet_window(_wcfg(0.9), 3, CPU)
        snap = [x.clone() for x in fs if x is not None]
        tids = torch.full((9,), 1, dtype=torch.int32)
        for _ in range(5):
            fs = fw.maybe_rotate_fleet(fw.insert_current_fleet(
                fs, tids, _t(_ids(rng, 9)), torch.ones(9, dtype=torch.bool),
                CFG, gamma=0.9), 2, 0.9, tenant_ids=tids)
        assert int(fs.tick[1]) == 5 and int(fs.cursor[1]) == 2
        for x, y in zip(snap, [x for x in fs if x is not None]):
            for t in (0, 2):
                assert torch.equal(x[t], y[t])

    def test_view_set_and_memory(self):
        """``set_tenant_window`` copies a ring into one tenant's slot and
        leaves the source fleet alone; the device bills match the
        reference's configs."""
        rng = np.random.default_rng(4)
        fs = fw.init_fleet_window(_wcfg(1.0), 3, CPU)
        one = ring.init_window(_wcfg(1.0), CPU)
        one = ring.insert_current(one, _t(_ids(rng, 9)),
                                  torch.ones(9, dtype=torch.bool), CFG)
        fs2 = fw.set_tenant_window(fs, 1, one)
        for a, b in zip(fw.tenant_window_view(fs2, 1), one):
            if b is not None:
                assert torch.equal(a, b)
        assert float(fs.n.sum()) == 0.0 and float(fs2.n[1].sum()) == 9.0
        assert fl.FleetConfig(ace=CFG, num_tenants=5).memory_bytes() == \
            jfl.FleetConfig(ace=JCFG, num_tenants=5).memory_bytes()

    def test_idle_tenant_parked_on_boundary_never_rerotates(self):
        fs = fw.init_fleet_window(_wcfg(1.0), 2, CPU)
        rng = np.random.default_rng(11)
        ones = torch.ones(9, dtype=torch.bool)
        for t, steps in ((0, 2), (1, 3)):
            tids = torch.full((9,), t, dtype=torch.int32)
            for _ in range(steps):
                fs = fw.maybe_rotate_fleet(fw.insert_current_fleet(
                    fs, tids, _t(_ids(rng, 9)), ones, CFG), 2,
                    tenant_ids=tids)
            if t == 0:
                snap0 = [x.clone() for x in fw.tenant_window_view(fs, 0)
                         if x is not None]
        assert int(fs.tick[0]) == 2 and int(fs.cursor[0]) == 1
        for x, y in zip(snap0, [x for x in fw.tenant_window_view(fs, 0)
                                if x is not None]):
            assert torch.equal(x, y)
        assert float(fs.n[0].sum()) > 0, "history intact"


# ---------------------------------------------------------------------------
# The filter and the runner.
# ---------------------------------------------------------------------------

D, B, T, NT = 24, 16, 4, 3


def _features(n, seed=1, burst_from=None):
    rng = np.random.default_rng(seed)
    topics = np.random.default_rng(0).normal(size=(3, D + 1))
    out = []
    for i in range(n):
        f = topics[rng.integers(0, 3, B)] + 0.2 * rng.normal(size=(B, D + 1))
        if burst_from is not None and i >= burst_from:
            f[: B // 4] = 3.0 * rng.normal(size=(B // 4, D + 1))
        f[i % B, i % (D + 1)] = np.nan
        out.append(f.astype(np.float32))
    return out


def _tids(n, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, NT, B).astype(np.int32) for _ in range(n)]


def _pair(use_kernels=True, **kw):
    kw = {**dict(d_model=D, num_tenants=NT, num_bits=6, num_tables=8,
                 alpha=1.0, warmup_items=20.0), **kw}
    jf = JFilter(**kw)
    pf = FleetDataFilter(**kw, use_kernels=use_kernels, device="cpu")
    js, jw = jf.init()
    ps, _ = pf.init()
    return jf, pf, (js, jw), (ps, params_from_numpy(np.asarray(jw), CPU))


def _assert_margins(got, want, n):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[~np.isfinite(got)],
                                  want[~np.isfinite(want)])
    fin = np.isfinite(got)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6,
                               atol=1e-6 * max(float(n), 1.0))


class TestFleetFilter:
    @pytest.mark.parametrize("use_kernels", [True, False])
    @pytest.mark.parametrize("variant", ["filter", "insert_all", "owned",
                                         "masked"])
    def test_step_matches_reference(self, variant, use_kernels):
        jf, pf, (js, jw), (ps, pw) = _pair(
            use_kernels, insert_all=variant == "insert_all")
        own = np.array([1.0, 0.0, 1.0], np.float32)
        tm = np.ones((NT, 8), np.float32)
        tm[2, [1, 5]] = 0.0
        kj = dict(tenant_mask=jnp.asarray(own)) if variant == "owned" else \
            dict(table_mask=jnp.asarray(tm)) if variant == "masked" else {}
        kp = {k: _t(np.asarray(v)) for k, v in kj.items()}
        for f, t in zip(_features(8, burst_from=5), _tids(8)):
            js, jk, jm = jf.step(js, jw, jnp.asarray(f), jnp.asarray(t), **kj)
            ps, pk, pm = pf.step(ps, pw, _t(f), _t(t), **kp)
            np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
            _assert_margins(pm.numpy(), jm, jnp.max(js.n))
        _assert_leaves(ps, js)
        if variant == "owned":
            assert float(ps.n[1]) == 0.0, "the unowned tenant never inserts"

    @pytest.mark.parametrize("use_kernels", [True, False])
    def test_fleet_of_one_is_the_flat_filter_bitwise(self, use_kernels):
        kw = dict(d_model=D, num_bits=6, num_tables=8, alpha=1.0,
                  warmup_items=20.0, use_kernels=use_kernels, device="cpu")
        ff, f1 = FleetDataFilter(**kw, num_tenants=1), AceDataFilter(**kw)
        sf, w = ff.init()
        s1, w1 = f1.init()
        assert torch.equal(w, w1)
        tids = torch.zeros(B, dtype=torch.int32)
        for f in _features(6, burst_from=4):
            sf, kf, mf = ff.step(sf, w, _t(f), tids)
            s1, k1, m1 = f1.step(s1, w, _t(f))
            assert torch.equal(kf, k1) and torch.equal(mf, m1)
        for a, b in zip(sf, s1):
            if b is not None:
                assert torch.equal(a[0], b)

    def test_kernel_and_plain_paths_agree(self):
        _, fk, _, (sk_, w) = _pair(True)
        _, fp, _, (sp, _) = _pair(False)
        for f, t in zip(_features(6, burst_from=4), _tids(6)):
            sk_, kk, mk = fk.step(sk_, w, _t(f), _t(t))
            sp, kp, mp = fp.step(sp, w, _t(f), _t(t))
            assert torch.equal(kk, kp) and torch.equal(mk, mp)
        for a, b in zip(sk_, sp):
            if b is not None:
                assert torch.equal(a, b)


EXACT = ("kept_frac", "anom_counts", "topk_step", "topk_item", "n",
         "quarantined", "degraded", "topk_valid", "per_tenant_items",
         "per_tenant_kept", "misrouted")


class TestFleetStreamRunner:
    @pytest.mark.parametrize("use_kernels", [True, False])
    def test_run_matches_reference(self, use_kernels):
        jf, pf, (js, jw), (ps, pw) = _pair(use_kernels)
        feats, tids = _features(3 * T, burst_from=2 * T), _tids(3 * T)
        js, jsum = JRunner(jf, T).run(js, jw, feats, tenant_ids=tids)
        ps, psum = StreamRunner(pf, T).run(ps, pw, feats, tenant_ids=tids)
        _assert_leaves(ps, js)
        assert len(psum) == len(jsum) == 3
        for got, want in zip(psum, jsum):
            assert isinstance(got, FleetChunkSummary)
            for f in EXACT:
                np.testing.assert_array_equal(getattr(got, f),
                                              np.asarray(getattr(want, f)),
                                              err_msg=f)
                assert getattr(got, f).dtype == np.asarray(
                    getattr(want, f)).dtype, f
            _assert_margins(got.topk_margin, want.topk_margin,
                            np.max(want.n))
            np.testing.assert_allclose(got.falpha, np.asarray(want.falpha),
                                       rtol=1e-5)
            assert got.hh_coord is None and got.hh_tenant is None

    def test_chunk_equals_sequential_steps(self):
        _, pf, _, (s0, w) = _pair()
        feats, tids = _features(2 * T, burst_from=T), _tids(2 * T)
        runner = StreamRunner(pf, T, return_masks=True)
        sc, ck = s0, []
        for c in range(2):
            sc, summary, keeps = runner.consume(
                sc, w, _t(np.stack(feats[c * T:(c + 1) * T])),
                _t(np.stack(tids[c * T:(c + 1) * T])))
            ck.append(keeps)
        ss, sk_ = pf.init()[0], []
        for f, t in zip(feats, tids):
            ss, k, _ = pf.step(ss, w, _t(f), _t(t))
            sk_.append(k)
        for a, b in zip(sc, ss):
            if b is not None:
                assert torch.equal(a, b)
        assert torch.equal(torch.cat(ck), torch.stack(sk_))
        host = runner.fetch(summary)
        assert host.per_tenant_items.sum() == T * B
        np.testing.assert_array_equal(host.n, sc.n.numpy())

    def test_misrouted_items_counted(self):
        _, pf, _, (s, w) = _pair()
        runner = StreamRunner(pf, T)
        own = torch.tensor([1.0, 1.0, 0.0])
        tids = np.stack(_tids(T))
        s, summary = runner.consume(s, w, _t(np.stack(_features(T))),
                                    _t(tids), tenant_mask=own)
        host = runner.fetch(summary)
        assert int(host.misrouted) == int((tids == 2).sum())
        assert float(s.n[2]) == 0.0

    def test_one_transfer_each_way_per_chunk(self, monkeypatch):
        """Features and tenant ids travel in ONE host-to-device copy."""
        h2d, d2h = [], []
        real_in, real_out = runner_mod._to_device, runner_mod._to_host
        monkeypatch.setattr(runner_mod, "_to_device",
                            lambda x, d: h2d.append(x.shape)
                            or real_in(x, d))
        monkeypatch.setattr(runner_mod, "_to_host",
                            lambda x: d2h.append(tuple(x.shape))
                            or real_out(x))
        _, pf, _, (s, w) = _pair()
        s, sums = StreamRunner(pf, T).run(s, w, _features(3 * T + 2),
                                          tenant_ids=_tids(3 * T + 2))
        assert len(sums) == 3
        assert h2d == [(T * B * (D + 1) + T * B,)] * 3
        assert len(d2h) == 3 and len(set(d2h)) == 1

    def test_tenant_ids_contract_validated(self):
        """Missing, spurious, misshapen and out-of-range ids raise before
        anything reaches the device."""
        _, pf, _, (s, w) = _pair()
        runner = StreamRunner(pf, T)
        feats = torch.zeros((T, B, D + 1))
        with pytest.raises(ValueError, match="tenant_ids"):
            runner.consume(s, w, feats)
        with pytest.raises(ValueError, match="tenant_ids"):
            runner.run(s, w, _features(T))
        bad = _tids(T)
        bad[1][3] = NT
        with pytest.raises(ValueError, match=r"\[0, 3\)"):
            runner.run(s, w, _features(T), tenant_ids=bad)
        flat = AceDataFilter(d_model=D, num_bits=6, num_tables=8,
                             device="cpu")
        r2 = StreamRunner(flat, T)
        s2, w2 = flat.init()
        with pytest.raises(ValueError, match="not a fleet"):
            r2.consume(s2, w2, feats, torch.zeros((T, B), dtype=torch.int32))
        with pytest.raises(ValueError, match="not a fleet"):
            r2.run(s2, w2, _features(T), tenant_ids=_tids(T))

    def test_windowed_fleet_runner_rejected(self):
        """As in the reference: a fleet with a rotation clock is
        host-driven, not a runner's."""
        _, pf, _, _ = _pair()
        with pytest.raises(NotImplementedError, match="windowed fleets"):
            StreamRunner(pf, T, rotate_every=2)


# ---------------------------------------------------------------------------
# The fleet guardrails and the fleet query op.
# ---------------------------------------------------------------------------

def _batches(n, T=3, seed=11, b=16, s=3, d=12):
    """Mixed-tenant request embeddings, one NaN row each, a growing
    off-topic share from the middle on."""
    rng = np.random.default_rng(seed)
    topics = rng.normal(size=(3, d))
    for i in range(n):
        e = topics[rng.integers(0, 3, b)][:, None, :] \
            + 0.3 * rng.normal(size=(b, s, d))
        if i >= n // 2:
            k = 2 * (i - n // 2) + 2
            e[:k] = rng.normal(size=(k, s, d)) * 3.0
        e[i % b, i % s, 0] = np.nan
        yield e.astype(np.float32), rng.integers(0, T, b).astype(np.int32)


GCFG = dict(d_model=12, num_bits=6, num_tables=8, warmup_items=16.0,
            alpha=2.0, num_tenants=3)


def _guards(port_kernels, jax_kernels, **kw):
    gcfg = {**GCFG, **kw}
    gj = jengine.Guardrail(jengine.GuardrailConfig(**gcfg),
                           use_kernels=jax_kernels)
    gp = engine.Guardrail(engine.GuardrailConfig(**gcfg),
                          use_kernels=port_kernels, device="cpu",
                          w=params_from_numpy(np.asarray(gj.w), CPU))
    return gj, gp


class TestFleetGuardrail:
    @pytest.mark.parametrize("port_kernels,jax_kernels",
                             [(True, True), (False, False)])
    def test_fleet_admit_matches_reference(self, port_kernels, jax_kernels):
        gj, gp = _guards(port_kernels, jax_kernels)
        for e, t in _batches(8):
            np.testing.assert_array_equal(
                gp.admit(e, t), np.asarray(gj.admit(jnp.asarray(e),
                                                    jnp.asarray(t))))
        assert gp.quarantined == gj.quarantined == 8
        _assert_leaves(gp.state, gj.state)

    @pytest.mark.parametrize("gamma", [1.0, 0.8])
    @pytest.mark.parametrize("port_kernels,jax_kernels",
                             [(True, True), (False, False)])
    def test_windowed_fleet_admit_matches_reference(self, port_kernels,
                                                    jax_kernels, gamma):
        """Ten admits, per-tenant clocks rotating every 2 of a tenant's
        own admits; the reference's kernel path runs its fused Pallas
        kernel in interpret mode."""
        gj, gp = _guards(port_kernels, jax_kernels, window_epochs=3,
                         rotate_every=2, window_decay=gamma)
        for e, t in _batches(10):
            t = np.where(t == 2, 1, t).astype(np.int32)   # tenant 2 idle
            np.testing.assert_array_equal(
                gp.admit(e, t), np.asarray(gj.admit(jnp.asarray(e),
                                                    jnp.asarray(t))))
        assert_window(gp.state, gj.state, gamma)
        assert int(gp.state.tick[2]) == 0 and int(gp.state.cursor[2]) == 0

    def test_windowed_fleet_kernel_and_plain_paths_agree(self):
        gk = engine.Guardrail(engine.GuardrailConfig(
            **GCFG, window_epochs=3, rotate_every=2), device="cpu")
        gp = engine.Guardrail(engine.GuardrailConfig(
            **GCFG, window_epochs=3, rotate_every=2), device="cpu",
            use_kernels=False, w=gk.w)
        for e, t in _batches(8):
            np.testing.assert_array_equal(gk.admit(e, t), gp.admit(e, t))
        for a, b in zip(gk.state, gp.state):
            if b is not None:
                assert torch.equal(a, b)

    def test_per_tenant_fail_policy(self):
        gj, gp = _guards(True, False,
                         fail_policy=("fail_open", "fail_closed",
                                      "fail_open"))
        e, _ = next(_batches(1))
        e[:] = np.nan
        t = np.array([0, 1, 2] * 5 + [1], np.int32)
        got = gp.admit(e, t)
        np.testing.assert_array_equal(got, t != 1)
        np.testing.assert_array_equal(got, np.asarray(
            gj.admit(jnp.asarray(e), jnp.asarray(t))))
        with pytest.raises(ValueError, match="entries"):
            engine.Guardrail(engine.GuardrailConfig(
                **{**GCFG, "fail_policy": ("fail_open",) * 2}), device="cpu")

    def test_tenant_isolation_of_thresholds(self):
        gp = engine.Guardrail(engine.GuardrailConfig(**GCFG), device="cpu")
        rng = np.random.default_rng(8)
        gp.admit(rng.normal(size=(8, 3, 12)).astype(np.float32),
                 [0, 0, 1, 1, 2, 2, 0, 1])
        before = [x.clone() for x in fl.tenant_view(gp.state, 2)[:4]]
        for _ in range(4):
            gp.admit(rng.normal(size=(8, 3, 12)).astype(np.float32),
                     np.zeros(8, np.int32))
        for x, y in zip(before, fl.tenant_view(gp.state, 2)[:4]):
            assert torch.equal(x, y)

    @pytest.mark.parametrize("windowed", [False, True])
    def test_one_transfer_and_checked_ids(self, windowed, monkeypatch):
        calls = []
        real = engine._to_host
        monkeypatch.setattr(engine, "_to_host",
                            lambda x: calls.append(tuple(x.shape))
                            or real(x))
        kw = dict(window_epochs=3, rotate_every=2) if windowed else {}
        gp = engine.Guardrail(engine.GuardrailConfig(**GCFG, **kw),
                              device="cpu")
        for e, t in _batches(3):
            gp.admit(e, t)
        assert calls == [(2, 16)] * 3
        e, t = next(_batches(1))
        with pytest.raises(ValueError, match="needs tenant_ids"):
            gp.admit(e)
        with pytest.raises(ValueError, match=r"\[0, 3\)"):
            gp.admit(e, np.full(16, 3))
        with pytest.raises(ValueError, match="shape"):
            gp.admit(e, t[:4])
        flat = engine.Guardrail(engine.GuardrailConfig(d_model=12),
                                device="cpu")
        with pytest.raises(ValueError, match="num_tenants == 1"):
            flat.admit(e, t)


class TestFleetScoreOp:
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("mode", ["dense", "srht"])
    def test_matches_reference_op(self, mode, masked):
        """``ops.ace_fleet_score`` against the reference's (its dense
        Pallas kernel in interpret mode), on the reference's fleet
        carried across: bitwise where the hash ids agree."""
        kw = dict(dim=20, num_bits=7, num_tables=6, seed=4, hash_mode=mode)
        jcfg, cfg = jsk.AceConfig(**kw), sk.AceConfig(**kw)
        rng = np.random.default_rng(9)
        T = 4
        js = jfl.init(jfl.FleetConfig(ace=jcfg, num_tenants=T))
        for _ in range(3):
            js = jfl.insert_masked(
                js, jnp.asarray(rng.integers(0, T, 30), jnp.int32),
                jnp.asarray(_ids(rng, 30)), jnp.ones(30, bool), jcfg)
        ps = tree_from_numpy(fl.FleetState, js, CPU)
        jw = jsk.make_params(jcfg)
        w = params_from_numpy(np.asarray(jw), CPU)
        q = rng.normal(size=(25, 20)).astype(np.float32)
        tids = rng.integers(0, T, 25).astype(np.int32)
        tm = np.ones((T, 6), np.float32)
        tm[1, 3] = 0.0
        jm, pm = (jnp.asarray(tm), _t(tm)) if masked else (None, None)
        got = ops.ace_fleet_score(ps, _t(q), _t(tids), w, cfg,
                                  table_mask=pm).numpy()
        want = np.asarray(jops.ace_fleet_score(js, jnp.asarray(q),
                                               jnp.asarray(tids), jw, jcfg,
                                               table_mask=jm))
        ids = ops.hash_dispatch(_t(q), w, cfg.srp).numpy()
        jids = np.asarray(jops.hash_dispatch(jnp.asarray(q), jw, jcfg.srp))
        same = (ids == jids).all(axis=1)
        assert same.mean() >= 0.9
        np.testing.assert_array_equal(got[same], want[same])
