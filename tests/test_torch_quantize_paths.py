"""The narrow count dtypes through the port's kernels (their plain
versions on the CPU), ``ops``, the ``Guardrail``'s four flavours, the three
filters and the ``StreamRunner``, against the reference's, on the same
numpy-made inputs and the same JAX-drawn W (the reference's Pallas kernels
in interpret mode).  ``core.quantize`` itself and the sketch algebra are
in tests/test_torch_quantize.py; the tolerances are that file's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro.core import sketch as jsk  # noqa: E402
from repro.core.srp import SrpConfig as JSrpConfig  # noqa: E402
from repro.core.srp import make_projections as jax_projections  # noqa: E402
from repro.data.pipeline import AceDataFilter as JFilter  # noqa: E402
from repro.fleet import FleetDataFilter as JFleetFilter  # noqa: E402
from repro.fleet import state as jfl  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.stream.runner import StreamRunner as JRunner  # noqa: E402
from repro.window import ring as jring  # noqa: E402
from repro.window.filter import WindowedAceFilter as JWinFilter  # noqa: E402
from repro_torch.core import quantize as qz  # noqa: E402
from repro_torch.core import sketch as sk  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402
from repro_torch.core.srp import SrpConfig  # noqa: E402
from repro_torch.data.pipeline import AceDataFilter  # noqa: E402
from repro_torch.fleet import state as fl  # noqa: E402
from repro_torch.fleet.filter import FleetDataFilter  # noqa: E402
from repro_torch.kernels import ace_admit_fused as A  # noqa: E402
from repro_torch.kernels import ace_fleet_score as FS  # noqa: E402
from repro_torch.kernels import ace_fleet_window_admit as FWA  # noqa: E402
from repro_torch.kernels import ace_query as Q  # noqa: E402
from repro_torch.kernels import ace_score_fused as F  # noqa: E402
from repro_torch.kernels import ace_update as U  # noqa: E402
from repro_torch.kernels import ace_window_combine as WC  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.stream.runner import StreamRunner  # noqa: E402
from repro_torch.window import ring  # noqa: E402
from repro_torch.window.filter import WindowedAceFilter  # noqa: E402
from test_torch_quantize import (NARROW, _assert_sketch, _cap,  # noqa: E402
                                 _cfgs, _eq, _t, _widened)

jax.config.update("jax_platform_name", "cpu")

CPU = torch.device("cpu")
DTYPES = ("int8", "int16", "float32")


# ---------------------------------------------------------------------------
# The retyped kernels' plain versions against the Pallas kernels.
# ---------------------------------------------------------------------------

def _hash_inputs(B, d, K, L, seed=0):
    jcfg = JSrpConfig(dim=d, num_bits=K, num_tables=L, seed=seed + 1)
    cfg = SrpConfig(dim=d, num_bits=K, num_tables=L, seed=seed + 1)
    w = np.asarray(jax_projections(jcfg))
    x = np.random.default_rng(seed + 2).normal(size=(B, d)) \
        .astype(np.float32)
    return jcfg, cfg, w, x


def _counts(shape, dt, seed, hi=9):
    return np.random.default_rng(seed).integers(0, hi, size=shape).astype(dt)


class TestKernelDtypes:
    """Each retyped kernel's plain version in int8, int16 and float32
    against the reference's Pallas kernel (interpret mode), as the
    reference's own dtype rows (tests/test_kernels.py) hold it."""

    @pytest.mark.parametrize("dt", DTYPES)
    def test_ace_update_and_query(self, dt):
        from repro.kernels.ace_query import ace_query as jquery
        from repro.kernels.ace_update import ace_update as jupdate
        counts = _counts((8, 256), dt, 3)
        ids = np.random.default_rng(4).integers(0, 256, size=(50, 8)) \
            .astype(np.int32)
        ids[:20, 3] = 17                          # a hot bucket
        want = jupdate(jnp.asarray(counts), jnp.asarray(ids),
                       interpret=True, mode="scalar")
        c = _t(counts)
        got = U.ace_update(c, _t(ids))
        assert got is c and got.dtype == c.dtype
        _eq(got, want)
        g = jquery(want, jnp.asarray(ids), interpret=True)
        _eq(Q.ace_query(got, _t(ids)), g)
        mean = Q.ace_query_sum(got, _t(ids))
        np.testing.assert_allclose(mean.numpy(), np.asarray(jnp.mean(g, -1)),
                                   rtol=1e-6)
        _eq(mean, np.asarray(jnp.sum(g, -1)) * np.float32(1 / 8))
        mask = np.ones(8, np.float32)
        mask[[1, 6]] = 0
        from repro.core.sketch import masked_table_mean
        _eq(Q.ace_query_sum(got, _t(ids), table_mask=_t(mask)),
            masked_table_mean(g, jnp.asarray(mask)))

    @pytest.mark.parametrize("dt", NARROW)
    def test_ace_update_wraps_like_the_reference(self, dt):
        """int8 127 + 1 → −128, int16 32767 + 1 → −32768, also with the
        row mask and at base rows."""
        from repro.kernels.ace_update import ace_update as jupdate
        counts = np.zeros((3, 16), dt)
        counts[:, 5] = _cap(dt)
        ids = np.full((2, 3), 5, np.int32)
        want = jupdate(jnp.asarray(counts), jnp.asarray(ids[:1]),
                       interpret=True)
        got = U.ace_update(_t(counts), _t(ids[:1]))
        _eq(got, want)
        assert int(got[0, 5]) == int(np.iinfo(dt).min)
        got = U.ace_update(_t(counts), _t(ids),
                           row_mask=_t(np.array([True, False])),
                           row_base=_t(np.zeros(2, np.int32)))
        _eq(got, want)

    @pytest.mark.parametrize("dt", DTYPES)
    def test_ace_score_fused(self, dt):
        from repro.kernels.ace_score_fused import ace_score_fused as jscore
        jcfg, cfg, w, x = _hash_inputs(26, 20, 7, 9, seed=5)
        counts = _counts((9, 128), dt, 7)
        pw = params_from_numpy(w, CPU)
        s, ids = F.ace_score_fused_planned(_t(counts), _t(x), pw, cfg, None,
                                           None, with_ids=True)
        want = jscore(jnp.asarray(counts), jnp.asarray(x), jnp.asarray(w),
                      jcfg, interpret=True)
        np.testing.assert_allclose(s.numpy(), np.asarray(want), rtol=1e-6)
        tw = np.ones(9, np.float32) / 7
        tw[[2, 4]] = 0
        want = jscore(jnp.asarray(counts), jnp.asarray(x), jnp.asarray(w),
                      jcfg, interpret=True, table_weights=jnp.asarray(tw))
        np.testing.assert_allclose(
            F.ace_score_fused(_t(counts), _t(x), pw, cfg, _t(tw)).numpy(),
            np.asarray(want), rtol=1e-6)

    @pytest.mark.parametrize("dt", DTYPES)
    def test_ace_admit_fused(self, dt):
        """Scores, verdicts and the counts in their own dtype bitwise the
        Pallas kernel's, narrow counters at their cap wrapping alike."""
        from repro.kernels.ace_admit_fused import ace_admit_fused as jadmit
        jcfg, cfg, w, x = _hash_inputs(16, 12, 4, 5, seed=8)
        x = np.concatenate([x, x])
        counts = _counts((5, 16), dt, 9)
        if dt != "float32":
            counts[:, :3] = _cap(dt)
        thresh = np.float32(np.median(counts))
        want = jadmit(jnp.asarray(counts), jnp.asarray(x), jnp.asarray(w),
                      jnp.asarray(thresh), jcfg, interpret=True)
        got = A.ace_admit_fused(_t(counts), _t(x), params_from_numpy(w, CPU),
                                torch.tensor(thresh), cfg)
        if (got[3].numpy() == np.asarray(want[3])).all():
            for i, (a, b) in enumerate(zip(got, want)):
                _eq(a, b, str(i))
        assert got[0].dtype == torch.from_numpy(counts).dtype

    @pytest.mark.parametrize("dt", DTYPES)
    def test_ace_window_combine(self, dt):
        from repro.kernels.ace_window_combine import \
            ace_window_combine as jcombine
        counts = _counts((3, 6, 64), dt, 9)
        ids = np.random.default_rng(10).integers(0, 64, size=(22, 6)) \
            .astype(np.int32)
        weights = np.array([1.0, 0.6, 0.36], np.float32)
        tw = np.full(6, 1 / 5, np.float32)
        tw[3] = 0
        for t in (None, tw):
            want = jcombine(jnp.asarray(counts), jnp.asarray(ids),
                            jnp.asarray(weights), interpret=True,
                            table_weights=None if t is None
                            else jnp.asarray(t))
            got = WC.ace_window_combine(_t(counts), _t(ids), _t(weights),
                                        None if t is None else _t(t))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6)

    @pytest.mark.parametrize("dt", DTYPES)
    def test_ace_fleet_score(self, dt):
        from repro.kernels.ace_fleet_score import ace_fleet_score as jfleet
        jcfg, cfg, w, x = _hash_inputs(26, 20, 7, 9, seed=5)
        counts = _counts((3, 9, 128), dt, 8)
        tids = np.random.default_rng(8).integers(0, 3, 26).astype(np.int32)
        want = jfleet(jnp.asarray(counts), jnp.asarray(x), jnp.asarray(tids),
                      jnp.asarray(w), jcfg, interpret=True)
        got = FS.ace_fleet_score(_t(counts), _t(x), _t(tids),
                                 params_from_numpy(w, CPU), cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)

    def test_ace_fleet_window_admit_float_ring(self):
        from repro.kernels.ace_fleet_window_admit import \
            ace_fleet_window_admit_fused as jfwa
        jcfg, cfg, w, x = _hash_inputs(12, 9, 4, 3, seed=11)
        ring_ = _counts((2, 2, 3, 16), "float32", 12)
        tail = _counts((2, 3, 16), "float32", 13, hi=20)
        cursor = np.array([1, 0], np.int32)
        tids = np.random.default_rng(14).integers(0, 2, 12).astype(np.int32)
        thr = np.array([3.0, 6.0], np.float32)
        want = jfwa(jnp.asarray(ring_), jnp.asarray(tail),
                    jnp.asarray(cursor), jnp.asarray(x), jnp.asarray(tids),
                    jnp.asarray(w), jnp.asarray(thr), jcfg, interpret=True)
        got = FWA.ace_fleet_window_admit_fused(
            _t(ring_), _t(tail), _t(cursor), _t(x), _t(tids),
            params_from_numpy(w, CPU), _t(thr), cfg)
        if (got[3].numpy() == np.asarray(want[3])).all():
            for i, (a, b) in enumerate(zip(got, want)):
                _eq(a, b, str(i))


# ---------------------------------------------------------------------------
# ops: the kernel path, and the plain quantize path under ``esc``.
# ---------------------------------------------------------------------------

class TestOps:
    @pytest.mark.parametrize("dt,esc", [("int8", 0), ("int16", 0),
                                        ("float32", 0), ("int8", 6),
                                        ("int16", 3)])
    def test_update_query_score_admit_match_reference_ops(self, dt, esc):
        """``ops.ace_update``/``ace_query``/``ace_score``/``ace_admit`` on a
        state that crosses the int8 cap: the reference's ops (Pallas
        kernels in interpret mode, or its jnp quantize path under esc)."""
        kw = dict(dim=10, num_bits=3, num_tables=4, seed=2,
                  counter_dtype=dt, esc_capacity=esc)
        cfg, jcfg = sk.AceConfig(**kw), jsk.AceConfig(**kw)
        w = np.asarray(jsk.make_params(jcfg))
        pw = params_from_numpy(w, CPU)
        rng = np.random.default_rng(3)
        ps, js = sk.init(cfg, CPU), jsk.init(jcfg)
        x = (rng.normal(size=(3, 10))[rng.integers(0, 3, 480)]
             + 0.05 * rng.normal(size=(480, 10))).astype(np.float32)
        for i in range(0, 480, 80):
            b = np.asarray(jops.hash_dispatch(jnp.asarray(x[i:i + 80]),
                                              jnp.asarray(w), jcfg.srp))
            ps = ops.ace_update(ps, _t(b), cfg)
            js = jops.ace_update(js, jnp.asarray(b), jcfg)
        _assert_sketch(ps, js, exact_mu=dt != "int16")
        if dt == "int8" and esc:
            assert int((ps.esc.offs != qz.SENTINEL).sum()) > 0
        b = np.asarray(jops.hash_dispatch(jnp.asarray(x[:16]), jnp.asarray(w),
                                          jcfg.srp))
        mask = np.array([1, 1, 0, 1], np.float32)
        for m in (None, mask):
            _eq(ops.ace_query(ps, _t(b), None if m is None else _t(m)),
                jops.ace_query(js, jnp.asarray(b),
                               None if m is None else jnp.asarray(m)))
        np.testing.assert_allclose(
            ops.ace_score(ps, _t(x[:16]), pw, cfg).numpy(),
            np.asarray(jops.ace_score(js, jnp.asarray(x[:16]),
                                      jnp.asarray(w), jcfg)), rtol=1e-6)
        ps2, pa = ops.ace_admit(ps, _t(x[:24]), pw, cfg, alpha=1.0,
                                warmup_items=0.0)
        js2, ja = jops.ace_admit(js, jnp.asarray(x[:24]), jnp.asarray(w),
                                 jcfg, alpha=1.0, warmup_items=0.0)
        _eq(pa, ja)
        _assert_sketch(ps2, js2, exact_mu=dt != "int16")


# ---------------------------------------------------------------------------
# The Guardrail's four flavours, the filters and the runner.
# ---------------------------------------------------------------------------

GCFG = dict(d_model=12, num_bits=6, num_tables=8, warmup_items=32.0,
            alpha=2.0)


def _batches(n, seed=11, b=16, s=3, d=12, T=None):
    """Request embeddings around a few directions, one NaN row each, a
    growing off-topic share (and tenant ids in [0, T) for a fleet)."""
    rng = np.random.default_rng(seed)
    topics = rng.normal(size=(3, d))
    for i in range(n):
        e = topics[rng.integers(0, 3, b)][:, None, :] \
            + 0.3 * rng.normal(size=(b, s, d))
        if i >= n // 2:
            k = 2 * (i - n // 2) + 2
            e[:k] = rng.normal(size=(k, s, d)) * 3.0
        e[i % b, i % s, 0] = np.nan
        t = None if T is None else rng.integers(0, T, b).astype(np.int32)
        yield e.astype(np.float32), t


FLAVOURS = {"flat": {}, "window": dict(window_epochs=3, rotate_every=2),
            "fleet": dict(num_tenants=3),
            "fleet_window": dict(num_tenants=3, window_epochs=3,
                                 rotate_every=2)}


class TestGuardrails:
    @pytest.mark.parametrize("dt", NARROW)
    @pytest.mark.parametrize("kind", list(FLAVOURS))
    def test_narrow_flavours_match_reference_and_int32(self, kind, dt):
        """Each flavour in int16 and int8 admits like the reference (its
        kernel path; Pallas in interpret mode) on the same W — masks and
        counts bitwise — and like the port's int32 guardrail, counts
        widened (below saturation narrow is free); the memory bill is the
        reference's formula."""
        kw = {**GCFG, **FLAVOURS[kind]}
        gj = jengine.Guardrail(jengine.GuardrailConfig(count_dtype=dt, **kw),
                               use_kernels=True)
        w = params_from_numpy(np.asarray(gj.w), CPU)
        gp = engine.Guardrail(engine.GuardrailConfig(count_dtype=dt, **kw),
                              device="cpu", w=w)
        g32 = engine.Guardrail(engine.GuardrailConfig(**kw), device="cpu",
                               w=w)
        for e, t in _batches(6, T=kw.get("num_tenants")):
            want = gj.admit(jnp.asarray(e)) if t is None \
                else gj.admit(jnp.asarray(e), jnp.asarray(t))
            got = gp.admit(e, t)
            np.testing.assert_array_equal(got, np.asarray(want))
            np.testing.assert_array_equal(got, g32.admit(e, t))
        _eq(gp.state.counts, gj.state.counts)
        assert gp.state.counts.dtype == getattr(torch, dt)
        assert torch.equal(gp.state.counts.to(torch.int32), g32.state.counts)
        _eq(gp.state.n, gj.state.n)
        base = sk.AceConfig(dim=13, num_bits=6, num_tables=8,
                            counter_dtype=dt).memory_bytes()
        T, E = kw.get("num_tenants", 1), kw.get("window_epochs", 1)
        tail = 8 * 64 * 4 if E > 1 else 0
        assert gp.memory_bytes() == T * (E * base + tail)

    @pytest.mark.parametrize("use_kernels", [True, False])
    @pytest.mark.parametrize("esc", [0, 8])
    def test_flat_int8_past_saturation(self, esc, use_kernels):
        """A flat int8 guardrail on K = 3 (8 buckets a table) past 127:
        with promotion the logical counts stay exact (promoted slots, the
        escalation table and masks bitwise the reference's, densified
        counts ≡ the int32 guardrail's); without it the plane wraps as the
        reference's does."""
        kw = {**GCFG, "num_bits": 3, "warmup_items": 1e9}
        gj = jengine.Guardrail(jengine.GuardrailConfig(
            count_dtype="int8", esc_capacity=esc, **kw), use_kernels=True)
        w = params_from_numpy(np.asarray(gj.w), CPU)
        gp = engine.Guardrail(engine.GuardrailConfig(
            count_dtype="int8", esc_capacity=esc, **kw), device="cpu", w=w,
            use_kernels=use_kernels)
        g32 = engine.Guardrail(engine.GuardrailConfig(**kw), device="cpu",
                               w=w)
        for e, _ in _batches(14, b=24):
            np.testing.assert_array_equal(gp.admit(e),
                                          np.asarray(gj.admit(jnp.asarray(e))))
            g32.admit(e)
        _assert_sketch(gp.state, gj.state)
        assert int(g32.state.counts.max()) > 127
        if esc:
            assert int((gp.state.esc.offs != qz.SENTINEL).sum()) > 0
            assert torch.equal(_widened(gp.state), g32.state.counts)
        else:
            assert int(gp.state.counts.min()) < 0      # wrapped


class TestFiltersAndRunner:
    FKW = dict(d_model=24, num_bits=6, num_tables=8, alpha=1.0,
               warmup_items=40.0)

    @staticmethod
    def _features(n, seed=1, burst_from=None, B=16, D=24):
        rng = np.random.default_rng(seed)
        topics = np.random.default_rng(0).normal(size=(3, D + 1))
        out = []
        for i in range(n):
            f = topics[rng.integers(0, 3, B)] \
                + 0.2 * rng.normal(size=(B, D + 1))
            if burst_from is not None and i >= burst_from:
                f[: B // 4] = 3.0 * rng.normal(size=(B // 4, D + 1))
            f[i % B, i % (D + 1)] = np.nan
            out.append(f.astype(np.float32))
        return out

    @pytest.mark.parametrize("use_kernels", [True, False])
    @pytest.mark.parametrize("dt,esc", [("int16", 0), ("int8", 4)])
    def test_flat_filter_step(self, dt, esc, use_kernels):
        kw = {**self.FKW, "count_dtype": dt, "esc_capacity": esc,
              "num_bits": 2, "insert_all": True}
        jf = JFilter(**kw)
        pf = AceDataFilter(**kw, use_kernels=use_kernels, device="cpu")
        (js, jw), (ps, _) = jf.init(), pf.init()
        pw = params_from_numpy(np.asarray(jw), CPU)
        for f in self._features(12, burst_from=9, B=48):
            js, jk, jm = jf.step(js, jw, jnp.asarray(f))
            ps, pk, pm = pf.step(ps, pw, torch.from_numpy(f))
            np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
        _assert_sketch(ps, js)
        if esc:
            assert int((ps.esc.offs != qz.SENTINEL).sum()) > 0

    @pytest.mark.parametrize("dt", NARROW)
    def test_windowed_filter_step(self, dt):
        """The windowed filter's narrow ring (a port field; the reference
        filter's ring type comes from its ``ace_cfg``, which the test
        narrows the same way) steps like the reference and like the int32
        ring, widened."""
        import dataclasses

        @dataclasses.dataclass(frozen=True)
        class JNarrow(JWinFilter):
            @property
            def ace_cfg(self):
                return dataclasses.replace(super().ace_cfg, counter_dtype=dt)
        kw = {**self.FKW, "num_epochs": 2, "decay": 0.8}
        jf = JNarrow(**kw)
        pf = WindowedAceFilter(**kw, count_dtype=dt, device="cpu")
        p32 = WindowedAceFilter(**kw, device="cpu")
        (js, jw), (ps, _), (s32, _) = jf.init(), pf.init(), p32.init()
        assert js.counts.dtype == jnp.dtype(dt)
        pw = params_from_numpy(np.asarray(jw), CPU)
        for i, f in enumerate(self._features(8, burst_from=6)):
            js, jk, _ = jf.step(js, jw, jnp.asarray(f))
            ps, pk, _ = pf.step(ps, pw, torch.from_numpy(f))
            s32, k32, _ = p32.step(s32, pw, torch.from_numpy(f))
            np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
            assert torch.equal(pk, k32)
            if i % 3 == 2:
                js, ps = jring.rotate(js, 0.8), ring.rotate(ps, 0.8)
                s32 = ring.rotate(s32, 0.8)
        _eq(ps.counts, js.counts)
        assert torch.equal(ps.counts.to(torch.int32), s32.counts)
        assert torch.equal(ps.tail, s32.tail)

    @pytest.mark.parametrize("dt", NARROW)
    def test_fleet_filter_and_runner(self, dt):
        kw = dict(d_model=24, num_tenants=3, num_bits=6, num_tables=8,
                  alpha=1.0, warmup_items=20.0, count_dtype=dt)
        jf, pf = JFleetFilter(**kw), FleetDataFilter(**kw, device="cpu")
        (js, jw), (ps, _) = jf.init(), pf.init()
        pw = params_from_numpy(np.asarray(jw), CPU)
        feats = self._features(8, burst_from=6)
        tids = [np.random.default_rng(i).integers(0, 3, 16).astype(np.int32)
                for i in range(8)]
        jr, pr = JRunner(jf, chunk_T=4), StreamRunner(pf, chunk_T=4)
        for c in range(2):
            fs, ts = feats[4 * c: 4 * c + 4], tids[4 * c: 4 * c + 4]
            js, jsum = jr.consume(js, jw, jnp.asarray(np.stack(fs)),
                                  tenant_ids=jnp.asarray(np.stack(ts)))
            ps, psum = pr.consume(ps, pw, torch.from_numpy(np.stack(fs)),
                                  tenant_ids=torch.from_numpy(np.stack(ts)))
            _eq(psum.kept_frac, jsum.kept_frac)
            np.testing.assert_allclose(psum.falpha.numpy(),
                                       np.asarray(jsum.falpha), rtol=1e-5)
        _eq(ps.counts, js.counts)
        assert ps.counts.dtype == getattr(torch, dt)

    @pytest.mark.parametrize("use_kernels", [True, False])
    def test_runner_falpha_reads_logical_counts(self, use_kernels):
        """An int8 stream with promotion past 127 (K = 2): the runner's
        summaries — falpha over the densified counts — like the
        reference's, and like the int32 stream's."""
        kw = {**self.FKW, "num_bits": 2, "warmup_items": 1e9}
        jf = JFilter(**kw, count_dtype="int8", esc_capacity=32)
        pf = AceDataFilter(**kw, count_dtype="int8", esc_capacity=32,
                           use_kernels=use_kernels, device="cpu")
        p32 = AceDataFilter(**kw, use_kernels=use_kernels, device="cpu")
        (js, jw), (ps, _), (s32, _) = jf.init(), pf.init(), p32.init()
        pw = params_from_numpy(np.asarray(jw), CPU)
        jr, pr, r32 = (JRunner(jf, chunk_T=4), StreamRunner(pf, chunk_T=4),
                       StreamRunner(p32, chunk_T=4))
        feats = self._features(12, B=48)
        for c in range(3):
            chunk = np.stack(feats[4 * c: 4 * c + 4])
            js, jsum = jr.consume(js, jw, jnp.asarray(chunk))
            ps, psum = pr.consume(ps, pw, torch.from_numpy(chunk))
            s32, sum32 = r32.consume(s32, pw, torch.from_numpy(chunk))
            np.testing.assert_allclose(float(psum.falpha),
                                       float(jsum.falpha), rtol=1e-5)
            assert torch.equal(psum.falpha, sum32.falpha)
            _eq(psum.kept_frac, jsum.kept_frac)
        assert int((ps.esc.offs != qz.SENTINEL).sum()) > 0
        assert float(ps.esc.lost) == 0.0
        _assert_sketch(ps, js)


class TestFleetPromotion:
    @pytest.mark.parametrize("dt", NARROW)
    def test_promote_and_merge(self, dt):
        """``merge_fleet(a8, b8)`` ≡ ``merge_fleet(promote_fleet(a8),
        promote_fleet(b8))`` ≡ the reference's, int32 out, and a sum that
        would wrap in the narrow dtype does not."""
        cq, jq, _ = _cfgs(dt, 0, K=3, L=2)
        rng = np.random.default_rng(7)
        counts = [rng.integers(0, _cap(dt) + 1, size=(2, 2, 8)).astype(dt)
                  for _ in range(2)]
        a, b = (fl.init(fl.FleetConfig(ace=cq, num_tenants=2), CPU)
                ._replace(counts=_t(c), n=torch.tensor([3.0, 5.0]))
                for c in counts)
        ja, jb = (jfl.init(jfl.FleetConfig(ace=jq, num_tenants=2))
                  ._replace(counts=jnp.asarray(c),
                            n=jnp.asarray([3.0, 5.0], jnp.float32))
                  for c in counts)
        pa = fl.promote_fleet(a)
        assert pa.counts.dtype == torch.int32
        _eq(pa.counts, jfl.promote_fleet(ja).counts)
        m = fl.merge_fleet(a, b)
        assert m.counts.dtype == torch.int32
        for x, y in zip(m, fl.merge_fleet(pa, fl.promote_fleet(b))):
            if x is not None:
                assert torch.equal(x, y)
        _eq(m.counts, jfl.merge_fleet(ja, jb).counts)
        assert int(m.counts.max()) > _cap(dt)
