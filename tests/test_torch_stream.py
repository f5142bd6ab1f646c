"""The port's data filter and stream runner (``repro_torch.data.pipeline``,
``repro_torch.stream``) against the reference's (``repro.data.pipeline``,
``repro.stream``) on the same numpy-made features and the same JAX-drawn W
(dense) or numpy-drawn SRHT parameters, on the CPU, both through the
kernel path (``use_kernels=True``: every wrapper takes its plain version
on CPU tensors) and the plain sketch path.

Tolerances:
* counts, n, keep masks, kept_frac, anom_counts, quarantined, degraded,
  topk_step/item/valid: exact (the shapes here are small enough that the
  dense hash ids agree everywhere; the SRHT ids are bitwise by design);
* Welford mean/M2 and falpha: rtol 1e-5;
* margins (score − threshold): rtol 1e-6 plus an absolute 1e-6·n — the
  score is exact, but the threshold's μ−ασ carries the Welford stream's
  float summation order, and a margin near 0 is a difference of two O(n)
  numbers.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro.data.pipeline import AceDataFilter as JFilter  # noqa: E402
from repro.stream.runner import StreamRunner as JRunner  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402
from repro_torch.data.pipeline import AceDataFilter  # noqa: E402
from repro_torch.dist.mesh import make_host_local_mesh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.stream import runner as runner_mod  # noqa: E402
from repro_torch.stream.runner import StreamRunner  # noqa: E402

CPU = torch.device("cpu")
D, B, T = 24, 16, 4
FKW = dict(d_model=D, num_bits=6, num_tables=8, alpha=1.0)
EXACT = ("kept_frac", "anom_counts", "topk_step", "topk_item", "n",
         "quarantined", "degraded", "topk_valid")


def _features(n, seed=1, burst_from=None):
    """(B, D+1) feature batches around 3 topics, one NaN row each; from
    ``burst_from`` on, a quarter of each batch is off-topic noise."""
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


def _pair(mode="dense", use_kernels=True, **kw):
    """The reference filter and the port's, on one set of hash params."""
    kw = {**FKW, "hash_mode": mode, **kw}
    jf = JFilter(**kw)
    pf = AceDataFilter(**kw, use_kernels=use_kernels, device="cpu")
    js, jw = jf.init()
    ps, pw = pf.init()
    if mode == "dense":
        pw = params_from_numpy(np.asarray(jw), CPU)
    return jf, pf, (js, jw), (ps, pw)


def _assert_state(ps, js):
    np.testing.assert_array_equal(ps.counts.numpy(), np.asarray(js.counts))
    assert float(ps.n) == float(js.n)
    for k in ("welford_mean", "welford_m2"):
        np.testing.assert_allclose(float(getattr(ps, k)),
                                   float(getattr(js, k)), rtol=1e-5)


def _assert_margins(got, want, n):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[~np.isfinite(got)],
                                  want[~np.isfinite(want)])
    fin = np.isfinite(got)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6,
                               atol=1e-6 * max(float(n), 1.0))


class TestFilterStep:
    @pytest.mark.parametrize("use_kernels", [True, False])
    @pytest.mark.parametrize("variant", ["filter", "insert_all", "masked"])
    @pytest.mark.parametrize("mode", ["dense", "srht"])
    def test_step_matches_reference(self, mode, variant, use_kernels):
        """Eight steps through warmup and past it, NaN rows in each:
        keep masks, margins, counts and n alike."""
        kw = dict(warmup_items=40.0)
        if variant == "insert_all":
            kw["insert_all"] = True
        jf, pf, (js, jw), (ps, pw) = _pair(mode, use_kernels, **kw)
        mask = None
        if variant == "masked":
            mask = np.ones(8, np.float32)
            mask[[2, 5]] = 0.0
        flagged = 0
        for f in _features(8, burst_from=5):
            js, jk, jm = jf.step(js, jw, jnp.asarray(f), table_mask=(
                None if mask is None else jnp.asarray(mask)))
            ps, pk, pm = pf.step(ps, pw, torch.from_numpy(f), table_mask=(
                None if mask is None else torch.from_numpy(mask)))
            np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
            _assert_margins(pm.numpy(), jm, js.n)
            _assert_state(ps, js)
            assert np.isneginf(pm.numpy()).sum() == 1     # the NaN row
            flagged += int((~pk.numpy()).sum())
        assert flagged > 8, "the burst is flagged past warmup"

    @pytest.mark.parametrize("mode", ["dense", "srht"])
    def test_call_matches_reference(self, mode):
        """``__call__`` on (B, S, D) embeddings zeroes the flagged rows'
        loss mask, like the reference."""
        jf, pf, (js, jw), (ps, pw) = _pair(mode, warmup_items=20.0)
        rng = np.random.default_rng(3)
        for i in range(4):
            e = (rng.normal(size=(B, 3, D)) * 0.3 + 1.0).astype(np.float32)
            if i == 3:
                e[:4] = rng.normal(size=(4, 3, D)) * 4.0
            m = np.ones((B, 3), np.float32)
            js, jm, jfrac = jf(js, jw, jnp.asarray(e), jnp.asarray(m))
            ps, pm, pfrac = pf(ps, pw, torch.from_numpy(e),
                               torch.from_numpy(m))
            np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
            assert float(pfrac) == float(jfrac)
        _assert_state(ps, js)

    def test_kernel_and_plain_paths_agree(self):
        """The two paths of the port on one stream: bitwise counts, n and
        Welford (both fold the same post-insert scores the same way)."""
        _, fk, _, (sk_, w) = _pair("srht", True, warmup_items=40.0)
        fp = AceDataFilter(**FKW, hash_mode="srht", warmup_items=40.0,
                           use_kernels=False, device="cpu")
        sp = fp.init()[0]
        for f in _features(6):
            sk_, kk, mk = fk.step(sk_, w, torch.from_numpy(f))
            sp, kp, mp = fp.step(sp, w, torch.from_numpy(f))
            assert torch.equal(kk, kp) and torch.equal(mk, mp)
        for k in ("counts", "n", "welford_mean", "welford_m2"):
            assert torch.equal(getattr(sk_, k), getattr(sp, k)), k

    @pytest.mark.parametrize("kw", [
        dict(count_dtype="int8"), dict(count_dtype="int8", esc_capacity=4)])
    def test_narrow_filters_now_step_like_the_reference(self, kw):
        """Narrow planes, once refused here (queue 1 item 9), now step like
        the reference through the kernel path: keep masks, margins,
        counts (in their dtype) and the escalation table alike
        (tests/test_torch_quantize.py covers every filter)."""
        jf, pf, (js, jw), (ps, pw) = _pair("dense", True, warmup_items=40.0,
                                           **kw)
        for f in _features(6, burst_from=4):
            js, jk, jm = jf.step(js, jw, jnp.asarray(f))
            ps, pk, pm = pf.step(ps, pw, torch.from_numpy(f))
            np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
            _assert_margins(pm.numpy(), jm, js.n)
            _assert_state(ps, js)
        assert ps.counts.dtype == torch.int8
        if "esc_capacity" in kw:
            for k in ("offs", "vals", "lost"):
                np.testing.assert_array_equal(
                    getattr(ps.esc, k).numpy(), np.asarray(getattr(js.esc, k)))

    @pytest.mark.parametrize("windowed", [False, True])
    def test_quantile_filters_now_step_like_the_reference(self, windowed):
        """Quantile admission, once refused here (queue 1 item 7), now
        steps like the reference: keep masks and histograms bitwise
        (tests/test_torch_quantile.py covers every filter)."""
        from repro.window.filter import WindowedAceFilter as JWin
        from repro_torch.window.filter import WindowedAceFilter
        kw = {**FKW, "threshold_mode": "quantile", "quantile_q": 0.05,
              "warmup_items": 40.0}
        if windowed:
            kw["num_epochs"] = 2
        jf = (JWin if windowed else JFilter)(**kw)
        pf = (WindowedAceFilter if windowed else AceDataFilter)(
            **kw, device="cpu")
        (js, jw), (ps, _) = jf.init(), pf.init()
        w = params_from_numpy(np.asarray(jw), CPU)
        for f in _features(6, burst_from=4):
            js, jk, _ = jf.step(js, jw, jnp.asarray(f))
            ps, pk, _ = pf.step(ps, w, torch.from_numpy(f))
            np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(ps.qhist.numpy(), np.asarray(js.qhist))
        assert float(ps.qhist.sum()) > 0

    def test_bad_options_raise(self):
        with pytest.raises(ValueError, match="threshold_mode"):
            AceDataFilter(d_model=8, device="cpu", threshold_mode="median")
        with pytest.raises(ValueError, match="hash_mode"):
            AceDataFilter(d_model=8, device="cpu", hash_mode="fwht")
        with pytest.raises(ValueError, match="counter_dtype"):
            AceDataFilter(d_model=8, device="cpu", count_dtype="int4")
        # float32 counts, once refused on the kernel path, step like the
        # reference's
        jf, pf, (js, jw), (ps, pw) = _pair("dense", True, warmup_items=40.0,
                                           count_dtype="float32")
        for f in _features(4):
            js, jk, _ = jf.step(js, jw, jnp.asarray(f))
            ps, pk, _ = pf.step(ps, pw, torch.from_numpy(f))
            np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
        assert ps.counts.dtype == torch.float32
        _assert_state(ps, js)


class TestStreamRunner:
    @pytest.mark.parametrize("use_kernels", [True, False])
    @pytest.mark.parametrize("mode", ["dense", "srht"])
    def test_run_matches_reference(self, mode, use_kernels):
        """Three chunks of T=4: the first all in warmup (every margin
        +inf, the whole chunk tied), then armed chunks with a burst."""
        jf, pf, (js, jw), (ps, pw) = _pair(mode, use_kernels,
                                           warmup_items=70.0)
        feats = _features(3 * T, burst_from=2 * T)
        js, jsum = JRunner(jf, T).run(js, jw, feats)
        ps, psum = StreamRunner(pf, T).run(ps, pw, feats)
        _assert_state(ps, js)
        assert len(psum) == len(jsum) == 3
        for got, want in zip(psum, jsum):
            for f in EXACT:
                np.testing.assert_array_equal(getattr(got, f),
                                              np.asarray(getattr(want, f)),
                                              err_msg=f)
                assert getattr(got, f).dtype == np.asarray(
                    getattr(want, f)).dtype, f
            _assert_margins(got.topk_margin, want.topk_margin, want.n)
            np.testing.assert_allclose(got.falpha, np.asarray(want.falpha),
                                       rtol=1e-5)
            assert got.hh_coord is None and want.hh_coord is None
        warm = psum[0]
        assert np.isposinf(warm.topk_margin).all()
        np.testing.assert_array_equal(warm.topk_step, np.zeros(8))
        np.testing.assert_array_equal(warm.topk_item, np.arange(8))
        assert not warm.topk_valid.any()
        assert psum[-1].topk_valid.all(), "the burst fills the top-k"

    def test_topk_ties_rank_lower_index_first(self):
        """All-tied margins (warmup) rank 0, 1, 2, …, as jax.lax.top_k
        does (torch.topk does not); a quarantined row (−inf) ranks with
        the +inf rows, after every real margin."""
        pf = AceDataFilter(**FKW, warmup_items=1e9, device="cpu")
        r = StreamRunner(pf, 2, topk=8)
        keeps = torch.ones((2, 4096), dtype=torch.bool)
        margins = torch.full((2, 4096), float("inf"))
        margins[0, 3] = float("-inf")
        s = r._summary(pf.init()[0], keeps, margins, None)
        assert s.topk_item.tolist() == list(range(8))
        margins[1, 5] = -2.0
        margins[1, 9] = -2.0
        s = r._summary(pf.init()[0], keeps, margins, None)
        assert s.topk_step.tolist()[:2] == [1, 1]
        assert s.topk_item.tolist()[:3] == [5, 9, 0]
        assert s.topk_valid.tolist()[:3] == [True, True, False]

    @pytest.mark.parametrize("mode", ["dense", "srht"])
    def test_chunk_equals_sequential_steps(self, mode):
        """``consume`` of a chunk ≡ T sequential ``step`` calls: counts, n
        and the Welford stream bitwise, keep masks equal."""
        _, pf, _, (s0, w) = _pair(mode, warmup_items=40.0)
        feats = _features(2 * T, burst_from=T)
        runner = StreamRunner(pf, T, return_masks=True)
        sc, seq_keeps = s0, []
        for c in range(2):
            chunk = torch.from_numpy(np.stack(feats[c * T:(c + 1) * T]))
            sc, summary, keeps = runner.consume(sc, w, chunk)
            seq_keeps.append(keeps)
        ss, _ = _pair(mode, warmup_items=40.0)[3]
        step_keeps = []
        for f in feats:
            ss, k, _ = pf.step(ss, w, torch.from_numpy(f))
            step_keeps.append(k)
        for k in ("counts", "n", "welford_mean", "welford_m2"):
            assert torch.equal(getattr(sc, k), getattr(ss, k)), k
        assert torch.equal(torch.cat(seq_keeps), torch.stack(step_keeps))
        assert int(summary.quarantined) == T
        assert not bool(summary.degraded)

    def test_one_transfer_each_way_per_chunk(self, monkeypatch):
        h2d, d2h = [], []
        real_in, real_out = runner_mod._to_device, runner_mod._to_host

        def to_device(x, device):
            h2d.append(x.shape)
            return real_in(x, device)

        def to_host(x):
            d2h.append(tuple(x.shape))
            return real_out(x)
        monkeypatch.setattr(runner_mod, "_to_device", to_device)
        monkeypatch.setattr(runner_mod, "_to_host", to_host)
        _, pf, _, (s, w) = _pair("srht", warmup_items=40.0)
        s, sums = StreamRunner(pf, T).run(s, w, _features(3 * T + 2))
        assert len(sums) == 3, "a trailing partial chunk is dropped"
        assert h2d == [(T, B, D + 1)] * 3
        assert len(d2h) == 3 and len(set(d2h)) == 1
        assert isinstance(s.counts, torch.Tensor)

    def test_degraded_chunk(self):
        """A table mask scores the chunk over healthy tables and marks the
        summary degraded; counts still take every kept item."""
        _, pf, _, (s, w) = _pair("dense", warmup_items=40.0)
        runner = StreamRunner(pf, T)
        mask = torch.ones(8)
        mask[1] = 0.0
        chunk = torch.from_numpy(np.stack(_features(T)))
        s, summary = runner.consume(s, w, chunk, table_mask=mask)
        host = runner.fetch(summary)
        assert bool(host.degraded) and host.n == float(s.n)
        assert (s.counts.sum(dim=1) == int(host.n)).all()

    @pytest.mark.parametrize("kw,item", [
        (dict(mesh=make_host_local_mesh()), 13),
        (dict(mesh=make_host_local_mesh(), rotate_every=2), 13)])
    def test_later_slices_raise(self, kw, item):
        """A mesh is ported (``repro_torch.dist``; across ranks in
        tests/test_torch_dist_sharded.py): on a one-rank mesh the runner
        is the unmeshed one bitwise, and a rotation clock on the flat
        filter is refused as without a mesh."""
        pf = AceDataFilter(**FKW, device="cpu")
        if "rotate_every" in kw:
            with pytest.raises(ValueError, match="windowed filter"):
                StreamRunner(pf, T, **kw)
        else:
            feats = _features(2 * T)
            outs = []
            for runner in (StreamRunner(pf, T), StreamRunner(pf, T, **kw)):
                s, w = runner.init()
                outs.append(runner.run(s, w, feats))
            (s0, sum0), (s1, sum1) = outs
            assert torch.equal(s0.counts, s1.counts)
            for k in ("n", "welford_mean", "welford_m2"):
                assert torch.equal(getattr(s0, k), getattr(s1, k)), k
            for a, b in zip(sum0, sum1):
                for f in a._fields:
                    if getattr(a, f) is not None:
                        np.testing.assert_array_equal(getattr(a, f),
                                                      getattr(b, f))
        # the dry run is ported (tests/test_torch_dryrun.py): queue 1 no
        # longer holds item 13, and with no cell named it stops at its usage
        from repro_torch import ROADMAP_QUEUE_1
        assert item not in ROADMAP_QUEUE_1
        with pytest.raises(SystemExit):
            dryrun.main([])

    def test_fleets_and_windows_raise(self):
        """Windows and fleets are ported (tests/test_torch_window.py and
        tests/test_torch_fleet.py); what still raises is what the
        reference refuses too: a rotation clock on a fleet or on the flat
        filter, and tenant ids for a filter that is not a fleet."""
        with pytest.raises(NotImplementedError, match="windowed fleets"):
            StreamRunner(types.SimpleNamespace(num_tenants=4), T,
                         rotate_every=2)
        pf = AceDataFilter(**FKW, device="cpu")
        with pytest.raises(ValueError, match="windowed filter"):
            StreamRunner(pf, T, rotate_every=2)
        s, w = pf.init()
        with pytest.raises(ValueError, match="not a fleet"):
            StreamRunner(pf, T).run(s, w, _features(T), tenant_ids=[0])

    def test_wrong_chunk_shape_raises(self):
        pf = AceDataFilter(**FKW, device="cpu")
        s, w = pf.init()
        with pytest.raises(ValueError, match="chunk"):
            StreamRunner(pf, T).consume(s, w, torch.zeros((T + 1, 2, D + 1)))
