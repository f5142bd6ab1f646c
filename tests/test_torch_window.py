"""The port's sliding window (``repro_torch.window``: the epoch ring, the
``WindowedAceFilter``, the windowed ``StreamRunner`` and ``Guardrail``,
``ops.ace_window_score``) against the reference's (``repro.window`` and
its drivers) on the same numpy-made inputs and the same JAX-drawn W, on
the CPU, where every kernel wrapper takes its plain version.

Tolerances:
* counts, n, cursor, tick, keep and admit masks, quarantine counts:
  exact;
* at γ = 1 the tail, ssq, μ and scores are integer-valued float32 below
  2^24 and exact; at γ < 1 they carry the decay's float products, which
  the port sums in ring-index order and the reference in XLA's
  (``tensordot``): rtol 1e-6, the reference's own tolerance for its
  window combine;
* the Welford streams (and σ and thresholds, which derive from them):
  rtol 1e-6 — their batch sums run in PyTorch's order here and XLA's
  there; a threshold near 0 is a difference of O(n) numbers, so it also
  gets an absolute 1e-6·n;
* inside the port (E = 1 against the flat filter, the kernel path against
  the plain path, a chunk against its sequential steps): bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro.core import sketch as jsk  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.stream.runner import StreamRunner as JRunner  # noqa: E402
from repro.window import ring as jring  # noqa: E402
from repro.window.filter import WindowedAceFilter as JFilter  # noqa: E402
from repro_torch.core import sketch as sk  # noqa: E402
from repro_torch.core.convert import (params_from_numpy,  # noqa: E402
                                      tree_from_numpy, state_to_numpy)
from repro_torch.data.pipeline import AceDataFilter  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.stream import runner as runner_mod  # noqa: E402
from repro_torch.stream.runner import StreamRunner  # noqa: E402
from repro_torch.window import ring  # noqa: E402
from repro_torch.window.filter import WindowedAceFilter  # noqa: E402
from repro_torch.window.ring import WindowConfig  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

CPU = torch.device("cpu")
KW = dict(dim=10, num_bits=6, num_tables=8, seed=3, welford_min_n=8.0)
INT_LEAVES = ("counts", "n", "cursor", "tick")
D, B, T = 24, 16, 4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ids(rng, n, K=6, L=8):
    return rng.integers(0, 1 << K, size=(n, L)).astype(np.int32)


def assert_window(ps, js, gamma, welford_rtol=1e-6):
    """Every leaf of a port ring (or windowed fleet) against the
    reference's, at the tolerances of the module docstring."""
    got = state_to_numpy(ps)
    for k, v in got.items():
        want = np.asarray(getattr(js, k))
        assert v.dtype == want.dtype and v.shape == want.shape, k
        if k in INT_LEAVES or (gamma == 1.0 and k in ("tail", "ssq")):
            np.testing.assert_array_equal(v, want, err_msg=k)
        else:
            rtol = welford_rtol if k.startswith("welford") else 1e-6
            np.testing.assert_allclose(v, want, rtol=rtol, atol=0,
                                       err_msg=k)


def _ring_sequence(gamma, steps=25, E=4, R=3, seed=0):
    """The same masked inserts and eager clock through both packages."""
    jcfg, cfg = jsk.AceConfig(**KW), sk.AceConfig(**KW)
    rng = np.random.default_rng(seed)
    js, ps = jring.init(jcfg, E), ring.init(cfg, E, CPU)
    for _ in range(steps):
        b = _ids(rng, 9)
        m = rng.uniform(size=9) < 0.6
        js = jring.maybe_rotate(jring.insert_current(
            js, jnp.asarray(b), jnp.asarray(m), jcfg, gamma=gamma), R, gamma)
        ps = ring.maybe_rotate(ring.insert_current(
            ps, _t(b), _t(m), cfg, gamma=gamma), R, gamma)
    return cfg, js, ps, rng


class TestRingAlgebra:
    @pytest.mark.parametrize("gamma", [1.0, 0.7])
    def test_ring_sequence_matches_reference(self, gamma):
        """25 masked inserts with a rotation every 3: every leaf."""
        _, js, ps, _ = _ring_sequence(gamma)
        assert_window(ps, js, gamma)

    @pytest.mark.parametrize("gamma", [1.0, 0.7])
    def test_tail_and_ssq_match_direct_recompute(self, gamma):
        """The maintained tail (Σ_{e≠cur} γ^age C_e) and ssq (‖C_w‖²)
        equal a recompute from the epochs: bitwise at γ = 1, rtol 1e-5 at
        γ < 1 (the maintained ssq adds increments, the recompute squares
        a decayed sum)."""
        _, _, ps, _ = _ring_sequence(gamma)
        dc = ring.decayed_counts(ps, gamma)
        want_tail = dc - ring.live_epoch(ps).counts.to(torch.float32)
        want_ssq = torch.sum(dc * dc)
        if gamma == 1.0:
            assert torch.equal(ps.tail, want_tail)
            assert torch.equal(ps.ssq, want_ssq)
        else:
            torch.testing.assert_close(ps.tail, want_tail, rtol=1e-5,
                                       atol=1e-4)
            torch.testing.assert_close(ps.ssq, want_ssq, rtol=1e-5, atol=0)

    def test_rotate_pow_E_is_zeroed_ring(self):
        cfg = sk.AceConfig(**KW)
        rng = np.random.default_rng(1)
        st = ring.init(cfg, 3, CPU)
        for _ in range(4):
            st = ring.insert_current(st, _t(_ids(rng, 7)),
                                     torch.ones(7, dtype=torch.bool), cfg)
        for _ in range(3):
            st = ring.rotate(st)
        assert int(st.cursor) == 0 and int(st.tick) == 4
        for k in ("counts", "n", "welford_mean", "welford_m2", "tail",
                  "ssq"):
            assert float(getattr(st, k).abs().sum()) == 0.0, k

    def test_hard_window_equals_merge_of_epochs(self):
        """γ = 1, one batch per epoch: the window is ``sketch.merge`` of
        the epochs — scores, μ and n bitwise."""
        cfg = sk.AceConfig(**KW)
        rng = np.random.default_rng(2)
        st = ring.init(cfg, 3, CPU)
        for e in range(3):
            st = ring.insert_current(st, _t(_ids(rng, 7)),
                                     torch.ones(7, dtype=torch.bool), cfg)
            if e < 2:
                st = ring.rotate(st)
        acc = ring.combined_ace(st)
        q = _t(_ids(rng, 5))
        assert torch.equal(ring.score_windowed(st, q, 1.0),
                           sk.batch_scores(acc.counts, q))
        assert torch.equal(ring.mean_mu_windowed(st, 1.0), sk.mean_mu(acc))
        assert torch.equal(ring.combined_n(st, 1.0), acc.n)

    @pytest.mark.parametrize("gamma", [1.0, 0.5])
    def test_score_hot_path_matches_eway_reference(self, gamma):
        """tail + live scoring ≡ the E-way combine at the ring's own γ:
        bitwise at γ = 1, rtol 1e-5 at γ < 1 (as the reference)."""
        cfg, _, ps, rng = _ring_sequence(gamma, steps=9, R=2)
        q = _t(_ids(rng, 11))
        hot = ring.score_combined(ps, q)
        ref = ring.score_windowed(ps, q, gamma)
        if gamma == 1.0:
            assert torch.equal(hot, ref)
        else:
            torch.testing.assert_close(hot, ref, rtol=1e-5, atol=0)

    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("gamma", [1.0, 0.7])
    def test_statistics_match_reference(self, gamma, masked):
        """Weights, combined n and moments, μ, σ, threshold, decayed
        counts, epoch sums, the live epoch and the windowed scores, on
        the reference's own state carried across."""
        _, js, _, rng = _ring_sequence(gamma, steps=14)
        ps = tree_from_numpy(ring.WindowedAceState, js, CPU)
        mask = np.ones(8, np.float32)
        if masked:
            mask[[2, 5]] = 0.0
        jm, pm = (jnp.asarray(mask), _t(mask)) if masked else (None, None)
        q = _ids(rng, 13)
        pairs = [
            (ring.epoch_weights(ps.cursor, 4, gamma),
             jring.epoch_weights(js.cursor, 4, gamma)),
            (ring.combined_n(ps, gamma), jring.combined_n(js, gamma)),
            (ring.mean_mu_windowed(ps, gamma, pm),
             jring.mean_mu_windowed(js, gamma, jm)),
            (ring.sigma_windowed(ps, gamma),
             jring.sigma_windowed(js, gamma)),
            (ring.decayed_counts(ps, gamma),
             jring.decayed_counts(js, gamma)),
            (ring.epoch_table_sums(ps, _t(q)),
             jring.epoch_table_sums(js, jnp.asarray(q))),
            (ring.score_windowed(ps, _t(q), gamma),
             jring.score_windowed(js, jnp.asarray(q), gamma)),
            (ring.score_live(*ring.window_table_sums(ps, _t(q), pm), 8, pm),
             jring.score_live(*jring.window_table_sums(js, jnp.asarray(q),
                                                       jm), 8, jm)),
            *zip(ring.combined_moments(ps, gamma),
                 jring.combined_moments(js, gamma)),
            *zip(ring.live_epoch(ps), jring.live_epoch(js)[:4])]
        for i, (got, want) in enumerate(pairs):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=0, err_msg=str(i))
        n = float(jring.combined_n(js, gamma))
        np.testing.assert_allclose(
            float(ring.admit_threshold_windowed(ps, gamma, 2.0, 10.0,
                                                table_mask=pm)),
            float(jring.admit_threshold_windowed(js, gamma, 2.0, 10.0,
                                                 table_mask=jm)),
            rtol=1e-6, atol=1e-6 * n)

    def test_window_config_validation(self):
        cfg = sk.AceConfig(**KW)
        with pytest.raises(ValueError, match="num_epochs"):
            WindowConfig(ace=cfg, num_epochs=0)
        with pytest.raises(ValueError, match="decay"):
            WindowConfig(ace=cfg, decay=1.5)
        with pytest.raises(ValueError, match="decay"):
            WindowConfig(ace=cfg, decay=0.0)
        qh = ring.init(cfg, 2, CPU, quantile=True).qhist
        np.testing.assert_array_equal(
            qh.numpy(), np.asarray(jring.init(jsk.AceConfig(**KW), 2,
                                              quantile=True).qhist))
        assert ring.init(cfg, 2, CPU).qhist is None
        assert WindowConfig(ace=cfg, num_epochs=3).memory_bytes() == \
            jring.WindowConfig(ace=jsk.AceConfig(**KW),
                               num_epochs=3).memory_bytes()


# ---------------------------------------------------------------------------
# The filter.
# ---------------------------------------------------------------------------

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


def _pair(use_kernels=True, **kw):
    kw = {**dict(d_model=D, num_bits=6, num_tables=8, alpha=1.0,
                 warmup_items=40.0, num_epochs=3), **kw}
    jf = JFilter(**kw)
    pf = WindowedAceFilter(**kw, use_kernels=use_kernels, device="cpu")
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


class TestWindowedFilter:
    @pytest.mark.parametrize("use_kernels", [True, False])
    @pytest.mark.parametrize("gamma", [1.0, 0.8])
    @pytest.mark.parametrize("insert_all", [False, True])
    def test_step_matches_reference(self, insert_all, gamma, use_kernels):
        """Eight steps through warmup and past it, with the eager clock
        every 2 steps and a NaN row in each: keep masks, margins and
        every leaf."""
        jf, pf, (js, jw), (ps, pw) = _pair(use_kernels, decay=gamma,
                                           insert_all=insert_all)
        for f in _features(8, burst_from=5):
            js, jk, jm = jf.step(js, jw, jnp.asarray(f))
            ps, pk, pm = pf.step(ps, pw, _t(f))
            np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
            _assert_margins(pm.numpy(), jm, jnp.sum(js.n))
            assert np.isneginf(pm.numpy()).sum() == 1     # the NaN row
            js = jring.maybe_rotate(js, 2, gamma)
            ps = ring.maybe_rotate(ps, 2, gamma)
        assert_window(ps, js, gamma)

    def test_call_matches_reference(self):
        """``__call__`` (step + the eager clock) on (B, S, D) embeddings."""
        jf, pf, (js, jw), (ps, pw) = _pair(rotate_every=2,
                                           warmup_items=20.0)
        rng = np.random.default_rng(3)
        for i in range(5):
            e = (rng.normal(size=(B, 3, D)) * 0.3 + 1.0).astype(np.float32)
            if i == 4:
                e[:4] = rng.normal(size=(4, 3, D)) * 4.0
            m = np.ones((B, 3), np.float32)
            js, jm, jfrac = jf(js, jw, jnp.asarray(e), jnp.asarray(m))
            ps, pm, pfrac = pf(ps, pw, _t(e), _t(m))
            np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
            assert float(pfrac) == float(jfrac)
        assert int(ps.cursor) == 2 and int(ps.tick) == 5
        assert_window(ps, js, 1.0)

    @pytest.mark.parametrize("use_kernels", [True, False])
    def test_single_epoch_is_the_flat_filter_bitwise(self, use_kernels):
        """E = 1 ≡ the port's ``AceDataFilter``: keep masks, margins,
        counts, n and the Welford stream bitwise."""
        kw = dict(d_model=D, num_bits=6, num_tables=8, alpha=1.0,
                  warmup_items=40.0, use_kernels=use_kernels, device="cpu")
        wf = WindowedAceFilter(**kw, num_epochs=1, decay=0.7)
        ff = AceDataFilter(**kw)
        ws, w = wf.init()
        fs, fw_ = ff.init()
        assert torch.equal(w, fw_)
        for f in _features(8, burst_from=5):
            ws, wk, wm = wf.step(ws, w, _t(f))
            fs, fk, fm = ff.step(fs, w, _t(f))
            assert torch.equal(wk, fk) and torch.equal(wm, fm)
        assert torch.equal(ws.counts[0], fs.counts)
        for k in ("n", "welford_mean", "welford_m2"):
            assert torch.equal(getattr(ws, k)[0], getattr(fs, k)), k
        assert torch.equal(ws.ssq, torch.sum(fs.counts.float() ** 2))

    @pytest.mark.parametrize("insert_all", [False, True])
    def test_kernel_and_plain_paths_agree(self, insert_all):
        """The two paths of the port, degraded steps included: every leaf
        bitwise."""
        _, pk_f, _, (sk_, w) = _pair(True, decay=0.8, insert_all=insert_all)
        _, pp_f, _, (sp, _) = _pair(False, decay=0.8, insert_all=insert_all)
        mask = torch.ones(8)
        mask[3] = 0.0
        for i, f in enumerate(_features(8, burst_from=5)):
            tm = mask if i % 3 == 2 else None
            sk_, kk, mk = pk_f.step(sk_, w, _t(f), table_mask=tm)
            sp, kp, mp = pp_f.step(sp, w, _t(f), table_mask=tm)
            assert torch.equal(kk, kp) and torch.equal(mk, mp), i
            sk_, sp = ring.maybe_rotate(sk_, 2, 0.8), \
                ring.maybe_rotate(sp, 2, 0.8)
        for a, b in zip(sk_, sp):
            if a is not None:
                assert torch.equal(a, b)

    def test_masked_decision_scores_over_healthy_tables(self):
        """Under a table mask the decision divides the unmasked sums by
        the healthy count and takes the masked threshold (the reference's
        ``WindowedAceFilter.step``); the insert keeps the unmasked sums
        for ssq."""
        _, pf, _, (s, w) = _pair(True, warmup_items=8.0)
        for f in _features(3):
            s, _, _ = pf.step(s, w, _t(f))
        mask = torch.ones(8)
        mask[[0, 4]] = 0.0
        f = _t(_features(1, seed=9)[0])
        finite = torch.isfinite(f).all(-1)
        feat = torch.where(finite[:, None], f, 0.0)
        from repro_torch.core.srp import hash_buckets
        b = hash_buckets(feat, w, pf.ace_cfg.srp)
        want = ring.score_live(*ring.window_table_sums(s, b), 8, mask) \
            - ring.admit_threshold_windowed(s, 1.0, 1.0, 8.0,
                                            table_mask=mask)
        _, _, margin = pf.step(s, w, f, table_mask=mask)
        assert torch.equal(margin[finite], want[finite])

    @pytest.mark.parametrize("use_kernels", [True, False])
    @pytest.mark.parametrize("gamma", [1.0, 0.8])
    @pytest.mark.parametrize("insert_all", [False, True])
    def test_masked_step_matches_reference(self, insert_all, gamma,
                                           use_kernels):
        """Degraded steps (every other step under a two-table mask, past
        warmup, with the eager clock every 2 steps) against the
        reference's ``step``: keep masks, margins and every leaf, at the
        module docstring's tolerances."""
        jf, pf, (js, jw), (ps, pw) = _pair(use_kernels, decay=gamma,
                                           insert_all=insert_all,
                                           warmup_items=16.0)
        mask = np.ones(8, np.float32)
        mask[[1, 6]] = 0.0
        for i, f in enumerate(_features(8, burst_from=4)):
            jm, pm = ((jnp.asarray(mask), _t(mask)) if i % 2
                      else (None, None))
            js, jk, jmar = jf.step(js, jw, jnp.asarray(f), table_mask=jm)
            ps, pk, pmar = pf.step(ps, pw, _t(f), table_mask=pm)
            np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
            _assert_margins(pmar.numpy(), jmar, jnp.sum(js.n))
            js = jring.maybe_rotate(js, 2, gamma)
            ps = ring.maybe_rotate(ps, 2, gamma)
        assert_window(ps, js, gamma)

    def test_bad_options_raise(self):
        with pytest.raises(ValueError, match="threshold_mode"):
            WindowedAceFilter(d_model=8, device="cpu",
                              threshold_mode="median")
        qf = WindowedAceFilter(d_model=8, device="cpu",
                               threshold_mode="quantile", num_epochs=3)
        np.testing.assert_array_equal(
            qf.init()[0].qhist.numpy(),
            np.asarray(JFilter(d_model=8, threshold_mode="quantile",
                               num_epochs=3).init()[0].qhist))
        with pytest.raises(ValueError, match="decay"):
            WindowedAceFilter(d_model=8, device="cpu", decay=2.0)
        with pytest.raises(ValueError, match="num_epochs"):
            WindowedAceFilter(d_model=8, device="cpu", num_epochs=0)


# ---------------------------------------------------------------------------
# The stream runner with rotation.
# ---------------------------------------------------------------------------

EXACT = ("kept_frac", "anom_counts", "topk_step", "topk_item", "n",
         "quarantined", "degraded", "topk_valid")


class TestWindowedStreamRunner:
    @pytest.mark.parametrize("use_kernels", [True, False])
    @pytest.mark.parametrize("R,gamma", [(2, 1.0), (8, 0.8)])
    def test_run_matches_reference(self, R, gamma, use_kernels):
        """Four chunks of T = 4, rotating inside (R = 2) or between
        (R = 8) chunks: summaries and every leaf."""
        jf, pf, (js, jw), (ps, pw) = _pair(use_kernels, decay=gamma,
                                           rotate_every=R)
        feats = _features(4 * T, burst_from=2 * T)
        js, jsum = JRunner(jf, T).run(js, jw, feats)
        ps, psum = StreamRunner(pf, T).run(ps, pw, feats)
        assert_window(ps, js, gamma)
        assert len(psum) == len(jsum) == 4
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

    @pytest.mark.parametrize("use_kernels", [True, False])
    def test_masked_consume_matches_reference(self, use_kernels):
        """A healthy chunk, then a degraded one under a table mask, with
        rotation inside the chunk (R = 2): summaries and every leaf."""
        jf, pf, (js, jw), (ps, pw) = _pair(use_kernels, decay=0.8,
                                           rotate_every=2,
                                           warmup_items=16.0)
        jr, pr = JRunner(jf, T), StreamRunner(pf, T)
        mask = np.ones(8, np.float32)
        mask[[0, 5]] = 0.0
        feats = _features(2 * T, burst_from=T)
        for c, m in enumerate((None, mask)):
            chunk = np.stack(feats[c * T:(c + 1) * T])
            js, jsum = jr.consume(js, jw, jnp.asarray(chunk),
                                  table_mask=None if m is None
                                  else jnp.asarray(m))
            ps, psum = pr.consume(ps, pw, _t(chunk),
                                  table_mask=None if m is None else _t(m))
            for f in EXACT:
                np.testing.assert_array_equal(
                    getattr(psum, f).numpy(), np.asarray(getattr(jsum, f)),
                    err_msg=f)
            _assert_margins(psum.topk_margin.numpy(), jsum.topk_margin,
                            jsum.n)
        assert_window(ps, js, 0.8)

    @pytest.mark.parametrize("R", [2, 4, 8])
    def test_chunk_equals_sequential_with_rotation(self, R):
        """``consume`` ≡ T sequential steps with the eager clock after
        each: every leaf bitwise, cursor and tick included."""
        _, pf, _, (s0, w) = _pair(decay=0.9, rotate_every=R)
        feats = _features(4 * T, burst_from=2 * T)
        runner = StreamRunner(pf, T, return_masks=True)
        sc, ck = s0, []
        for c in range(4):
            sc, _, keeps = runner.consume(
                sc, w, _t(np.stack(feats[c * T:(c + 1) * T])))
            ck.append(keeps)
        ss = pf.init()[0]
        sk_ = []
        for f in feats:
            ss, k, _ = pf.step(ss, w, _t(f))
            ss = ring.maybe_rotate(ss, R, 0.9)
            sk_.append(k)
        for a, b in zip(sc, ss):
            if a is not None:
                assert torch.equal(a, b)
        assert torch.equal(torch.cat(ck), torch.stack(sk_))
        assert int(sc.cursor) == (16 // R) % 3 and int(sc.tick) == 16

    def test_one_transfer_each_way_per_chunk(self, monkeypatch):
        h2d, d2h = [], []
        real_in, real_out = runner_mod._to_device, runner_mod._to_host
        monkeypatch.setattr(runner_mod, "_to_device",
                            lambda x, d: h2d.append(x.shape)
                            or real_in(x, d))
        monkeypatch.setattr(runner_mod, "_to_host",
                            lambda x: d2h.append(tuple(x.shape))
                            or real_out(x))
        _, pf, _, (s, w) = _pair(rotate_every=2)
        s, sums = StreamRunner(pf, T).run(s, w, _features(3 * T + 1))
        assert len(sums) == 3
        assert h2d == [(T, B, D + 1)] * 3
        assert len(d2h) == 3 and len(set(d2h)) == 1

    def test_summary_n_is_ring_total(self):
        _, pf, _, (s, w) = _pair(rotate_every=2)
        runner = StreamRunner(pf, T)
        s, summary = runner.consume(s, w, _t(np.stack(_features(T))))
        host = runner.fetch(summary)
        assert host.n.shape == () and float(host.n) == float(s.n.sum())
        assert int(s.cursor) == 2

    def test_bad_rotate_every_raises(self):
        _, pf, _, _ = _pair()
        with pytest.raises(ValueError, match="divide"):
            StreamRunner(pf, 4, rotate_every=3)
        flat = AceDataFilter(d_model=D, device="cpu")
        with pytest.raises(ValueError, match="windowed filter"):
            StreamRunner(flat, 4, rotate_every=2)


# ---------------------------------------------------------------------------
# The windowed guardrail and the arbitrary-γ query op.
# ---------------------------------------------------------------------------

def _batches(n, seed=11, b=16, s=3, d=12):
    """Request embeddings around a few directions, one NaN row each."""
    rng = np.random.default_rng(seed)
    topics = rng.normal(size=(3, d))
    for i in range(n):
        e = topics[rng.integers(0, 3, b)][:, None, :] \
            + 0.3 * rng.normal(size=(b, s, d))
        if i >= n // 2:
            k = 2 * (i - n // 2) + 2
            e[:k] = rng.normal(size=(k, s, d)) * 3.0
        e[i % b, i % s, 0] = np.nan
        yield e.astype(np.float32)


GCFG = dict(d_model=12, num_bits=6, num_tables=8, warmup_items=32.0,
            alpha=2.0, window_epochs=3, rotate_every=2)


class TestWindowedGuardrail:
    @pytest.mark.parametrize("gamma", [1.0, 0.8])
    @pytest.mark.parametrize("port_kernels,jax_kernels",
                             [(True, True), (False, False)])
    def test_admit_matches_reference(self, port_kernels, jax_kernels, gamma):
        """Ten admits over five rotations, each with a NaN row; the
        reference runs its kernel path with Pallas in interpret mode."""
        gcfg = {**GCFG, "window_decay": gamma}
        gj = jengine.Guardrail(jengine.GuardrailConfig(**gcfg),
                               use_kernels=jax_kernels)
        gp = engine.Guardrail(engine.GuardrailConfig(**gcfg),
                              use_kernels=port_kernels, device="cpu",
                              w=params_from_numpy(np.asarray(gj.w), CPU))
        for e in _batches(10):
            np.testing.assert_array_equal(gp.admit(e),
                                          np.asarray(gj.admit(
                                              jnp.asarray(e))))
        assert gp.quarantined == gj.quarantined == 10
        assert_window(gp.state, gj.state, gamma)
        assert int(gp.state.cursor) == 5 % 3

    @pytest.mark.parametrize("use_kernels", [True, False])
    def test_clock_follows_reference_every_admit(self, use_kernels):
        """The eager epoch clock after every admit: tick and cursor
        exact, the ring rotating on the admit that fills an epoch."""
        gj = jengine.Guardrail(jengine.GuardrailConfig(**GCFG))
        gp = engine.Guardrail(engine.GuardrailConfig(**GCFG),
                              use_kernels=use_kernels, device="cpu",
                              w=params_from_numpy(np.asarray(gj.w), CPU))
        for i, e in enumerate(_batches(7)):
            gp.admit(e)
            gj.admit(jnp.asarray(e))
            assert int(gp.state.tick) == int(gj.state.tick) == i + 1
            assert int(gp.state.cursor) == int(gj.state.cursor) \
                == (i + 1) // 2 % 3

    def test_recovers_from_traffic_shift(self):
        """The reference's traffic-shift test: the frozen guardrail keeps
        rejecting the new regime, the windowed one re-admits it once the
        stale epochs expire."""
        common = dict(d_model=12, num_bits=8, num_tables=16,
                      warmup_items=64.0, alpha=2.0)
        frozen = engine.Guardrail(engine.GuardrailConfig(**common),
                                  device="cpu")
        windowed = engine.Guardrail(engine.GuardrailConfig(
            **common, window_epochs=3, rotate_every=6), device="cpu")
        rng = np.random.default_rng(12)
        mu_a = np.zeros(12)
        mu_a[:6] = 3.0
        mu_b = np.zeros(12)
        mu_b[6:] = 3.0

        def batch(mu):
            return (rng.normal(size=(16, 4, 12)) * 0.3 + mu) \
                .astype(np.float32)
        fa, wa = [], []
        for _ in range(20):
            fa.append(frozen.admit(batch(mu_a)).mean())
            wa.append(windowed.admit(batch(mu_a)).mean())
        assert np.mean(fa[-5:]) > 0.8 and np.mean(wa[-5:]) > 0.7
        fb, wb = [], []
        for _ in range(30):
            fb.append(frozen.admit(batch(mu_b)).mean())
            wb.append(windowed.admit(batch(mu_b)).mean())
        assert np.mean(fb[-5:]) < 0.2, fb
        assert np.mean(wb[-5:]) > 0.8, wb

    def test_rotate_every_required(self):
        with pytest.raises(ValueError, match="rotate_every"):
            engine.Guardrail(engine.GuardrailConfig(
                d_model=8, window_epochs=2), device="cpu")


class TestWindowScoreOp:
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("gamma", [1.0, 0.6])
    def test_matches_reference_op(self, gamma, masked):
        """``ops.ace_window_score`` (the ``ace_window_combine`` kernel's
        plain version here) against the reference's, whose Pallas kernel
        runs in interpret mode: rtol 1e-6 (bitwise at γ = 1)."""
        _, js, _, rng = _ring_sequence(gamma, steps=12)
        ps = tree_from_numpy(ring.WindowedAceState, js, CPU)
        q = _ids(rng, 21)
        mask = np.ones(8, np.float32)
        mask[[1, 6]] = 0.0
        jm, pm = (jnp.asarray(mask), _t(mask)) if masked else (None, None)
        got = ops.ace_window_score(ps, _t(q), gamma, table_mask=pm).numpy()
        want = np.asarray(jops.ace_window_score(js, jnp.asarray(q), gamma,
                                                table_mask=jm))
        if gamma == 1.0 and not masked:
            np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        if not masked:
            np.testing.assert_allclose(
                got, ring.score_windowed(ps, _t(q), gamma).numpy(),
                rtol=1e-6, atol=0)

    @pytest.mark.parametrize("gamma", [1.0, 0.8])
    def test_admit_op_matches_reference_op(self, gamma):
        """``ops.ace_admit_windowed`` with its own epoch clock (the
        device-side ``maybe_rotate`` select) against the reference's
        kernel-path op over six admissions and three rotations."""
        jcfg, cfg = jsk.AceConfig(**KW), sk.AceConfig(**KW)
        jw = jsk.make_params(jcfg)
        w = params_from_numpy(np.asarray(jw), CPU)
        rng = np.random.default_rng(11)
        js, ps = jring.init(jcfg, 3), ring.init(cfg, 3, CPU)
        for _ in range(6):
            q = (rng.normal(size=(16, 10)) + 1.0).astype(np.float32)
            item = rng.random(16) < 0.9
            js, ja = jops.ace_admit_windowed(
                js, jnp.asarray(q), jw, jcfg, gamma=gamma, alpha=2.0,
                warmup_items=16.0, rotate_every=2,
                item_mask=jnp.asarray(item))
            ps, pa = ops.ace_admit_windowed(
                ps, _t(q), w, cfg, gamma=gamma, alpha=2.0,
                warmup_items=16.0, rotate_every=2, item_mask=_t(item))
            np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
        assert_window(ps, js, gamma)
        assert int(ps.cursor) == 0 and int(ps.tick) == 6

    def test_state_round_trips_through_numpy(self):
        _, js, ps, _ = _ring_sequence(0.7, steps=6)
        back = tree_from_numpy(ring.WindowedAceState,
                               state_to_numpy(ps).values(), CPU)
        for a, b in zip(back, ps):
            if b is not None:
                assert torch.equal(a, b)
