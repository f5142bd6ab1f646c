"""The port's quantile-calibrated admission (``repro_torch.quantile.sketch``
and ``threshold_mode="quantile"`` through every state, ``ops`` admission,
filter and ``Guardrail`` flavour) against the reference's
(``repro.quantile.sketch`` and its drivers) on the same numpy-made inputs,
the same JAX-drawn W and reference states carried across
(``core/convert.py``), on the CPU, where every kernel wrapper takes its
plain version and the reference's kernel path runs Pallas in interpret
mode.

Tolerances:
* bin ids and unit-weight histograms: bitwise.  A rate within an ulp of a
  bin edge may land one bin over if the two packages' ``log`` differ by an
  ulp; ``assert_bins`` allows ±1 bin there, and only where the rate lies
  within 4 ulp of an edge;
* counts, n, cursors, ticks, keep/admit masks, ``qhist``: bitwise;
* ``hist_quantile`` of a weighted (non-integer) histogram, thresholds,
  Welford streams and γ < 1 window views: rtol 1e-6 (cumulative and
  batch sums in PyTorch's order here, XLA's there), thresholds and margins
  with an absolute 1e-6·n;
* inside the port (E = 1 against the flat filter, fleet scatter against
  per-tenant flat, the reference's algebraic contracts): bitwise.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro.attribution.sketch import _level_tables_np  # noqa: E402
from repro.core import sketch as jsk  # noqa: E402
from repro.data.pipeline import AceDataFilter as JFlat  # noqa: E402
from repro.fleet import FleetDataFilter as JFleet  # noqa: E402
from repro.fleet import state as jfl  # noqa: E402
from repro.fleet import window as jfw  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.quantile import sketch as jq  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.stream.runner import StreamRunner as JRunner  # noqa: E402
from repro.window import ring as jring  # noqa: E402
from repro.window.filter import WindowedAceFilter as JWin  # noqa: E402
from repro_torch import ROADMAP_QUEUE_1  # noqa: E402
from repro_torch.core import sketch as sk  # noqa: E402
from repro_torch.core.convert import (  # noqa: E402
    attr_tables_from_numpy, params_from_numpy, state_from_numpy,
    state_to_numpy, tree_from_numpy)
from repro_torch.data.pipeline import AceDataFilter  # noqa: E402
from repro_torch.fleet import state as fl  # noqa: E402
from repro_torch.fleet import window as fw  # noqa: E402
from repro_torch.fleet.filter import FleetDataFilter  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.quantile import sketch as qsk  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.stream import runner as runner_mod  # noqa: E402
from repro_torch.stream.runner import StreamRunner  # noqa: E402
from repro_torch.window import ring  # noqa: E402
from repro_torch.window.filter import WindowedAceFilter  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
NB = qsk.NUM_BINS
KW = dict(dim=10, num_bits=6, num_tables=8, seed=3, welford_min_n=8.0)
CFG, JCFG = sk.AceConfig(**KW), jsk.AceConfig(**KW)
QS = (0.001, 0.01, 0.02, 0.3, 0.5, 0.99, 1.0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rates(rng, n, kind):
    """Rate streams, float32: the reference's adversarial five
    (tests/test_quantile.py) and real ACE rates (k/L)/n."""
    if kind == 0:                                   # uniform
        r = rng.uniform(0.0, 1.0, n)
    elif kind == 1:                                 # constant (all ties)
        r = np.full(n, rng.uniform(0.0, 1.0))
    elif kind == 2:                                 # pre-sorted
        r = np.sort(rng.uniform(0.0, 1.0, n))
    elif kind == 3:                                 # heavy-tailed Pareto
        r = np.minimum(rng.pareto(1.1, n) * 1e-3, 1.2)
    elif kind == 4:                                 # lognormal, underflow
        r = np.minimum(rng.lognormal(-8.0, 4.0, n), 1.2)
    else:                                           # ACE: sum·f32(1/L) / n
        L = int(rng.choice([8, 32, 50]))
        tot = float(rng.choice([1, 97, 4096, 65536, 596853]))
        k = rng.integers(0, int(min(tot, 5000)) * L + 1, n)
        s = k.astype(np.float32) * np.float32(1.0 / L)
        return (s / np.float32(tot)).astype(np.float32)
    return r.astype(np.float32)


def assert_bins(got, want, rates):
    """Bin ids bitwise, but for ±1 bin where the rate lies within 4 ulp of
    an edge (the two packages' ``log`` may differ by an ulp there)."""
    got, want = np.asarray(got), np.asarray(want)
    bad = got != want
    if bad.any():
        r = np.asarray(rates, np.float32)[bad]
        gap = np.min(np.abs(qsk._EDGES_NP[None, :] - r[:, None]), axis=1)
        assert (np.abs(got[bad] - want[bad]) <= 1).all()
        assert (gap <= 4 * np.spacing(r)).all(), r[gap > 4 * np.spacing(r)]


def _np_hist(rates, mask=None):
    h = np.zeros(NB, np.float32)
    np.add.at(h, qsk.bin_index(_t(rates)).numpy(),
              np.ones(len(rates), np.float32) if mask is None else mask)
    return h


def _hist_cases():
    rng = np.random.default_rng(5)
    cases = {f"kind{k}": _np_hist(_rates(rng, 500, k)) for k in range(6)}
    w = rng.uniform(0.0, 3.0, NB).astype(np.float32)
    cases["weighted"] = (_np_hist(_rates(rng, 400, 0)) * w).astype(
        np.float32)
    cases["empty"] = np.zeros(NB, np.float32)
    for b in (0, 60, NB - 1):
        h = np.zeros(NB, np.float32)
        h[b] = 37.0
        cases[f"one_bin_{b}"] = h
    tail = _np_hist(_rates(rng, 300, 0))
    tail[NB - 1] += 900.0                # most mass in the overflow bin
    cases["overflow_tail"] = tail
    return cases


HISTS = _hist_cases()


# ---------------------------------------------------------------------------
# The sketch functions against the reference's.
# ---------------------------------------------------------------------------

class TestSketchFunctions:
    def test_constants_edges_and_init(self):
        for name in ("NUM_BINS", "RATE_MIN", "_RATIO", "_INV_LOG_RATIO"):
            assert getattr(qsk, name) == getattr(jq, name), name
        np.testing.assert_array_equal(qsk._EDGES_NP, jq._EDGES_NP)
        np.testing.assert_array_equal(qsk.bin_edges().numpy(),
                                      np.asarray(jq.bin_edges()))
        for lead in ((), (3,), (2, 4)):
            h = qsk.init_hist(*lead, device=CPU)
            assert h.dtype == torch.float32 and not h.any()
            assert tuple(h.shape) == tuple(jq.init_hist(*lead).shape)
        assert 7 not in ROADMAP_QUEUE_1

    @pytest.mark.parametrize("kind", range(6))
    def test_bin_index_matches_reference(self, kind):
        rng = np.random.default_rng(10 + kind)
        r = _rates(rng, 20000, kind)
        r[:3] = (0.0, qsk.RATE_MIN, 1.0)
        got = qsk.bin_index(_t(r))
        assert got.dtype == torch.int64
        assert_bins(got.numpy(), jq.bin_index(jnp.asarray(r)), r)

    @pytest.mark.parametrize("kind", range(6))
    def test_observe_rates_matches_reference(self, kind):
        rng = np.random.default_rng(20 + kind)
        r = _rates(rng, 3000, kind)
        m = (rng.uniform(size=r.size) < 0.7).astype(np.float32)
        h0 = _np_hist(_rates(rng, 50, 0))
        got = qsk.observe_rates(_t(h0), _t(r), _t(m))
        want = jq.observe_rates(jnp.asarray(h0), jnp.asarray(r),
                                jnp.asarray(m))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert float(got.sum()) == float(h0.sum() + m.sum())

    @pytest.mark.parametrize("T", [1, 3, 5])
    def test_observe_rates_fleet_matches_reference(self, T):
        rng = np.random.default_rng(30 + T)
        r = _rates(rng, 2000, 5)
        tids = rng.integers(0, T, r.size).astype(np.int32)
        m = (rng.uniform(size=r.size) < 0.8).astype(np.float32)
        got = qsk.observe_rates_fleet(qsk.init_hist(T, device=CPU), _t(r),
                                      _t(tids), _t(m))
        want = jq.observe_rates_fleet(jq.init_hist(T), jnp.asarray(r),
                                      jnp.asarray(tids), jnp.asarray(m))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("warmup", [0.0, 64.0, 513.0])
    def test_calib_mask_matches_reference(self, warmup):
        rng = np.random.default_rng(3)
        m = (rng.uniform(size=40) < 0.9).astype(np.float32)
        for n in (np.float32(0.0), np.float32(warmup / 2),
                  np.float32(warmup / 2 - 1),
                  rng.integers(0, 600, 40).astype(np.float32)):
            got = qsk.calib_mask(_t(m), _t(np.asarray(n)), warmup)
            want = jq.calib_mask(jnp.asarray(m), jnp.asarray(n), warmup)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("name", sorted(HISTS))
    def test_hist_quantile_matches_reference(self, name):
        """Every q, one histogram at a time and all of them batched (the
        fleet's rows) against the reference's per-row ``vmap``: bitwise
        on unit-weight histograms, rtol 1e-6 on the weighted one."""
        h = HISTS[name]
        got = np.array([float(qsk.hist_quantile(_t(h), q)) for q in QS])
        want = np.array([float(jq.hist_quantile(jnp.asarray(h), q))
                         for q in QS])
        if name == "weighted":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(got, want)

    def test_batched_hist_quantile_matches_reference_vmap(self):
        """All the histograms as one (N, NUM_BINS) stack (the fleet's rows)
        against the reference's per-row ``vmap``."""
        stack = np.stack(list(HISTS.values()))
        for q in (0.01, 0.5):
            np.testing.assert_allclose(
                qsk.hist_quantile(_t(stack), q).numpy(),
                np.asarray(jax.vmap(lambda x: jq.hist_quantile(x, q))(
                    jnp.asarray(stack))), rtol=1e-6, atol=0)

    def test_quantile_threshold_matches_reference(self):
        stack = np.stack([HISTS["kind0"], HISTS["kind5"], HISTS["empty"]])
        n = np.array([3.0, 700.0, 900.0], np.float32)
        for warmup in (0.0, 512.0, 1000.0):
            got = qsk.quantile_threshold(_t(stack), _t(n), 0.02, warmup)
            want = jax.vmap(lambda h, m: jq.quantile_threshold(
                h, m, 0.02, warmup))(jnp.asarray(stack), jnp.asarray(n))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=0)
            assert np.isneginf(got.numpy()[n < warmup]).all()


# ---------------------------------------------------------------------------
# The reference's algebraic contracts, on the port.
# ---------------------------------------------------------------------------

class TestContracts:
    @pytest.mark.parametrize("seed", range(4))
    def test_merge_commutative_associative_and_split_invariant(self, seed):
        rng = np.random.default_rng(seed)
        kind = seed % 6
        rs = [_rates(rng, int(rng.integers(1, 200)), kind) for _ in range(3)]
        a, b, c = (qsk.observe_rates(qsk.init_hist(device=CPU), _t(r),
                                     torch.ones(r.size)) for r in rs)
        assert torch.equal(qsk.merge_hists(a, b), qsk.merge_hists(b, a))
        assert torch.equal(qsk.merge_hists(qsk.merge_hists(a, b), c),
                           qsk.merge_hists(a, qsk.merge_hists(b, c)))
        allr = np.concatenate(rs)
        whole = qsk.observe_rates(qsk.init_hist(device=CPU), _t(allr),
                                  torch.ones(allr.size))
        assert torch.equal(whole, qsk.merge_hists(qsk.merge_hists(a, b), c))

    @pytest.mark.parametrize("seed", range(4))
    def test_masked_scatter_equals_dense_subset(self, seed):
        rng = np.random.default_rng(seed)
        r = _rates(rng, int(rng.integers(1, 300)), seed % 6)
        mask = (rng.uniform(size=r.size) < 0.6).astype(np.float32)
        fixed = qsk.observe_rates(qsk.init_hist(device=CPU), _t(r),
                                  _t(mask))
        sub = r[mask > 0]
        dense = qsk.observe_rates(qsk.init_hist(device=CPU), _t(sub),
                                  torch.ones(sub.size))
        assert torch.equal(fixed, dense)
        assert float(fixed.sum()) == float(mask.sum())

    @pytest.mark.parametrize("seed,T", [(0, 1), (1, 3), (2, 5)])
    def test_fleet_scatter_equals_per_tenant_flat(self, seed, T):
        rng = np.random.default_rng(seed)
        r = _rates(rng, 300, 0)
        tids = rng.integers(0, T, r.size).astype(np.int32)
        mask = (rng.uniform(size=r.size) < 0.8).astype(np.float32)
        fleet = qsk.observe_rates_fleet(qsk.init_hist(T, device=CPU), _t(r),
                                        _t(tids), _t(mask))
        for t in range(T):
            sel = tids == t
            flat = qsk.observe_rates(qsk.init_hist(device=CPU), _t(r[sel]),
                                     _t(mask[sel]))
            assert torch.equal(fleet[t], flat)

    @pytest.mark.parametrize("seed,E,gamma", [(0, 2, 1.0), (1, 3, 0.7),
                                              (2, 4, 0.55), (3, 4, 1.0)])
    def test_rotate_then_merge_equals_windowed_combine(self, seed, E, gamma):
        """The rows against a numpy ring, the γ-combine against the
        oracle (bitwise at γ = 1) and against the reference's on the same
        state carried across (rtol 1e-6)."""
        rng = np.random.default_rng(seed)
        state = ring.init(CFG, E, CPU, quantile=True)
        ref = [np.zeros(NB, np.float32) for _ in range(E)]
        cursor = 0
        for _ in range(8):
            B = int(rng.integers(4, 32))
            r = _rates(rng, B, int(rng.integers(0, 6)))
            mask = (rng.uniform(size=B) < 0.9).astype(np.float32)
            state = ring.observe_current(state, _t(r), _t(mask))
            ref[cursor] += _np_hist(r, mask)
            if rng.integers(0, 2):
                state = ring.rotate(state, gamma)
                cursor = (cursor + 1) % E
                ref[cursor] = np.zeros(NB, np.float32)
        expect = sum(np.float32(gamma) ** ((cursor - e) % E) * ref[e]
                     for e in range(E))
        got = ring.combined_qhist(state, gamma).numpy()
        if gamma == 1.0:
            np.testing.assert_array_equal(got, expect.astype(np.float32))
        else:
            np.testing.assert_allclose(got, expect, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(state.qhist.numpy(), np.stack(ref))
        js = jring.WindowedAceState(**{
            k: jnp.asarray(v) for k, v in state_to_numpy(state).items()})
        np.testing.assert_allclose(
            got, np.asarray(jring.combined_qhist(js, gamma)), rtol=1e-6,
            atol=0)

    def test_full_ring_of_rotations_returns_to_zero(self):
        state = ring.init(CFG, 3, CPU, quantile=True)
        r = _t(np.linspace(0.0, 0.9, 16, dtype=np.float32))
        state = ring.observe_current(state, r, torch.ones(16))
        for _ in range(3):
            state = ring.rotate(state, 0.7)
        assert not state.qhist.any() and int(state.cursor) == 0

    @pytest.mark.parametrize("seed", range(12))
    def test_one_bin_rank_bracket_vs_exact(self, seed):
        rng = np.random.default_rng(seed)
        n, q = int(rng.integers(20, 400)), int(rng.integers(1, 100)) / 100
        r = _rates(rng, n, seed % 6)
        v = float(qsk.hist_quantile(qsk.observe_rates(
            qsk.init_hist(device=CPU), _t(r), torch.ones(n)), q))
        exact = float(np.quantile(r, q, method="inverted_cdf"))
        edges = qsk._EDGES_NP

        def bin_of(x):
            return int(np.clip(np.searchsorted(edges, x, side="right") - 1,
                               0, NB - 1))
        assert abs(bin_of(v) - bin_of(exact)) <= 1, (v, exact)
        if qsk.RATE_MIN <= exact <= 1.0 and v >= qsk.RATE_MIN:
            ratio = v / exact
            assert qsk._RATIO ** -2 * 0.999 <= ratio <= qsk._RATIO ** 2 \
                * 1.001
        elif exact < qsk.RATE_MIN:
            assert v <= edges[2]

    @pytest.mark.parametrize("seed", range(6))
    def test_quantile_monotone_in_q(self, seed):
        rng = np.random.default_rng(seed)
        h = qsk.observe_rates(qsk.init_hist(device=CPU),
                              _t(_rates(rng, 200, seed)), torch.ones(200))
        vals = [float(qsk.hist_quantile(h, q)) for q in
                (0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99)]
        assert all(a <= b + 1e-12 for a, b in zip(vals, vals[1:]))

    def test_empty_hist_is_zero_and_threshold_warmup_gates(self):
        assert float(qsk.hist_quantile(qsk.init_hist(device=CPU), 0.5)) \
            == 0.0
        h = qsk.observe_rates(qsk.init_hist(device=CPU),
                              torch.tensor([0.1, 0.2, 0.3]), torch.ones(3))
        three = torch.tensor(3.0)
        assert np.isneginf(float(qsk.quantile_threshold(h, three, 0.5,
                                                        10.0)))
        assert float(qsk.quantile_threshold(h, three, 0.5, 2.0)) \
            == float(qsk.hist_quantile(h, 0.5) * 3.0)

    @pytest.mark.parametrize("use_kernels", [True, False])
    def test_e1_windowed_quantile_filter_bitwise_flat(self, use_kernels):
        kw = dict(d_model=16, num_bits=6, num_tables=8, alpha=3.0,
                  warmup_items=32.0, threshold_mode="quantile",
                  quantile_q=0.05, use_kernels=use_kernels, device="cpu")
        flat = AceDataFilter(**kw)
        wind = WindowedAceFilter(**kw, num_epochs=1, decay=1.0)
        fs, w = flat.init()
        ws, w2 = wind.init()
        assert torch.equal(w, w2)
        rng = np.random.default_rng(11)
        for _ in range(6):
            feat = flat.features(_t(rng.normal(size=(16, 4, 16))
                                    .astype(np.float32)))
            fs, fk, fm = flat.step(fs, w, feat)
            ws, wk, wm = wind.step(ws, w, feat)
            assert torch.equal(fk, wk) and torch.equal(fm, wm)
        assert torch.equal(fs.qhist, ws.qhist[0])
        assert float(fs.qhist.sum()) == 5 * 16   # step 1 under the gate


# ---------------------------------------------------------------------------
# The states: the qhist leaf through every rebuild, thresholds.
# ---------------------------------------------------------------------------

def _ref_flat_state(steps=3, seed=0):
    """A reference AceState with a histogram, built by its own filter."""
    jf = JFlat(d_model=9, num_bits=6, num_tables=8, warmup_items=40.0,
               threshold_mode="quantile", quantile_q=0.05)
    js, jw = jf.init()
    step = jax.jit(jf.step)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        js, _, _ = step(js, jw, jnp.asarray(
            rng.normal(size=(16, 10)).astype(np.float32)))
    return jf, js, jw


class TestStates:
    def test_flat_threshold_merge_and_convert(self):
        jf, js, _ = _ref_flat_state()
        ps = state_from_numpy(js.counts, js.n, js.welford_mean,
                              js.welford_m2, CPU, qhist=js.qhist)
        np.testing.assert_array_equal(state_to_numpy(ps)["qhist"],
                                      np.asarray(js.qhist))
        assert float(ps.qhist.sum()) > 0
        for warmup in (0.0, 40.0, 1e6):
            for q in (0.01, 0.3):
                got = sk.admit_threshold(ps, 3.0, warmup,
                                         threshold_mode="quantile", q=q)
                want = jsk.admit_threshold(js, 3.0, warmup,
                                           threshold_mode="quantile", q=q)
                np.testing.assert_allclose(float(got), float(want),
                                           rtol=1e-6)
        merged = sk.merge(ps, ps)
        jm = jsk.merge(js, js)
        np.testing.assert_array_equal(merged.qhist.numpy(),
                                      np.asarray(jm.qhist))
        bare = ps._replace(qhist=None)
        with pytest.raises(ValueError, match="quantile-tracking"):
            sk.merge(ps, bare)
        with pytest.raises(ValueError, match="qhist"):
            sk.admit_threshold(bare, 3.0, 0.0, threshold_mode="quantile")
        carried = sk.insert_buckets(ps, _t(np.zeros((3, 8), np.int32)), CFG)
        assert carried.qhist is ps.qhist

    @pytest.mark.parametrize("gamma", [1.0, 0.8])
    def test_ring_matches_reference(self, gamma):
        """Masked inserts, live-epoch observations of the pre-insert
        rates and the eager clock in both packages: every leaf, the
        histogram rows bitwise, the combined histogram and the quantile
        threshold at rtol 1e-6 (bitwise at γ = 1)."""
        E, R = 3, 2
        js, ps = jring.init(JCFG, E, quantile=True), ring.init(CFG, E, CPU,
                                                                quantile=True)
        assert tuple(ps.qhist.shape) == (E, NB)
        @jax.jit
        def jstep(js, b, m):
            r = jring.score_combined(js, b) \
                / jnp.maximum(jring.combined_n(js, gamma), 1.0)
            js = jring.insert_current(js, b, m, JCFG, gamma=gamma)
            js = jring.observe_current(js, r, jnp.ones(12))
            return jring.maybe_rotate(js, R, gamma)
        rng = np.random.default_rng(4)
        for _ in range(6):
            b = rng.integers(0, 64, size=(12, 8)).astype(np.int32)
            m = rng.uniform(size=12) < 0.7
            pr = ring.score_combined(ps, _t(b)) \
                / torch.clamp_min(ring.combined_n(ps, gamma), 1.0)
            js = jstep(js, jnp.asarray(b), jnp.asarray(m))
            ps = ring.insert_current(ps, _t(b), _t(m), CFG, gamma=gamma)
            ps = ring.observe_current(ps, pr, torch.ones(12))
            ps = ring.maybe_rotate(ps, R, gamma)
        np.testing.assert_array_equal(ps.qhist.numpy(), np.asarray(js.qhist))
        np.testing.assert_array_equal(ps.cursor.numpy(),
                                      np.asarray(js.cursor))
        np.testing.assert_allclose(ring.combined_qhist(ps, gamma).numpy(),
                                   np.asarray(jring.combined_qhist(js,
                                                                   gamma)),
                                   rtol=1e-6, atol=0)
        for q in (0.05, 0.5):
            got = ring.admit_threshold_windowed(
                ps, gamma, 3.0, 10.0, threshold_mode="quantile", q=q)
            want = jring.admit_threshold_windowed(
                js, gamma, 3.0, 10.0, threshold_mode="quantile", q=q)
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        with pytest.raises(ValueError, match="qhist"):
            ring.combined_qhist(ring.init(CFG, E, CPU), gamma)

    def test_fleet_state_carries_the_histograms(self):
        T = 3
        jcfg = jfl.FleetConfig(ace=JCFG, num_tenants=T)
        js = jfl.init(jcfg, quantile=True)
        ps = fl.init(fl.FleetConfig(ace=CFG, num_tenants=T), CPU,
                     quantile=True)
        assert tuple(ps.qhist.shape) == (T, NB)
        rng = np.random.default_rng(6)
        r = _rates(rng, 200, 5)
        tids = rng.integers(0, T, 200).astype(np.int32)
        js = js._replace(qhist=jq.observe_rates_fleet(
            js.qhist, jnp.asarray(r), jnp.asarray(tids), jnp.ones(200)))
        js = js._replace(n=jnp.asarray([10.0, 500.0, 900.0]))
        ps = tree_from_numpy(fl.FleetState, js, CPU)
        for t in range(T):
            assert torch.equal(fl.tenant_view(ps, t).qhist, ps.qhist[t])
        one = fl.tenant_view(ps, 2)
        moved = fl.set_tenant(ps, 0, one)
        want = jfl.set_tenant(js, 0, jfl.tenant_view(js, 2))
        np.testing.assert_array_equal(moved.qhist.numpy(),
                                      np.asarray(want.qhist))
        np.testing.assert_array_equal(
            fl.merge_fleet(ps, moved).qhist.numpy(),
            np.asarray(jfl.merge_fleet(js, want).qhist))
        stacked = fl.from_states([fl.tenant_view(ps, t) for t in range(T)])
        assert torch.equal(stacked.qhist, ps.qhist)
        with pytest.raises(ValueError, match="quantile-tracking"):
            fl.merge_fleet(ps, ps._replace(qhist=None))
        for warmup in (0.0, 400.0):
            np.testing.assert_allclose(
                fl.admit_thresholds(ps, 3.0, warmup,
                                    threshold_mode="quantile",
                                    q=0.02).numpy(),
                np.asarray(jfl.admit_thresholds(js, 3.0, warmup,
                                                threshold_mode="quantile",
                                                q=0.02)), rtol=1e-6, atol=0)
        with pytest.raises(ValueError, match="quantile=True"):
            fl.admit_thresholds(ps._replace(qhist=None), 3.0, 0.0,
                                threshold_mode="quantile")

    @pytest.mark.parametrize("gamma", [1.0, 0.8])
    def test_fleet_window_matches_reference(self, gamma):
        """Routed observations into each tenant's live row, then the
        presence-gated clocks, which zero only the rotated tenants' new
        live rows; the per-tenant windowed quantile thresholds."""
        T, E, R = 3, 3, 2
        wcfg = ring.WindowConfig(ace=CFG, num_epochs=E)
        jwcfg = jring.WindowConfig(ace=JCFG, num_epochs=E)
        js = jfw.init_fleet_window(jwcfg, T, quantile=True)
        ps = fw.init_fleet_window(wcfg, T, CPU, quantile=True)
        assert tuple(ps.qhist.shape) == (T, E, NB)
        @jax.jit
        def jstep(js, tids, b, m, r):
            js = jfw.insert_current_fleet(js, tids, b, m, JCFG, gamma=gamma)
            js = jfw.observe_current_fleet(js, r, tids, jnp.ones(12))
            return jfw.maybe_rotate_fleet(js, R, gamma, tenant_ids=tids)
        rng = np.random.default_rng(8)
        for i in range(5):
            b = rng.integers(0, 64, size=(12, 8)).astype(np.int32)
            tids = rng.integers(0, 2 if i % 3 else T, 12).astype(np.int32)
            m = rng.uniform(size=12) < 0.7
            r = _rates(rng, 12, 5)
            js = jstep(js, jnp.asarray(tids), jnp.asarray(b), jnp.asarray(m),
                       jnp.asarray(r))
            ps = fw.insert_current_fleet(ps, _t(tids), _t(b), _t(m), CFG,
                                         gamma=gamma)
            ps = fw.observe_current_fleet(ps, _t(r), _t(tids),
                                          torch.ones(12))
            before = ps.qhist.clone()
            ps = fw.maybe_rotate_fleet(ps, R, gamma, tenant_ids=_t(tids))
            np.testing.assert_array_equal(ps.qhist.numpy(),
                                          np.asarray(js.qhist))
            for t in range(T):
                if t not in tids:
                    assert torch.equal(ps.qhist[t], before[t])
        assert int(ps.cursor.max()) > 0
        np.testing.assert_array_equal(fw.rotate_fleet(ps, gamma)
                                      .qhist.numpy(),
                                      np.asarray(jfw.rotate_fleet(js, gamma)
                                                 .qhist))
        for q in (0.05, 0.5):
            got = fw.window_admit_thresholds(ps, gamma, 3.0, 10.0,
                                             threshold_mode="quantile", q=q)
            want = jax.vmap(lambda s: jring.admit_threshold_windowed(
                s, gamma, 3.0, 10.0, threshold_mode="quantile", q=q))(
                jring.WindowedAceState(*js))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# ops admissions, filters, guardrails, the runner.
# ---------------------------------------------------------------------------

def _queries(rng, B=24, d=10, burst=0):
    topics = np.random.default_rng(99).normal(size=(3, d))
    q = topics[rng.integers(0, 3, B)] + 0.3 * rng.normal(size=(B, d))
    q[:burst] = 3.0 * rng.normal(size=(burst, d))
    return q.astype(np.float32)


def _assert_ace(ps, js):
    got = state_to_numpy(ps)
    for k in ("counts", "n", "qhist", "cursor", "tick"):
        if k in got:
            np.testing.assert_array_equal(got[k], np.asarray(getattr(js, k)),
                                          err_msg=k)
    for k in ("welford_mean", "welford_m2", "tail", "ssq"):
        if k in got:
            np.testing.assert_allclose(got[k], np.asarray(getattr(js, k)),
                                       rtol=1e-6, atol=0, err_msg=k)


ADMITS = {
    "flat": (lambda **k: (jsk.init(JCFG)._replace(qhist=jq.init_hist()),
                          sk.init(CFG, CPU)._replace(
                              qhist=qsk.init_hist(device=CPU))),
             "ace_admit", {}),
    "window": (lambda gamma, **k: (jring.init(JCFG, 3, quantile=True),
                                   ring.init(CFG, 3, CPU, quantile=True)),
               "ace_admit_windowed", dict(rotate_every=2)),
    "fleet": (lambda **k: (jfl.init(jfl.FleetConfig(ace=JCFG, num_tenants=3),
                                    quantile=True),
                           fl.init(fl.FleetConfig(ace=CFG, num_tenants=3),
                                   CPU, quantile=True)),
              "ace_fleet_admit", {}),
    "fleet_window": (
        lambda **k: (jfw.init_fleet_window(jring.WindowConfig(
            ace=JCFG, num_epochs=3), 3, quantile=True),
            fw.init_fleet_window(ring.WindowConfig(ace=CFG, num_epochs=3),
                                 3, CPU, quantile=True)),
        "ace_fleet_window_admit", dict(rotate_every=2)),
}


class TestOpsAdmission:
    @pytest.mark.parametrize("kind,gamma", [
        ("flat", 1.0), ("window", 1.0), ("window", 0.8), ("fleet", 1.0),
        ("fleet_window", 1.0), ("fleet_window", 0.8)])
    def test_quantile_admit_matches_reference(self, kind, gamma):
        """Seven admits through warmup, past the gate and into a burst, one
        NaN-quarantined row each, both packages' kernel paths (the
        reference's Pallas kernels in interpret mode): admit masks, counts,
        n, cursors, ticks and histograms bitwise; after the fourth admit
        the reference's state is carried across (``tree_from_numpy``) and
        both go on from it."""
        make, name, extra = ADMITS[kind]
        js, ps = make(gamma=gamma)
        jw = jsk.make_params(JCFG)
        w = params_from_numpy(np.asarray(jw), CPU)
        windowed, fleet = "window" in kind, "fleet" in kind
        kw = dict(alpha=2.0, warmup_items=30.0, threshold_mode="quantile",
                  quantile_q=0.1, **extra)
        if windowed:
            kw["gamma"] = gamma
        jadmit = jax.jit(lambda st, *a, item: getattr(jops, name)(
            st, *a, jw, JCFG, **kw, item_mask=item))
        rng = np.random.default_rng(12)
        for i in range(7):
            q = _queries(rng, burst=6 if i >= 5 else 0)
            item = np.ones(24, bool)
            item[i] = False
            args = [jnp.asarray(q)]
            pargs = [_t(q)]
            if fleet:
                tids = rng.integers(0, 3 if i % 4 else 2, 24).astype(np.int32)
                args.append(jnp.asarray(tids))
                pargs.append(_t(tids))
            js, ja = jadmit(js, *args, item=jnp.asarray(item))
            ps, pa = getattr(ops, name)(ps, *pargs, w, CFG, **kw,
                                        item_mask=_t(item))
            np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
            if i == 3:
                _assert_ace(ps, js)
                ps = tree_from_numpy(type(ps), js, CPU)
        _assert_ace(ps, js)
        assert float(ps.qhist.sum()) > 0

    def test_mu_sigma_admit_leaves_no_histogram(self):
        ps = sk.init(CFG, CPU)
        w = params_from_numpy(np.asarray(jsk.make_params(JCFG)), CPU)
        ps, _ = ops.ace_admit(ps, _t(_queries(np.random.default_rng(0))), w,
                              CFG, alpha=2.0, warmup_items=0.0)
        assert ps.qhist is None


def _filters(kind, use_kernels, **kw):
    kw = dict(d_model=9, num_bits=6, num_tables=8, alpha=2.0,
              warmup_items=40.0, threshold_mode="quantile",
              quantile_q=0.05, **kw)
    if kind == "window":
        kw.update(num_epochs=3, decay=0.8)
        jf, pf = JWin(**kw), WindowedAceFilter
    elif kind == "fleet":
        kw.update(num_tenants=3)
        jf, pf = JFleet(**kw), FleetDataFilter
    else:
        jf, pf = JFlat(**kw), AceDataFilter
    tables = None
    if kw.get("attr_rows"):              # the reference's attribution hash
        tables = attr_tables_from_numpy(
            *_level_tables_np(jf.ace_cfg.attr),
            pf(**kw, device="cpu").ace_cfg.attr, CPU)
    pf = pf(**kw, use_kernels=use_kernels, device="cpu", attr_tables=tables)
    (js, jw), (ps, pw) = jf.init(), pf.init()
    return jf, pf, js, jw, ps, params_from_numpy(np.asarray(jw), CPU)


def _ref_steps(jf, js, jw, data, fleet, window):
    """The reference filter's steps (jitted, as its runner runs them) with
    the window's eager clock every 2 steps: the states and keep masks."""
    step = jax.jit(jf.step)
    rot = jax.jit(lambda s: jring.maybe_rotate(s, 2, 0.8))
    keeps = []
    for i, (f, t) in enumerate(data):
        extra = (jnp.asarray(t),) if fleet else ()
        js, jk, _ = step(js, jw, jnp.asarray(f), *extra)
        keeps.append(np.asarray(jk))
        if window and i % 2 == 1:
            js = rot(js)
    return js, keeps


def _feats(rng, n, B=16, d=10, burst_from=5):
    topics = np.random.default_rng(98).normal(size=(3, d))
    for i in range(n):
        f = topics[rng.integers(0, 3, B)] + 0.2 * rng.normal(size=(B, d))
        if i >= burst_from:
            f[:4] = 3.0 * rng.normal(size=(4, d))
        f[i % B, i % d] = np.nan
        yield f.astype(np.float32), rng.integers(0, 3, B).astype(np.int32)


class TestFilters:
    @pytest.mark.parametrize("kind", ["flat", "window", "fleet"])
    @pytest.mark.parametrize("insert_all", [False, True])
    def test_step_matches_reference(self, kind, insert_all):
        """Eight steps through the half-warmup gate, warmup and a burst,
        a NaN row each (never observed), the window's eager clock every
        2 steps, through the port's kernel path and its plain path: keep
        masks, margins' finiteness, every leaf, the histograms bitwise."""
        data = list(_feats(np.random.default_rng(2), 8))
        fleet, window = kind == "fleet", kind == "window"
        jf, _, js, jw, _, w = _filters(kind, True, insert_all=insert_all)
        js, jkeeps = _ref_steps(jf, js, jw, data, fleet, window)
        for use_kernels in (True, False):
            _, pf, _, _, ps, _ = _filters(kind, use_kernels,
                                          insert_all=insert_all)
            for i, (f, t) in enumerate(data):
                ps, pk, pm = pf.step(ps, w, _t(f), *((_t(t),) if fleet
                                                     else ()))
                np.testing.assert_array_equal(pk.numpy(), jkeeps[i])
                assert int(np.isneginf(pm.numpy()).sum()) == 1
                if window and i % 2 == 1:
                    ps = ring.maybe_rotate(ps, 2, 0.8)
            _assert_ace(ps, js)
            assert 0 < float(ps.qhist.sum()) <= 8 * 15

    @pytest.mark.parametrize("kind", ["flat", "window", "fleet"])
    def test_runner_consume_matches_reference(self, kind, monkeypatch):
        """Two chunks of 4 steps through both runners, with heavy-hitter
        attribution riding the quantile state: summaries' anomaly counts
        and heavy hitters, the states bitwise (attribution planes at
        rtol 1e-5); one H2D and one D2H a chunk."""
        jf, pf, js, jw, ps, w = _filters(kind, True, attr_rows=3,
                                         attr_bits=4)
        rng = np.random.default_rng(7)
        data = list(_feats(rng, 8))
        feats = np.stack([f for f, _ in data])
        tids = np.stack([t for _, t in data]) if kind == "fleet" else None
        calls = {"h2d": 0, "d2h": 0}
        real_in, real_out = runner_mod._to_device, runner_mod._to_host

        def to_device(x, dev):
            calls["h2d"] += 1
            return real_in(x, dev)

        def to_host(x):
            calls["d2h"] += 1
            return real_out(x)
        monkeypatch.setattr(runner_mod, "_to_device", to_device)
        monkeypatch.setattr(runner_mod, "_to_host", to_host)
        ps, psum = StreamRunner(pf, 4).run(
            ps, w, iter(feats), None if tids is None else iter(tids))
        js, jsum = JRunner(jf, 4).run(
            js, jw, iter(feats), None if tids is None else iter(tids))
        assert calls == {"h2d": 2, "d2h": 2}
        for a, b in zip(psum, jsum):
            for k in ("anom_counts", "hh_coord", "hh_valid"):
                np.testing.assert_array_equal(np.asarray(getattr(a, k)),
                                              np.asarray(getattr(b, k)))
        _assert_ace(ps, js)
        np.testing.assert_allclose(ps.attr.numpy(), np.asarray(js.attr),
                                   rtol=1e-5, atol=1e-5)


def _guard_batches(n, T=None, seed=11, b=16, s=3, d=12):
    rng = np.random.default_rng(seed)
    topics = rng.normal(size=(3, d))
    for i in range(n):
        e = topics[rng.integers(0, 3, b)][:, None, :] \
            + 0.3 * rng.normal(size=(b, s, d))
        if i >= n // 2:
            k = 2 * (i - n // 2) + 2
            e[:k] = rng.normal(size=(k, s, d)) * 3.0
        e[i % b, i % s, 0] = np.nan
        yield e.astype(np.float32), (None if T is None else
                                     rng.integers(0, T, b).astype(np.int32))


GUARDS = {"flat": {}, "window": dict(window_epochs=3, rotate_every=2,
                                     window_decay=0.8),
          "fleet": dict(num_tenants=3),
          "fleet_window": dict(num_tenants=3, window_epochs=3,
                               rotate_every=2, window_decay=0.8)}


class TestGuardrails:
    @pytest.mark.parametrize("kind", sorted(GUARDS))
    def test_admit_matches_reference(self, kind, monkeypatch):
        """Twelve admits, a growing off-topic share, a NaN row each, through
        the reference's plain path and the port's kernel and plain paths:
        masks, counts, n, cursors, ticks and histograms bitwise, Welford at
        rtol 1e-6; one transfer an admit.  (The reference's kernel path
        meets the port's in ``TestOpsAdmission``.)"""
        gcfg = dict(d_model=12, num_bits=6, num_tables=8, warmup_items=32.0,
                    alpha=2.0, threshold_mode="quantile", quantile_q=0.05,
                    **GUARDS[kind])
        gj = jengine.Guardrail(jengine.GuardrailConfig(**gcfg))
        T = gcfg.get("num_tenants")
        batches = list(_guard_batches(12, T))
        want = [np.asarray(gj.admit(jnp.asarray(e)) if t is None
                           else gj.admit(jnp.asarray(e), jnp.asarray(t)))
                for e, t in batches]
        calls = []
        real = engine._to_host
        monkeypatch.setattr(engine, "_to_host",
                            lambda x: calls.append(1) or real(x))
        for use_kernels in (True, False):
            gp = engine.Guardrail(engine.GuardrailConfig(**gcfg),
                                  use_kernels=use_kernels, device="cpu",
                                  w=params_from_numpy(np.asarray(gj.w), CPU))
            for (e, t), m in zip(batches, want):
                np.testing.assert_array_equal(gp.admit(e, t), m)
            assert gp.quarantined == gj.quarantined == 12
            _assert_ace(gp.state, gj.state)
            assert float(gp.state.qhist.sum()) > 0
        assert len(calls) == 24


# ---------------------------------------------------------------------------
# The calibration scenario (benchmarks/quantile_bench.py) and its stream.
# ---------------------------------------------------------------------------

def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class TestCalibrationScenario:
    def test_stream_copy_is_the_benchmarks_bitwise(self):
        """``chip_smoke.calibration_stream`` (numpy, no JAX) draw for draw
        the benchmark's ``_make_stream``, at its smoke and full shapes."""
        bench = _load("quantile_bench", REPO / "benchmarks" /
                      "quantile_bench.py")
        smoke = _load("chip_smoke", REPO / "chip_smoke.py")
        for shape in (dict(steps=12, batch=64, dim=32, T=2),
                      dict(steps=6, batch=384, dim=64, T=3)):
            kw = dict(burst_from=4, burst_frac=0.3, drift=0.1,
                      noise_scale=0.55, seed=0)
            for a, b in zip(smoke.calibration_stream(**shape, **kw),
                            bench._make_stream(**shape, **kw)):
                for x, y in zip(a, b):
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)
        assert smoke.CAL_TENANTS == bench.TENANTS
        assert smoke.CAL_BIMODAL_FRAC == bench.BIMODAL_FRAC

    @pytest.mark.parametrize("mode", ["quantile", "mu_sigma"])
    def test_per_step_keep_masks_match_reference(self, mode):
        """The scenario at a narrow size (B = 96, d = 32, K = 8, L = 16,
        warmup 128) through both fleets' runners in monitor mode: every
        step's keep mask bitwise, and the histograms."""
        smoke = _load("chip_smoke", REPO / "chip_smoke.py")
        steps, B, dim, T = 30, 96, 32, 3
        stream = smoke.calibration_stream(steps, B, dim, T, burst_from=24,
                                          burst_frac=0.3, drift=0.1,
                                          noise_scale=0.55, seed=0)
        kw = dict(d_model=dim, num_tenants=T, num_bits=8, num_tables=16,
                  alpha=3.0, warmup_items=128.0, insert_all=True,
                  threshold_mode=mode, quantile_q=0.05)
        jf = JFleet(**kw)
        pf = FleetDataFilter(**kw, device="cpu")
        (js, jw), (ps, _) = jf.init(), pf.init()
        w = params_from_numpy(np.asarray(jw), CPU)
        jr = JRunner(jf, chunk_T=10, return_masks=True)
        pr = StreamRunner(pf, chunk_T=10, return_masks=True)
        raw = np.stack([x for x, _, _ in stream])
        tids = np.stack([t for _, t, _ in stream])
        for c in range(steps // 10):
            sl = slice(c * 10, (c + 1) * 10)
            jfeat = jf.features(jnp.asarray(raw[sl]).reshape(-1, 1, dim)) \
                .reshape(10, B, dim + 1)
            pfeat = pf.features(_t(raw[sl]).reshape(-1, 1, dim)) \
                .reshape(10, B, dim + 1)
            js, _, jk = jr.consume(js, jw, jfeat, jnp.asarray(tids[sl]))
            ps, _, pk = pr.consume(ps, w, pfeat, _t(tids[sl]))
            np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
        _assert_ace(ps, js)
