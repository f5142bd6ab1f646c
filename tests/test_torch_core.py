"""The port's core (``repro_torch.core``: srp, sketch, estimators) against
the reference's (``repro.core``) on the same numpy-made inputs, the same
JAX-drawn projection matrix and the same bucket ids.

Tolerances:
* hash bucket ids: agreement >= 0.999 (the reference's kernel floor);
* counts and n, fed the same bucket ids: bitwise;
* scores: bitwise (every count sum here is far below 2^24);
* Welford mean/M2, μ, rates, σ and thresholds: rtol 1e-5
  (tests/test_guardrail_admit.py holds its own kernel/jnp paths to that);
* float-valued estimator outputs (collision probabilities, exact and RSE
  scores): rtol 1e-5, for the float32 arccos and summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro.core import estimators as jest  # noqa: E402
from repro.core import sketch as jsk  # noqa: E402
from repro.core import srp as jsrp  # noqa: E402
from repro_torch.core import estimators as est  # noqa: E402
from repro_torch.core import sketch as sk  # noqa: E402
from repro_torch.core import srp  # noqa: E402
from repro_torch.core.convert import (params_from_numpy,  # noqa: E402
                                      params_to_numpy, state_from_numpy,
                                      state_to_numpy)

jax.config.update("jax_platform_name", "cpu")

CPU = torch.device("cpu")
RTOL = 1e-5


def _data(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jstate_to_port(js):
    return state_from_numpy(js.counts, js.n, js.welford_mean, js.welford_m2,
                            CPU)


def _assert_state(port, ref):
    """counts/n bitwise, Welford at RTOL."""
    got = state_to_numpy(port)
    np.testing.assert_array_equal(got["counts"], np.asarray(ref.counts))
    assert float(got["n"]) == float(ref.n)
    for k in ("welford_mean", "welford_m2"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(ref, k)),
                                   rtol=RTOL, atol=1e-12)


class TestSrp:
    def test_sign_zero_is_bit_one(self):
        """sign(0) gives bit 1 (srp.py:101-109): a zero row hashes every
        table to the all-ones bucket 2^K − 1."""
        cfg = srp.SrpConfig(dim=6, num_bits=5, num_tables=4)
        w = srp.make_projections(cfg, device=CPU)
        b = srp.hash_buckets(torch.zeros((3, 6)), w, cfg)
        assert (b == (1 << 5) - 1).all()

    def test_pack_is_msb_first(self):
        cfg = srp.SrpConfig(dim=4, num_bits=3, num_tables=2)
        bits = torch.tensor([[1, 0, 1, 0, 1, 1]], dtype=torch.int32)
        assert srp.pack_buckets(bits, cfg).tolist() == [[5, 3]]

    @pytest.mark.parametrize("K,L", [(3, 2), (15, 50), (8, 10)])
    def test_pack_matches_reference(self, K, L):
        cfg = srp.SrpConfig(dim=4, num_bits=K, num_tables=L)
        bits = np.random.default_rng(K).integers(
            0, 2, size=(9, K * L)).astype(np.int32)
        want = jsrp.pack_buckets(jnp.asarray(bits), jsrp.SrpConfig(
            dim=4, num_bits=K, num_tables=L))
        np.testing.assert_array_equal(srp.pack_buckets(_t(bits), cfg).numpy(),
                                      np.asarray(want))

    @pytest.mark.parametrize("n,d,K,L", [(200, 16, 15, 50), (64, 36, 8, 10)])
    def test_hash_matches_reference_on_jax_w(self, n, d, K, L):
        jcfg = jsrp.SrpConfig(dim=d, num_bits=K, num_tables=L, seed=3)
        w = np.asarray(jsrp.make_projections(jcfg))
        x = _data(n, d)
        got = srp.hash_buckets(_t(x), params_from_numpy(w, CPU),
                               srp.SrpConfig(dim=d, num_bits=K,
                                             num_tables=L, seed=3))
        want = np.asarray(jsrp.hash_buckets(jnp.asarray(x), jnp.asarray(w),
                                            jcfg))
        assert (got.numpy() == want).mean() >= 0.999

    def test_make_projections_shape_and_determinism(self):
        cfg = srp.SrpConfig(dim=9, num_bits=15, num_tables=50, seed=4)
        a = srp.make_projections(cfg, device=CPU)
        b = srp.make_projections(cfg, device=CPU)
        assert tuple(a.shape) == (9, 768) and a.dtype == torch.float32
        assert torch.equal(a, b)
        g = torch.Generator().manual_seed(5)
        assert not torch.equal(srp.make_projections(cfg, g, CPU), a)

    def test_collision_probability_matches_reference(self):
        q, x = _data(5, 12, 1), _data(5, 12, 2)
        want = jsrp.collision_probability(jnp.asarray(q), jnp.asarray(x))
        np.testing.assert_allclose(
            srp.collision_probability(_t(q), _t(x)).numpy(),
            np.asarray(want), rtol=RTOL)

    def test_other_hash_modes_raise(self):
        """Only an unknown hash mode raises now; "srht" and "auto" are
        ported and hash like the reference (tests/test_torch_srht.py holds
        them bitwise)."""
        with pytest.raises(ValueError, match="hash_mode"):
            srp.make_projections(srp.SrpConfig(dim=4, hash_mode="fwht"))
        with pytest.raises(ValueError, match="hash_mode"):
            srp.hash_buckets(torch.zeros((1, 4)), torch.zeros((4, 128)),
                             srp.SrpConfig(dim=4, hash_mode="fwht"))
        x = _data(30, 20)
        for mode in ("srht", "auto"):
            jcfg = jsrp.SrpConfig(dim=20, num_bits=6, num_tables=5, seed=2,
                                  hash_mode=mode)
            cfg = srp.SrpConfig(dim=20, num_bits=6, num_tables=5, seed=2,
                                hash_mode=mode)
            jw = jsrp.make_projections(jcfg)
            want = np.asarray(jsrp.hash_buckets(jnp.asarray(x), jw, jcfg))
            got = srp.hash_buckets(_t(x), params_from_numpy(np.asarray(jw),
                                                            CPU), cfg)
            if srp.resolve_hash_mode(cfg) == "srht":
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                assert (got.numpy() == want).mean() >= 0.999


CFG = dict(dim=12, num_bits=8, num_tables=16, seed=11)


def _pair(welford_min_n=0.0, **kw):
    kw = {**CFG, "welford_min_n": welford_min_n, **kw}
    return jsk.AceConfig(**kw), sk.AceConfig(**kw)


def _bucket_ids(n, K, L, seed):
    return np.random.default_rng(seed).integers(
        0, 1 << K, size=(n, L)).astype(np.int32)


class TestSketch:
    def test_init(self):
        jcfg, cfg = _pair()
        _assert_state(sk.init(cfg, CPU), jsk.init(jcfg))
        assert cfg.memory_bytes() == jcfg.memory_bytes()

    def test_batch_scores_and_histogram(self):
        jcfg, cfg = _pair()
        counts = np.random.default_rng(0).integers(
            0, 50, size=(16, 256)).astype(np.int32)
        ids = _bucket_ids(30, 8, 16, 1)
        np.testing.assert_array_equal(
            sk.batch_scores(_t(counts), _t(ids)).numpy(),
            np.asarray(jsk.batch_scores(jnp.asarray(counts),
                                        jnp.asarray(ids))))
        np.testing.assert_array_equal(
            sk.histogram(_t(ids), cfg).numpy(),
            np.asarray(jsk.histogram(jnp.asarray(ids), jcfg)))

    @pytest.mark.parametrize("min_n", [0.0, 40.0])
    def test_insert_delete_match_reference(self, min_n):
        """Three inserts (crossing the σ cold-start gate when min_n > 0),
        lookups and a delete, fed the same bucket ids."""
        jcfg, cfg = _pair(welford_min_n=min_n)
        js, ps = jsk.init(jcfg), sk.init(cfg, CPU)
        for i in range(3):
            ids = _bucket_ids(24, 8, 16, 10 + i)
            js = jsk.insert_buckets(js, jnp.asarray(ids), jcfg)
            ps = sk.insert_buckets(ps, _t(ids), cfg)
            _assert_state(ps, js)
            np.testing.assert_array_equal(
                sk.lookup(ps, _t(ids)).numpy(),
                np.asarray(jsk.lookup(js, jnp.asarray(ids))))
        ids = _bucket_ids(24, 8, 16, 11)
        _assert_state(sk.delete_buckets(ps, _t(ids), cfg),
                      jsk.delete_buckets(js, jnp.asarray(ids), jcfg))

    @pytest.mark.parametrize("density", [0.0, 0.4, 1.0])
    def test_masked_insert_matches_reference(self, density):
        jcfg, cfg = _pair(welford_min_n=8.0)
        ids0 = _bucket_ids(30, 8, 16, 3)
        js = jsk.insert_buckets(jsk.init(jcfg), jnp.asarray(ids0), jcfg)
        ps = sk.insert_buckets(sk.init(cfg, CPU), _t(ids0), cfg)
        ids = _bucket_ids(20, 8, 16, 4)
        mask = np.random.default_rng(5).random(20) < density
        _assert_state(
            sk.insert_buckets_masked(ps, _t(ids), _t(mask), cfg),
            jsk.insert_buckets_masked(js, jnp.asarray(ids),
                                      jnp.asarray(mask), jcfg))

    @pytest.mark.parametrize("density", [0.3, 0.7, 1.0])
    def test_masked_equals_gather_insert(self, density):
        """insert_buckets_masked(mask) ≡ insert_buckets(buckets[mask]):
        counts/n/μ exact, Welford at the reference test's own tolerances
        (tests/test_guardrail_admit.py: mean at dtype rtol 1e-5, M2 at
        rtol 1e-4 — the two paths sum in different orders)."""
        _, cfg = _pair()
        ps = sk.insert_buckets(sk.init(cfg, CPU), _t(_bucket_ids(30, 8, 16, 6)),
                               cfg)
        ids = _t(_bucket_ids(40, 8, 16, 7))
        mask = _t(np.random.default_rng(8).random(40) < density)
        got = sk.insert_buckets_masked(ps, ids, mask, cfg)
        want = sk.insert_buckets(ps, ids[mask], cfg)
        assert torch.equal(got.counts, want.counts)
        assert float(got.n) == float(want.n)
        assert float(sk.mean_mu(got)) == float(sk.mean_mu(want))
        np.testing.assert_allclose(float(got.welford_mean),
                                   float(want.welford_mean), rtol=1e-5)
        np.testing.assert_allclose(float(got.welford_m2),
                                   float(want.welford_m2), rtol=1e-4,
                                   atol=1e-7)

    def test_merge_matches_reference(self):
        jcfg, cfg = _pair()
        a, b = _bucket_ids(40, 8, 16, 20), _bucket_ids(24, 8, 16, 21)
        ja = jsk.insert_buckets(jsk.init(jcfg), jnp.asarray(a), jcfg)
        jb = jsk.insert_buckets(jsk.init(jcfg), jnp.asarray(b), jcfg)
        pa = sk.insert_buckets(sk.init(cfg, CPU), _t(a), cfg)
        pb = sk.insert_buckets(sk.init(cfg, CPU), _t(b), cfg)
        _assert_state(sk.merge(pa, pb), jsk.merge(ja, jb))
        full = sk.insert_buckets(pa, _t(b), cfg)
        assert torch.equal(sk.merge(pa, pb).counts, full.counts)

    def test_statistics_and_threshold_match_reference(self):
        jcfg, cfg = _pair(welford_min_n=4.0)
        ids = _bucket_ids(60, 8, 16, 30)
        js = jsk.insert_buckets(jsk.init(jcfg), jnp.asarray(ids), jcfg)
        ps = sk.insert_buckets(sk.init(cfg, CPU), _t(ids), cfg)
        for name in ("mean_mu", "mean_rate", "sigma_welford"):
            np.testing.assert_allclose(
                float(getattr(sk, name)(ps)), float(getattr(jsk, name)(js)),
                rtol=RTOL)
        for alpha, warmup in ((1.5, 10.0), (3.0, 1e6)):
            got = float(sk.admit_threshold(ps, alpha, warmup))
            want = float(jsk.admit_threshold(js, alpha, warmup))
            if warmup > 60:
                assert got == want == float("-inf")
            else:
                np.testing.assert_allclose(got, want, rtol=RTOL)

    def test_closed_form_mu_equals_sequential_eq11(self):
        """μ = Σ‖A‖²/(nL) ≡ the paper's streaming Eq. 11, in the port, and
        the same μ as the reference's closed form."""
        jcfg, cfg = _pair()
        ids = _bucket_ids(60, 8, 16, 40)
        ps, mu_seq = sk.init(cfg, CPU), None
        for i in range(60):
            ps, mu_seq = sk.mu_sequential_increment(ps, _t(ids[i]), cfg)
        batch = sk.insert_buckets(sk.init(cfg, CPU), _t(ids), cfg)
        np.testing.assert_allclose(float(mu_seq), float(sk.mean_mu(batch)),
                                   rtol=RTOL)
        assert torch.equal(ps.counts, batch.counts)
        js = jsk.insert_buckets(jsk.init(jcfg), jnp.asarray(ids), jcfg)
        np.testing.assert_allclose(float(sk.mean_mu(batch)),
                                   float(jsk.mean_mu(js)), rtol=RTOL)

    def test_vector_api_matches_reference(self):
        """insert / score / is_anomaly / delete on raw vectors with the
        JAX-drawn W carried across."""
        jcfg, cfg = _pair()
        w = np.asarray(jsk.make_params(jcfg))
        pw = params_from_numpy(w, CPU)
        x, q = _data(80, 12, 1), _data(10, 12, 2)
        js = jsk.insert(jsk.init(jcfg), jnp.asarray(w), jnp.asarray(x), jcfg)
        ps = sk.insert(sk.init(cfg, CPU), pw, _t(x), cfg)
        _assert_state(ps, js)
        np.testing.assert_array_equal(
            sk.score(ps, pw, _t(q), cfg).numpy(),
            np.asarray(jsk.score(js, jnp.asarray(w), jnp.asarray(q), jcfg)))
        np.testing.assert_array_equal(
            sk.is_anomaly(ps, pw, _t(q), cfg, alpha=0.5).numpy(),
            np.asarray(jsk.is_anomaly(js, jnp.asarray(w), jnp.asarray(q),
                                      jcfg, alpha=0.5)))
        _assert_state(sk.delete(ps, pw, _t(x[:20]), cfg),
                      jsk.delete(js, jnp.asarray(w), jnp.asarray(x[:20]),
                                 jcfg))

    def test_float32_counts(self):
        jcfg, cfg = _pair(counter_dtype="float32")
        ids = _bucket_ids(30, 8, 16, 50)
        _assert_state(sk.insert_buckets(sk.init(cfg, CPU), _t(ids), cfg),
                      jsk.insert_buckets(jsk.init(jcfg), jnp.asarray(ids),
                                         jcfg))

    @pytest.mark.parametrize("kw", [
        dict(counter_dtype="int16"),
        dict(counter_dtype="int8", esc_capacity=4),
        dict(counter_dtype="int8")])
    def test_narrow_planes_now_run_like_the_reference(self, kw):
        """Narrow planes (with and without promotion), once refused here
        (queue 1 item 9), now insert, score, delete and merge like the
        reference: counts, the escalation table and n bitwise, μ at RTOL
        (tests/test_torch_quantize.py covers every path)."""
        from repro_torch.core.convert import state_to_numpy
        jcfg, cfg = _pair(**kw)
        assert cfg.memory_bytes() == jcfg.memory_bytes()
        ids = _bucket_ids(40, 8, 16, 51)
        ps = sk.insert_buckets(sk.init(cfg, CPU), _t(ids), cfg)
        js = jsk.insert_buckets(jsk.init(jcfg), jnp.asarray(ids), jcfg)
        ps = sk.merge(sk.delete_buckets(ps, _t(ids[:7]), cfg), ps)
        js = jsk.merge(jsk.delete_buckets(js, jnp.asarray(ids[:7]), jcfg),
                       js)
        got = state_to_numpy(ps)
        assert got["counts"].dtype == np.dtype(kw["counter_dtype"])
        _assert_state(ps, js)
        if js.esc is not None:
            for k in ("offs", "vals", "lost"):
                np.testing.assert_array_equal(got[f"esc.{k}"],
                                              np.asarray(getattr(js.esc, k)))
        np.testing.assert_array_equal(
            sk.lookup(ps, _t(ids)).numpy(),
            np.asarray(jsk.lookup(js, jnp.asarray(ids))))
        np.testing.assert_allclose(float(sk.mean_mu(ps)),
                                   float(jsk.mean_mu(js)), rtol=RTOL)

    def test_degraded_and_quantile_raise(self):
        """Degraded scoring (``table_mask``) scores like the reference; the
        quantile threshold (ported) raises, as the reference's does, on a
        sketch with no histogram, and with one equals the reference's
        (rtol 1e-6)."""
        jcfg, cfg = _pair()
        ids = _bucket_ids(40, 8, 16, 70)
        js = jsk.insert_buckets(jsk.init(jcfg), jnp.asarray(ids), jcfg)
        ps = sk.insert_buckets(sk.init(cfg, CPU), _t(ids), cfg)
        mask = np.ones(16, np.float32)
        mask[[2, 9]] = 0.0
        np.testing.assert_array_equal(
            sk.lookup(ps, _t(ids[:5]), table_mask=_t(mask)).numpy(),
            np.asarray(jsk.lookup(js, jnp.asarray(ids[:5]),
                                  table_mask=jnp.asarray(mask))))
        with pytest.raises(ValueError, match="qhist"):
            jsk.admit_threshold(js, 1.0, 0.0, threshold_mode="quantile")
        with pytest.raises(ValueError, match="qhist"):
            sk.admit_threshold(ps, 1.0, 0.0, threshold_mode="quantile")
        from repro.quantile import sketch as jq
        rates = (jsk.lookup(js, jnp.asarray(ids)) / js.n).astype(jnp.float32)
        jh = jq.observe_rates(jq.init_hist(), rates, jnp.ones(40))
        js, ps = js._replace(qhist=jh), ps._replace(
            qhist=torch.from_numpy(np.array(jh)))
        for warmup in (0.0, 100.0):
            np.testing.assert_allclose(
                float(sk.admit_threshold(ps, 1.0, warmup,
                                         threshold_mode="quantile", q=0.1)),
                float(jsk.admit_threshold(js, 1.0, warmup,
                                          threshold_mode="quantile", q=0.1)),
                rtol=1e-6)

    @pytest.mark.parametrize("dead", [[], [0], [3, 7, 15], list(range(16))])
    def test_masked_statistics_match_reference(self, dead):
        """``masked_table_mean``, ``lookup``, ``mean_mu``, ``mean_rate``
        and ``admit_threshold`` over the healthy tables, down to none
        healthy: scores bitwise, μ and the threshold at RTOL."""
        jcfg, cfg = _pair(welford_min_n=4.0)
        ids = _bucket_ids(60, 8, 16, 31)
        js = jsk.insert_buckets(jsk.init(jcfg), jnp.asarray(ids), jcfg)
        ps = sk.insert_buckets(sk.init(cfg, CPU), _t(ids), cfg)
        mask = np.ones(16, np.float32)
        mask[dead] = 0.0
        jm, pm = jnp.asarray(mask), _t(mask)
        g = np.random.default_rng(1).integers(0, 90, (7, 16)) \
            .astype(np.float32)
        np.testing.assert_array_equal(
            sk.masked_table_mean(_t(g), pm).numpy(),
            np.asarray(jsk.masked_table_mean(jnp.asarray(g), jm)))
        np.testing.assert_array_equal(
            sk.lookup(ps, _t(ids), table_mask=pm).numpy(),
            np.asarray(jsk.lookup(js, jnp.asarray(ids), table_mask=jm)))
        np.testing.assert_array_equal(
            sk.batch_scores(ps.counts, _t(ids), table_mask=pm).numpy(),
            np.asarray(jsk.batch_scores(js.counts, jnp.asarray(ids),
                                        table_mask=jm)))
        for name in ("mean_mu", "mean_rate"):
            np.testing.assert_allclose(
                float(getattr(sk, name)(ps, pm)),
                float(getattr(jsk, name)(js, table_mask=jm)), rtol=RTOL)
        np.testing.assert_allclose(
            float(sk.admit_threshold(ps, 1.5, 10.0, table_mask=pm)),
            float(jsk.admit_threshold(js, 1.5, 10.0, table_mask=jm)),
            rtol=RTOL)
        if not dead:
            assert float(sk.mean_mu(ps, pm)) == float(sk.mean_mu(ps))

    @pytest.mark.parametrize("dead", [None, [1, 4]])
    @pytest.mark.parametrize("alpha", [1.0, 1.25, 2.0])
    def test_falpha_index_matches_reference(self, alpha, dead):
        from repro.quantile.moments import falpha_index as jfalpha
        from repro_torch.quantile.moments import falpha_index
        counts = np.random.default_rng(2).integers(
            -2, 40, size=(16, 256)).astype(np.int32)   # negatives clamp
        n = np.float32(counts.clip(0).sum(1).mean())
        mask = None
        if dead is not None:
            mask = np.ones(16, np.float32)
            mask[dead] = 0.0
        got = falpha_index(_t(counts), torch.tensor(n), alpha,
                           None if mask is None else _t(mask))
        want = jfalpha(jnp.asarray(counts), jnp.asarray(n), alpha,
                       None if mask is None else jnp.asarray(mask))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


class TestEstimators:
    def test_collision_probs_and_exact_score(self):
        q, data = _data(4, 10, 1), _data(50, 10, 2)
        np.testing.assert_allclose(
            est.collision_probs(_t(q), _t(data)).numpy(),
            np.asarray(jest.collision_probs(jnp.asarray(q),
                                            jnp.asarray(data))), rtol=RTOL)
        np.testing.assert_allclose(
            est.exact_score(_t(q), _t(data), 5).numpy(),
            np.asarray(jest.exact_score(jnp.asarray(q), jnp.asarray(data), 5)),
            rtol=RTOL)

    def test_rse_at_full_sample_is_exact(self):
        """num_samples == n: every draw is the whole dataset, so the port's
        torch.Generator and the reference's jax.random key agree."""
        q, data = _data(3, 8, 3), _data(40, 8, 4)
        got = est.rse_score(_t(q), _t(data), 4, 40,
                            torch.Generator().manual_seed(0))
        want = jest.rse_score(jnp.asarray(q), jnp.asarray(data), 4, 40,
                              jax.random.PRNGKey(0))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
        np.testing.assert_allclose(
            got.numpy(), est.exact_score(_t(q), _t(data), 4).numpy(),
            rtol=RTOL)

    def test_variances(self):
        p = np.random.default_rng(5).random((3, 30)).astype(np.float32)
        np.testing.assert_allclose(
            est.ace_variance_leading(_t(p), 4, 20).numpy(),
            np.asarray(jest.ace_variance_leading(jnp.asarray(p), 4, 20)),
            rtol=RTOL)
        np.testing.assert_allclose(
            est.rse_variance(_t(p), 4, 20, 500).numpy(),
            np.asarray(jest.rse_variance(jnp.asarray(p), 4, 20, 500)),
            rtol=RTOL)

    def test_estimator_draws_w_from_its_generator(self):
        _, cfg = _pair()
        e = est.AceEstimator(cfg, use_kernels=False, device="cpu",
                             generator=torch.Generator().manual_seed(9))
        assert torch.equal(e.w, sk.make_params(
            cfg, torch.Generator().manual_seed(9), CPU))

    def test_plain_estimator_matches_reference(self):
        """AceEstimator(use_kernels=False): the plain sketch path."""
        jcfg, cfg = _pair()
        j = jest.AceEstimator(jcfg)
        p = est.AceEstimator(cfg, use_kernels=False, device="cpu",
                             w=params_from_numpy(np.asarray(j.w), CPU))
        x, q = _data(150, 12, 6), _data(20, 12, 7)
        j.fit(jnp.asarray(x), batch=64)
        p.fit(x, batch=64)
        _assert_state(p.state, j.state)
        np.testing.assert_array_equal(p.score(q).numpy(),
                                      np.asarray(j.score(jnp.asarray(q))))
        np.testing.assert_allclose(float(p.mu), float(j.mu), rtol=RTOL)
        p.remove(x[:30])
        j.remove(jnp.asarray(x[:30]))
        _assert_state(p.state, j.state)

    def test_round_trips(self):
        jcfg, _ = _pair()
        js = jsk.insert_buckets(jsk.init(jcfg),
                                jnp.asarray(_bucket_ids(9, 8, 16, 60)), jcfg)
        _assert_state(_jstate_to_port(js), js)
        w = np.asarray(jsk.make_params(jcfg))
        np.testing.assert_array_equal(
            params_to_numpy(params_from_numpy(w, CPU)), w)
