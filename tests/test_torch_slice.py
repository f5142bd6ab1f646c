"""The port's slice as a whole against the reference: the flat guardrail
(``Guardrail.admit``) and ``AceEstimator`` fit/score/predict, run on the
CPU (where every kernel wrapper takes its plain version) beside the JAX
package's own ``Guardrail`` and ``AceEstimator`` on the same inputs and
the same JAX-drawn W.

Tolerances: masks may differ where the two hashes flip a sign at
|proj| ~ 0 (the reference's own slack for its kernel vs jnp guardrails,
tests/test_guardrail_admit.py: under 1% of masks, and n off by at most the
number of differing masks); with no differing mask, counts and n are
bitwise and the Welford stream within rtol 1e-5.  Estimator scores are
bitwise, Welford rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro.core import estimators as jest  # noqa: E402
from repro.core import sketch as jsk  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.core import estimators as est  # noqa: E402
from repro_torch.core import sketch as sk  # noqa: E402
from repro_torch.core.convert import (params_from_numpy,  # noqa: E402
                                      state_from_numpy, state_to_numpy)
from repro_torch.dist.mesh import make_host_local_mesh  # noqa: E402
from repro_torch.models.registry import Arch  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

CPU = torch.device("cpu")
GCFG = dict(d_model=12, num_bits=6, num_tables=8, warmup_items=32.0,
            alpha=2.0)


def _batches(n, seed=11, b=16, s=3, d=12):
    """Request embeddings around a few directions, one NaN row each."""
    rng = np.random.default_rng(seed)
    topics = rng.normal(size=(3, d))
    for i in range(n):
        e = topics[rng.integers(0, 3, b)][:, None, :] \
            + 0.3 * rng.normal(size=(b, s, d))
        if i >= n // 2:                       # a growing off-topic share
            k = 2 * (i - n // 2) + 2
            e[:k] = rng.normal(size=(k, s, d)) * 3.0
        e[i % b, i % s, 0] = np.nan
        yield e.astype(np.float32)


def _pair(port_kernels, jax_kernels, **kw):
    gcfg = {**GCFG, **kw}
    gj = jengine.Guardrail(jengine.GuardrailConfig(**gcfg),
                           use_kernels=jax_kernels)
    gp = engine.Guardrail(engine.GuardrailConfig(**gcfg),
                          use_kernels=port_kernels, device="cpu",
                          w=params_from_numpy(np.asarray(gj.w), CPU))
    return gj, gp


def _compare(gj, gp, batches):
    mismatch = total = 0
    for e in batches:
        mj, mp = gj.admit(jnp.asarray(e)), gp.admit(e)
        assert mp.dtype == np.bool_ and mp.shape == mj.shape
        mismatch += int((mj != mp).sum())
        total += mj.size
    assert mismatch / total < 0.01, f"{mismatch}/{total} masks differ"
    assert gp.quarantined == gj.quarantined
    assert abs(float(gp.state.n) - float(gj.state.n)) <= mismatch
    if mismatch == 0:
        got = state_to_numpy(gp.state)
        np.testing.assert_array_equal(got["counts"],
                                      np.asarray(gj.state.counts))
        assert float(got["n"]) == float(gj.state.n)
        for k in ("welford_mean", "welford_m2"):
            np.testing.assert_allclose(got[k],
                                       float(getattr(gj.state, k)),
                                       rtol=1e-5)
    return mismatch


class TestGuardrailSlice:
    @pytest.mark.parametrize("port_kernels,jax_kernels",
                             [(True, False), (True, True), (False, False)])
    def test_admit_matches_reference(self, port_kernels, jax_kernels):
        """Six batches through warmup and past it, each with a NaN row."""
        gj, gp = _pair(port_kernels, jax_kernels)
        _compare(gj, gp, _batches(6))
        assert gp.quarantined == 6
        assert 0 < float(gp.state.n) < 6 * 16

    @pytest.mark.parametrize("port_kernels", [True, False])
    @pytest.mark.parametrize("mode", ["srht", "auto"])
    def test_admit_matches_reference_in_other_hash_modes(self, mode,
                                                         port_kernels):
        """``hash_mode="srht"`` (the SRHT ids are bitwise, so no mask may
        differ) and ``"auto"`` (which resolves to the dense family at
        d_model = 12 in both packages)."""
        gj, gp = _pair(port_kernels, True, hash_mode=mode)
        mismatch = _compare(gj, gp, _batches(6))
        if mode == "srht":
            assert mismatch == 0
            assert tuple(gp.w.shape) == (13, 0)
        assert gp.quarantined == 6

    @pytest.mark.parametrize("policy", ["fail_open", "fail_closed"])
    def test_quarantine_follows_fail_policy(self, policy):
        gj, gp = _pair(True, False, fail_policy=policy)
        e = next(_batches(1))
        mp = gp.admit(e)
        assert bool(mp[0]) is (policy == "fail_open")
        assert float(gp.state.n) == 15       # the NaN row never inserts
        np.testing.assert_array_equal(mp, gj.admit(jnp.asarray(e)))

    def test_state_carried_from_jax_continues_alike(self):
        """JAX state crosses into the port (core/convert.py) mid-stream;
        both then admit the same batches alike."""
        gj, gp = _pair(True, False)
        batches = list(_batches(6))
        for e in batches[:3]:
            gj.admit(jnp.asarray(e))
        js = gj.state
        gp.state = state_from_numpy(js.counts, js.n, js.welford_mean,
                                    js.welford_m2, CPU)
        gp.quarantined = gj.quarantined
        _compare(gj, gp, batches[3:])

    @pytest.mark.parametrize("use_kernels", [True, False])
    def test_one_host_transfer_per_admit(self, use_kernels, monkeypatch):
        calls = []
        real = engine._to_host

        def counted(x):
            calls.append(tuple(x.shape))
            return real(x)
        monkeypatch.setattr(engine, "_to_host", counted)
        _, gp = _pair(use_kernels, False)
        for e in _batches(3):
            gp.admit(e)
        assert calls == [(2, 16)] * 3
        assert isinstance(gp.state.counts, torch.Tensor)


class TestNotPorted:
    @pytest.mark.parametrize("kw", [
        dict(window_epochs=2, rotate_every=1, count_dtype="int16"),
        dict(count_dtype="int8"),
        dict(count_dtype="int8", esc_capacity=4)])
    def test_narrow_guardrails_now_run_like_the_reference(self, kw):
        """Narrow planes, once refused here (queue 1 item 9), now admit
        like the reference on the same W: masks, counts (in their dtype)
        and the escalation table bitwise, and the same memory bill
        (tests/test_torch_quantize.py covers every flavour)."""
        gj, gp = _pair(True, False, **kw)
        for e in _batches(6):
            np.testing.assert_array_equal(gp.admit(e),
                                          np.asarray(gj.admit(jnp.asarray(e))))
        got = state_to_numpy(gp.state)
        assert got["counts"].dtype == np.dtype(kw["count_dtype"])
        for k in ("counts", "n"):
            np.testing.assert_array_equal(got[k], np.asarray(
                getattr(gj.state, k)), err_msg=k)
        if "esc_capacity" in kw:
            for k in ("offs", "vals", "lost"):
                np.testing.assert_array_equal(
                    got[f"esc.{k}"], np.asarray(getattr(gj.state.esc, k)))
        from repro.window.ring import WindowConfig
        want = (WindowConfig(ace=gj.ace_cfg, num_epochs=2).memory_bytes()
                if "window_epochs" in kw else gj.ace_cfg.memory_bytes())
        assert gp.memory_bytes() == want

    @pytest.mark.parametrize("kw", [
        dict(num_tenants=2, threshold_mode="quantile"),
        dict(threshold_mode="quantile")])
    def test_quantile_guardrails_now_run_like_the_reference(self, kw):
        """Quantile admission, once refused here (queue 1 item 7), now
        admits like the reference on the same W: masks, counts and the
        rate histogram bitwise (tests/test_torch_quantile.py covers every
        flavour)."""
        gj, gp = _pair(True, False, quantile_q=0.05, **kw)
        T = kw.get("num_tenants")
        rng = np.random.default_rng(0)
        for e in _batches(6):
            t = None if T is None else rng.integers(0, T, 16).astype(
                np.int32)
            want = gj.admit(jnp.asarray(e)) if t is None \
                else gj.admit(jnp.asarray(e), jnp.asarray(t))
            np.testing.assert_array_equal(gp.admit(e, t), np.asarray(want))
        got = state_to_numpy(gp.state)
        for k in ("counts", "n", "qhist"):
            np.testing.assert_array_equal(got[k], np.asarray(
                getattr(gj.state, k)), err_msg=k)
        assert got["qhist"].sum() > 0

    def test_mesh_and_health_raise(self):
        """Meshes are ported (``repro_torch.dist``; across ranks in
        tests/test_torch_dist_sharded.py): on a one-rank mesh a guardrail
        admits as the unmeshed one, bitwise, and audits, serves degraded
        and repairs as it does; the fused single-card admission under a
        mesh and sharded windowed fleets are refused; the dry run's
        abstract inputs are ``meta`` tensors."""
        mesh = make_host_local_mesh()
        gcfg = engine.GuardrailConfig(d_model=8, num_bits=6, num_tables=8,
                                      warmup_items=16.0)
        with pytest.raises(ValueError, match="single-device"):
            engine.Guardrail(gcfg, device="cpu", mesh=mesh, use_kernels=True)
        plain = engine.Guardrail(gcfg, device="cpu")
        meshed = engine.Guardrail(gcfg, device="cpu", mesh=mesh,
                                  sketch_layout="table_sharded", w=plain.w)
        rng = np.random.default_rng(0)
        for _ in range(4):
            e = rng.normal(size=(16, 2, 8)).astype(np.float32)
            np.testing.assert_array_equal(meshed.admit(e), plain.admit(e))
        for k in ("counts", "n", "welford_mean", "welford_m2"):
            assert torch.equal(getattr(meshed.state, k),
                               getattr(plain.state, k)), k
        for g in (meshed, plain):           # one flipped bit in table 3
            g.state.counts[3, 5] ^= 1 << 20
        for method in ("health_check", "repair"):
            for got, want in zip(getattr(meshed, method)(),
                                 getattr(plain, method)()):
                np.testing.assert_array_equal(got, want)
            assert meshed.degraded and plain.degraded
        e = rng.normal(size=(16, 2, 8)).astype(np.float32)
        np.testing.assert_array_equal(meshed.admit(e), plain.admit(e))
        for k in ("counts", "n", "welford_mean", "welford_m2"):
            assert torch.equal(getattr(meshed.state, k),
                               getattr(plain.state, k)), k
        with pytest.raises(NotImplementedError, match="windowed fleets"):
            engine.Guardrail(engine.GuardrailConfig(
                d_model=8, num_tenants=2, window_epochs=2, rotate_every=1),
                device="cpu", mesh=mesh)
        # the dry run's abstract inputs are ported (queue 1 item 13; held
        # to the reference in tests/test_torch_dryrun.py): meta tensors
        from repro_torch.models.registry import SHAPES
        specs = Arch("olmo_1b", reduced=True).input_specs(SHAPES["train_4k"])
        assert {k: (tuple(v.shape), v.device.type)
                for k, v in specs.items()} == {
            "tokens": ((256, 4096), "meta"), "labels": ((256, 4096), "meta")}
        # health_check / repair are ported (queue 1 item 10): a fresh
        # guardrail audits healthy, repairs nothing and stays undegraded
        g = engine.Guardrail(engine.GuardrailConfig(d_model=8), device="cpu")
        for fn in (g.health_check, g.repair):
            rep = fn()
            assert rep.table_ok.shape == (32,) and rep.table_ok.all()
            assert bool(rep.ok) and bool(rep.moments_ok)
            assert not g.degraded and g._table_mask is None


class TestEstimatorSlice:
    @pytest.mark.parametrize("mode", ["dense", "srht"])
    @pytest.mark.parametrize("use_kernels", [True, False])
    def test_fit_score_predict_match_reference(self, use_kernels, mode):
        """Algorithm 1 end to end: fit in batches, score, predict, with the
        same kernel/plain choice on both sides, in both hash families."""
        cfg = dict(dim=8, num_bits=6, num_tables=8, seed=3, hash_mode=mode)
        j = jest.AceEstimator(jsk.AceConfig(**cfg), use_kernels=use_kernels)
        p = est.AceEstimator(sk.AceConfig(**cfg), use_kernels=use_kernels,
                             device="cpu",
                             w=params_from_numpy(np.asarray(j.w), CPU))
        rng = np.random.default_rng(0)
        centre = rng.normal(size=8)
        x = (centre + 0.4 * rng.normal(size=(300, 8))).astype(np.float32)
        q = np.concatenate([x[:30], rng.normal(size=(10, 8)) * 2.0]) \
            .astype(np.float32)
        j.fit(jnp.asarray(x), batch=64)
        p.fit(x, batch=64)
        got = state_to_numpy(p.state)
        np.testing.assert_array_equal(got["counts"], np.asarray(j.state.counts))
        assert float(got["n"]) == float(j.state.n) == 300
        for k in ("welford_mean", "welford_m2"):
            np.testing.assert_allclose(got[k], float(getattr(j.state, k)),
                                       rtol=1e-5)
        np.testing.assert_allclose(p.score(q).numpy(),
                                   np.asarray(j.score(jnp.asarray(q))),
                                   rtol=1e-6)
        for alpha in (0.5, 1.0):
            np.testing.assert_array_equal(
                p.predict(q, alpha=alpha).numpy(),
                np.asarray(j.predict(jnp.asarray(q), alpha=alpha)))
        np.testing.assert_allclose(float(p.mu), float(j.mu), rtol=1e-5)
        assert p.memory_bytes() == j.memory_bytes()
