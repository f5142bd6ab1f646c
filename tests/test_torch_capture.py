"""The compile-once contract (``repro_torch.core.capture``): the port's
``Guardrail.admit`` and ``StreamRunner.consume`` build one program a
signature, and their ``trace_count`` equals the reference's jitted
``trace_count`` after every call of the reference tests' sequences, on the
same seeded inputs and W (the verdicts equal too).  On the CPU a program
runs keys, counting, static buffers and copy-in/copy-out and skips only
the capture and the replay (``tests/test_torch_gpu.py`` holds the captured
graphs on the card), so here: a state a caller assigns is copied in and
gives the results of the eager twin (``capture.disabled()``) bitwise, the
returned state is the program's static buffers, and ``run`` stages every
chunk in one reused host buffer with one copy each way.

Small sizes: guardrails d_model 12-16, K = 6, L = 8; runners B = 8, T = 4.
The mesh cases are left out: the reference's sharded jit mode fails on
this JAX (ROADMAP queue 3 item 5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro import resilience as jrz  # noqa: E402
from repro.data.pipeline import AceDataFilter as JFilter  # noqa: E402
from repro.fleet.filter import FleetDataFilter as JFleet  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.stream.runner import StreamRunner as JRunner  # noqa: E402
from repro.window.filter import WindowedAceFilter as JWindowed  # noqa: E402
from repro_torch.core import capture  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402
from repro_torch.data.pipeline import AceDataFilter  # noqa: E402
from repro_torch.fleet.filter import FleetDataFilter  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.stream import runner as runner_mod  # noqa: E402
from repro_torch.stream.runner import StreamRunner  # noqa: E402
from repro_torch.window.filter import WindowedAceFilter  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

CPU = torch.device("cpu")
D, CT, B = 16, 4, 8
FLAVOURS = {"flat": {}, "windowed": dict(window_epochs=2, rotate_every=2),
            "fleet": dict(num_tenants=2),
            "fleet_window": dict(num_tenants=2, window_epochs=2,
                                 rotate_every=2)}


def _embeds(rng, batch=32, seq=2, d=D, mu=0.0):
    return (mu + rng.normal(size=(batch, seq, d))).astype(np.float32)


def _guardrails(kw, use_kernels=(True, False), jkw=None):
    """The reference guardrail and the port's (each route) on its W."""
    gj = jengine.Guardrail(jengine.GuardrailConfig(**kw), **(jkw or {}))
    w = params_from_numpy(np.asarray(gj.w), CPU)
    return gj, [engine.Guardrail(engine.GuardrailConfig(**kw), device="cpu",
                                 w=w, use_kernels=u) for u in use_kernels]


def _leaves(state) -> list:
    return [x for x in capture.leaves(state) if x is not None]


def _same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


# ---------------------------------------------------------------------------
# Guardrail.admit
# ---------------------------------------------------------------------------

class TestGuardrailTraceCount:
    @pytest.mark.parametrize("use_kernels", [False, True])
    def test_one_program_across_admitted_counts(self, use_kernels):
        """tests/test_guardrail_admit.py::TestGuardrailCompileOnce: ten
        admits with a growing off-distribution share keep ONE program;
        the count equals the reference's after every admit."""
        kw = dict(d_model=12, num_bits=6, num_tables=8, warmup_items=48.0,
                  alpha=3.0)
        gj, (gp,) = _guardrails(kw, (use_kernels,),
                                dict(use_kernels=use_kernels))
        rng = np.random.default_rng(7)
        base_dir = rng.normal(size=16)
        admitted = []
        for i in range(10):
            e = rng.normal(size=(24, 3, 12)).astype(np.float32) * 0.05
            e += base_dir[:12] * 2.0
            if i >= 3:
                k = min(3 * (i - 2), 24)
                e[:k] = rng.normal(size=(k, 3, 12)) * 4.0
            want = np.asarray(gj.admit(jnp.asarray(e)))
            np.testing.assert_array_equal(gp.admit(e), want)
            assert gp.trace_count == gj.trace_count
            admitted.append(int(want.sum()))
        assert gp.trace_count == 1 and len(set(admitted)) > 1

    @pytest.mark.parametrize("flavour", list(FLAVOURS))
    def test_degraded_is_one_more_program_and_healthy_reused(self, flavour):
        """tests/test_resilience.py::test_corrupt_degrade_repair_rewarm:
        healthy serving, one more program while degraded, the healthy one
        reused after repair and re-warm — the count the reference's after
        every admit, in both port routes."""
        kw = dict(d_model=16, num_bits=6, num_tables=8, warmup_items=32.0,
                  **FLAVOURS[flavour])
        T = kw.get("num_tenants")
        gj, gps = _guardrails(kw)
        rng = np.random.default_rng(4)

        def serve():
            e = _embeds(rng)
            t = None if T is None else rng.integers(0, T, 32).astype(
                np.int32)
            want = np.asarray(gj.admit(jnp.asarray(e)) if t is None
                              else gj.admit(jnp.asarray(e), tenant_ids=t))
            for gp in gps:
                np.testing.assert_array_equal(gp.admit(e, t), want)
                assert gp.trace_count == gj.trace_count, flavour

        for _ in range(3):
            serve()
        counts = jrz.flip_count_bits(gj.state.counts, jax.random.PRNGKey(9),
                                     num_flips=3, tables=(2,))
        gj.state = gj.state._replace(counts=counts)
        for gp in gps:                    # a state assigned: copied in
            gp.state = gp.state._replace(counts=torch.as_tensor(
                np.array(counts)))
        gj.health_check()
        for gp in gps:
            gp.health_check()
            assert gp.degraded and gj.degraded
        traces = gj.trace_count
        serve()
        assert gj.trace_count == traces + 1
        gj.repair()
        for gp in gps:
            gp.repair()
        for _ in range(8):
            serve()
            gj.health_check()
            for gp in gps:
                gp.health_check()
                assert gp.degraded == gj.degraded
            if not gj.degraded:
                break
        assert not gj.degraded
        traces = gj.trace_count
        serve()
        assert gj.trace_count == traces == gps[0].trace_count

    def test_batch_shape_change_is_one_more_program(self):
        kw = dict(d_model=16, num_bits=6, num_tables=8, warmup_items=32.0)
        gj, gps = _guardrails(kw)
        rng = np.random.default_rng(11)
        for batch in (32, 32, 16, 32, 16):
            e = _embeds(rng, batch=batch)
            want = np.asarray(gj.admit(jnp.asarray(e)))
            for gp in gps:
                np.testing.assert_array_equal(gp.admit(e), want)
                assert gp.trace_count == gj.trace_count
        assert gj.trace_count == 2


class TestGuardrailStaticState:
    @pytest.mark.parametrize("flavour", list(FLAVOURS))
    def test_assigned_state_copied_in_like_the_eager_twin(self, flavour):
        """A state assigned between admits (a repair, a restore) is copied
        into the program's buffers: verdicts and state bitwise those of
        the same guardrail run eagerly under ``capture.disabled()``."""
        kw = dict(d_model=16, num_bits=6, num_tables=8, warmup_items=16.0,
                  **FLAVOURS[flavour])
        T = kw.get("num_tenants")
        g = engine.Guardrail(engine.GuardrailConfig(**kw), device="cpu")
        twin = engine.Guardrail(engine.GuardrailConfig(**kw), device="cpu",
                                w=g.w)
        rng = np.random.default_rng(12)
        batches = [(_embeds(rng), None if T is None else
                    rng.integers(0, T, 32).astype(np.int32))
                   for _ in range(6)]
        for i, (e, t) in enumerate(batches):
            if i == 3:
                counts = g.state.counts.clone()
                counts.view(-1)[::7] += 3
                g.state = g.state._replace(counts=counts)
                twin.state = twin.state._replace(counts=counts.clone())
            got = g.admit(e, t)
            with capture.disabled():
                want = twin.admit(e, t)
            np.testing.assert_array_equal(got, want)
            assert _same_bits(g.state, twin.state)
        assert g.trace_count == 1 and twin.trace_count == 0

    def test_returned_state_is_the_static_buffers(self):
        kw = dict(d_model=16, num_bits=6, num_tables=8, warmup_items=16.0)
        g = engine.Guardrail(engine.GuardrailConfig(**kw), device="cpu")
        rng = np.random.default_rng(13)
        g.admit(_embeds(rng))
        first = _leaves(g.state)
        kept = [x.clone() for x in first]
        g.admit(_embeds(rng))
        assert all(a is b for a, b in zip(_leaves(g.state), first))
        # the state of the first admit is dead: its leaves now hold the
        # second admit's values (donation)
        assert not torch.equal(first[1], kept[1])      # n moved on


# ---------------------------------------------------------------------------
# StreamRunner.consume
# ---------------------------------------------------------------------------

def _stream(rng, T=CT, b=B, d=D, mu=0.0):
    return (mu + rng.normal(size=(T, b, d + 1))).astype(np.float32)


def _runners(kind, **kw):
    """(reference runner, port runner, reference (state, w), port (state,
    w)) of one filter kind on one W."""
    base = dict(d_model=D, num_bits=6, num_tables=8, warmup_items=16.0,
                alpha=3.0)
    rkw = kw.pop("runner", {})
    if kind == "fleet":
        jf, pf = JFleet(num_tenants=2, **base, **kw), FleetDataFilter(
            num_tenants=2, **base, **kw, device="cpu")
    elif kind == "window":
        kw = {"num_epochs": 3, "rotate_every": 2, **kw}
        jf, pf = JWindowed(**base, **kw), WindowedAceFilter(
            **base, **kw, device="cpu")
    else:
        jf = JFilter(**base, hash_mode=kind, **kw)
        pf = AceDataFilter(**base, hash_mode=kind, **kw, device="cpu")
    jr, pr = JRunner(jf, chunk_T=CT, **rkw), StreamRunner(pf, CT, **rkw)
    (js, jw), (ps, pw) = jr.init(), pr.init()
    if kind != "srht":
        pw = params_from_numpy(np.asarray(jw), CPU)
    return jr, pr, (js, jw), (ps, pw)


def _tids(rng, T=CT, b=B):
    return rng.integers(0, 2, size=(T, b)).astype(np.int32)


RUN_CASES = {
    # tests/test_stream.py: one program across chunks, dense and SRHT
    "dense": dict(kind="dense"), "srht": dict(kind="srht"),
    # tests/test_window.py: the in-chunk clock, R a multiple of T
    "window": dict(kind="window"),
    "window_r8_masks": dict(kind="window", rotate_every=8,
                            runner=dict(return_masks=True)),
    # tests/test_fleet.py: the fleet scan
    "fleet": dict(kind="fleet"),
    # tests/test_attribution.py: attribution on the flat, windowed and
    # fleet runners
    "attr_flat": dict(kind="dense", attr_rows=5, attr_bits=6),
    "attr_window": dict(kind="window", attr_rows=4, attr_bits=6),
    "attr_fleet": dict(kind="fleet", attr_rows=5, attr_bits=6),
    "quantile_fleet": dict(kind="fleet", threshold_mode="quantile"),
}


class TestRunnerTraceCount:
    @pytest.mark.parametrize("case", list(RUN_CASES))
    def test_one_program_a_run(self, case):
        """Three chunks, then a masked one (one more program: the mask
        code is its own), then an unmasked one reusing the first — the
        count the reference's after every chunk, summaries alike."""
        kw = dict(RUN_CASES[case])
        kind = kw.pop("kind")
        jr, pr, (js, jw), (ps, pw) = _runners(kind, **kw)
        rng = np.random.default_rng(20)
        mask = np.ones((2, 8) if kind == "fleet" else 8, np.float32)
        mask[..., 3] = 0.0
        for i in range(5):
            f = _stream(rng, mu=2.0 if i < 3 else -2.0)
            t = _tids(rng) if kind == "fleet" else None
            m = mask if i == 3 else None
            jout = jr.consume(js, jw, jnp.asarray(f),
                              *(() if t is None else (jnp.asarray(t),)),
                              table_mask=None if m is None
                              else jnp.asarray(m))
            pout = pr.consume(ps, pw, torch.from_numpy(f),
                              None if t is None else torch.from_numpy(t),
                              table_mask=None if m is None
                              else torch.from_numpy(m))
            js, ps = jout[0], pout[0]
            assert pr.trace_count == jr.trace_count, (case, i)
            jsum, psum = jax.device_get(jout[1]), pout[1]
            for name in ("kept_frac", "anom_counts", "quarantined",
                         "degraded", "n"):
                np.testing.assert_array_equal(
                    getattr(psum, name).numpy(),
                    np.asarray(getattr(jsum, name)), err_msg=name)
            if len(jout) == 3:
                np.testing.assert_array_equal(pout[2].numpy(),
                                              np.asarray(jout[2]))
        assert pr.trace_count == 2

    def test_chunk_shape_change_is_one_more_program(self):
        jr, pr, (js, jw), (ps, pw) = _runners("dense")
        rng = np.random.default_rng(21)
        for b in (8, 16, 8):
            f = _stream(rng, b=b)
            js, _ = jr.consume(js, jw, jnp.asarray(f))
            ps, _ = pr.consume(ps, pw, torch.from_numpy(f))
            assert pr.trace_count == jr.trace_count
        assert pr.trace_count == 2

    @pytest.mark.parametrize("kind", ["dense", "fleet"])
    def test_run_is_one_program(self, kind):
        """``run`` over 3 chunks and a trailing part: one program, as the
        reference's."""
        jr, pr, (js, jw), (ps, pw) = _runners(kind)
        rng = np.random.default_rng(22)
        feats = list(_stream(rng, T=3 * CT + 2))
        tids = list(_tids(rng, T=3 * CT + 2)) if kind == "fleet" else None
        js, jsums = jr.run(js, jw, feats, tenant_ids=tids)
        ps, psums = pr.run(ps, pw, feats, tenant_ids=tids)
        assert pr.trace_count == jr.trace_count == 1
        for a, b in zip(psums, jsums):
            np.testing.assert_array_equal(a.anom_counts, b.anom_counts)


class TestRunnerStaticState:
    @pytest.mark.parametrize("kind", ["dense", "window", "fleet"])
    def test_assigned_state_copied_in_like_the_eager_twin(self, kind):
        """A state handed in that is not the program's buffers (a restore,
        the cluster's adoption) is copied in: summaries, keep masks and
        states bitwise those of ``capture.disabled()``."""
        _, pr, _, (ps, pw) = _runners(kind, runner=dict(return_masks=True))
        twin = StreamRunner(pr.filt, CT, return_masks=True)
        ts = capture.tree_map(torch.clone, ps)
        rng = np.random.default_rng(23)
        for i in range(4):
            f = torch.from_numpy(_stream(rng))
            t = torch.from_numpy(_tids(rng)) if kind == "fleet" else None
            if i == 2:
                ps = capture.tree_map(torch.clone, ps)
                ps.counts.view(-1)[::5] += 2
                ts = capture.tree_map(torch.clone, ps)
            ps, psum, pk = pr.consume(ps, pw, f, t)
            with capture.disabled():
                ts, tsum, tk = twin.consume(ts, pw, f, t)
            assert torch.equal(pk, tk)
            assert _same_bits(psum, tsum)
            assert _same_bits(ps, ts)
        assert pr.trace_count == 1 and twin.trace_count == 0

    def test_returned_state_is_the_static_buffers(self):
        _, pr, _, (ps, pw) = _runners("dense")
        rng = np.random.default_rng(24)
        s1, _ = pr.consume(ps, pw, torch.from_numpy(_stream(rng)))
        first = _leaves(s1)
        s2, _ = pr.consume(s1, pw, torch.from_numpy(_stream(rng)))
        assert all(a is b for a, b in zip(_leaves(s2), first))
        # a foreign state comes back as the same buffers, its values in
        s3, _ = pr.consume(capture.tree_map(torch.clone, ps), pw,
                           torch.from_numpy(_stream(rng)))
        assert all(a is b for a, b in zip(_leaves(s3), first))

    @pytest.mark.parametrize("kind", ["dense", "fleet"])
    def test_run_stages_in_one_reused_buffer(self, kind, monkeypatch):
        """One H2D and one D2H a chunk, every H2D from the same host
        buffer into the same device buffer, and neither ``np.stack`` nor a
        fresh ``np.empty`` on the way: the chunk is written row by row."""
        jr, pr, (js, jw), (ps, pw) = _runners(kind)
        rng = np.random.default_rng(25)
        feats = list(_stream(rng, T=3 * CT + 1))
        tids = list(_tids(rng, T=3 * CT + 1)) if kind == "fleet" else None
        h2d, d2h = [], []
        real_in, real_out = runner_mod._to_device, runner_mod._to_host

        def to_device(x, to):
            h2d.append((x.data_ptr(), to.data_ptr()))
            return real_in(x, to)

        def to_host(x):
            d2h.append(tuple(x.shape))
            return real_out(x)

        def refused(*a, **k):
            raise AssertionError("a fresh host array in run's staging")
        with monkeypatch.context() as m:
            m.setattr(runner_mod, "_to_device", to_device)
            m.setattr(runner_mod, "_to_host", to_host)
            m.setattr(np, "stack", refused)
            m.setattr(np, "empty", refused)
            ps, psums = pr.run(ps, pw, feats, tenant_ids=tids)
        assert len(psums) == 3 and len(h2d) == 3 and len(d2h) == 3
        assert len(set(h2d)) == 1, "one host buffer, one device buffer"
        js, jsums = jr.run(js, jw, feats, tenant_ids=tids)
        for a, b in zip(psums, jsums):
            np.testing.assert_array_equal(a.anom_counts, b.anom_counts)
            np.testing.assert_array_equal(a.n, b.n)
