"""The port's open-loop front end (``repro_torch.serve.frontend``) and
``Guardrail.fail_open_mask`` against the JAX package's on the CPU.

Every scenario of the reference's ``tests/test_cluster.py::TestFrontEnd``
runs twice on a fake clock of its own: the reference ``FrontEnd`` over the
reference ``Guardrail``, and the port's over the port's, whose W is the
reference's carried across by ``core.convert``.  Each run makes the
reference test's own assertions; then the tickets must match field by
field (status, reason, admitted, deadline, submit and done times,
latency), the metrics must be equal and the verdicts bitwise.  With a
fake clock every time is exact, so nothing here has a tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro.serve import engine as jengine  # noqa: E402
from repro.serve import frontend as jfrontend  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.serve import frontend  # noqa: E402

CPU = torch.device("cpu")


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class Env:
    """One implementation: the reference's or the port's ``Guardrail``
    and ``FrontEnd`` (the port's on the reference's W)."""

    def __init__(self, port: bool):
        self.port = port
        self.fe_mod = frontend if port else jfrontend

    def guardrail(self, **gkw):
        j = jengine.Guardrail(jengine.GuardrailConfig(**gkw))
        if not self.port:
            return j
        return engine.Guardrail(engine.GuardrailConfig(**gkw), device="cpu",
                                w=params_from_numpy(np.asarray(j.w), CPU))

    def mk(self, clock, policies=("fail_open", "fail_closed"), **kw):
        g = self.guardrail(d_model=6, num_bits=5, num_tables=4,
                           warmup_items=16.0, num_tenants=len(policies),
                           fail_policy=policies)
        fcfg = self.fe_mod.FrontEndConfig(batch_size=4, seq=2, d_model=6,
                                          **kw)
        return g, self.fe_mod.FrontEnd(g, fcfg, clock=clock)

    @staticmethod
    def embed(seed=0):
        return np.random.default_rng(seed).normal(
            size=(2, 6)).astype(np.float32)


# -- the reference's ten scenarios; each returns (g, fe, tickets) --------------

def full_batches_serve_all(env):
    clock = FakeClock()
    g, fe = env.mk(clock)
    tickets = [fe.submit(env.embed(i), tenant=i % 2) for i in range(8)]
    while fe.ready():
        fe.pump()
    assert all(t.status == "served" for t in tickets)
    assert fe.metrics()["served"] == 8
    assert fe.metrics()["shed_rate"] == 0.0
    return g, fe, tickets


def queue_is_bounded_and_sheds_by_policy(env):
    clock = FakeClock()
    g, fe = env.mk(clock, max_queue=6)
    tickets = [fe.submit(env.embed(i), tenant=i % 2) for i in range(20)]
    assert fe.queue_len == 6
    shed = [t for t in tickets if t.status == "shed"]
    assert len(shed) == 14
    assert all(t.reason == "queue_full" for t in shed)
    for t in shed:   # fail_open tenant 0 ⇒ admit, fail_closed ⇒ reject
        assert t.admitted is (t.tenant == 0)
    fe.drain()
    assert fe.served == 6
    assert fe.metrics()["shed_queue_full"] == 14
    return g, fe, tickets


def submit_deadline_is_absolute(env):
    clock = FakeClock(t=100.0)
    g, fe = env.mk(clock)
    t = fe.submit(env.embed(), tenant=0, deadline=100.5)
    assert t.deadline == 100.5
    d = fe.submit(env.embed(2), tenant=0)
    assert d.deadline == clock.t + fe.cfg.default_deadline
    fe.pump(force=True)
    assert t.status == "served"
    past = fe.submit(env.embed(1), tenant=1, deadline=99.0)
    assert past.deadline == 99.0 < clock.t
    fe.pump(force=True)
    assert past.status == "shed" and past.reason == "deadline"
    return g, fe, [t, d, past]


def deadline_shed_before_serving(env):
    clock = FakeClock()
    g, fe = env.mk(clock)
    tickets = [fe.submit(env.embed(i), tenant=0) for i in range(4)]
    fe.pump()
    est = fe.est_service
    late = fe.submit(env.embed(9), tenant=1, deadline=clock.t + 0.001)
    ok = fe.submit(env.embed(10), tenant=0, deadline=clock.t + 60.0)
    clock.advance(0.002 + est)
    fe.pump(force=True)
    assert late.status == "shed" and late.reason == "deadline"
    assert late.admitted is False
    assert ok.status == "served"
    assert fe.metrics()["shed_deadline"] == 1
    return g, fe, tickets + [late, ok]


def cold_start_never_sheds_by_deadline(env):
    clock = FakeClock()
    g, fe = env.mk(clock)
    t = fe.submit(env.embed(), tenant=1, deadline=clock.t + 0.001)
    clock.advance(10.0)
    assert fe.est_service == 0.0
    assert fe.pump(force=True) == 1
    assert t.status == "served"
    assert fe.metrics()["shed_deadline"] == 0
    late = fe.submit(env.embed(1), tenant=0, deadline=clock.t + 0.001)
    clock.advance(1.0)
    fe.pump(force=True)
    assert late.status == "shed" and late.reason == "deadline"
    assert fe.metrics()["shed_deadline"] == 1
    return g, fe, [t, late]


def partial_batch_after_max_wait(env):
    clock = FakeClock()
    g, fe = env.mk(clock, max_wait=0.005)
    t = fe.submit(env.embed(), tenant=0, deadline=clock.t + 60.0)
    assert not fe.ready()
    clock.advance(0.006)
    assert fe.ready()
    assert fe.pump() == 1
    assert t.status == "served"
    return g, fe, [t]


def pad_rows_match_guardrail_quarantine(env):
    clock = FakeClock()
    g, fe = env.mk(clock)
    tickets = [fe.submit(env.embed(i), tenant=0, deadline=clock.t + 60.0)
               for i in range(5)]
    fe.drain()
    assert fe.pad_rows == 3
    assert int(g.quarantined) == fe.pad_rows
    return g, fe, tickets


def latency_accounting(env):
    clock = FakeClock()
    g, fe = env.mk(clock)
    t = fe.submit(env.embed(), tenant=0, deadline=clock.t + 60.0)
    clock.advance(0.004)
    fe.pump(force=True)
    assert t.latency is not None and t.latency >= 0.004
    return g, fe, [t]


def bad_shape_rejected(env):
    clock = FakeClock()
    g, fe = env.mk(clock)
    with pytest.raises(ValueError):
        fe.submit(np.zeros((3, 6), np.float32))
    return g, fe, []


def single_tenant_guardrail(env):
    clock = FakeClock()
    g = env.guardrail(d_model=6, num_bits=5, num_tables=4,
                      warmup_items=16.0, fail_policy="fail_closed")
    fe = env.fe_mod.FrontEnd(g, env.fe_mod.FrontEndConfig(
        batch_size=4, seq=2, d_model=6, max_queue=2), clock=clock)
    tickets = [fe.submit(env.embed(i)) for i in range(4)]
    shed = [t for t in tickets if t.status == "shed"]
    assert len(shed) == 2
    assert all(t.admitted is False for t in shed)
    fe.drain()
    return g, fe, tickets


SCENARIOS = [full_batches_serve_all, queue_is_bounded_and_sheds_by_policy,
             submit_deadline_is_absolute, deadline_shed_before_serving,
             cold_start_never_sheds_by_deadline,
             partial_batch_after_max_wait,
             pad_rows_match_guardrail_quarantine, latency_accounting,
             bad_shape_rejected, single_tenant_guardrail]

FIELDS = ("tenant", "status", "reason", "admitted", "deadline", "t_submit",
          "t_done", "latency")


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_reference(scenario):
    jg, jfe, jt = scenario(Env(port=False))
    pg, pfe, pt = scenario(Env(port=True))
    assert len(pt) == len(jt)
    for a, b in zip(pt, jt):
        for f in FIELDS:
            assert getattr(a, f) == getattr(b, f), (f, a, b)
        assert type(a.admitted) is type(b.admitted)   # bool or None
    assert pfe.metrics() == jfe.metrics()
    assert int(pg.quarantined) == int(jg.quarantined)
    assert pfe.assembly_s >= 0.0


@pytest.mark.parametrize("policy", ["fail_open", "fail_closed",
                                    ("fail_open", "fail_closed", "fail_open"),
                                    ("fail_closed",) * 4])
def test_fail_open_mask_matches_reference(policy):
    T = 1 if isinstance(policy, str) else len(policy)
    kw = dict(d_model=6, num_bits=5, num_tables=4,
              num_tenants=T, fail_policy=policy)
    want = jengine.Guardrail(jengine.GuardrailConfig(**kw)).fail_open_mask
    g = engine.Guardrail(engine.GuardrailConfig(**kw), device="cpu")
    got = g.fail_open_mask
    assert isinstance(got, np.ndarray) and got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    got[:] = ~got                       # a copy: the policy is unchanged
    np.testing.assert_array_equal(g.fail_open_mask, want)
    # the quarantine select on the device reads the same policy
    e = np.full((T, 1, 6), np.nan, np.float32)
    v = g.admit(e, np.arange(T)) if T > 1 else g.admit(e)
    np.testing.assert_array_equal(v, want)


def test_shed_reads_no_device_tensor(monkeypatch):
    """A shed answers from the host policy alone: with the device-side
    policy tensor removed, queue-full and deadline sheds still answer
    by tenant policy."""
    clock = FakeClock()
    g, fe = Env(port=True).mk(clock, max_queue=2)
    monkeypatch.delattr(g, "_fail_open")
    tickets = [fe.submit(Env.embed(i), tenant=i % 2, deadline=-1.0)
               for i in range(6)]
    assert [t.reason for t in tickets[2:]] == ["queue_full"] * 4
    fe._est_service = 0.01                     # armed: the two queued shed
    assert fe.pump(force=True) == 0
    assert all(t.status == "shed" and t.admitted is (t.tenant == 0)
               for t in tickets)
    assert fe.metrics()["shed_deadline"] == 2


def test_frontend_runs_the_kernel_path_plain_on_cpu():
    """The port's default guardrail (``use_kernels=True``) behind the
    front end: on CPU tensors the kernels take their plain versions, and
    the verdicts equal the plain guardrail's on the same batches."""
    clock = FakeClock()
    env = Env(port=True)
    gk, fek = env.mk(clock)
    gp = engine.Guardrail(gk.gcfg, use_kernels=False, device="cpu", w=gk.w)
    fep = frontend.FrontEnd(gp, fek.cfg, clock=clock)
    rng = np.random.default_rng(5)
    out = []
    for fe in (fek, fep):
        ts = [fe.submit(rng.normal(size=(2, 6)).astype(np.float32),
                        tenant=i % 2) for i in range(30)]
        fe.drain()
        out.append([t.admitted for t in ts])
        rng = np.random.default_rng(5)
    assert out[0] == out[1]
    assert torch.equal(gk.state.counts, gp.state.counts)


class StepClock:
    """A clock that moves ``step`` seconds at every read, so a batch's
    assembly and its service each take one step."""

    def __init__(self, step):
        self.t, self.step = 0.0, step

    def __call__(self):
        self.t += self.step
        return self.t


def test_deadline_check_counts_service_alone():
    """The deadline check is the reference's: the EWMA of the ``admit``
    call alone.  On a clock that moves at every read the batch's assembly
    takes time too; it is counted in ``assembly_s`` and not in the check,
    so a request whose slack covers the service but not service +
    assembly is served by both packages."""
    out = {}
    for port in (False, True):
        clock = StepClock(0.01)
        g, fe = Env(port).mk(clock)
        for i in range(4):
            fe.submit(Env.embed(i), tenant=0, deadline=1e9)
        fe.pump(force=True)                   # arms: service one step
        late = fe.submit(Env.embed(5), tenant=1, deadline=clock.t + 0.035)
        fe.pump(force=True)
        out[port] = (late.status, fe.metrics())
        if port:
            assert fe.assembly_s == pytest.approx(0.02)   # a step a batch
    assert out[True] == out[False]
    assert out[True][0] == "served"
    assert out[True][1]["est_service_s"] == pytest.approx(0.01)


class SlowGuardrail:
    """A guardrail whose every ``admit`` moves the fake clock by the next
    of ``service`` seconds (the clock stands still everywhere else)."""

    def __init__(self, g, clock, service):
        self.g, self.clock, self.service = g, clock, list(service)

    multi_tenant = property(lambda self: self.g.multi_tenant)
    fail_open_mask = property(lambda self: self.g.fail_open_mask)

    def admit(self, *args):
        self.clock.advance(self.service.pop(0))
        return self.g.admit(*args)


def service_past_the_slack(env):
    """A batch slower than the default slack arms an estimate past it:
    default-deadline requests shed, but one whose deadline allows the
    estimate is served, its fast sample pulls the EWMA back under the
    slack, and default-deadline requests are served again."""
    clock = FakeClock()
    g, fe = env.mk(clock)
    fe.g = SlowGuardrail(g, clock, [0.080] + [0.001] * 3)
    first = fe.submit(env.embed(0), tenant=0)
    fe.pump(force=True)                        # cold start: served
    assert fe.est_service == pytest.approx(0.080)
    shed = fe.submit(env.embed(1), tenant=1)   # slack 0.05 < 0.08
    fe.pump(force=True)
    assert shed.status == "shed" and shed.reason == "deadline"
    long = []
    for i in range(2):                         # a batch each
        long.append(fe.submit(env.embed(2 + i), tenant=0,
                              deadline=clock.t + 1.0))
        fe.pump(force=True)
    assert all(t.status == "served" for t in long)
    assert fe.est_service < fe.cfg.default_deadline
    again = fe.submit(env.embed(9), tenant=1)
    assert fe.pump(force=True) == 1
    assert again.status == "served"
    return g, fe, [first, shed] + long + [again]


def test_service_past_the_slack_recovers_like_the_reference():
    jg, jfe, jt = service_past_the_slack(Env(port=False))
    pg, pfe, pt = service_past_the_slack(Env(port=True))
    for a, b in zip(pt, jt, strict=True):
        for f in FIELDS:
            assert getattr(a, f) == getattr(b, f), (f, a, b)
    assert pfe.metrics() == jfe.metrics()


def test_staging_rows_are_reset_between_batches():
    """The reused staging array: a short batch after a full one pads with
    NaN again (the full batch's rows do not leak into it), so the pads
    stay the only quarantined rows and the verdicts equal a fresh front
    end's on the same short batch."""
    clock = FakeClock()
    env = Env(port=True)
    g, fe = env.mk(clock)
    rows = [env.embed(i) for i in range(7)]
    for i in range(4):
        fe.submit(rows[i], tenant=i % 2, deadline=1e9)
    fe.pump(force=True)
    tail = [fe.submit(rows[i], tenant=i % 2, deadline=1e9) for i in (4, 5)]
    fe.pump(force=True)
    assert fe.pad_rows == 2 and int(g.quarantined) == 2
    assert np.isnan(fe._stage[2:]).all()
    g2 = engine.Guardrail(g.gcfg, device="cpu", w=g.w)
    fe2 = frontend.FrontEnd(g2, fe.cfg, clock=clock)
    for i in range(4):
        fe2.submit(rows[i], tenant=i % 2, deadline=1e9)
    fe2.pump(force=True)
    fresh = [fe2.submit(rows[i], tenant=i % 2, deadline=1e9) for i in (4, 5)]
    fe2._stage = np.full_like(fe2._stage, np.nan)   # nothing reused
    fe2.pump(force=True)
    assert [t.admitted for t in tail] == [t.admitted for t in fresh]
