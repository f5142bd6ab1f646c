"""The port's train step and loop (``repro_torch.train.train_loop``) and
its launcher (``repro_torch.launch.train``) against the reference's, on
the CPU at reduced configs in float32.

The two packages start from one state: the port's ``init_train_state``
(its own parameter draw) carried into the reference's layout
(``params_to_reference``), the reference's filter and monitor W carried
into the port's, zero optimiser state and fresh sketches on both sides.
Then both ``train`` on the same ``DataStream``.

Tolerances:
* filter keep fractions, the monitor's verdicts, the filter's and the
  monitor's integer counts and n: exact (the dense hash ids agree on
  every row at these sizes);
* losses and gradient norms: rtol 1e-5 (the models' float32 forward and
  backward in another summation order; see ``test_torch_train_grad``);
  learning rates within 2 ulp (``test_torch_optim``);
* parameters after SGD steps: atol 1e-6 (lr × the gradients' rtol);
  after AdamW steps, 99.99% of them within atol 1e-6 and every one
  within steps × lr: where |g| is near ε = 1e-8, m̂/(√v̂ + ε) turns a
  gradient difference of a few float32 ulps (or of sign) into an update
  difference of up to lr a step, as Adam's update is ~1 in magnitude
  there whatever g is (seen: 2 of 131,072 weights off by 2.3e-5 after
  two steps at lr 1e-3); their moments within 1e-4 of each leaf's
  largest.
The restart tests hold the port to itself: an interrupted run restored
from its checkpoint equals the uninterrupted one exactly (params within
1e-6 as the reference's own test; sketches, ring fields and the
generator's state bitwise).
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro.data import pipeline as jpipe  # noqa: E402
from repro.models.registry import Arch as JArch  # noqa: E402
from repro.train import train_loop as JT  # noqa: E402
from repro.train.compression import (  # noqa: E402
    init_error_feedback as jinit_ef)
from repro.train.fault import GradMonitor as JMonitor  # noqa: E402
from repro.train.optim import make_optimizer as jmake_opt  # noqa: E402
from repro_torch.data.pipeline import DataStream, StreamConfig  # noqa: E402
from repro_torch.dist.mesh import make_host_local_mesh  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models.convert import params_to_reference  # noqa: E402
from repro_torch.models.registry import Arch, all_cells, leaves  # noqa: E402
from repro_torch.train import fault as tfault  # noqa: E402
from repro_torch.train import train_loop as TT  # noqa: E402
from torch_zoo_helpers import one_torch_thread  # noqa: E402

_threads = pytest.fixture(autouse=True, scope="module")(one_torch_thread)
CPU = torch.device("cpu")


def _configs(**kw):
    return TT.TrainConfig(**kw, device="cpu"), JT.TrainConfig(**kw)


def _start(name, tcfg, jcfg):
    """(port Arch, port state, reference Arch, reference state): one
    starting point for both packages."""
    a, ja = Arch(name, reduced=True), JArch(name, reduced=True)
    ts = TT.init_train_state(a, tcfg)
    jp = jax.tree.map(jnp.asarray, params_to_reference(ts.params))
    mon = mon_w = fs = fw = ef = None
    if jcfg.use_grad_monitor:
        mon, mon_w = JMonitor(feature_dim=jcfg.monitor_feature_dim).init()
        ts = ts._replace(monitor_w=torch.from_numpy(np.array(mon_w)))
    if jcfg.use_data_filter:
        fs, fw = JT.make_data_filter(jcfg, a.cfg.d_model).init()
        ts = ts._replace(filter_w=torch.from_numpy(np.array(fw)))
    if jcfg.grad_compression:
        ef = jinit_ef(jp)
    js = JT.TrainState(params=jp, opt_state=jmake_opt(jcfg.optimizer).init(jp),
                       step=jnp.zeros((), jnp.int32), monitor=mon,
                       monitor_w=mon_w, filter_state=fs, filter_w=fw, ef=ef,
                       rng=jax.random.PRNGKey(jcfg.seed))
    return a, ts, ja, js


def _streams(a, **kw):
    return (DataStream(StreamConfig(vocab_size=a.cfg.vocab_size, **kw)),
            jpipe.DataStream(jpipe.StreamConfig(vocab_size=a.cfg.vocab_size,
                                                **kw)))


def _both(name, steps, stream_kw, **cfg_kw):
    tcfg, jcfg = _configs(**cfg_kw)
    a, ts, ja, js = _start(name, tcfg, jcfg)
    tstream, jstream = _streams(a, **stream_kw)
    js, jh = JT.train(ja, jcfg, jstream, num_steps=steps, log_every=0,
                      state=js)
    ts, th = TT.train(a, tcfg, tstream, num_steps=steps, log_every=0,
                      state=ts)
    return ts, th, js, jh


EXACT = ("filter_keep_frac", "grad_anomaly", "rollback_needed",
         "straggler_breach")


def _histories_agree(th, jh):
    assert len(th) == len(jh)
    for t, j in zip(th, jh):
        assert set(t) == set(j)
        for k in EXACT:
            if k in j:
                assert t[k] == j[k], k
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-5)
        np.testing.assert_allclose(t["lr"], j["lr"], rtol=3e-7)


def _params_agree(ts, js, atol):
    got = jax.tree.leaves(params_to_reference(ts.params))
    want = jax.tree.leaves(js.params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=atol)


def _sketch_agrees(t, j):
    np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))
    np.testing.assert_array_equal(t.n.numpy(), np.asarray(j.n))
    for f in ("welford_mean", "welford_m2"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=1e-5)


@pytest.fixture(scope="module")
def filtered_run():
    """Reduced olmo_1b, SGD, filter and monitor on, 10 steps of 64
    sequences: the filter arms (512 items) at step 8."""
    return _both("olmo_1b", 10, dict(seq_len=8, global_batch=64, seed=3),
                 optimizer="sgd", total_steps=20, warmup_steps=2,
                 peak_lr=1e-3, seed=3)


def test_train_steps_against_the_reference(filtered_run):
    ts, th, js, jh = filtered_run
    _histories_agree(th, jh)
    assert [h["filter_keep_frac"] for h in th[:8]] == [1.0] * 8
    _params_agree(ts, js, atol=1e-6)
    _sketch_agrees(ts.filter_state, js.filter_state)
    _sketch_agrees(ts.monitor.ace, js.monitor.ace)
    assert float(ts.filter_state.n) >= 512
    assert int(ts.step) == int(js.step) == 10


def test_quantile_mode_against_the_reference():
    ts, th, js, jh = _both(
        "olmo_1b", 10, dict(seq_len=8, global_batch=64, seed=4),
        optimizer="sgd", total_steps=20, warmup_steps=2, peak_lr=1e-3,
        use_grad_monitor=False, filter_threshold_mode="quantile",
        filter_quantile_q=0.05, seed=4)
    _histories_agree(th, jh)
    assert min(h["filter_keep_frac"] for h in th[8:]) < 1.0
    _sketch_agrees(ts.filter_state, js.filter_state)
    np.testing.assert_array_equal(ts.filter_state.qhist.numpy(),
                                  np.asarray(js.filter_state.qhist))


def test_chunks_and_tail_against_the_reference():
    """filter_chunk=3 over 7 steps: two runner chunks and one tail batch,
    the filter's sketch in the in-step path's per-batch order."""
    ts, th, js, jh = _both(
        "qwen2_1_5b", 7, dict(seq_len=8, global_batch=4, seed=7),
        optimizer="sgd", total_steps=7, warmup_steps=2,
        use_grad_monitor=False, filter_chunk=3, seed=7)
    _histories_agree(th, jh)
    assert all("filter_keep_frac" in h for h in th)
    _sketch_agrees(ts.filter_state, js.filter_state)
    _params_agree(ts, js, atol=1e-6)


def test_adamw_microbatches_and_mrope_positions_against_the_reference():
    """Two microbatches of a reduced qwen2_vl batch (input embeddings,
    (3, B, S) M-RoPE positions split on axis 1), AdamW, filter and monitor
    on: two steps of each package's ``make_train_step`` from one state."""
    tcfg, jcfg = _configs(optimizer="adamw", microbatches=2, peak_lr=1e-3,
                          warmup_steps=1, total_steps=4, seed=2)
    a, ts, ja, js = _start("qwen2_vl_7b", tcfg, jcfg)
    rng = np.random.default_rng(2)
    B, S = 4, 8
    toks = rng.integers(0, a.cfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)) \
        + rng.integers(0, 3, (3, B, 1)).astype(np.int32)
    batch = {"embeds": rng.normal(size=(B, S, a.cfg.d_model))
             .astype(np.float32), "labels": toks,
             "mask": np.ones((B, S), np.float32),
             "positions": np.ascontiguousarray(pos)}
    tstep, jstep = TT.make_train_step(a, tcfg), \
        jax.jit(JT.make_train_step(ja, jcfg))
    for _ in range(2):
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in
                            batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        assert float(tm["grad_anomaly"]) == float(jm["grad_anomaly"])
    got = np.concatenate([g.ravel() for g in jax.tree.leaves(
        params_to_reference(ts.params))])
    want = np.concatenate([np.asarray(w).ravel()
                           for w in jax.tree.leaves(js.params)])
    diff = np.abs(got - want)
    assert diff.max() <= 2 * 1e-3 and np.mean(diff <= 1e-6) >= 0.9999
    for k in ("m", "v"):
        got = jax.tree.leaves(params_to_reference(ts.opt_state[k]))
        for g, w in zip(got, jax.tree.leaves(js.opt_state[k])):
            w = np.asarray(w)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * float(
                np.max(np.abs(w))))


def _restart_case(tmp_path, name, steps, first, second, **kw):
    """(uninterrupted state, restored-and-finished state)."""
    a = Arch(name, reduced=True)
    tcfg = TT.TrainConfig(**kw, ckpt_dir=str(tmp_path / "a"), device="cpu")
    scfg = StreamConfig(vocab_size=a.cfg.vocab_size, seq_len=8,
                        global_batch=4, seed=kw["seed"])
    sa, _ = TT.train(a, tcfg, DataStream(scfg), num_steps=steps,
                     log_every=0)
    tb = TT.TrainConfig(**{**tcfg.__dict__, "ckpt_dir": str(tmp_path / "b")})
    TT.train(a, tb, DataStream(scfg), num_steps=first, log_every=0)
    sc, _ = TT.train(a, tb, DataStream(scfg), num_steps=second, log_every=0)
    assert int(sc.step) == int(sa.step) == steps
    for x, y in zip(leaves(sa.params), leaves(sc.params)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6,
                                   atol=1e-6)
    return sa, sc


RESTARTS = {
    "plain": dict(use_data_filter=False, use_grad_monitor=False,
                  ckpt_interval=5, seed=5),
    "chunked": dict(use_data_filter=True, filter_chunk=2,
                    use_grad_monitor=False, ckpt_interval=2, seed=6),
    "windowed_chunked": dict(use_data_filter=True, filter_chunk=2,
                             filter_window_epochs=2, filter_rotate_every=2,
                             use_grad_monitor=False, ckpt_interval=2,
                             seed=9),
    "compression": dict(use_data_filter=True, use_grad_monitor=True,
                        grad_compression=True, ckpt_interval=5, seed=8),
}


@pytest.mark.parametrize("case", list(RESTARTS))
def test_restart_from_checkpoint_is_exact(tmp_path, case):
    """The reference's three restart tests and a fourth with compression
    on (the generator's state rides in the checkpoint): a 10-step (8 for
    the chunked cases) run against 7 + 5 (5 + 4) steps restored from the
    checkpoint of step 5 (4)."""
    steps, first, second = (10, 7, 5) if case in ("plain", "compression") \
        else (8, 5, 4)
    sa, sc = _restart_case(tmp_path, "qwen2_1_5b", steps, first, second,
                           total_steps=20, warmup_steps=2, peak_lr=1e-3,
                           **RESTARTS[case])
    for f in ("filter_state", "monitor", "ef"):
        a, c = getattr(sa, f), getattr(sc, f)
        assert (a is None) == (c is None)
        for x, y in zip(leaves(a), leaves(c)):
            assert torch.equal(x, y), f
    assert torch.equal(sa.rng.get_state(), sc.rng.get_state())
    if case == "windowed_chunked":
        assert int(sa.filter_state.tick) == 8


def test_one_transfer_each_way_a_step(monkeypatch):
    """A chunked run with a tail: one ``_to_device`` (the batch) and one
    ``_to_host`` (the step's metrics) a step, and nothing else moved."""
    counts = {"h2d": 0, "d2h": 0}
    to_device, to_host = TT._to_device, TT._to_host

    def counted_device(batch, device):
        counts["h2d"] += 1
        return to_device(batch, device)

    def counted_host(x):
        counts["d2h"] += 1
        assert x.ndim == 1 and x.dtype == torch.float32
        return to_host(x)

    monkeypatch.setattr(TT, "_to_device", counted_device)
    monkeypatch.setattr(TT, "_to_host", counted_host)
    a = Arch("olmo_1b", reduced=True)
    tcfg = TT.TrainConfig(filter_chunk=3, warmup_steps=1, device="cpu")
    _, hist = TT.train(a, tcfg, DataStream(StreamConfig(
        vocab_size=a.cfg.vocab_size, seq_len=8, global_batch=4)),
        num_steps=5, log_every=0)
    assert counts == {"h2d": 5, "d2h": 5} and len(hist) == 5
    assert {"loss", "grad_norm", "lr", "grad_anomaly", "grad_score",
            "rollback_needed", "filter_keep_frac"} <= set(hist[0])


def test_monitor_skips_poisoned_step():
    """The reference's test, on both packages from one state: 30 healthy
    steps, then a batch of zeros with every label the last token.  The
    verdicts agree step for step; the monitor flags the poisoned step and
    the port's parameters and optimiser state stay as they were."""
    tcfg, jcfg = _configs(total_steps=100, warmup_steps=2, peak_lr=1e-3,
                          use_data_filter=False, use_grad_monitor=True,
                          seed=1)
    a, state, ja, js = _start("olmo_1b", tcfg, jcfg)
    step_fn, jstep = TT.make_train_step(a, tcfg), \
        jax.jit(JT.make_train_step(ja, jcfg))
    tstream, jstream = _streams(a, seq_len=16, global_batch=8, seed=1)
    flags = []
    for t in range(31):
        b, jb = next(tstream), next(jstream)
        if t == 30:
            for x in (b, jb):
                x["tokens"] = np.zeros_like(x["tokens"])
                x["labels"] = np.full_like(x["labels"], a.cfg.vocab_size - 1)
            before = [x.clone() for x in leaves((state.params,
                                                  state.opt_state))]
        state, m = step_fn(state, {k: torch.from_numpy(v)
                                   for k, v in b.items()
                                   if not k.startswith("_")})
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in jb.items()
                            if not k.startswith("_")})
        flags.append(float(m["grad_anomaly"]))
        assert flags[-1] == float(jm["grad_anomaly"]), t
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    assert flags[-1] == 1.0
    assert all(torch.equal(x, y) for x, y in
               zip(before, leaves((state.params, state.opt_state))))
    assert int(state.step) == 31
    _sketch_agrees(state.monitor.ace, js.monitor.ace)


def test_rollback_restores_the_newest_checkpoint(tmp_path, monkeypatch):
    a = Arch("qwen2_1_5b", reduced=True)
    tcfg = TT.TrainConfig(warmup_steps=1, use_data_filter=False,
                          ckpt_dir=str(tmp_path), ckpt_interval=2,
                          max_rollbacks=1, seed=4, device="cpu")
    scfg = StreamConfig(vocab_size=a.cfg.vocab_size, seq_len=8,
                        global_batch=4, seed=4)
    TT.train(a, tcfg, DataStream(scfg), num_steps=5, log_every=0)
    monkeypatch.setattr(tfault.GradMonitor, "rollback_needed",
                        lambda self, st: torch.ones((), dtype=torch.bool))
    stream = DataStream(scfg)
    state, hist = TT.train(a, tcfg, stream, num_steps=2, log_every=0)
    # restored step 4; its step 5 trips, rolls back to 4; the next trip
    # finds the budget spent and clears the run length instead
    assert [h["rollback"] for h in hist] == [1.0, 0.0]
    assert int(state.step) == 5 and stream.state_dict() == {"step": 5}
    assert float(state.monitor.consecutive) == 0.0


def test_launcher_on_the_cpu_and_not_ported_options():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launcher.main(["--arch", "olmo_1b", "--reduced", "--steps", "3",
                       "--batch", "4", "--seq", "16", "--device", "cpu"])
    assert "done: step=3 loss" in out.getvalue()
    # --devices/--mesh are ported (train.sharded; against one process in
    # tests/test_torch_dist_sharded.py): a mesh that does not hold the
    # ranks asked for is refused before anything spawns
    with pytest.raises(ValueError, match="ranks"):
        launcher.main(["--arch", "olmo_1b", "--reduced", "--device", "cpu",
                       "--mesh", "2x2", "--devices", "2"])
    a = Arch("olmo_1b", reduced=True)
    tcfg = TT.TrainConfig(device="cpu")
    for kw in (dict(grad_pspecs={}), dict(sketch_layout="replicated")):
        with pytest.raises(ValueError, match="mesh="):
            TT.make_train_step(a, tcfg, **kw)
    # Adafactor, compression, the chunked prefilter and checkpoints run
    # under a mesh (tests/test_torch_dist_train_features.py), and so does
    # the dry run (tests/test_torch_dryrun.py): nothing refuses them
    assert callable(TT.make_train_step(
        a, TT.TrainConfig(optimizer="adafactor", grad_compression=True,
                          filter_chunk=2, device="cpu"),
        mesh=make_host_local_mesh()))
    assert len(all_cells()) == 35 and len(all_cells(True)) == 40
    with pytest.raises(ValueError, match="filter_rotate_every"):
        TT.make_data_filter(TT.TrainConfig(filter_window_epochs=2,
                                           device="cpu"), 16)
