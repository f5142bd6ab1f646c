"""The compile-once contract for training: the port's ``train_loop.train``
runs its step, its chunk features and its tail step each as one
``core.capture`` program, as the reference jits ``step_fn``, ``feat_fn``
and ``pb_step`` (``repro/train/train_loop.py:346``, ``:370``, ``:385``).

On the CPU a program builds keys, counts them and copies in and out, and
skips only the capture and the replay (``tests/test_torch_gpu.py -k
captured_train`` holds the graphs on the card).  Here one sequence of
``train`` calls (``CALLS``: the plain loop, two microbatches, the chunked
prefilter at T = 2 over 5 steps, so two chunks and a tail, compression,
a run that checkpoints, a monitor-tripped rollback, a checkpoint restart
with compression on) runs on reduced olmo_1b cut to two layers, in
float32, on the reference (once, module-scoped), on the port and on the
port's eager twin (``capture.disabled()``), each call from one starting
state for the three.  After every call:

* the port's step, features and tail ``trace_count`` equal the
  reference's ``step_fn``, ``feat_fn`` and ``pb_step`` ``_cache_size()``
  (both picked by the wrapped function's name: ``jax.jit`` and
  ``capture.Program`` are patched to record what they wrap), and the
  number of times the reference traced each.  One exception, asserted:
  the reference's checkpoint restore hands ``jit`` numpy arrays, which
  jit keeps in a cache entry of their own beside its Arrays' (the same
  trace; ``_cache_size()`` one more than the traces) — so after the
  restart the port's count equals the reference's traces, one less than
  its ``_cache_size()``.  A rollback and a restore build no program;
* losses, every metric, parameters, moments, sketches, the residual and
  the generator's state equal the eager twin's exactly;
* the port matches the reference within ``tests/test_torch_train_loop.py``'s
  tolerances (losses and gradient norms rtol 1e-5, learning rates rtol
  3e-7, keep fractions and verdicts exact; parameters after SGD atol
  1e-6, after AdamW 99.99% within 1e-6 and all within steps × lr; the
  sketches' counts and n exact, Welford rtol 1e-5).  The compression call
  feeds the reference's rounding noise to the port; the restart draws
  from the port's generator, so there the port is held to the reference
  in the exact fields only (its draw is its own, ``train.compression``);
* the step's static parameters and moments are the caller's tensors
  (same ``data_ptr``, no clone): the state is donated.
"""
import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro.data import pipeline as jpipe  # noqa: E402
from repro.models.registry import Arch as JArch  # noqa: E402
from repro.train import fault as jfault  # noqa: E402
from repro.train import train_loop as JT  # noqa: E402
from repro.train.compression import (  # noqa: E402
    init_error_feedback as jinit_ef)
from repro.train.optim import make_optimizer as jmake_opt  # noqa: E402
from repro_torch.core import capture  # noqa: E402
from repro_torch.data.pipeline import DataStream, StreamConfig  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    params_to_reference, reference_leaves)
from repro_torch.models.registry import Arch, leaves  # noqa: E402
from repro_torch.train import compression  # noqa: E402
from repro_torch.train import fault as tfault  # noqa: E402
from repro_torch.train import train_loop as TT  # noqa: E402
from torch_zoo_helpers import one_torch_thread  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
_threads = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

LAYERS = 2
STREAM = dict(seq_len=8, global_batch=8, seed=3)
BASE = dict(optimizer="sgd", peak_lr=1e-3, warmup_steps=1, total_steps=20,
            seed=3)
# (name, steps, TrainConfig fields); "ckpt" names the checkpoint
# directory a call saves to and restores from, "trip" patches both
# monitors' rollback_needed to true
CALLS = [
    ("plain", 3, {}),
    ("microbatches", 3, dict(optimizer="adamw", microbatches=2)),
    ("chunked", 5, dict(filter_chunk=2)),
    ("compression", 3, dict(grad_compression=True)),
    ("checkpointed", 4, dict(ckpt="a", ckpt_interval=2)),
    ("rollback", 2, dict(ckpt="a", ckpt_interval=2, max_rollbacks=1,
                         trip=True)),
    ("interrupted", 3, dict(ckpt="b", ckpt_interval=2,
                            grad_compression=True)),
    ("restart", 3, dict(ckpt="b", ckpt_interval=2, grad_compression=True)),
]
NAMES = [c[0] for c in CALLS]
# each program's function in the port and in the reference
PROGRAMS = {"step": ("train_step", "train_step"),
            "features": ("chunk_features", "<lambda>"),
            "tail": ("tail_step", "_tail_step")}
# calls whose reference state at the first step is a checkpoint restore
# that the reference's own steps then replace: numpy arrays, then Arrays
RESTORED = {"restart": {"step": 1}}
EXACT = ("filter_keep_frac", "grad_anomaly", "rollback_needed",
         "straggler_breach", "rollback")


def _arches():
    a, ja = Arch("olmo_1b", reduced=True), JArch("olmo_1b", reduced=True)
    a.cfg = dataclasses.replace(a.cfg, num_layers=LAYERS)
    ja.cfg = dataclasses.replace(ja.cfg, num_layers=LAYERS)
    return a, ja


def _configs(root, fields):
    kw = {**BASE, **{k: v for k, v in fields.items()
                     if k not in ("ckpt", "trip")}}
    dirs = {}
    if "ckpt" in fields:
        dirs = {w: str(root / f"{w}_{fields['ckpt']}")
                for w in ("port", "twin", "ref")}
    return (TT.TrainConfig(**kw, ckpt_dir=dirs.get("port"), device="cpu"),
            TT.TrainConfig(**kw, ckpt_dir=dirs.get("twin"), device="cpu"),
            JT.TrainConfig(**kw, ckpt_dir=dirs.get("ref")))


def _start(a, ja, tcfg, jcfg):
    """(port state, its twin's copy, reference state): one starting
    point for the three."""
    ts = TT.init_train_state(a, tcfg)
    jp = jax.tree.map(jnp.asarray, params_to_reference(ts.params))
    mon, mon_w = jfault.GradMonitor(feature_dim=jcfg.monitor_feature_dim
                                    ).init()
    fs, fw = JT.make_data_filter(jcfg, a.cfg.d_model).init()
    ts = ts._replace(monitor_w=torch.from_numpy(np.array(mon_w)),
                     filter_w=torch.from_numpy(np.array(fw)))
    ef = jinit_ef(jp) if jcfg.grad_compression else None
    js = JT.TrainState(params=jp, opt_state=jmake_opt(jcfg.optimizer).init(jp),
                       step=jnp.zeros((), jnp.int32), monitor=mon,
                       monitor_w=mon_w, filter_state=fs, filter_w=fw, ef=ef,
                       rng=jax.random.PRNGKey(jcfg.seed))
    twin = TT.TrainState(*[
        torch.Generator().set_state(f.get_state())
        if isinstance(f, torch.Generator)
        else capture.tree_map(torch.clone, f) for f in ts])
    return ts, twin, js


def _reference_noise(params, steps: int, seed: int) -> list:
    """The rounding noise the reference's step draws (its key split off
    ``rng``, one key a leaf), as the port draws it: each part of a
    stacked leaf whole, in ``reference_leaves`` order."""
    key = jax.random.PRNGKey(seed)
    ls = jax.tree.leaves(params_to_reference(params))
    parts = reference_leaves(params)
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        for kk, x, leaf in zip(jax.random.split(sub, len(ls)), ls, parts):
            noise = np.asarray(jax.random.uniform(kk, x.shape, jnp.float32)
                               - 0.5)
            out += [torch.from_numpy(np.array(p)) for p in
                    (list(noise) if leaf.stacked else [noise])]
    return out


def _fed(tape: list):
    """``compression.uniform_noise`` handing out ``tape`` in order."""
    it = iter(tape)

    def feed(shape, generator):
        x = next(it)
        assert tuple(x.shape) == tuple(shape), (tuple(x.shape), shape)
        return x.clone()
    return feed


class _Recorded(capture.Program):
    """A ``capture.Program`` that lists itself in ``made``."""
    made: list = []

    def __init__(self, fn, *a, **k):
        super().__init__(fn, *a, **k)
        _Recorded.made.append(self)


def _port_programs() -> dict:
    by_fn = {getattr(p.fn, "__name__", None): p for p in _Recorded.made}
    return {k: by_fn.get(port) for k, (port, _) in PROGRAMS.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every call of ``CALLS`` on the reference, the port and the twin:
    {name: dict of the three's states, histories and counts, and the
    port's programs}."""
    root = tmp_path_factory.mktemp("capture_train")
    a, ja = _arches()
    jits = []
    real_jit = jax.jit

    def spy(fn, *args, **kw):
        if getattr(fn, "__name__", None) not in {r for _, r in
                                                 PROGRAMS.values()}:
            return real_jit(fn, *args, **kw)
        traced = [0]

        @functools.wraps(fn)
        def body(*x, **y):
            traced[0] += 1
            return fn(*x, **y)
        jitted = real_jit(body, *args, **kw)
        jits.append((fn.__name__, jitted, traced))
        return jitted

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", spy)
        mp.setattr(capture, "Program", _Recorded)
        for name, steps, fields in CALLS:
            tcfg, twcfg, jcfg = _configs(root, fields)
            ts, twin, js = _start(a, ja, tcfg, jcfg)
            given = {"params": [t.data_ptr() for t in leaves(ts.params)],
                     "opt_state": [t.data_ptr()
                                   for t in leaves(ts.opt_state)]}

            def stream(jaxs=False):
                if jaxs:
                    return jpipe.DataStream(jpipe.StreamConfig(
                        vocab_size=a.cfg.vocab_size, **STREAM))
                return DataStream(StreamConfig(vocab_size=a.cfg.vocab_size,
                                               **STREAM))
            with pytest.MonkeyPatch.context() as call:
                if fields.get("trip"):
                    call.setattr(jfault.GradMonitor, "rollback_needed",
                                 lambda self, st: jnp.ones((), bool))
                    call.setattr(tfault.GradMonitor, "rollback_needed",
                                 lambda self, st: torch.ones((), dtype=bool))
                jits.clear()
                js, jh = JT.train(ja, jcfg, stream(True), num_steps=steps,
                                  log_every=0, state=js)
                ref = {k: (j._cache_size(), t[0]) for k, (_, r) in
                       PROGRAMS.items() for n, j, t in jits if n == r}
                if name == "compression":
                    tape = _reference_noise(ts.params, steps, BASE["seed"])
                    call.setattr(compression, "uniform_noise", _fed(tape))
                _Recorded.made.clear()
                ts, th = TT.train(a, tcfg, stream(), num_steps=steps,
                                  log_every=0, state=ts)
                programs = _port_programs()
                if name == "compression":
                    call.setattr(compression, "uniform_noise", _fed(tape))
                _Recorded.made.clear()
                with capture.disabled():
                    twin, twh = TT.train(a, twcfg, stream(), num_steps=steps,
                                         log_every=0, state=twin)
                twin_programs = _port_programs()
            out[name] = dict(ts=ts, th=th, twin=twin, twh=twh, js=js, jh=jh,
                             ref=ref, programs=programs,
                             twin_programs=twin_programs, given=given,
                             steps=steps, fields=fields)
    return out


def _counts(programs) -> dict:
    return {k: 0 if p is None else p.trace_count for k, p in programs.items()}


@pytest.mark.parametrize("name", NAMES)
def test_trace_counts_match_the_reference(runs, name):
    """The port's counts after the call against the reference's
    ``_cache_size()`` (less the restore's numpy entry, ``RESTORED``) and
    its traces; the twin builds nothing."""
    r = runs[name]
    got = _counts(r["programs"])
    cache = {k: r["ref"].get(k, (0, 0))[0] for k in PROGRAMS}
    traced = {k: r["ref"].get(k, (0, 0))[1] for k in PROGRAMS}
    numpy_entries = {k: RESTORED.get(name, {}).get(k, 0) for k in PROGRAMS}
    assert {k: cache[k] - traced[k] for k in PROGRAMS} == numpy_entries, \
        "the reference's cache holds one more entry only for a restore"
    assert got == {k: cache[k] - numpy_entries[k] for k in PROGRAMS}
    assert got == traced
    assert _counts(r["twin_programs"]) == dict.fromkeys(PROGRAMS, 0)
    want = {"chunked": {"step": 1, "features": 2, "tail": 1}}.get(
        name, {"step": 1, "features": 0, "tail": 0})
    assert got == want


@pytest.mark.parametrize("name", ["checkpointed", "rollback", "restart"])
def test_rollback_and_restore_build_no_program(runs, name):
    """A restore at the start and a rollback mid-run write the checkpoint
    into the step's buffers: one key, its static state the state
    returned."""
    r = runs[name]
    step = r["programs"]["step"]
    assert step.trace_count == len(step._entries) == 1
    assert all(x is y for x, y in zip(leaves(step._last.state.params),
                                      leaves(r["ts"].params)))
    if name == "rollback":
        assert [h["rollback"] for h in r["th"]] == [1.0, 0.0]
        assert [h["rollback"] for h in r["jh"]] == [1.0, 0.0]
    assert int(r["ts"].step) == int(r["js"].step)


def _trees_equal(a, b, what):
    la, lb = list(leaves(a)), list(leaves(b))
    assert len(la) == len(lb), what
    for x, y in zip(la, lb):
        assert torch.equal(x, y), what


@pytest.mark.parametrize("name", NAMES)
def test_the_eager_twin_is_bitwise(runs, name):
    r = runs[name]
    assert r["th"] == r["twh"]
    for f in ("params", "opt_state", "monitor", "monitor_w", "filter_state",
              "filter_w", "ef"):
        _trees_equal(getattr(r["ts"], f), getattr(r["twin"], f), f)
    assert torch.equal(r["ts"].step, r["twin"].step)
    assert torch.equal(r["ts"].rng.get_state(), r["twin"].rng.get_state())
    if r["fields"].get("grad_compression") and name != "compression":
        # the generator drew the noise: its state moved
        fresh = torch.Generator().manual_seed(BASE["seed"]).get_state()
        assert not torch.equal(r["ts"].rng.get_state(), fresh)


def _sketch_agrees(t, j):
    np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))
    np.testing.assert_array_equal(t.n.numpy(), np.asarray(j.n))
    for f in ("welford_mean", "welford_m2"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_matches_the_reference(runs, name):
    r = runs[name]
    th, jh = r["th"], r["jh"]
    assert len(th) == len(jh)
    for t, j in zip(th, jh):
        assert set(t) == set(j)
        for k in EXACT:
            if k in j:
                assert t[k] == j[k], k
    assert int(r["ts"].step) == int(r["js"].step)
    if name in ("interrupted", "restart"):
        return                      # the port's own noise (docstring)
    for t, j in zip(th, jh):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-5)
        np.testing.assert_allclose(t["lr"], j["lr"], rtol=3e-7)
    got = np.concatenate([np.ravel(g) for g in jax.tree.leaves(
        params_to_reference(r["ts"].params))])
    want = np.concatenate([np.ravel(np.asarray(w))
                           for w in jax.tree.leaves(r["js"].params)])
    diff = np.abs(got - want)
    if r["fields"].get("optimizer") == "adamw":
        assert diff.max() <= r["steps"] * BASE["peak_lr"]
        assert np.mean(diff <= 1e-6) >= 0.9999
    else:
        assert diff.max() <= 1e-6
    _sketch_agrees(r["ts"].filter_state, r["js"].filter_state)
    _sketch_agrees(r["ts"].monitor.ace, r["js"].monitor.ace)


@pytest.mark.parametrize("name", ["plain", "microbatches", "compression"])
def test_the_step_keeps_the_state_it_is_given(runs, name):
    """Donation: the parameters and moments the step writes in place are
    its static buffers, the caller's own tensors, never cloned."""
    r = runs[name]
    step = r["programs"]["step"]
    for f in ("params", "opt_state"):
        ptrs = [t.data_ptr() for t in leaves(getattr(r["ts"], f))]
        static = [t.data_ptr() for t in leaves(getattr(step._last.state, f))]
        assert ptrs == static == r["given"][f], f
    if name == "microbatches":
        assert len(r["given"]["opt_state"]) == 2 * len(r["given"]["params"])


def test_chunk_features_read_the_step_parameters(runs):
    """The chunk features adopt the embedding table where the step's
    program keeps it."""
    r = runs["chunked"]
    feat = r["programs"]["features"]
    embed = r["programs"]["step"]._last.state.params["embed"]
    for entry in feat._entries.values():
        assert entry.where[0] == ((embed.data_ptr(), embed.stride()),)


def test_generator_is_keyed_on_its_device_and_copied_in():
    """A state's generator keys on its device only: another generator
    handed in replays the same program, its state copied into the key's
    generator, which then draws what the eager call would draw from the
    one handed in."""
    class State(NamedTuple):
        x: torch.Tensor
        g: torch.Generator

    def fn(state, x):
        return state._replace(x=x + torch.rand(3, generator=state.g)), None

    prog = capture.Program(fn, "cpu", name="gen")
    first = torch.Generator().manual_seed(1)
    state, _ = prog(State(torch.zeros(3), first), torch.ones(3))
    assert state.g is first
    state, _ = prog(State(state.x, torch.Generator().manual_seed(2)),
                    torch.ones(3))
    assert prog.trace_count == 1 and state.g is first
    want = torch.Generator().manual_seed(2)
    assert torch.equal(state.x, torch.ones(3) + torch.rand(3, generator=want))
    assert torch.equal(first.get_state(), want.get_state())


@pytest.mark.parametrize("donate", [False, True])
def test_donated_state_is_not_cloned(donate):
    """With ``donate=True`` a state leaf the function writes in place is
    kept as the static buffer (the caller's tensor); without, it is
    cloned (the guardrail's and runner's rule).  A leaf that is also an
    input is cloned either way."""
    def fn(state, x):
        state["a"].add_(x)
        return {"a": state["a"], "b": x}, None

    prog = capture.Program(fn, "cpu", name="donate", donate=donate)
    a = torch.zeros(3)
    state, _ = prog({"a": a, "b": torch.zeros(3)}, torch.ones(3))
    assert (state["a"] is a) == donate
    assert state["b"].data_ptr() != prog._last.input_leaves[0][0].data_ptr()
    state, _ = prog(state, torch.ones(3))
    assert torch.equal(state["a"], torch.full((3,), 2.0))
    assert prog.trace_count == 1
