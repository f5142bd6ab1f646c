"""The port's schedules, optimisers and gradient compression
(``repro_torch.train.schedule``, ``optim``, ``compression``) against the
reference's, on one set of numpy inputs: a reduced olmo_1b parameter
tree and five steps of gradients, drawn with numpy, held in the port's
layout and stacked into the reference's (``params_to_reference``).

Tolerances:
* ``RsqrtSchedule``, ``ConstantSchedule``: bitwise; ``CosineSchedule``:
  within 2 ulp (rtol 3e-7) — XLA's and PyTorch's float32 cos are
  different approximations, each within an ulp of the true value (the
  port takes cos in float64 and rounds once, the closest it can get);
* Sgd (three modes) and AdamW: rtol 1e-6 on parameters and moments
  (the same float32 formula; PyTorch's CPU float32 sqrt can be an ulp
  off XLA's correctly rounded one); Adafactor the same, its means over
  rows and columns summed in another order;
* ``global_norm``: rtol 1e-6 (per-leaf norms summed, not per-leaf sums
  of squares); the clipped gradients rtol 1e-6;
* compression, with the reference's ``jax.random`` noise carried across
  as numpy: q and the scales bitwise, the residual rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro.models.registry import Arch as JArch  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train import optim as jopt  # noqa: E402
from repro.train import schedule as jsched  # noqa: E402
from repro_torch.models.convert import (params_to_reference,  # noqa: E402
                                        reference_leaves)
from repro_torch.models.registry import Arch, leaves, tree_map  # noqa: E402
from repro_torch.train import compression as tcomp  # noqa: E402
from repro_torch.train import optim as topt  # noqa: E402
from repro_torch.train import schedule as tsched  # noqa: E402
from torch_zoo_helpers import one_torch_thread  # noqa: E402

_threads = pytest.fixture(autouse=True, scope="module")(one_torch_thread)
RTOL = 1e-6


def _close(actual, desired, rtol=RTOL):
    actual, desired = np.asarray(actual), np.asarray(desired)
    np.testing.assert_allclose(
        actual, desired, rtol=rtol,
        atol=rtol * float(np.max(np.abs(desired), initial=0.0)))


def _trees_close(port_tree, ref_tree, rtol=RTOL):
    a = jax.tree.leaves(params_to_reference(port_tree))
    b = jax.tree.leaves(ref_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == np.shape(y)
        _close(x, y, rtol)


def _draw(tree, rng, scale=1.0):
    return tree_map(lambda t: torch.from_numpy(
        (rng.normal(size=tuple(t.shape)) * scale).astype(np.float32)), tree)


@pytest.fixture(scope="module")
def tree():
    """(params, five gradient trees) of reduced olmo_1b, numpy-drawn."""
    shapes = Arch("olmo_1b", reduced=True)._shapes()
    rng = np.random.default_rng(0)
    params = _draw(shapes, rng, 0.05)
    grads = [_draw(shapes, rng, s) for s in (1.0, 0.3, 3.0, 1e-3, 1.0)]
    return params, grads


def _jax(tree):
    return jax.tree.map(jnp.asarray, params_to_reference(tree))


@pytest.mark.parametrize("name", ["cosine", "cosine_short", "rsqrt", "const"])
def test_schedules(name):
    kw, cls = {"cosine": ({}, "CosineSchedule"),
               "cosine_short": (dict(peak_lr=1e-3, warmup_steps=7,
                                     total_steps=300), "CosineSchedule"),
               "rsqrt": (dict(peak_lr=1e-2, warmup_steps=13),
                         "RsqrtSchedule"),
               "const": (dict(lr=3e-4), "ConstantSchedule")}[name]
    js, ts = getattr(jsched, cls)(**kw), getattr(tsched, cls)(**kw)
    steps = np.arange(0, 12_000, 37, dtype=np.int32)
    want = np.array([np.asarray(js(jnp.asarray(s))) for s in steps])
    got = np.array([ts(torch.tensor(s)).numpy() for s in steps])
    assert got.dtype == np.float32
    if cls == "CosineSchedule":
        ulps = np.abs(got.view(np.int32).astype(np.int64)
                      - want.view(np.int32).astype(np.int64))
        assert ulps.max() <= 2, ulps.max()
    else:
        np.testing.assert_array_equal(got, want)
    assert ts(5).dtype == torch.float32           # a Python int step


def test_global_norm_and_clip(tree):
    _, grads = tree
    for g in grads[:3]:
        jg = _jax(g)
        _close(topt.global_norm(g), jopt.global_norm(jg))
        for max_norm in (1.0, 1e9):
            tc, tn = topt.clip_by_global_norm(g, max_norm)
            jc, jn = jopt.clip_by_global_norm(jg, max_norm)
            _close(tn, jn)
            _trees_close(tc, jc)
            assert all(t.dtype == torch.float32 for t in leaves(tc))


OPTS = [("sgd", dict(momentum=0.0)), ("sgd", {}),
        ("sgd", dict(nesterov=True)), ("adamw", {}), ("adafactor", {}),
        ("adafactor", dict(weight_decay=0.01))]


@pytest.mark.parametrize("name,kw", OPTS,
                         ids=[f"{n}-{'-'.join(k) or 'default'}"
                              for n, k in OPTS])
def test_optimizer_five_steps(tree, name, kw):
    params, grads = tree
    to, jo = topt.make_optimizer(name, **kw), jopt.make_optimizer(name, **kw)
    tp = tree_map(torch.clone, params)
    ts = to.init(tp)
    jp = _jax(params)
    js = jo.init(jp)
    jupdate = jax.jit(jo.update)
    sched = tsched.CosineSchedule(peak_lr=1e-2, warmup_steps=2,
                                  total_steps=10)
    for i, g in enumerate(grads):
        lr = sched(torch.tensor(i, dtype=torch.int32))
        out = to.update(tp, g, ts, torch.tensor(i, dtype=torch.int32), lr)
        assert out[0] is tp and out[1] is ts          # in place
        jp, js = jupdate(jp, _jax(g), js, jnp.asarray(i, jnp.int32),
                         jnp.asarray(lr.numpy()))
    _trees_close(tp, jp)
    if name in ("sgd", "adamw") and ts:
        for k in ts:
            _trees_close(ts[k], js[k])
    if name == "adafactor":
        want = jax.tree.leaves(js["slots"])
        got = [s[k] for s in ts["slots"] for k in sorted(s)]
        assert len(got) == len(want)
        for x, y in zip(got, want):
            _close(x, y)


def test_skip_keeps_every_old_value(tree):
    params, grads = tree
    for name in ("adamw", "sgd", "adafactor"):
        opt = topt.make_optimizer(name)
        tp = tree_map(torch.clone, params)
        ts = opt.init(tp)
        opt.update(tp, grads[0], ts, torch.tensor(0), 1e-2)
        before = [t.clone() for t in leaves((tp, ts))]
        opt.update(tp, grads[1], ts, torch.tensor(1), 1e-2,
                   skip=torch.tensor(True))
        assert all(torch.equal(a, b) for a, b in zip(before,
                                                     leaves((tp, ts))))
        opt.update(tp, grads[1], ts, torch.tensor(1), 1e-2,
                   skip=torch.tensor(False))
        assert not all(torch.equal(a, b)
                       for a, b in zip(before, leaves((tp, ts))))


def test_adafactor_slots_are_the_reference_layout(tree):
    params, _ = tree
    slots = topt.Adafactor().init(params)["slots"]
    want = jopt.Adafactor().init(_jax(params))["slots"]
    assert [tuple(s[k].shape) for s in slots for k in sorted(s)] == \
        [x.shape for x in jax.tree.leaves(want)]


@pytest.mark.parametrize("name", ["sgd", "adamw", "adafactor"])
def test_optimizer_memory_bytes(name):
    for n in (0, 1_176_764_416, 7):
        for pb in (2, 4):
            assert topt.optimizer_memory_bytes(name, n, pb) == \
                jopt.optimizer_memory_bytes(name, n, pb)


@jax.jit
def _reference_noise(sub, jgrads):
    """The reference's per-leaf draw for one step's key."""
    ls = jax.tree.leaves(jgrads)
    keys = jax.random.split(sub, len(ls))
    return [jax.random.uniform(k, x.shape, jnp.float32) - 0.5
            for k, x in zip(keys, ls)]


def test_compression_with_carried_noise(tree, monkeypatch):
    _, grads = tree
    key = jax.random.PRNGKey(7)
    tef = tcomp.init_error_feedback(grads[0])
    jef = jcomp.init_error_feedback(_jax(grads[0]))
    for g in grads:
        jg = _jax(g)
        key, sub = jax.random.split(key)
        parts = []
        for noise, leaf in zip(_reference_noise(sub, jg),
                               reference_leaves(g)):
            noise = np.array(noise)
            parts += (list(torch.from_numpy(noise)) if leaf.stacked
                      else [torch.from_numpy(noise)])
        feed = iter(parts)
        monkeypatch.setattr(tcomp, "uniform_noise",
                            lambda shape, gen: next(feed))
        tq, tsc, tef = tcomp.compress_grads_with_ef(g, tef, None)
        jq, jsc, jef = jcomp.compress_grads_with_ef(jg, jef, sub)
        assert next(feed, None) is None
        for x, y in zip(jax.tree.leaves(params_to_reference(tq)),
                        jax.tree.leaves(jq)):
            assert x.dtype == np.int8
            np.testing.assert_array_equal(x, np.asarray(y))
        got = [float(leaf.parts[0]) for leaf in reference_leaves(tsc)]
        assert all(float(leaf.parts[0]) == float(s) for leaf in
                   reference_leaves(tsc) for s in leaf.parts)
        assert got == [float(s) for s in jax.tree.leaves(jsc)]
        _trees_close(tef.residual, jef.residual)
        _trees_close(tcomp.decompress_grads(tq, tsc),
                     jcomp.decompress_grads(jq, jsc))
    assert tcomp.compression_ratio(grads[0]) == \
        jcomp.compression_ratio(_jax(grads[0]))


def test_quantise_int8_one_tensor():
    rng = np.random.default_rng(3)
    key = jax.random.PRNGKey(1)
    for x in (rng.normal(size=(33, 7)).astype(np.float32),
              np.zeros((5,), np.float32),
              (rng.normal(size=(64,)) * 1e6).astype(np.float32)):
        jq, js = jcomp.quantise_int8(jnp.asarray(x), key)
        noise = np.array(jax.random.uniform(key, x.shape, jnp.float32)
                           - 0.5)
        tq, ts = tcomp.quantise_int8(torch.from_numpy(x),
                                     torch.from_numpy(noise))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert float(ts) == float(js)
        np.testing.assert_array_equal(
            tcomp.dequantise_int8(tq, ts).numpy(),
            np.asarray(jcomp.dequantise_int8(jq, js)))
    g = torch.Generator().manual_seed(0)
    n = tcomp.uniform_noise((1000,), g)
    assert n.dtype == torch.float32 and float(n.min()) >= -0.5 \
        and float(n.max()) < 0.5
