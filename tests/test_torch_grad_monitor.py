"""The port's ACE gradient monitor (``repro_torch.train.fault``:
``MonitorState``, ``GradMonitor``) and the reference-order walk it reads
its leaves with (``repro_torch.models.convert.reference_leaves``) against
the reference's ``GradMonitor``, on the reference's W (carried across as
numpy) and numpy-drawn gradients, on the CPU, through the plain path and
the kernel path (each kernel wrapper's plain version on CPU tensors).

Tolerances: the walk's names and shapes exact; features rtol 1e-6 (a
stacked leaf's norm is the root of its parts' squared norms, not one
norm over the stack); verdicts, integer counts, n, anomalies and the
consecutive count exact, and the kernel path's bitwise the plain path's;
scores exact (the same counts, the same float32(1/L) scaling); the
Welford mean and M2 rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro.models.registry import Arch as JArch  # noqa: E402
from repro.train.fault import GradMonitor as JMonitor  # noqa: E402
from repro_torch.models.convert import (params_to_reference,  # noqa: E402
                                        reference_leaves)
from repro_torch.models.registry import Arch, tree_map  # noqa: E402
from repro_torch.train.fault import GradMonitor  # noqa: E402
from torch_zoo_helpers import one_torch_thread  # noqa: E402

_threads = pytest.fixture(autouse=True, scope="module")(one_torch_thread)
CPU = torch.device("cpu")


def _olmo_grads(seed=0):
    shapes = Arch("olmo_1b", reduced=True)._shapes()
    rng = np.random.default_rng(seed)
    return tree_map(lambda t: torch.from_numpy(
        rng.normal(size=tuple(t.shape)).astype(np.float32)
        * np.float32(rng.uniform(0.01, 3.0))), shapes)


def _jax(tree):
    return jax.tree.map(jnp.asarray, params_to_reference(tree))


def test_leaf_order_is_the_references():
    for name in ("olmo_1b", "jamba_v01_52b", "whisper_tiny"):
        ja = JArch(name, reduced=True)
        shapes = jax.eval_shape(lambda k: ja.init_params(k)[0],
                                jax.random.PRNGKey(0))
        want = [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                          for k in path), leaf.shape)
                for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)]
        got = [(leaf.name, ((len(leaf.parts),) if leaf.stacked else ())
                + tuple(leaf.parts[0].shape))
               for leaf in reference_leaves(Arch(name,
                                                 reduced=True)._shapes())]
        assert got == want, name
    olmo = reference_leaves(_olmo_grads())
    assert len(olmo) == 8 and olmo[0].name == "blocks/0/mixer/wk" \
        and olmo[-1].name == "embed" and len(olmo[0].parts) == 4


@pytest.mark.parametrize("feature_dim", [32, 5, 9])
def test_features_on_a_reduced_olmo_gradient_tree(feature_dim):
    """32: eight leaves padded to 31; 5: truncated to 4; 9: exactly 8."""
    grads = _olmo_grads()
    loss = np.float32(6.25)
    want = np.asarray(JMonitor(feature_dim=feature_dim).features(
        _jax(grads), jnp.asarray(loss)))
    got = GradMonitor(feature_dim=feature_dim, device="cpu").features(
        grads, torch.tensor(loss)).numpy()
    assert got.shape == want.shape == (feature_dim + 1,)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the stacked norms, leaf by leaf: each over all four superblocks
    n = min(8, feature_dim - 1)
    for leaf, f in zip(reference_leaves(grads)[:n], got[:n]):
        whole = np.linalg.norm(np.stack([p.numpy() for p in leaf.parts])
                               .astype(np.float64))
        np.testing.assert_allclose(f, np.log1p(whole), rtol=1e-6)


def _sequence():
    """60 healthy steps, a 1000x spike, three more spikes, then healthy."""
    rng = np.random.default_rng(0)

    def grads_like(scale):
        return {"a": (rng.normal(size=(16,)) * scale).astype(np.float32),
                "b": (rng.normal(size=(8,)) * scale).astype(np.float32)}
    seq = [(grads_like(1.0), 1.0) for _ in range(60)]
    seq += [(grads_like(1000.0), 50.0) for _ in range(4)]
    seq += [(grads_like(1.0), 1.0) for _ in range(6)]
    return seq


@pytest.fixture(scope="module")
def reference_run():
    gm = JMonitor(feature_dim=8, warmup=20, alpha=4.0)
    state, w = gm.init()
    step = jax.jit(gm.step)
    out = []
    for g, loss in _sequence():
        state, anom, score = step(state, w, jax.tree.map(jnp.asarray, g),
                                  jnp.float32(loss))
        out.append((bool(anom), float(score), float(state.ace.n),
                    float(state.consecutive),
                    float(gm.rollback_needed(state))))
    return np.asarray(w), out, state


def _port_run(w, use_kernels):
    gm = GradMonitor(feature_dim=8, warmup=20, alpha=4.0,
                     use_kernels=use_kernels, device="cpu")
    state, _ = gm.init()
    w = torch.from_numpy(np.array(w))
    out = []
    for g, loss in _sequence():
        state, anom, score = gm.step(
            state, w, {k: torch.from_numpy(v) for k, v in g.items()},
            torch.tensor(loss))
        assert anom.dtype == torch.bool and anom.shape == ()
        out.append((bool(anom), float(score), float(state.ace.n),
                    float(state.consecutive),
                    float(gm.rollback_needed(state))))
    return out, state


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_scripted_sequence_with_a_spike(reference_run, use_kernels):
    w, want, jstate = reference_run
    got, state = _port_run(w, use_kernels)
    assert got == want
    flags = [f for f, *_ in got]
    assert sum(flags[:60]) <= 4 and flags[60]       # the spike flagged
    np.testing.assert_array_equal(state.ace.counts.numpy(),
                                  np.asarray(jstate.ace.counts))
    for f in ("welford_mean", "welford_m2"):
        np.testing.assert_allclose(float(getattr(state.ace, f)),
                                   float(getattr(jstate.ace, f)), rtol=1e-6)
    assert float(state.anomalies) == float(jstate.anomalies)
    assert float(state.warmup_left) == float(jstate.warmup_left) == 0.0


def test_kernel_path_bitwise_the_plain_path(reference_run):
    w = reference_run[0]
    (a, sa), (b, sb) = _port_run(w, False), _port_run(w, True)
    assert a == b
    for x, y in zip(sa.ace, sb.ace):
        assert x is None and y is None or torch.equal(x, y)


@pytest.mark.parametrize("kernels", [False, True],
                         ids=["plain", "kernels"])
def test_step_features_takes_the_path_it_is_given(reference_run, kernels):
    """``step_features(kernels=...)`` overrides ``use_kernels``: the
    plain version the card's check holds the kernel path against, on a
    kernel monitor, runs the reference's sequence as ``step`` does."""
    w, want, _ = reference_run
    gm = GradMonitor(feature_dim=8, warmup=20, alpha=4.0,
                     use_kernels=not kernels, device="cpu")
    state, _ = gm.init()
    w = torch.from_numpy(np.array(w))
    got = []
    for g, loss in _sequence():
        feat = gm.features({k: torch.from_numpy(v) for k, v in g.items()},
                           torch.tensor(loss))[None]
        state, anom, score = gm.step_features(state, w, feat,
                                              kernels=kernels)
        got.append((bool(anom), float(score), float(state.ace.n),
                    float(state.consecutive),
                    float(gm.rollback_needed(state))))
    assert got == want


def test_rollback_needed_after_max_consecutive(reference_run):
    """The spikes at steps 60-63: the run length climbs past
    max_consecutive = 3 and trips rollback_needed, then clears."""
    _, want, _ = reference_run
    runs = [c for _, _, _, c, _ in want[60:65]]
    trips = [r for *_, r in want]
    assert max(runs) >= 3 and trips[60 + int(np.argmax(runs))] == 1.0
    assert trips[-1] == 0.0


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_warmup_never_flags(use_kernels):
    gm = GradMonitor(feature_dim=4, warmup=100, use_kernels=use_kernels,
                     device="cpu")
    state, w = gm.init()
    state, anom, _ = gm.step(state, w, {"a": torch.ones((4,)) * 1e6},
                             torch.tensor(1e9))
    assert not bool(anom) and float(state.ace.n) == 1.0
    jgm = JMonitor(feature_dim=4, warmup=100)
    js, jw = jgm.init()
    _, janom, _ = jgm.step(js, jw, {"a": jnp.ones((4,)) * 1e6},
                           jnp.asarray(1e9))
    assert bool(janom) == bool(anom)
    assert gm.ace_cfg.seed == 17 and gm.ace_cfg.welford_min_n == 100.0
    assert gm.ace_cfg.dim == 5 and gm.num_bits == 12 \
        and gm.num_tables == 32 and gm.max_consecutive == 3
