"""The training features a sharded run takes (ROADMAP queue 1 item 13b)
and the sharded step's collectives from shapes, across ``gloo`` ranks on
the CPU, held to the reference and to the live tally.

ONE run of ``python tests/torch_dist_helpers.py --features IN OUT``
spawns 2 ranks, then 4 (``torch_dist_helpers.features``):
* on (2, 1) and (2, 2) data × model meshes, one live step of reduced
  olmo_1b (``PLAN_CASES``: AdamW with whole and table-sharded sketches,
  Adafactor with int8 compression) against the same step run on ``meta``
  over the mesh's shape (``train.sharded.step_on_meta``): every rank's
  ``collectives.TALLY`` equal to its tally by kind, bytes and count, and
  by axis;
* ``FEATURE_CFGS``: Adafactor with FSDP over data on a (2, 1) mesh and
  with the model axis too on a (2, 2) mesh (its factored means, the mean
  of vr and the update clip all-reduced over one axis or two), int8
  compression on a (2, 1) mesh and the chunked prefilter (a (1, 2) mesh,
  its sketch table-sharded under ``StreamRunner(mesh=…)``), each against
  the reference's single-device ``train`` from the same parameters
  (``params_to_reference``), W and batches.  The compression run's ranks
  take the reference's rounding noise (drawn here with ``jax.random``,
  passed whole leaf by leaf in IN.npz, each rank slicing its block as it
  slices its own draw); the rounding noise the port draws from the step's
  generator is held to one process by the checkpoint run (compression
  on), which is also resumed from step 2 at world 2 and, here, at world 1,
  each against the uninterrupted run.
Tolerances are ``tests/test_torch_dist_sharded.py``'s for the AdamW step:
keep fractions and the monitor's verdicts exact, losses and gradient norms
rtol 1e-5, 99.99% of the parameters within 1e-6 and every one within the
summed learning rate.  The reduce-scatters and all-reduces sum in another
order than one process, so nothing is held bitwise across world sizes.

Besides (no ranks): the counterpart of the reference's
``test_elastic_checkpoint_reshard``: a tree saved unsharded (by either
package) restores as each rank's block of a (4, 2) spec.
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.models.registry import Arch as JArch
from repro.train import checkpoint as jck
from repro.train import compression as jcomp
from repro.train import train_loop as JT
from repro.train.fault import GradMonitor as JMonitor
from repro.train.optim import make_optimizer as jmake_opt
from repro_torch.dist.mesh import P
from repro_torch.models.convert import params_to_reference, reference_leaves
from repro_torch.models.registry import Arch, leaves, tree_map
from repro_torch.train import checkpoint as ck
from repro_torch.train import compression as tcomp
from repro_torch.train import train_loop as TT

import torch_dist_helpers as H

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_RUNS = ("adafactor", "adafactor_2x2", "chunked")


def _world(name: str) -> int:
    return int(np.prod(H.FEATURE_CFGS[name][1]))


def _start(name: str):
    """(the port's initial parameters, the reference's copy of them)."""
    params = TT.init_train_state(Arch("olmo_1b", reduced=True),
                                 H.feature_config(name)).params
    return params, jax.tree.map(jnp.asarray, params_to_reference(params))


def _reference_noise(name: str) -> dict:
    """The rounding noise the reference's ``train`` draws for a
    compression case, step by step (its key split off ``rng``, one key a
    leaf), as the port draws it: each part of a stacked leaf whole, in
    ``reference_leaves`` order (``cnoise_<k>`` in draw order)."""
    params, jp = _start(name)
    key = jax.random.PRNGKey(JT.TrainConfig(**H.TRAIN_CFG).seed)
    ls = jax.tree.leaves(jp)
    out, k = {}, 0
    for _ in range(H.FEATURE_STEPS):
        key, sub = jax.random.split(key)
        for kk, x, leaf in zip(jax.random.split(sub, len(ls)), ls,
                               reference_leaves(params)):
            noise = np.asarray(jax.random.uniform(kk, x.shape, jnp.float32)
                               - 0.5)
            for part in (list(noise) if leaf.stacked else [noise]):
                out[f"cnoise_{k}"] = part
                k += 1
    return out


def _reference(name: str, fw, mon_w) -> dict:
    """The reference's single-device ``train`` of a feature case,
    FEATURE_STEPS steps from the port's initial parameters."""
    fields, _, _ = H.FEATURE_CFGS[name]
    jcfg = JT.TrainConfig(**{**H.TRAIN_CFG, **fields})
    ja = JArch("olmo_1b", reduced=True)
    arch = Arch("olmo_1b", reduced=True)
    _, jp = _start(name)
    mon, _ = JMonitor(feature_dim=jcfg.monitor_feature_dim).init()
    fs, _ = JT.make_data_filter(jcfg, arch.cfg.d_model).init()
    js = JT.TrainState(params=jp, opt_state=jmake_opt(jcfg.optimizer)
                       .init(jp), step=jnp.zeros((), jnp.int32),
                       monitor=mon, monitor_w=mon_w, filter_state=fs,
                       filter_w=fw,
                       ef=(jcomp.init_error_feedback(jp)
                           if jcfg.grad_compression else None),
                       rng=jax.random.PRNGKey(jcfg.seed))
    stream = jpipe.DataStream(jpipe.StreamConfig(
        vocab_size=arch.cfg.vocab_size, seq_len=H.TRAIN_S,
        global_batch=H.TRAIN_B))
    js, hist = JT.train(ja, jcfg, stream, num_steps=H.FEATURE_STEPS,
                        log_every=0, state=js)
    out = {"params": np.concatenate([np.asarray(p).reshape(-1) for p
                                     in jax.tree.leaves(js.params)])}
    for k in ("loss", "grad_norm", "lr", "filter_keep_frac",
              "grad_anomaly"):
        out[k] = np.asarray([h[k] for h in hist])
    for f in ("counts", "n", "welford_mean", "welford_m2"):
        out[f"filter_{f}"] = np.asarray(getattr(js.filter_state, f))
    return out


def _port_run(name: str, d: dict, steps: int, **kw):
    """The port's single process of a feature case (on its W)."""
    arch = Arch("olmo_1b", reduced=True)
    tcfg = H.feature_config(name, **kw)
    state = H.feature_start(arch, tcfg, d)
    return TT.train(arch, tcfg, H.feature_stream(arch), steps, log_every=0,
                    state=state)


def _flat(state) -> np.ndarray:
    return np.concatenate([t.detach().numpy().reshape(-1)
                           for t in leaves(state.params)])


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(reference runs, the port's world-2 and world-4 outputs, the W, the
    ranks' directory)."""
    tmp = tmp_path_factory.mktemp("features")
    jcfg = JT.TrainConfig(**H.TRAIN_CFG)
    _, mon_w = JMonitor(feature_dim=jcfg.monitor_feature_dim).init()
    _, fw = JT.make_data_filter(
        jcfg, Arch("olmo_1b", reduced=True).cfg.d_model).init()
    d = {"tr_filter_w": np.asarray(fw), "tr_monitor_w": np.asarray(mon_w),
         **_reference_noise("compression")}
    runs, ref = {}, {}
    for name in REF_RUNS + ("compression",):  # one run a configuration
        key = str(H.FEATURE_CFGS[name][0])
        if key not in runs:
            runs[key] = _reference(name, fw, mon_w)
        ref[name] = runs[key]
    np.savez(tmp / "inputs.npz", **d)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests", "torch_dist_helpers.py"),
         "--features", str(tmp / "inputs.npz"), str(tmp / "out.npz")],
        capture_output=True, text=True, timeout=400, env=env)
    assert run.returncode == 0, f"stderr:\n{run.stderr[-4000:]}"
    port = {w: dict(np.load(tmp / f"w{w}" / "out.npz")) for w in (2, 4)}
    return ref, port, d, tmp


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", range(len(H.PLAN_CASES)))
def test_planned_collectives_equal_live_tally(results, world, case):
    """One sharded step on the (2, 1) and the (2, 2) mesh: every rank's
    tally equals the same step's on ``meta`` over the mesh's shape, kind
    by kind (bytes and calls) and axis by axis, and collectives moved."""
    _, port, _, _ = results
    out = port[world]
    plan = json.loads(str(out[f"plan{case}_plan"]))
    lives = [json.loads(str(s)) for s in out[f"plan{case}_live"]]
    assert len(lives) == world
    for live in lives:
        assert live == plan
    assert plan["total_bytes"] > 0 and plan["reduce-scatter"]["count"] > 0
    if world == 4 and H.PLAN_CASES[case][1] == "table_sharded":
        assert plan["by_axis"]["model"] > 0


def _within(got: np.ndarray, want: np.ndarray) -> float:
    """The fraction of parameters within 1e-6."""
    return float(np.mean(np.abs(got - want) <= 1e-6))


def _agree(got: dict, want: dict, prefix: str, lr_sum: float,
           welford=False, within=0.9999):
    """The AdamW step's tolerances (module docstring); ``within`` the
    fraction of parameters within 1e-6."""
    for k in ("filter_keep_frac", "grad_anomaly"):
        np.testing.assert_array_equal(got[f"{prefix}_{k}"], want[k],
                                      err_msg=k)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[f"{prefix}_{k}"], want[k], rtol=1e-5,
                                   err_msg=k)
    diff = np.abs(got[f"{prefix}_params"] - want["params"])
    assert diff.max() <= lr_sum
    assert _within(got[f"{prefix}_params"], want["params"]) >= within
    if welford:
        for k in ("counts", "n"):
            np.testing.assert_array_equal(got[f"{prefix}_filter_{k}"],
                                          want[f"filter_{k}"])
        for k in ("welford_mean", "welford_m2"):
            np.testing.assert_allclose(got[f"{prefix}_filter_{k}"],
                                       want[f"filter_{k}"], rtol=1e-5)


def _reference_order(port_flat: np.ndarray) -> np.ndarray:
    """The port's flat parameters (its leaf order) in the reference's."""
    arch = Arch("olmo_1b", reduced=True)
    params = TT.init_train_state(arch, H.feature_config("adafactor")).params
    flat = iter(np.split(port_flat, np.cumsum(
        [p.numel() for p in leaves(params)])[:-1]))
    got = tree_map(lambda p: torch.from_numpy(next(flat).reshape(p.shape)),
                   params)
    return np.concatenate([np.asarray(g).reshape(-1) for g in
                           jax.tree.leaves(params_to_reference(got))])


@pytest.mark.parametrize("name", REF_RUNS)
def test_feature_matches_single_device_reference(results, name):
    """Adafactor (FSDP over data on (2, 1); over data and model on
    (2, 2)), int8 compression with error feedback (FSDP over data: scales
    all-reduced, the reference's noise sliced by each rank) and the
    chunked prefilter (T = 2, its sketch table-sharded over a (1, 2) mesh)
    against the reference's single-device ``train``: histories,
    parameters and, for the prefilter, the gathered sketch (counts and n
    bitwise)."""
    ref, port, _, _ = results
    got = dict(port[_world(name)])
    got[f"f_{name}_params"] = _reference_order(got[f"f_{name}_params"])
    lr_sum = float(np.sum(ref[name]["lr"]))
    np.testing.assert_allclose(got[f"f_{name}_lr"], ref[name]["lr"],
                               rtol=3e-7)
    _agree(got, ref[name], f"f_{name}", lr_sum, welford=name == "chunked")


def test_compression_matches_single_device_reference(results,
                                                     monkeypatch):
    """int8 compression with error feedback at world 2 (FSDP over data:
    scales all-reduced (max), the reference's noise sliced by each rank,
    error feedback by the leaf's spec) against the reference's
    single-device ``train`` on the same noise, and against the port's
    single process on it.

    Against one process: every tolerance of the module docstring.
    Against the reference: the histories and the summed-lr bound as
    stated; the fraction of parameters within 1e-6 is held to what the
    port's own single process reaches against the reference less the
    1e-4 the world-2 run may differ from one process.  A gradient that
    differs in its last bit flips the stochastic rounding of an element
    whose x/scale + noise lies that close to a half-integer, and the flip
    moves it by a whole step of the int8 grid (the same flips separate
    one process from the reference: on this data about 1.25e-4 of the
    parameters lie beyond 1e-6 there, with or without a mesh)."""
    ref, port, d, _ = results
    feed, check = H.noise_feed(d)
    monkeypatch.setattr(tcomp, "uniform_noise", feed)
    state, hist = _port_run("compression", d, H.FEATURE_STEPS)
    check()
    one = {k: np.asarray([h[k] for h in hist])
           for k in ("loss", "grad_norm", "filter_keep_frac",
                     "grad_anomaly", "lr")}
    one["params"] = _reference_order(_flat(state))
    got = dict(port[2])
    got["f_compression_params"] = _reference_order(
        got["f_compression_params"])
    want = ref["compression"]
    lr_sum = float(np.sum(want["lr"]))
    np.testing.assert_allclose(got["f_compression_lr"], want["lr"],
                               rtol=3e-7)
    _agree(got, one, "f_compression", lr_sum)
    _agree(got, want, "f_compression", lr_sum,
           within=_within(one["params"], want["params"]) - 1e-4)


def test_compression_matches_one_process(results):
    """int8 compression with error feedback at world 2 on the port's own
    noise (the checkpoint run: every rank draws each leaf's noise whole
    from the step's generator and slices its block) against the port's
    single process on the same state, generator and batches."""
    _, port, d, _ = results
    state, hist = _port_run("ckpt", d, H.FEATURE_STEPS)
    want = {k: np.asarray([h[k] for h in hist])
            for k in ("loss", "grad_norm", "filter_keep_frac",
                      "grad_anomaly", "lr")}
    want["params"] = _flat(state)
    _agree(port[2], want, "f_ckpt", float(np.sum(want["lr"])))


def test_checkpoint_resumes_at_any_world_size(results, tmp_path):
    """A world-2 run (compression on, so the error feedback and the
    generator's state ride along) saves whole leaves from rank 0 at steps
    2 and 4, in the unsharded format (its names are one process's);
    resumed from step 2 at world 2 and at world 1 (here), each ends where
    the uninterrupted run does, its last two steps' histories too."""
    _, port, d, root = results
    out = port[2]
    arch = Arch("olmo_1b", reduced=True)
    tcfg = H.feature_config("ckpt")
    one = TT._ckpt_tree(H.feature_start(arch, tcfg, d))
    for step in (2, 4):
        tree, man = ck.restore(str(root / "w2" / "ckpt"), step, one)
        assert man["step"] == step and int(tree.step) == step
    # world 1, from the step-2 checkpoint the ranks wrote
    resumed = tmp_path / "resumed"
    resumed.mkdir()
    shutil.copytree(root / "w2" / "ckpt" / f"step_{2:010d}",
                    resumed / f"step_{2:010d}")
    state, hist = _port_run("ckpt", d, H.FEATURE_STEPS - 2,
                            ckpt_dir=str(resumed))
    lr_sum = float(np.sum(out["f_ckpt_lr"]))
    tail = {k: out[f"f_ckpt_{k}"][2:] for k in
            ("loss", "grad_norm", "filter_keep_frac", "grad_anomaly")}
    tail["params"] = out["f_ckpt_params"]
    one_hist = {f"w1_{k}": np.asarray([h[k] for h in hist])
                for k in ("loss", "grad_norm", "filter_keep_frac",
                          "grad_anomaly")}
    one_hist["w1_params"] = _flat(state)
    _agree(one_hist, tail, "w1", lr_sum)
    _agree(out, tail, "f_resumed", lr_sum)


class _Coords:
    """One rank of a (data, model) mesh, by its coordinates: what
    ``local_block`` and ``local_shape`` read of a live mesh."""

    def __init__(self, sizes, coords):
        self.axis_names = tuple(sizes)
        self.devices = np.zeros(tuple(sizes.values()))
        self.coords = coords

    def get_local_rank(self, axis):
        return self.coords[axis]


@pytest.mark.parametrize("saver", ["port", "reference"])
def test_elastic_checkpoint_reshard(tmp_path, saver):
    """The reference's ``test_elastic_checkpoint_reshard``: a (8, 4) leaf
    saved on one process (by the port or by the reference) restores onto a
    (4, 2) data × model mesh as each of the 8 ranks' (2, 2) block under
    P("data", "model"), and the blocks tile the saved leaf."""
    whole = np.arange(32, dtype=np.float32).reshape(8, 4)
    if saver == "port":
        ck.save(str(tmp_path), 3, {"w": torch.from_numpy(whole)})
    else:
        jck.save(str(tmp_path), 3, {"w": jnp.asarray(whole)})
    tiled = np.zeros_like(whole)
    for i in range(4):
        for j in range(2):
            mesh = _Coords({"data": 4, "model": 2}, {"data": i, "model": j})
            like = {"w": torch.zeros((2, 2), dtype=torch.float32)}
            tree, man = ck.restore(str(tmp_path), 3, like,
                                   specs={"w": P("data", "model")},
                                   mesh=mesh)
            assert man["step"] == 3 and tuple(tree["w"].shape) == (2, 2)
            tiled[2 * i:2 * i + 2, 2 * j:2 * j + 2] = tree["w"].numpy()
    np.testing.assert_array_equal(tiled, whole)
    with pytest.raises(ValueError, match="block"):
        ck.restore(str(tmp_path), 3, {"w": torch.zeros((4, 4))},
                   specs={"w": P("data", "model")},
                   mesh=_Coords({"data": 4, "model": 2},
                                {"data": 0, "model": 0}))
