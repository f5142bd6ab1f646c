"""``repro_torch.dist`` across ranks, held to the reference.

Two oracles, each computed once for the module:
* the reference's explicit-collective (``shard_map``) primitives, in ONE
  subprocess with 4 forced CPU devices (``REFERENCE``): the replicated
  data-parallel insert, the table-sharded insert / score / μ with and
  without a data axis, the masked inserts of both layouts, the merge
  across layouts, the windowed table-sharded score and GPipe;
* the reference's single-device entry points, in this process: the
  ``Guardrail`` flavours and ``StreamRunner`` filters of
  ``torch_dist_helpers.GUARD_CASES`` / ``STREAM_CASES``, whose W the port
  takes, and the train loop (``_reference_training``), started from the
  port's initial parameters (``params_to_reference``) with its filter and
  monitor W carried into the port's, as ``test_torch_train_loop`` does.

The port runs every layout and entry point in ONE spawn of 4 ``gloo``
ranks on the CPU (``torch_dist_helpers.py``, a (2, 2) data × model mesh).
The self-healing lifecycle of each sharded ``Guardrail`` and a masked
stream chunk are held to the reference's single-device ``Guardrail`` and
``StreamRunner`` on the same W, traffic and bit flips (drawn here with
numpy, in tables of both table shards and tenants of both tenant
groups).
Tolerances: counts, n, scores, μ and masks bitwise on the table and
tenant axes; the Welford mean and M2 at rtol 1e-6 against the reference
(batch sums in another order), bitwise against the port's own single
process; with a data axis the Welford batch statistics come from
all-reduced partial sums, rtol 1e-6.  The sharded train step takes
``test_torch_train_loop``'s tolerances against the reference.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.data.pipeline import AceDataFilter as JFlat
from repro.fleet.filter import FleetDataFilter as JFleet
from repro.models.registry import Arch as JArch
from repro.serve import engine as jengine
from repro.stream.runner import StreamRunner as JRunner
from repro.train import train_loop as JT
from repro.train.fault import GradMonitor as JMonitor
from repro.train.optim import make_optimizer as jmake_opt
from repro.window.filter import WindowedAceFilter as JWindow
from repro_torch.models.convert import params_to_reference
from repro_torch.models.registry import Arch, leaves, tree_map
from repro_torch.train import train_loop as TT

import torch_dist_helpers as H

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-6
FIELDS = ("counts", "n", "welford_mean", "welford_m2")

REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import sketch as sk
from repro.core.sketch import AceConfig
from repro.dist import sketch_parallel as sp
from repro.dist.pipeline import pipeline_apply

out = {}
cfg = AceConfig(**%(sketch)r)
mesh = jax.make_mesh((2, 2), ("data", "model"))
w = sk.make_params(cfg)
rng = np.random.default_rng(0)
xs = [rng.normal(size=(48, 16)).astype(np.float32) for _ in range(3)]
masks = [rng.random(48) < p for p in (1.0, .6, .3)]
q = rng.normal(size=(32, 16)).astype(np.float32)
out.update(w=np.asarray(w), q=q, **{f"x{i}": x for i, x in enumerate(xs)},
           **{f"m{i}": m for i, m in enumerate(masks)})

def save(prefix, st):
    for k in ("counts", "n", "welford_mean", "welford_m2"):
        out[f"{prefix}_{k}"] = np.asarray(getattr(st, k))

rep = jax.tree.map(lambda _: NamedSharding(mesh, P()), sk.init(cfg))
sh = sp.table_sharded_shardings(mesh)
data = NamedSharding(mesh, P("data"))
with jax.set_mesh(mesh):
    upd = jax.jit(sp.make_shardmap_update(mesh, cfg, data_axes=("data",)))
    st = jax.device_put(sk.init(cfg), rep)
    for x in xs:
        st = upd(st, jax.device_put(jnp.asarray(x), data), w)
    save("shardmap", st)
    upd = jax.jit(sp.make_table_sharded_update(mesh, cfg))
    st = jax.device_put(sk.init(cfg), sh)
    for x in xs:
        st = upd(st, jnp.asarray(x), w)
    save("ts", st)
    out["ts_scores"] = np.asarray(jax.jit(sp.make_table_sharded_score(
        mesh, cfg))(st, jnp.asarray(q), w))
    out["ts_mu"] = np.asarray(jax.jit(sp.make_table_sharded_mean_mu(
        mesh, cfg))(st))
    upd = jax.jit(sp.make_table_sharded_update(mesh, cfg,
                                               data_axes=("data",)))
    st = jax.device_put(sk.init(cfg), sh)
    for x in xs:
        st = upd(st, jax.device_put(jnp.asarray(x), data), w)
    save("tsdata", st)
    rupd = jax.jit(sp.make_masked_update(mesh, cfg))
    tupd = jax.jit(sp.make_table_sharded_masked_update(mesh, cfg))
    r = jax.device_put(sk.init(cfg), rep)
    t = jax.device_put(sk.init(cfg), sh)
    for x, m in zip(xs, masks):
        r = rupd(r, jnp.asarray(x), w, jnp.asarray(m))
        t = tupd(t, jnp.asarray(x), w, jnp.asarray(m))
    save("mrep", r)
    save("mts", t)
    upd = jax.jit(sp.make_table_sharded_update(mesh, cfg))
    merged = jax.jit(sk.merge)(
        upd(jax.device_put(sk.init(cfg), sh), jnp.asarray(xs[0]), w),
        upd(jax.device_put(sk.init(cfg), sh), jnp.asarray(xs[1]), w))
    save("merge", merged)
    out["merge_mu"] = np.asarray(sk.mean_mu(merged))
    ring = rng.integers(0, 50, size=(3, 8, 256)).astype(np.int32)
    weights = (0.9 ** np.array([1, 0, 2], np.float32)).astype(np.float32)
    out["ring"], out["ring_w"] = ring, weights
    out["win_scores"] = np.asarray(jax.jit(
        sp.make_table_sharded_window_score(mesh, cfg))(
        jax.device_put(jnp.asarray(ring),
                       NamedSharding(mesh, P(None, "model", None))),
        jnp.asarray(weights), jnp.asarray(q), w))
S, M, mb, D = 4, 8, 2, 16
pw = (rng.normal(size=(S, D, D)) * 0.3).astype(np.float32)
px = rng.normal(size=(M, mb, D)).astype(np.float32)
out["pipe_w"], out["pipe_x"] = pw, px
out["pipe_out"] = np.asarray(jax.jit(lambda a, b: pipeline_apply(
    lambda p, h: jnp.tanh(h @ p["w"]), {"w": a}, b,
    mesh=jax.make_mesh((S,), ("pipe",)), num_stages=S,
    num_microbatches=M))(jnp.asarray(pw), jnp.asarray(px)))
np.savez(sys.argv[1], **out)
"""


def _run(args, env_extra, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               **env_extra)
    out = subprocess.run([sys.executable] + args, capture_output=True,
                         text=True, timeout=timeout, env=env)
    assert out.returncode == 0, f"stderr:\n{out.stderr[-4000:]}"


def _reference_guardrails() -> dict:
    """Each Guardrail case on the reference, single device: its W, masks
    and final state (tenant groups admitted one after the other)."""
    out = {}
    for c, (name, fields, layout) in enumerate(H.GUARD_CASES):
        g = jengine.Guardrail(jengine.GuardrailConfig(**{**H.GUARD_BASE,
                                                         **fields}))
        out[f"g_{name}_w"] = np.asarray(g.w)
        masks = []
        for row in H.guard_batches(c, H.tenant_groups(layout)):
            for e, t in row:
                masks.append(np.asarray(
                    g.admit(jnp.asarray(e)) if t is None
                    else g.admit(jnp.asarray(e), jnp.asarray(t))))
        out[f"g_{name}_masks"] = np.stack(masks)
        for k in FIELDS:
            out[f"g_{name}_{k}"] = np.asarray(getattr(g.state, k))
    return out


def _draw_flips(case: int) -> np.ndarray:
    """(k, 4) flips (lead, table, bucket, bit) of a GUARD_CASES case: one
    in a table of each table shard (4 tables each), and for a fleet in a
    tenant of each tenant group ({0, 1}, {2, 3}) against each shard; the
    lead of a ring a random epoch; bits 16-30, which a count of this
    traffic never has, so every flip raises its table's sum."""
    _, fields, _ = H.GUARD_CASES[case]
    rng = np.random.default_rng(400 + case)
    L, nb = H.GUARD_BASE["num_tables"], 1 << H.GUARD_BASE["num_bits"]
    epochs = fields.get("window_epochs", 1)
    fleet = fields.get("num_tenants", 1) > 1
    flips = []
    for group in (0, 1) if fleet else (0,):
        for shard in (0, 1):
            lead = (2 * group + rng.integers(0, 2) if fleet
                    else rng.integers(0, epochs))
            flips.append((lead, shard * L // 2 + rng.integers(0, L // 2),
                          rng.integers(0, nb), rng.integers(16, 31)))
    return np.asarray(flips, np.int64)


def _flip(counts, flips: np.ndarray, kind: str) -> np.ndarray:
    c = np.array(counts)
    bits = c.view(np.uint32)
    for lead, j, b, bit in flips.tolist():
        bits[H.flip_index(lead, j, b, kind)] ^= np.uint32(1 << bit)
    return c


def _reference_lifecycles(ref: dict) -> dict:
    """Each GUARD_CASES case's lifecycle on the reference, single device
    (a ``LIFE_CASES`` replica case shares its case's): the flips drawn
    here, then what ``torch_dist_helpers.lifecycle`` records, the tenant
    groups admitted one after the other."""
    out = {}
    for case, (name, gc, replica) in enumerate(H.LIFE_CASES):
        gname, fields, layout = H.GUARD_CASES[gc]
        if replica:
            continue
        flips = _draw_flips(gc)
        out[f"life_{gname}_flips"] = flips
        g = jengine.Guardrail(jengine.GuardrailConfig(**{**H.GUARD_BASE,
                                                         **fields}))
        assert np.array_equal(np.asarray(g.w), ref[f"g_{gname}_w"])
        kind = ("fleet" if g.multi_tenant else "window" if g.windowed
                else "flat")
        batches = iter(H.life_batches(case, H.tenant_groups(layout)))
        masks, reports, flags = [], [], []

        def serve():
            masks.append([np.asarray(g.admit(jnp.asarray(e)) if t is None
                                     else g.admit(jnp.asarray(e),
                                                  jnp.asarray(t)))
                          for e, t in next(batches)])

        def audit(method):
            rep = getattr(g, method)()
            reports.append(np.concatenate([np.asarray(x, bool).reshape(-1)
                                           for x in rep]))
            flags.append((g.degraded, g._rewarm_admits))

        for _ in range(H.LIFE_WARM):
            serve()
        g.state = g.state._replace(counts=jnp.asarray(
            _flip(g.state.counts, flips, kind)))
        audit("health_check")
        serve()
        audit("repair")
        for k in FIELDS:
            out[f"life_{gname}_repaired_{k}"] = np.asarray(getattr(g.state,
                                                                   k))
        landed = -1
        for i in range(H.LIFE_REWARM):
            serve()
            audit("health_check")
            if not g.degraded:
                landed = i
                break
        serve()
        out[f"life_{gname}_masks"] = np.asarray(masks)   # (admits, groups, B)
        out[f"life_{gname}_reports"] = np.stack(reports)
        out[f"life_{gname}_flags"] = np.asarray(flags)
        out[f"life_{gname}_landed"] = np.asarray(landed)
        for k in FIELDS:
            out[f"life_{gname}_final_{k}"] = np.asarray(getattr(g.state, k))
    return out


def _stream_mask(case: int) -> np.ndarray:
    """A stream case's health mask: (L,) with one table of each table
    shard masked; a fleet's (T, L) with one such table a tenant."""
    _, kind, fields, _ = H.STREAM_CASES[case]
    rng = np.random.default_rng(500 + case)
    L = H.FILTER_BASE["num_tables"]
    rows = fields.get("num_tenants", 1) if kind == "fleet" else 1
    mask = np.ones((rows, L), np.float32)
    for r in range(rows):
        mask[r, rng.integers(0, L // 2)] = 0.0
        mask[r, L // 2 + rng.integers(0, L // 2)] = 0.0
    return mask if kind == "fleet" else mask[0]


def _reference_streams() -> dict:
    """Each StreamRunner case on the reference: W, keep masks, state,
    summaries (a fleet's tenant groups' chunks in turns), then one chunk
    a group under the case's health mask."""
    kinds = {"flat": JFlat, "window": JWindow, "fleet": JFleet}
    out = {}
    for c, (name, kind, fields, layout) in enumerate(H.STREAM_CASES):
        runner = JRunner(kinds[kind](**{**H.FILTER_BASE, **fields}),
                         chunk_T=H.STREAM_T, return_masks=True)
        state, w = runner.init()
        out[f"s_{name}_w"] = np.asarray(w)
        groups = H.stream_batches(c, H.tenant_groups(layout))
        keeps, summaries = [], []
        for k in range(H.STREAM_CHUNKS):
            for feats, tids in groups:
                sl = slice(k * H.STREAM_T, (k + 1) * H.STREAM_T)
                chunk = jnp.asarray(np.stack(feats[sl]))
                tc = None if tids is None else jnp.asarray(
                    np.stack(tids[sl]))
                state, summary, keep = runner.consume(state, w, chunk, tc)
                keeps.append(np.asarray(keep))
                summaries.append(summary)
        out[f"s_{name}_keeps"] = np.stack(keeps)
        for k in FIELDS:
            out[f"s_{name}_{k}"] = np.asarray(getattr(state, k))
        for f in ("n", "falpha", "kept_frac", "topk_margin"):
            out[f"s_{name}_sum_{f}"] = np.stack([np.asarray(getattr(s, f))
                                             for s in summaries])
        mask = _stream_mask(c)
        out[f"s_{name}_mask"] = mask
        masked = {"keeps": [], "sum_n": [], "sum_falpha": [],
                  "sum_degraded": []}
        for feats, tids in H.stream_batches(c, H.tenant_groups(layout), 1,
                                            seed=250):
            state, summary, keep = runner.consume(
                state, w, jnp.asarray(np.stack(feats)),
                None if tids is None else jnp.asarray(np.stack(tids)),
                table_mask=jnp.asarray(mask))
            masked["keeps"].append(np.asarray(keep))
            for f in ("n", "falpha", "degraded"):
                masked[f"sum_{f}"].append(np.asarray(getattr(summary, f)))
        for f, v in masked.items():
            out[f"sm_{name}_{f}"] = np.stack(v)          # (groups, ...)
        for k in FIELDS:
            out[f"sm_{name}_{k}"] = np.asarray(getattr(state, k))
    return out


def _train_start():
    """The port's reduced olmo_1b and its initial parameters (the ranks
    draw the same ones)."""
    arch = Arch("olmo_1b", reduced=True)
    return arch, TT.init_train_state(
        arch, TT.TrainConfig(**H.TRAIN_CFG, device="cpu")).params


def _reference_training() -> dict:
    """The reference's single-device ``train``, TRAIN_STEPS steps on the
    ranks' ``DataStream``, from the port's initial parameters; its filter
    and monitor W go to the ranks."""
    jcfg = JT.TrainConfig(**H.TRAIN_CFG)
    ja = JArch("olmo_1b", reduced=True)
    arch, params = _train_start()
    jp = jax.tree.map(jnp.asarray, params_to_reference(params))
    mon, mon_w = JMonitor(feature_dim=jcfg.monitor_feature_dim).init()
    fs, fw = JT.make_data_filter(jcfg, arch.cfg.d_model).init()
    js = JT.TrainState(params=jp, opt_state=jmake_opt(jcfg.optimizer)
                       .init(jp), step=jnp.zeros((), jnp.int32),
                       monitor=mon, monitor_w=mon_w, filter_state=fs,
                       filter_w=fw, ef=None,
                       rng=jax.random.PRNGKey(jcfg.seed))
    stream = jpipe.DataStream(jpipe.StreamConfig(
        vocab_size=arch.cfg.vocab_size, seq_len=H.TRAIN_S,
        global_batch=H.TRAIN_B))
    js, hist = JT.train(ja, jcfg, stream, num_steps=H.TRAIN_STEPS,
                        log_every=0, state=js)
    out = {"tr_filter_w": np.asarray(fw), "tr_monitor_w": np.asarray(mon_w),
           "tr_params": np.concatenate([np.asarray(p).reshape(-1) for p
                                        in jax.tree.leaves(js.params)])}
    for k in ("loss", "grad_norm", "lr", "filter_keep_frac",
              "grad_anomaly"):
        out[f"tr_{k}"] = np.asarray([h[k] for h in hist])
    for name, st in (("filter", js.filter_state), ("monitor", js.monitor.ace)):
        for k in FIELDS:
            out[f"tr_{name}_{k}"] = np.asarray(getattr(st, k))
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(reference shard_map oracles + entry points, port's ranks)."""
    tmp = tmp_path_factory.mktemp("dist")
    oracle = tmp / "oracle.npz"
    script = tmp / "reference.py"
    script.write_text(textwrap.dedent(REFERENCE % {"sketch": H.SKETCH}))
    _run([str(script), str(oracle)],
         {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
          "JAX_PLATFORMS": "cpu"})
    ref = dict(np.load(oracle))
    ref.update(_reference_guardrails())
    ref.update(_reference_lifecycles(ref))
    ref.update(_reference_streams())
    ref.update(_reference_training())
    inputs, port = tmp / "inputs.npz", tmp / "port.npz"
    np.savez(inputs, **ref)
    _run([os.path.join(REPO, "tests", "torch_dist_helpers.py"),
          str(inputs), str(port)], {"OMP_NUM_THREADS": "1"})
    return ref, dict(np.load(port))


def _same_state(ref, port, a, b, welford_rtol=RTOL):
    for k in ("counts", "n"):
        np.testing.assert_array_equal(port[f"{b}_{k}"], ref[f"{a}_{k}"],
                                      err_msg=f"{b} {k}")
    for k in ("welford_mean", "welford_m2"):
        np.testing.assert_allclose(port[f"{b}_{k}"], ref[f"{a}_{k}"],
                                   rtol=welford_rtol, err_msg=f"{b} {k}")


@pytest.mark.parametrize("name", ["shardmap", "ts", "tsdata", "mrep", "mts",
                                  "merge"])
def test_primitive_matches_reference_shard_map(results, name):
    """Replicated over a data axis, table-sharded with and without one,
    both masked inserts, and the merge of table-sharded blocks: counts and
    n bitwise the reference's shard_map mode, Welford within rtol 1e-6."""
    ref, port = results
    _same_state(ref, port, name, name)


def test_table_sharded_score_and_mu_bitwise(results):
    """Scores from partial sums + one (B,) all-reduce, and μ from the
    ranks' exact Σ‖A_j‖², bitwise; the score moves 4·B bytes."""
    ref, port = results
    np.testing.assert_array_equal(port["ts_scores"], ref["ts_scores"])
    np.testing.assert_array_equal(port["ts_mu"], ref["ts_mu"])
    np.testing.assert_array_equal(port["merge_mu"], ref["merge_mu"])
    assert int(port["score_tally_bytes"]) == 4 * ref["q"].shape[0]


def test_window_score_all_reduce_before_weights(results):
    """The windowed score's per-epoch partial sums are all-reduced before
    the γ weights, so at γ = 0.9 it is bitwise the single card's
    ``ring.score_from_sums`` of the whole ring; against the reference's
    rtol 1e-6 (XLA contracts its jitted multiply-add into an FMA, 1 ulp
    off the separate multiply and add)."""
    ref, port = results
    np.testing.assert_array_equal(port["win_scores"], port["win_one"])
    np.testing.assert_allclose(port["win_scores"], ref["win_scores"],
                               rtol=RTOL)


def test_gpipe_matches_reference_and_sequential(results):
    """GPipe over 4 stages against the reference's pipeline and the
    sequential stages (the reference test's tolerance)."""
    ref, port = results
    np.testing.assert_allclose(port["pipe_out"], ref["pipe_out"],
                               rtol=2e-5, atol=2e-5)
    h = ref["pipe_x"]
    for s in range(ref["pipe_w"].shape[0]):
        h = np.tanh(h @ ref["pipe_w"][s])
    np.testing.assert_allclose(port["pipe_out"], h, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", [c[0] for c in H.GUARD_CASES])
def test_guardrail_layouts_match_single_device(results, case):
    """``Guardrail(mesh=…)``: every rank's masks equal the single-device
    reference's for its batches, the gathered state bitwise the
    reference's counts and n (Welford rtol 1e-6) and bitwise the port's
    own single process."""
    ref, port = results
    layout = dict((c[0], c[2]) for c in H.GUARD_CASES)[case]
    masks = port[f"g_{case}_masks"]                  # (ranks, admits, B)
    want = ref[f"g_{case}_masks"]
    if H.tenant_groups(layout) > 1:
        # rank r serves tenant group r // 2 (its data index)
        for r in range(H.WORLD):
            np.testing.assert_array_equal(masks[r], want[r // 2::2])
    else:
        for r in range(H.WORLD):
            np.testing.assert_array_equal(masks[r], want)
    _same_state(ref, port, f"g_{case}", f"g_{case}")
    _same_state(port, port, f"g_{case}_one", f"g_{case}", welford_rtol=0)
    np.testing.assert_array_equal(port[f"g_{case}_one_masks"], want)


@pytest.mark.parametrize("case", [c[0] for c in H.STREAM_CASES])
def test_stream_runner_layouts_match_single_device(results, case):
    """``StreamRunner(mesh=…)``: keep masks and the gathered state against
    the single-device reference runner; the summaries' n bitwise, falpha
    and margins within rtol 1e-6 (flat and window, whose ranks see the
    whole stream)."""
    ref, port = results
    layout = dict((c[0], c[3]) for c in H.STREAM_CASES)[case]
    keeps, want = port[f"s_{case}_keeps"], ref[f"s_{case}_keeps"]
    groups = H.tenant_groups(layout)
    for r in range(H.WORLD):
        np.testing.assert_array_equal(
            keeps[r], want[r // 2::2] if groups > 1 else want)
    _same_state(ref, port, f"s_{case}", f"s_{case}")
    if groups == 1:
        np.testing.assert_array_equal(port[f"s_{case}_sum_n"],
                                      ref[f"s_{case}_sum_n"])
        for f in ("falpha", "kept_frac", "topk_margin"):
            np.testing.assert_allclose(port[f"s_{case}_sum_{f}"],
                                       ref[f"s_{case}_sum_{f}"], rtol=RTOL,
                                       atol=1e-7)


@pytest.mark.parametrize("case", [c[0] for c in H.LIFE_CASES])
def test_guardrail_lifecycle_matches_single_device(results, case):
    """``health_check``, degraded admits, ``repair`` and the re-warm of a
    sharded ``Guardrail`` against the reference's single-device one on the
    same W, traffic and flips, on every rank: verdicts at every admit,
    the whole report of every audit, ``degraded`` and
    ``_rewarm_admits`` after it, the admit at which recovery lands, the
    gathered repaired and final counts and n bitwise (Welford rtol 1e-6);
    the masked μ of ``ShardedSketch.mean_mu`` bitwise the single card's
    on the gathered state; one ``_to_host`` an admit, degraded or not,
    and one a ``health_check``.  The replica case flips on data rank 0
    only: every rank still masks and repairs the same tables, so every
    replica's repaired counts are equal."""
    ref, port = results
    _, gc, replica = dict((c[0], c) for c in H.LIFE_CASES)[case]
    gname, _, layout = H.GUARD_CASES[gc]
    groups = H.tenant_groups(layout)
    got = {k[len(f"life_{case}_"):]: v for k, v in port.items()
           if k.startswith(f"life_{case}_")}
    want = {k[len(f"life_{gname}_"):]: v for k, v in ref.items()
            if k.startswith(f"life_{gname}_")}
    assert want["landed"] >= 0, "the reference recovers within the cap"
    assert want["flags"][0][0], "the flips degrade the reference"
    for r in range(H.WORLD):
        g = r // 2 if groups > 1 else 0
        np.testing.assert_array_equal(got["masks"][r], want["masks"][:, g],
                                      err_msg=f"rank {r} verdicts")
        np.testing.assert_array_equal(got["reports"][r], want["reports"],
                                      err_msg=f"rank {r} reports")
        np.testing.assert_array_equal(got["flags"][r], want["flags"],
                                      err_msg=f"rank {r} degraded/re-warm")
        assert got["landed"][r] == want["landed"], f"rank {r} recovery"
        np.testing.assert_array_equal(got["mu"][r][0], got["mu"][r][1],
                                      err_msg=f"rank {r} masked mu")
        assert (got["d2h_admit"][r] == 1).all(), "one D2H an admit"
        assert (got["d2h_check"][r] == 1).all(), "one D2H a health_check"
        for stage in ("repaired", "final"):
            for k in FIELDS:
                tol = dict(rtol=RTOL) if k.startswith("welford") else {}
                cmp = (np.testing.assert_allclose if tol
                       else np.testing.assert_array_equal)
                cmp(got[f"{stage}_{k}"][r], want[f"{stage}_{k}"], **tol,
                    err_msg=f"rank {r} {stage} {k}")
    if replica:
        for r in range(1, H.WORLD):
            np.testing.assert_array_equal(got["repaired_counts"][r],
                                          got["repaired_counts"][0])


@pytest.mark.parametrize("case", [c[0] for c in H.STREAM_CASES])
def test_masked_chunk_matches_single_device(results, case):
    """``StreamRunner(mesh=…).consume(table_mask=…)``: one chunk under a
    health mask (a table of each shard masked, a fleet's per tenant)
    against the reference's single-device runner: keeps, the summary's n
    and ``degraded`` bitwise, ``falpha`` within rtol 1e-6, and the
    gathered state's counts and n bitwise (Welford rtol 1e-6)."""
    ref, port = results
    _, _, fields, layout = dict((c[0], c) for c in H.STREAM_CASES)[case]
    groups = H.tenant_groups(layout)
    per = fields.get("num_tenants", 1) // groups
    for r in range(H.WORLD):
        g = r // 2 if groups > 1 else 0
        np.testing.assert_array_equal(port[f"sm_{case}_keeps"][r],
                                      ref[f"sm_{case}_keeps"][g])
        assert bool(port[f"sm_{case}_sum_degraded"][r])
        assert bool(ref[f"sm_{case}_sum_degraded"][g])
        n, fa = ref[f"sm_{case}_sum_n"][g], ref[f"sm_{case}_sum_falpha"][g]
        if groups > 1:                           # the rank's tenants' rows
            n, fa = n[g * per:(g + 1) * per], fa[g * per:(g + 1) * per]
        np.testing.assert_array_equal(port[f"sm_{case}_sum_n"][r], n)
        np.testing.assert_allclose(port[f"sm_{case}_sum_falpha"][r], fa,
                                   rtol=RTOL)
    _same_state(ref, port, f"sm_{case}", f"sm_{case}")


def test_sharded_train_step_matches_one_process(results):
    """Reduced olmo_1b, two AdamW ZeRO-2 steps on the (2, 2) mesh (FSDP
    over data, the logical rules on model, table-sharded sketches) against
    the reference's single-device ``train`` from the same parameters, W
    and batches, at ``test_torch_train_loop``'s tolerances: keep fractions
    and the monitor's verdicts exact, losses and gradient norms rtol 1e-5,
    learning rates within 2 ulp, 99.99% of the parameters within 1e-6 and
    every one within the summed lr, the sketches' counts and n bitwise and
    their Welford moments rtol 1e-5.  Besides, against the port's single
    process from the same state: the histories as tight, the sketches
    bitwise in every field."""
    ref, port = results
    for k in ("filter_keep_frac", "grad_anomaly"):
        np.testing.assert_array_equal(port[f"t_{k}"], ref[f"tr_{k}"])
        np.testing.assert_array_equal(port[f"t_{k}"], port[f"t_one_{k}"])
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(port[f"t_{k}"], ref[f"tr_{k}"],
                                   rtol=1e-5)
        np.testing.assert_allclose(port[f"t_{k}"], port[f"t_one_{k}"],
                                   rtol=1e-5)
    np.testing.assert_allclose(port["t_lr_sum"], np.sum(ref["tr_lr"]),
                               rtol=3e-7)
    # the gathered parameters, in the reference's layout and leaf order
    _, params = _train_start()
    flat = iter(np.split(port["t_params"], np.cumsum(
        [p.numel() for p in leaves(params)])[:-1]))
    got = tree_map(lambda p: torch.from_numpy(next(flat).reshape(p.shape)),
                   params)
    got = np.concatenate([np.asarray(g).reshape(-1) for g in
                          jax.tree.leaves(params_to_reference(got))])
    diff = np.abs(got - ref["tr_params"])
    assert diff.max() <= float(port["t_lr_sum"])
    assert np.mean(diff <= 1e-6) >= 0.9999
    one = np.abs(port["t_param_diff"])
    assert one.max() <= float(port["t_lr_sum"])
    assert np.mean(one <= 1e-6) >= 0.999
    assert int(port["t_fsdp_split"]) > 0      # FSDP split some leaves
    for name in ("filter", "monitor"):
        for k in ("counts", "n"):
            np.testing.assert_array_equal(port[f"t_{name}_{k}"],
                                          ref[f"tr_{name}_{k}"],
                                          err_msg=f"{name} {k}")
        for k in ("welford_mean", "welford_m2"):
            np.testing.assert_allclose(port[f"t_{name}_{k}"],
                                       ref[f"tr_{name}_{k}"], rtol=1e-5,
                                       err_msg=f"{name} {k}")
        for k in FIELDS:
            np.testing.assert_array_equal(port[f"t_{name}_{k}"],
                                          port[f"t_{name}_one_{k}"],
                                          err_msg=f"{name} {k}")
