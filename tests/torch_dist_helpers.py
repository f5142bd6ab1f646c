"""The rank side of ``tests/test_torch_dist_sharded.py``: the port's
``repro_torch.dist`` run as WORLD = 4 ``gloo`` processes on the CPU, one
(2, 2) data × model mesh, on inputs the test wrote (the reference's W and
batches).  Run as

    PYTHONPATH=src python tests/torch_dist_helpers.py IN.npz OUT.npz

It spawns the ranks (``file://`` init beside OUT.npz, so parallel test
workers never share a port), and rank 0 writes every result, each global
state gathered from the ranks' blocks, to OUT.npz.  It imports no JAX.
The case tables (``GUARD_CASES``, ``STREAM_CASES``) are shared with the
test, which runs the reference on the same ones.

    PYTHONPATH=src python tests/torch_dist_helpers.py --features IN.npz OUT.npz

The ``health`` part runs every ``LIFE_CASES`` lifecycle (serve, flip
bits, ``health_check``, serve degraded, ``repair``, re-warm) on the
sharded ``Guardrail`` with the test's flips (IN's ``life_<case>_flips``),
and ``streams`` ends each case with one chunk under the test's health
mask (IN's ``s_<case>_mask``).

is the rank side of ``tests/test_torch_dist_train_features.py``: one
spawn of 2 ranks, then one of 4 (``features``): the sharded train step's
collectives on ``meta`` against its live tally, and the training features
a sharded run takes (Adafactor on a (2, 1) and a (2, 2) mesh, int8
compression on the reference's rounding noise, the chunked prefilter,
checkpoints saved at world 2 and resumed), each written to ``w2/out.npz``
and ``w4/out.npz`` beside OUT.npz, with the checkpoint directory.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
SKETCH = dict(dim=16, num_bits=8, num_tables=8, seed=0, welford_min_n=16.0)

# Guardrail flavours: (name, GuardrailConfig fields, layout)
GUARD_BASE = dict(d_model=16, num_bits=8, num_tables=8, warmup_items=64.0)
GUARD_CASES = (
    ("flat_table", {}, "table_sharded"),
    ("flat_table_quantile", dict(threshold_mode="quantile"),
     "table_sharded"),
    ("flat_replicated", {}, "replicated"),
    ("window_table", dict(window_epochs=3, window_decay=0.9,
                          rotate_every=2), "table_sharded"),
    ("window_table_quantile", dict(window_epochs=3, window_decay=0.9,
                                   rotate_every=2, threshold_mode="quantile"),
     "table_sharded"),
    ("fleet_table", dict(num_tenants=4, warmup_items=32.0),
     "table_sharded"),
    ("fleet_tenant", dict(num_tenants=4, warmup_items=32.0),
     "tenant_sharded"),
    ("fleet_tenant_table", dict(num_tenants=4, warmup_items=32.0,
                                threshold_mode="quantile"),
     "tenant_table_sharded"),
)
GUARD_ADMITS, GUARD_B, GUARD_S = 6, 32, 4

# Guardrail lifecycles: (name, GUARD_CASES index, flips on data rank 0
# only).  Each flip is (lead, table, bucket, bit): lead is the epoch of a
# ring, the tenant of a fleet, unused for a flat sketch.
LIFE_CASES = tuple((name, c, False) for c, (name, _, _)
                   in enumerate(GUARD_CASES)) + (("flat_table_replica", 0,
                                                  True),)
LIFE_WARM, LIFE_REWARM = 4, 16       # admits before the flips; re-warm cap
LIFE_ADMITS = LIFE_WARM + 1 + LIFE_REWARM + 1

# StreamRunner filters: (name, kind, filter fields, layout)
FILTER_BASE = dict(d_model=16, num_bits=8, num_tables=8, warmup_items=64.0)
STREAM_CASES = (
    ("flat", "flat", {}, "table_sharded"),
    ("window", "window", dict(num_epochs=3, decay=0.9, rotate_every=2),
     "table_sharded"),
    ("fleet", "fleet", dict(num_tenants=4, warmup_items=32.0),
     "tenant_table_sharded"),
)
STREAM_T, STREAM_B, STREAM_CHUNKS = 4, 32, 2
TRAIN_STEPS, TRAIN_B, TRAIN_S = 2, 8, 16
TRAIN_CFG = dict(optimizer="adamw", peak_lr=1e-3, warmup_steps=1,
                 total_steps=8)
TENANT_LAYOUTS = ("tenant_sharded", "tenant_table_sharded")


def tenant_groups(layout: str) -> int:
    """Streams of a fleet case: one a tenant group (the data axis) under
    the tenant layouts, one shared by every rank otherwise."""
    return 2 if layout in TENANT_LAYOUTS else 1


def guard_batches(case: int, groups: int, admits: int = GUARD_ADMITS,
                  seed: int = 100):
    """[admit][group] -> (embeds (B, S, 16), tenant ids (B,) or None):
    group g's ids lie in its tenant block {2g, 2g + 1}; every third admit
    is shifted so the threshold rejects."""
    _, fields, layout = GUARD_CASES[case]
    rng = np.random.default_rng(seed + case)
    T = fields.get("num_tenants", 1)
    out = []
    for k in range(admits):
        row = []
        for g in range(groups):
            e = rng.normal(size=(GUARD_B, GUARD_S, 16)).astype(np.float32)
            if k % 3 == 2:
                e[: GUARD_B // 4] += 3.0
            tids = None
            if T > 1:
                tids = (rng.integers(0, 2, GUARD_B) + 2 * g if groups > 1
                        else rng.integers(0, T, GUARD_B)).astype(np.int32)
            row.append((e, tids))
        out.append(row)
    return out


def life_batches(case: int, groups: int):
    """A lifecycle's traffic: ``guard_batches`` of its GUARD_CASES case,
    LIFE_ADMITS admits."""
    return guard_batches(LIFE_CASES[case][1], groups, LIFE_ADMITS, seed=300)


def flip_index(lead: int, table: int, bucket: int, kind: str) -> tuple:
    """The counts index of one flip in a (L, 2^K), (E, L, 2^K) or
    (T, L, 2^K) plane."""
    return (table, bucket) if kind == "flat" else (lead, table, bucket)


def stream_batches(case: int, groups: int, chunks: int = STREAM_CHUNKS,
                   seed: int = 200):
    """[group] -> (list of (B, 17) feature batches, list of ids or None)."""
    _, kind, _, _ = STREAM_CASES[case]
    rng = np.random.default_rng(seed + case)
    out = []
    for g in range(groups):
        feats, tids = [], []
        for k in range(STREAM_T * chunks):
            f = rng.normal(size=(STREAM_B, 17)).astype(np.float32)
            if k % 3 == 2:
                f[: STREAM_B // 4] += 2.0
            feats.append(f)
            if kind == "fleet":
                tids.append((rng.integers(0, 2, STREAM_B)
                             + 2 * g).astype(np.int32))
        out.append((feats, tids or None))
    return out


def _np(t):
    return t.detach().cpu().numpy()


FIELDS = ("counts", "n", "welford_mean", "welford_m2")


def _state(prefix: str, st, out: dict) -> None:
    for f in FIELDS:
        out[f"{prefix}_{f}"] = _np(getattr(st, f))


def primitives(mesh, d: dict, out: dict) -> None:
    """The explicit-collective primitives on the oracle's inputs."""
    from repro_torch.core import sketch as sk
    from repro_torch.dist import sketch_parallel as sp
    from repro_torch.dist.mesh import P, local_block
    cfg = sk.AceConfig(**SKETCH)
    w = torch.as_tensor(d["w"])
    xs = [torch.as_tensor(d[f"x{i}"]) for i in range(3)]
    masks = [torch.as_tensor(d[f"m{i}"]) for i in range(3)]
    q = torch.as_tensor(d["q"])
    dr = mesh.get_local_rank("data")
    ts = sp.table_sharded_shardings(mesh)

    def fresh(spec=ts):
        return sp.place(sk.init(cfg, "cpu"), spec, mesh)

    upd = sp.make_shardmap_update(mesh, cfg, data_axes=("data",))
    st = sk.init(cfg, "cpu")
    for x in xs:
        st = upd(st, x.chunk(2)[dr], w)
    _state("shardmap", st, out)

    upd = sp.make_table_sharded_update(mesh, cfg)
    st = fresh()
    for x in xs:
        st = upd(st, x, w)
    _state("ts", sp.gather(st, ts, mesh), out)
    from repro_torch.dist import collectives as col
    with col.tallied() as tally:
        out["ts_scores"] = _np(sp.make_table_sharded_score(mesh, cfg)(
            st, q, w))
    out["score_tally_bytes"] = np.asarray(tally.snapshot()["total_bytes"])
    out["ts_mu"] = _np(sp.make_table_sharded_mean_mu(mesh, cfg)(st))

    upd = sp.make_table_sharded_update(mesh, cfg, data_axes=("data",))
    st = fresh()
    for x in xs:
        st = upd(st, x.chunk(2)[dr], w)
    _state("tsdata", sp.gather(st, ts, mesh), out)

    rupd = sp.make_masked_update(mesh, cfg)
    tupd = sp.make_table_sharded_masked_update(mesh, cfg)
    r, t = sk.init(cfg, "cpu"), fresh()
    for x, m in zip(xs, masks):
        r = rupd(r, x, w, m)
        t = tupd(t, x, w, m)
    _state("mrep", r, out)
    _state("mts", sp.gather(t, ts, mesh), out)

    upd = sp.make_table_sharded_update(mesh, cfg)
    merged = sk.merge(upd(fresh(), xs[0], w), upd(fresh(), xs[1], w))
    _state("merge", sp.gather(merged, ts, mesh), out)
    out["merge_mu"] = _np(sp.table_sharded_mean_mu(mesh, cfg, merged))

    ring = local_block(torch.as_tensor(d["ring"]), P(None, "model", None),
                       mesh)
    out["win_scores"] = _np(sp.make_table_sharded_window_score(mesh, cfg)(
        ring, torch.as_tensor(d["ring_w"]), q, w))
    # the single card's windowed score of the whole ring (cursor 1, γ 0.9)
    from repro_torch.kernels import ops as kops
    from repro_torch.window import ring as wr
    whole = torch.as_tensor(d["ring"])
    ids = kops.hash_dispatch(q, w, cfg.srp).long()
    sums = torch.stack([torch.sum(whole[e][torch.arange(8), ids].to(
        torch.float32), dim=-1) for e in range(whole.shape[0])])
    out["win_one"] = _np(wr.score_from_sums(sums, torch.tensor(1), 0.9, 8))


def guardrails(mesh, d: dict, out: dict) -> None:
    """Every Guardrail case, sharded and on one process, on the same W."""
    from repro_torch.serve.engine import Guardrail, GuardrailConfig
    dr = mesh.get_local_rank("data")
    for c, (name, fields, layout) in enumerate(GUARD_CASES):
        gcfg = GuardrailConfig(**{**GUARD_BASE, **fields})
        w = torch.as_tensor(d[f"g_{name}_w"])
        g = Guardrail(gcfg, device="cpu", mesh=mesh, sketch_layout=layout,
                      w=w)
        one = Guardrail(gcfg, device="cpu", w=w)
        groups = tenant_groups(layout)
        masks, ones = [], []
        for row in guard_batches(c, groups):
            e, tids = row[dr if groups > 1 else 0]
            masks.append(g.admit(e, tids))
            for e1, t1 in row:
                ones.append(one.admit(e1, t1))
        masks = np.stack(masks)
        every = [None] * WORLD
        dist.all_gather_object(every, masks)
        out[f"g_{name}_masks"] = np.stack(every)       # (ranks, admits, B)
        out[f"g_{name}_one_masks"] = np.stack(ones)
        _state(f"g_{name}", g._shard.gather(g.state), out)
        _state(f"g_{name}_one", one.state, out)


def streams(mesh, d: dict, out: dict) -> None:
    """Every StreamRunner case sharded, with its keep masks and summaries,
    on the reference's W."""
    from repro_torch.data.pipeline import AceDataFilter
    from repro_torch.fleet.filter import FleetDataFilter
    from repro_torch.stream.runner import StreamRunner
    from repro_torch.window.filter import WindowedAceFilter
    kinds = {"flat": AceDataFilter, "window": WindowedAceFilter,
             "fleet": FleetDataFilter}
    dr = mesh.get_local_rank("data")
    for c, (name, kind, fields, layout) in enumerate(STREAM_CASES):
        filt = kinds[kind](**{**FILTER_BASE, **fields}, device="cpu")
        runner = StreamRunner(filt, STREAM_T, return_masks=True, mesh=mesh,
                              sketch_layout=layout)
        state, _ = runner.init()
        w = torch.as_tensor(d[f"s_{name}_w"])
        groups = tenant_groups(layout)
        feats, tids = stream_batches(c, groups)[dr if groups > 1 else 0]
        keeps, summaries = [], []
        for k in range(STREAM_CHUNKS):
            chunk = torch.as_tensor(np.stack(
                feats[k * STREAM_T:(k + 1) * STREAM_T]))
            tc = None if tids is None else torch.as_tensor(np.stack(
                tids[k * STREAM_T:(k + 1) * STREAM_T]))
            state, summary, keep = runner.consume(state, w, chunk, tc)
            keeps.append(_np(keep))
            summaries.append(runner.fetch(summary))
        every = [None] * WORLD
        dist.all_gather_object(every, np.stack(keeps))
        out[f"s_{name}_keeps"] = np.stack(every)
        _state(f"s_{name}", runner.shard.gather(state), out)
        for f in ("n", "falpha", "kept_frac", "topk_margin"):
            out[f"s_{name}_sum_{f}"] = np.stack([getattr(s, f)
                                             for s in summaries])
        # one chunk under a health mask, whole on every rank
        feats, tids = stream_batches(c, groups, 1, seed=250)[
            dr if groups > 1 else 0]
        state, summary, keep = runner.consume(
            state, w, torch.as_tensor(np.stack(feats)),
            None if tids is None else torch.as_tensor(np.stack(tids)),
            table_mask=torch.as_tensor(d[f"s_{name}_mask"]))
        summary = runner.fetch(summary)
        every = [None] * WORLD
        dist.all_gather_object(every, (_np(keep), summary.n, summary.falpha,
                                       summary.degraded))
        for i, f in enumerate(("keeps", "sum_n", "sum_falpha",
                               "sum_degraded")):
            out[f"sm_{name}_{f}"] = np.stack([e[i] for e in every])
        _state(f"sm_{name}", runner.shard.gather(state), out)


def _report(rep) -> np.ndarray:
    """A host ``HealthReport`` as one flat bool vector."""
    return np.concatenate([np.asarray(x, bool).reshape(-1) for x in rep])


def masked_mu(g, report: np.ndarray) -> np.ndarray:
    """(this rank's masked μ through ``ShardedSketch.mean_mu``, the single
    card's masked μ of the gathered state, its rows of this rank's
    tenants), under the whole serving mask of the first audit (its
    table verdicts: no table re-warms yet)."""
    from repro_torch.core import sketch as sk
    from repro_torch.fleet import state as fl
    from repro_torch.window import ring
    sh, cfg = g._shard, g.gcfg
    T, L = max(cfg.num_tenants, 1), cfg.num_tables
    whole = torch.as_tensor(report[:T * L].reshape((T, L) if T > 1 else (L,))
                            .astype(np.float32))
    state = sh.gather(g.state)
    if g.windowed:
        one = ring.mean_mu_windowed(state, cfg.window_decay, whole)
    elif g.multi_tenant:
        one = sh.tenant_block(fl.mean_mu_fleet(state, whole))
    else:
        one = sk.mean_mu(state, whole)
    got = sh.mean_mu(g.state, g._table_mask, cfg.window_decay)
    return np.stack([_np(got), _np(one)])


def lifecycle(mesh, case: int, d: dict, out: dict) -> None:
    """One ``LIFE_CASES`` lifecycle on the sharded ``Guardrail``: LIFE_WARM
    admits, the test's bit flips in this rank's block (on data rank 0
    only for a replica case), ``health_check``, one degraded admit,
    ``repair``, then admit + ``health_check`` until healthy (at most
    LIFE_REWARM), one healthy admit.  Rank 0 keeps every rank's verdicts,
    reports, ``degraded`` and ``_rewarm_admits`` after each audit, the
    admit at which recovery landed, the ``_to_host`` calls of each step,
    and each rank's gathered state right after the repair and at the
    end."""
    from repro_torch.serve import engine
    name, gc, replica = LIFE_CASES[case]
    _, fields, layout = GUARD_CASES[gc]
    gname = GUARD_CASES[gc][0]
    gcfg = engine.GuardrailConfig(**{**GUARD_BASE, **fields})
    g = engine.Guardrail(gcfg, device="cpu", mesh=mesh, sketch_layout=layout,
                         w=torch.as_tensor(d[f"g_{gname}_w"]))
    sh = g._shard
    dr = mesh.get_local_rank("data")
    groups = tenant_groups(layout)
    batches = iter(life_batches(case, groups))
    calls = []
    real = engine._to_host

    def counted(x):
        calls.append(tuple(x.shape))
        return real(x)

    def step(fn):
        """fn() and the number of ``_to_host`` calls it made."""
        before = len(calls)
        res = fn()
        return res, len(calls) - before

    masks, reports, flags, d2h = [], [], [], {"admit": [], "health_check": []}

    def serve():
        e, t = next(batches)[dr if groups > 1 else 0]
        m, k = step(lambda: g.admit(e, t))
        masks.append(m)
        d2h["admit"].append(k)

    def audit(method):
        rep, k = step(getattr(g, method))
        if method == "health_check":
            d2h["health_check"].append(k)
        reports.append(_report(rep))
        flags.append((g.degraded, g._rewarm_admits))

    kind = "fleet" if g.multi_tenant else "window" if g.windowed else "flat"
    engine._to_host = counted
    try:
        for _ in range(LIFE_WARM):
            serve()
        if not replica or dr == 0:
            c = g.state.counts
            for lead, j, b, bit in d[f"life_{gname}_flips"].tolist():
                if not sh.table_start <= j < sh.table_start + sh.l_local:
                    continue
                if kind == "fleet":
                    if not sh.tenant_start <= lead < (sh.tenant_start
                                                      + sh.t_local):
                        continue
                    lead -= sh.tenant_start
                c[flip_index(lead, j - sh.table_start, b, kind)] ^= 1 << bit
        audit("health_check")
        mu = masked_mu(g, reports[-1])
        serve()                                  # degraded
        audit("repair")
        # copied now: the kernels update the counts in place
        repaired = {k: _np(v).copy() for k, v in zip(
            FIELDS, (getattr(sh.gather(g.state), f) for f in FIELDS))}
        landed = -1
        for i in range(LIFE_REWARM):
            serve()
            audit("health_check")
            if not g.degraded:
                landed = i
                break
        serve()
    finally:
        engine._to_host = real
    final = sh.gather(g.state)
    mine = dict(masks=np.stack(masks), reports=np.stack(reports), mu=mu,
                flags=np.asarray(flags), landed=np.asarray(landed),
                d2h_admit=np.asarray(d2h["admit"]),
                d2h_check=np.asarray(d2h["health_check"]),
                **{f"repaired_{k}": v for k, v in repaired.items()},
                **{f"final_{k}": _np(getattr(final, k)) for k in FIELDS})
    every = [None] * WORLD
    dist.all_gather_object(every, mine)
    for k in mine:
        out[f"life_{name}_{k}"] = np.stack([e[k] for e in every])


def health(mesh, d: dict, out: dict) -> None:
    """Every ``LIFE_CASES`` lifecycle."""
    for case in range(len(LIFE_CASES)):
        lifecycle(mesh, case, d, out)


def gpipe(d: dict, out: dict) -> None:
    from repro_torch.dist.mesh import make_mesh
    from repro_torch.dist.pipeline import pipeline_apply
    pmesh = make_mesh((WORLD,), ("pipe",), "cpu")
    x = torch.as_tensor(d["pipe_x"])
    out["pipe_out"] = _np(pipeline_apply(
        lambda p, h: torch.tanh(h @ p["w"]),
        {"w": torch.as_tensor(d["pipe_w"])}, x, mesh=pmesh,
        num_stages=WORLD, num_microbatches=x.shape[0]))


def training(mesh, d: dict, out: dict) -> None:
    """Reduced olmo_1b, TRAIN_STEPS steps sharded (FSDP + model-axis rules,
    table-sharded sketches) and on one process, each from the port's
    initial parameters with the reference's filter and monitor W (the
    start of the reference's run in the test)."""
    from repro_torch.data.pipeline import DataStream, StreamConfig
    from repro_torch.dist import mesh as dm
    from repro_torch.models.common import set_rules
    from repro_torch.models.registry import Arch, leaves
    from repro_torch.train import sharded
    from repro_torch.train.train_loop import (TrainConfig,
                                              init_train_state, train)
    arch = Arch("olmo_1b", reduced=True)
    tcfg = TrainConfig(**TRAIN_CFG, device="cpu")
    scfg = StreamConfig(vocab_size=arch.cfg.vocab_size, seq_len=TRAIN_S,
                        global_batch=TRAIN_B)
    set_rules(dm.rules_for(mesh))
    shapes = arch.abstract_params()[0]
    specs = dm.sharding_tree_for(
        mesh, dm.fsdp_tree(arch.param_pspecs(), shapes, mesh), shapes)

    def start():
        return init_train_state(arch, tcfg)._replace(
            filter_w=torch.as_tensor(d["tr_filter_w"]),
            monitor_w=torch.as_tensor(d["tr_monitor_w"]))
    state = sharded.shard_train_state(start(), arch, tcfg, mesh, specs,
                                      "table_sharded")
    state, hist = train(arch, tcfg, DataStream(scfg), TRAIN_STEPS,
                        log_every=0, state=state, mesh=mesh,
                        grad_pspecs=specs, sketch_layout="table_sharded")
    one, one_hist = train(arch, tcfg, DataStream(scfg), TRAIN_STEPS,
                          log_every=0, state=start())
    params = sharded.gather_params(state.params, specs, mesh)
    out["t_params"] = np.concatenate([_np(a).reshape(-1)
                                      for a in leaves(params)])
    out["t_param_diff"] = np.concatenate(
        [_np(a - b).reshape(-1) for a, b in zip(leaves(params),
                                                leaves(one.params))])
    out["t_lr_sum"] = np.asarray(sum(h["lr"] for h in one_hist))
    for k in ("loss", "grad_norm", "filter_keep_frac", "grad_anomaly"):
        out[f"t_{k}"] = np.asarray([h[k] for h in hist])
        out[f"t_one_{k}"] = np.asarray([h[k] for h in one_hist])
    fsh, msh = sharded.sketch_shards(tcfg, arch, mesh, "table_sharded")
    _state("t_filter", fsh.gather(state.filter_state), out)
    _state("t_filter_one", one.filter_state, out)
    _state("t_monitor", msh.gather(state.monitor.ace), out)
    _state("t_monitor_one", one.monitor.ace, out)
    out["t_fsdp_split"] = np.asarray(sum(
        1 for ps in sharded.spec_leaves(specs) if "data" in ps))


FEATURE_STEPS = 4                 # each feature run's steps
FEATURE_CFGS = {                  # name: (TrainConfig fields, mesh, layout)
    "adafactor": (dict(optimizer="adafactor"), (2, 1), None),
    "adafactor_2x2": (dict(optimizer="adafactor"), (2, 2), None),
    "compression": (dict(grad_compression=True), (2, 1), None),
    "chunked": (dict(filter_chunk=2), (1, 2), "table_sharded"),
    "ckpt": (dict(grad_compression=True, ckpt_interval=2), (2, 1), None),
}
# plan-against-tally cases: (TrainConfig fields, layout) on the world's mesh
PLAN_CASES = ((dict(), None), (dict(), "table_sharded"),
              (dict(optimizer="adafactor", grad_compression=True),
               "table_sharded"))


def feature_config(name: str, **kw):
    from repro_torch.train.train_loop import TrainConfig
    fields, _, _ = FEATURE_CFGS[name]
    return TrainConfig(**{**TRAIN_CFG, **fields, **kw}, device="cpu")


def feature_specs(arch, mesh):
    """launch.train's specs: the logical rules of the mesh, FSDP over
    data, divisibility."""
    from repro_torch.dist import mesh as dm
    from repro_torch.models.common import set_rules
    set_rules(dm.rules_for(mesh))
    shapes = arch.abstract_params()[0]
    specs = dm.sharding_tree_for(
        mesh, dm.fsdp_tree(arch.param_pspecs(), shapes, mesh), shapes)
    set_rules({})
    return specs


def feature_start(arch, tcfg, d: dict):
    """The port's initial state with the reference's filter and monitor W
    (the start of the reference's runs in the test)."""
    from repro_torch.train.train_loop import init_train_state
    return init_train_state(arch, tcfg)._replace(
        filter_w=torch.tensor(d["tr_filter_w"]),
        monitor_w=torch.tensor(d["tr_monitor_w"]))


def feature_stream(arch):
    from repro_torch.data.pipeline import DataStream, StreamConfig
    return DataStream(StreamConfig(vocab_size=arch.cfg.vocab_size,
                                   seq_len=TRAIN_S, global_batch=TRAIN_B))


def _save_run(prefix, state, hist, specs, mesh, out):
    from repro_torch.models.registry import leaves
    from repro_torch.train import sharded
    params = sharded.gather_params(state.params, specs, mesh)
    out[f"{prefix}_params"] = np.concatenate(
        [_np(a).reshape(-1) for a in leaves(params)])
    for k in ("loss", "grad_norm", "lr", "filter_keep_frac",
              "grad_anomaly"):
        out[f"{prefix}_{k}"] = np.asarray([h.get(k, np.nan) for h in hist])


def noise_feed(d: dict):
    """``train.compression.uniform_noise`` in the test's draws
    (``cnoise_0``, ``cnoise_1``, … in draw order: the reference's
    rounding noise, each part of a leaf whole), and a check that every
    draw was taken."""
    taken = [0]

    def feed(shape, generator):
        x = torch.tensor(d[f"cnoise_{taken[0]}"])
        assert tuple(x.shape) == tuple(shape), (tuple(x.shape), shape)
        taken[0] += 1
        return x

    def check():
        assert f"cnoise_{taken[0]}" not in d and taken[0] > 0, taken[0]
    return feed, check


def meta_batch(batch: dict) -> dict:
    """A batch's shapes and dtypes as ``meta`` tensors."""
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in batch.items()}


def plans(world: int, mesh, d: dict, out: dict) -> None:
    """One live step of each ``PLAN_CASES`` case against the same step on
    ``meta`` over the mesh's shape (``sharded.step_on_meta``): by kind,
    bytes and count, and by axis."""
    import json
    from repro_torch.dist import collectives as col
    from repro_torch.models.registry import Arch
    from repro_torch.train import sharded
    from repro_torch.train import train_loop as tl
    arch = Arch("olmo_1b", reduced=True)
    specs = feature_specs(arch, mesh)
    for i, (fields, layout) in enumerate(PLAN_CASES):
        tcfg = tl.TrainConfig(**{**TRAIN_CFG, **fields}, device="cpu")
        state = sharded.shard_train_state(feature_start(arch, tcfg, d), arch,
                                          tcfg, mesh, specs, layout)
        step = tl.make_train_step(arch, tcfg, specs, layout, mesh)
        batch = tl._to_device({k: v for k, v in next(feature_stream(arch))
                               .items() if not k.startswith("_")},
                              torch.device("cpu"))
        with col.tallied() as tally:
            step(state, batch)
        live = tally.snapshot()
        plan = sharded.step_on_meta(arch, tcfg, specs, layout, mesh,
                                    meta_batch(batch))
        every = [None] * world
        dist.all_gather_object(every, json.dumps(live, sort_keys=True))
        out[f"plan{i}_live"] = np.asarray(every)
        out[f"plan{i}_plan"] = np.asarray(json.dumps(plan, sort_keys=True))


def trainings(world: int, mesh_of, d: dict, out: dict, root: str) -> None:
    """Every ``FEATURE_CFGS`` run whose mesh has ``world`` ranks; the
    compression case on the reference's rounding noise (``noise_feed``),
    the checkpoint case on the generator's and also resumed from its
    step-2 checkpoint."""
    import math
    import shutil
    from repro_torch.models.registry import Arch
    from repro_torch.train import compression, sharded
    from repro_torch.train.train_loop import train
    arch = Arch("olmo_1b", reduced=True)
    for name, (_, shape, layout) in FEATURE_CFGS.items():
        if math.prod(shape) != world:
            continue
        mesh = mesh_of(shape)
        specs = feature_specs(arch, mesh)
        kw = {}
        if name == "ckpt":
            kw["ckpt_dir"] = os.path.join(root, "ckpt")
        tcfg = feature_config(name, **kw)
        state = sharded.shard_train_state(feature_start(arch, tcfg, d), arch,
                                          tcfg, mesh, specs, layout)
        drawn = compression.uniform_noise
        if name == "compression":
            compression.uniform_noise, check = noise_feed(d)
        try:
            state, hist = train(arch, tcfg, feature_stream(arch),
                                FEATURE_STEPS, log_every=0, state=state,
                                mesh=mesh, grad_pspecs=specs,
                                sketch_layout=layout)
        finally:
            compression.uniform_noise = drawn
        if name == "compression":
            check()
        _save_run(f"f_{name}", state, hist, specs, mesh, out)
        if layout is not None:
            fsh, _ = sharded.sketch_shards(tcfg, arch, mesh, layout)
            _state(f"f_{name}_filter", fsh.gather(state.filter_state), out)
        if name != "ckpt":
            continue
        resumed = os.path.join(root, "resumed")
        if dist.get_rank() == 0:
            os.makedirs(resumed)
            shutil.copytree(os.path.join(root, "ckpt", f"step_{2:010d}"),
                            os.path.join(resumed, f"step_{2:010d}"))
        dist.barrier()
        tcfg = feature_config(name, ckpt_dir=resumed)
        state = sharded.shard_train_state(feature_start(arch, tcfg, d), arch,
                                          tcfg, mesh, specs, layout)
        state, hist = train(arch, tcfg, feature_stream(arch),
                            FEATURE_STEPS - 2, log_every=0, state=state,
                            mesh=mesh, grad_pspecs=specs)
        _save_run("f_resumed", state, hist, specs, mesh, out)


def features(rank: int, world: int, d: dict, root: str) -> dict:
    from repro_torch.dist.mesh import make_debug_mesh
    out: dict = {}

    def mesh_of(shape):
        return make_debug_mesh(data=shape[0], model=shape[1],
                               device_type="cpu")
    plans(world, mesh_of((2, world // 2)), d, out)
    trainings(world, mesh_of, d, out, root)
    return out


def run(rank: int, d: dict) -> dict:
    from repro_torch.dist.mesh import make_debug_mesh
    mesh = make_debug_mesh(data=2, model=2, device_type="cpu")
    out: dict = {}
    primitives(mesh, d, out)
    guardrails(mesh, d, out)
    health(mesh, d, out)
    streams(mesh, d, out)
    gpipe(d, out)
    training(mesh, d, out)
    return out


def _rank(rank: int, inp: str, out_path: str, init: str,
          world: int = WORLD, mode: str = "layouts") -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world)
    try:
        d = dict(np.load(inp))
        res = (run(rank, d) if mode == "layouts" else
               features(rank, world, d, os.path.dirname(out_path)))
        if rank == 0:
            np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "--features":
        inp, out_path = sys.argv[2], sys.argv[3]
        root = os.path.dirname(os.path.abspath(out_path))
        for world in (2, 4):
            sub = os.path.join(root, f"w{world}")
            os.makedirs(sub)
            mp.spawn(_rank, args=(inp, os.path.join(sub, "out.npz"),
                                  os.path.join(sub, "gloo_init"), world,
                                  "features"), nprocs=world)
    else:
        inp, out_path = sys.argv[1], sys.argv[2]
        init = os.path.join(os.path.dirname(os.path.abspath(out_path)),
                            "gloo_init")
        mp.spawn(_rank, args=(inp, out_path, init), nprocs=WORLD)
