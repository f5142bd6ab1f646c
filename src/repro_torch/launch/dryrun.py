"""The dry run: every (arch × shape) cell built on an abstract production
mesh, on the ``meta`` device, with its per-rank bytes, costs and
collectives.  Port of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo_1b \\
        --shape train_4k [--multi-pod | --both-meshes] [--all] [--force] \\
        [--out DIR]

Nothing is allocated and no card is needed.  Per cell:

1. the 16×16 ``("data", "model")`` mesh — or 2×16×16 ``("pod", "data",
   "model")`` — as a shape-only ``MeshShape`` (``make_production_mesh``);
2. the logical rules of that mesh (``rules_for``; long-context cells put
   the KV cache's sequence axis on the data axes), FSDP over ``data``
   (``fsdp_tree``) and the divisibility check (``sharding_tree_for``);
3. the reference's policy (``cell_policy``): Adafactor past 40 B
   parameters, microbatches sized to the activation budget, bf16
   parameters for the serving cells;
4. the cell's program run on ``meta`` as rank 0 runs it, against the
   mesh's shape (``cell_costs``): a train cell's step is
   ``make_sharded_train_step`` itself (``train.sharded.step_on_meta``:
   its collectives tallied by ``dist.collectives`` and not run, the
   sketches' kernels in their plain versions on shapes).  It runs at one
   and at two superblocks, and the totals are extrapolated to the
   model's depth as the reference's probe does (body = f(2) − f(1),
   total = f(1) + (n_sb − 1)·body), so no cell runs more than two
   superblocks; past two microbatches a step runs at one and two and is
   extrapolated the same way.  A recurrent config's probes run at three
   short sequence lengths where that is exact, a fourth where the data
   filter samples its tokens (``seq_probes``, ``_fit``), and are fitted
   to the cell's;
5. ``<out>/<arch>__<shape>__<mesh>.json`` with the reference's keys
   (``CellResult``), which ``dist.roofline`` reads.

The program a cell describes is the port's.  ``make_sharded_train_step``
holds parameters, optimiser state and gradients as blocks of their specs
and gathers every parameter whole at use, so each rank runs every layer
whole on its rows of the batch (the global batch ÷ the batch axes); the
model axis splits storage, not compute.  A serving cell runs the same
way: parameters and the cache held as blocks, each gathered whole over
its non-batch axes at use (the cache's batch rows stay split), every
layer whole on the rank's rows.

What the numbers are:

* ``flops``: ``torch.utils.flop_counter``'s rules (``FlopCounterMode``'s
  registry) over the whole step: the forward and the backward (with
  remat's recompute), the filter's and the monitor's hashes.  They count
  matrix products (mm, bmm, addmm, baddbmm, einsum's products,
  attention) and nothing else: elementwise work — the recurrences'
  scans, norms, softmax, the optimiser — adds no flops.
* ``bytes_accessed``: every aten op's input and output bytes, counted by
  a ``TorchDispatchMode`` (views and allocations move nothing and are
  left out): the eager port's unfused traffic, an upper bound on what
  reaches HBM where tensors stay in the 50 MB L2.
* ``memory.args``: the exact per-rank bytes of the step's inputs, by
  ``local_shape``: parameter, optimiser, error-feedback and sketch blocks
  (the projections whole), and the batch (every rank gets the global
  batch in training, its rows in serving) and cache blocks.
  ``memory.temp`` is the reference's activation model (``cell_policy``:
  tokens × (2·d·n_sb + the per-token recompute bytes) ÷ microbatches),
  an estimate (``temp_is_estimate``).
* ``collectives``: the tally of the program's own collective calls on
  ``meta`` (a serving cell's parameter and cache gathers), by kind and by
  axis, the layout of ``collectives.TALLY.snapshot()``: a live step's
  tally equals it.  It takes the place of the reference's HLO analysis
  (``repro.dist.hlo_analysis``).
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import gc
import json
import math
import os
import time
import traceback

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.dist import collectives as col
from repro_torch.dist.mesh import (P, axis_sizes, fsdp_tree, local_shape,
                                   make_production_mesh, map_specs,
                                   rules_for, sanitize_pspec,
                                   sharding_tree_for)
from repro_torch.dist.sketch_parallel import gather_block
from repro_torch.models.common import get_rules, set_rules
from repro_torch.models.registry import (META, SHAPES, Arch, ShapeSpec,
                                         all_cells, is_whisper)
from repro_torch.train import sharded
from repro_torch.train.optim import make_optimizer

ACTIVATION_BUDGET = 3.5e9     # bytes/device of saved layer-boundary carries
BIG_MODEL_PARAMS = 4e10       # adafactor beyond this (no fp32 moment pair)
F32 = torch.float32


@dataclasses.dataclass
class CellPolicy:
    optimizer: str
    microbatches: int
    serve_bf16: bool = True


def _per_token_recompute_bytes(cfg, seq_len: int, model_shards: int = 16):
    """Peak live bytes/token while ONE superblock recomputes in backward
    (the reference's model, term for term).

    Rough per-layer-kind model (f32 residuals where the math is f32):
      attn/swa : score rows (S or window) × heads_local × 4 + qkv/mlp temps
      mamba    : the (delta, B, C, xc) xs streams in f32
      rwkv     : the (r, k, v, w) streams in f32
      moe adds : dispatch/combine + (E, C, D) expert slots per token
    """
    total = 0.0
    for pos, kind in enumerate(cfg.block_pattern):
        if kind in ("attn", "swa"):
            span = min(seq_len, cfg.sliding_window or seq_len) \
                if kind == "swa" else seq_len
            h_local = max(cfg.num_heads // model_shards, 1)
            total += span * 4.0 * h_local / 8.0   # chunked/flash factor
            total += 10 * cfg.d_model * 2
        elif kind == "mamba":
            d_inner = cfg.mamba_expand * cfg.d_model
            total += (2 * d_inner + 2 * cfg.mamba_d_state) * 4
            total += 6 * cfg.d_model * 2
        elif kind == "rwkv":
            total += 16 * cfg.d_model * 4
        if cfg.moe_num_experts and \
                pos % cfg.moe_layer_period == cfg.moe_layer_period - 1 \
                and kind != "rwkv":
            cf, K, E = cfg.moe_capacity_factor, cfg.moe_top_k, \
                cfg.moe_num_experts
            ff_local = max(cfg.d_ff // model_shards, 1)
            total += cf * K * (2 * cfg.d_model + ff_local) * 2  # slots
            total += E * cf * K * 4                             # disp/comb
    return total


def _superblocks(cfg) -> int:
    return (cfg.num_layers + cfg.encoder_layers) \
        // max(len(cfg.block_pattern), 1)


def cell_policy(arch: Arch, shape, mesh) -> CellPolicy:
    """The reference's policy; ``mesh`` is anything ``axis_sizes`` reads."""
    cfg = arch.cfg
    sizes = axis_sizes(mesh)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    if shape.kind != "train":
        return CellPolicy(optimizer="adamw", microbatches=1)
    n_params = arch.param_count()
    opt = "adafactor" if n_params > BIG_MODEL_PARAMS else "adamw"
    b_local = max(shape.global_batch // dp, 1)
    n_sb = _superblocks(cfg)
    tokens_local = b_local * shape.seq_len
    # carries (whole step) + one superblock's recompute working set (per mb)
    per_tok = (2 * cfg.d_model * max(n_sb, 1)
               + _per_token_recompute_bytes(cfg, shape.seq_len))
    mb = 1
    while tokens_local * per_tok / mb > ACTIVATION_BUDGET and mb < b_local:
        mb *= 2
    while b_local % mb != 0:
        mb *= 2
    mb = min(mb, b_local)
    return CellPolicy(optimizer=opt, microbatches=mb)


@dataclasses.dataclass
class CellResult:
    """One cell's JSON: the reference's keys (``trip_counts`` is None: no
    loop is left to count), plus ``mesh_axes``."""
    arch: str
    shape: str
    mesh: str
    ok: bool
    seconds: float
    error: str | None = None
    memory: dict | None = None
    flops: float | None = None
    bytes_accessed: float | None = None
    collectives: dict | None = None
    params: int | None = None
    active_params: int | None = None
    policy: dict | None = None
    trip_counts: list | None = None
    # totals extrapolated from the depth-1 and depth-2 probes
    corrected: dict | None = None
    probe_error: str | None = None
    mesh_axes: dict | None = None


# ---------------------------------------------------------------------------
# Counting on ``meta``.
# ---------------------------------------------------------------------------

_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten.empty_like,
               torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
               torch.ops.aten.new_empty_strided}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class Costs(TorchDispatchMode):
    """``with Costs() as c: …`` -> ``c.flops``, ``c.bytes``: one dispatch
    mode over every aten op.  Flops by ``torch.utils.flop_counter``'s
    registry (``FlopCounterMode``'s rules: matrix products only); bytes
    the op's inputs and outputs, views (outputs that alias an input) and
    allocations left out as they move nothing."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        count = flop_registry.get(packet)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if not (func.is_view or packet in _NO_TRAFFIC):
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out

    def __exit__(self, *exc):
        self.flops, self.bytes = float(self.flops), float(self.bytes)
        return super().__exit__(*exc)


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _local_rows(batch: int, mesh, rules, long_ctx: bool) -> int:
    """This rank's rows of a global batch: split over the batch axes when
    they divide it (never in a long-context cell)."""
    ps = P() if long_ctx else sanitize_pspec(P(rules.get("batch")),
                                             (batch,), mesh)
    return local_shape((batch,), ps, mesh)[0]


def _train_tcfg(arch: Arch, policy: CellPolicy, tcfg=None):
    from repro_torch.train.train_loop import TrainConfig
    if tcfg is None:
        cfg = arch.cfg
        tcfg = TrainConfig(
            optimizer=policy.optimizer, microbatches=policy.microbatches,
            use_data_filter=cfg.input_mode == "tokens" and not is_whisper(
                cfg), use_grad_monitor=True, remat=True)
    return dataclasses.replace(tcfg, device="meta")


def _param_specs(arch: Arch, mesh, rules):
    """The cell's parameter layout: the mesh's logical rules, FSDP over
    ``data``, the divisibility check."""
    shapes = arch.abstract_params()[0]
    return sharding_tree_for(mesh, fsdp_tree(arch.param_pspecs(rules),
                                             shapes, mesh, axis="data"),
                             shapes)


def _blocks(tree, specs, mesh):
    """Rank 0's blocks of a tree of ``meta`` tensors."""
    return map_specs(lambda ps, t: _empty(local_shape(t.shape, ps, mesh),
                                          t.dtype), specs, tree)


def _cache_gather_specs(cache_specs):
    """A cache leaf's spec without its batch (leading) entry: the axes its
    block is gathered over at use."""
    return map_specs(lambda ps: P(None, *tuple(ps)[1:]) if len(ps) else ps,
                     cache_specs)


def cell_costs(arch: Arch, shape, mesh, rules, long_ctx: bool, rows: int,
               tcfg=None) -> tuple:
    """(flops, bytes, collectives) of one step of the cell's program on
    rank 0, at ``arch``'s own depth and ``shape``'s own length, run on
    ``meta`` against ``mesh``'s shape.  Training: the sharded step itself
    (``train.sharded.step_on_meta``) on the global batch; past two
    microbatches, its runs at one and two microbatches of the same rows
    extrapolated to ``tcfg.microbatches`` (every cost is affine in the
    count: the microbatches are alike, and the filter's rows and the loss
    weights grow with them).  Serving: each parameter block gathered
    whole, and a decode cell's cache blocks over their non-batch axes,
    then ``prefill`` or ``decode_step`` on the rank's ``rows``, every
    layer whole."""
    specs = _param_specs(arch, mesh, rules)
    if shape.kind == "train":
        mb = tcfg.microbatches
        runs = []
        for m in (1, 2) if mb > 2 else (mb,):
            c = Costs()
            part = dataclasses.replace(
                shape, global_batch=shape.global_batch // mb * m)
            coll = sharded.step_on_meta(
                arch, dataclasses.replace(tcfg, microbatches=m), specs, None,
                mesh, arch.input_specs(part), count=c)
            runs.append((c.flops, c.bytes, coll))
        if len(runs) == 1:
            return runs[0]
        (f1, b1, c1), (f2, b2, c2) = runs
        return (extrapolate(f1, f2, mb), extrapolate(b1, b2, mb),
                extrapolate_tally(c1, c2, mb))
    shapes = arch.abstract_params()[0]
    blocks = _blocks(shapes, specs, mesh)
    batch = arch.input_specs(shape, batch_override=rows)
    if shape.kind == "decode":
        cache = arch.cache_specs(shape, batch_override=shape.global_batch)
        cspecs = sharding_tree_for(
            mesh, arch.cache_pspecs(long_context=long_ctx, rules=rules),
            cache)
        cblocks = _blocks(cache, cspecs, mesh)
    with torch.no_grad(), Costs() as c, col.tallied() as tally:
        params = map_specs(lambda ps, t: gather_block(t, ps, mesh), specs,
                           blocks)
        if shape.kind == "prefill":
            arch.prefill(params, batch)
        else:
            whole = map_specs(lambda ps, t: gather_block(t, ps, mesh),
                              _cache_gather_specs(cspecs), cblocks)
            arch.decode_step(params, batch, whole,
                             arch.decode_pos_spec(shape,
                                                  batch_override=rows))
    return c.flops, c.bytes, tally.snapshot()


SEQ_PROBE = 64                # the sequence-length probes' step


def _filters_tokens(arch: Arch, shape, tcfg) -> bool:
    """The cell's step runs the data filter on token embeddings, whose
    count (``train_loop.filter_tokens``) stops growing at 512 tokens."""
    return (shape.kind == "train" and tcfg is not None
            and tcfg.use_data_filter and tcfg.filter_chunk <= 1
            and arch.cfg.input_mode == "tokens")


def seq_probes(arch: Arch, shape, rows: int, tcfg=None):
    """Given the rows a forward runs at once (a microbatch's, training),
    the sequence lengths s, 2s, 3s (s = ``SEQ_PROBE``) at which a
    recurrent config's step costs extrapolate EXACTLY to ``shape.seq_len``
    (``_fit``), or None.  Its per-time-step loops make a probe at full
    length slow on ``meta``; every cost of such a step is a polynomial of
    degree 2 in the sequence length as long as no code path changes
    between the probes and the target: attention (no sliding window)
    dense on both sides of ``q_chunk_threshold`` or chunked on both, an
    MoE's token groups one group of every token at each length (its
    capacity, cf·T·K/E, an integer) or groups of ``group_size`` at each.
    One term is not: the data filter's sampled embeddings, linear in
    ``filter_tokens(S)``, which is S below 512 and about 256 past it.  When
    the target samples, a fourth probe at 512 tokens gives that term's
    cost per token."""
    from repro_torch.train.train_loop import filter_tokens
    cfg = arch.cfg
    S = shape.seq_len
    if shape.kind == "decode" or cfg.encoder_layers \
            or not {"mamba", "rwkv"} & set(cfg.block_pattern) \
            or "swa" in cfg.block_pattern or 3 * SEQ_PROBE >= S:
        return None
    lengths = tuple(k * SEQ_PROBE for k in (1, 2, 3))
    if _filters_tokens(arch, shape, tcfg) and filter_tokens(S) != S:
        lengths += (512,)
    dense = [L <= cfg.q_chunk_threshold for L in lengths + (S,)]
    if "attn" in cfg.block_pattern and len(set(dense)) > 1:
        return None
    if cfg.moe_num_experts:
        group = 4096                            # models.mlp.moe's default
        toks = [rows * L for L in lengths + (S,)]
        one = all(t <= group for t in toks) and all(
            float(cfg.moe_capacity_factor * t * cfg.moe_top_k
                  / cfg.moe_num_experts).is_integer() for t in toks)
        if not (one or all(t % group == 0 for t in toks)):
            return None
    return lengths


def _quadratic(lengths, values, S: int) -> float:
    """The degree-2 polynomial through (lengths[i], values[i]), equally
    spaced, at S (Newton's form)."""
    (s1, s2, _), (c1, c2, c3) = lengths, values
    h = s2 - s1
    d1 = (c2 - c1) / h
    d2 = (c3 - 2 * c2 + c1) / (2 * h * h)
    return c1 + (S - s1) * d1 + (S - s1) * (S - s2) * d2


def _fit(lengths, values, S: int) -> float:
    """A cost at S from ``seq_probes``' probes: the quadratic through the
    first three (each scores all its tokens in the filter) less, with a
    fourth probe, the filter's cost per token times the tokens the filter
    skips at S; that cost is what the fourth probe, which skips
    L4 − ``filter_tokens(L4)`` tokens, falls short of the quadratic by."""
    from repro_torch.train.train_loop import filter_tokens
    fit = _quadratic(lengths[:3], values[:3], S)
    if len(lengths) == 3:
        return fit
    L4 = lengths[3]
    per_token = (_quadratic(lengths[:3], values[:3], L4) - values[3]) \
        / (L4 - filter_tokens(L4))
    return fit - per_token * (S - filter_tokens(S))


def _probe(arch: Arch, shape, depth: int) -> Arch:
    """``arch`` at ``depth`` superblocks (whisper: ``depth`` layers in each
    stack), its recurrences in one time chunk, as the reference's
    probes."""
    a = copy.copy(arch)
    repl = dict(num_layers=len(arch.cfg.block_pattern) * depth,
                scan_unroll=max(depth, 1), unroll_q_chunks=True,
                time_chunk=max(shape.seq_len, 1))
    if arch.cfg.encoder_layers:
        repl["encoder_layers"] = depth
    a.cfg = dataclasses.replace(arch.cfg, **repl)
    return a


# ---------------------------------------------------------------------------
# Per-rank bytes.
# ---------------------------------------------------------------------------

def _block_bytes(tree, specs, mesh) -> int:
    total = []
    map_specs(lambda ps, t: total.append(
        math.prod(local_shape(t.shape, ps, mesh)) * t.element_size()),
        specs, tree)
    return sum(total)


def _sketch_bytes(arch: Arch, tcfg) -> int:
    """The filter's and the monitor's states and projections, whole on
    every rank (the dry run's sketches are replicated)."""
    from repro_torch.train.fault import GradMonitor
    from repro_torch.train.train_loop import make_data_filter
    total = 0
    if tcfg.use_data_filter:
        total += _nbytes(make_data_filter(tcfg, arch.cfg.d_model).init())
    if tcfg.use_grad_monitor:
        total += _nbytes(GradMonitor(feature_dim=tcfg.monitor_feature_dim,
                                     device=META).init())
    return total


def _memory(arch: Arch, shape, mesh, rules, long_ctx, policy, specs,
            rows: int, tcfg) -> dict:
    """The full-depth cell's per-rank memory dict."""
    params = arch.abstract_params()[0]
    p_bytes = _block_bytes(params, specs, mesh)
    tokens = rows * (shape.seq_len if shape.kind != "decode" else 1)
    per_tok = (2 * arch.cfg.d_model * max(_superblocks(arch.cfg), 1)
               + _per_token_recompute_bytes(arch.cfg, shape.seq_len))
    temp = tokens * per_tok / policy.microbatches
    if shape.kind == "train":
        blocks = map_specs(lambda ps, p: _empty(
            local_shape(p.shape, ps, mesh), F32), specs, params)
        state = (p_bytes + _nbytes(make_optimizer(tcfg.optimizer)
                                   .init(blocks))
                 + (_nbytes(blocks) if tcfg.grad_compression else 0)
                 + _sketch_bytes(arch, tcfg) + 4)
        batch = _nbytes(arch.input_specs(shape))      # the global batch
        args, output, alias = state + batch, state, state
    else:
        batch = _nbytes(arch.input_specs(shape, batch_override=rows))
        logits = rows * arch.cfg.vocab_size * torch.empty(
            (), dtype=arch.cfg.adtype).element_size()
        cache = arch.cache_specs(shape, batch_override=shape.global_batch)
        cspecs = sharding_tree_for(
            mesh, arch.cache_pspecs(long_context=long_ctx, rules=rules),
            cache)
        c_bytes = _block_bytes(cache, cspecs, mesh)
        if shape.kind == "prefill":
            args, output, alias = p_bytes + batch, logits + c_bytes, 0
        else:
            args = p_bytes + batch + c_bytes + _nbytes(arch.decode_pos_spec(
                shape, batch_override=rows))
            output, alias = logits + c_bytes, c_bytes
    return {"temp": temp, "temp_is_estimate": True, "args": args,
            "output": output, "alias": alias,
            "peak_estimate": temp + args - alias}


def extrapolate(v1, v2, n: int):
    """A total at ``n`` repeats (superblocks, microbatches) from the runs
    at one and two: the reference's outside + n·body with body = v2 − v1,
    unclamped.  A negative body means the program does not repeat one
    part, and raises."""
    if v2 < v1:
        raise ValueError(f"probe body is negative ({v1} at one repeat, "
                         f"{v2} at two)")
    return v1 + (n - 1) * (v2 - v1)


def extrapolate_tally(t1: dict, t2: dict, n: int) -> dict:
    """``extrapolate`` of two collective tallies, kind by kind (bytes and
    calls) and axis by axis."""
    out = {}
    for kind in sorted(set(t1) | set(t2)):
        a, b = t1.get(kind, {}), t2.get(kind, {})
        if kind == "by_axis":
            out[kind] = {ax: extrapolate(a.get(ax, 0), b.get(ax, 0), n)
                         for ax in sorted(set(a) | set(b))}
        elif isinstance(a, dict) or isinstance(b, dict):
            out[kind] = {f: extrapolate(a.get(f, 0), b.get(f, 0), n)
                         for f in ("bytes", "count")}
        else:
            out[kind] = extrapolate(a or 0, b or 0, n)
    return out


def probe_costs(arch: Arch, shape, mesh, rules, long_ctx: bool,
                rows: int, tcfg, policy: CellPolicy) -> dict:
    """The cell's totals from its probes at one and two superblocks (each
    at the cell's length, or fitted from ``seq_probes``' three),
    extrapolated to the model's depth: {flops, bytes_accessed,
    collectives, probe_depth1, probe_depth2}, the reference's dict."""
    lengths = seq_probes(arch, shape, max(rows // policy.microbatches, 1)
                         if shape.kind == "train" else rows, tcfg)
    probes, colls = [], []
    for depth in (1, 2):
        at = []
        for L in lengths or (shape.seq_len,):
            sh = dataclasses.replace(shape, seq_len=L)
            at.append(cell_costs(_probe(arch, sh, depth), sh, mesh, rules,
                                 long_ctx, rows, tcfg))
        flops, nbytes, coll = zip(*at)
        if any(c != coll[0] for c in coll):
            raise ValueError("the collectives vary with the sequence "
                             "length; the probes cannot extrapolate")
        if lengths:
            flops = [_fit(lengths, flops, shape.seq_len)]
            nbytes = [_fit(lengths, nbytes, shape.seq_len)]
        probes.append({"flops": flops[0], "bytes": nbytes[0],
                       "seq_lens": list(lengths or (shape.seq_len,))})
        colls.append(coll[0])
    n_sb = arch.cfg.num_layers // max(len(arch.cfg.block_pattern), 1)
    f1, f2 = probes
    return {"flops": extrapolate(f1["flops"], f2["flops"], n_sb),
            "bytes_accessed": extrapolate(f1["bytes"], f2["bytes"], n_sb),
            "collectives": extrapolate_tally(*colls, n_sb),
            "probe_depth1": f1, "probe_depth2": f2}


def dry_run(arch: Arch, shape: ShapeSpec, mesh, *, policy=None,
            long_ctx: bool = False, tcfg=None, name: str | None = None
            ) -> CellResult:
    """One cell: ``arch`` as configured (its ``cfg.param_dtype`` included)
    at ``shape`` on ``mesh`` (a ``MeshShape`` or anything ``axis_sizes``
    reads) under ``policy`` (``cell_policy``'s by default) and, for a
    train cell, ``tcfg`` (the policy's ``TrainConfig`` by default).
    Failures are reported in the result, not raised; the active logical
    rules are the cell's while it runs and put back after."""
    sizes = axis_sizes(mesh)
    mesh_name = "x".join(str(s) for s in sizes.values())
    rules = rules_for(mesh, long_context=long_ctx)
    before = get_rules()
    set_rules(rules)
    policy = policy or cell_policy(arch, shape, mesh)
    t0 = time.time()
    res = CellResult(arch=name or arch.name, shape=shape.name,
                     mesh=mesh_name, ok=False, seconds=0.0, mesh_axes=sizes)
    try:
        if shape.kind == "train":
            tcfg = _train_tcfg(arch, policy, tcfg)
        specs = _param_specs(arch, mesh, rules)
        rows = _local_rows(shape.global_batch, mesh, rules, long_ctx)
        memory = _memory(arch, shape, mesh, rules, long_ctx, policy, specs,
                         rows, tcfg)
        corrected = probe_costs(arch, shape, mesh, rules, long_ctx, rows,
                                tcfg, policy)
        flops, nbytes = corrected["flops"], corrected["bytes_accessed"]
        coll = corrected["collectives"]
        res = dataclasses.replace(
            res, ok=True, memory=memory, flops=flops, bytes_accessed=nbytes,
            collectives=coll, params=arch.param_count(),
            active_params=arch.active_param_count(),
            policy=dataclasses.asdict(policy),
            corrected=corrected)
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        res.error = (f"{type(e).__name__}: {e}\n"
                     f"{traceback.format_exc(limit=6)}")
    finally:
        set_rules(before)
    res.seconds = round(time.time() - t0, 1)
    gc.collect()
    return res


def run_cell(arch_name: str, shape_name: str, multi_pod: bool) -> CellResult:
    """The production cell (arch × shape) on the 16×16 or the 2×16×16
    mesh; serving cells in bf16 weights."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    shape = SHAPES[shape_name]
    arch = Arch(arch_name)
    if shape.kind != "train":
        # serving runs in bf16 weights (production inference convention)
        arch.cfg = dataclasses.replace(arch.cfg, param_dtype="bfloat16")
    return dry_run(arch, shape, mesh, long_ctx=shape_name == "long_500k",
                   name=arch_name)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="dryrun_results")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    cells = all_cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    for arch_name, shape_name in cells:
        for mp in meshes:
            tag = f"{arch_name}__{shape_name}__{'2x16x16' if mp else '16x16'}"
            path = f"{args.out}/{tag}.json"
            if os.path.exists(path) and not args.force:
                print(f"[skip existing] {tag}", flush=True)
                continue
            print(f"[dryrun] {tag} ...", flush=True)
            res = run_cell(arch_name, shape_name, mp)
            with open(path, "w") as f:
                json.dump(dataclasses.asdict(res), f, indent=1)
            status = ("OK" if res.ok
                      else "FAIL: " + res.error.splitlines()[0])
            print(f"[dryrun] {tag}: {status} ({res.seconds}s)", flush=True)


if __name__ == "__main__":
    main()
