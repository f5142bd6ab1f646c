"""ZeRO-2 training over a ``torch.distributed`` mesh: the port of the
reference's ``make_train_step(grad_pspecs=…, sketch_layout=…)`` under a
mesh (``repro.train.train_loop``).

The reference states the layout as PartitionSpecs and lets GSPMD insert
the collectives; here every rank runs them explicitly
(``repro_torch.dist.collectives``):

* parameters and optimiser state are held as this rank's blocks of the
  ``grad_pspecs`` layout (``shard_train_state``: the model axes of the
  logical rules plus FSDP's data axis, ``dist.mesh.fsdp_tree``).  The
  port holds each block as a plain tensor beside its spec rather than as
  a ``DTensor``: a ``DTensor`` redistributes through PyTorch's functional
  collectives, which would bypass ``collectives``' tally;
* each step gathers every leaf whole once, before the forward (ZeRO-2:
  the optimiser state and the gradients stay sharded, the parameters are
  whole during compute), and runs the layers whole: tensor-parallel
  layers (split heads with an all-reduce inside attention) give the same
  numbers and the same per-rank parameter bytes;
* the batch splits over the batch axes (``pod``, ``data``); every rank
  sees the global batch for the data filter, whose sketch then updates as
  on one card, and takes its rows of each microbatch for the loss.  Each
  rank's loss is weighted by its share of the global microbatch's loss
  terms (max(c_r, 1) / max(C, 1)), so the summed gradient is the global
  mean's (an MoE's load-balance term is averaged over the shards, where
  the reference takes it over the whole batch);
* gradients are reduce-scattered over the batch axes onto the layout
  (all-reduced where a leaf is whole on a batch axis), sliced on the
  model axes, clipped by the norm summed over the ranks, fed to the
  int8-compressed with error feedback (``train.compression``: each
  leaf's scale all-reduced (max), the whole leaf's noise drawn on every
  rank), fed to the gradient monitor through their per-leaf squared
  norms, and applied to the local blocks by the optimiser (Sgd and AdamW
  elementwise; Adafactor all-reduces its factored means and its update
  clip's Σu² over the axes that split a leaf, ``train.optim``);
* ``sketch_layout`` places the data filter's and the gradient monitor's
  sketches (``ShardedSketch``); None keeps them whole on every rank, on
  the single-card kernels.  With ``filter_chunk > 1`` the filter runs
  outside the step, as ``train``'s chunked prefilter;
* ``state_specs`` lays out a whole ``TrainState``: ``gather_state``
  gathers it whole for a checkpoint (saved from rank 0 in the unsharded
  format, so any world size restores it) and ``train.checkpoint.restore
  (specs=, mesh=)`` takes each rank's blocks back.

``step_on_meta`` runs the same step on ``meta`` against a shape-only
mesh: its collectives are tallied and not run, so a live step's
``collectives.TALLY`` equals them by construction, and the dry run
(``launch.dryrun``) counts its flops and bytes there too.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from repro_torch import resolve_device
from repro_torch.dist import collectives as col
from repro_torch.dist.mesh import (MeshShape, P, axis_names, axis_sizes,
                                   dim_axes, is_spec, local_block,
                                   local_shape, map_specs)
from repro_torch.dist.sketch_parallel import ShardedSketch, gather_block
from repro_torch.models.convert import reference_leaves
from repro_torch.models.registry import is_whisper, leaves, unflatten
from repro_torch.train.compression import (compress_grads_with_ef,
                                           decompress_grads)
from repro_torch.train.optim import make_optimizer
from repro_torch.train.schedule import CosineSchedule, scalar_div
from repro_torch.window import ring

F32 = torch.float32


def replicated_specs(arch):
    """Every parameter whole on every rank (the spec tree's structure)."""
    return map_specs(lambda ps: P(), arch.param_pspecs(rules={}))


def batch_axes(mesh) -> tuple:
    """The axes the batch splits over, major first."""
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))


def _batch_index(mesh) -> tuple[int, int]:
    """(this rank's batch shard, number of batch shards)."""
    sizes = axis_sizes(mesh)
    index, count = 0, 1
    for a in batch_axes(mesh):
        index = index * sizes[a] + (mesh.get_local_rank(a)
                                    if sizes[a] > 1 else 0)
        count *= sizes[a]
    return index, count


def spec_leaves(specs) -> list:
    out = []
    map_specs(out.append, specs)
    return out


def replication(ps, mesh) -> int:
    """How many ranks hold the same block of a leaf of spec ``ps``."""
    sizes = axis_sizes(mesh)
    used = {a for entry in ps for a in dim_axes(entry)}
    return math.prod(n for a, n in sizes.items() if a not in used)


def sketch_shards(tcfg, arch, mesh, sketch_layout, table_axis="model"):
    """(filter shard, monitor shard) of ``sketch_layout``, None for a
    sketch that stays whole."""
    from repro_torch.train.fault import GradMonitor
    from repro_torch.train.train_loop import make_data_filter
    if sketch_layout is None:
        return None, None
    fsh = msh = None
    if tcfg.use_data_filter:
        filt = make_data_filter(tcfg, arch.cfg.d_model)
        windowed = getattr(filt, "num_epochs", 1) > 1
        fsh = ShardedSketch(filt.ace_cfg, mesh, sketch_layout,
                            kind="window" if windowed else "flat",
                            table_axis=table_axis,
                            num_epochs=getattr(filt, "num_epochs", 1),
                            quantile=filt.threshold_mode == "quantile")
    if tcfg.use_grad_monitor:
        gm = GradMonitor(feature_dim=tcfg.monitor_feature_dim,
                         device=resolve_device(tcfg.device))
        msh = ShardedSketch(gm.ace_cfg, mesh, sketch_layout,
                            table_axis=table_axis)
    return fsh, msh


def shard_train_state(state, arch, tcfg, mesh, param_pspecs,
                      sketch_layout: str | None = None):
    """This rank's blocks of a whole ``TrainState``: parameters under
    ``param_pspecs``, the optimiser state under its ``state_pspecs``, the
    error feedback under the parameters' specs, the sketches under
    ``sketch_layout``; the projections broadcast from rank 0."""
    specs = state_specs(state, arch, tcfg, mesh, param_pspecs, sketch_layout)
    placed = map_specs(lambda ps, t: local_block(t, ps, mesh), specs,
                       state._replace(rng=state.rng.get_state()))
    for w in (state.filter_w, state.monitor_w):
        if w is not None:
            col.broadcast(w)
    return state._replace(**{f: getattr(placed, f) for f in
                             ("params", "opt_state", "filter_state",
                              "monitor", "ef")})


def reconcile(spec, tree):
    """``spec`` with ``tree``'s structure: a spec (or None, whole) given for
    a subtree covers each of its tensors; dicts follow ``tree``'s keys
    (the reference's ``state_pspecs`` gives every Adafactor slot key, a
    slot holds some)."""
    if tree is None:
        return None
    if spec is None or is_spec(spec):
        if isinstance(tree, torch.Tensor):
            return P() if spec is None else spec
        spec = spec or P()
        if isinstance(tree, dict):
            return {k: reconcile(spec, v) for k, v in tree.items()}
        out = [reconcile(spec, v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    if isinstance(tree, dict):
        return {k: reconcile(spec[k], v) for k, v in tree.items()}
    out = [reconcile(a, b) for a, b in zip(spec, tree)]
    return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)


def state_specs(state, arch, tcfg, mesh, param_pspecs,
                sketch_layout: str | None = None):
    """The spec of every tensor of a ``TrainState`` (its structure, the
    generator as its state bytes, whole): parameters, optimiser state and
    error feedback by ``param_pspecs``, the sketches by
    ``sketch_layout``, the rest whole."""
    fsh, msh = sketch_shards(tcfg, arch, mesh, sketch_layout)
    mon = None
    if state.monitor is not None:
        mon = type(state.monitor)(*(
            msh.specs if (f == "ace" and msh is not None) else None
            for f in state.monitor._fields))
    spec = state._replace(
        params=param_pspecs,
        opt_state=make_optimizer(tcfg.optimizer).state_pspecs(param_pspecs),
        step=None, monitor=mon, monitor_w=None,
        filter_state=None if fsh is None else fsh.specs, filter_w=None,
        ef=None if state.ef is None else type(state.ef)(param_pspecs),
        rng=None)
    tree = state._replace(rng=state.rng.get_state()) \
        if isinstance(state.rng, torch.Generator) else state
    return reconcile(spec, tree)


def gather_state(state, specs, mesh):
    """The whole ``TrainState`` (every rank gets it) of this rank's blocks,
    its generator as its state bytes: a checkpoint's tree."""
    tree = state._replace(rng=state.rng.get_state())
    return map_specs(lambda ps, t: gather_block(t, ps, mesh), specs, tree)


def gather_params(params, specs, mesh):
    """Every leaf whole, from this rank's blocks."""
    return map_specs(lambda ps, p: gather_block(p, ps, mesh), specs, params)


def reduce_grad(g: torch.Tensor, ps, mesh) -> torch.Tensor:
    """A whole local gradient -> this rank's block of the global one: a
    reduce-scatter over each batch axis the spec splits (major first), a
    slice on each model axis, an all-reduce over each batch axis it does
    not split."""
    sizes, baxes = axis_sizes(mesh), batch_axes(mesh)
    used = set()
    for i, entry in enumerate(ps):
        for a in dim_axes(entry):
            used.add(a)
            if sizes[a] == 1:
                continue
            if a in baxes:
                g = col.reduce_scatter(g, mesh, a, dim=i)
            else:
                g = torch.chunk(g, sizes[a], dim=i)[mesh.get_local_rank(a)]
    g = g.contiguous()
    for a in baxes:
        if a not in used:
            col.all_reduce(g, mesh, a)
    return g


def make_sharded_train_step(arch, tcfg, grad_pspecs, sketch_layout, mesh):
    """``(state, batch) -> (state, metrics)`` on this rank's blocks (the
    module docstring); ``batch`` is the global batch, the same on every
    rank."""
    from repro_torch.train.fault import GradMonitor
    from repro_torch.train.train_loop import (make_data_filter,
                                              sequence_embeddings)
    cfg = arch.cfg
    device = resolve_device(tcfg.device)
    opt = make_optimizer(tcfg.optimizer)
    sched = CosineSchedule(peak_lr=tcfg.peak_lr,
                           warmup_steps=tcfg.warmup_steps,
                           total_steps=tcfg.total_steps)
    gm = GradMonitor(feature_dim=tcfg.monitor_feature_dim, device=device) \
        if tcfg.use_grad_monitor else None
    filt = make_data_filter(tcfg, cfg.d_model) \
        if tcfg.use_data_filter and tcfg.filter_chunk <= 1 else None
    fsh, msh = sketch_shards(tcfg, arch, mesh, sketch_layout)
    okw = dict(mesh=mesh, specs=grad_pspecs) \
        if tcfg.optimizer == "adafactor" else {}
    specs = grad_pspecs
    reps = [replication(ps, mesh) for ps in spec_leaves(specs)]
    all_axes = axis_names(mesh)
    baxes = batch_axes(mesh)
    bi, nb = _batch_index(mesh)
    uses_mask = not is_whisper(cfg)     # whisper's loss reads no mask

    def loss_and_grads(params, batch):
        flat = [p.detach().requires_grad_() for p in leaves(params)]
        loss, _ = arch.loss(unflatten(params, flat), batch, remat=tcfg.remat,
                            remat_policy=tcfg.remat_policy)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(flat, grads)]

    def filter_batch(state, full, batch, metrics):
        mask = batch.get("mask", torch.ones(batch["labels"].shape,
                                            dtype=F32, device=device))
        with torch.no_grad():
            feats = filt.features(sequence_embeddings(full, batch, cfg))
        fs, keep, _ = filt.step(state.filter_state, state.filter_w, feats,
                                shard=fsh)
        if getattr(filt, "num_epochs", 1) > 1:
            fs = (fsh or ring).maybe_rotate(fs, filt.rotate_every,
                                            filt.decay)
        metrics["filter_keep_frac"] = torch.mean(keep.to(F32))
        return fs, dict(batch, mask=mask * keep[:, None].to(mask.dtype))

    def local_parts(batch):
        """This rank's rows of each microbatch, and its loss weights."""
        mb = tcfg.microbatches
        parts = []
        for j in range(mb):
            part = {}
            for k, v in batch.items():
                if v.ndim < 1:
                    continue
                dim = 1 if k == "positions" else 0
                part[k] = torch.chunk(torch.chunk(v, mb, dim=dim)[j], nb,
                                      dim=dim)[bi]
            parts.append(part)
        if uses_mask and "mask" in batch:
            c = torch.stack([torch.sum(p["mask"][:, 1:].to(F32))
                             for p in parts])
        else:
            c = torch.tensor([float(p["labels"][:, 1:].numel())
                              for p in parts], device=device)
        total = col.all_reduce(c.clone(), mesh, baxes)
        return parts, torch.clamp_min(c, 1.0) / torch.clamp_min(total, 1.0)

    def leaf_sq(grads):
        """The squared norm of every leaf, each block counted once."""
        return col.all_reduce(torch.stack(
            [torch.sum(g * g) / r for g, r in zip(grads, reps)]), mesh,
            all_axes)

    def train_step(state, batch):
        metrics = {}
        full = gather_params(state.params, specs, mesh)   # gathered at use
        filter_state = state.filter_state
        if filt is not None:
            filter_state, batch = filter_batch(state, full, batch, metrics)
        parts, wts = local_parts(batch)
        mb = len(parts)
        loss, grads = None, None
        for j, part in enumerate(parts):
            l_j, g_j = loss_and_grads(full, part)
            l_j = scalar_div(l_j.to(F32) * wts[j], mb)
            loss = l_j if loss is None else loss + l_j
            g_j = [scalar_div(g.to(F32) * wts[j], mb) for g in g_j]
            grads = g_j if grads is None else [a.add_(g) for a, g
                                               in zip(grads, g_j)]
        del full
        loss = col.all_reduce(loss, mesh, baxes)
        grads = [reduce_grad(g, ps, mesh)
                 for g, ps in zip(grads, spec_leaves(specs))]
        sq = leaf_sq(grads)
        gnorm = torch.sqrt(torch.sum(sq))
        scale = torch.clamp_max(torch.full_like(gnorm, tcfg.grad_clip)
                                / (gnorm + 1e-9), 1.0)
        grads = [g * scale for g in grads]
        sq = sq * scale * scale
        metrics["loss"] = loss
        metrics["grad_norm"] = gnorm
        gtree = unflatten(state.params, grads)
        ef = state.ef
        if tcfg.grad_compression:
            q, scales, ef = compress_grads_with_ef(gtree, ef, state.rng,
                                                   mesh, specs)
            gtree = decompress_grads(q, scales)
            del q
            grads = list(leaves(gtree))
            sq = leaf_sq(grads)             # the monitor's, as on one card

        monitor = state.monitor
        lr = sched(state.step)
        metrics["lr"] = lr
        skip = None
        if gm is not None:
            index = {id(g): i for i, g in enumerate(grads)}
            groups = reference_leaves(gtree)[: gm.feature_dim - 1]
            sq_parts = torch.stack([sq[index[id(p)]] for leaf in groups
                                    for p in leaf.parts])
            feat = gm.features_from_sq(sq_parts, groups, loss)[None]
            monitor, skip, score = gm.step_features(
                state.monitor, state.monitor_w, feat, shard=msh)
            metrics["grad_anomaly"] = skip.to(F32)
            metrics["grad_score"] = score
            metrics["rollback_needed"] = gm.rollback_needed(monitor).to(F32)
        new_params, new_opt = opt.update(state.params, gtree,
                                         state.opt_state, state.step, lr,
                                         skip=skip, **okw)
        return state._replace(params=new_params, opt_state=new_opt,
                              step=state.step + 1, monitor=monitor,
                              filter_state=filter_state, ef=ef), metrics

    return train_step


def abstract_train_state(arch, tcfg, grad_pspecs, sketch_layout, mesh):
    """Rank 0's blocks of a ``TrainState`` on ``meta`` (nothing allocated):
    parameter, optimiser and error-feedback blocks by ``grad_pspecs``, the
    sketches whole or placed by ``sketch_layout``; ``rng`` an unused CPU
    generator (compression draws nothing on ``meta``)."""
    from repro_torch.train.fault import GradMonitor
    from repro_torch.train.train_loop import TrainState, make_data_filter
    from repro_torch.train.compression import init_error_feedback
    meta = torch.device("meta")
    params = map_specs(lambda ps, p: torch.empty(
        local_shape(p.shape, ps, mesh), dtype=p.dtype, device=meta),
        grad_pspecs, arch.abstract_params()[0])
    fsh, msh = sketch_shards(tcfg, arch, mesh, sketch_layout)
    mon = mon_w = fs = fw = None
    if tcfg.use_grad_monitor:
        mon, mon_w = GradMonitor(feature_dim=tcfg.monitor_feature_dim,
                                 device=meta).init()
        if msh is not None:
            mon = mon._replace(ace=msh.place(mon.ace))
    if tcfg.use_data_filter:
        fs, fw = make_data_filter(tcfg, arch.cfg.d_model).init()
        if fsh is not None:
            fs = fsh.place(fs)
    return TrainState(
        params=params,
        opt_state=make_optimizer(tcfg.optimizer).init(params),
        step=torch.zeros((), dtype=torch.int32, device=meta), monitor=mon,
        monitor_w=mon_w, filter_state=fs, filter_w=fw,
        ef=init_error_feedback(params) if tcfg.grad_compression else None,
        rng=torch.Generator())


def step_on_meta(arch, tcfg, grad_pspecs, sketch_layout, mesh, batch,
                 count=None) -> dict:
    """One ``make_sharded_train_step`` step of rank 0 on ``meta``, against
    ``mesh``'s shape: the program itself, its collectives tallied and not
    run (``dist.collectives`` over a ``MeshShape``), the sketches' kernels
    in their plain versions on shapes (``kernels.build.plain_on_meta``).
    ``batch`` is the global batch as ``meta`` tensors; ``count`` a context
    manager entered around the step alone (the dry run's cost counters).
    Returns the step's collectives (``collectives.TALLY.snapshot()``):
    a live step's tally on every rank equals it."""
    from repro_torch.kernels import build
    shape = mesh if isinstance(mesh, MeshShape) else MeshShape(
        tuple(axis_sizes(mesh).values()), axis_names(mesh))
    tcfg = dataclasses.replace(tcfg, device="meta")
    state = abstract_train_state(arch, tcfg, grad_pspecs, sketch_layout,
                                 shape)
    step = make_sharded_train_step(arch, tcfg, grad_pspecs, sketch_layout,
                                   shape)
    with build.plain_on_meta(), col.tallied() as tally, \
            (count or contextlib.nullcontext()):
        step(state, batch)
    return tally.snapshot()
