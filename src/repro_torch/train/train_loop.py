"""The training step and loop — port of ``repro.train.train_loop``:
microbatch accumulation, remat, mixed precision, the ACE data filter and
the ACE gradient monitor in the step, optional int8 error-feedback
compression, checkpoint/restart and monitor-tripped rollback.

Everything that changes lives in one ``TrainState``; ``make_train_step``
builds ``(state, batch) -> (state, metrics)``, whose metrics stay on the
device.  ``train`` is the host loop: it moves each batch to the device
in one transfer (``_to_device``), runs the step, and moves the step's
metrics back in one transfer (``_to_host``, a float32 vector), so a step
makes one device-to-host copy and no other sync (the reference pulls each
metric with ``float(v)``).  The step counter is kept on the host as a
Python int beside ``state.step``, the device scalar the schedule and the
optimiser read.

What differs from the reference, and why:
* the gradients are PyTorch autograd through plain torch, as the
  reference's are ``jax.grad`` through plain jnp (no kernel has a
  backward pass), taken with respect to detached views of the parameters
  that require grad; the stored parameters never do;
* the optimiser updates the parameters and moments in place, leaf by
  leaf (``train.optim``), and the monitor's skip is its ``skip`` operand:
  a per-leaf ``torch.where`` with no host sync.  The monitor decides
  before the update, on the same gradients and loss the reference's
  decides on after it;
* ``TrainState.rng`` is a ``torch.Generator`` on the device, drawn from
  only for the compression noise; its state (``get_state()``) rides in
  the checkpoint, so a restart with compression on is exact;
* a checkpoint holds the port's own tree (parameters per layer, the
  ``TrainState`` fields by name, the generator's state as a byte tensor):
  ``train.checkpoint``'s format, but not a tree the reference's
  ``train`` can restore, nor one this one can take from it;
* the filter's and monitor's sketches run on the port's kernels
  (``ace_admit_fused`` + ``ace_query_sum`` a flat filter step, the
  window kernels' path a windowed one, ``srp_hash`` + ``ace_query_sum``
  + ``ace_update`` + ``ace_query_sum`` a monitor step), which write their
  counts in place: the state passed to a step shares its sketch tensors
  with the state it returns.
``make_train_step(grad_pspecs=…, sketch_layout=…, mesh=…)`` and
``train(mesh=…)`` train ZeRO-2 over the ranks of a ``torch.distributed``
mesh (``train.sharded``), uncaptured (a mesh's collectives stage through
the host); on one device ``train`` runs the step, the chunk features and
the tail step as captured programs (``core.capture``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import capture
from repro_torch.data.pipeline import AceDataFilter, DataStream
from repro_torch.models.registry import Arch, leaves, tree_map, unflatten
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.compression import (EfState, compress_grads_with_ef,
                                           decompress_grads,
                                           init_error_feedback)
from repro_torch.train.fault import GradMonitor, MonitorState, StepTimer
from repro_torch.train.optim import clip_by_global_norm, make_optimizer
from repro_torch.train.schedule import CosineSchedule, scalar_div

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    microbatches: int = 1            # grad accumulation
    remat: bool = True
    remat_policy: str = "full"   # "dots": save matmul outs
    use_data_filter: bool = True     # ACE filter on sequence embeddings
    filter_chunk: int = 0            # T>1: run the data filter through
                                     # StreamRunner once per T batches
                                     # instead of per batch in the step
    filter_window_epochs: int = 1    # >1: sliding-window filter (an
                                     # epoch ring whose threshold tracks
                                     # stream drift)
    filter_window_decay: float = 1.0  # γ epoch decay (1.0 = hard window)
    filter_rotate_every: int = 0     # filter steps (batches) per epoch
    filter_threshold_mode: str = "mu_sigma"  # "mu_sigma" | "quantile":
                                     # quantile mode pins the filter's
                                     # flag rate at filter_quantile_q
    filter_quantile_q: float = 0.01  # target flag rate for quantile mode
    use_grad_monitor: bool = True    # ACE monitor on gradient stats
    grad_compression: bool = False   # int8 + error feedback
    monitor_feature_dim: int = 32
    ckpt_dir: str | None = None
    ckpt_interval: int = 200
    step_slo_seconds: float = 120.0  # host straggler SLO (StepTimer);
                                     # breaches ride the metrics stream
    max_rollbacks: int = 3           # bounded monitor-tripped rollbacks
                                     # per train() call (0 disables)
    rollback_backoff: float = 0.0    # seconds slept before the k-th
                                     # rollback (linear: k × backoff)
    seed: int = 0
    device: str | None = None        # CUDA unless "cpu" (the port's)


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor               # () int32 on the device
    monitor: MonitorState | None
    monitor_w: torch.Tensor | None
    filter_state: Any | None
    filter_w: torch.Tensor | None
    ef: EfState | None
    rng: torch.Generator


def make_data_filter(tcfg: TrainConfig, d_model: int):
    """The one place the train stack decides flat against windowed
    filtering: ``filter_window_epochs > 1`` takes the epoch-ring
    ``WindowedAceFilter`` (and needs ``filter_rotate_every > 0``: with no
    clock the ring never expires), else the flat ``AceDataFilter``.
    Every consumer (``init_train_state``, the in-step path, the chunked
    prefilter, its tail) builds through here."""
    device = resolve_device(tcfg.device)
    if tcfg.filter_window_epochs > 1:
        if tcfg.filter_rotate_every <= 0:
            raise ValueError(
                "filter_window_epochs > 1 needs filter_rotate_every > 0 "
                "— without a rotation clock the ring never expires and "
                "behaves like the frozen sketch")
        from repro_torch.window.filter import WindowedAceFilter
        return WindowedAceFilter(
            d_model=d_model, num_epochs=tcfg.filter_window_epochs,
            decay=tcfg.filter_window_decay,
            rotate_every=tcfg.filter_rotate_every,
            threshold_mode=tcfg.filter_threshold_mode,
            quantile_q=tcfg.filter_quantile_q, device=device)
    return AceDataFilter(d_model=d_model,
                         threshold_mode=tcfg.filter_threshold_mode,
                         quantile_q=tcfg.filter_quantile_q, device=device)


def init_train_state(arch: Arch, tcfg: TrainConfig,
                     generator: torch.Generator | int | None = None
                     ) -> TrainState:
    """Parameters drawn from ``generator`` (a generator on the run's
    device, or a seed; ``tcfg.seed`` when None), zero optimiser state and
    fresh sketches on ``tcfg.device``; ``rng`` a generator there seeded
    with ``tcfg.seed``."""
    device = resolve_device(tcfg.device)
    params = arch.init_params(tcfg.seed if generator is None else generator,
                              device=device)
    opt_state = make_optimizer(tcfg.optimizer).init(params)
    mon = mon_w = fs = fw = ef = None
    if tcfg.use_grad_monitor:
        mon, mon_w = GradMonitor(feature_dim=tcfg.monitor_feature_dim,
                                 device=device).init()
    if tcfg.use_data_filter:
        fs, fw = make_data_filter(tcfg, arch.cfg.d_model).init()
    if tcfg.grad_compression:
        ef = init_error_feedback(params)
    return TrainState(params=params, opt_state=opt_state,
                      step=torch.zeros((), dtype=torch.int32, device=device),
                      monitor=mon, monitor_w=mon_w,
                      filter_state=fs, filter_w=fw, ef=ef,
                      rng=torch.Generator(device=device).manual_seed(
                          tcfg.seed))


def filter_stride(seq_len: int) -> int:
    """The stride of the tokens the data filter scores: S // 256, at least
    1 (every token up to S = 511)."""
    return max(seq_len // 256, 1)


def filter_tokens(seq_len: int) -> int:
    """How many tokens of a sequence the data filter scores."""
    return len(range(0, seq_len, filter_stride(seq_len)))


def sequence_embeddings(params, batch, cfg):
    """The embeddings the data filter scores, shared by the in-step filter
    and the chunked prefilter: ``batch["embeds"]``, or the token
    embeddings of about 256 tokens a sequence (``filter_stride``) in the
    activation dtype, gathered before the cast (the same values as the
    reference's cast-then-gather, without a cast of the whole table)."""
    if "embeds" in batch:
        return batch["embeds"]
    toks = batch["tokens"]
    stride = filter_stride(toks.shape[1])
    return params["embed"][toks[:, ::stride].long()].to(cfg.adtype)


def make_train_step(arch: Arch, tcfg: TrainConfig, grad_pspecs=None,
                    sketch_layout: str | None = None, mesh=None):
    """Builds the train step ``(state, batch) -> (state, metrics)``; batch
    and metrics are dicts of tensors on the device.

    With ``filter_chunk > 1`` the filter runs outside the step (``train``
    runs it once a chunk through ``StreamRunner``); the step then takes
    the batches already masked.

    ``grad_pspecs`` (a PartitionSpec tree of the parameters' structure)
    and ``sketch_layout`` ("replicated" or "table_sharded") train over
    the ranks of ``mesh``, a live ``DeviceMesh`` (the reference's ambient
    mesh), on a state of this rank's blocks (``train.sharded``: ZeRO-2,
    the gradients reduce-scattered onto ``grad_pspecs``, which is also
    the parameters' and the optimiser state's layout)."""
    if grad_pspecs is not None or sketch_layout is not None \
            or mesh is not None:
        from repro_torch.train import sharded
        if mesh is None:
            raise ValueError("grad_pspecs / sketch_layout shard over a "
                             "mesh: pass mesh=")
        if grad_pspecs is None:
            grad_pspecs = sharded.replicated_specs(arch)
        return sharded.make_sharded_train_step(arch, tcfg, grad_pspecs,
                                               sketch_layout, mesh)
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

    def loss_and_grads(params, batch):
        flat = [p.detach().requires_grad_() for p in leaves(params)]
        loss, aux = arch.loss(unflatten(params, flat), batch,
                              remat=tcfg.remat,
                              remat_policy=tcfg.remat_policy)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        return loss.detach(), unflatten(params, grads)

    def train_step(state: TrainState, batch):
        metrics = {}
        params = state.params

        # ---- ACE data filter: score sequence embeddings, mask anomalies
        filter_state = state.filter_state
        if filt is not None:
            mask = batch.get("mask", torch.ones(batch["labels"].shape,
                                                dtype=F32, device=device))
            with torch.no_grad():
                embeds = sequence_embeddings(params, batch, cfg)
            filter_state, new_mask, kept = filt(
                state.filter_state, state.filter_w, embeds, mask)
            batch = dict(batch, mask=new_mask)
            metrics["filter_keep_frac"] = kept

        # ---- grads (with optional microbatch accumulation, in the
        # reference's order: carry + g.float() / mb)
        if tcfg.microbatches > 1:
            mb = tcfg.microbatches
            # M-RoPE positions (3, B, S) split on their batch axis, 1
            parts = {k: torch.chunk(v, mb, dim=1 if k == "positions" else 0)
                     for k, v in batch.items() if v.ndim >= 1}
            loss = grads = None
            for j in range(mb):
                l_j, g_j = loss_and_grads(
                    params, {k: v[j] for k, v in parts.items()})
                l_j = scalar_div(l_j.to(F32), mb)
                loss = l_j if loss is None else loss + l_j
                if grads is None:
                    grads = tree_map(lambda g: scalar_div(g.to(F32), mb),
                                     g_j)
                else:
                    for a, g in zip(leaves(grads), leaves(g_j)):
                        a.add_(scalar_div(g.to(F32), mb))
                del g_j
        else:
            loss, grads = loss_and_grads(params, batch)

        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        metrics["loss"] = loss
        metrics["grad_norm"] = gnorm

        # ---- optional int8 error-feedback compression
        ef = state.ef
        if tcfg.grad_compression:
            q, scales, ef = compress_grads_with_ef(grads, ef, state.rng)
            grads = decompress_grads(q, scales)
            del q

        # ---- ACE gradient monitor: skip anomalous updates
        monitor = state.monitor
        lr = sched(state.step)
        metrics["lr"] = lr
        skip = None
        if gm is not None:
            monitor, skip, score = gm.step(state.monitor, state.monitor_w,
                                           grads, loss)
            metrics["grad_anomaly"] = skip.to(F32)
            metrics["grad_score"] = score
            # rides the step's one metrics transfer: the rollback
            # decision costs the host loop no extra sync
            metrics["rollback_needed"] = gm.rollback_needed(monitor).to(F32)
        new_params, new_opt = opt.update(params, grads, state.opt_state,
                                         state.step, lr, skip=skip)
        new_state = TrainState(
            params=new_params, opt_state=new_opt, step=state.step + 1,
            monitor=monitor, monitor_w=state.monitor_w,
            filter_state=filter_state, filter_w=state.filter_w,
            ef=ef, rng=state.rng)
        return new_state, metrics

    return train_step


def _to_device(batch: dict, device: torch.device) -> dict:
    """The ONE host-to-device transfer of a batch: its arrays packed into
    one byte buffer (each at a 16-byte offset), moved, and viewed back
    as tensors (a named function, so tests can count it)."""
    arrays = {k: np.ascontiguousarray(v) for k, v in batch.items()}
    offs, total = {}, 0
    for k, v in arrays.items():
        offs[k] = total
        total += -(-v.nbytes // 16) * 16
    host = np.zeros(max(total, 16), np.uint8)
    for k, v in arrays.items():
        host[offs[k]:offs[k] + v.nbytes] = v.reshape(-1).view(np.uint8)
    dev = torch.as_tensor(host, device=device)
    return {k: dev[offs[k]:offs[k] + v.nbytes]
            .view(torch.from_numpy(v[:0].reshape(-1)).dtype).view(v.shape)
            for k, v in arrays.items()}


def _to_host(x: torch.Tensor) -> np.ndarray:
    """The ONE device-to-host transfer of a step: its packed metrics (a
    named function, so tests can count it)."""
    return x.cpu().numpy()


def _ckpt_tree(state: TrainState) -> TrainState:
    """The state as a checkpoint tree: the generator as its state bytes."""
    return state._replace(rng=state.rng.get_state())


def _restore(mgr, state: TrainState, specs=None, mesh=None):
    """The newest intact checkpoint written into ``state``, with its
    manifest; (None, None) when there is none.  Each leaf is copied into
    the tensor that holds it and the generator's state set, so the step's
    program (whose static buffers and generator these are) replays on
    them with no new key, and the chunk features' graph reads the
    parameters where it was captured on them.  With ``specs`` and a
    ``mesh`` (``sharded.state_specs``) ``state`` holds this rank's
    blocks."""
    restored, manifest = mgr.restore_latest(_ckpt_tree(state), specs, mesh)
    if restored is None:
        return None, None
    with torch.no_grad():
        for dst, src in zip(leaves(state._replace(rng=None)),
                            leaves(restored._replace(rng=None))):
            dst.copy_(src)
    state.rng.set_state(restored.rng)
    return state, manifest


def train(arch: Arch, tcfg: TrainConfig, stream: DataStream,
          num_steps: int, log_every: int = 10,
          state: TrainState | None = None, *, mesh=None, grad_pspecs=None,
          sketch_layout: str | None = None):
    """Host loop: checkpoint/restart, straggler timer, rollback, logging.

    With ``tcfg.filter_chunk = T > 1`` the data filter runs as a chunked
    prefilter: every T batches, their sequence-embedding features (taken
    with the parameters at chunk start) go through one
    ``StreamRunner(return_masks=True).consume`` (hash once a batch,
    masked insert, no host sync), and the (T, B) keep mask is applied to
    the loss masks as the batches feed the filter-free step.  The sketch
    updates in the in-step path's per-batch order.  Steps past the last
    full chunk take the per-batch ``filt.step`` (and, for a ring, its
    rotation clock, so rotations land where a chunk would put them).
    Checkpoints are taken only on chunk-final steps (mid-chunk the sketch
    holds batches no step has trained on), so a restart stays exact; pick
    ``ckpt_interval`` a multiple of ``filter_chunk``.

    On one device the loop compiles once, as the reference jits its three
    programs: the step, the chunk features and the tail step are each a
    ``core.capture.Program`` (one captured CUDA graph a signature on the
    card; ``capture.disabled()`` runs the eager twin).  The step's state
    is donated: its program keeps the tensors it is given (the
    parameters and moments the optimiser writes in place, uncloned) as
    its static buffers, and the state returned is those buffers.  The
    batch is copied into the step's static inputs; the chunk features
    read the parameters where the step keeps them.  A rollback or a
    restore writes the checkpoint into those buffers and the generator
    (``_restore``), so it builds no new program.

    With a ``mesh`` every rank runs this loop on the same stream and
    trains its blocks (``make_train_step``); a ``state`` passed in is then
    already sharded, and rank 0 alone logs.  Every rank runs the chunked
    prefilter on the global batches (its sketch under ``sketch_layout``,
    ``StreamRunner(mesh=…)``), as the in-step filter does.  A checkpoint
    is the state gathered whole (``sharded.gather_state``) and saved by
    rank 0 in the unsharded format, so a run at any world size (one
    process too) restores it; a sharded run restores its blocks
    (``checkpoint.restore(specs=, mesh=)``).

    Returns (final state, list of metric dicts of floats)."""
    from repro_torch.stream.runner import StreamRunner
    from repro_torch.window import ring

    device = resolve_device(tcfg.device)
    logs = True
    sspecs = fsh = None
    if mesh is not None:
        import torch.distributed as dist
        from repro_torch.dist.sketch_parallel import gather_block
        from repro_torch.train import sharded
        if grad_pspecs is None:
            grad_pspecs = sharded.replicated_specs(arch)
        logs = dist.get_rank() == 0
        if state is None:
            state = sharded.shard_train_state(
                init_train_state(arch, tcfg), arch, tcfg, mesh,
                grad_pspecs, sketch_layout)
        sspecs = sharded.state_specs(state, arch, tcfg, mesh, grad_pspecs,
                                     sketch_layout)
        fsh, _ = sharded.sketch_shards(tcfg, arch, mesh, sketch_layout)
    if state is None:
        state = init_train_state(arch, tcfg)
    step_fn = make_train_step(arch, tcfg, grad_pspecs, sketch_layout, mesh)
    if mesh is None:
        # the step's key holds the state it is given (donated, uncloned)
        step_fn = capture.Program(step_fn, device, name="train.step",
                                  donate=True)

    mgr = None
    if tcfg.ckpt_dir:
        mgr = ckpt_lib.CheckpointManager(tcfg.ckpt_dir,
                                         interval=tcfg.ckpt_interval)
        restored, manifest = _restore(mgr, state, sspecs, mesh)
        if restored is not None:
            state = restored
            stream.load_state_dict({"step": manifest["extra"]["data_step"]})
    host_step = int(state.step)

    chunk_T = tcfg.filter_chunk if tcfg.use_data_filter else 0
    filt = runner = None
    if chunk_T > 1:
        filt = make_data_filter(tcfg, arch.cfg.d_model)
        # a windowed filter carries its own rotation clock; the runner
        # inherits it and rotates inside the chunk
        runner = StreamRunner(
            filt, chunk_T=chunk_T, return_masks=True,
            **({} if fsh is None else dict(mesh=mesh,
                                           sketch_layout=sketch_layout)))

    def chunk_features(_, params, stacked):
        """(None, (T, B, d+1) filter features of T stacked batches), in
        one pass (under a mesh the token embeddings gathered whole
        first)."""
        if mesh is not None and "tokens" in stacked:
            params = {"embed": gather_block(params["embed"],
                                            grad_pspecs["embed"], mesh)}
        T, B = next(iter(stacked.values())).shape[:2]
        flat = {k: v.reshape(T * B, *v.shape[2:]) for k, v in stacked.items()}
        with torch.no_grad():
            f = filt.features(sequence_embeddings(params, flat, arch.cfg))
        return None, f.reshape(T, B, f.shape[-1])

    def tail_step(fstate, w, feat):
        """A tail batch past the last full chunk: the runner's per-step
        program, its rotation clock included."""
        fstate, keep, _ = filt.step(fstate, w, feat, shard=fsh)
        if getattr(filt, "num_epochs", 1) > 1:
            fstate = (fsh or ring).maybe_rotate(fstate, filt.rotate_every,
                                                filt.decay)
        return fstate, keep

    if runner is not None and mesh is None:
        # the parameters are read where the step's program keeps them
        chunk_features = capture.Program(chunk_features, device,
                                         name="train.features", adopt=(0,))
        tail_step = capture.Program(tail_step, device, name="train.tail",
                                    consts=(0,))

    def features(params, batches):
        if "embeds" in batches[0]:
            key, params = "embeds", {}
        else:
            key, params = "tokens", {"embed": params["embed"]}
        return chunk_features(None, params, {
            key: torch.stack([b[key] for b in batches])})[1]

    timer = StepTimer(slo_seconds=tcfg.step_slo_seconds)
    history = []
    rollbacks = 0

    def run_step(jbatch, keep=None, saveable=True):
        nonlocal state, rollbacks, host_step
        metrics = {}
        if keep is not None:
            mask = jbatch.get("mask", torch.ones(
                jbatch["labels"].shape, dtype=F32, device=device))
            jbatch = dict(jbatch,
                          mask=mask * keep[:, None].to(mask.dtype))
            metrics["filter_keep_frac"] = torch.mean(keep.to(F32))
        state, step_metrics = step_fn(state, jbatch)
        metrics.update(step_metrics)
        names = list(metrics)
        values = _to_host(torch.stack([metrics[k].to(F32).reshape(())
                                       for k in names]))
        metrics = {k: float(v) for k, v in zip(names, values)}
        host_step += 1
        metrics["straggler_breach"] = float(timer.tick())
        metrics["straggler_breaches_total"] = float(timer.breaches)
        # ---- monitor-tripped rollback: max_consecutive anomalous steps
        # in a row mean skipping updates no longer contains the fault —
        # restore the newest INTACT checkpoint (corrupt ones are skipped
        # by their CRCs) and rewind the data stream with it.  Bounded
        # retries with linear backoff; with no checkpoint (or the budget
        # spent) the trip counter is cleared, so training continues in
        # skip-updates mode instead of re-tripping every step.
        if metrics.get("rollback_needed", 0.0) >= 1.0:
            rolled = False
            if mgr is not None and rollbacks < tcfg.max_rollbacks:
                rollbacks += 1
                if tcfg.rollback_backoff > 0:
                    time.sleep(tcfg.rollback_backoff * rollbacks)
                restored, manifest = _restore(mgr, state, sspecs, mesh)
                if restored is not None:
                    state = restored
                    host_step = int(manifest["step"])
                    stream.load_state_dict(
                        {"step": manifest["extra"]["data_step"]})
                    rolled = True
            metrics["rollback"] = float(rolled)
            if not rolled and state.monitor is not None:
                state = state._replace(monitor=state.monitor._replace(
                    consecutive=torch.zeros_like(
                        state.monitor.consecutive)))
        history.append(metrics)
        # ``saveable`` is False on a chunk's non-final steps: its runner
        # pass has already inserted all T batches and advanced the
        # stream, so a checkpoint there would restore a sketch that has
        # seen batches no step trained on
        if mgr is not None and saveable and host_step % mgr.interval == 0:
            tree = _ckpt_tree(state) if mesh is None \
                else sharded.gather_state(state, sspecs, mesh)
            if logs:
                mgr.maybe_save(host_step, tree, extra={
                    "data_step": stream.state_dict()["step"]})
            if mesh is not None:        # every rank sees the new step
                dist.barrier()
        if logs and log_every and host_step % log_every == 0:
            print(f"step {host_step}: loss={metrics['loss']:.4f} "
                  f"gnorm={metrics['grad_norm']:.3f} "
                  f"keep={metrics.get('filter_keep_frac', 1.0):.3f} "
                  f"anom={metrics.get('grad_anomaly', 0.0):.0f}")

    def next_jbatch():
        batch = next(stream)
        return _to_device({k: v for k, v in batch.items()
                           if not k.startswith("_")}, device)

    done = 0
    while done < num_steps:
        if runner is not None and num_steps - done >= chunk_T:
            # ---- chunked prefilter: T batches, one runner pass
            jbatches = [next_jbatch() for _ in range(chunk_T)]
            fstate, _summary, keeps = runner.consume(
                state.filter_state, state.filter_w,
                features(state.params, jbatches))
            state = state._replace(filter_state=fstate)
            for t, jb in enumerate(jbatches):
                run_step(jb, keep=keeps[t], saveable=t == chunk_T - 1)
            done += chunk_T
        else:
            jb = next_jbatch()
            if runner is not None:
                fstate, keep = tail_step(
                    state.filter_state, state.filter_w,
                    features(state.params, [jb])[0])
                state = state._replace(filter_state=fstate)
                run_step(jb, keep=keep)
            else:
                run_step(jb)
            done += 1
    return state, history
