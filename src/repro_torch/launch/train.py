"""Training launcher: ``--arch <id>`` on one device, or over a data × model
mesh of ranks.  Port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b \
        --reduced --steps 100 [--device cpu] [--devices 4 --mesh 2x2] \
        [--ckpt-dir DIR] [--optimizer adafactor] [--grad-compression] \
        [--filter-chunk T]

Runs on the card unless ``--device cpu``.  ``--devices N`` spawns N
processes joined by the ``gloo`` backend (where the reference forces N
fake host devices), on the CPU or all on the card(s), one rank a process;
``--mesh DxM`` lays them out as data × model (default N×1).  Each rank
trains its blocks: parameters and optimiser state split by the logical
rules of the mesh (``dist.mesh.rules_for``) plus FSDP over ``data``,
gradients reduce-scattered onto that layout (ZeRO-2,
``train.sharded``); the filter's and the monitor's sketches stay whole on
every rank.  Every option runs under a mesh as on one device: Adafactor,
int8 compression, the chunked prefilter and checkpoints (gathered whole
and saved by rank 0, so a run at any world size resumes them).  Rank 0
logs and prints the result.  As in the
reference, a model fed frame embeddings (whisper) trains with the data
filter off: its loss ignores the loss mask the filter writes.
"""
import argparse
import os
import tempfile


def _run(args, mesh=None) -> None:
    from repro_torch.data.pipeline import DataStream, StreamConfig
    from repro_torch.models.registry import Arch
    from repro_torch.train.train_loop import TrainConfig, train

    arch = Arch(args.arch, reduced=args.reduced)
    tcfg = TrainConfig(
        optimizer=args.optimizer, peak_lr=args.lr,
        warmup_steps=max(args.steps // 20, 1), total_steps=args.steps,
        microbatches=args.microbatches,
        use_data_filter=not args.no_filter and arch.cfg.input_mode == "tokens",
        use_grad_monitor=not args.no_monitor,
        grad_compression=args.grad_compression,
        filter_chunk=args.filter_chunk,
        ckpt_dir=args.ckpt, ckpt_interval=max(args.steps // 5, 10),
        device=args.device)
    scfg = StreamConfig(vocab_size=arch.cfg.vocab_size, seq_len=args.seq,
                        global_batch=args.batch)
    kw = {}
    if mesh is not None:
        from repro_torch.dist.mesh import fsdp_tree, rules_for, \
            sharding_tree_for
        from repro_torch.models.common import set_rules
        set_rules(rules_for(mesh))
        shapes = arch.abstract_params()[0]
        kw = dict(mesh=mesh, grad_pspecs=sharding_tree_for(
                      mesh, fsdp_tree(arch.param_pspecs(), shapes, mesh),
                      shapes))
    state, hist = train(arch, tcfg, DataStream(scfg), num_steps=args.steps,
                        log_every=10, **kw)
    if mesh is None or mesh.get_rank() == 0:
        print(f"done: step={int(state.step)} "
              f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")


def _rank(rank: int, world: int, init_file: str, args) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.dist.mesh import make_debug_mesh
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        on_card = args.device != "cpu"
        if on_card:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:       # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        d, m = _mesh_shape(args)
        _run(args, make_debug_mesh(data=d, model=m,
                                   device_type="cuda" if on_card else "cpu"))
    finally:
        dist.destroy_process_group()


def _mesh_shape(args) -> tuple[int, int]:
    if args.mesh:
        d, m = (int(x) for x in args.mesh.split("x"))
    else:
        d, m = args.devices, 1
    return d, m


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--devices", type=int, default=0)
    ap.add_argument("--mesh", default=None, help="e.g. 4x2 = data x model")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", "--ckpt-dir", dest="ckpt", default=None)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--filter-chunk", type=int, default=0)
    ap.add_argument("--no-filter", action="store_true")
    ap.add_argument("--no-monitor", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if not (args.devices or args.mesh):
        _run(args)
        return
    d, m = _mesh_shape(args)
    world = args.devices or d * m
    if d * m != world:
        raise ValueError(f"--mesh {args.mesh} has {d * m} ranks, "
                         f"--devices {world}")
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(world, os.path.join(tmp, "init"), args),
                 nprocs=world)


if __name__ == "__main__":
    main()
