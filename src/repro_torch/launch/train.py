"""Training launcher: ``--arch <id>`` on one device.  Port of
``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b \
        --reduced --steps 100 [--device cpu] [--ckpt DIR]

Runs on the card unless ``--device cpu``.  The reference's ``--devices``
(fake host devices) and ``--mesh`` (a data × model mesh) come with
``repro.dist`` (ROADMAP.md queue 1 item 13) and raise here.  As in the
reference, a model fed frame embeddings (whisper) trains with the data
filter off: its loss ignores the loss mask the filter writes.
"""
import argparse

from repro_torch import not_ported


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
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--no-filter", action="store_true")
    ap.add_argument("--no-monitor", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.devices:
        not_ported("--devices (fake host devices for a mesh)", 13)
    if args.mesh:
        not_ported("--mesh (a data x model mesh)", 13)

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
        ckpt_dir=args.ckpt, ckpt_interval=max(args.steps // 5, 10),
        device=args.device)
    scfg = StreamConfig(vocab_size=arch.cfg.vocab_size, seq_len=args.seq,
                        global_batch=args.batch)
    state, hist = train(arch, tcfg, DataStream(scfg), num_steps=args.steps,
                        log_every=10)
    print(f"done: step={int(state.step)} "
          f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
