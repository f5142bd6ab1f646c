"""End-to-end run on the PyTorch/CUDA port: train a ~100M-parameter LM
for a few hundred steps with the whole training stack of ``repro_torch``
— the ACE data filter, the ACE gradient monitor, checkpoints, gradient
accumulation — on the card (``--device cpu`` for the CPU).

    PYTHONPATH=src python examples/train_lm_ace_monitor_torch.py \
        [--steps 300] [--arch olmo_1b] [--poison] [--device cpu]

``--poison`` injects corrupted batches every 13 steps; watch the ``keep``
column drop on those steps once the filter has armed.  Checkpoints go to
``build/train_lm_ckpt`` beside this checkout unless ``--ckpt`` names
another directory.
"""
import argparse
import dataclasses
from pathlib import Path

from repro_torch.data.pipeline import DataStream, StreamConfig
from repro_torch.models.registry import Arch
from repro_torch.train.train_loop import TrainConfig, train

ROOT = Path(__file__).resolve().parents[1]


def build_100m(base: str) -> Arch:
    """~100M-param same-family variant of an assigned arch."""
    a = Arch(base, reduced=True)
    a.cfg = dataclasses.replace(
        a.cfg, num_layers=8, d_model=512, num_heads=8, num_kv_heads=4,
        head_dim=64, d_ff=2048, vocab_size=32768, dtype="float32")
    return a


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--poison", action="store_true")
    ap.add_argument("--ckpt", default=str(ROOT / "build" / "train_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    arch = build_100m(args.arch)
    n_params = arch.param_count()
    print(f"arch={arch.cfg.name} params={n_params / 1e6:.1f}M")

    tcfg = TrainConfig(
        optimizer="adamw", peak_lr=3e-4, warmup_steps=20,
        total_steps=args.steps, microbatches=2,
        use_data_filter=True, use_grad_monitor=True,
        ckpt_dir=args.ckpt, ckpt_interval=100, seed=0, device=args.device)
    scfg = StreamConfig(
        vocab_size=arch.cfg.vocab_size, seq_len=128, global_batch=8,
        seed=0, corrupt_every=13 if args.poison else 0)

    state, history = train(arch, tcfg, DataStream(scfg),
                           num_steps=args.steps, log_every=20)
    losses = [h["loss"] for h in history]
    print(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"over {len(losses)} steps")
    kept = [h.get("filter_keep_frac", 1.0) for h in history]
    anoms = sum(h.get("grad_anomaly", 0.0) for h in history)
    print(f"filter keep-frac: min {min(kept):.2f} mean "
          f"{sum(kept) / len(kept):.3f}; monitor-skipped steps: {anoms:.0f}")
    assert losses[-1] < losses[0], "training must make progress"


if __name__ == "__main__":
    main()
