#!/usr/bin/env python3
"""Time one checkout's kernels at the main path's shapes, on one card, and
print one JSON line: the ``ace_update`` and ``srht_hash`` kernels, the
calls around the gather — ``ops.ace_query``, ``ops.ace_update`` and
``ops.ace_fleet_admit_at`` at the fit, admit and stream-step shapes, and
the fused windowed-fleet admission at its guardrail's shape — and the
public functions ``attribution.find_hh`` (phase 7's hierarchy),
``ops.ace_score`` (the estimator's score shape, with and without a table
mask), ``ops.ace_window_score`` (with and without a table mask) and
``ops.ace_fleet_score`` (phase 6's query shape).  With ``--operands``
it times instead the six hash kernels on bfloat16 and float16 operands
in turns with float32 (and ``srp_hash`` and ``ace_admit_fused`` with the
widening tile, the other three dense ones with the operands widened on
the card first), as ``chip_smoke.phase_timing_operands`` does; with
``--float32``, the five dense hash kernels on float32 operands alone
(``srp_hash`` at its three main-path shapes, the fused four at the admit
shape), which every checkout since the fused kernels can run.

    python scripts/kernel_ab.py [--root DIR] [--label NAME]
                                [--operands | --float32]

The kernels come from ``DIR/src/repro_torch`` (default: this checkout)
and are built there; the inputs, shapes and timing are this checkout's
``chip_smoke.time_update_and_srht``, ``chip_smoke.time_query_paths`` and
``chip_smoke.time_public_paths``, so two checkouts unpacked side by side
time the same work.  To compare a change with its parent on one card,
run parent, change, change, parent in one sitting: the card and its
power limit are in each line.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]


def time_float32_hashes(cs, mods, device) -> dict:
    """Device ms of ``srp_hash`` at the dense hash's three main-path
    shapes and of the four fused hash kernels at the admit shape, on
    float32 operands (``chip_smoke``'s shapes, inputs and timing)."""
    h, out = mods["srp_hash"], {}
    for where, B, d, K, L in cs.dense_hash_shapes():
        cfg, (x, w), _ = cs.operands(B, d, K, L, "bfloat16", device, 56)
        out[f"srp_hash {where}"] = cs.device_ms(lambda: h.srp_hash(x, w,
                                                                    cfg))
    B, d = cs.ADMIT_B, cs.D_MODEL + 1
    cfg, (x, w), _ = cs.operands(B, d, cs.K_BITS, cs.L_TABLES, "bfloat16",
                                 device, 58)
    runs, _ = cs.fused_cases(mods, device, cfg, B)
    for name, run in runs.items():
        out[name] = cs.device_ms(lambda: run(x, w, fresh=False))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE,
                    help="checkout whose kernels to time")
    ap.add_argument("--label", default=None)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--operands", action="store_true",
                      help="time the hash kernels on 2-byte operands only")
    mode.add_argument("--float32", action="store_true",
                      help="time the dense hash kernels on float32 only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is false; this script "
              "needs a CUDA device", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(HERE))
    import chip_smoke
    from repro_torch.kernels import ace_update, build, srht_hash
    if not Path(ace_update.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"kernel_ab: repro_torch did not come from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain hash's ids
    build.build_all()
    device = torch.device("cuda")
    if args.operands or args.float32:
        import importlib
        mods = {k: importlib.import_module(f"repro_torch.kernels.{k}")
                for k in chip_smoke.KERNELS}
    if args.float32:
        print(json.dumps({"label": args.label or str(root),
                          "card": chip_smoke.card_line(),
                          **time_float32_hashes(chip_smoke, mods, device)}))
        return 0
    if args.operands:
        times = chip_smoke.phase_timing_operands(mods, device)
        keep = ("ms", "float32_ms", "widen_ms", "matmul_ms", "plain_ms",
                "bound_ms", "bound_by", "shape")
        print(json.dumps({
            "label": args.label or str(root), "card": chip_smoke.card_line(),
            **{k: {dt: [{f: r[f] for f in keep if f in r}
                        for r in e.get("by_shape", [e])]
                   for dt, e in v.items()} for k, v in times.items()}}))
        return 0
    times = chip_smoke.time_update_and_srht(ace_update, srht_hash, device)
    times.update(chip_smoke.time_query_paths(device))
    times.update(chip_smoke.time_public_paths(device))
    keep = ("ms", "copies_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "shape")
    print(json.dumps({
        "label": args.label or str(root), "card": chip_smoke.card_line(),
        **{k: [{f: r[f] for f in keep if f in r} for r in v["by_shape"]]
           for k, v in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
