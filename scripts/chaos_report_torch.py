"""Chaos drill on the PyTorch/CUDA port: inject the full fault menu
against a live guardrail + checkpoint stack and emit a machine-readable
resilience report (``RESILIENCE_torch.json``), the same stages, evidence
and schema as ``scripts/chaos_report.py``.

The drill is the ``repro_torch.resilience`` lifecycle end to end, in
order:

1. serve a clean stream (baseline admit behaviour);
2. quarantine — NaN/Inf request rows must be sanitized, counted, and
   answered by the fail policy;
3. corrupt — bit-flip count tables, verify ``health_check`` localises
   exactly the flipped tables and degrades scoring to the healthy rest;
4. repair — re-zero the corrupted tables, re-warm them on live traffic,
   and confirm the guardrail returns to the healthy program;
5. checkpoints — tear the newest checkpoint and confirm
   ``restore_latest`` falls back to the newest intact step.

Every stage appends pass/fail + evidence to the report; the script exits
non-zero if any stage fails, or if the guardrail built other admission
programs than its two (healthy and degraded: on the card two captured
CUDA graphs), so the drill is a gate, not a log.  Runs on the card unless
``--device cpu`` is given.

Usage:
    PYTHONPATH=src python scripts/chaos_report_torch.py \
        [--json RESILIENCE_torch.json] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch import resilience as rz
from repro_torch import resolve_device
from repro_torch.serve.engine import Guardrail, GuardrailConfig
from repro_torch.train import checkpoint as ck

D_MODEL, NUM_BITS, NUM_TABLES = 16, 6, 8
BATCH, SEQ, WARMUP = 32, 2, 64.0
PROGRAMS = 2             # admission programs: healthy and degraded


def _embeds(rng, n=BATCH):
    return rng.normal(size=(n, SEQ, D_MODEL)).astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default="RESILIENCE_torch.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    stages = []

    def stage(name, ok, **evidence):
        stages.append({"stage": name, "ok": bool(ok), **evidence})
        print(f"[{'ok' if ok else 'FAIL'}] {name}: {evidence}")

    g = Guardrail(GuardrailConfig(d_model=D_MODEL, num_bits=NUM_BITS,
                                  num_tables=NUM_TABLES,
                                  warmup_items=WARMUP), device=device)

    # 1. clean baseline — warm past warmup so thresholds are armed
    for _ in range(4):
        g.admit(_embeds(rng))
    base_report = rz.health_check(g.state)
    stage("baseline", bool(base_report.ok), n=float(g.state.n))

    # 2. quarantine: corrupted rows sanitized + counted, policy-answered
    e = _embeds(rng)
    bad = rng.random(BATCH) < 0.25
    e[bad] = np.inf
    before = g.quarantined
    verdict = g.admit(e)
    quarantined = g.quarantined - before
    clean_report = rz.health_check(g.state)
    stage("quarantine",
          quarantined == int(bad.sum()) and bool(clean_report.ok)
          and bool(verdict[bad].all()),  # default policy is fail_open
          injected=int(bad.sum()), quarantined=quarantined)

    # 3. corrupt tables -> health_check localises them, guardrail degrades
    flip_tables = [1, NUM_TABLES - 2]
    counts = g.state.counts
    for t in flip_tables:
        gen = torch.Generator(device=device).manual_seed(t)
        counts = rz.flip_count_bits(counts, gen, num_flips=3, tables=(t,))
    g.state = g.state._replace(counts=counts)
    report = g.health_check()
    table_ok = np.asarray(report.table_ok, bool)
    localised = set(np.nonzero(~table_ok)[0].tolist()) == set(flip_tables)
    still_serving = bool(g.admit(_embeds(rng)).shape == (BATCH,))
    stage("degrade", localised and g.degraded and still_serving,
          flipped=flip_tables,
          masked=np.nonzero(~table_ok)[0].tolist())

    # 4. repair + re-warm back to the healthy program
    g.repair()
    repaired_ok = bool(rz.health_check(g.state, g._repair_offsets).ok)
    while g.degraded:
        g.admit(_embeds(rng))
        g.health_check()
    stage("repair", repaired_ok and not g.degraded,
          rewarmed_n=float(g.state.n))

    # 5. checkpoint tear -> CRC-verified fallback restore
    with tempfile.TemporaryDirectory() as d:
        tree = {"sketch": g.state, "w": g.w}
        ck.save(d, 100, tree, keep=5)
        for _ in range(2):
            g.admit(_embeds(rng))
        ck.save(d, 200, {"sketch": g.state, "w": g.w}, keep=5)
        rz.tear_checkpoint(d, 200, mode="truncate")
        mgr = ck.CheckpointManager(d, keep=5)
        restored, manifest = mgr.restore_latest(tree)
        fell_back = manifest is not None and manifest["step"] == 100
        stage("checkpoint_fallback", bool(fell_back),
              intact_step=None if manifest is None else manifest["step"])

    ok = all(s["ok"] for s in stages)
    out = {"ok": ok, "stages": stages,
           "quarantined_total": int(g.quarantined)}
    Path(args.json).parent.mkdir(parents=True, exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(out, f, indent=2)
    print(f"admission programs built: {g.trace_count} (healthy and "
          f"degraded: {PROGRAMS})")
    print(f"report -> {args.json} (ok={ok})")
    return 0 if ok and g.trace_count == PROGRAMS else 1


if __name__ == "__main__":
    sys.exit(main())
