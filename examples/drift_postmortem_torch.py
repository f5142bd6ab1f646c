"""Drift post-mortem on the PyTorch/CUDA port: WHICH dimensions (and
which tenant) drove the alarm.

    PYTHONPATH=src python examples/drift_postmortem_torch.py [--device cpu]

The ACE tier answers "is this item anomalous" at cache-lookup speed; the
first question an operator asks when the anomaly counter jumps is WHY —
which feature dimensions does the flagged traffic differ in, and (in a
multi-tenant fleet) whose traffic is it?  Answering by pulling raw
flagged items off the device reintroduces exactly the per-item host
traffic the chunked runner exists to avoid.

The attribution tier (``repro_torch.attribution``, enabled with
``attr_rows > 0`` on any filter) answers on-device: every chunk, the
runner splits per-coordinate energy into background vs flagged-anomaly
channels, sketches both into signed count-sketch hierarchies riding the
filter state, and drills down on the chunk's DRIFT VECTOR (mean anomaly
energy − mean background energy per coordinate) with the dyadic findHH
recursion — one ``attr_find_hh`` kernel launch on the card, inside the
same chunk program, reported in the same single summary transfer.

This script stages a post-mortem:

1. a background regime with energy on the low feature dims warms the
   detector;
2. a drifted attack regime appears: flagged rows carry their energy on
   three PLANTED dims the background never uses;
3. the chunk summary's ``hh_coord``/``hh_est`` rows name the planted
   dims — asserted exactly, no device pull beyond the summary;
4. the same traffic through a 4-tenant fleet, attack routed to one
   tenant: ``hh_tenant`` names the offender.
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import convert
from repro_torch.data.pipeline import AceDataFilter
from repro_torch.fleet.filter import FleetDataFilter
from repro_torch.stream import StreamRunner

CHUNK_T = 8
BATCH = 32
DIM = 24                       # feature dim is DIM + 1 (bias column)
PLANTED = (3, 11, 17)          # the dims the attack regime shifts onto
ATTACK_MAG = 8.0
T_FLEET = 4
OFFENDER = 2


def background(rng, T=CHUNK_T):
    """Inlier cone: energy on the low third of the dims (host float32)."""
    x = rng.normal(size=(T, BATCH, DIM + 1)).astype(np.float32) * 0.3
    x[..., : DIM // 3] += 2.0
    return x


def attacked(rng, rows=8):
    """Background chunk with ``rows`` attack rows per step: energy moved
    onto the PLANTED dims (out-of-cone → flagged once armed)."""
    x = background(rng)
    x[:, :rows, : DIM // 3] = 0.1
    for c in PLANTED:
        x[:, :rows, c] = ATTACK_MAG
    return x


def on(x: np.ndarray, device) -> torch.Tensor:
    """A host chunk (features or tenant ids) as a tensor on ``device``."""
    return torch.as_tensor(x, device=device)


def runner_for(filt, w):
    """A StreamRunner over ``filt`` (top-k = the planted count) with its
    (state, W): ``w`` (numpy) carries a projection matrix in."""
    runner = StreamRunner(filt, chunk_T=CHUNK_T, topk=len(PLANTED))
    state, own = runner.init()
    return runner, state, (own if w is None
                           else convert.params_from_numpy(w, filt.device))


def flat_postmortem(rng, device, w=None) -> dict:
    """Part 1: warm and arm the flat filter on background, then one
    attacked chunk; the summary must name every planted dim.  Returns
    {"flagged", "named", "trace_count"}."""
    filt = AceDataFilter(d_model=DIM, num_bits=6, num_tables=16,
                         warmup_items=64.0, alpha=3.0,
                         attr_rows=5, attr_bits=8, device=device)
    acfg = filt.ace_cfg.attr
    print(f"attribution: {acfg.rows} rows x {acfg.width} cols x "
          f"{acfg.num_levels} levels "
          f"(+{acfg.memory_bytes() / 1024:.0f} KiB on the filter state)")
    runner, state, fw = runner_for(filt, w)
    for _ in range(4):                                   # warm + arm
        state, summary = runner.consume(state, fw,
                                        on(background(rng), device))

    state, summary = runner.consume(state, fw, on(attacked(rng), device))
    s = runner.fetch(summary)                            # the ONE pull
    if runner.trace_count != 1:
        raise AssertionError("attribution must not retrace")

    named = [int(c) for c, v in zip(s.hh_coord, s.hh_valid) if v]
    flagged = int(s.anom_counts.sum())
    print(f"\nchunk flagged {flagged} rows "
          f"(kept_frac {float(s.kept_frac):.2f}); drill-down says the "
          "flagged traffic shifted on:")
    for c, e, v in zip(s.hh_coord, s.hh_est, s.hh_valid):
        if v:
            print(f"  dim {int(c):2d}  drift energy {float(e):+9.2f}")
    missing = set(PLANTED) - set(named)
    if missing:
        raise AssertionError(f"drill-down missed planted dims: {missing}")
    print(f"all planted dims {sorted(PLANTED)} named.")
    return {"flagged": flagged, "named": named,
            "trace_count": runner.trace_count}


def fleet_postmortem(rng, device, w=None) -> dict:
    """Part 2: the same traffic through a 4-tenant fleet, the attack rows
    routed to OFFENDER; the summary's tenant ranking must name it first
    and its drill-down the planted dims.  Returns {"flagged", "named",
    "tenants", "tenant_drift", "trace_count"}."""
    ff = FleetDataFilter(d_model=DIM, num_tenants=T_FLEET, num_bits=6,
                         num_tables=16, warmup_items=64.0, alpha=3.0,
                         attr_rows=5, attr_bits=8, device=device)
    frunner, fstate, fw = runner_for(ff, w)
    tids = rng.integers(0, T_FLEET, size=(CHUNK_T, BATCH)).astype(np.int32)
    for _ in range(6):                                   # arm every tenant
        fstate, fsum = frunner.consume(fstate, fw,
                                       on(background(rng), device),
                                       on(tids, device))

    # attack rows routed to ONE tenant
    feats = attacked(rng)
    tids_attack = tids.copy()
    tids_attack[:, :8] = OFFENDER
    fstate, fsum = frunner.consume(fstate, fw, on(feats, device),
                                   on(tids_attack, device))
    fs = frunner.fetch(fsum)

    print(f"\nfleet of {T_FLEET}: per-tenant drift L2 ranking "
          f"(top {len(fs.hh_tenant)}):")
    for t, e in zip(fs.hh_tenant, fs.hh_tenant_est):
        print(f"  tenant {int(t)}  ||drift||_2 {float(e):9.2f}")
    if int(fs.hh_tenant[0]) != OFFENDER:
        raise AssertionError(f"offender not ranked first: {fs.hh_tenant}")
    fnamed = [int(c) for c, v in zip(fs.hh_coord, fs.hh_valid) if v]
    if set(PLANTED) - set(fnamed):
        raise AssertionError(f"fleet drill-down missed planted dims: "
                             f"{fnamed}")
    print(f"tenant {OFFENDER} named as the offender; same planted dims "
          "recovered from the fleet summary.")
    return {"flagged": int(fs.anom_counts.sum()), "named": fnamed,
            "tenants": [int(t) for t in fs.hh_tenant],
            "tenant_drift": fs.hh_tenant_est,
            "trace_count": frunner.trace_count}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)
    flat_postmortem(rng, device)           # -- 1. flat post-mortem
    fleet_postmortem(rng, device)          # -- 2. fleet: who is it?


if __name__ == "__main__":
    main()
