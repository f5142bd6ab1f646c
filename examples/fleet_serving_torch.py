"""Fleet serving demo on the PyTorch/CUDA port: 8 tenants behind ONE
guardrail program.

Each tenant is an independent service with its own traffic distribution
(its own embedding cone).  A single multi-tenant ``Guardrail`` hosts all
8 detectors as one ``FleetState`` — every admit call takes the mixed
batch plus tenant ids, hashes once, and scores/thresholds/inserts each
request against its OWN tenant's sketch; on the card the admission is
one captured CUDA graph (``trace_count`` 1).

The demo shows the property the tenant axis exists for: when tenant 3's
traffic starts drifting (bursts of off-cone garbage), its own detector
flags the bursts — while the other 7 tenants' thresholds, admit
decisions, and sketch states stay BITWISE identical to a world where
tenant 3 never misbehaved.  One noisy neighbour cannot poison the
fleet.

Run:  PYTHONPATH=src python examples/fleet_serving_torch.py [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import convert
from repro_torch.fleet.state import tenant_view
from repro_torch.serve.engine import Guardrail, GuardrailConfig

T, B_PER, D, SEQ = 8, 4, 24, 3          # 8 tenants, 4 requests each/step
BURSTY = 3                              # the tenant that drifts
WARM_STEPS, LIVE_STEPS = 24, 12
BURST_AT = {2, 5, 8, 11}                # live steps where tenant 3 bursts


def tenant_traffic(rng, base, t, burst=False):
    """(B_PER, SEQ, D) embeddings for tenant t: its own cone, or garbage."""
    if burst:
        return rng.normal(size=(B_PER, SEQ, D)) * 3.0   # off-cone garbage
    return base[t] + rng.normal(size=(B_PER, SEQ, D)) * 0.1


def run_stream(bursts: bool, seed: int = 0, device=None, w=None):
    """Drive the fleet guardrail over the mixed stream on ``device``;
    ``w`` (numpy, (D + 1, P)) carries a projection matrix in, else the
    guardrail draws its own.  Returns (guardrail, per-step admit masks of
    the live phase)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(T, 1, 1, D)) * 1.0          # tenant cones
    g = Guardrail(GuardrailConfig(
        d_model=D, num_bits=10, num_tables=16, alpha=3.0,
        warmup_items=float(WARM_STEPS * B_PER // 2), num_tenants=T),
        device=device,
        w=None if w is None else convert.params_from_numpy(w, device))
    tids = np.repeat(np.arange(T), B_PER).astype(np.int32)

    def step(burst_now):
        embeds = np.concatenate(
            [tenant_traffic(rng, base, t,
                            burst=(burst_now and t == BURSTY))
             for t in range(T)])
        return g.admit(embeds.astype(np.float32), tids)

    for _ in range(WARM_STEPS):
        step(False)
    masks = [step(bursts and i in BURST_AT) for i in range(LIVE_STEPS)]
    return g, np.stack(masks)


def tenants_equal(a, b, t: int) -> bool:
    """Tenant t's sketch (counts, n, Welford moments) bitwise equal in the
    fleet states ``a`` and ``b``."""
    return all(torch.equal(x, y) for x, y in zip(tenant_view(a, t),
                                                 tenant_view(b, t))
               if x is not None)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)
    # identical RNG draws in both worlds: the burst replaces tenant 3's
    # draw, every other tenant's stream is literally the same bytes
    g_burst, masks_burst = run_stream(bursts=True, device=device)
    g_clean, masks_clean = run_stream(bursts=False, device=device)

    tids = np.repeat(np.arange(T), B_PER)
    burst_rows = tids == BURSTY
    caught = sum(int((~masks_burst[i][burst_rows]).sum())
                 for i in BURST_AT)
    total_burst = len(BURST_AT) * B_PER
    neighbour_flags = int((~masks_burst[:, ~burst_rows]).sum())

    print(f"fleet guardrail: {T} tenants, one admit program "
          f"(trace_count={g_burst.trace_count})")
    print(f"tenant {BURSTY} drift bursts flagged: {caught}/{total_burst}")
    print(f"false flags on the other {T - 1} tenants: {neighbour_flags}")

    # isolation: every non-bursty tenant's state is bitwise identical to
    # the clean world — thresholds included
    for t in range(T):
        if t != BURSTY and not tenants_equal(g_burst.state, g_clean.state,
                                             t):
            raise AssertionError(f"tenant {t}'s sketch differs from the "
                                 "burst-free world")
    np.testing.assert_array_equal(
        masks_burst[:, ~burst_rows], masks_clean[:, ~burst_rows])
    print(f"neighbour isolation: all {T - 1} other tenants' sketches and "
          "admit masks bitwise identical to the burst-free world")

    if caught < total_burst * 3 // 4:
        raise AssertionError("bursts largely uncaught")
    if g_burst.trace_count != 1:
        raise AssertionError("admit retraced")
    print("OK")


if __name__ == "__main__":
    main()
