"""ACE (Arrays of locality-sensitive Count Estimators) in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of the JAX package ``repro``, module for module under the same
names (``core.srp``, ``core.sketch``, ``core.estimators``,
``kernels.ops``, ``data.pipeline``, ``window``, ``fleet``,
``attribution``, ``stream``, ``serve.engine``).  It imports
neither JAX nor ``repro``: ``repro`` is the reference its tests hold it
against, and only the tests import both.

The port carries both SRP hash families (dense and SRHT), the int32 flat
sketch with degraded (table-masked) scoring, the ``AceEstimator`` (paper
Algorithm 1), the sliding-window epoch ring (``window``), tenant fleets
and windowed fleets (``fleet``), heavy-hitter attribution
(``attribution``: signed count-sketch planes on every kind of state and
the dyadic ``find_hh``), the ``AceDataFilter``, ``WindowedAceFilter`` and
``FleetDataFilter`` with their chunked ``StreamRunner`` (its summaries
name each chunk's heavy-hitter coordinates and, for a fleet, tenants),
and the ``Guardrail`` in its flat, windowed, fleet and windowed-fleet
flavours; its ten kernels, one for each TPU kernel of the reference, are
``srp_hash``, ``srht_hash``, ``ace_update``, ``ace_query``,
``ace_score_fused``, ``ace_admit_fused``, ``ace_window_combine``,
``ace_fleet_score``, ``ace_fleet_window_admit`` and ``attr_estimate``
(``repro_torch/csrc``).

Entry points run on the card (``torch.device("cuda")``) unless the caller
passes ``device="cpu"``; on CPU tensors every kernel wrapper takes its
plain PyTorch version instead of the CUDA kernel.
"""
from __future__ import annotations

import torch

# ROADMAP.md queue 1 items that bring what the port leaves out so far.
ROADMAP_QUEUE_1 = {
    7: "repro.quantile",
    9: "repro.core.quantize (int8/int16 planes plus the escalation table)",
    10: "repro.resilience",
    13: "repro.dist",
}


def not_ported(feature: str, item: int):
    """Raise NotImplementedError for a feature a later slice brings,
    naming its ROADMAP.md queue item."""
    raise NotImplementedError(
        f"{feature} is not ported to repro_torch yet: ROADMAP.md queue 1 "
        f"item {item} ({ROADMAP_QUEUE_1[item]})")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and there is
    no card — the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
