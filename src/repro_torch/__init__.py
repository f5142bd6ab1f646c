"""ACE (Arrays of locality-sensitive Count Estimators) in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of the JAX package ``repro``, module for module under the same
names (``core.srp``, ``core.sketch``, ``core.estimators``,
``core.privacy``, ``kernels.ops``, ``data.pipeline``,
``data.synthetic``, ``window``, ``fleet``, ``quantile``,
``attribution``, ``stream``, ``serve.engine``, ``serve.frontend``,
``resilience``, ``train``, ``launch.train``, ``baselines``, ``models``,
``configs``, ``cluster``).  It imports
neither JAX nor ``repro``: ``repro`` is the reference its tests hold it
against, and only the tests import both.

The port carries both SRP hash families (dense and SRHT), the flat
sketch in int32, int16, int8 or float32 counters (the narrow ones with or
without the exact overflow promotion of ``core.quantize``) with degraded
(table-masked) scoring, the ``AceEstimator`` (paper
Algorithm 1), the sliding-window epoch ring (``window``), tenant fleets
and windowed fleets (``fleet``), heavy-hitter attribution
(``attribution``: signed count-sketch planes on every kind of state and
the dyadic ``find_hh``), the ``AceDataFilter``, ``WindowedAceFilter`` and
``FleetDataFilter`` with their chunked ``StreamRunner`` (its summaries
name each chunk's heavy-hitter coordinates and, for a fleet, tenants),
and the ``Guardrail`` in its flat, windowed, fleet and windowed-fleet
flavours, each of which audits its own sketch, serves degraded over its
healthy tables, repairs and re-warms the corrupted ones
(``resilience``: health invariants, repair ops and seeded fault
injectors), beside CRC-checked checkpoints that restore the newest
intact step (``train.checkpoint``, in the reference's on-disk format).  Every filter and ``Guardrail`` takes either admission rule:
μ−ασ, or ``threshold_mode="quantile"`` (``quantile``: per-tenant,
per-epoch rate histograms read as an inverse CDF, on the same kernels).
The open-loop front end (``serve.frontend``) batches single requests for
any ``Guardrail`` flavour behind a bounded queue with absolute deadlines,
shedding by each tenant's ``fail_open_mask``.  ``core.privacy`` is the
paper's §4 differentially private hash, ``data.synthetic`` the paper's
three datasets (bitwise the reference's), and ``baselines`` its 11
competitors on one shared kNN graph (plain PyTorch on the card, as the
reference's are plain jnp).  ``models`` and ``configs`` are the model
zoo and its ten configs (decoder-only LMs of "attn", "swa", "mamba" and
"rwkv" layers, dense or MoE, and the encoder-decoder whisper), which
``serve.engine``'s ``ServeEngine`` serves greedily behind a
``Guardrail``.  ``train`` trains them (``train_loop.train``: PyTorch
autograd, remat, microbatches, the ``optim`` optimisers and ``schedule``,
int8 ``compression`` with error feedback) behind the ACE data filter and
the ACE gradient monitor (``fault.GradMonitor``), with checkpoint,
restart and rollback; ``launch.train`` is its command line.
``cluster`` serves a fleet across hosts that fail: rendezvous-hashed
tenants, heartbeats, CRC-framed gossip of each epoch's sketches over a
``torch.distributed`` ``TCPStore``, failover from a peer's gossip or
checkpoint, and rejoin.  Projections come in float32, bfloat16 or
float16; the hash kernels widen narrow x and W to float32 as they load
them.
Its ten kernels, one for each TPU kernel of the reference, are
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
    13: "repro.dist, with launch.dryrun, launch.mesh and Arch.input_specs, "
        "cache_specs and all_cells",
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
