"""Self-healing ACE sketches — port of ``repro.resilience``: fault
injection, health invariants and repair.

A sketch of a few MB of counts is a single point of failure: one NaN
batch poisons the Welford moments, one flipped bit corrupts every later
decision, a torn checkpoint propagates silently.  ACE's L independent
tables are redundancy the sketch already owns, so failures become
detectable, maskable and repairable:

* ``health``  — invariant checks over every state type, returning
                per-table (and per-tenant) health masks, and repair ops
                that zero a corrupted table while the others keep serving.
* ``inject``  — deterministic fault injectors (NaN/Inf batches, count bit
                flips, saturation, poisoned moments, torn checkpoints,
                stalled steps), seeded with a ``torch.Generator``.

The health masks feed the ``table_mask`` every scoring op takes: degraded
scoring averages over the healthy tables only, an unbiased estimator of
the same Ŝ(q, D) (Theorem 1 holds for any subset of the independent
tables).  ``serve.engine.Guardrail.health_check`` / ``repair`` wire them
into serving; ``train.checkpoint`` keeps CRC-checked checkpoints.
"""
from repro_torch.resilience.inject import (  # noqa: F401
    corrupt_embeddings,
    flip_count_bits,
    poison_moments,
    saturate_table,
    stall_step,
    tear_checkpoint,
)
from repro_torch.resilience.health import (  # noqa: F401
    HealthReport,
    check_ace,
    check_fleet,
    check_fleet_window,
    check_window,
    health_check,
    repair_ace,
    repair_fleet,
    repair_fleet_window,
    repair_moments,
    repair_window,
    serving_mask,
)
