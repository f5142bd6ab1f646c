"""Frequency-moment drift statistics over the count planes (``moments``);
the quantile-calibrated admission of ``repro.quantile`` is not ported
yet (ROADMAP.md queue 1 item 7)."""
