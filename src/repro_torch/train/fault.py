"""Host-side fault detection — the ``StepTimer`` of ``repro.train.fault``
(``GradMonitor`` comes with ROADMAP.md queue 1 item 12)."""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class StepTimer:
    """Host-side straggler detector: flags steps breaching the SLO."""
    slo_seconds: float
    _last: float = dataclasses.field(default_factory=time.perf_counter)
    breaches: int = 0

    def tick(self) -> bool:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        if dt > self.slo_seconds:
            self.breaches += 1
            return True
        return False
