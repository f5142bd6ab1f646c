"""Heartbeats, failure detection, and attempt-bounded rejoin backoff —
port of ``repro.cluster.membership``, pure Python with an injected clock.

Liveness is decided from CHANGE, not clocks: each host bumps a
monotonic sequence number under ``hb/<host>`` every
``heartbeat_interval``; the detector records, against its OWN clock,
when it last saw each host's value change.  A host whose value has not
changed for ``failure_timeout`` is DEAD.  Comparing local observation
times (never the writers' timestamps) means nothing here assumes
synchronised clocks across hosts — the only time base is the observer's.

The detector is deliberately a two-state machine (ALIVE → DEAD) with
the SUSPECT stage folded into the timeout: at our gossip cadence the
cost of a false positive is bounded — the "dead" host's tenants re-home
from its last gossiped sketch, and if it was merely slow it comes back
through the join path (:class:`RejoinPolicy`) like any other returning
host.  The rejoin path is the part that must NOT be naive: a flapping
host rejoining in a tight loop would thrash the shard map, so rejoin
attempts are bounded and exponentially backed off, and a host that
exhausts its attempts stays out until an operator intervenes.
"""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass(frozen=True)
class MembershipConfig:
    heartbeat_interval: float = 0.2   # seconds between beats
    failure_timeout: float = 1.0      # silence ⇒ DEAD (≥ several beats)

    def __post_init__(self):
        if self.failure_timeout <= self.heartbeat_interval:
            raise ValueError(
                f"failure_timeout ({self.failure_timeout}) must exceed "
                f"heartbeat_interval ({self.heartbeat_interval}) — a "
                "timeout under one beat declares every host dead "
                "between its own heartbeats")


class HeartbeatWriter:
    """Bumps ``hb/<host>`` at most once per interval (cheap to call
    every chunk — the hot loop never needs its own timer).

    The written value is ``"seq:map_version"`` — the shard-map regime
    the writer currently believes in rides every beat, so the detector
    can refuse to count liveness from a host revived with a STALE map
    (a rewound zombie's beats would otherwise look like fresh change).
    ``version`` is owned by the node and updated whenever it applies a
    newer map; until the zombie catches up to the current map its
    beats do not reset anyone's failure timer."""

    def __init__(self, store, host: str, cfg: MembershipConfig,
                 clock=time.monotonic):
        self._store = store
        self._key = f"hb/{host}"
        self._cfg = cfg
        self._clock = clock
        self._seq = 0
        self._last = None
        self.version = 0          # current shard-map version (fencing)

    def beat(self) -> None:
        self._seq += 1
        self._store.set(self._key, f"{self._seq}:{int(self.version)}")
        self._last = self._clock()

    def maybe_beat(self) -> bool:
        now = self._clock()
        if self._last is None or \
                now - self._last >= self._cfg.heartbeat_interval:
            self.beat()
            return True
        return False


class FailureDetector:
    """Change-based liveness: per host, the local time its heartbeat
    value last CHANGED.  ``poll`` returns the currently-dead subset of
    the hosts asked about.  A host never seen at all is given a grace
    window from the time it was first asked about (startup is not
    death)."""

    def __init__(self, store, cfg: MembershipConfig,
                 clock=time.monotonic):
        self._store = store
        self._cfg = cfg
        self._clock = clock
        # host -> (last_value | None, local time of last change/first
        #          ask, highest map_version ever seen from the host)
        self._seen: dict[str, tuple[str | None, float, int]] = {}

    @staticmethod
    def _version_of(value) -> int:
        """map_version carried by a heartbeat value; legacy bare-seq
        beats (no ':') and unreadable values count as version 0."""
        if value is None:
            return 0
        _, sep, ver = str(value).partition(":")
        if not sep:
            return 0
        try:
            return int(ver)
        except ValueError:
            return 0

    def poll(self, hosts) -> list[str]:
        now = self._clock()
        dead = []
        for host in hosts:
            value = self._store.get(f"hb/{host}")
            prev = self._seen.get(host)
            if prev is None:
                self._seen[host] = (value, now, self._version_of(value))
                continue
            pval, ptime, pver = prev
            if value != pval:
                ver = self._version_of(value)
                if ver >= pver:
                    self._seen[host] = (value, now, ver)
                    continue
                # STALE-VERSION beat (revived zombie with an old map):
                # record the value so repeats don't look like change,
                # but do NOT reset the failure clock — the host is not
                # live in any regime that matters until it catches up.
                self._seen[host] = (value, ptime, pver)
            if now - self._seen[host][1] > self._cfg.failure_timeout:
                dead.append(host)
        return dead

    def forget(self, host: str) -> None:
        """Drop observation state (host left the map; a rejoin starts a
        fresh grace window)."""
        self._seen.pop(host, None)


@dataclasses.dataclass
class RejoinPolicy:
    """Attempt-bounded exponential backoff for hosts re-entering the
    cluster.  ``next_delay`` returns the wait before the next attempt,
    or None when the budget is exhausted (stay out; don't flap)."""

    max_attempts: int = 5
    base_delay: float = 0.1
    max_delay: float = 5.0
    attempt: int = 0

    def next_delay(self) -> float | None:
        if self.attempt >= self.max_attempts:
            return None
        delay = min(self.base_delay * (2.0 ** self.attempt),
                    self.max_delay)
        self.attempt += 1
        return delay

    def reset(self) -> None:
        """A successful (re)admission refunds the budget."""
        self.attempt = 0
