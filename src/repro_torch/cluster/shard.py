"""Elastic tenant→host assignment via rendezvous (HRW) hashing — port of
``repro.cluster.shard``, pure Python: owners, maps and their JSON are the
reference's, byte for byte.

The fleet's tenant axis is collective-free, so "sharding" a fleet
across hosts is pure routing: host h serves the tenants it owns and
ignores the rest (``StreamRunner``'s ``tenant_mask`` makes misroutes
inert).  What the assignment function must guarantee is MINIMAL
MOVEMENT under membership change — when a host dies, ONLY its tenants
may re-home (each survivor's warm sketches stay put), and when a host
(re)joins, only the tenants it wins move.  Rendezvous hashing gives
exactly that: tenant t is owned by ``argmax_h hash(h, t)``, so removing
h from the candidate set changes the argmax only where h was winning,
and adding h changes it only where h now wins.  Consistent-hash rings
give the same property but need virtual nodes for balance; HRW is
balanced by construction at these T/host ratios and is ~5 lines.

A :class:`ShardMap` is an immutable, versioned snapshot of the
assignment — hosts + num_tenants fully determine it, so publishing a
map costs a few hundred JSON bytes, never T entries, and every host
derives identical ownership from the same (version, hosts) pair.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np


def _weight(host: str, tenant: int) -> int:
    """Deterministic 64-bit HRW weight (stable across processes/runs —
    NEVER Python's salted ``hash``)."""
    digest = hashlib.blake2b(f"{host}|{tenant}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "big")


def rendezvous_owner(tenant: int, hosts: tuple[str, ...]) -> str:
    """The highest-random-weight owner of ``tenant`` among ``hosts``
    (ties broken by host id — deterministic everywhere)."""
    if not hosts:
        raise ValueError("rendezvous_owner needs at least one host")
    return max(hosts, key=lambda h: (_weight(h, tenant), h))


@dataclasses.dataclass(frozen=True)
class ShardMap:
    """Versioned tenant→host assignment (immutable; derive, don't edit).

    ``hosts`` is the ALIVE set; dead hosts are simply absent (their
    tenants re-home by HRW).  ``version`` totally orders maps — every
    consumer ignores any map older than what it already applied.
    """

    version: int
    hosts: tuple[str, ...]
    num_tenants: int

    def __post_init__(self):
        if not self.hosts:
            raise ValueError("a ShardMap needs at least one live host")
        if len(set(self.hosts)) != len(self.hosts):
            raise ValueError(f"duplicate hosts: {self.hosts}")
        object.__setattr__(self, "hosts", tuple(sorted(self.hosts)))

    def owner_of(self, tenant: int) -> str:
        return rendezvous_owner(tenant, self.hosts)

    def owned_by(self, host: str) -> tuple[int, ...]:
        return tuple(t for t in range(self.num_tenants)
                     if self.owner_of(t) == host)

    def tenant_mask(self, host: str) -> np.ndarray:
        """(T,) float32 ownership mask for ``StreamRunner.consume``."""
        mask = np.zeros(self.num_tenants, np.float32)
        mask[list(self.owned_by(host))] = 1.0
        return mask

    def to_json(self) -> str:
        return json.dumps({"version": self.version,
                           "hosts": list(self.hosts),
                           "num_tenants": self.num_tenants})

    @classmethod
    def from_json(cls, blob: str) -> "ShardMap":
        d = json.loads(blob)
        return cls(version=int(d["version"]), hosts=tuple(d["hosts"]),
                   num_tenants=int(d["num_tenants"]))


def without_host(m: ShardMap, dead: str) -> ShardMap:
    """The successor map after ``dead`` is declared gone (version+1).
    Only ``dead``'s tenants change owner (the HRW guarantee)."""
    hosts = tuple(h for h in m.hosts if h != dead)
    return ShardMap(version=m.version + 1, hosts=hosts,
                    num_tenants=m.num_tenants)


def with_host(m: ShardMap, host: str) -> ShardMap:
    """The successor map after ``host`` (re)joins (version+1).  Only
    tenants ``host`` wins under HRW move — everyone else stays warm."""
    if host in m.hosts:
        return m
    return ShardMap(version=m.version + 1, hosts=m.hosts + (host,),
                    num_tenants=m.num_tenants)
