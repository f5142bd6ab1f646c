"""Control-plane key/value store for the cluster — port of
``repro.cluster.kv``.

Heartbeats, shard maps, join requests and gossiped sketches all ride a
tiny string/bytes KV interface with two implementations:

* :class:`MemStore` — an in-process dict (thread-safe), the reference's
  as it is.  Every cluster state machine (failure detection, re-shard,
  gossip, rejoin backoff) is testable in one process against it, with a
  fake clock.
* :class:`DistributedStore` — a ``torch.distributed`` store, the one every
  ``torchrun`` launch (or ``init_process_group``) already has, in place of
  the reference's ``jax.distributed`` coordination client.  It wraps an
  existing ``torch.distributed.Store``, or connects a ``TCPStore`` to a
  host and port (serving it when ``is_master``), by default those of
  ``MASTER_ADDR`` / ``MASTER_PORT`` as ``torchrun`` sets them.

The interface is last-writer-wins with NON-BLOCKING reads (``get``
returns None on absence): heartbeats are monotonic sequence numbers,
shard maps are versioned and self-describing, gossip blobs are
CRC-framed and published under epoch-stamped keys with a pointer flipped
last, so a torn read is indistinguishable from a slightly stale one.
"""
from __future__ import annotations

import datetime
import json
import os
import threading
import uuid

import torch


class MemStore:
    """In-process ControlStore — the unit-test double (thread-safe)."""

    def __init__(self):
        self._data: dict[str, bytes] = {}
        self._lock = threading.Lock()

    def set(self, key: str, value: str) -> None:
        self.set_bytes(key, value.encode())

    def set_bytes(self, key: str, value: bytes) -> None:
        with self._lock:
            self._data[key] = bytes(value)

    def get(self, key: str) -> str | None:
        b = self.get_bytes(key)
        return None if b is None else b.decode()

    def get_bytes(self, key: str) -> bytes | None:
        with self._lock:
            return self._data.get(key)

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)

    def keys(self, prefix: str) -> list[str]:
        with self._lock:
            return sorted(k for k in self._data if k.startswith(prefix))


class DistributedStore:
    """ControlStore over a ``torch.distributed.Store`` (a ``TCPStore``).

    ``store``: an existing store (e.g. the one ``init_process_group``
    made); else a ``TCPStore`` is connected to ``host``:``port``
    (default ``MASTER_ADDR``:``MASTER_PORT``), and served by this process
    when ``is_master``.  ``timeout`` (seconds) bounds connecting and any
    read.

    A store's ``get`` of an absent key blocks until the timeout and then
    raises, so ``get``/``get_bytes`` ask ``check`` first and return None
    for an absent key: reads stay non-blocking, as the protocols above
    need.  A key deleted between the two calls costs one timeout and reads
    as None.  ``delete`` of an absent key is a no-op; ``keys`` filters the
    store's key list.

    The libuv ``TCPStore`` refuses a value past 8 MiB, and a full-width
    gossip blob is tens of MB (8 tenants of K = 15, L = 50: 52 MB), so
    ``set_bytes`` writes a value longer than ``PART`` bytes as parts under
    ``PARTS/<key>/<token>/<i>``, then a header under the key itself (the
    header last, as gossip flips its pointer last); ``get_bytes`` joins
    them and reads a value whose parts are gone (overwritten or deleted
    meanwhile) as absent.  ``keys`` never lists the parts.
    """

    PART = 4 << 20                       # bytes a part
    PARTS = "__parts__/"                 # the parts' key namespace
    MAGIC = b"\x00repro-parts\x00"        # a header's first bytes

    def __init__(self, store=None, *, host: str | None = None,
                 port: int | None = None, is_master: bool = False,
                 timeout: float = 10.0):
        if store is None:
            host = host or os.environ.get("MASTER_ADDR")
            port = port or os.environ.get("MASTER_PORT")
            if host is None or port is None:
                raise RuntimeError(
                    "DistributedStore needs a torch.distributed store, a "
                    "host and port, or MASTER_ADDR and MASTER_PORT set (as "
                    "torchrun sets them)")
            store = torch.distributed.TCPStore(
                host, int(port), is_master=is_master,
                timeout=datetime.timedelta(seconds=timeout),
                wait_for_workers=False)
        self._store = store

    def set(self, key: str, value: str) -> None:
        self.set_bytes(key, value.encode())

    def _raw(self, key: str) -> bytes | None:
        if not self._store.check([key]):
            return None
        try:
            return bytes(self._store.get(key))
        except Exception:             # deleted since the check: absent
            return None

    def _parts(self, key: str, raw: bytes | None) -> list[str]:
        """The part keys a header names ([] for a plain value)."""
        if raw is None or not raw.startswith(self.MAGIC):
            return []
        head = json.loads(raw[len(self.MAGIC):].decode())
        return [f"{self.PARTS}{key}/{head['token']}/{i}"
                for i in range(head["n"])]

    def set_bytes(self, key: str, value: bytes) -> None:
        value = bytes(value)
        old = self._parts(key, self._raw(key))
        if len(value) <= self.PART:
            self._store.set(key, value)
        else:
            token = uuid.uuid4().hex
            n = -(-len(value) // self.PART)
            for i in range(n):
                self._store.set(f"{self.PARTS}{key}/{token}/{i}",
                                value[i * self.PART:(i + 1) * self.PART])
            self._store.set(key, self.MAGIC + json.dumps(
                {"token": token, "n": n, "size": len(value)}).encode())
        for k in old:
            self._store.delete_key(k)

    def get(self, key: str) -> str | None:
        b = self.get_bytes(key)
        return None if b is None else b.decode()

    def get_bytes(self, key: str) -> bytes | None:
        raw = self._raw(key)
        parts = self._parts(key, raw)
        if not parts:
            return raw
        chunks = [self._raw(k) for k in parts]
        if any(c is None for c in chunks):
            return None                   # overwritten or deleted meanwhile
        value = b"".join(chunks)
        size = json.loads(raw[len(self.MAGIC):].decode())["size"]
        return value if len(value) == size else None

    def delete(self, key: str) -> None:
        parts = self._parts(key, self._raw(key))
        self._store.delete_key(key)
        for k in parts:
            self._store.delete_key(k)

    def keys(self, prefix: str) -> list[str]:
        return sorted(k for k in self._store.list_keys()
                      if k.startswith(prefix)
                      and not k.startswith(self.PARTS))
