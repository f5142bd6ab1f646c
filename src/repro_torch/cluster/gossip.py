"""Epoch-boundary sketch gossip: serialize, CRC-frame, publish, adopt —
port of ``repro.cluster.gossip``, in the reference's wire format.

An ACE sketch is a CRDT (counts add, moments merge by Chan's rule), so a
PEER'S COPY of a tenant's sketch is a valid warm restore point.  Each
host publishes its owned tenants' sketches once per epoch; when a host
dies, the survivors adopt its tenants from the last gossiped snapshot,
losing at most the partial epoch since the last publish.

Integrity is layered:

1. transport: every array of a snapshot carries a CRC32 in the framing
   manifest; a torn or bit-flipped BLOB fails :class:`SnapshotCorrupt`
   at unpack.
2. semantics: a sketch corrupted BEFORE serialization has valid CRCs,
   so adoption also runs every candidate through
   ``repro_torch.resilience.health_check`` (count conservation per table,
   finite moments) and refuses one that fails.

A blob is the reference's: an npz of ``counts`` (t, L, 2^K) in the
fleet's count dtype, ``stats`` (3, t) float32 (n, Welford mean, M2) and
the JSON ``manifest`` as uint8, so a blob packed by either package
unpacks in the other.  Publishing flips an epoch pointer LAST (blob under
``gossip/<host>/<e>``, then ``gossip/<host>/latest`` ← e), so a reader
following the pointer never sees a half-written blob.
"""
from __future__ import annotations

import io
import json
import zlib

import numpy as np
import torch

from repro_torch.core.sketch import AceState


class SnapshotCorrupt(RuntimeError):
    """A gossiped snapshot failed CRC/framing verification."""


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _host(leaf) -> np.ndarray:
    """A state leaf as a host numpy array (a CPU tensor or any array)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def pack_snapshot(state, tenants, epoch: int, map_version: int = 0) -> bytes:
    """Serialize ``tenants``' rows of a host-side fleet (leaves on the CPU:
    tensors or numpy arrays; the caller fetches the fleet once an epoch)
    into one CRC-framed npz blob.

    ``map_version`` stamps the shard-map regime the publisher believed it
    owned these tenants under — the fencing token a revived host with a
    stale map cannot forge (it can only hold an OLD version).
    """
    tenants = [int(t) for t in tenants]
    counts = np.ascontiguousarray(_host(state.counts)[tenants])
    stats = np.stack([_host(state.n)[tenants],
                      _host(state.welford_mean)[tenants],
                      _host(state.welford_m2)[tenants]]).astype(np.float32)
    manifest = {
        "epoch": int(epoch),
        "map_version": int(map_version),
        "tenants": tenants,
        "count_dtype": str(counts.dtype),
        "crc_counts": _crc(counts),
        "crc_stats": _crc(stats),
    }
    buf = io.BytesIO()
    np.savez(buf, counts=counts, stats=stats,
             manifest=np.frombuffer(json.dumps(manifest).encode(),
                                    np.uint8))
    return buf.getvalue()


def unpack_snapshot(blob: bytes) -> tuple[int, dict[int, AceState], int]:
    """(epoch, tenant → AceState with numpy leaves, map_version).  Raises
    :class:`SnapshotCorrupt` on any framing/CRC mismatch, before any state
    is built.  Blobs packed before version fencing carry ``map_version``
    0."""
    try:
        with np.load(io.BytesIO(blob)) as z:
            manifest = json.loads(bytes(z["manifest"]).decode())
            counts, stats = z["counts"], z["stats"]
    except Exception as e:
        raise SnapshotCorrupt(f"unreadable snapshot blob ({e})") from e
    if (_crc(counts) != manifest["crc_counts"]
            or _crc(stats) != manifest["crc_stats"]):
        raise SnapshotCorrupt("snapshot CRC mismatch")
    if counts.shape[0] != len(manifest["tenants"]) \
            or stats.shape != (3, len(manifest["tenants"])):
        raise SnapshotCorrupt("snapshot shape/manifest mismatch")
    states = {}
    for i, t in enumerate(manifest["tenants"]):
        states[int(t)] = AceState(
            counts=counts[i], n=np.float32(stats[0, i]),
            welford_mean=np.float32(stats[1, i]),
            welford_m2=np.float32(stats[2, i]))
    return (int(manifest["epoch"]), states,
            int(manifest.get("map_version", 0)))


def ace_on(ace: AceState, device) -> AceState:
    """A host ``AceState`` (numpy or tensor leaves) on ``device``: counts
    in their own dtype, the moments as float32 scalars."""
    def scalar(v):
        return torch.tensor(float(np.asarray(_host(v), np.float32)),
                            dtype=torch.float32, device=device)
    return AceState(counts=torch.as_tensor(_host(ace.counts), device=device),
                    n=scalar(ace.n), welford_mean=scalar(ace.welford_mean),
                    welford_m2=scalar(ace.welford_m2))


def snapshot_healthy(ace: AceState, device="cpu") -> bool:
    """Semantic gate (run BEFORE any install): the resilience invariants —
    per-table count conservation against n, finite moments — checked by
    ``repro_torch.resilience.health_check`` on ``device``.  A bit-flip
    applied before serialization has valid CRCs and fails exactly here."""
    from repro_torch.resilience import health_check
    return bool(health_check(ace_on(ace, device)).ok)


class GossipBus:
    """Per-host publish/fetch of epoch snapshots over a ControlStore.

    ``keep`` epochs stay resident per host (older blobs are deleted at
    publish time); ``published_bytes`` accounts the control-plane traffic.

    **Version fencing**: a host revived with a stale shard map holds an
    OLD ``map_version`` and an old epoch counter.  Every publish carries
    the publisher's map version, and a per-host fence key records the
    high-water ``(map_version, epoch)`` ever published: a publish that
    does not advance it is a counted no-op (``stale_publishes``), and
    ``latest`` refuses blobs below the fenced version even if one was
    raced into the store.
    """

    def __init__(self, store, host: str, keep: int = 2):
        self._store = store
        self._host = host
        self._keep = max(int(keep), 1)
        self.published_bytes = 0
        self.published_epochs = 0
        self.stale_publishes = 0   # fenced-off (rejected) publish calls

    def _fence(self, host: str) -> tuple[int, int]:
        """High-water (map_version, epoch) published by ``host``, read from
        the STORE: a revived host builds a fresh bus and must still see its
        own pre-death mark."""
        raw = self._store.get(f"gossip/{host}/fence")
        if raw is None:
            return (-1, -1)
        ver, _, ep = str(raw).partition(":")
        return (int(ver), int(ep))

    def publish(self, epoch: int, state, tenants, map_version: int = 0,
                blob: bytes | None = None) -> int:
        """Publish owned tenants' sketches for ``epoch`` (``blob``: their
        snapshot when the caller packed it already); returns the blob's
        bytes, or 0 when the publish is FENCED: ``(map_version, epoch)``
        must strictly advance the host's high-water mark."""
        fence = self._fence(self._host)
        if (int(map_version), int(epoch)) <= fence:
            self.stale_publishes += 1
            return 0
        if blob is None:
            blob = pack_snapshot(state, tenants, epoch,
                                 map_version=map_version)
        self._store.set_bytes(f"gossip/{self._host}/{epoch}", blob)
        # pointer flips LAST — readers never chase a half-written blob
        self._store.set(f"gossip/{self._host}/latest", str(epoch))
        self._store.set(f"gossip/{self._host}/fence",
                        f"{int(map_version)}:{int(epoch)}")
        self._store.delete(f"gossip/{self._host}/{epoch - self._keep}")
        self.published_bytes += len(blob)
        self.published_epochs += 1
        return len(blob)

    def latest(self, host: str) -> tuple[int, dict[int, AceState], int] | None:
        """The newest intact NON-STALE snapshot ``host`` published, or None.
        A corrupt newest blob falls back to the previous kept epoch; a blob
        stamped below the host's fenced map version is refused the same
        way."""
        ptr = self._store.get(f"gossip/{host}/latest")
        if ptr is None:
            return None
        fence_ver = self._fence(host)[0]
        epoch = int(ptr)
        for e in range(epoch, epoch - self._keep, -1):
            blob = self._store.get_bytes(f"gossip/{host}/{e}")
            if blob is None:
                continue
            try:
                got = unpack_snapshot(blob)
            except SnapshotCorrupt:
                continue
            if got[2] < fence_ver:
                continue
            return got
        return None
