"""ClusterNode: one host's slice of a fault-tolerant multi-host fleet —
port of ``repro.cluster.node``.

Every host holds a FULL (T, L, 2^K) fleet allocation on its device but
serves only the tenants the current :class:`~.shard.ShardMap` assigns
it; ownership is pure routing (the fleet step's ``tenant_mask``), so
re-sharding never reshapes device buffers, it re-points requests and
warm-restores rows.

The control plane is synchronous — three host-side calls the serving
loop interleaves between chunks:

* ``ingest_chunk``: the hot path.  One chunk through the unchanged fleet
  stream step (``StreamRunner.consume``: per batch one ``srp_hash``, one
  ``ace_query_sum`` and one ``ace_update`` at the tenants' base rows,
  ``kops.ace_fleet_admit_at``), ownership-masked; one host-to-device copy
  of the chunk and one device-to-host copy of its summary and keep masks.
  The heartbeat rides it; every ``epoch_chunks`` chunks an epoch boundary
  fetches the fleet once, publishes the owned rows' gossip and (every
  ``ckpt_every_epochs``) saves a CRC'd checkpoint of the fleet.
* ``control_step``: poll heartbeats; the acting coordinator (lowest live
  host id) publishes a successor shard map when someone died; everyone
  applies newer maps, adopting gained tenants from the previous owner's
  last gossiped snapshot and/or newest intact checkpoint — the intact
  candidate of the newest map regime, then the largest n — each gated by
  ``resilience.health_check`` before it touches the fleet.
* ``try_rejoin``: a host the cluster declared dead (or a cold restart)
  re-enters through attempt-bounded exponential backoff; the coordinator
  re-adds it, and HRW moves back only the tenants it wins.

A host that applies a newer map beats at once at its version, and keeps
beating (at most once a heartbeat interval) between the steps of an
adoption: the coordinator gives a re-admitted host one failure timeout
from its first poll, and an adoption slower than that (a slow store, a
large checkpoint) would otherwise get it declared dead again.  The
reference's node writes no beat from applying a map until its adoption
is done.

A dead host's tenants lose at most the partial epoch since its last
publish; every surviving tenant's state is BITWISE untouched (tenant
isolation + ownership masking), so survivors stay parity-exact with a
never-failed run.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.cluster.gossip import (GossipBus, ace_on, pack_snapshot,
                                        snapshot_healthy)
from repro_torch.cluster.membership import (FailureDetector, HeartbeatWriter,
                                            MembershipConfig, RejoinPolicy)
from repro_torch.cluster.shard import ShardMap, with_host, without_host
from repro_torch.core import srp
from repro_torch.core.sketch import AceState
from repro_torch.fleet import state as fl
from repro_torch.fleet.filter import FleetDataFilter
from repro_torch.fleet.state import FleetState
from repro_torch.stream.runner import FleetChunkSummary, StreamRunner
from repro_torch.train import checkpoint as ckpt

_MAP_KEY = "shardmap"

# A chunk's summary and keep masks, fetched in one transfer.
_Served = collections.namedtuple(
    "_Served", FleetChunkSummary._fields + ("keeps",),
    defaults=(None,) * (len(FleetChunkSummary._fields) + 1))


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Static per-host cluster configuration (every host gets the same
    values except ``host_id``); the reference's fields."""

    host_id: str
    hosts: tuple[str, ...]            # the configured host universe
    num_tenants: int
    d_model: int = 16
    num_bits: int = 6
    num_tables: int = 8
    alpha: float = 4.0
    warmup_items: float = 64.0
    hash_mode: str = "dense"
    insert_all: bool = False
    count_dtype: str = "int32"
    chunk_T: int = 8                  # batches per ingest chunk
    epoch_chunks: int = 2             # chunks per epoch (gossip cadence)
    gossip_keep: int = 2
    ckpt_root: str | None = None      # shared fs root; None = no ckpts
    ckpt_every_epochs: int = 1
    ckpt_keep: int = 3
    membership: MembershipConfig = MembershipConfig()

    def __post_init__(self):
        if self.host_id not in self.hosts:
            raise ValueError(
                f"host_id {self.host_id!r} not in hosts {self.hosts}")
        if self.epoch_chunks < 1:
            raise ValueError("epoch_chunks must be >= 1")


def fetch_fleet(state: FleetState) -> FleetState:
    """A copy of the fleet on the host (CPU tensors): the epoch boundary's
    one fetch, counted apart from the chunks' transfers.  Always a copy:
    the stream step updates the counts in place, and a CPU fleet's
    ``.cpu()`` would alias them."""
    return FleetState(*(None if v is None
                        else v.detach().to("cpu", copy=True)
                        for v in state))


class ClusterNode:
    """One host of the fleet cluster (see the module docstring).  The fleet
    lives on ``device``: the card unless the caller passes ``"cpu"``.

    ``boundary_ms`` holds, for each epoch boundary, the host-clock ms of
    its four parts: the fleet's fetch (``d2h``), packing the owned rows
    with their CRCs (``pack``), the store writes (``publish``) and the
    checkpoint (``ckpt``, 0 without one)."""

    def __init__(self, cfg: ClusterConfig, store, clock=time.monotonic, *,
                 device=None):
        self.cfg = cfg
        self.store = store
        self.clock = clock
        self.device = resolve_device(device)
        self.filt = FleetDataFilter(
            d_model=cfg.d_model, num_tenants=cfg.num_tenants,
            num_bits=cfg.num_bits, num_tables=cfg.num_tables,
            alpha=cfg.alpha, warmup_items=cfg.warmup_items,
            hash_mode=cfg.hash_mode, insert_all=cfg.insert_all,
            count_dtype=cfg.count_dtype, device=self.device)
        self.runner = StreamRunner(self.filt, chunk_T=cfg.chunk_T,
                                   return_masks=True)
        self.state, self.w = self.runner.init()
        self.map = ShardMap(version=0, hosts=cfg.hosts,
                            num_tenants=cfg.num_tenants)
        self._mask = self._tenant_mask()
        self.heartbeat = HeartbeatWriter(store, cfg.host_id,
                                         cfg.membership, clock)
        self.heartbeat.version = self.map.version
        self.detector = FailureDetector(store, cfg.membership, clock)
        self.gossip = GossipBus(store, cfg.host_id, keep=cfg.gossip_keep)
        self.chunk_idx = 0
        self.epoch = 0
        self.adoptions: list[dict] = []   # observability + test probes
        self.boundary_ms: list[dict] = []
        self.heartbeat.beat()
        # v0 is derivable by every host from the config, but publishing
        # it seeds the store for late joiners and external observers.
        if self.coordinator:
            self._publish_map(self.map)

    # -- identity ----------------------------------------------------------

    @property
    def coordinator(self) -> bool:
        """Acting coordinator = lowest host id in the CURRENT map."""
        return self.map.hosts[0] == self.cfg.host_id

    def owned(self) -> tuple[int, ...]:
        return self.map.owned_by(self.cfg.host_id)

    def _tenant_mask(self) -> torch.Tensor:
        return torch.as_tensor(self.map.tenant_mask(self.cfg.host_id),
                               device=self.device)

    # -- hot path ----------------------------------------------------------

    def _upload(self, feats, tenant_ids):
        """The chunk on the device: host arrays in ONE copy (features and
        ids packed, ``StreamRunner``'s fleet upload), tensors as they are
        (moved when they lie elsewhere)."""
        if isinstance(feats, torch.Tensor):
            return (feats.to(self.device),
                    torch.as_tensor(tenant_ids, device=self.device)
                    .to(torch.int32))
        feats = np.asarray(feats, np.float32)
        tids = np.asarray(tenant_ids, np.int32)
        return self.runner._upload_fleet(list(feats), list(tids))

    def ingest_chunk(self, feats, tenant_ids):
        """Serve one (chunk_T, B, d+1) feature chunk of mixed-tenant
        batches with its (chunk_T, B) tenant ids.  Returns (summary, keeps)
        on the host: the ``FleetChunkSummary`` and the (chunk_T, B) keep
        masks, fetched together in one transfer.  Epoch boundaries (every
        ``epoch_chunks`` chunks) publish gossip and checkpoints."""
        self.heartbeat.maybe_beat()
        feats, tids = self._upload(feats, tenant_ids)
        self.state, summary, keeps = self.runner.consume(
            self.state, self.w, feats, tids, tenant_mask=self._mask)
        host = self.runner.fetch(_Served(*summary, keeps=keeps))
        self.chunk_idx += 1
        if self.chunk_idx % self.cfg.epoch_chunks == 0:
            self._epoch_boundary()
        return FleetChunkSummary(*host[:-1]), host.keeps

    def probe_scores(self, feats, tenant_ids) -> np.ndarray:
        """Score WITHOUT inserting (read-only serving probe): the plain hash
        and the tenant-routed gather, as in the reference."""
        feats = torch.as_tensor(np.asarray(feats, np.float32),
                                device=self.device)
        tids = torch.as_tensor(np.asarray(tenant_ids, np.int32),
                               device=self.device)
        buckets = srp.hash_buckets(feats, self.w, self.filt.ace_cfg.srp)
        return fl.fleet_scores(self.state, tids, buckets).cpu().numpy()

    def _epoch_boundary(self) -> None:
        self.epoch += 1
        t0 = time.perf_counter()
        host = fetch_fleet(self.state)
        t1 = time.perf_counter()
        owned = self.owned()
        blob = pack_snapshot(host, owned, self.epoch,
                             map_version=self.map.version)
        t2 = time.perf_counter()
        self.gossip.publish(self.epoch, host, owned,
                            map_version=self.map.version, blob=blob)
        t3 = time.perf_counter()
        if (self.cfg.ckpt_root
                and self.epoch % self.cfg.ckpt_every_epochs == 0):
            ckpt.save(self._ckpt_dir(self.cfg.host_id), self.epoch, host,
                      keep=self.cfg.ckpt_keep,
                      extra={"map_version": self.map.version})
        t4 = time.perf_counter()
        self.boundary_ms.append({
            "d2h": 1e3 * (t1 - t0), "pack": 1e3 * (t2 - t1),
            "publish": 1e3 * (t3 - t2), "ckpt": 1e3 * (t4 - t3),
            "bytes": len(blob)})

    # -- control plane -----------------------------------------------------

    def control_step(self) -> list[str]:
        """One failure-detection/re-shard turn; returns hosts newly
        declared dead this turn (already re-sharded away if this node is
        the acting coordinator)."""
        self.heartbeat.maybe_beat()
        self._apply_newer_map()
        peers = [h for h in self.map.hosts if h != self.cfg.host_id]
        dead = self.detector.poll(peers)
        if dead:
            alive = [h for h in self.map.hosts if h not in dead]
            # the acting coordinator AFTER the deaths publishes — so a
            # dead coordinator cannot block its own replacement
            if alive and alive[0] == self.cfg.host_id:
                new_map = self.map
                for h in dead:
                    new_map = without_host(new_map, h)
                self._publish_map(new_map)
                self._apply_newer_map()
        if self.coordinator:
            self._admit_joiners()
        return dead

    def request_rejoin(self) -> None:
        self.store.set(f"join/{self.cfg.host_id}", str(self.map.version))

    def try_rejoin(self, policy: RejoinPolicy | None = None,
                   sleep=time.sleep) -> bool:
        """Re-enter the cluster after being declared dead: request admission
        and wait with attempt-bounded exponential backoff until a map
        containing this host appears.  False when the budget is spent."""
        policy = policy or RejoinPolicy()
        while True:
            self._apply_newer_map()
            if self.cfg.host_id in self.map.hosts:
                policy.reset()
                return True
            delay = policy.next_delay()
            if delay is None:
                return False
            self.request_rejoin()
            self.heartbeat.beat()     # prove liveness to the admitter
            sleep(delay)

    def _admit_joiners(self) -> None:
        for host in self.cfg.hosts:
            if host in self.map.hosts:
                continue
            if self.store.get(f"join/{host}") is None:
                continue
            self.detector.forget(host)     # fresh grace window
            self._publish_map(with_host(self.map, host))
            self.store.delete(f"join/{host}")
            self._apply_newer_map()

    def _publish_map(self, m: ShardMap) -> None:
        cur = self._read_map()
        if cur is None or m.version > cur.version:
            self.store.set(_MAP_KEY, m.to_json())

    def _read_map(self) -> ShardMap | None:
        blob = self.store.get(_MAP_KEY)
        return None if blob is None else ShardMap.from_json(blob)

    def _apply_newer_map(self) -> None:
        m = self._read_map()
        if m is None or m.version <= self.map.version:
            return
        prev = self.map
        old_owned = set(prev.owned_by(self.cfg.host_id))
        self.map = m
        self.heartbeat.version = m.version   # beats carry the new regime
        self.heartbeat.beat()                # ... from now on
        for host in set(prev.hosts) - set(m.hosts):
            self.detector.forget(host)
        gained = sorted(set(self.owned()) - old_owned)
        if gained:
            by_prev: dict[str, list[int]] = {}
            for t in gained:
                by_prev.setdefault(prev.owner_of(t), []).append(t)
            for prev_host, tenants in by_prev.items():
                if prev_host != self.cfg.host_id:
                    self._adopt(tenants, prev_host)
        self._mask = self._tenant_mask()

    # -- adoption (warm restore of re-homed tenants) -----------------------

    def _adopt(self, tenants, prev_host: str) -> None:
        """Install ``tenants``' sketches from ``prev_host``'s last gossiped
        snapshot and/or newest intact checkpoint — per tenant, the intact
        candidate from the NEWEST shard-map regime wins, ties broken by the
        most stream absorbed (max n); candidates failing
        ``resilience.health_check`` on this node's device are refused.
        Version outranks n: a stale revived host can carry a LARGER n from
        a divergent timeline, and only the map version fences it.  With no
        intact candidate the tenant cold-starts (zero row, fresh warmup)."""
        snap = self.gossip.latest(prev_host)
        self.heartbeat.maybe_beat()          # alive while it adopts
        peer_ckpt = self._restore_peer_ckpt(prev_host)
        for t in tenants:
            self.heartbeat.maybe_beat()
            cands = []
            if snap is not None and t in snap[1]:
                ace = snap[1][t]
                if snapshot_healthy(ace, self.device):
                    cands.append(("gossip", snap[0], ace, snap[2]))
            if peer_ckpt is not None:
                epoch, fleet, ver = peer_ckpt
                ace = AceState(counts=fleet.counts[t], n=fleet.n[t],
                               welford_mean=fleet.welford_mean[t],
                               welford_m2=fleet.welford_m2[t])
                if snapshot_healthy(ace, self.device):
                    cands.append(("checkpoint", epoch, ace, ver))
            record = {"tenant": t, "from_host": prev_host,
                      "at_epoch": self.epoch, "at_chunk": self.chunk_idx,
                      "map_version": self.map.version}
            if not cands:
                self.adoptions.append({**record, "source": "cold",
                                       "source_epoch": None, "n": 0.0})
                continue
            source, src_epoch, ace, _ = max(
                cands, key=lambda c: (int(c[3]), float(c[2].n)))
            dev = ace_on(ace, self.device)
            self.state = fl.set_tenant(self.state, t, dev._replace(
                counts=dev.counts.to(self.state.counts.dtype)))
            self.adoptions.append({**record, "source": source,
                                   "source_epoch": src_epoch,
                                   "n": float(ace.n)})

    def _restore_peer_ckpt(self, host: str):
        """(epoch, FleetState on the CPU, map_version) from ``host``'s
        newest INTACT checkpoint (torn or flipped steps are skipped), or
        None.  Checkpoints live on a shared filesystem root; a deployment
        without one leans on gossip alone.  Checkpoints without a map
        version read as version 0."""
        if not self.cfg.ckpt_root:
            return None
        mgr = ckpt.CheckpointManager(self._ckpt_dir(host),
                                     keep=self.cfg.ckpt_keep)
        tree, manifest = mgr.restore_latest(
            fl.init(self.filt.fleet_cfg, "cpu"))
        if tree is None:
            return None
        ver = int((manifest.get("extra") or {}).get("map_version", 0))
        return int(manifest["step"]), tree, ver

    def _ckpt_dir(self, host: str) -> str:
        return os.path.join(self.cfg.ckpt_root, host)
