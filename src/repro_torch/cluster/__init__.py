"""repro_torch.cluster — fault-tolerant multi-host fleet serving, port of
``repro.cluster``.

The sketch's mergeability (counts add, moments merge by Chan's rule)
makes a peer's copy a valid warm restore, so host failure is a
degraded-but-serving event instead of an outage:

* tenants shard across hosts by rendezvous hashing (``shard``: minimal
  movement on any membership change),
* each host gossips its owned tenants' sketches at epoch boundaries and
  checkpoints its fleet with CRCs (``gossip`` + ``train.checkpoint``),
* heartbeat-timeout failure detection re-shards a dead host's tenants
  onto survivors, warm-restored from the last intact gossip/checkpoint,
  every candidate health-checked before install (``membership``,
  ``node``),
* declared-dead hosts re-enter through attempt-bounded exponential
  backoff (``membership.RejoinPolicy``).

Control traffic rides a key/value store (``kv``): a ``torch.distributed``
``TCPStore`` across processes, a dict in one.  The hot path stays the
unchanged fleet stream step on the card, ownership-masked.
"""
from repro_torch.cluster.gossip import (GossipBus, SnapshotCorrupt,
                                        pack_snapshot, snapshot_healthy,
                                        unpack_snapshot)
from repro_torch.cluster.kv import DistributedStore, MemStore
from repro_torch.cluster.membership import (FailureDetector, HeartbeatWriter,
                                            MembershipConfig, RejoinPolicy)
from repro_torch.cluster.node import ClusterConfig, ClusterNode
from repro_torch.cluster.shard import (ShardMap, rendezvous_owner, with_host,
                                       without_host)

__all__ = [
    "ClusterConfig", "ClusterNode", "DistributedStore", "FailureDetector",
    "GossipBus", "HeartbeatWriter", "MemStore", "MembershipConfig",
    "RejoinPolicy", "ShardMap", "SnapshotCorrupt", "pack_snapshot",
    "rendezvous_owner", "snapshot_healthy", "unpack_snapshot",
    "with_host", "without_host",
]
