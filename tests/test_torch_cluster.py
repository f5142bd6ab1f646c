"""The port's cluster (``repro_torch.cluster``) against the reference's
(``repro.cluster``), in one process on the CPU, with ``MemStore`` and a
fake clock: the cases of ``tests/test_cluster.py``'s ``TestShardMap``,
``TestMembership``, ``TestGossip`` and ``TestNodeFailover``.

* Sharding: the HRW owner of every (tenant, hosts) pair and the
  ``ShardMap`` JSON are the reference's, byte for byte.
* Membership: the reference's state machines, step for step.
* Gossip: a blob packed by either package unpacks in the other, bitwise;
  CRC and health gates refuse what the reference's refuse.
* Failover: each scenario runs a port node pair and a reference node pair
  in lockstep on the same chunks (numpy-made features, the reference's W
  carried across before the first chunk): owners, adoptions (tenant,
  source, epoch, n), counts and n bitwise and the keep masks equal; the
  Welford moments at rtol 1e-6 (batch sums in PyTorch's order here, in
  XLA's there).  On the CPU every kernel wrapper takes its plain version.
"""
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

import repro.cluster as jcl  # noqa: E402
from repro.resilience import inject as jinject  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch import cluster as cl  # noqa: E402
from repro_torch.cluster import gossip as gossip_mod  # noqa: E402
from repro_torch.cluster import node as node_mod  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402
from repro_torch.core.sketch import AceState  # noqa: E402
from repro_torch.fleet.filter import FleetDataFilter  # noqa: E402
from repro_torch.fleet.state import FleetState  # noqa: E402
from repro_torch.resilience import inject  # noqa: E402
from repro_torch.stream import runner as runner_mod  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

CPU = torch.device("cpu")


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def test_exports_the_reference_names():
    assert sorted(cl.__all__) == sorted(jcl.__all__)
    for name in cl.__all__:
        assert hasattr(cl, name)


# ---------------------------------------------------------------------------
# sharding
# ---------------------------------------------------------------------------

HOST_SETS = [("h0",), ("h0", "h1"), ("h1", "h0", "h2"),
             ("h0", "h1", "h2", "h3"), ("alpha", "beta", "gamma", "delta",
                                        "eps")]


class TestShardMap:
    HOSTS = ("h0", "h1", "h2", "h3")

    @pytest.mark.parametrize("hosts", HOST_SETS, ids=len)
    def test_owners_and_json_equal_the_reference(self, hosts):
        m = cl.ShardMap(version=3, hosts=hosts, num_tenants=64)
        jm = jcl.ShardMap(version=3, hosts=hosts, num_tenants=64)
        for t in range(64):
            assert cl.rendezvous_owner(t, hosts) \
                == jcl.rendezvous_owner(t, hosts)
            assert m.owner_of(t) == jm.owner_of(t)
        assert m.to_json().encode() == jm.to_json().encode()
        assert cl.ShardMap.from_json(jm.to_json()) == m
        np.testing.assert_array_equal(m.tenant_mask(hosts[0]),
                                      jm.tenant_mask(hosts[0]))
        for h in hosts:
            assert m.owned_by(h) == jm.owned_by(h)

    @pytest.mark.parametrize("hosts", HOST_SETS[1:], ids=len)
    def test_with_and_without_host_equal_the_reference(self, hosts):
        m = cl.ShardMap(version=0, hosts=hosts, num_tenants=48)
        jm = jcl.ShardMap(version=0, hosts=hosts, num_tenants=48)
        dead = hosts[-1]
        a, ja = cl.without_host(m, dead), jcl.without_host(jm, dead)
        assert a.to_json() == ja.to_json()
        b, jb = cl.with_host(a, dead), jcl.with_host(ja, dead)
        assert b.to_json() == jb.to_json()
        for t in range(48):
            # minimal movement: only the dead host's tenants move, and a
            # rejoin restores the original split
            if m.owner_of(t) != dead:
                assert a.owner_of(t) == m.owner_of(t)
            assert b.owner_of(t) == m.owner_of(t)
        assert cl.with_host(b, dead) is b

    def test_partition_balance_and_validation(self):
        m = cl.ShardMap(version=0, hosts=self.HOSTS, num_tenants=256)
        owned = [m.owned_by(h) for h in self.HOSTS]
        assert sorted(t for o in owned for t in o) == list(range(256))
        assert min(map(len, owned)) >= 256 // len(self.HOSTS) // 3
        masks = np.stack([m.tenant_mask(h) for h in self.HOSTS])
        assert masks.dtype == np.float32
        assert np.array_equal(masks.sum(axis=0), np.ones(256))
        with pytest.raises(ValueError):
            cl.ShardMap(version=0, hosts=("h0", "h0"), num_tenants=4)
        with pytest.raises(ValueError):
            cl.ShardMap(version=0, hosts=(), num_tenants=4)
        with pytest.raises(ValueError):
            cl.rendezvous_owner(0, ())


# ---------------------------------------------------------------------------
# membership
# ---------------------------------------------------------------------------

def _both(fn):
    """Run ``fn(pkg)`` on the port's cluster and on the reference's and
    return both results."""
    return fn(cl), fn(jcl)


class TestMembership:
    def _cfg(self, pkg, interval=0.2, timeout=1.0):
        return pkg.MembershipConfig(heartbeat_interval=interval,
                                    failure_timeout=timeout)

    def test_config_validation(self):
        with pytest.raises(ValueError):
            cl.MembershipConfig(heartbeat_interval=1.0, failure_timeout=0.5)

    def test_maybe_beat_rate_limits(self):
        def run(pkg):
            clock, store = FakeClock(), pkg.MemStore()
            hb = pkg.HeartbeatWriter(store, "h0", self._cfg(pkg), clock)
            out = [hb.maybe_beat(), hb.maybe_beat()]
            clock.advance(0.25)
            out.append(hb.maybe_beat())
            return out, store.get("hb/h0")
        got, want = _both(run)
        assert got == want == ([True, False, True], "2:0")

    def test_detector_death_grace_and_forget(self):
        def run(pkg):
            clock, store = FakeClock(), pkg.MemStore()
            hb = pkg.HeartbeatWriter(store, "h1", self._cfg(pkg), clock)
            det = pkg.FailureDetector(store, self._cfg(pkg), clock)
            hb.beat()
            out = [det.poll(["h1"])]
            for dt in (0.9, 0.2):
                clock.advance(dt)
                out.append(det.poll(["h1"]))
            hb.beat()
            out += [det.poll(["h1"]), det.poll(["ghost"])]
            clock.advance(1.1)
            out.append(det.poll(["ghost", "h1"]))
            det.forget("h1")
            out.append(det.poll(["h1"]))
            return out
        got, want = _both(run)
        assert got == want
        assert got[2] == ["h1"] and got[5] == ["ghost", "h1"]

    def test_stale_version_beats_do_not_reset_liveness(self):
        def run(pkg):
            clock, store = FakeClock(), pkg.MemStore()
            cfg = self._cfg(pkg)
            hb = pkg.HeartbeatWriter(store, "h1", cfg, clock)
            det = pkg.FailureDetector(store, cfg, clock)
            hb.version = 3
            hb.beat()
            out = [det.poll(["h1"])]
            clock.advance(0.5)
            hb.beat()
            out.append(det.poll(["h1"]))
            zombie = pkg.HeartbeatWriter(store, "h1", cfg, clock)
            zombie.version = 1
            for _ in range(4):
                clock.advance(0.4)
                zombie.beat()
                out.append(det.poll(["h1"]))
            zombie.version = 3
            clock.advance(0.4)
            zombie.beat()
            out.append(det.poll(["h1"]))
            # legacy bare-seq beats read as version 0
            store.set("hb/h2", "1")
            out.append(det.poll(["h2"]))
            clock.advance(1.1)
            out.append(det.poll(["h2"]))
            return out
        got, want = _both(run)
        assert got == want
        assert ["h1"] in got[2:6] and got[6] == [] and got[-1] == ["h2"]

    def test_rejoin_policy_bounded_backoff(self):
        def run(pkg):
            pol = pkg.RejoinPolicy(max_attempts=4, base_delay=0.1,
                                   max_delay=0.5)
            delays = [pol.next_delay() for _ in range(5)]
            pol.reset()
            return delays + [pol.next_delay()]
        got, want = _both(run)
        assert got == want == [0.1, 0.2, 0.4, 0.5, None, 0.1]


# ---------------------------------------------------------------------------
# gossip
# ---------------------------------------------------------------------------

def _host_fleet(count_dtype="int32", T=4, seed=0):
    """A host fleet of T tenants (numpy leaves, as both packages' pack
    takes them), fed by the port's filter on the CPU."""
    filt = FleetDataFilter(d_model=6, num_tenants=T, num_bits=5,
                           num_tables=4, warmup_items=16.0, insert_all=True,
                           count_dtype=count_dtype, device="cpu")
    state, w = filt.init()
    rng = np.random.default_rng(seed)
    for t in range(T):
        for _ in range(2):
            x = torch.from_numpy(rng.normal(size=(16, 1, 6))
                                 .astype(np.float32))
            state, _, _ = filt.step(state, w, filt.features(x),
                                    torch.full((16,), t, dtype=torch.int32))
    return FleetState(*(None if v is None else v.numpy() for v in state))


def _assert_snapshot(states, host, tenants):
    assert set(states) == set(tenants)
    for t in tenants:
        np.testing.assert_array_equal(states[t].counts, host.counts[t])
        assert states[t].counts.dtype == host.counts.dtype
        for f in ("n", "welford_mean", "welford_m2"):
            assert np.float32(getattr(states[t], f)) \
                == np.float32(getattr(host, f)[t])


class TestGossip:
    @pytest.mark.parametrize("count_dtype", ["int32", "int16", "int8"])
    def test_blobs_cross_packages_both_ways(self, count_dtype):
        host = _host_fleet(count_dtype)
        ours = cl.pack_snapshot(host, [1, 3], epoch=5, map_version=7)
        theirs = jcl.pack_snapshot(host, [1, 3], epoch=5, map_version=7)
        for blob in (ours, theirs):
            for unpack in (cl.unpack_snapshot, jcl.unpack_snapshot):
                epoch, states, ver = unpack(blob)
                assert (epoch, ver) == (5, 7)
                _assert_snapshot(states, host, [1, 3])
        # the same arrays and manifest: only the zip's timestamps may differ
        assert len(ours) == len(theirs)

    def test_pack_takes_cpu_tensors(self):
        host = _host_fleet()
        tensors = FleetState(*(None if v is None else torch.from_numpy(v)
                               for v in host))
        _, states, _ = cl.unpack_snapshot(
            cl.pack_snapshot(tensors, [0, 2], epoch=1))
        _assert_snapshot(states, host, [0, 2])

    def test_transport_corruption_rejected(self):
        blob = cl.pack_snapshot(_host_fleet(), [0, 1], epoch=1)
        with pytest.raises(cl.SnapshotCorrupt):
            cl.unpack_snapshot(blob[:-40])
        flipped = bytearray(blob)
        flipped[len(flipped) // 2] ^= 0xFF
        with pytest.raises(cl.SnapshotCorrupt):
            cl.unpack_snapshot(bytes(flipped))
        with pytest.raises(jcl.SnapshotCorrupt):
            jcl.unpack_snapshot(bytes(flipped))

    def test_preserialization_bitflip_passes_crc_fails_health(self):
        host = _host_fleet()
        _, good, _ = cl.unpack_snapshot(cl.pack_snapshot(host, [0], 1))
        assert cl.snapshot_healthy(good[0])
        assert jcl.snapshot_healthy(good[0])
        bad_counts = host.counts.copy()
        bad_counts[0] = inject.flip_count_bits(
            torch.from_numpy(bad_counts[0]),
            torch.Generator().manual_seed(0), num_flips=4).numpy()
        blob = cl.pack_snapshot(host._replace(counts=bad_counts), [0], 2)
        _, states, _ = cl.unpack_snapshot(blob)     # CRC passes
        assert not cl.snapshot_healthy(states[0])
        assert not jcl.snapshot_healthy(states[0])  # the reference agrees

    def test_bus_retention_fallback_and_fencing(self):
        def run(pkg):
            store, host = pkg.MemStore(), _host_fleet()
            bus = pkg.GossipBus(store, "h0", keep=2)
            for e in range(1, 5):
                bus.publish(e, host, [0, 1], map_version=1)
            out = [bus.published_epochs, bus.latest("h0")[0],
                   [k for k in store.keys("gossip/h0/")
                    if not k.endswith(("latest", "fence"))]]
            store.set_bytes("gossip/h0/4", b"garbage" + bytes(64))
            out.append(bus.latest("h0")[0])           # falls back to 3
            zombie = pkg.GossipBus(store, "h0", keep=2)
            out += [zombie.publish(2, host, [0], map_version=0),
                    zombie.publish(5, host, [0], map_version=0),
                    zombie.publish(4, host, [0], map_version=1),
                    zombie.stale_publishes]
            # a stale blob raced in below the fence is skipped
            store.set_bytes("gossip/h0/5", pkg.pack_snapshot(
                host, [1], epoch=5, map_version=0))
            store.set("gossip/h0/latest", "5")
            out.append(pkg.GossipBus(store, "h1", keep=3).latest("h0")[0])
            out.append(pkg.GossipBus(pkg.MemStore(), "h0").latest("nobody"))
            return out
        got, want = _both(run)
        assert got == want
        assert got[2] == ["gossip/h0/3", "gossip/h0/4"] and got[3] == 3
        assert got[4:8] == [0, 0, 0, 3] and got[8] == 3


# ---------------------------------------------------------------------------
# node failover: the port and the reference in lockstep
# ---------------------------------------------------------------------------

def _cfg(pkg, host, root, **kw):
    base = dict(
        host_id=host, hosts=("h0", "h1"), num_tenants=8, d_model=6,
        num_bits=5, num_tables=4, warmup_items=16.0, insert_all=True,
        chunk_T=4, epoch_chunks=2, ckpt_root=root,
        membership=pkg.MembershipConfig(heartbeat_interval=0.2,
                                        failure_timeout=1.0))
    base.update(kw)
    return pkg.ClusterConfig(**base)


class Pair:
    """One node of the port and its reference twin, the port's on the
    reference's W, fed the same chunks."""

    def __init__(self, host, stores, clock, root, **kw):
        self.j = jcl.ClusterNode(
            _cfg(jcl, host, None if root is None else str(root / "ref"),
                 **kw), stores[1], clock)
        self.p = cl.ClusterNode(
            _cfg(cl, host, None if root is None else str(root / "port"),
                 **kw), stores[0], clock, device="cpu")
        self.p.w = params_from_numpy(np.asarray(self.j.w), CPU)

    def chunk(self, seed):
        """The reference test's chunk over the owned tenants (both nodes
        own the same), as numpy features and ids."""
        owned = self.p.owned()
        assert owned == self.j.owned()
        T, B, d = self.p.cfg.chunk_T, 8, self.p.cfg.d_model
        embeds, tids = [], []
        for j in range(T):
            t = owned[j % len(owned)]
            rng = np.random.default_rng(seed * 1000 + t)
            embeds.append(rng.normal(size=(B, 1, d)).astype(np.float32))
            tids.append(np.full((B,), t, np.int32))
        feats = np.asarray(self.j.filt.features(
            jnp.asarray(np.concatenate(embeds)))).reshape(T, B, d + 1)
        return feats, np.stack(tids)

    def ingest(self, seed):
        feats, tids = self.chunk(seed)
        _, keeps = self.p.ingest_chunk(feats, tids)
        _, jkeeps = self.j.ingest_chunk(jnp.asarray(feats), tids)
        np.testing.assert_array_equal(keeps, np.asarray(jkeeps))
        return keeps

    def epochs(self, n, seed0=0):
        for i in range(n * self.p.cfg.epoch_chunks):
            self.ingest(seed0 + i)

    def control_step(self):
        dead = self.p.control_step()
        assert dead == self.j.control_step()
        return dead

    def assert_equal(self):
        assert self.p.map.to_json() == self.j.map.to_json()
        assert self.p.owned() == self.j.owned()
        assert self.p.adoptions == self.j.adoptions
        assert (self.p.epoch, self.p.chunk_idx) \
            == (self.j.epoch, self.j.chunk_idx)
        got, want = self.p.state, jax.device_get(self.j.state)
        np.testing.assert_array_equal(got.counts.numpy(), want.counts)
        np.testing.assert_array_equal(got.n.numpy(), want.n)
        for f in ("welford_mean", "welford_m2"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       getattr(want, f), rtol=1e-6)


class TestNodeFailover:
    def _two(self, root, **kw):
        stores, clock = (cl.MemStore(), jcl.MemStore()), FakeClock()
        return (stores, clock, Pair("h0", stores, clock, root, **kw),
                Pair("h1", stores, clock, root, **kw))

    def _kill_and_detect(self, clock, n0):
        clock.advance(0.5)
        n0.control_step()      # observes h1's last value
        clock.advance(1.2)
        assert n0.control_step() == ["h1"]
        assert len(n0.p.owned()) == n0.p.cfg.num_tenants

    def test_gossip_adoption_exact_n(self, tmp_path):
        stores, clock, n0, n1 = self._two(tmp_path)
        n0.epochs(2)
        n1.epochs(2)
        h1 = n1.p.state
        self._kill_and_detect(clock, n0)
        n0.assert_equal()
        adopted = {a["tenant"]: a for a in n0.p.adoptions}
        assert set(adopted) == set(
            cl.ShardMap(0, ("h0", "h1"), 8).owned_by("h1"))
        for t, rec in adopted.items():
            assert (rec["source"], rec["source_epoch"]) == ("gossip", 2)
            assert float(n0.p.state.n[t]) == float(h1.n[t])
            assert torch.equal(n0.p.state.counts[t], h1.counts[t])
        # requests for adopted tenants now serve
        assert n0.ingest(99).shape == (n0.p.cfg.chunk_T, 8)
        n0.assert_equal()

    def test_untouched_tenants_stay_bitwise(self, tmp_path):
        """Tenants a host does not own are never inserted into, and a
        survivor's own tenants are bitwise those of a never-failed twin
        that saw the same chunks."""
        stores, clock, n0, n1 = self._two(tmp_path)
        n0.epochs(2)
        not_owned = [t for t in range(8) if t not in n0.p.owned()]
        assert not n0.p.state.counts[not_owned].any()
        assert not n0.p.state.n[not_owned].any()
        twin = cl.ClusterNode(_cfg(cl, "h0", None), cl.MemStore(),
                              FakeClock(), device="cpu")
        twin.w = n0.p.w
        for i in range(4):
            twin.ingest_chunk(*n0.chunk(i))
        for leaf in ("counts", "n", "welford_mean", "welford_m2"):
            assert torch.equal(getattr(twin.state, leaf),
                               getattr(n0.p.state, leaf))

    def test_checkpoint_fallback_with_torn_newest(self, tmp_path):
        stores, clock, n0, n1 = self._two(tmp_path)
        n1.epochs(3)     # checkpoints at epochs 1, 2, 3
        for store in stores:
            for k in list(store.keys("gossip/h1/")):
                store.delete(k)
        inject.tear_checkpoint(str(tmp_path / "port" / "h1"), 3)
        jinject.tear_checkpoint(str(tmp_path / "ref" / "h1"), 3)
        self._kill_and_detect(clock, n0)
        n0.assert_equal()
        assert n0.p.adoptions
        for rec in n0.p.adoptions:
            assert (rec["source"], rec["source_epoch"]) == ("checkpoint", 2)
            assert rec["n"] > 0

    def test_unhealthy_gossip_rejected_before_install(self, tmp_path):
        stores, clock, n0, n1 = self._two(tmp_path)
        n1.epochs(2)
        bad = n1.p.state.counts.clone()
        for t in n1.p.owned():
            bad[t] = inject.flip_count_bits(
                bad[t], torch.Generator().manual_seed(t), num_flips=2)
        host = node_mod.fetch_fleet(n1.p.state)._replace(counts=bad)
        for store, pkg in zip(stores, (cl, jcl)):   # one poisoned blob
            store.set_bytes("gossip/h1/3", pkg.pack_snapshot(
                host, n1.p.owned(), 3))
            store.set("gossip/h1/latest", "3")
        self._kill_and_detect(clock, n0)
        n0.assert_equal()
        assert n0.p.adoptions
        assert {r["source"] for r in n0.p.adoptions} == {"checkpoint"}

    def test_cold_start_when_no_candidates(self):
        stores, clock, n0, n1 = self._two(None)     # no ckpt_root
        self._kill_and_detect(clock, n0)           # before any epoch
        n0.assert_equal()
        assert n0.p.adoptions
        for rec in n0.p.adoptions:
            assert rec["source"] == "cold" and rec["n"] == 0.0
        n0.ingest(5)                               # degraded, serving
        n0.assert_equal()

    def test_rejoin_with_backoff(self, tmp_path):
        stores, clock, n0, n1 = self._two(tmp_path)
        n0.epochs(1)
        n1.epochs(1)
        self._kill_and_detect(clock, n0)
        back = Pair("h1", stores, clock, tmp_path)   # fresh process
        sleeps = ([], [])

        def sleeper(i, coordinator):
            def sleep(d):
                sleeps[i].append(d)
                coordinator.control_step()   # it runs while we wait
            return sleep

        assert back.p.try_rejoin(
            cl.RejoinPolicy(max_attempts=3, base_delay=0.1),
            sleeper(0, n0.p))
        assert back.j.try_rejoin(
            jcl.RejoinPolicy(max_attempts=3, base_delay=0.1),
            sleeper(1, n0.j))
        assert sleeps[0] == sleeps[1] and sleeps[0][0] == 0.1
        back.assert_equal()
        n0.assert_equal()
        assert set(n0.p.owned()) | set(back.p.owned()) == set(range(8))
        assert not set(n0.p.owned()) & set(back.p.owned())
        won = set(cl.ShardMap(0, ("h0", "h1"), 8).owned_by("h1"))
        assert {a["tenant"] for a in back.p.adoptions} == won
        for rec in back.p.adoptions:
            # the survivor adopted these after its last publish: they come
            # from its checkpoint of the whole fleet, as in the reference
            assert (rec["from_host"], rec["source"]) == ("h0", "checkpoint")
            t = rec["tenant"]
            assert rec["n"] == float(back.p.state.n[t])

    def test_rejoin_budget_exhausted(self):
        n1 = cl.ClusterNode(_cfg(cl, "h1", None), cl.MemStore(),
                            FakeClock(), device="cpu")
        n1.map = cl.without_host(n1.map, "h1")
        slept = []
        assert not n1.try_rejoin(cl.RejoinPolicy(max_attempts=2),
                                 sleep=slept.append)
        assert slept == [0.1, 0.2]

    def test_adoption_prefers_newer_map_version_over_larger_n(self,
                                                              tmp_path):
        stores, clock, n0, n1 = self._two(tmp_path)
        n1.epochs(1)
        early = node_mod.fetch_fleet(n1.p.state)
        n1.epochs(2, seed0=50)                  # the zombie keeps going
        zombie = node_mod.fetch_fleet(n1.p.state)
        for pkg, store, save, state, root in (
                (cl, stores[0], ckpt.save, zombie, tmp_path / "port"),
                (jcl, stores[1], jckpt.save, n1.j.state, tmp_path / "ref")):
            save(str(root / "h1"), 99, state, extra={"map_version": 0},
                 keep=8)
            pkg.GossipBus(store, "h1").publish(
                9, early, n1.p.owned(), map_version=2)
        self._kill_and_detect(clock, n0)
        n0.assert_equal()
        assert n0.p.adoptions
        for rec in n0.p.adoptions:
            t = rec["tenant"]
            assert rec["source"] == "gossip"
            assert float(zombie.n[t]) > float(early.n[t])
            assert float(n0.p.state.n[t]) == float(early.n[t])

    def test_revived_stale_host_not_adopted_from(self, tmp_path):
        stores, clock, n0, n1 = self._two(tmp_path)
        n1.epochs(2)
        live = node_mod.fetch_fleet(n1.p.state)
        cl.GossipBus(stores[0], "h1").publish(5, live, n1.p.owned(),
                                              map_version=3)
        zbus = cl.GossipBus(stores[0], "h1")     # revived process
        empty = FleetState(*(None if v is None else v.numpy() for v in
                             cl.ClusterNode(_cfg(cl, "h1", None),
                                            cl.MemStore(), FakeClock(),
                                            device="cpu").state))
        assert zbus.publish(1, empty, n1.p.owned(), map_version=0) == 0
        assert zbus.stale_publishes == 1
        got = n0.p.gossip.latest("h1")
        assert got[0] == 5 and got[2] == 3
        for t in n1.p.owned():
            assert float(got[1][t].n) == float(live.n[t])

    def test_dead_coordinator_replaced(self, tmp_path):
        stores, clock, n0, n1 = self._two(tmp_path)
        n0.epochs(1)
        clock.advance(0.5)
        n1.control_step()
        clock.advance(1.2)
        assert n1.control_step() == ["h0"]
        n1.assert_equal()
        assert n1.p.coordinator
        assert len(n1.p.owned()) == n1.p.cfg.num_tenants

    def test_one_transfer_each_way_a_chunk(self, tmp_path, monkeypatch):
        """A chunk is one host-to-device copy and one device-to-host copy;
        the epoch boundary's fetch of the fleet is counted apart."""
        stores, clock, n0, n1 = self._two(tmp_path)
        calls = {"h2d": 0, "d2h": 0, "fleet": 0}

        def count(name, fn):
            def wrapped(*a, **k):
                calls[name] += 1
                return fn(*a, **k)
            return wrapped
        monkeypatch.setattr(runner_mod, "_to_device",
                            count("h2d", runner_mod._to_device))
        monkeypatch.setattr(runner_mod, "_to_host",
                            count("d2h", runner_mod._to_host))
        monkeypatch.setattr(node_mod, "fetch_fleet",
                            count("fleet", node_mod.fetch_fleet))
        for i in range(4):
            n0.p.ingest_chunk(*n0.chunk(i))
            assert calls == {"h2d": i + 1, "d2h": i + 1,
                             "fleet": (i + 1) // 2}
        assert n0.p.epoch == 2 and len(n0.p.boundary_ms) == 2
        rec = n0.p.boundary_ms[-1]
        assert set(rec) == {"d2h", "pack", "publish", "ckpt", "bytes"}
        assert rec["bytes"] == n0.p.gossip.published_bytes // 2


def test_snapshot_blob_manifest_is_the_reference_layout():
    host = _host_fleet("int16")
    blob = cl.pack_snapshot(host, [2], epoch=3, map_version=1)
    with np.load(io.BytesIO(blob)) as z:
        assert sorted(z.files) == ["counts", "manifest", "stats"]
        man = json.loads(bytes(z["manifest"]).decode())
        assert z["stats"].dtype == np.float32
        assert z["stats"].shape == (3, 1)
    assert man["count_dtype"] == "int16" and man["tenants"] == [2]
    assert set(man) == {"epoch", "map_version", "tenants", "count_dtype",
                        "crc_counts", "crc_stats"}
    assert gossip_mod._crc(host.counts[[2]]) == man["crc_counts"]
    assert isinstance(cl.unpack_snapshot(blob)[1][2], AceState)
