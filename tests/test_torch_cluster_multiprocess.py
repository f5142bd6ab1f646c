"""Two REAL processes of the port's cluster (``repro_torch.cluster``) over
a ``torch.distributed.TCPStore`` served by the test: the KV/gossip round
trip, and the chaos host kill of ``tests/test_cluster_multiprocess.py``
at its small shape (d = 8, T = 16, K = 5, L = 4), held against the
reference's never-failed oracle replay.

The children run the port on the CPU and import no JAX; they hash with the
reference filter's W, which the test writes for them.  The oracle replays
each tenant's exact batch sequence through the reference's fleet filter in
this process.  Counts, n, probe scores and every served verdict are held
bitwise; the Welford moments at rtol 1e-6 (batch sums in PyTorch's order
there, XLA's here).  Each child has a 120 s timeout.
"""
import datetime
import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from test_cluster_multiprocess import _GEN  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 120


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_pair(code: str, tmp, expect_rc=(0, 0)):
    """Serve a TCPStore here and run ``code`` in 2 child processes (ACE_PROC
    selects the role).  Returns their stdouts."""
    port = _free_port()
    server = torch.distributed.TCPStore(
        "127.0.0.1", port, is_master=True, wait_for_workers=False,
        timeout=datetime.timedelta(seconds=CHILD_TIMEOUT))
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "ACE_PORT": str(port), "ACE_TMP": str(tmp)}
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**env, "ACE_PROC": str(i)}) for i in range(2)]
    outs = []
    try:
        for i, p in enumerate(procs):
            out, err = p.communicate(timeout=CHILD_TIMEOUT)
            assert p.returncode == expect_rc[i], \
                f"proc {i} rc={p.returncode}\nstderr:\n{err[-4000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        del server
    return outs


_BOOT = """
import json, os, sys, time
import numpy as np
import torch
sys.modules["jax"] = None               # the port runs without JAX
pid = int(os.environ["ACE_PROC"])
tmp = os.environ["ACE_TMP"]
from repro_torch.cluster import (ClusterConfig, ClusterNode,
                                 DistributedStore, GossipBus,
                                 MembershipConfig)
from repro_torch.core.convert import params_from_numpy

store = DistributedStore(host="127.0.0.1", port=int(os.environ["ACE_PORT"]))

def wait_key(store, key, tries=6000):
    for _ in range(tries):
        v = store.get(key)
        if v is not None:
            return v
        time.sleep(0.01)
    raise RuntimeError("timeout waiting for " + key)
"""


def test_distributed_store_splits_values_past_the_store_limit():
    """A ``TCPStore`` value is capped (8 MiB under libuv) and a full-width
    gossip blob is tens of MB: ``DistributedStore`` writes a long value as
    parts and a header, joins them on read, hides them from ``keys`` and
    deletes them with the key or when the key is overwritten."""
    from repro_torch.cluster import DistributedStore
    server = torch.distributed.TCPStore(
        "127.0.0.1", _free_port(), is_master=True, wait_for_workers=False,
        timeout=datetime.timedelta(seconds=30))
    store = DistributedStore(server)
    big = np.random.default_rng(0).bytes(3 * DistributedStore.PART + 5)
    store.set_bytes("gossip/h0/1", big)
    assert store.get_bytes("gossip/h0/1") == big
    assert store.keys("") == ["gossip/h0/1"]
    parts = [k for k in server.list_keys()
             if k.startswith(DistributedStore.PARTS)]
    assert len(parts) == 4
    store.set_bytes("gossip/h0/1", b"small")      # the old parts go
    assert store.get_bytes("gossip/h0/1") == b"small"
    assert not [k for k in server.list_keys()
                if k.startswith(DistributedStore.PARTS)]
    store.set_bytes("gossip/h0/2", big)
    server.delete_key([k for k in server.list_keys()
                       if k.startswith(DistributedStore.PARTS)][0])
    assert store.get_bytes("gossip/h0/2") is None  # a part gone: absent
    store.delete("gossip/h0/2")
    store.delete("gossip/h0/2")                    # absent: a no-op
    assert store.keys("gossip/") == ["gossip/h0/1"]
    assert not [k for k in server.list_keys()
                if k.startswith(DistributedStore.PARTS)]
    store.set("k", "v")
    assert store.get("k") == "v" and store.get("missing") is None


def test_kv_roundtrip_and_gossip_fetch(tmp_path):
    code = _BOOT + _GEN + """
from repro_torch.fleet.filter import FleetDataFilter

filt = FleetDataFilter(d_model=D, num_tenants=4, num_bits=5, num_tables=4,
                       warmup_items=16.0, insert_all=True,
                       count_dtype="int8", device="cpu")
state, w = filt.init()
if pid == 0:
    for t in range(4):
        x, _ = tenant_batch(t, 0)
        feat = filt.features(torch.from_numpy(x[:, None, :]))
        state, _, _ = filt.step(state, w, feat,
                                torch.full((B,), t, dtype=torch.int32))
    nbytes = GossipBus(store, "h0").publish(1, state, [0, 1, 2, 3])
    assert nbytes > 0
    store.set("k1", "v1")
    store.set("ready0", "1")
    wait_key(store, "done1")
    np.save(os.path.join(tmp, "pub_counts.npy"), state.counts.numpy())
else:
    wait_key(store, "ready0")
    assert store.get("k1") == "v1"
    t0 = time.perf_counter()
    assert store.get("missing/key") is None      # absent: no blocking
    assert store.get_bytes("missing/key") is None
    assert time.perf_counter() - t0 < 0.5
    store.delete("missing/key")                  # a no-op
    assert "gossip/h0/latest" in store.keys("gossip/h0/")
    epoch, states, _ = GossipBus(store, "h1").latest("h0")
    assert epoch == 1 and set(states) == {0, 1, 2, 3}
    assert states[0].counts.dtype == np.int8
    assert float(sum(states[t].n for t in range(4))) == 4.0 * B
    np.save(os.path.join(tmp, "got_counts.npy"),
            np.stack([states[t].counts for t in range(4)]))
    store.set("done1", "1")
print("OK", pid)
"""
    outs = _run_pair(code, tmp_path)
    assert [o.split()[-1] for o in outs] == ["0", "1"]
    pub = np.load(tmp_path / "pub_counts.npy")
    got = np.load(tmp_path / "got_counts.npy")
    assert got.dtype == np.int8 and np.array_equal(pub, got)


_CHAOS_WORKER = _BOOT + _GEN + """
HOSTS = ("h0", "h1")
T = 16
cfg = ClusterConfig(host_id=HOSTS[pid], hosts=HOSTS, num_tenants=T,
                    d_model=D, num_bits=5, num_tables=4, alpha=2.0,
                    warmup_items=48.0, insert_all=True, chunk_T=8,
                    epoch_chunks=2, ckpt_root=os.path.join(tmp, "ckpt"),
                    ckpt_every_epochs=1, ckpt_keep=3,
                    membership=MembershipConfig(heartbeat_interval=0.05,
                                                failure_timeout=0.6))
node = ClusterNode(cfg, store, device="cpu")
node.w = params_from_numpy(np.load(os.path.join(tmp, "w.npy")), "cpu")

counters = {t: 0 for t in range(T)}
step_no = 0
served = []       # (tenant, idx) per batch, in order
keeps_log = []    # matching (B,) keep rows

def run_chunk():
    global step_no
    owned = node.owned()
    embeds = np.zeros((cfg.chunk_T * B, 1, D), np.float32)
    tids = np.zeros((cfg.chunk_T, B), np.int32)
    meta = []
    for j in range(cfg.chunk_T):
        t = owned[(step_no + j) % len(owned)]
        idx = counters[t]; counters[t] += 1
        x, _ = tenant_batch(t, idx)
        embeds[j * B:(j + 1) * B, 0, :] = x
        tids[j] = t
        meta.append((t, idx))
    step_no += cfg.chunk_T
    feats = node.filt.features(torch.from_numpy(embeds)).numpy()
    _, keeps = node.ingest_chunk(feats.reshape(cfg.chunk_T, B, D + 1), tids)
    for (t, idx), k in zip(meta, keeps):
        served.append((t, idx)); keeps_log.append(k)

run_chunk()
store.set("warm/%s" % cfg.host_id, "1")
wait_key(store, "warm/%s" % HOSTS[1 - pid])

if pid == 1:
    for _ in range(10):                  # chunks 2..11: die mid-epoch 6
        run_chunk()
        node.control_step()
        time.sleep(0.05)
    sys.stdout.flush()
    os._exit(137)                        # SIGKILL-equivalent: no cleanup

n_adopt_seen = 0
for loop in range(400):
    run_chunk()
    node.control_step()
    for rec in node.adoptions[n_adopt_seen:]:   # resume adopted streams
        counters[rec["tenant"]] = int(round(rec["n"] / B))
        n_adopt_seen += 1
    time.sleep(0.03)
    if len(node.owned()) == T:
        adopted = [a["tenant"] for a in node.adoptions]
        if adopted and all(counters[t] >= 16 for t in adopted):
            break
else:
    raise RuntimeError("h1 death never produced a full adoption")

node.control_step()
surv = sorted(set(range(T)) - {a["tenant"] for a in node.adoptions})
qx = np.random.default_rng(424242).normal(size=(B, D)).astype(np.float32)
qf = node.filt.features(torch.from_numpy(qx[:, None, :])).numpy()
probe = np.stack([node.probe_scores(qf, np.full(B, t, np.int32))
                  for t in surv])
final = node.state
np.savez(os.path.join(tmp, "h0_result.npz"),
         counts=final.counts.numpy(), n=final.n.numpy(),
         mean=final.welford_mean.numpy(), m2=final.welford_m2.numpy(),
         served_t=np.array([t for t, _ in served], np.int32),
         served_i=np.array([i for _, i in served], np.int32),
         keeps=np.stack(keeps_log), probe=probe,
         surv=np.array(surv, np.int32))
with open(os.path.join(tmp, "h0_result.json"), "w") as f:
    json.dump({"adoptions": node.adoptions, "epoch": node.epoch,
               "map_version": node.map.version,
               "gossip_bytes": node.gossip.published_bytes}, f)
print("H0 DONE")
"""


def test_host_kill_reshard_parity_and_recall(tmp_path):
    import jax
    import jax.numpy as jnp
    from repro.core import srp
    from repro.fleet import state as fl
    from repro.fleet.filter import FleetDataFilter
    from repro.stream.runner import StreamRunner

    filt = FleetDataFilter(d_model=8, num_tenants=16, num_bits=5,
                           num_tables=4, alpha=2.0, warmup_items=48.0,
                           insert_all=True)
    runner = StreamRunner(filt, chunk_T=1, return_masks=True)
    state, w = runner.init()
    np.save(tmp_path / "w.npy", np.asarray(w))

    t0 = time.perf_counter()
    outs = _run_pair(_CHAOS_WORKER, tmp_path, expect_rc=(0, 137))
    assert "H0 DONE" in outs[0]
    assert time.perf_counter() - t0 < 2 * CHILD_TIMEOUT
    res = np.load(tmp_path / "h0_result.npz")
    with open(tmp_path / "h0_result.json") as f:
        meta = json.load(f)

    # ---- adoption happened, from gossip, with exact n -----------------
    adopted = {a["tenant"]: a for a in meta["adoptions"]}
    surv = set(res["surv"].tolist())
    assert surv and adopted
    assert surv | set(adopted) == set(range(16))
    assert not (surv & set(adopted))
    for rec in adopted.values():
        assert rec["source"] == "gossip"
        assert rec["source_epoch"] == 5       # h1's last boundary
        assert rec["n"] == 10.0 * 16          # 10 of its 11 batches
    assert meta["map_version"] == 1
    assert meta["gossip_bytes"] > 0

    # ---- the reference's never-failed oracle ---------------------------
    ns: dict = {"np": np}
    exec(textwrap.dedent(_GEN), ns)
    tenant_batch = ns["tenant_batch"]
    served = list(zip(res["served_t"].tolist(), res["served_i"].tolist()))
    max_idx = {}
    for t, i in served:
        max_idx[t] = max(max_idx.get(t, -1), i)
    oracle_keeps = {}
    for t in range(16):
        for idx in range(max_idx[t] + 1):
            x, _ = tenant_batch(t, idx)
            feats = filt.features(jnp.asarray(x[:, None, :]))[None]
            state, _, k = runner.consume(
                state, w, feats, jnp.full((1, 16), t, jnp.int32))
            oracle_keeps[(t, idx)] = np.asarray(k)[0]
    oracle = jax.device_get(state)

    # ---- survivors and adopted tenants: state bitwise, moments close ---
    for t in range(16):
        assert np.array_equal(res["counts"][t], oracle.counts[t])
        assert res["n"][t] == oracle.n[t]
    for t in surv:
        np.testing.assert_allclose(res["mean"][t], oracle.welford_mean[t],
                                   rtol=1e-6)
        np.testing.assert_allclose(res["m2"][t], oracle.welford_m2[t],
                                   rtol=1e-6)
    qx = np.random.default_rng(424242).normal(size=(16, 8)) \
        .astype(np.float32)
    qf = filt.features(jnp.asarray(qx[:, None, :]))
    buckets = srp.hash_buckets(qf, w, filt.ace_cfg.srp)
    for row, t in zip(res["probe"], sorted(surv)):
        ref = np.asarray(fl.fleet_scores(
            jax.tree.map(jnp.asarray, oracle),
            jnp.full(16, t, jnp.int32), buckets))
        assert np.array_equal(row, ref)

    # ---- every batch h0 served: the oracle's verdicts ------------------
    for (t, i), keep in zip(served, res["keeps"]):
        assert np.array_equal(keep.astype(bool),
                              oracle_keeps[(t, i)].astype(bool)), \
            f"verdict mismatch tenant {t} batch {i}"

    # ---- recall after re-homing >= 0.9x fault-free ---------------------
    def recall(keep_lookup, pairs):
        flagged = total = 0
        for t, i in pairs:
            _, y = tenant_batch(t, i)
            if not y.any():
                continue
            k = np.asarray(keep_lookup(t, i), bool)
            flagged += int((~k[y]).sum())
            total += int(y.sum())
        return flagged / max(total, 1), total

    post = [(t, i) for (t, i) in served if t in adopted and i >= 10]
    faulted = {(t, i): k for (t, i), k in zip(served, res["keeps"])}
    r_fault, n_fault = recall(lambda t, i: faulted[(t, i)], post)
    oracle_post = [(t, i) for t in adopted
                   for i in range(11, max_idx[t] + 1)]
    r_free, n_free = recall(lambda t, i: oracle_keeps[(t, i)], oracle_post)
    assert n_fault > 0 and n_free > 0 and r_free > 0
    assert r_fault >= 0.9 * r_free
