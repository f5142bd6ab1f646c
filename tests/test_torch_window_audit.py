"""ROADMAP.md queue 3 item 16: the audit's count conservation on window
rings is one-sided, Σ counts ≤ n (the reference's
``resilience.health.check_window`` and ``check_fleet_window``), so a
flipped bit that LOWERS a counter passes the audit while one that raises
it is caught.  The one-sided check is what lets a repaired table's
deficit expire with its epochs.  This test pins the reference's behaviour
in both packages, on one ring carried across; it does not fix it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fleet.window import WindowedFleetState as JFleetRing
from repro.resilience import health as jhealth
from repro.window.ring import WindowedAceState as JRing
from repro_torch.core.sketch import AceConfig
from repro_torch.fleet import window as fw
from repro_torch.resilience import health
from repro_torch.window import ring

CFG = AceConfig(dim=8, num_bits=6, num_tables=4, seed=0)
WCFG = ring.WindowConfig(ace=CFG, num_epochs=3, rotate_every=2)
T = 2


def _filled(kind: str):
    """A ring (or a fleet of T rings) after two inserts of 32 items."""
    rng = np.random.default_rng(0)
    if kind == "ring":
        st = ring.init_window(WCFG, "cpu")
    else:
        st = fw.init_fleet_window(WCFG, T, "cpu")
    for _ in range(2):
        ids = torch.as_tensor(rng.integers(0, CFG.num_buckets, (32, 4)),
                              dtype=torch.int32)
        mask = torch.ones(32, dtype=torch.bool)
        if kind == "ring":
            st = ring.insert_current(st, ids, mask, CFG)
        else:
            tids = torch.as_tensor(rng.integers(0, T, 32), dtype=torch.int32)
            st = fw.insert_current_fleet(st, tids, ids, mask, CFG)
    return st


def _flip(st, raise_it: bool):
    """Flip one bit of table 1's fullest live counter: clear its lowest
    set bit (the counter drops), or set bit 20 (it jumps)."""
    counts = st.counts.clone()
    table = counts[..., 1, :].reshape(-1)
    i = int(torch.argmax(table))
    c = int(table[i])
    table[i] = c | (1 << 20) if raise_it else c & (c - 1)
    counts[..., 1, :] = table.reshape(counts[..., 1, :].shape)
    return st._replace(counts=counts)


def _reference(st, kind: str):
    fields = {f: jnp.asarray(getattr(st, f).numpy())
              for f in ("counts", "n", "welford_mean", "welford_m2", "tail",
                        "ssq", "cursor", "tick")}
    return (JRing if kind == "ring" else JFleetRing)(**fields)


@pytest.mark.parametrize("raise_it", [False, True], ids=["lowered",
                                                         "raised"])
@pytest.mark.parametrize("kind", ["ring", "fleet_ring"])
def test_window_audit_misses_a_lowered_counter(kind, raise_it):
    st = _flip(_filled(kind), raise_it)
    port = (health.check_window if kind == "ring"
            else health.check_fleet_window)(st)
    ref = (jhealth.check_window if kind == "ring"
           else jhealth.check_fleet_window)(_reference(st, kind))
    ok = port.table_ok.numpy()
    np.testing.assert_array_equal(ok, np.asarray(ref.table_ok))
    # table 1 (every tenant's, for the fleet) passes when its counter was
    # lowered — the miss — and is flagged when raised
    assert bool(ok[..., 1].all()) is (not raise_it)
    assert bool(np.delete(ok, 1, axis=-1).all())
