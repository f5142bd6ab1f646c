"""The port's self-healing sketches (``repro_torch.resilience``,
``repro_torch.train.checkpoint``, ``train.fault.StepTimer`` and the
``Guardrail``'s health_check / degraded admission / repair / re-warm)
against the reference's, on the CPU, at the reference tests' size (dim 17,
K = 6, L = 8; guardrails d_model 16).

The reference builds and faults each state with its own injectors (and
with single-bit flips at chosen bits); the faulted state is carried
across as numpy (``core/convert.py``) — the port's injectors draw with a
``torch.Generator`` and are held to the reference's properties, never to
its draws.

Tolerances: health reports, repaired counts, n, moments, cursors, ticks,
escalation tables, repair offsets, verdicts, ``degraded`` flags and the
admit at which recovery lands: bitwise.  A repaired window's ``ssq`` (a
float sum over the plane, PyTorch's order here, XLA's there): rtol 1e-6.
Checkpoints: each package restores the other's bitwise, with equal leaf
names and CRCs; a torn file is byte for byte the reference's tear.
"""
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro import resilience as jrz  # noqa: E402
from repro.core import sketch as jsk  # noqa: E402
from repro.core import srp as jsrp  # noqa: E402
from repro.fleet import state as jfl  # noqa: E402
from repro.fleet import window as jfw  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.train import checkpoint as jck  # noqa: E402
from repro.window import ring as jring  # noqa: E402
from repro_torch import resilience as rz  # noqa: E402
from repro_torch.core import sketch as sk  # noqa: E402
from repro_torch.core.convert import (params_from_numpy,  # noqa: E402
                                      tree_from_numpy)
from repro_torch.fleet import state as fl  # noqa: E402
from repro_torch.fleet import window as fw  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train import checkpoint as ck  # noqa: E402
from repro_torch.train.fault import StepTimer  # noqa: E402
from repro_torch.window import ring  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

CPU = torch.device("cpu")
PORT_CLS = {"AceState": sk.AceState, "WindowedAceState": ring.WindowedAceState,
            "FleetState": fl.FleetState,
            "WindowedFleetState": fw.WindowedFleetState}
UNSIGNED = {1: np.uint8, 2: np.uint16, 4: np.uint32}


def _cfg(**kw):
    base = dict(dim=17, num_bits=6, num_tables=8, seed=3, welford_min_n=4.0)
    base.update(kw)
    return jsk.AceConfig(**base)


def _points(rng, rows, clustered=False):
    """(rows, 17) float32 points; clustered ones pile into few buckets (an
    int8 plane then promotes)."""
    if clustered:
        c = np.random.default_rng(99).normal(size=(2, 17))
        return (c[rng.integers(0, 2, rows)]
                + 0.01 * rng.normal(size=(rows, 17))).astype(np.float32)
    return rng.normal(size=(rows, 17)).astype(np.float32)


def _carry(js):
    """The reference state ``js`` as the port's state on the CPU."""
    return tree_from_numpy(PORT_CLS[type(js).__name__], list(js), CPU)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _ftz(a):
    """Subnormal floats flushed to zero, as XLA's CPU ops flush them (a
    repair's multiply by 1.0 zeroes a subnormal there, not here)."""
    if a.dtype.kind != "f":
        return a
    return np.where(np.abs(a) < np.finfo(a.dtype).tiny, 0.0 * a, a)


def _assert_same(got, want, what):
    got, want = _ftz(_np(got)), _ftz(np.asarray(want))
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (what, got.shape, got.dtype, want.shape, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)
    if got.dtype.kind == "f":
        np.testing.assert_array_equal(np.signbit(got), np.signbit(want),
                                      err_msg=what)


def _assert_report(pr, jr):
    for f in jrz.HealthReport._fields:
        _assert_same(getattr(pr, f), getattr(jr, f), f)


FLOAT_STREAMS = ("welford_mean", "welford_m2", "tail", "ssq")


def _assert_state(ps, js, streams_rtol=None):
    """Every leaf bitwise (escalation tables too), ``ssq`` rtol 1e-6; with
    ``streams_rtol`` the float streams (Welford, tail, ssq — batch sums in
    another order in each package) within that rtol."""
    for f in js._fields:
        jv, pv = getattr(js, f), getattr(ps, f)
        if jv is None:
            assert pv is None, f
        elif f == "esc":
            for g in ("offs", "vals", "lost"):
                _assert_same(getattr(pv, g), getattr(jv, g), f"esc.{g}")
        elif streams_rtol is not None and f in FLOAT_STREAMS:
            np.testing.assert_allclose(_np(pv), np.asarray(jv),
                                       rtol=streams_rtol, atol=1e-30,
                                       err_msg=f)
        elif f == "ssq":
            np.testing.assert_allclose(_np(pv), np.asarray(jv), rtol=1e-6,
                                       err_msg=f)
        else:
            _assert_same(pv, jv, f)


# ---------------------------------------------------------------------------
# Reference states, faults and the parity of reports and repairs.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)   # immutable: built once
def _flat_state(dtype, esc=0):
    cfg = _cfg(counter_dtype=dtype, esc_capacity=esc)
    state, w = jsk.init(cfg), jsk.make_params(cfg)
    rng = np.random.default_rng(0)
    for _ in range(24 if esc else 4):
        x = jnp.asarray(_points(rng, 16, clustered=bool(esc)))
        state = jsk.insert_buckets(state, jsrp.hash_buckets(x, w, cfg.srp),
                                   cfg)
    return state, w, cfg


@functools.lru_cache(maxsize=None)
def _window_state():
    wcfg = jring.WindowConfig(ace=_cfg(), num_epochs=3, decay=0.9,
                              rotate_every=2)
    state, w = jring.init_window(wcfg), jsk.make_params(wcfg.ace)
    rng = np.random.default_rng(1)
    for _ in range(7):
        b = jsrp.hash_buckets(jnp.asarray(_points(rng, 8)), w, wcfg.ace.srp)
        state = jring.insert_current(state, b, jnp.ones(8, bool), wcfg.ace,
                                     gamma=0.9)
        state = jring.maybe_rotate(state, 2, 0.9)
    return state


@functools.lru_cache(maxsize=None)
def _fleet_state():
    cfg = _cfg()
    state, w = jfl.init(jfl.FleetConfig(ace=cfg, num_tenants=3)), \
        jsk.make_params(cfg)
    rng = np.random.default_rng(2)
    for _ in range(4):
        x = jnp.asarray(_points(rng, 12))
        tids = jnp.asarray(rng.integers(0, 3, 12), jnp.int32)
        state = jfl.insert_masked(state, tids,
                                  jsrp.hash_buckets(x, w, cfg.srp),
                                  jnp.ones(12, bool), cfg)
    return state, w, cfg


@functools.lru_cache(maxsize=None)
def _fleet_window_state():
    wcfg = jring.WindowConfig(ace=_cfg(), num_epochs=3, decay=0.9,
                              rotate_every=2)
    state, w = jfw.init_fleet_window(wcfg, 2), jsk.make_params(wcfg.ace)
    rng = np.random.default_rng(3)
    for _ in range(7):
        tids = jnp.asarray(rng.integers(0, 2, 8), jnp.int32)
        b = jsrp.hash_buckets(jnp.asarray(_points(rng, 8)), w, wcfg.ace.srp)
        state = jfw.insert_current_fleet(state, tids, b, jnp.ones(8, bool),
                                         wcfg.ace, gamma=0.9)
        state = jfw.maybe_rotate_fleet(state, 2, 0.9, tenant_ids=tids)
    return state


def _flip_bits(counts, bit):
    """Two single-bit flips at ``bit`` in a copy of a count plane: at the
    fullest counter of table 3 and at an empty counter of table 5 (of the
    first tenant/epoch slice), through an unsigned same-width view."""
    a = np.array(counts)
    lead = a.reshape(-1, a.shape[-2], a.shape[-1])[0]
    hot = 3 * a.shape[-1] + int(np.argmax(lead[3]))
    cold = 5 * a.shape[-1] + int(np.argmin(np.abs(lead[5])))
    v = a.reshape(-1).view(UNSIGNED[a.itemsize])
    one = v.dtype.type(1) << v.dtype.type(bit)
    v[[hot, cold]] ^= one
    return jnp.asarray(a)


BITS = {"int32": (0, 15, 30, 31), "int16": (0, 15), "int8": (0, 7),
        "float32": (0, 23, 30, 31), "int8esc": (7,)}
FLAT_FAULTS = ["clean", "flip_random", "saturate", "poison_nan",
               "poison_neg", "offsets"]
FLAT_CASES = [(dt, f) for dt in BITS for f in FLAT_FAULTS] \
    + [(dt, f"bit{b}") for dt, bits in BITS.items() for b in bits]


def _flat_fault(dt, fault):
    state, w, cfg = _flat_state("int8" if dt == "int8esc" else dt,
                                esc=16 if dt == "int8esc" else 0)
    offsets = None
    if fault == "flip_random":
        state = state._replace(counts=jrz.flip_count_bits(
            state.counts, jax.random.PRNGKey(0), num_flips=2, tables=(3,)))
    elif fault.startswith("bit"):
        state = state._replace(counts=_flip_bits(state.counts,
                                                 int(fault[3:])))
    elif fault == "saturate":
        state = state._replace(counts=jrz.saturate_table(state.counts, 5))
    elif fault.startswith("poison"):
        state = jrz.poison_moments(state, kind=fault[7:])
    elif fault == "offsets":
        # a repaired table regrown from the live stream: Σ == n − offset
        bad = _flip_bits(state.counts, 0)
        ok = jrz.health_check(state._replace(counts=bad)).table_ok
        state, offsets = jrz.repair_ace(state._replace(counts=bad), ok)
        rng = np.random.default_rng(7)
        x = jnp.asarray(_points(rng, 16, clustered=dt == "int8esc"))
        state = jsk.insert_buckets(state, jsrp.hash_buckets(x, w, cfg.srp),
                                   cfg)
    return state, offsets


class TestReports:
    @pytest.mark.parametrize("dt,fault", FLAT_CASES,
                             ids=[f"{d}-{f}" for d, f in FLAT_CASES])
    def test_flat_report_and_repair(self, dt, fault):
        """``check_ace`` field for field the reference's, then
        ``repair_ace`` (escalation slots freed and re-sorted, offsets) and
        ``repair_moments`` bitwise, and the repaired sketch audits clean
        against its offsets in both packages."""
        js, joffs = _flat_fault(dt, fault)
        ps = _carry(js)
        poffs = None if joffs is None else torch.as_tensor(np.array(joffs))
        jr = jrz.health_check(js, joffs)
        pr = rz.health_check(ps, poffs)
        _assert_report(pr, jr)
        if dt == "int8esc" and fault == "clean":
            assert int((np.asarray(js.esc.vals) > 0).sum()) > 0, \
                "the clustered stream must promote"
        if fault in ("flip_random", "saturate") or (
                fault.startswith("bit") and not (dt == "float32"
                                                 and fault == "bit0")):
            # (a float's lowest mantissa bit vanishes into the float32 sum)
            assert not bool(jr.ok)
        j2, jo2 = jrz.repair_ace(js, jr.table_ok, joffs)
        p2, po2 = rz.repair_ace(ps, pr.table_ok, poffs)
        _assert_state(p2, j2)
        _assert_same(po2, jo2, "repair offsets")
        _assert_report(rz.health_check(p2, po2), jrz.health_check(j2, jo2))
        _assert_state(rz.repair_moments(p2), jrz.repair_moments(j2))

    WINDOW_FAULTS = ["clean", "flip_random", "flip_tail", "add_1_20",
                     "bit0", "bit31", "cursor", "tick", "ssq_nan",
                     "poison_nan", "poison_neg"]

    @staticmethod
    def _ring_fault(js, fault, T=None):
        if fault == "flip_random":
            return js._replace(counts=jrz.flip_count_bits(
                js.counts, jax.random.PRNGKey(4), num_flips=3, tables=(4,)))
        if fault == "flip_tail":
            return js._replace(tail=jrz.flip_count_bits(
                js.tail, jax.random.PRNGKey(5), num_flips=3, tables=(1,)))
        if fault == "add_1_20":
            idx = (0, 0, 4, 7) if T else (0, 4, 7)
            return js._replace(counts=js.counts.at[idx].add(
                jnp.asarray(1 << 20, js.counts.dtype)))
        if fault.startswith("bit"):
            return js._replace(counts=_flip_bits(js.counts, int(fault[3:])))
        if fault == "cursor":
            return js._replace(cursor=js.cursor + 99)
        if fault == "tick":
            return js._replace(tick=js.tick - 1000)
        if fault == "ssq_nan":
            return js._replace(ssq=js.ssq * jnp.nan)
        if fault.startswith("poison"):
            return jrz.poison_moments(js, kind=fault[7:])
        return js

    @pytest.mark.parametrize("fault", WINDOW_FAULTS)
    def test_window_report_and_repair(self, fault):
        js = self._ring_fault(_window_state(), fault)
        ps = _carry(js)
        jr, pr = jrz.health_check(js), rz.health_check(ps)
        _assert_report(pr, jr)
        _assert_state(rz.repair_window(ps, pr.table_ok),
                      jrz.repair_window(js, jr.table_ok))

    @pytest.mark.parametrize("fault", WINDOW_FAULTS)
    def test_fleet_window_report_and_repair(self, fault):
        js = self._ring_fault(_fleet_window_state(), fault, T=2)
        ps = _carry(js)
        jr, pr = jrz.health_check(js), rz.health_check(ps)
        _assert_report(pr, jr)
        _assert_state(rz.repair_fleet_window(ps, pr.table_ok),
                      jrz.repair_fleet_window(js, jr.table_ok))
        _assert_state(rz.repair_moments(ps), jrz.repair_moments(js))

    FLEET_FAULTS = ["clean", "flip_random", "bit0", "bit15", "bit30",
                    "bit31", "add_7", "saturate", "poison_nan", "poison_neg",
                    "offsets"]

    @pytest.mark.parametrize("fault", FLEET_FAULTS)
    def test_fleet_report_and_repair(self, fault):
        js, w, cfg = _fleet_state()
        joffs = None
        if fault == "flip_random":
            js = js._replace(counts=jrz.flip_count_bits(
                js.counts, jax.random.PRNGKey(6), num_flips=3, tables=(6,)))
        elif fault.startswith("bit"):
            js = js._replace(counts=_flip_bits(js.counts, int(fault[3:])))
        elif fault == "add_7":
            js = js._replace(counts=js.counts.at[1, 6, 0].add(7))
        elif fault == "saturate":
            js = js._replace(counts=jrz.saturate_table(js.counts, 2))
        elif fault.startswith("poison"):
            js = jrz.poison_moments(js, kind=fault[7:])
        elif fault == "offsets":
            bad = js._replace(counts=js.counts.at[1, 6, 0].add(7))
            js, joffs = jrz.repair_fleet(
                bad, jrz.health_check(bad).table_ok)
            rng = np.random.default_rng(8)
            tids = jnp.asarray(rng.integers(0, 3, 12), jnp.int32)
            js = jfl.insert_masked(js, tids, jsrp.hash_buckets(
                jnp.asarray(_points(rng, 12)), w, cfg.srp),
                jnp.ones(12, bool), cfg)
        ps = _carry(js)
        poffs = None if joffs is None else torch.as_tensor(np.array(joffs))
        jr, pr = jrz.health_check(js, joffs), rz.health_check(ps, poffs)
        _assert_report(pr, jr)
        j2, jo2 = jrz.repair_fleet(js, jr.table_ok, joffs)
        p2, po2 = rz.repair_fleet(ps, pr.table_ok, poffs)
        _assert_state(p2, j2)
        _assert_same(po2, jo2, "repair offsets")
        _assert_report(rz.health_check(p2, po2), jrz.health_check(j2, jo2))

    def test_serving_mask_and_dispatch(self):
        js, _, _ = _flat_state("int32")
        rep = rz.health_check(_carry(js))
        m = rz.serving_mask(rep)
        assert m.dtype == torch.float32 and bool(torch.all(m == 1.0))
        with pytest.raises(TypeError, match="unknown state type"):
            rz.health_check(object())


# ---------------------------------------------------------------------------
# The port's injectors: the reference's properties.
# ---------------------------------------------------------------------------

class TestInjectors:
    def test_corrupt_embeddings_marks_rows(self):
        x = torch.ones((32, 4, 8))
        for kind in ("nan", "inf", "mixed"):
            y, bad = rz.corrupt_embeddings(
                x, torch.Generator().manual_seed(0), frac=0.25, kind=kind)
            assert 0 < int(bad.sum()) < 32
            finite = torch.isfinite(y).all(dim=2).all(dim=1)
            assert torch.equal(finite, ~bad)
        with pytest.raises(ValueError, match="unknown kind"):
            rz.corrupt_embeddings(x, torch.Generator(), kind="zero")

    def test_flip_count_bits_changes_only_target_tables(self):
        ps = _carry(_flat_state("int32")[0])
        flipped = rz.flip_count_bits(ps.counts,
                                     torch.Generator().manual_seed(3),
                                     num_flips=3, tables=(2, 5))
        rows = set(torch.nonzero(flipped != ps.counts)[:, 0].tolist())
        assert rows and rows <= {2, 5}
        # a windowed fleet's (T, E, L, B) plane: the table axis is -2
        ring4 = torch.zeros((2, 3, 8, 64), dtype=torch.int32)
        hit = rz.flip_count_bits(ring4, torch.Generator().manual_seed(1),
                                 num_flips=16, tables=(6,))
        assert set(torch.nonzero(hit)[:, 2].tolist()) == {6}

    @pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32,
                                       torch.float32])
    def test_flip_count_bits_single_bits_every_width(self, dtype):
        """Each flip XORs one bit of a same-width view: flips into a zero
        plane set exactly one bit each, the top bit included (it wraps to
        the negative value, or the float's sign)."""
        zero = torch.zeros((4, 16384), dtype=dtype)
        got = rz.flip_count_bits(zero, torch.Generator().manual_seed(2),
                                 num_flips=256)
        assert got.dtype == dtype and got.shape == zero.shape
        width = {torch.int8: 8, torch.int16: 16}.get(dtype, 32)
        bits = _np(got).view(UNSIGNED[width // 8]).astype(np.uint64)
        ones = sum((bits >> b) & 1 for b in range(width))
        # a repeated draw of one counter overwrites (the reference's
        # scatter-set), so some of the 256 may coincide
        assert set(np.unique(ones).tolist()) == {0, 1}
        assert 240 <= int(ones.sum()) <= 256
        assert bool((got < 0).any()) if dtype != torch.float32 \
            else bool(torch.signbit(got).any())

    def test_saturate_and_poison(self):
        js, _, _ = _flat_state("int16")
        ps = _carry(js)
        sat = rz.saturate_table(ps.counts, 5)
        assert bool((sat[5] == 32767).all()) and torch.equal(sat[4],
                                                            ps.counts[4])
        _assert_same(sat, jrz.saturate_table(js.counts, 5), "saturate")
        fsat = rz.saturate_table(torch.zeros((3, 4)), 1)
        assert bool((fsat[1] == 2.0 ** 31).all())
        for kind in ("nan", "neg"):
            _assert_state(rz.poison_moments(ps, kind),
                          jrz.poison_moments(js, kind))
        with pytest.raises(ValueError, match="unknown kind"):
            rz.poison_moments(ps, "zero")

    def test_step_timer_and_stall_step(self):
        t = StepTimer(slo_seconds=60.0)
        assert t.tick() is False
        rz.stall_step(t, 120.0)
        assert t.tick() is True and t.breaches == 1
        assert t.tick() is False and t.breaches == 1


# ---------------------------------------------------------------------------
# Checkpoints: the same format in both packages.
# ---------------------------------------------------------------------------

def _trees():
    return ({"w": torch.arange(12.0).reshape(3, 4), "n": torch.tensor(7.0)},
            {"w": torch.zeros((3, 4)), "n": torch.zeros(())})


class TestCheckpoints:
    @pytest.mark.parametrize("mode,nbytes,seed", [("truncate", 64, 0),
                                                  ("truncate", 10**9, 0),
                                                  ("flip", 32, 0),
                                                  ("flip", 64, 2)])
    def test_tear_is_byte_for_byte_the_reference(self, tmp_path, mode,
                                                 nbytes, seed):
        a, b = str(tmp_path / "a"), str(tmp_path / "b")
        ck.save(a, 5, _trees()[0])
        shutil.copytree(a, b)
        pa = rz.tear_checkpoint(a, 5, mode=mode, nbytes=nbytes, seed=seed)
        pb = jrz.tear_checkpoint(b, 5, mode=mode, nbytes=nbytes, seed=seed)
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            assert fa.read() == fb.read()
        with pytest.raises(ValueError, match="unknown mode"):
            rz.tear_checkpoint(a, 5, mode="zero")

    def _states(self):
        js, _, _ = _fleet_state()
        jq, _, _ = _flat_state("int8", esc=16)
        return {"fleet": js, "esc": jq}

    @pytest.mark.parametrize("which", ["fleet", "esc", "dict"])
    def test_port_saves_reference_restores(self, tmp_path, which):
        """A port checkpoint restores into the reference's tree bitwise,
        and the reference's own save of the same values has the same leaf
        names and CRCs."""
        if which == "dict":
            ptree = _trees()[0]
            jtree = {k: jnp.asarray(_np(v)) for k, v in ptree.items()}
            jlike = {k: jnp.zeros(v.shape, v.dtype) for k, v in jtree.items()}
        else:
            jtree = self._states()[which]
            ptree = _carry(jtree)
            jlike = jax.tree.map(jnp.zeros_like, jtree)
        pdir, jdir = str(tmp_path / "p"), str(tmp_path / "j")
        ck.save(pdir, 3, ptree, extra={"data_step": 3})
        jck.save(jdir, 3, jtree, extra={"data_step": 3})
        got, man = jck.restore(pdir, 3, jlike)
        _, jman = jck.restore(jdir, 3, jlike)
        assert man["names"] == jman["names"]
        assert man["checksums"] == jman["checksums"]
        assert man["step"] == 3 and man["extra"] == {"data_step": 3}
        for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(jtree)):
            _assert_same(x, y, "leaf")
        if which == "fleet":
            assert man["names"] == [".counts", ".n", ".welford_mean",
                                    ".welford_m2"]

    @pytest.mark.parametrize("which", ["fleet", "esc"])
    def test_reference_saves_port_restores(self, tmp_path, which):
        jtree = self._states()[which]
        d = str(tmp_path)
        jck.save(d, 11, jtree)
        like = _carry(jax.tree.map(jnp.zeros_like, jtree))
        got, man = ck.restore(d, 11, like)
        assert type(got) is type(like) and man["step"] == 11
        _assert_state(got, jtree)
        # each leaf takes its like leaf's dtype (and device)
        wide = like._replace(n=like.n.to(torch.float64))
        assert ck.restore(d, 11, wide)[0].n.dtype == torch.float64

    @pytest.mark.parametrize("mode", ["truncate", "flip"])
    def test_torn_checkpoint_detected_and_fallback_bitwise(self, tmp_path,
                                                           mode):
        tree, like = _trees()
        d = str(tmp_path)
        ck.save(d, 100, tree, keep=5)
        ck.save(d, 200, {"w": torch.ones((3, 4)), "n": torch.tensor(1.0)},
                keep=5)
        rz.tear_checkpoint(d, 200, mode=mode, nbytes=32, seed=0)
        with pytest.raises(ck.CheckpointCorruptError):
            ck.restore(d, 200, like)
        restored, manifest = ck.CheckpointManager(d).restore_latest(like)
        assert manifest["step"] == 100
        assert torch.equal(restored["w"], tree["w"])

    def test_crc_catches_silent_leaf_rewrite(self, tmp_path):
        tree, like = _trees()
        d = str(tmp_path)
        npz = os.path.join(ck.save(d, 7, tree, keep=5), "arrays.npz")
        with np.load(npz) as z:
            arrays = {k: z[k].copy() for k in z.files}
        arrays["a0"] = arrays["a0"] + 1
        np.savez(npz, **arrays)
        with pytest.raises(ck.CheckpointCorruptError, match="CRC"):
            ck.restore(d, 7, like)

    def test_legacy_manifest_and_mismatches(self, tmp_path):
        import json
        tree, like = _trees()
        d = str(tmp_path)
        path = ck.save(d, 3, tree, keep=5)
        mp = os.path.join(path, "manifest.json")
        with open(mp) as f:
            man = json.load(f)
        man.pop("checksums")
        with open(mp, "w") as f:
            json.dump(man, f)
        restored, _ = ck.restore(d, 3, like)
        assert float(restored["n"]) == 7.0
        with pytest.raises(ValueError, match="tree mismatch"):
            ck.restore(d, 3, {"w": like["w"]})
        with pytest.raises(ValueError, match="shape mismatch"):
            ck.restore(d, 3, {"w": torch.zeros(2), "n": like["n"]})

    def test_all_corrupt_returns_none_and_gc(self, tmp_path):
        tree, like = _trees()
        d = str(tmp_path)
        ck.save(d, 1, tree, keep=5)
        rz.tear_checkpoint(d, 1, mode="truncate")
        assert ck.CheckpointManager(d).restore_latest(like) == (None, None)
        m = ck.CheckpointManager(d, interval=2, keep=2)
        assert m.maybe_save(3, tree) is None
        for s in (2, 4, 6):
            m.maybe_save(s, tree)
        assert ck.all_steps(d) == [4, 6] and ck.latest_step(d) == 6
        os.rename(os.path.join(d, "step_0000000004"), os.path.join(d,
                                                                  "step_4"))
        assert ck.all_steps(d) == [4, 6]
        assert ck.restore(d, 4, like)[1]["step"] == 4


# ---------------------------------------------------------------------------
# The Guardrail's lifecycle in lockstep with the reference's.
# ---------------------------------------------------------------------------

LIFE = {"flat": {}, "window": dict(window_epochs=2, rotate_every=2),
        "fleet": dict(num_tenants=2),
        "fleet_window": dict(num_tenants=2, window_epochs=2, rotate_every=2)}
LIFE_CASES = [(k, "mu_sigma") for k in LIFE] + [("flat", "quantile"),
                                                ("fleet", "quantile")]


def _count_to_host(monkeypatch):
    calls = []
    real = engine._to_host

    def counted(x):
        calls.append(tuple(x.shape))
        return real(x)
    monkeypatch.setattr(engine, "_to_host", counted)
    return calls


class TestGuardrailLifecycle:
    @pytest.mark.parametrize("kind,mode", LIFE_CASES,
                             ids=[f"{k}-{m}" for k, m in LIFE_CASES])
    def test_corrupt_degrade_repair_rewarm_in_lockstep(self, kind, mode,
                                                       monkeypatch):
        """The reference's lifecycle (its traffic, its flips), with the
        port's kernel-route and plain guardrails on the reference's W in
        lockstep: equal verdicts every admit, equal reports and
        ``degraded`` flags after every health_check and repair, the
        repaired states bitwise, recovery at the same admit, one
        ``_to_host`` an admit, degraded or not."""
        kw = dict(d_model=16, num_bits=6, num_tables=8, warmup_items=32.0,
                  threshold_mode=mode, quantile_q=0.05, **LIFE[kind])
        T = kw.get("num_tenants")
        gj = jengine.Guardrail(jengine.GuardrailConfig(**kw))
        w = params_from_numpy(np.asarray(gj.w), CPU)
        gps = [engine.Guardrail(engine.GuardrailConfig(**kw), device="cpu",
                                w=w, use_kernels=u) for u in (True, False)]
        calls = _count_to_host(monkeypatch)
        rng = np.random.default_rng(4)

        def serve():
            e = (rng.normal(size=(32, 2, 16))).astype(np.float32)
            t = None if T is None else rng.integers(0, T, 32).astype(
                np.int32)
            want = np.asarray(gj.admit(jnp.asarray(e)) if t is None
                              else gj.admit(jnp.asarray(e), tenant_ids=t))
            for gp in gps:
                before = len(calls)
                np.testing.assert_array_equal(gp.admit(e, t), want)
                assert calls[before:] == [(2, 32)], "one D2H an admit"

        def audit(method):
            jr = getattr(gj, method)()
            for gp in gps:
                _assert_report(getattr(gp, method)(), jr)
                assert gp.degraded == gj.degraded
                assert gp._rewarm_admits == gj._rewarm_admits
            return jr

        for _ in range(3):
            serve()
        assert not gj.degraded and not any(g.degraded for g in gps)
        counts = jrz.flip_count_bits(gj.state.counts, jax.random.PRNGKey(9),
                                     num_flips=3, tables=(2,))
        gj.state = gj.state._replace(counts=counts)
        for gp in gps:
            gp.state = gp.state._replace(counts=torch.as_tensor(
                np.array(counts)))
        rep = audit("health_check")
        assert gj.degraded and not np.asarray(rep.table_ok, bool).all()
        serve()                                       # degraded serving
        audit("repair")
        for gp in gps:
            _assert_state(gp.state, gj.state, streams_rtol=1e-5)
            assert bool(np.asarray(rz.health_check(
                gp.state, gp._repair_offsets).table_ok).all())
        assert gj.degraded, "repaired tables re-warm before serving"
        landed = None
        for i in range(8):
            serve()
            audit("health_check")
            if not gj.degraded:
                landed = i
                break
        assert landed is not None, "re-warm must finish within one window"
        serve()
        for gp in gps:
            assert not gp.degraded and gp._table_mask is None
            _assert_same(gp.state.counts, gj.state.counts, "counts")
            _assert_same(gp.state.n, gj.state.n, "n")

    def test_degraded_admit_scores_over_healthy_tables(self):
        """A saturated table behind the mask moves no verdict: a degraded
        guardrail admits like its twin whose table was never touched."""
        kw = dict(d_model=16, num_bits=6, num_tables=8, warmup_items=32.0)
        a = engine.Guardrail(engine.GuardrailConfig(**kw), device="cpu")
        rng = np.random.default_rng(5)
        for _ in range(4):
            a.admit(rng.normal(size=(32, 2, 16)).astype(np.float32))
        b = engine.Guardrail(engine.GuardrailConfig(**kw), device="cpu",
                             w=a.w)
        b.state = type(a.state)(*(None if x is None else x.clone()
                                  for x in a.state))
        a.state = a.state._replace(counts=rz.saturate_table(a.state.counts,
                                                            1))
        a.health_check()
        assert a.degraded
        b._table_mask = a._table_mask.clone()
        for _ in range(3):
            e = rng.normal(size=(32, 2, 16)).astype(np.float32)
            np.testing.assert_array_equal(a.admit(e), b.admit(e))
        np.testing.assert_array_equal(_np(a.state.counts[2:]),
                                      _np(b.state.counts[2:]))

    def test_all_masked_tenant_matches_reference(self):
        """A fleet tenant with every table masked: the masked mean and
        threshold divide by a clamped healthy count — verdicts and counts
        the reference's, in both port routes."""
        kw = dict(d_model=16, num_bits=6, num_tables=8, warmup_items=32.0,
                  num_tenants=2)
        gj = jengine.Guardrail(jengine.GuardrailConfig(**kw))
        w = params_from_numpy(np.asarray(gj.w), CPU)
        gps = [engine.Guardrail(engine.GuardrailConfig(**kw), device="cpu",
                                w=w, use_kernels=u) for u in (True, False)]
        mask = np.ones((2, 8), np.float32)
        mask[1] = 0.0
        mask[0, 3] = 0.0
        rng = np.random.default_rng(6)
        for i in range(5):
            if i == 3:
                gj._table_mask = jnp.asarray(mask)
                for gp in gps:
                    gp._table_mask = torch.as_tensor(mask)
            e = rng.normal(size=(32, 2, 16)).astype(np.float32)
            t = rng.integers(0, 2, 32).astype(np.int32)
            want = np.asarray(gj.admit(jnp.asarray(e), tenant_ids=t))
            for gp in gps:
                np.testing.assert_array_equal(gp.admit(e, t), want)
        for gp in gps:
            _assert_same(gp.state.counts, gj.state.counts, "counts")


# ---------------------------------------------------------------------------
# The chaos property (the reference's TestChaosProperty, on the port).
# ---------------------------------------------------------------------------

def _cone_embeds(rng, base, batch=32, seq=2, ood_rows=0):
    e = (base + 0.05 * rng.normal(size=(batch, seq, base.shape[-1]))
         ).astype(np.float32)
    if ood_rows:
        e[:ood_rows] = (-base + 0.05 * rng.normal(
            size=(ood_rows, seq, base.shape[-1]))).astype(np.float32)
    return e


class TestChaosProperty:
    def test_fleet_survives_nan_flips_and_torn_checkpoint(self, tmp_path,
                                                          monkeypatch):
        """NaN rows, ⌈L/4⌉ bit-flipped tables and a torn checkpoint against
        a fault-free oracle fed the same stream: the fleet keeps serving
        (degraded), healthy-table scores equal the oracle's, recall holds
        within 0.9× of fault-free, the repair re-converges within one
        warmup window, one D2H an admit throughout."""
        from repro_torch.core.srp import hash_buckets
        from repro_torch.data.pipeline import mean_embed_features
        L, T, B = 8, 2, 32
        gk = dict(d_model=16, num_bits=6, num_tables=L, num_tenants=T,
                  warmup_items=64.0, alpha=3.0)
        g = engine.Guardrail(engine.GuardrailConfig(**gk), device="cpu")
        oracle = engine.Guardrail(engine.GuardrailConfig(**gk), device="cpu",
                                  w=g.w)
        ff = engine.Guardrail(engine.GuardrailConfig(**gk), device="cpu",
                              w=g.w)
        calls = _count_to_host(monkeypatch)
        rng = np.random.default_rng(21)
        base = rng.normal(size=16)
        base = 4.0 * base / np.linalg.norm(base)
        tids = rng.integers(0, T, B).astype(np.int32)

        def serve(guard, e):
            before = len(calls)
            v = guard.admit(e, tids)
            assert len(calls) == before + 1, "one D2H an admit"
            return v

        for _ in range(6):
            e = _cone_embeds(rng, base)
            for guard in (g, oracle, ff):
                serve(guard, e)
        eval_batches = [_cone_embeds(np.random.default_rng(100 + i), base,
                                     ood_rows=8) for i in range(4)]
        recall_ff = sum(int((~serve(ff, e)[:8]).sum())
                        for e in eval_batches) / 32
        assert recall_ff > 0.5

        d = str(tmp_path)
        ck.save(d, 1, g.state, keep=5)
        e = _cone_embeds(rng, base)
        nan_rows = np.zeros(B, bool)
        nan_rows[10:14] = True
        e[nan_rows] = np.nan
        q_before = g.quarantined
        serve(g, e)
        clean = e.copy()
        clean[nan_rows] = _cone_embeds(rng, base, ood_rows=B)[nan_rows]
        v_orc = serve(oracle, clean)
        assert g.quarantined - q_before == 4

        flipped = sorted(rng.choice(L, size=-(-L // 4), replace=False))
        counts = g.state.counts
        for t in flipped:
            counts = rz.flip_count_bits(
                counts, torch.Generator().manual_seed(40 + int(t)),
                num_flips=2, tables=(int(t),))
        g.state = g.state._replace(counts=counts)
        ck.save(d, 2, g.state, keep=5)
        rz.tear_checkpoint(d, 2, mode="truncate")

        rep = g.health_check()
        assert g.degraded
        bad = set(np.nonzero(~rep.table_ok)[1].tolist())
        assert bad and bad <= set(int(t) for t in flipped), rep.table_ok

        assert not v_orc[nan_rows].any()
        feat = mean_embed_features(torch.as_tensor(_cone_embeds(rng, base)),
                                   0.25)
        b = hash_buckets(feat, g.w, g.ace_cfg.srp)
        jt = torch.as_tensor(tids)
        s_chaos = fl.fleet_scores(g.state, jt, b, table_mask=g._table_mask)
        s_orc = fl.fleet_scores(oracle.state, jt, b,
                                table_mask=g._table_mask)
        assert torch.equal(s_chaos, s_orc)

        recall_chaos = sum(int((~serve(g, e)[:8]).sum())
                           for e in eval_batches) / 32
        assert recall_chaos >= 0.9 * recall_ff, (recall_chaos, recall_ff)

        restored, manifest = ck.CheckpointManager(d).restore_latest(g.state)
        assert manifest["step"] == 1 and type(restored) is fl.FleetState

        g.repair()
        assert g.degraded
        min_rows = int(np.bincount(tids, minlength=T).min())
        for _ in range(int(np.ceil(gk["warmup_items"] / min_rows)) + 2):
            serve(g, _cone_embeds(rng, base))
            g.health_check()
            if not g.degraded:
                break
        assert not g.degraded, "re-converge within one warmup window"
        assert bool(rz.health_check(g.state, g._repair_offsets).ok.all())
