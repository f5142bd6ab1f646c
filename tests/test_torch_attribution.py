"""The port's heavy-hitter attribution (``repro_torch.attribution``, the
``attr_estimate`` kernel module and ``ops.attr_estimate``, the ``attr``
leaf of every state and the runner's ``hh_*`` summary fields) against the
reference's (``repro.attribution``, ``repro.kernels.ops.attr_estimate`` in
interpret mode, ``repro.stream``) on the same numpy-made inputs, the same
JAX-drawn W and the same JAX-drawn hash tables carried across
(``convert.attr_tables_from_numpy``), on the CPU, where every kernel
wrapper takes its plain version.

Tolerances:
* point estimates (``attr_estimate``, ``estimate_level``, ``estimate``)
  and the ``find_hh`` drill-down on the same plane and tables: equal by
  value, every lane (the invalid ones too).  By value, not as int32 bit
  views: an empty plane cell gives sign·0 = ±0.0, and which zero a median
  of zeros returns depends on the sort;
* coordinate and tenant rankings (``hh_coord``, ``hh_valid``,
  ``hh_tenant``), counts, n and keep masks: exact;
* planes, energies, drift vectors, L2 estimates, ``hh_est`` and
  ``hh_tenant_est``: rtol 1e-5 with an absolute 1e-5 × the largest
  magnitude — the port sums energies and sketches in a fixed
  deterministic order (node sums, then each cell's nodes), the reference
  scatters coordinate by coordinate, and a cell of the signed drift
  sketch can be a near-cancelling sum;
* inside the port (a fleet of one tenant against the flat path): bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro import attribution as jat  # noqa: E402
from repro.attribution import sketch as jatsk  # noqa: E402
from repro.core import sketch as jsk  # noqa: E402
from repro.data.pipeline import AceDataFilter as JFilter  # noqa: E402
from repro.fleet.filter import FleetDataFilter as JFleetFilter  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ref import attr_estimate_ref  # noqa: E402
from repro.stream.runner import StreamRunner as JRunner  # noqa: E402
from repro.window import ring as jring  # noqa: E402
from repro.window.filter import WindowedAceFilter as JWFilter  # noqa: E402
from repro_torch.attribution import sketch as at  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import sketch as sk  # noqa: E402
from repro_torch.data.pipeline import AceDataFilter  # noqa: E402
from repro_torch.fleet import state as fl  # noqa: E402
from repro_torch.fleet import window as fw  # noqa: E402
from repro_torch.fleet.filter import FleetDataFilter  # noqa: E402
from repro_torch.kernels import attr_estimate as AE  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.stream import runner as runner_mod  # noqa: E402
from repro_torch.stream.runner import StreamRunner  # noqa: E402
from repro_torch.window import ring  # noqa: E402
from repro_torch.window.filter import WindowedAceFilter  # noqa: E402
from repro_torch.window.ring import WindowConfig  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

CPU = torch.device("cpu")
RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want):
    """Float agreement at the module's tolerance (rtol 1e-5, absolute
    1e-5 × the largest magnitude)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


def _cfgs(dim, rows=5, bits=7, seed=3):
    """(JAX AttrConfig, port AttrConfig, port tables carrying JAX's)."""
    jc = jat.AttrConfig(dim=dim, rows=rows, bits=bits, seed=seed)
    pc = at.AttrConfig(dim=dim, rows=rows, bits=bits, seed=seed)
    cols, signs = jatsk._level_tables_np(jc)
    return jc, pc, convert.attr_tables_from_numpy(cols, signs, pc, CPU)


# ---------------------------------------------------------------------------
# The kernel module and ops.attr_estimate
# ---------------------------------------------------------------------------

class TestAttrEstimateKernel:
    @pytest.mark.parametrize("R", [1, 2, 3, 4, 5, 8])
    @pytest.mark.parametrize("B", [1, 16])
    def test_matches_reference_kernel_and_oracle(self, R, B):
        """Odd R (middle order statistic) and even R (midpoint) alike,
        with some repeated columns so values tie."""
        C = 64
        rng = np.random.default_rng(R * 100 + B)
        plane = rng.normal(size=(R, C)).astype(np.float32)
        plane[:, :4] = 0.0                       # empty cells: ±0 values
        cols = rng.integers(0, C, size=(B, R)).astype(np.int32)
        cols[: B // 2, 0] = 1
        signs = rng.choice([-1.0, 1.0], size=(B, R)).astype(np.float32)
        want = np.asarray(jops.attr_estimate(
            jnp.asarray(plane), jnp.asarray(cols), jnp.asarray(signs),
            interpret=True))
        np.testing.assert_array_equal(np.asarray(attr_estimate_ref(
            jnp.asarray(plane), jnp.asarray(cols), jnp.asarray(signs))), want)
        for fn in (AE.attr_estimate_plain, AE.attr_estimate,
                   ops.attr_estimate):
            got = fn(_t(plane), _t(cols), _t(signs))
            assert got.dtype == torch.float32 and got.shape == (B,)
            np.testing.assert_array_equal(got.numpy(), want)

    def test_columns_past_the_plane_are_clamped(self):
        """A column >= C reads the last cell, as the reference's gather
        clamps it."""
        rng = np.random.default_rng(5)
        plane = rng.normal(size=(3, 16)).astype(np.float32)
        cols = np.array([[15, 16, 99], [0, 1, 2]], np.int32)
        signs = np.ones((2, 3), np.float32)
        want = attr_estimate_ref(jnp.asarray(plane), jnp.asarray(cols),
                                 jnp.asarray(signs))
        got = ops.attr_estimate(_t(plane), _t(cols), _t(signs))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_wrapper_checks_its_operands(self):
        plane = torch.zeros((3, 8))
        cols = torch.zeros((4, 3), dtype=torch.int32)
        signs = torch.ones((4, 3))
        assert AE.attr_estimate(plane, cols, signs).shape == (4,)
        assert AE.attr_estimate(plane, cols[:0], signs[:0]).shape == (0,)
        with pytest.raises(TypeError):
            AE.attr_estimate(plane, cols.long(), signs)
        with pytest.raises(ValueError):
            AE.attr_estimate(plane, cols[:, :2].contiguous(), signs)
        with pytest.raises(ValueError):
            AE.attr_estimate(plane.to("meta"), cols, signs)
        before = AE.KERNEL.launches
        AE.attr_estimate(plane, cols, signs)
        assert AE.KERNEL.launches == before, "the plain version launches " \
            "nothing"


# ---------------------------------------------------------------------------
# Hash tables
# ---------------------------------------------------------------------------

class TestTables:
    def test_shapes_ranges_and_determinism(self):
        cfg = at.AttrConfig(dim=37, rows=4, bits=6, seed=3)
        t = at.make_tables(cfg, CPU)
        nl, d2 = cfg.num_levels, cfg.padded_dim
        assert (nl, d2) == (6, 64)
        assert t.cols.shape == t.signs.shape == (nl, d2, 4)
        assert t.cols.dtype == torch.int32 and t.signs.dtype == torch.float32
        assert int(t.cols.min()) >= 0 and int(t.cols.max()) < cfg.width
        assert set(t.signs.unique().tolist()) == {-1.0, 1.0}
        again = at.make_tables(cfg, CPU)
        for a, b in zip(t, again):
            assert torch.equal(a, b)
        other = at.make_tables(dataclasses.replace(cfg, seed=4), CPU)
        assert not torch.equal(t.cols, other.cols)
        assert not torch.equal(t.signs, other.signs)
        assert at.level_tables(cfg, CPU) is at.level_tables(cfg, "cpu")

    @pytest.mark.parametrize("dim,rows,bits", [(37, 4, 6), (48, 5, 7),
                                               (13, 1, 5)])
    def test_coord_tables_match_reference(self, dim, rows, bits):
        jc, pc, _ = _cfgs(dim, rows, bits)
        cols, signs = jatsk._level_tables_np(jc)
        off, sg = at._coord_tables_np(pc, cols, signs)
        want_off, want_sg = jatsk._coord_tables_np(jc)
        np.testing.assert_array_equal(off, want_off)
        np.testing.assert_array_equal(sg, want_sg)
        assert off.dtype == want_off.dtype and sg.dtype == want_sg.dtype

    def test_cell_tables_hold_every_real_node_once(self):
        cfg = at.AttrConfig(dim=37, rows=3, bits=4)
        t = at.make_tables(cfg, CPU)
        nodes = t.cell_nodes.numpy()
        for lvl in range(cfg.num_levels):
            real = ((cfg.dim - 1) >> (cfg.num_levels - 1 - lvl)) + 1
            base = (2 << lvl) - 2
            for r in range(cfg.rows):
                got = nodes[lvl, r][(nodes[lvl, r] >= base)
                                    & (nodes[lvl, r] < base + real)]
                assert sorted(got.tolist()) == list(range(base, base + real))

    def test_wrong_table_shape_raises(self):
        cfg = at.AttrConfig(dim=8, rows=2, bits=3)
        with pytest.raises(ValueError, match="attribution tables"):
            at.make_tables(cfg, CPU, np.zeros((3, 8, 3), np.int32),
                           np.ones((3, 8, 3), np.float32))


# ---------------------------------------------------------------------------
# Functions on the same plane and tables
# ---------------------------------------------------------------------------

class TestFunctions:
    @pytest.mark.parametrize("dim,rows,bits", [(48, 5, 7), (37, 4, 6),
                                               (13, 1, 5), (2, 3, 4)])
    def test_sketch_matches_reference(self, dim, rows, bits):
        jc, pc, tables = _cfgs(dim, rows, bits)
        rng = np.random.default_rng(dim)
        v = rng.normal(size=(dim,)).astype(np.float32)
        _close(at.sketch_vector(pc, tables, _t(v)).numpy(),
               jat.sketch_vector(jc, jnp.asarray(v)))
        e = np.abs(rng.normal(size=(2, 3, dim))).astype(np.float32)
        _close(at.chunk_planes(pc, tables, _t(e[0]), _t(e[1])).numpy(),
               jat.chunk_planes(jc, jnp.asarray(e[0]), jnp.asarray(e[1])))

    @pytest.mark.parametrize("dim,rows,bits,topk", [
        (37, 4, 6, 3), (13, 1, 5, 18), (2, 3, 4, 7)])
    def test_estimates_and_find_hh_match_reference(self, dim, rows, bits,
                                                   topk):
        """On the reference's own plane: every estimate and every lane of
        the drill-down equal (non-power-of-two dims, a one-level tree,
        topk past the number of valid coordinates)."""
        jc, pc, tables = _cfgs(dim, rows, bits)
        rng = np.random.default_rng(dim + 1)
        v = rng.normal(size=(dim,)).astype(np.float32) * 0.1
        v[dim // 2] = 9.0
        v[-1] = -7.0
        plane = jat.sketch_vector(jc, jnp.asarray(v))
        pp = _t(np.asarray(plane))
        nodes = rng.integers(0, pc.padded_dim, size=(12,)).astype(np.int32)
        for lvl in sorted({0, pc.num_levels // 2, pc.num_levels - 1}):
            np.testing.assert_array_equal(
                at.estimate_level(pc, tables, pp, _t(nodes), lvl).numpy(),
                np.asarray(jat.estimate_level(jc, plane, jnp.asarray(nodes),
                                              lvl)))
        coords = rng.integers(0, dim, size=(10,)).astype(np.int32)
        want = np.asarray(jat.estimate(jc, plane, jnp.asarray(coords),
                                       interpret=True))
        for use_kernels in (True, False):
            np.testing.assert_array_equal(at.estimate(
                pc, tables, pp, _t(coords), use_kernels).numpy(), want)
        want = [np.asarray(x) for x in jat.find_hh(jc, plane, topk)]
        for use_kernels in (True, False):
            got = at.find_hh(pc, tables, pp, topk, use_kernels)
            for g, w in zip(got, want):
                assert g.numpy().dtype == w.dtype
                np.testing.assert_array_equal(g.numpy(), w)
        _close(at.l2estimate(pp).numpy(), jat.l2estimate(plane))

    def test_find_hh_names_planted_coordinates(self):
        """The recovery the reference tests, through the port's own
        tables: every planted heavy coordinate named, signs kept, and
        padded coordinates of a non-power-of-two dim never valid."""
        cfg = at.AttrConfig(dim=37, rows=5, bits=7)
        tables = at.level_tables(cfg, CPU)
        v = np.random.default_rng(2).normal(size=(37,)).astype(np.float32)
        v *= 0.05
        v[[36, 5, 17]] = [8.0, -7.0, 6.0]
        coords, ests, valid = at.find_hh(
            cfg, tables, at.sketch_vector(cfg, tables, _t(v)), topk=3)
        assert valid.all() and (coords < 37).all()
        assert set(coords.tolist()) == {36, 5, 17}
        for c, e in zip(coords.tolist(), ests.tolist()):
            assert np.sign(e) == np.sign(v[c]) and abs(e - v[c]) < 1.0

    def test_find_hh_rejects_topk_below_one(self):
        cfg = at.AttrConfig(dim=8, rows=3, bits=3)
        with pytest.raises(ValueError, match="topk"):
            at.find_hh(cfg, at.level_tables(cfg, CPU),
                       torch.zeros((3, 3, 8)), 0)

    @pytest.mark.parametrize("tenants", [None, 3])
    def test_energy_drift_and_tenant_l2_match_reference(self, tenants):
        """Quarantined (−inf), warmup (+inf), flagged (< 0) and kept
        margins in one chunk, with and without tenant routing."""
        rng = np.random.default_rng(7)
        n, dim = 24, 11
        feat = rng.normal(size=(n, dim)).astype(np.float32)
        margins = rng.normal(size=(n,)).astype(np.float32)
        margins[:3] = -np.inf
        margins[3:6] = np.inf
        feat[:3] = 0.0                          # sanitized quarantined rows
        tids = None if tenants is None else rng.integers(
            0, tenants, size=(n,)).astype(np.int32)
        nt = tenants or 1
        want = jat.chunk_energy(jnp.asarray(feat), jnp.asarray(margins), nt,
                                None if tids is None else jnp.asarray(tids))
        got = at.chunk_energy(_t(feat), _t(margins), nt,
                              None if tids is None else _t(tids))
        for g, w in zip(got, want):
            _close(g.numpy(), w)
        _close(at.drift_vector(*got).numpy(), jat.drift_vector(*want))
        _close(at.tenant_drift_l2(*got).numpy(), jat.tenant_drift_l2(*want))
        # the quarantined rows are in neither channel, warmup rows only in
        # the background
        assert float(got[2].sum()) == n - 3
        assert float(got[3].sum()) == float((margins[6:] < 0).sum())


# ---------------------------------------------------------------------------
# State wiring (the reference's TestStateWiring, and every rebuild site)
# ---------------------------------------------------------------------------

_KW = dict(dim=13, num_bits=5, num_tables=6, attr_rows=3, attr_bits=5)
_ACFG = sk.AceConfig(**_KW)


def _planes(rng, shape):
    return _t(rng.normal(size=shape).astype(np.float32))


class TestStateWiring:
    def test_config_and_init_match_reference(self):
        jcfg = jsk.AceConfig(**_KW)
        assert dataclasses.asdict(_ACFG.attr) == dataclasses.asdict(jcfg.attr)
        assert _ACFG.attr.memory_bytes() == jcfg.attr.memory_bytes()
        assert tuple(sk.init(_ACFG, CPU).attr.shape) == jcfg.attr.plane_shape()
        assert sk.init(sk.AceConfig(dim=13), CPU).attr is None
        js = jsk.init(jcfg)
        js = js._replace(attr=js.attr + 1.5)
        ps = convert.state_from_numpy(js.counts, js.n, js.welford_mean,
                                      js.welford_m2, CPU, attr=js.attr)
        np.testing.assert_array_equal(ps.attr.numpy(), np.asarray(js.attr))
        assert ps.attr.dtype == torch.float32
        assert sk.AceConfig(dim=13).attr is None
        for bad in (dict(attr_bits=0), dict(attr_bits=21)):
            with pytest.raises(ValueError, match="bits"):
                sk.AceConfig(**{**_KW, **bad})
        with pytest.raises(ValueError, match="attr_rows"):
            sk.AceConfig(dim=13, attr_rows=-1)

    def test_flat_merge_adds_attr_planes(self):
        rng = np.random.default_rng(10)
        shape = _ACFG.attr.plane_shape()
        a = sk.init(_ACFG, CPU)._replace(attr=_planes(rng, shape))
        b = sk.init(_ACFG, CPU)._replace(attr=_planes(rng, shape))
        assert torch.equal(sk.merge(a, b).attr, a.attr + b.attr)
        with pytest.raises(ValueError, match="attribution"):
            sk.merge(a, b._replace(attr=None))
        assert sk.merge(a._replace(attr=None),
                        b._replace(attr=None)).attr is None

    def test_fleet_merge_set_view_and_stack_carry_planes(self):
        rng = np.random.default_rng(11)
        fcfg = fl.FleetConfig(ace=_ACFG, num_tenants=3)
        shape = (3,) + _ACFG.attr.plane_shape()
        a = fl.init(fcfg, CPU)._replace(attr=_planes(rng, shape))
        b = fl.init(fcfg, CPU)._replace(attr=_planes(rng, shape))
        assert torch.equal(fl.merge_fleet(a, b).attr, a.attr + b.attr)
        with pytest.raises(ValueError, match="attribution"):
            fl.merge_fleet(a, b._replace(attr=None))
        one = fl.tenant_view(a, 1)
        assert torch.equal(one.attr, a.attr[1])
        s = fl.set_tenant(b, 2, one)
        assert torch.equal(s.attr[2], a.attr[1])
        assert torch.equal(s.attr[:2], b.attr[:2])
        stacked = fl.from_states([fl.tenant_view(a, t) for t in range(3)])
        assert torch.equal(stacked.attr, a.attr)

    def test_window_rotate_zeroes_only_new_live_row(self):
        E = 4
        st = ring.init(_ACFG, E, CPU)
        assert tuple(st.attr.shape) == (E,) + _ACFG.attr.plane_shape()
        rot = ring.rotate(st._replace(attr=torch.ones_like(st.attr)))
        c = int(rot.cursor)
        assert float(rot.attr[c].abs().sum()) == 0.0
        for e in range(E):
            if e != c:
                assert bool((rot.attr[e] == 1).all()), e
        jst = jring.init(jsk.AceConfig(**_KW), E)
        jrot = jring.rotate(jst._replace(attr=jnp.ones_like(jst.attr)))
        np.testing.assert_array_equal(rot.attr.numpy(), np.asarray(jrot.attr))

    def test_fleet_window_rotate_zeroes_each_tenants_new_live_row(self):
        T, E = 3, 4
        st = fw.init_fleet_window(WindowConfig(ace=_ACFG, num_epochs=E), T,
                                  CPU)
        assert tuple(st.attr.shape) == (T, E) + _ACFG.attr.plane_shape()
        st = st._replace(attr=torch.ones_like(st.attr),
                         cursor=torch.tensor([0, 2, 3], dtype=torch.int32))
        rot = fw.rotate_fleet(st)
        for t, c in enumerate(rot.cursor.tolist()):
            assert float(rot.attr[t, c].abs().sum()) == 0.0
            assert float(rot.attr[t].sum()) == float(
                rot.attr[t].numel() * (E - 1) / E)
        view = fw.tenant_window_view(rot, 1)
        assert torch.equal(view.attr, rot.attr[1])
        assert torch.equal(fw.set_tenant_window(st, 1, view).attr[1],
                           rot.attr[1])

    def test_observe_window_touches_cursor_row_only(self):
        st = ring.init(_ACFG, 3, CPU)
        out = at.observe_window(st.attr, torch.ones(_ACFG.attr.plane_shape()),
                                torch.tensor(1, dtype=torch.int32))
        assert bool((out[1] == 1).all())
        assert float(out[0].abs().sum()) == float(out[2].abs().sum()) == 0.0

    def test_observe_fleet_window_per_tenant_cursors(self):
        pshape = _ACFG.attr.plane_shape()
        T, E = 3, 4
        attr = torch.zeros((T, E) + pshape)
        planes = torch.stack([torch.full(pshape, float(t + 1))
                              for t in range(T)])
        cursor = torch.tensor([0, 2, 3], dtype=torch.int32)
        out = at.observe_fleet_window(attr, planes, cursor)
        want = jat.observe_fleet_window(jnp.asarray(attr.numpy()),
                                        jnp.asarray(planes.numpy()),
                                        jnp.asarray(cursor.numpy()))
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
        for t, c in enumerate([0, 2, 3]):
            assert bool((out[t, c] == t + 1).all())
            others = [e for e in range(E) if e != c]
            assert float(out[t, others].abs().sum()) == 0.0

    def test_inserts_and_views_keep_the_planes(self):
        """Every function that rebuilds a state carries ``attr`` as it
        was (flat inserts, kernel-path inserts and admits, the fleet's,
        and the views)."""
        rng = np.random.default_rng(12)
        cfg = _ACFG
        attr = _planes(rng, cfg.attr.plane_shape())
        st = sk.init(cfg, CPU)._replace(attr=attr)
        ids = _t(rng.integers(0, 32, size=(5, 6)).astype(np.int32))
        x = _t(rng.normal(size=(5, 13)).astype(np.float32))
        w = sk.make_params(cfg)
        mask = torch.tensor([True, False, True, True, False])
        outs = {
            "insert_buckets": sk.insert_buckets(st, ids, cfg),
            "insert_buckets_masked": sk.insert_buckets_masked(st, ids, mask,
                                                              cfg),
            "delete_buckets": sk.delete_buckets(st, ids, cfg),
            "ops.ace_update": ops.ace_update(
                st._replace(counts=st.counts.clone()), ids, cfg),
            "ops.ace_admit_at": ops.ace_admit_at(
                st._replace(counts=st.counts.clone()), x, w, cfg,
                torch.tensor(float("-inf")))[0],
            "ops.ace_admit": ops.ace_admit(
                st._replace(counts=st.counts.clone()), x, w, cfg,
                alpha=1.0, warmup_items=0.0)[0],
        }
        for name, out in outs.items():
            assert out.attr is attr, name
        fcfg = fl.FleetConfig(ace=cfg, num_tenants=2)
        fattr = _planes(rng, (2,) + cfg.attr.plane_shape())
        fst = fl.init(fcfg, CPU)._replace(attr=fattr)
        tids = torch.tensor([0, 1, 1, 0, 1], dtype=torch.int32)
        assert fl.insert_masked(fst, tids, ids, mask, cfg).attr is fattr
        assert ops.ace_fleet_admit_at(
            fst._replace(counts=fst.counts.clone()), x, tids, w, cfg,
            torch.full((5,), float("-inf")))[0].attr is fattr
        wst = ring.init(cfg, 3, CPU)
        wst = wst._replace(attr=_planes(rng, tuple(wst.attr.shape)),
                           cursor=torch.tensor(2, dtype=torch.int32))
        assert torch.equal(ring.live_epoch(wst).attr, wst.attr[2])
        assert torch.allclose(ring.combined_ace(wst).attr, wst.attr.sum(0))
        assert ring.insert_current(wst, ids, mask, cfg).attr is wst.attr


# ---------------------------------------------------------------------------
# The stream runner against the reference's
# ---------------------------------------------------------------------------

D, CT, B = 16, 4, 8
PLANTED = (3, 11)
FKW = dict(d_model=D, num_bits=5, num_tables=8, warmup_items=16.0,
           alpha=3.0, attr_rows=5, attr_bits=6)
FILTERS = {"dense": (JFilter, AceDataFilter, {}),
           "srht": (JFilter, AceDataFilter, dict(hash_mode="srht")),
           "window": (JWFilter, WindowedAceFilter,
                      dict(num_epochs=3, rotate_every=2)),
           "fleet": (JFleetFilter, FleetDataFilter, dict(num_tenants=3))}


def _chunk(rng, attack=False):
    """(CT, B, D+1) features around one cone; an attacked chunk moves the
    energy of its first 3 rows a step onto the planted dims."""
    x = (rng.normal(size=(CT, B, D + 1)) * 0.3).astype(np.float32)
    x[..., : D // 3] += 2.0
    if attack:
        x[:, :3, : D // 3] = 0.1
        x[:, :3, list(PLANTED)] = 8.0
    return x


def _pair(kind, **kw):
    """The reference's runner and the port's on one W and one set of
    attribution tables."""
    jcls, pcls, extra = FILTERS[kind]
    kw = {**FKW, **extra, **kw}
    jf = jcls(**kw)
    acfg = jf.ace_cfg.attr
    tables = convert.attr_tables_from_numpy(*jatsk._level_tables_np(acfg),
                                            acfg, CPU)
    pf = pcls(**kw, device="cpu", attr_tables=tables)
    jr, pr = JRunner(jf, chunk_T=CT, topk=4), StreamRunner(pf, chunk_T=CT,
                                                           topk=4)
    (js, jw), (ps, _) = jr.init(), pr.init()
    return jr, pr, (js, jw), (ps, convert.params_from_numpy(np.asarray(jw),
                                                            CPU))


def _compare(psum, jsum, pstate, jstate):
    jsum = jax.device_get(jsum)
    for f in ("hh_coord", "hh_valid", "hh_tenant", "topk_valid"):
        want = getattr(jsum, f, None)
        if want is not None:
            np.testing.assert_array_equal(getattr(psum, f), np.asarray(want),
                                          err_msg=f)
    for f in ("hh_est", "hh_tenant_est"):
        want = getattr(jsum, f, None)
        if want is not None:
            _close(getattr(psum, f), want)
    _close(pstate.attr.numpy(), jstate.attr)


class TestStreamRunner:
    @pytest.mark.parametrize("kind", sorted(FILTERS))
    def test_consume_matches_reference(self, kind):
        """Three background chunks then an attacked one, with a NaN row:
        the hh_* fields and the planes after every chunk; the attacked
        chunk names the planted dims (and, for a fleet, its tenant)."""
        jr, pr, (js, jw), (ps, pw) = _pair(kind)
        rng = np.random.default_rng(20)
        tids = rng.integers(0, 3, size=(CT, B)).astype(np.int32)
        tids[:, :3] = 1                          # the attack rows' tenant
        for i in range(4):
            f = _chunk(rng, attack=i == 3)
            f[1, 4, 2] = np.nan
            extra = ((jnp.asarray(tids),), (_t(tids),)) \
                if kind == "fleet" else ((), ())
            js, jsum = jr.consume(js, jw, jnp.asarray(f), *extra[0])
            ps, psum = pr.consume(ps, pw, _t(f), *extra[1])
            host = pr.fetch(psum)
            _compare(host, jsum, ps, js)
        named = set(host.hh_coord[host.hh_valid].tolist())
        assert set(PLANTED) <= named, named
        if kind == "fleet":
            assert host.hh_tenant.dtype == np.int32
            assert host.hh_tenant.shape == (3,) and host.hh_tenant[0] == 1
        if kind == "window":
            assert float(ps.attr[int(ps.cursor)].abs().sum()) > 0.0

    @pytest.mark.parametrize("kind", ["dense", "fleet"])
    def test_run_fetches_hh_fields_in_one_transfer(self, kind, monkeypatch):
        h2d, d2h = [], []
        real_in, real_out = runner_mod._to_device, runner_mod._to_host

        def to_device(x, device):
            h2d.append(x.shape)
            return real_in(x, device)

        def to_host(x):
            d2h.append(tuple(x.shape))
            return real_out(x)
        monkeypatch.setattr(runner_mod, "_to_device", to_device)
        monkeypatch.setattr(runner_mod, "_to_host", to_host)
        jr, pr, (js, jw), (ps, pw) = _pair(kind)
        rng = np.random.default_rng(21)
        feats = [b for i in range(3) for b in _chunk(rng, attack=i == 2)]
        tids = None
        if kind == "fleet":
            tids = [rng.integers(0, 3, size=(B,)).astype(np.int32)
                    for _ in feats]
        ps, psums = pr.run(ps, pw, feats, tids)
        js, jsums = jr.run(js, jw, [jnp.asarray(f) for f in feats],
                           None if tids is None
                           else [jnp.asarray(t) for t in tids])
        assert len(h2d) == len(d2h) == 3
        for got, want in zip(psums, jsums):
            assert got.hh_coord.shape == (4,)
            assert got.hh_est.dtype == np.float32
            _compare(got, want, ps, js)

    @pytest.mark.parametrize("use_kernels", [True, False])
    def test_fleet_of_one_is_the_flat_path_bitwise(self, use_kernels):
        flat = AceDataFilter(**FKW, use_kernels=use_kernels, device="cpu")
        fleet = FleetDataFilter(**FKW, num_tenants=1,
                                use_kernels=use_kernels, device="cpu")
        r1, rf = StreamRunner(flat, CT, topk=4), StreamRunner(fleet, CT,
                                                              topk=4)
        (s1, w), (sf, _) = r1.init(), rf.init()
        tids = torch.zeros((CT, B), dtype=torch.int32)
        rng = np.random.default_rng(22)
        for i in range(3):
            f = _t(_chunk(rng, attack=i == 2))
            s1, a = r1.consume(s1, w, f)
            sf, b = rf.consume(sf, w, f, tids)
            for k in ("hh_coord", "hh_est", "hh_valid"):
                assert torch.equal(getattr(a, k), getattr(b, k)), k
            assert b.hh_tenant.tolist() == [0]
        assert torch.equal(s1.attr, sf.attr[0])

    def test_all_quarantined_chunk(self):
        """A chunk of NaN rows adds nothing to the planes, reports no
        valid top-k row and estimates 0 for every coordinate it names —
        as the reference does: its ``hh_valid`` marks lanes that are real
        coordinates, not drift, so those lanes stay valid."""
        jr, pr, (js, jw), (ps, pw) = _pair("dense")
        rng = np.random.default_rng(23)
        for _ in range(2):
            f = _chunk(rng)
            js, _ = jr.consume(js, jw, jnp.asarray(f))
            ps, _ = pr.consume(ps, pw, _t(f))
        before = ps.attr.clone()
        dirty = np.full((CT, B, D + 1), np.nan, np.float32)
        js, jsum = jr.consume(js, jw, jnp.asarray(dirty))
        ps, psum = pr.consume(ps, pw, _t(dirty))
        host = pr.fetch(psum)
        _compare(host, jsum, ps, js)
        assert torch.equal(ps.attr, before)
        assert int(host.quarantined) == CT * B and not host.topk_valid.any()
        assert (host.hh_est == 0.0).all()

    def test_without_attribution_no_hh_fields(self):
        pf = AceDataFilter(**{**FKW, "attr_rows": 0}, device="cpu")
        assert pf.attr_tables is None
        runner = StreamRunner(pf, CT)
        s, w = runner.init()
        assert s.attr is None
        s, summary = runner.consume(s, w, _t(_chunk(np.random.default_rng(1))))
        assert summary.hh_coord is None and s.attr is None


class TestPostMortem:
    def test_drift_postmortem_scenario(self):
        """``examples/drift_postmortem.py`` through the port at its own
        small width: the flat summary names the planted dims, and the
        fleet's ``hh_tenant[0]`` is the tenant the attack was routed to."""
        dim, batch, chunk_t = 24, 32, 8
        planted, offender, tenants = (3, 11, 17), 2, 4
        rng = np.random.default_rng(0)

        def background():
            x = rng.normal(size=(chunk_t, batch, dim + 1)).astype(np.float32)
            x *= 0.3
            x[..., : dim // 3] += 2.0
            return x

        def attacked():
            x = background()
            x[:, :8, : dim // 3] = 0.1
            x[:, :8, list(planted)] = 8.0
            return x
        kw = dict(d_model=dim, num_bits=6, num_tables=16, warmup_items=64.0,
                  alpha=3.0, attr_rows=5, attr_bits=8, device="cpu")
        runner = StreamRunner(AceDataFilter(**kw), chunk_t, topk=3)
        state, w = runner.init()
        for _ in range(4):
            state, _ = runner.consume(state, w, _t(background()))
        state, summary = runner.consume(state, w, _t(attacked()))
        s = runner.fetch(summary)
        assert set(planted) <= set(s.hh_coord[s.hh_valid].tolist())
        # the post-mortem batch query over every coordinate of the
        # anomaly channel: the planted dims carry the largest estimates
        filt = runner.filt
        acfg = filt.ace_cfg.attr
        est = at.estimate(acfg, filt.attr_tables, state.attr[1],
                          torch.arange(dim + 1, dtype=torch.int32))
        assert set(torch.topk(est, 3).indices.tolist()) == set(planted)

        frunner = StreamRunner(FleetDataFilter(**kw, num_tenants=tenants),
                               chunk_t, topk=3)
        fstate, fw_ = frunner.init()
        tids = rng.integers(0, tenants, size=(chunk_t, batch)).astype(
            np.int32)
        for _ in range(6):
            fstate, _ = frunner.consume(fstate, fw_, _t(background()),
                                        _t(tids))
        tids_attack = tids.copy()
        tids_attack[:, :8] = offender
        fstate, fsum = frunner.consume(fstate, fw_, _t(attacked()),
                                       _t(tids_attack))
        fs = frunner.fetch(fsum)
        assert int(fs.hh_tenant[0]) == offender
        assert set(planted) <= set(fs.hh_coord[fs.hh_valid].tolist())
