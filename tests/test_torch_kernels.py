"""The port's kernel modules (``repro_torch.kernels``) on CPU tensors,
where each wrapper takes its plain PyTorch version, against the
reference's oracles (``repro.kernels.ref``) on the same numpy-made inputs
and the same projection matrix W (drawn by JAX, carried across with
``repro_torch.core.convert``).

Tolerances:
* hash bucket ids: agreement >= 0.999, the reference's own floor for its
  dense-hash kernels (tests/test_kernels.py, TestKernelParityMatrix);
* everything downstream of one set of bucket ids — counts, gathers,
  pre-insert scores, admit masks — bitwise (every count sum here stays far
  below 2^24, so float sums of counts are exact in any order);
* weighted (table-masked) scores, and sums of non-integer tail values:
  rtol 1e-6, the reference's tolerance for its own fused kernels — its
  sum runs in XLA's order, the port's in table order.

``srht_hash`` has its own file, tests/test_torch_srht.py.

The CUDA kernels themselves run only on a GPU; ``chip_smoke.py`` holds
each against these plain versions there.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro.core.srp import SrpConfig as JSrpConfig  # noqa: E402
from repro.core.srp import make_projections as jax_projections  # noqa: E402
from repro.kernels import ref as R  # noqa: E402
from repro.kernels.ace_admit_fused import \
    ace_admit_fused as jax_admit_fused  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402
from repro_torch.core.srp import SrpConfig  # noqa: E402
from repro_torch.kernels import ace_admit_fused as A  # noqa: E402
from repro_torch.kernels import ace_fleet_score as FS  # noqa: E402
from repro_torch.kernels import ace_fleet_window_admit as FWA  # noqa: E402
from repro_torch.kernels import ace_query as Q  # noqa: E402
from repro_torch.kernels import ace_window_combine as WC  # noqa: E402
from repro_torch.kernels import attr_estimate as AE  # noqa: E402
from repro_torch.kernels import ace_score_fused as F  # noqa: E402
from repro_torch.kernels import srht_hash as SH  # noqa: E402
from repro_torch.kernels import ace_update as U  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import srp_hash as H  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

CPU = torch.device("cpu")
HASH_AGREEMENT = 0.999

# (B, d, K, L): awkward sizes, the paper's K=15/L=50, and the KDD d=36
SHAPES = [(16, 32, 8, 10), (7, 9, 4, 3), (33, 128, 12, 50), (64, 36, 15, 50)]


def _inputs(B, d, K, L, seed=0, repeat=1):
    """Same inputs for both packages: JAX's W, numpy x and counts.
    ``repeat`` > 1 stacks copies of the rows so buckets collide."""
    jcfg = JSrpConfig(dim=d, num_bits=K, num_tables=L, seed=seed + 1)
    cfg = SrpConfig(dim=d, num_bits=K, num_tables=L, seed=seed + 1)
    w = np.asarray(jax_projections(jcfg))
    rng = np.random.default_rng(seed + 2)
    x = rng.normal(size=(B, d)).astype(np.float32)
    x = np.concatenate([x] * repeat)
    counts = rng.integers(0, 9, size=(L, 1 << K)).astype(np.int32)
    return jcfg, cfg, w, x, counts


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ids(B, K, L, seed, repeat=1):
    ids = np.random.default_rng(seed).integers(0, 1 << K, size=(B, L))
    return np.concatenate([ids] * repeat).astype(np.int32)


class TestSrpHash:
    @pytest.mark.parametrize("B,d,K,L", SHAPES)
    def test_matches_ref(self, B, d, K, L):
        jcfg, cfg, w, x, _ = _inputs(B, d, K, L)
        got = H.srp_hash(_t(x), params_from_numpy(w, CPU), cfg)
        want = np.asarray(R.srp_hash_ref(jnp.asarray(x), jnp.asarray(w),
                                         jcfg))
        assert got.dtype == torch.int32 and tuple(got.shape) == (B, L)
        assert (got.numpy() == want).mean() >= HASH_AGREEMENT

    def test_empty_batch(self):
        _, cfg, w, _, _ = _inputs(4, 8, 5, 3)
        got = H.srp_hash(torch.zeros((0, 8)), params_from_numpy(w, CPU), cfg)
        assert tuple(got.shape) == (0, 3)


class TestAceUpdate:
    @pytest.mark.parametrize("B,K,L,repeat", [(40, 4, 3, 1), (30, 6, 10, 4),
                                              (128, 15, 50, 2)])
    def test_matches_ref_with_collisions(self, B, K, L, repeat):
        """Repeated rows and a tiny bucket space make ids collide."""
        counts = np.random.default_rng(1).integers(
            0, 9, size=(L, 1 << K)).astype(np.int32)
        ids = _ids(B, K, L, 2, repeat)
        c = _t(counts.copy())
        got = U.ace_update(c, _t(ids))
        want = np.asarray(R.ace_update_ref(jnp.asarray(counts),
                                           jnp.asarray(ids)))
        assert got is c, "the update is in place"
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
    def test_row_mask_matches_masked_insert(self, density):
        """With a row mask only the masked rows insert: the counts of the
        reference's ``insert_buckets_masked``."""
        from repro.core import sketch as jsk
        K, L = 6, 10
        jcfg = jsk.AceConfig(dim=4, num_bits=K, num_tables=L)
        counts = np.random.default_rng(1).integers(
            0, 9, size=(L, 1 << K)).astype(np.int32)
        ids = _ids(30, K, L, 2, repeat=2)
        mask = np.random.default_rng(3).random(60) < density
        want = jsk.insert_buckets_masked(
            jsk.init(jcfg)._replace(counts=jnp.asarray(counts)),
            jnp.asarray(ids), jnp.asarray(mask), jcfg).counts
        got = U.ace_update(_t(counts.copy()), _t(ids), row_mask=_t(mask))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        with pytest.raises(TypeError):
            U.ace_update(_t(counts), _t(ids), row_mask=_t(mask).int())


class TestAceQuery:
    @pytest.mark.parametrize("B,K,L", [(40, 4, 3), (33, 12, 50),
                                       (64, 15, 50)])
    def test_matches_ref(self, B, K, L):
        counts = np.random.default_rng(3).integers(
            0, 1000, size=(L, 1 << K)).astype(np.int32)
        ids = _ids(B, K, L, 4, 2)
        got = Q.ace_query(_t(counts), _t(ids))
        want = np.asarray(R.ace_query_ref(jnp.asarray(counts),
                                          jnp.asarray(ids)))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)

    def test_ops_mean_matches_reference_ops(self):
        """``ops.ace_query``: the gather kernel + the mean over L, against
        the reference's own kernel-path op (Pallas, interpret mode)."""
        from repro.core import sketch as jsk
        from repro.kernels import ops as jops
        from repro_torch.core.convert import state_from_numpy
        from repro_torch.kernels import ops
        counts = np.random.default_rng(7).integers(
            0, 1000, size=(10, 1 << 8)).astype(np.int32)
        ids = _ids(33, 8, 10, 8)
        js = jsk.init(jsk.AceConfig(dim=4, num_bits=8, num_tables=10))
        js = js._replace(counts=jnp.asarray(counts))
        got = ops.ace_query(state_from_numpy(counts, 0, 0, 0, CPU), _t(ids))
        want = jops.ace_query(js, jnp.asarray(ids))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


class TestAceScoreFused:
    @pytest.mark.parametrize("weighted", [False, True])
    @pytest.mark.parametrize("B,d,K,L", SHAPES)
    def test_matches_pallas_kernel_in_interpret_mode(self, B, d, K, L,
                                                     weighted):
        """The Pallas kernel itself (interpret mode), on JAX's W, with and
        without ``table_weights`` (two tables masked, the rest weighted
        1/num_healthy)."""
        from repro.kernels.ace_score_fused import ace_score_fused as jfused
        jcfg, cfg, w, x, counts = _inputs(B, d, K, L)
        tw = None
        if weighted:
            m = np.ones(L, np.float32)
            m[[0, L // 2]] = 0.0
            tw = (m / max(m.sum(), 1.0)).astype(np.float32)
        want = np.asarray(jfused(
            jnp.asarray(counts), jnp.asarray(x), jnp.asarray(w), jcfg,
            interpret=True,
            table_weights=None if tw is None else jnp.asarray(tw)))
        got = F.ace_score_fused(_t(counts), _t(x), params_from_numpy(w, CPU),
                                cfg, table_weights=None if tw is None
                                else _t(tw))
        assert got.dtype == torch.float32 and tuple(got.shape) == (B,)
        ids = H.srp_hash(_t(x), params_from_numpy(w, CPU), cfg).numpy()
        jids = np.asarray(R.srp_hash_ref(jnp.asarray(x), jnp.asarray(w),
                                         jcfg))
        assert (ids == jids).mean() >= HASH_AGREEMENT
        same = (ids == jids).all(axis=1)
        if weighted:
            np.testing.assert_allclose(got.numpy()[same], want[same],
                                       rtol=1e-6)
        else:
            np.testing.assert_array_equal(got.numpy()[same], want[same])

    def test_sums_in_table_order(self):
        """Above 2^24 a float sum depends on its order: the weighted form
        adds the L products in table order j = 0..L−1, as the kernel does;
        the unweighted form takes ``ace_query_sum``'s exact integer sum,
        rounded once, then × float32(1/L)."""
        _, cfg, w, x, _ = _inputs(5, 8, 4, 3)
        counts = np.zeros((3, 16), np.int32)
        counts[0], counts[1], counts[2] = 1 << 24, 1, 1
        pw = params_from_numpy(w, CPU)
        got = F.ace_score_fused(_t(counts), _t(x), pw, cfg,
                                table_weights=torch.ones(3))
        s = np.float32(1 << 24)
        for v in (1.0, 1.0):
            s = np.float32(s + np.float32(v))
        np.testing.assert_array_equal(got.numpy(), np.full(5, s, np.float32))
        got = F.ace_score_fused(_t(counts), _t(x), pw, cfg)
        np.testing.assert_array_equal(
            got.numpy(), np.full(5, np.float32((1 << 24) + 2)
                                 * np.float32(1.0 / 3), np.float32))

    def test_flat_table_gather_matches_reference(self):
        from repro.kernels.ace_score_fused import flat_table_gather as jflat
        counts = np.random.default_rng(4).integers(
            0, 99, size=(7, 64)).astype(np.int32)
        ids = _ids(11, 6, 7, 5)
        np.testing.assert_array_equal(
            F.flat_table_gather(_t(counts), _t(ids)).numpy(),
            np.asarray(jflat(jnp.asarray(counts), jnp.asarray(ids), 7, 64)))

    def test_empty_batch(self):
        _, cfg, w, _, counts = _inputs(4, 8, 5, 3)
        got = F.ace_score_fused(_t(counts), torch.zeros((0, 8)),
                                params_from_numpy(w, CPU), cfg)
        assert tuple(got.shape) == (0,)


class TestOps:
    """``repro_torch.kernels.ops`` against the reference's kernel-path ops
    (Pallas in interpret mode) on the same state and W."""

    def _pair(self, mode, d=24, K=6, L=8, seed=2, min_n=0.0):
        from repro.core import sketch as jsk
        from repro_torch.core import sketch as sk
        kw = dict(dim=d, num_bits=K, num_tables=L, seed=seed,
                  hash_mode=mode, welford_min_n=min_n)
        jcfg, cfg = jsk.AceConfig(**kw), sk.AceConfig(**kw)
        jw = jsk.make_params(jcfg)
        ids = _ids(60, K, L, seed)
        js = jsk.insert_buckets(jsk.init(jcfg), jnp.asarray(ids), jcfg)
        ps = sk.insert_buckets(sk.init(cfg, CPU), _t(ids), cfg)
        return jcfg, cfg, jw, params_from_numpy(np.asarray(jw), CPU), js, ps

    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("mode", ["dense", "srht"])
    def test_ace_score_and_query(self, mode, masked):
        from repro.kernels import ops as jops
        from repro_torch.kernels import ops
        jcfg, cfg, jw, w, js, ps = self._pair(mode)
        x = np.random.default_rng(3).normal(size=(20, 24)).astype(np.float32)
        mask = None
        if masked:
            mask = np.ones(8, np.float32)
            mask[[1, 6]] = 0.0
        jm = None if mask is None else jnp.asarray(mask)
        pm = None if mask is None else _t(mask)
        want = np.asarray(jops.ace_score(js, jnp.asarray(x), jw, jcfg,
                                         table_mask=jm))
        got = ops.ace_score(ps, _t(x), w, cfg, table_mask=pm).numpy()
        ids = ops.hash_dispatch(_t(x), w, cfg.srp)
        jids = np.asarray(jops.hash_dispatch(jnp.asarray(x), jw, jcfg.srp))
        same = (ids.numpy() == jids).all(axis=1)
        assert same.mean() >= 0.9
        np.testing.assert_allclose(got[same], want[same], rtol=1e-6)
        np.testing.assert_allclose(
            ops.ace_query(ps, ids, table_mask=pm).numpy(),
            np.asarray(jops.ace_query(js, jnp.asarray(ids.numpy()),
                                      table_mask=jm)), rtol=1e-6)

    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("mode", ["dense", "srht"])
    def test_ace_admit(self, mode, masked):
        """Admission in both hash families, healthy and degraded, with a
        quarantine mask: the same admits and counts as the reference's
        ``ops.ace_admit``, n bitwise, Welford at rtol 1e-5."""
        from repro.kernels import ops as jops
        from repro_torch.kernels import ops
        jcfg, cfg, jw, w, js, ps = self._pair(mode, min_n=8.0)
        rng = np.random.default_rng(5)
        x = rng.normal(size=(24, 24)).astype(np.float32)
        item = rng.random(24) < 0.8
        mask = None
        if masked:
            mask = np.ones(8, np.float32)
            mask[3] = 0.0
        jm = None if mask is None else jnp.asarray(mask)
        pm = None if mask is None else _t(mask)
        j2, ja = jops.ace_admit(js, jnp.asarray(x), jw, jcfg, alpha=0.5,
                                warmup_items=10.0, table_mask=jm,
                                item_mask=jnp.asarray(item))
        p2, pa = ops.ace_admit(ps, _t(x), w, cfg, alpha=0.5,
                               warmup_items=10.0, table_mask=pm,
                               item_mask=_t(item))
        assert p2.counts is ps.counts, "the insert is in place"
        ids = ops.hash_dispatch(_t(x), w, cfg.srp).numpy()
        jids = np.asarray(jops.hash_dispatch(jnp.asarray(x), jw, jcfg.srp))
        if mode == "srht":
            np.testing.assert_array_equal(ids, jids)
        assert (ids == jids).mean() >= HASH_AGREEMENT
        if (ids == jids).all():
            np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
            np.testing.assert_array_equal(p2.counts.numpy(),
                                          np.asarray(j2.counts))
            assert float(p2.n) == float(j2.n)
            for k in ("welford_mean", "welford_m2"):
                np.testing.assert_allclose(float(getattr(p2, k)),
                                           float(getattr(j2, k)), rtol=1e-5)


def _jax_admit_from_buckets(counts, buckets, thresh, item_mask):
    """The reference's admission downstream of a given set of bucket ids
    (tests/test_kernels.py ``_admit_from_buckets``, plus the item mask)."""
    L = counts.shape[0]
    gathered = R.ace_query_ref(counts, buckets)
    scores = jnp.sum(gathered, axis=-1) * jnp.float32(1.0 / L)
    admit = scores >= thresh
    if item_mask is not None:
        admit = jnp.logical_and(admit, item_mask)
    rows = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32)[None, :],
                            buckets.shape)
    nc = counts.at[rows, buckets].add(
        jnp.broadcast_to(admit.astype(counts.dtype)[:, None], buckets.shape))
    return nc, scores, admit


class TestAceAdmitFused:
    @pytest.mark.parametrize("thresh", ["median", "-inf", "+inf"])
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("B,d,K,L,repeat", [(16, 32, 8, 10, 1),
                                                (8, 36, 15, 50, 4),
                                                (6, 9, 3, 4, 3)])
    def test_matches_ref(self, B, d, K, L, repeat, thresh, masked):
        """Warmup (−inf admits all), armed (median) and reject-all
        thresholds, with and without the quarantine mask, on batches
        whose rows repeat: every score must be the PRE-insert one."""
        jcfg, cfg, w, x, counts = _inputs(B, d, K, L, repeat=repeat)
        pre = np.asarray(R.ace_score_ref(jnp.asarray(counts), jnp.asarray(x),
                                         jnp.asarray(w), jcfg))
        t = {"median": np.median(pre), "-inf": -np.inf,
             "+inf": np.inf}[thresh]
        mask = (np.random.default_rng(5).random(len(x)) < 0.7) if masked \
            else None
        c = _t(counts.copy())
        got_c, got_s, got_a, got_b = A.ace_admit_fused(
            c, _t(x), params_from_numpy(w, CPU),
            torch.tensor(t, dtype=torch.float32), cfg,
            item_mask=None if mask is None else _t(mask))
        assert got_c is c, "counts are updated in place"
        _, _, _, want_b = R.ace_admit_ref(jnp.asarray(counts), jnp.asarray(x),
                                          jnp.asarray(w), jnp.float32(t),
                                          jcfg)
        assert (got_b.numpy() == np.asarray(want_b)).mean() \
            >= HASH_AGREEMENT
        # downstream of the port's own bucket ids: bitwise
        nc, s, a = _jax_admit_from_buckets(
            jnp.asarray(counts), jnp.asarray(got_b.numpy()), jnp.float32(t),
            None if mask is None else jnp.asarray(mask))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(s))
        np.testing.assert_array_equal(got_a.numpy(), np.asarray(a))
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(nc))
        if repeat > 1:
            s_rep = got_s.numpy().reshape(repeat, -1)
            assert (s_rep == s_rep[:1]).all(), "copies score alike"

    def test_matches_pallas_kernel_in_interpret_mode(self):
        """The Pallas kernel itself (interpret mode, as the reference's
        tests run it on the CPU), with the item mask."""
        jcfg, cfg, w, x, counts = _inputs(16, 32, 8, 10, repeat=2)
        thresh = np.float32(np.median(np.asarray(R.ace_score_ref(
            jnp.asarray(counts), jnp.asarray(x), jnp.asarray(w), jcfg))))
        mask = np.random.default_rng(6).random(len(x)) < 0.8
        jc, js, ja, jb = jax_admit_fused(
            jnp.asarray(counts), jnp.asarray(x), jnp.asarray(w),
            jnp.float32(thresh), jcfg, interpret=True,
            item_mask=jnp.asarray(mask))
        c, s, a, b = A.ace_admit_fused(
            _t(counts.copy()), _t(x), params_from_numpy(w, CPU),
            torch.tensor(thresh), cfg, item_mask=_t(mask))
        assert (b.numpy() == np.asarray(jb)).mean() >= HASH_AGREEMENT
        if (b.numpy() == np.asarray(jb)).all():
            np.testing.assert_array_equal(s.numpy(), np.asarray(js))
            np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
            np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


def _stacked(R, K, L, B, seed, repeat=1):
    """A stacked (R, 2^K) table, (B, L) ids and (B,) base rows that keep
    every row inside it; ``repeat`` > 1 repeats the (ids, base) pairs so
    inserts collide."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 50, size=(R, 1 << K)).astype(np.int32)
    ids = _ids(B, K, L, seed + 1, repeat)
    base = rng.integers(0, R - L + 1, size=B).astype(np.int32)
    return counts, ids, np.concatenate([base] * repeat)


class TestRowBase:
    """The per-item base row of ``ace_update``/``ace_query``: item b's
    table j is row row_base[b] + j of a stacked table (a window ring, a
    fleet, a windowed fleet)."""

    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("R,K,L,B,repeat", [(24, 6, 4, 9, 3),
                                                (6, 5, 6, 1, 1),
                                                (100, 8, 10, 33, 2)])
    def test_update_matches_reference_scatter(self, R, K, L, B, repeat,
                                              masked):
        """The reference's stacked scatter (``fleet.window``'s
        ``.at[rows, buckets].add``), colliding rows included."""
        counts, ids, base = _stacked(R, K, L, B, R + K, repeat)
        mask = np.random.default_rng(2).random(len(ids)) < 0.6 \
            if masked else np.ones(len(ids), bool)
        rows = base[:, None] + np.arange(L)[None, :]
        want = jnp.asarray(counts).at[jnp.asarray(rows), jnp.asarray(ids)] \
            .add(jnp.broadcast_to(jnp.asarray(mask, jnp.int32)[:, None],
                                  ids.shape))
        c = _t(counts.copy())
        got = U.ace_update(c, _t(ids), row_mask=_t(mask) if masked else None,
                           row_base=_t(base))
        assert got is c
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("R,K,L,B", [(24, 6, 4, 9), (6, 5, 6, 1),
                                         (100, 8, 10, 33)])
    def test_query_matches_reference_gather(self, R, K, L, B):
        counts, ids, base = _stacked(R, K, L, B, R)
        rows = base[:, None] + np.arange(L)[None, :]
        want = np.asarray(jnp.asarray(counts)[jnp.asarray(rows),
                                              jnp.asarray(ids)]
                          .astype(jnp.float32))
        got = Q.ace_query(_t(counts), _t(ids), row_base=_t(base))
        np.testing.assert_array_equal(got.numpy(), want)

    def test_contract(self):
        counts, ids, base = _stacked(12, 4, 3, 5, 0)
        with pytest.raises(ValueError, match="counts"):
            Q.ace_query(_t(counts), _t(ids))        # R != L needs row_base
        with pytest.raises(TypeError, match="row_base"):
            U.ace_update(_t(counts), _t(ids), row_base=_t(base).long())
        with pytest.raises(ValueError, match="row_base"):
            Q.ace_query(_t(counts), _t(ids), row_base=_t(base[:2]))


class TestAceWindowCombine:
    @pytest.mark.parametrize("weighted", [False, True])
    @pytest.mark.parametrize("E,L,K,B,repeat", [(4, 8, 6, 16, 1),
                                                (1, 5, 4, 7, 1),
                                                (3, 50, 10, 9, 3),
                                                (2, 3, 3, 1, 1)])
    def test_matches_pallas_kernel_in_interpret_mode(self, E, L, K, B,
                                                     repeat, weighted):
        """The Pallas kernel (interpret mode) on the same ring, ids and
        γ^age weights, E = 1 and colliding rows included: rtol 1e-6, the
        reference's own tolerance for this kernel against its oracle
        (XLA may contract the weighted add into an FMA inside the
        kernel); unweighted, bitwise against the oracle
        ``ref.ace_window_combine_ref`` (integer sums, the same weighted
        ring-order adds)."""
        from repro.kernels.ace_window_combine import \
            ace_window_combine as jwc
        rng = np.random.default_rng(E * 10 + L)
        counts = rng.integers(0, 999, size=(E, L, 1 << K)).astype(np.int32)
        ids = _ids(B, K, L, 3, repeat)
        weights = (0.8 ** rng.permutation(E)).astype(np.float32)
        tw = None
        if weighted:
            m = np.ones(L, np.float32)
            m[[0, L // 2]] = 0.0
            tw = (m / max(m.sum(), 1.0)).astype(np.float32)
        want = np.asarray(jwc(jnp.asarray(counts), jnp.asarray(ids),
                              jnp.asarray(weights), interpret=True,
                              table_weights=None if tw is None
                              else jnp.asarray(tw)))
        got = WC.ace_window_combine(_t(counts), _t(ids), _t(weights),
                                    None if tw is None else _t(tw))
        assert got.dtype == torch.float32 and tuple(got.shape) == (len(ids),)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        if not weighted:
            np.testing.assert_array_equal(got.numpy(), np.asarray(
                R.ace_window_combine_ref(jnp.asarray(counts),
                                         jnp.asarray(ids),
                                         jnp.asarray(weights))))
        if repeat > 1:
            s = got.numpy().reshape(repeat, -1)
            assert (s == s[:1]).all()

    @pytest.mark.parametrize("weighted", [False, True])
    def test_sums_in_table_then_ring_order(self, weighted):
        """Above 2^24 the order matters.  Unweighted: each epoch's sum is
        exact, converted once, weighted, then accumulated in ring-index
        order and × float32(1/L).  Weighted: each epoch adds tw_j·g_j in
        table order j = 0..L−1 (a float sum), then ring-index order."""
        counts = np.zeros((2, 3, 16), np.int32)
        counts[0, 0], counts[0, 1:] = 1 << 24, 1
        counts[1] = 3
        ids = np.zeros((4, 3), np.int32)
        w = np.array([1.0, 0.5], np.float32)
        tw = np.ones(3, np.float32) if weighted else None
        got = WC.ace_window_combine(_t(counts), _t(ids), _t(w),
                                    None if tw is None else _t(tw))
        if weighted:
            s0 = np.float32(1 << 24)
            for j in (1, 2):                 # + 1 twice: each rounds off
                s0 = np.float32(s0 + np.float32(1) * tw[j])
            s1 = np.float32(0)
            for j in range(3):
                s1 = np.float32(s1 + np.float32(3) * tw[j])
            assert s0 == np.float32(1 << 24)
        else:
            s0 = np.float32((1 << 24) + 2)   # exact: 2^24 + 1 + 1
            s1 = np.float32(9)
        acc = np.float32(np.float32(0) + w[0] * s0)
        acc = np.float32(acc + w[1] * s1)
        if not weighted:
            acc = np.float32(acc * np.float32(1.0 / 3))
        np.testing.assert_array_equal(got.numpy(), np.full(4, acc))

    def test_empty_batch(self):
        got = WC.ace_window_combine(torch.zeros((2, 3, 8), dtype=torch.int32),
                                    torch.zeros((0, 3), dtype=torch.int32),
                                    torch.ones(2))
        assert tuple(got.shape) == (0,)


def _fleet_inputs(T, B, d, K, L, seed=0, repeat=1):
    jcfg, cfg, w, x, _ = _inputs(B, d, K, L, seed=seed, repeat=repeat)
    rng = np.random.default_rng(seed + 7)
    counts = rng.integers(0, 9, size=(T, L, 1 << K)).astype(np.int32)
    tids = rng.integers(0, T, size=B).astype(np.int32)
    return jcfg, cfg, w, x, counts, np.concatenate([tids] * repeat)


class TestAceFleetScore:
    @pytest.mark.parametrize("T,B,d,K,L", [(3, 16, 32, 8, 10),
                                           (1, 7, 9, 4, 3),
                                           (5, 33, 36, 15, 50)])
    def test_matches_pallas_kernel_in_interpret_mode(self, T, B, d, K, L):
        """The Pallas kernel (interpret mode) on JAX's W: ids agree >=
        0.999, scores bitwise where they do; bitwise against the routed
        gather of the port's own ids everywhere."""
        from repro.kernels.ace_fleet_score import ace_fleet_score as jfs
        jcfg, cfg, w, x, counts, tids = _fleet_inputs(T, B, d, K, L)
        want = np.asarray(jfs(jnp.asarray(counts), jnp.asarray(x),
                              jnp.asarray(tids), jnp.asarray(w), jcfg,
                              interpret=True))
        pw = params_from_numpy(w, CPU)
        got = FS.ace_fleet_score(_t(counts), _t(x), _t(tids), pw, cfg)
        ids = H.srp_hash(_t(x), pw, cfg).numpy()
        jids = np.asarray(R.srp_hash_ref(jnp.asarray(x), jnp.asarray(w),
                                         jcfg))
        assert (ids == jids).mean() >= HASH_AGREEMENT
        same = (ids == jids).all(axis=1)
        np.testing.assert_array_equal(got.numpy()[same], want[same])
        from repro.fleet.state import fleet_scores
        from repro.fleet.state import init as jinit
        from repro.fleet.state import FleetConfig
        from repro.core.sketch import AceConfig as JAceConfig
        js = jinit(FleetConfig(ace=JAceConfig(dim=d, num_bits=K,
                                              num_tables=L), num_tenants=T))
        js = js._replace(counts=jnp.asarray(counts))
        np.testing.assert_array_equal(got.numpy(), np.asarray(fleet_scores(
            js, jnp.asarray(tids), jnp.asarray(ids))))

    def test_fleet_of_one_is_the_fused_score(self):
        _, cfg, w, x, counts, _ = _fleet_inputs(1, 12, 20, 6, 7)
        pw = params_from_numpy(w, CPU)
        assert torch.equal(
            FS.ace_fleet_score(_t(counts), _t(x),
                               torch.zeros(12, dtype=torch.int32), pw, cfg),
            F.ace_score_fused(_t(counts[0]), _t(x), pw, cfg))


class TestAceFleetWindowAdmit:
    def _case(self, T, E, B, d, K, L, repeat, thresh, integral, seed=0):
        jcfg, cfg, w, x, _ = _inputs(B, d, K, L, seed=seed, repeat=repeat)
        rng = np.random.default_rng(seed + 11)
        ring = rng.integers(0, 9, size=(T, E, L, 1 << K)).astype(np.int32)
        tail = rng.integers(0, 20, size=(T, L, 1 << K)).astype(np.float32)
        if not integral:
            tail = tail * np.float32(0.37)
        cursor = rng.integers(0, E, size=T).astype(np.int32)
        tids = np.concatenate([rng.integers(0, T, size=B)] * repeat) \
            .astype(np.int32)
        thr = {"-inf": np.full(T, -np.inf), "+inf": np.full(T, np.inf),
               "spread": np.linspace(2.0, 12.0, T)}[thresh].astype(np.float32)
        return jcfg, cfg, w, x, ring, tail, cursor, tids, thr

    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("thresh", ["spread", "-inf", "+inf"])
    @pytest.mark.parametrize("T,E,B,d,K,L,repeat", [(3, 4, 16, 32, 6, 8, 1),
                                                    (2, 1, 6, 9, 3, 4, 3),
                                                    (4, 2, 8, 36, 15, 50, 2)])
    def test_matches_pallas_kernel_in_interpret_mode(self, T, E, B, d, K, L,
                                                     repeat, thresh, masked):
        """The fused Pallas kernel (interpret mode) on the same ring,
        tails, cursors, thresholds and W, with colliding copies of rows
        sent to one tenant: every output bitwise where the ids agree
        (integer-valued tails), and every copy scores alike (all scores
        are pre-insert)."""
        from repro.kernels.ace_fleet_window_admit import \
            ace_fleet_window_admit_fused as jfwa
        jcfg, cfg, w, x, ring, tail, cursor, tids, thr = self._case(
            T, E, B, d, K, L, repeat, thresh, integral=True)
        mask = np.random.default_rng(5).random(len(x)) < 0.7 if masked \
            else None
        want = jfwa(jnp.asarray(ring), jnp.asarray(tail),
                    jnp.asarray(cursor), jnp.asarray(x), jnp.asarray(tids),
                    jnp.asarray(w), jnp.asarray(thr), jcfg, interpret=True,
                    item_mask=None if mask is None else jnp.asarray(mask))
        r = _t(ring.copy())
        got = FWA.ace_fleet_window_admit_fused(
            r, _t(tail), _t(cursor), _t(x), _t(tids),
            params_from_numpy(w, CPU), _t(thr), cfg,
            item_mask=None if mask is None else _t(mask))
        assert got[0] is r, "the ring is updated in place"
        assert (got[3].numpy() == np.asarray(want[3])).mean() \
            >= HASH_AGREEMENT
        if (got[3].numpy() == np.asarray(want[3])).all():
            for i, (a, b) in enumerate(zip(got, want)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=str(i))
        if repeat > 1:
            s = got[1].numpy().reshape(repeat, -1)
            assert (s == s[:1]).all(), "copies score alike: pre-insert"
        if thresh == "+inf":
            np.testing.assert_array_equal(r.numpy(), ring)

    def test_downstream_of_its_own_ids_with_fractional_tails(self):
        """γ < 1 tails: the tail sums are table-order float sums (rtol
        1e-6 against XLA's); everything after them is exact."""
        from repro.fleet import window as jfw_
        jcfg, cfg, w, x, ring, tail, cursor, tids, thr = self._case(
            3, 3, 12, 20, 6, 8, 2, "spread", integral=False)
        r = _t(ring.copy())
        _, s, a, b, ts, lp = FWA.ace_fleet_window_admit_fused(
            r, _t(tail), _t(cursor), _t(x), _t(tids),
            params_from_numpy(w, CPU), _t(thr), cfg)
        from repro.core.sketch import AceConfig as JAceConfig
        from repro.window.ring import WindowConfig as JWC
        js = jfw_.init_fleet_window(JWC(ace=JAceConfig(dim=20, num_bits=6,
                                                       num_tables=8),
                                        num_epochs=3), 3)
        js = js._replace(counts=jnp.asarray(ring), tail=jnp.asarray(tail),
                         cursor=jnp.asarray(cursor))
        jt, jl = jfw_.window_table_sums_fleet(js, jnp.asarray(tids),
                                              jnp.asarray(b.numpy()))
        np.testing.assert_allclose(ts.numpy(), np.asarray(jt), rtol=1e-6)
        np.testing.assert_array_equal(lp.numpy(), np.asarray(jl))
        want_s = (ts + lp) * torch.tensor(1.0 / 8, dtype=torch.float32)
        assert torch.equal(s, want_s)
        assert torch.equal(a, s >= _t(thr)[_t(tids).long()])
        rows = (_t(tids).long() * 3 + _t(cursor).long()[_t(tids).long()]) \
            [:, None] * 8 + torch.arange(8)[None, :]
        want_r = _t(ring.copy()).view(-1, 64).index_put_(
            (rows, b.long()), a.int()[:, None].expand(b.shape),
            accumulate=True)
        assert torch.equal(r.view(-1, 64), want_r)

    @pytest.mark.parametrize("dtype", [np.int16, np.int8])
    def test_narrow_rings_match_pallas_kernel(self, dtype):
        """Narrow rings, once refused here (queue 1 item 9): the ring in
        its own dtype, scores, admit mask and both sums bitwise the Pallas
        kernel's (interpret mode) on the same inputs, as the reference's
        test_narrow_ring_dtypes holds its kernel to its oracle."""
        from repro.kernels.ace_fleet_window_admit import \
            ace_fleet_window_admit_fused as jfwa
        jcfg, cfg, w, x, ring, tail, cursor, tids, thr = self._case(
            2, 2, 4, 8, 5, 3, 2, "spread", integral=True)
        ring = ring.astype(dtype)
        want = jfwa(jnp.asarray(ring), jnp.asarray(tail),
                    jnp.asarray(cursor), jnp.asarray(x), jnp.asarray(tids),
                    jnp.asarray(w), jnp.asarray(thr), jcfg, interpret=True)
        r = _t(ring.copy())
        got = FWA.ace_fleet_window_admit_fused(
            r, _t(tail), _t(cursor), _t(x), _t(tids),
            params_from_numpy(w, CPU), _t(thr), cfg)
        assert got[0] is r and r.dtype == torch.from_numpy(ring).dtype
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        for i, (a, b) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=str(i))


# (x dtype, W dtype) pairs with a narrow operand: the reference's Pallas
# kernels take any of float32, bfloat16 and float16 for each
NARROW_PAIRS = [("float32", "bfloat16"), ("bfloat16", "float32"),
                ("bfloat16", "bfloat16"), ("float16", "float16"),
                ("float32", "float16"), ("float16", "bfloat16")]


def _narrow(a, dtype):
    """The same narrow operand for both packages: the JAX array rounded to
    ``dtype`` and its bits carried into a torch tensor."""
    j = jnp.asarray(a).astype(dtype)
    return j, params_from_numpy(np.asarray(j), CPU)


class TestNarrowOperands:
    """bfloat16 and float16 x and W through every dense-hash wrapper (and x
    through ``srht_hash``), each plain version against the reference's
    Pallas kernel in interpret mode on the same narrow operands: both widen
    to float32 before the product, so the ids agree at the float32 floor
    and everything downstream of one set of ids is bitwise."""

    @pytest.mark.parametrize("xdt,wdt", NARROW_PAIRS)
    @pytest.mark.parametrize("B,d,K,L", SHAPES)
    def test_srp_hash_matches_pallas(self, B, d, K, L, xdt, wdt):
        from repro.kernels.srp_hash import srp_hash as jhash
        jcfg, cfg, w, x, _ = _inputs(B, d, K, L)
        (jx, px), (jw, pw) = _narrow(x, xdt), _narrow(w, wdt)
        assert (px.dtype, pw.dtype) == (getattr(torch, xdt),
                                        getattr(torch, wdt))
        want = np.asarray(jhash(jx, jw, jcfg, interpret=True))
        got = H.srp_hash(px, pw, cfg)
        assert got.dtype == torch.int32 and tuple(got.shape) == (B, L)
        assert (got.numpy() == want).mean() >= HASH_AGREEMENT
        # the plain version is the float32 product of the widened operands
        np.testing.assert_array_equal(
            got.numpy(), H.srp_hash(px.float(), pw.float(), cfg).numpy())

    @pytest.mark.parametrize("xdt,wdt", NARROW_PAIRS[:3])
    def test_admit_fused_matches_pallas(self, xdt, wdt):
        jcfg, cfg, w, x, counts = _inputs(16, 36, 15, 50, repeat=2)
        (jx, px), (jw, pw) = _narrow(x, xdt), _narrow(w, wdt)
        thresh = np.float32(np.median(np.asarray(R.ace_score_ref(
            jnp.asarray(counts), jx.astype(jnp.float32),
            jw.astype(jnp.float32), jcfg))))
        mask = np.random.default_rng(6).random(len(x)) < 0.8
        jc, js, ja, jb = jax_admit_fused(
            jnp.asarray(counts), jx, jw, jnp.float32(thresh), jcfg,
            interpret=True, item_mask=jnp.asarray(mask))
        c, s, a, b = A.ace_admit_fused(_t(counts.copy()), px, pw,
                                       torch.tensor(thresh), cfg,
                                       item_mask=_t(mask))
        assert (b.numpy() == np.asarray(jb)).mean() >= HASH_AGREEMENT
        nc, s2, a2 = _jax_admit_from_buckets(
            jnp.asarray(counts), jnp.asarray(b.numpy()),
            jnp.float32(thresh), jnp.asarray(mask))
        np.testing.assert_array_equal(s.numpy(), np.asarray(s2))
        np.testing.assert_array_equal(a.numpy(), np.asarray(a2))
        np.testing.assert_array_equal(c.numpy(), np.asarray(nc))

    @pytest.mark.parametrize("xdt,wdt", NARROW_PAIRS[:4])
    def test_score_fused_and_fleet_score_match_pallas(self, xdt, wdt):
        from repro.kernels.ace_fleet_score import ace_fleet_score as jfs
        from repro.kernels.ace_score_fused import ace_score_fused as jfused
        jcfg, cfg, w, x, counts, tids = _fleet_inputs(5, 33, 36, 15, 50)
        (jx, px), (jw, pw) = _narrow(x, xdt), _narrow(w, wdt)
        ids = H.srp_hash(px, pw, cfg).numpy()
        jids = np.asarray(R.srp_hash_ref(jx.astype(jnp.float32),
                                         jw.astype(jnp.float32), jcfg))
        assert (ids == jids).mean() >= HASH_AGREEMENT
        same = (ids == jids).all(axis=1)
        want = np.asarray(jfused(jnp.asarray(counts[0]), jx, jw, jcfg,
                                 interpret=True))
        got = F.ace_score_fused(_t(counts[0]), px, pw, cfg)
        np.testing.assert_array_equal(got.numpy()[same], want[same])
        want = np.asarray(jfs(jnp.asarray(counts), jx, jnp.asarray(tids),
                              jw, jcfg, interpret=True))
        got = FS.ace_fleet_score(_t(counts), px, _t(tids), pw, cfg)
        np.testing.assert_array_equal(got.numpy()[same], want[same])

    @pytest.mark.parametrize("xdt,wdt", NARROW_PAIRS[:3])
    def test_fleet_window_admit_matches_pallas(self, xdt, wdt):
        from repro.kernels.ace_fleet_window_admit import \
            ace_fleet_window_admit_fused as jfwa
        case = TestAceFleetWindowAdmit()._case(4, 2, 8, 36, 15, 50, 2,
                                               "spread", integral=True)
        jcfg, cfg, w, x, ring, tail, cursor, tids, thr = case
        (jx, px), (jw, pw) = _narrow(x, xdt), _narrow(w, wdt)
        want = jfwa(jnp.asarray(ring), jnp.asarray(tail),
                    jnp.asarray(cursor), jx, jnp.asarray(tids), jw,
                    jnp.asarray(thr), jcfg, interpret=True)
        got = FWA.ace_fleet_window_admit_fused(
            _t(ring.copy()), _t(tail), _t(cursor), px, _t(tids), pw,
            _t(thr), cfg)
        assert (got[3].numpy() == np.asarray(want[3])).mean() \
            >= HASH_AGREEMENT
        if (got[3].numpy() == np.asarray(want[3])).all():
            for i, (a, b) in enumerate(zip(got, want)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=str(i))

    @pytest.mark.parametrize("xdt", ["bfloat16", "float16"])
    @pytest.mark.parametrize("d", [36, 300])
    def test_srht_hash_matches_pallas(self, d, xdt):
        from repro.kernels.srht_hash import srht_hash as jsrht
        kw = dict(dim=d, num_bits=15, num_tables=50, seed=3,
                  hash_mode="srht")
        jcfg, cfg = JSrpConfig(**kw), SrpConfig(**kw)
        x = np.random.default_rng(d).normal(size=(24, d)).astype(np.float32)
        jx, px = _narrow(x, xdt)
        want = np.asarray(jsrht(jx, jcfg, interpret=True))
        got = SH.srht_hash(px, cfg)
        assert (got.numpy() == want).mean() >= HASH_AGREEMENT
        np.testing.assert_array_equal(
            got.numpy(), SH.srht_hash(px.float(), cfg).numpy())

    def test_other_dtypes_refused(self):
        _, cfg, w, x, counts = _inputs(4, 8, 5, 3)
        pw = params_from_numpy(w, CPU)
        for bad in (torch.float64, torch.int32):
            with pytest.raises(TypeError, match="bfloat16"):
                H.srp_hash(_t(x).to(bad), pw, cfg)
            with pytest.raises(TypeError, match="bfloat16"):
                F.ace_score_fused(_t(counts), _t(x), pw.to(bad), cfg)
        assert build.OPERAND_DTYPES == (torch.float32, torch.bfloat16,
                                        torch.float16)
        assert [build.operand_code(torch.zeros(1, dtype=t))
                for t in build.OPERAND_DTYPES] == [0, 1, 2]


class TestWrapperContract:
    """What every wrapper checks before it runs anything."""

    def _args(self):
        _, cfg, w, x, counts = _inputs(4, 8, 5, 3)
        return cfg, params_from_numpy(w, CPU), _t(x), _t(counts)

    def test_rejects_wrong_dtype(self):
        cfg, w, x, counts = self._args()
        with pytest.raises(TypeError):
            H.srp_hash(x.double(), w, cfg)
        with pytest.raises(TypeError):
            U.ace_update(counts.double(),
                         torch.zeros((2, 3), dtype=torch.int32))

    def test_rejects_wrong_shape(self):
        cfg, w, x, counts = self._args()
        with pytest.raises(ValueError):
            H.srp_hash(x, w[:, :64].contiguous(), cfg)
        with pytest.raises(ValueError):
            Q.ace_query(counts, torch.zeros((2, 4), dtype=torch.int32))

    def test_rejects_non_contiguous(self):
        cfg, w, x, counts = self._args()
        with pytest.raises(ValueError):
            H.srp_hash(torch.zeros((8, 4)).T, w, cfg)

    def test_rejects_other_devices(self):
        """Only CPU tensors take the plain version; anything that is
        neither CPU nor CUDA raises instead of running somewhere."""
        cfg, w, x, counts = self._args()
        with pytest.raises(ValueError):
            H.srp_hash(x.to("meta"), w.to("meta"), cfg)
        with pytest.raises(ValueError):
            H.srp_hash(x, w.to("meta"), cfg)

    def test_plain_versions_count_no_launch(self):
        """The launch counters grow only where a CUDA kernel launches."""
        cfg, w, x, counts = self._args()
        mods = (H, U, Q, A, F, SH, WC, FS, FWA, AE)
        before = [m.KERNEL.launches for m in mods]
        b = H.srp_hash(x, w, cfg)
        U.ace_update(counts, b)
        U.ace_update(counts, b, row_mask=torch.ones(4, dtype=torch.bool))
        Q.ace_query(counts, b)
        A.ace_admit_fused(counts, x, w, torch.tensor(0.0), cfg)
        F.ace_score_fused(counts, x, w, cfg)
        F.ace_score_fused(counts, x, w, cfg, table_weights=torch.ones(3))
        SH.srht_hash(x, cfg)
        ring = counts[None].repeat(2, 1, 1)
        rows = torch.zeros(4, dtype=torch.int32)
        U.ace_update(ring.view(6, -1), b, row_base=rows)
        Q.ace_query(ring.view(6, -1), b, row_base=rows + 3)
        WC.ace_window_combine(ring, b, torch.ones(2))
        tids = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
        FS.ace_fleet_score(ring, x, tids, w, cfg)
        FWA.ace_fleet_window_admit_fused(
            ring[:, None].contiguous(), ring.float(),
            torch.zeros(2, dtype=torch.int32), x, tids, w, torch.zeros(2),
            cfg)
        AE.attr_estimate(counts.float(), b, torch.ones(b.shape))
        assert [m.KERNEL.launches for m in mods] == before

    def test_admit_rejects_non_scalar_threshold(self):
        cfg, w, x, counts = self._args()
        with pytest.raises(ValueError):
            A.ace_admit_fused(counts, x, w, torch.zeros(2), cfg)


DENSE_HASH_SOURCES = ("srp_hash", "ace_admit_fused", "ace_score_fused",
                      "ace_fleet_score", "ace_fleet_window_admit")


class TestBuild:
    def test_nvcc_command_targets_hopper(self):
        cmd = build.nvcc_command("nvcc", "srp_hash", build.BUILD_DIR / "x.so")
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "-shared" in cmd and cmd[-1].endswith("srp_hash.cu")

    def test_every_kernel_has_a_source(self):
        assert build.sources() == ["ace_admit_fused", "ace_fleet_score",
                                   "ace_fleet_window_admit", "ace_query",
                                   "ace_score_fused", "ace_update",
                                   "ace_window_combine", "attr_estimate",
                                   "srht_hash", "srp_hash"]

    def test_cache_key_follows_the_sources(self, tmp_path, monkeypatch):
        csrc = tmp_path / "csrc"
        shutil.copytree(build.CSRC, csrc)
        monkeypatch.setattr(build, "CSRC", csrc)
        before = build.library_path("srp_hash")
        (csrc / "common.cuh").write_text(
            (csrc / "common.cuh").read_text() + "\n// edit\n")
        assert build.library_path("srp_hash") != before

    def test_cache_key_follows_the_dense_hash_header(self, tmp_path,
                                                     monkeypatch):
        csrc = tmp_path / "csrc"
        shutil.copytree(build.CSRC, csrc)
        monkeypatch.setattr(build, "CSRC", csrc)
        before = {n: build.library_path(n) for n in DENSE_HASH_SOURCES}
        (csrc / "srp_gemm.cuh").write_text(
            (csrc / "srp_gemm.cuh").read_text() + "\n// edit\n")
        assert all(build.library_path(n) != p for n, p in before.items())

    def test_every_dense_hash_kernel_is_on_srp_gemm(self):
        """One dense hash: the five kernels that hash include
        ``srp_gemm.cuh``, and the only headers are it and ``common.cuh``."""
        assert sorted(p.name for p in build.CSRC.glob("*.cuh")) == [
            "common.cuh", "srp_gemm.cuh"]
        for name in DENSE_HASH_SOURCES:
            assert '#include "srp_gemm.cuh"' in (
                build.CSRC / f"{name}.cu").read_text()

    def test_missing_nvcc_raises(self, tmp_path, monkeypatch):
        import torch.utils.cpp_extension as cpp_ext
        monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
        monkeypatch.delenv("CUDA_HOME", raising=False)
        monkeypatch.setattr(shutil, "which", lambda _name: None)
        monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
        with pytest.raises(RuntimeError, match="no nvcc"):
            build.build_all()

    def test_failed_compile_raises_with_compiler_output(self, tmp_path,
                                                        monkeypatch):
        fake = tmp_path / "nvcc"
        fake.write_text("#!/bin/sh\necho 'error: no such target' >&2\n"
                        "exit 2\n")
        fake.chmod(0o755)
        monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(build, "find_nvcc", lambda: str(fake))
        with pytest.raises(RuntimeError, match="no such target"):
            build.build_all()
        assert not list((tmp_path / "build").glob("*.so"))
