"""The port against the reference where the two could part silently: a W
of one hash family handed to a config that resolves to the other (the
port's ``hash_mode="auto"`` weights are its own, fitted on the H100, and
the reference's differ), and the remnants of ported modules that the
port first left out (``sigma_cubic_proxy``, the projection memory sizes,
``ops.srp_hash``, ``SrpConfig.pad_lanes``, the ``dtype`` argument).

Tolerances: shapes, sizes and refusals are exact; dense-hash ids keep the
0.999 agreement floor of the reference's own dense kernels; the cubic σ
proxy rtol 1e-5: it is the root of a difference of two float32 sums
(cubes, squares) that each package takes in its own order, and the
difference magnifies their ~1e-7 disagreement.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro.core import sketch as jsk  # noqa: E402
from repro.core import srp as jsrp  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.core import sketch as sk  # noqa: E402
from repro_torch.core import srp  # noqa: E402
from repro_torch.core.convert import (params_from_numpy,  # noqa: E402
                                      state_from_numpy)
from repro_torch.core.estimators import AceEstimator  # noqa: E402
from repro_torch.data.pipeline import AceDataFilter  # noqa: E402
from repro_torch.fleet.filter import FleetDataFilter  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import srp_hash as H  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.stream.runner import StreamRunner  # noqa: E402
from repro_torch.window.filter import WindowedAceFilter  # noqa: E402

CPU = torch.device("cpu")
HASH_AGREEMENT = 0.999

# One width inside each band where the port's "auto" picks SRHT and the
# reference's dense (core/srht.py lists the bands), at the paper's K, L
# and at the stream filters' defaults.
BAND_WIDTHS = [(15, 50, d) for d in (53, 300, 463, 600, 1100, 2300, 4097,
                                     5028, 9000)] \
    + [(13, 32, d) for d in (50, 64, 500, 1500, 3000, 4097, 7376, 12000)]
# Widths where both packages resolve "auto" alike (dense).
AGREED_WIDTHS = [(15, 50, 12), (15, 50, 36), (13, 32, 12), (13, 32, 36)]


def _x(B, d, seed=0):
    return np.random.default_rng(seed).normal(size=(B, d)).astype(np.float32)


def _auto_cfgs(K, L, d):
    kw = dict(dim=d, num_bits=K, num_tables=L, hash_mode="auto")
    return jsk.AceConfig(**kw), sk.AceConfig(**kw)


@pytest.mark.parametrize("K,L,d", BAND_WIDTHS)
def test_the_packages_part_in_the_band(K, L, d):
    jcfg, cfg = _auto_cfgs(K, L, d)
    assert jsrp.resolve_hash_mode(jcfg.srp) == "dense"
    assert srp.resolve_hash_mode(cfg.srp) == "srht"


@pytest.mark.parametrize("K,L,d", BAND_WIDTHS)
def test_a_reference_w_in_the_band_is_refused(K, L, d):
    """The reference's dense W under the port's SRHT pick raises, at the
    estimator and at the kernel-path dispatch, and names the remedy."""
    jcfg, cfg = _auto_cfgs(K, L, d)
    w = params_from_numpy(np.asarray(jsk.make_params(jcfg)), CPU)
    assert tuple(w.shape) == (d, jcfg.srp.padded_projections)
    with pytest.raises(ValueError, match="srht") as err:
        AceEstimator(cfg, device="cpu", w=w)
    assert 'hash_mode="auto"' in str(err.value)
    assert 'pass hash_mode="dense" or "srht"' in str(err.value)
    with pytest.raises(ValueError, match="srht"):
        ops.hash_dispatch(torch.zeros((2, d)), w, cfg.srp)
    with pytest.raises(ValueError, match="srht"):
        srp.check_projections(w, cfg.srp)


@pytest.mark.parametrize("K,L,d", AGREED_WIDTHS)
def test_a_reference_w_where_both_agree_is_taken(K, L, d):
    """Where both packages pick dense, the reference's W is taken without
    a word and hashes like the reference."""
    jcfg, cfg = _auto_cfgs(K, L, d)
    jw = jsk.make_params(jcfg)
    w = params_from_numpy(np.asarray(jw), CPU)
    srp.check_projections(w, cfg.srp)
    est = AceEstimator(cfg, device="cpu", w=w)
    x = _x(64, d, seed=d)
    got = ops.hash_dispatch(torch.from_numpy(x), est.w, cfg.srp).numpy()
    want = np.asarray(jsrp.hash_buckets(jnp.asarray(x), jw, jcfg.srp))
    assert float(np.mean(got == want)) >= HASH_AGREEMENT


def test_guardrail_at_d_model_4096_refuses_the_reference_w_and_state():
    """``"auto"`` at the guardrail's width: the reference hashes densely,
    the port would hash with the SRHT; carrying JAX's W (and its state)
    across must raise, not diverge.  An explicit hash_mode="dense" takes
    the same W and state."""
    gcfg = dict(d_model=4096, hash_mode="auto")
    gj = jengine.Guardrail(jengine.GuardrailConfig(**gcfg),
                           use_kernels=False)
    jw = np.asarray(gj.w)
    assert jw.shape == (4097, gj.ace_cfg.srp.padded_projections)
    w = params_from_numpy(jw, CPU)
    for use_kernels in (True, False):
        with pytest.raises(ValueError, match='hash_mode="auto"'):
            engine.Guardrail(engine.GuardrailConfig(**gcfg),
                             use_kernels=use_kernels, device="cpu", w=w)
    gp = engine.Guardrail(engine.GuardrailConfig(d_model=4096,
                                                 hash_mode="dense"),
                          device="cpu", w=w)
    js = gj.state
    gp.state = state_from_numpy(js.counts, js.n, js.welford_mean,
                                js.welford_m2, CPU)
    assert tuple(gp.w.shape) == jw.shape


@pytest.mark.parametrize("kind", ["flat", "window", "fleet"])
def test_filters_and_runner_refuse_the_reference_w(kind):
    """The stream filters at d_model = 4096 under "auto": each filter's
    ``step``, and so the runner that drives it, refuses the reference
    filter's dense W."""
    jf = jpipe.AceDataFilter(d_model=4096, hash_mode="auto")
    jw = np.asarray(jf.init()[1])
    assert jw.shape[1] > 0
    w = params_from_numpy(jw, CPU)
    kw = dict(d_model=4096, hash_mode="auto", device="cpu")
    filt = {"flat": lambda: AceDataFilter(**kw),
            "window": lambda: WindowedAceFilter(num_epochs=2, **kw),
            "fleet": lambda: FleetDataFilter(num_tenants=2, **kw)}[kind]()
    state, own_w = filt.init()
    assert tuple(own_w.shape) == (4097, 0)
    feat = torch.zeros((4, 4097))
    args = (torch.zeros(4, dtype=torch.int32),) if kind == "fleet" else ()
    with pytest.raises(ValueError, match='hash_mode="auto"'):
        filt.step(state, w, feat, *args)
    runner = StreamRunner(filt, chunk_T=2)
    batches = [np.zeros((4, 4097), np.float32)] * 2
    tids = [np.zeros(4, np.int32)] * 2 if kind == "fleet" else None
    with pytest.raises(ValueError, match='hash_mode="auto"'):
        list(runner.run(state, w, batches, tids) if tids else
             runner.run(state, w, batches))
    filt.step(state, own_w, feat, *args)          # its own W is taken


def test_srht_w_under_a_dense_config_is_refused():
    cfg = srp.SrpConfig(dim=9, num_bits=4, num_tables=3)
    with pytest.raises(ValueError, match="dense"):
        srp.check_projections(torch.zeros((9, 0)), cfg)
    with pytest.raises(ValueError) as err:
        srp.check_projections(torch.zeros((9, 12)), cfg)
    assert "auto" not in str(err.value)   # only "auto" names the remedy


# ---------------------------------------------------------------------------
# The remnants.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,L,seed", [(4, 3, 0), (6, 8, 1), (15, 50, 2)])
def test_sigma_cubic_proxy_matches_reference(K, L, seed):
    cfg = dict(dim=5, num_bits=K, num_tables=L)
    ids = np.random.default_rng(seed).integers(
        0, min(1 << K, 9), size=(300, L)).astype(np.int32)
    js = jsk.insert_buckets(jsk.init(jsk.AceConfig(**cfg)),
                            jnp.asarray(ids), jsk.AceConfig(**cfg))
    ps = sk.insert_buckets(sk.init(sk.AceConfig(**cfg), CPU),
                           torch.from_numpy(ids), sk.AceConfig(**cfg))
    np.testing.assert_array_equal(ps.counts.numpy(), np.asarray(js.counts))
    want = float(jsk.sigma_cubic_proxy(js))
    got = sk.sigma_cubic_proxy(ps)
    assert got.dtype == torch.float32 and want > 0
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    empty = sk.init(sk.AceConfig(**cfg), CPU)
    assert float(sk.sigma_cubic_proxy(empty)) == float(
        jsk.sigma_cubic_proxy(jsk.init(jsk.AceConfig(**cfg)))) == 0.0


@pytest.mark.parametrize("pad_lanes", [True, False])
@pytest.mark.parametrize("d,K,L", [(1, 1, 1), (36, 15, 50), (4097, 13, 32),
                                   (300, 7, 19)])
def test_memory_sizes_and_padded_width_match_reference(d, K, L, pad_lanes):
    kw = dict(dim=d, num_bits=K, num_tables=L, pad_lanes=pad_lanes)
    jcfg, cfg = jsrp.SrpConfig(**kw), srp.SrpConfig(**kw)
    assert cfg.padded_projections == jcfg.padded_projections
    assert (srp.projection_memory_bytes(cfg)
            == jsrp.projection_memory_bytes(jcfg))
    assert (srp.projection_memory_bytes(cfg, 2)
            == jsrp.projection_memory_bytes(jcfg, 2))
    assert srp.seeds_memory_bytes(cfg) == jsrp.seeds_memory_bytes(jcfg)
    assert (tuple(srp.make_projections(cfg, device=CPU).shape)
            == jsrp.make_projections(jcfg).shape)


@pytest.mark.parametrize("d,K,L", [(36, 15, 50), (9, 4, 3), (130, 13, 32)])
def test_unpadded_w_hashes_like_the_reference(d, K, L):
    """``pad_lanes=False``: W has exactly K·L columns; the plain path, the
    kernel wrapper (the plain version here) and ``ops.srp_hash`` hash the
    reference's unpadded W as the reference does; the kernels get it
    re-padded (``lane_padded``)."""
    kw = dict(dim=d, num_bits=K, num_tables=L, pad_lanes=False)
    jcfg, cfg = jsrp.SrpConfig(**kw), srp.SrpConfig(**kw)
    jw = jsrp.make_projections(jcfg)
    w = params_from_numpy(np.asarray(jw), CPU)
    assert tuple(w.shape) == (d, K * L)
    x = _x(200, d, seed=K)
    want = np.asarray(jsrp.hash_buckets(jnp.asarray(x), jw, jcfg))
    xt = torch.from_numpy(x)
    for got in (srp.hash_buckets(xt, w, cfg), H.srp_hash(xt, w, cfg),
                ops.srp_hash(xt, w, cfg), ops.hash_dispatch(xt, w, cfg)):
        assert got.dtype == torch.int32
        assert float(np.mean(got.numpy() == want)) >= HASH_AGREEMENT
    wp, P = H.lane_padded(w, cfg)
    assert P == -(-K * L // 128) * 128 and tuple(wp.shape) == (d, P)
    assert torch.equal(wp[:, :K * L], w) and not wp[:, K * L:].any()
    padded = srp.SrpConfig(dim=d, num_bits=K, num_tables=L)
    assert torch.equal(srp.hash_buckets(xt, wp, padded),
                       srp.hash_buckets(xt, w, cfg))
    same, P2 = H.lane_padded(wp, padded)
    assert same is wp and P2 == P


@pytest.mark.parametrize("B,d,K,L", [(16, 36, 15, 50), (7, 9, 4, 3)])
def test_ops_srp_hash_matches_reference(B, d, K, L):
    """``ops.srp_hash`` against the reference's Pallas kernel (interpret
    mode) on the reference's W."""
    kw = dict(dim=d, num_bits=K, num_tables=L, seed=3)
    jcfg, cfg = jsrp.SrpConfig(**kw), srp.SrpConfig(**kw)
    jw = jsrp.make_projections(jcfg)
    x = _x(B, d, seed=B)
    want = np.asarray(jops.srp_hash(jnp.asarray(x), jw, jcfg))
    got = ops.srp_hash(torch.from_numpy(x),
                       params_from_numpy(np.asarray(jw), CPU), cfg)
    assert got.shape == want.shape
    assert float(np.mean(got.numpy() == want)) >= HASH_AGREEMENT


def test_float32_projections_are_taken_and_others_refused():
    cfg = srp.SrpConfig(dim=6, num_bits=4, num_tables=3)
    acfg = sk.AceConfig(dim=6, num_bits=4, num_tables=3)
    assert srp.make_projections(cfg, dtype=torch.float32).dtype \
        == torch.float32
    assert sk.make_params(acfg, dtype=torch.float32).dtype == torch.float32
    for dtype in (torch.bfloat16, torch.float16, torch.float64):
        with pytest.raises(NotImplementedError, match="queue 1 item 9"):
            srp.make_projections(cfg, dtype=dtype)
        with pytest.raises(NotImplementedError, match="queue 1 item 9"):
            sk.make_params(acfg, dtype=dtype)
