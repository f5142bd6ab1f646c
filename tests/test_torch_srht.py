"""The port's SRHT hash family (``repro_torch.core.srht``, the
``srht_hash`` kernel module and the ``hash_mode`` dispatch) against the
reference's (``repro.core.srht``, ``repro.kernels.srht_hash`` in Pallas
interpret mode) on the same numpy-made inputs.

Tolerances: the sign diagonals and row sample are drawn by numpy in both
packages, and the butterflies add in the same order, so the transform,
the bits and the bucket ids are held bitwise.  Dense-hash ids keep the
0.999 agreement floor of the reference's own dense kernels.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro.core import srht as jsrht  # noqa: E402
from repro.core import srp as jsrp  # noqa: E402
from repro.kernels import srht_hash as jkernel  # noqa: E402
from repro_torch.core import srht  # noqa: E402
from repro_torch.core import srp  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import srht_hash as SH  # noqa: E402

CPU = torch.device("cpu")
DIMS = [1, 2, 3, 36, 64, 65, 130]


def _cfgs(d, K=6, L=7, seed=0, mode="srht"):
    kw = dict(dim=d, num_bits=K, num_tables=L, seed=seed, hash_mode=mode)
    return jsrp.SrpConfig(**kw), srp.SrpConfig(**kw)


def _x(B, d, seed=0):
    return np.random.default_rng(seed).normal(size=(B, d)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("d", DIMS)
def test_params_equal_reference_bitwise(d):
    jcfg, cfg = _cfgs(d, K=15, L=50, seed=d)
    want, got = jsrht.srht_params(jcfg), srht.srht_params(cfg)
    assert got.d_pad == want.d_pad == srht.next_pow2(max(d, 2))
    for name in ("signs1", "signs2", "rows"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    s1, s2, rows = got.tensors(CPU)
    assert s1.dtype == torch.float32 and rows.dtype == torch.int32
    assert got.tensors(CPU)[0] is s1, "made once per device"


@pytest.mark.parametrize("n", [2, 8, 64, 1024])
def test_fwht_matches_reference_bitwise(n):
    x = _x(5, n, seed=n)
    got = srht.fwht(_t(x)).numpy()
    want = np.asarray(jsrht.fwht(jnp.asarray(x)))
    assert got.tobytes() == want.tobytes()
    # H·H = n·I: the transform is its own inverse up to n
    np.testing.assert_allclose(srht.fwht(srht.fwht(_t(x))).numpy() / n, x,
                               rtol=1e-5, atol=1e-5)


def test_fwht_rejects_other_lengths():
    with pytest.raises(ValueError, match="power of two"):
        srht.fwht(torch.zeros(6))


@pytest.mark.parametrize("d", DIMS)
def test_bits_and_plain_hash_match_reference_bitwise(d):
    """The port's ``srht_bits`` and ``srht_hash_plain`` against the
    reference's ``srht_bits`` and its Pallas kernel (interpret mode)."""
    jcfg, cfg = _cfgs(d, seed=d + 1)
    x = _x(9, d, seed=d)
    x[0] = 0.0                      # all-zero row: padded −0.0 lanes
    want_bits = np.asarray(jsrht.srht_bits(jnp.asarray(x),
                                           jsrht.srht_params(jcfg)))
    got_bits = srht.srht_bits(_t(x), srht.srht_params(cfg)).numpy()
    np.testing.assert_array_equal(got_bits, want_bits)
    want = np.asarray(jkernel.srht_hash(jnp.asarray(x), jcfg,
                                        interpret=True))
    np.testing.assert_array_equal(SH.srht_hash_plain(_t(x), cfg).numpy(),
                                  want)
    got = SH.srht_hash(_t(x), cfg)
    assert got.dtype == torch.int32 and tuple(got.shape) == (9, 7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sign_of_zero_and_nan():
    """sign(0) is bit 1, so a zero row (whose transform is all ±0.0) lands
    in bucket 2^K − 1; a NaN row's bits are all 0."""
    _, cfg = _cfgs(20, K=5, L=4)
    ids = SH.srht_hash(torch.zeros((2, 20)), cfg)
    assert (ids == (1 << 5) - 1).all()
    ids = SH.srht_hash(torch.full((1, 20), float("nan")), cfg)
    assert (ids == 0).all()


def test_wrapper_refuses_what_the_kernel_cannot_take():
    _, cfg = _cfgs(40)
    with pytest.raises(TypeError):
        SH.srht_hash(torch.zeros((2, 40), dtype=torch.float64), cfg)
    with pytest.raises(ValueError):
        SH.srht_hash(torch.zeros((2, 41)), cfg)
    _, wide = _cfgs(SH.MAX_D_PAD + 1, K=2, L=2)
    with pytest.raises(SH.SrhtWidthError, match="pads to 65536"):
        SH.srht_hash(torch.zeros((1, SH.MAX_D_PAD + 1)), wide)
    _, widest = _cfgs(SH.MAX_D_PAD, K=2, L=2)
    assert tuple(SH.srht_hash(torch.zeros((1, SH.MAX_D_PAD)),
                              widest).shape) == (1, 2)


class TestHashModeDispatch:
    @pytest.mark.parametrize("mode", ["dense", "srht"])
    def test_hash_buckets_matches_reference(self, mode):
        """``hash_buckets`` and ``ops.hash_dispatch`` route by the mode;
        the dense family runs on JAX's W carried across."""
        jcfg, cfg = _cfgs(36, K=8, L=10, seed=3, mode=mode)
        jw = jsrp.make_projections(jcfg)
        w = params_from_numpy(np.asarray(jw), CPU)
        x = _x(40, 36, seed=4)
        want = np.asarray(jsrp.hash_buckets(jnp.asarray(x), jw, jcfg))
        for got in (srp.hash_buckets(_t(x), w, cfg),
                    ops.hash_dispatch(_t(x), w, cfg)):
            if mode == "srht":
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                assert (got.numpy() == want).mean() >= 0.999

    def test_srht_projections_are_a_placeholder(self):
        """Under "srht" W is a (d, 0) placeholder in both packages, and
        it carries across like any W."""
        jcfg, cfg = _cfgs(9)
        jw = np.asarray(jsrp.make_projections(jcfg))
        w = srp.make_projections(cfg, device=CPU)
        assert tuple(w.shape) == jw.shape == (9, 0)
        assert tuple(params_from_numpy(jw, CPU).shape) == (9, 0)

    @pytest.mark.parametrize("d", [16, 64, 4096, 12289])
    def test_auto_gives_the_results_of_its_resolved_mode(self, d):
        """"auto" is the port's own rule (``choose_hash_mode``): it hashes
        exactly as the mode it resolves to."""
        cfg = srp.SrpConfig(dim=d, num_bits=4, num_tables=3, hash_mode="auto")
        mode = srp.resolve_hash_mode(cfg)
        assert mode == srht.choose_hash_mode(cfg) in ("dense", "srht")
        fixed = dataclasses.replace(cfg, hash_mode=mode)
        x = _t(_x(6, d, seed=d))
        w = srp.make_projections(cfg, device=CPU)
        np.testing.assert_array_equal(
            ops.hash_dispatch(x, w, cfg).numpy(),
            ops.hash_dispatch(x, srp.make_projections(fixed, device=CPU),
                              fixed).numpy())

    def test_auto_picks_dense_low_and_srht_high(self):
        """The corners of benchmarks/stream_throughput.py (K=15, L=50): the
        port's weights pick dense at d = 64 and SRHT at d = 4096, the
        winners its kernels showed on the H100 (PERF.md)."""
        lo = srp.SrpConfig(dim=64, hash_mode="auto")
        hi = srp.SrpConfig(dim=4096, hash_mode="auto")
        assert srp.resolve_hash_mode(lo) == "dense"
        assert srp.resolve_hash_mode(hi) == "srht"
        assert srht.effective_cost_srht(lo) > srht.effective_cost_dense(lo)
        assert srht.effective_cost_srht(hi) < srht.effective_cost_dense(hi)

    def test_operation_counts_match_reference(self):
        for d in (3, 64, 4097):
            jcfg, cfg = _cfgs(d, K=15, L=50)
            assert srht.flops_dense(cfg, 7) == jsrht.flops_dense(jcfg, 7)
            assert srht.flops_srht(cfg, 7) == jsrht.flops_srht(jcfg, 7)

    def test_unknown_mode_raises(self):
        with pytest.raises(ValueError, match="hash_mode"):
            srp.resolve_hash_mode(srp.SrpConfig(dim=8, hash_mode="fwht"))
