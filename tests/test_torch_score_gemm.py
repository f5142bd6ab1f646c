"""The fused score on the Hopper hash (``kernels/ace_score_fused.py`` on
``csrc/srp_gemm.cuh``) on CPU tensors, where the wrapper takes its plain
version, against the reference's Pallas kernel in interpret mode on the
same numpy-made inputs and JAX-drawn W; its sum convention
(``ace_query_sum``'s) past 2^24; and the launch it makes on a CUDA
tensor — arguments, scratch and plan — recorded with the kernel call
replaced, since the kernel itself runs only on a card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).

Tolerances: bucket ids agree >= 0.999 with the reference's hash (its own
floor), and scores are compared on the rows whose ids agree: unweighted
bitwise (the sums stay below 2^24, exact in any order), weighted at rtol
1e-6, the reference's tolerance for its fused kernels (it sums in XLA's
order, the port in table order).  Past 2^24 the unweighted score is the
int64 sum, rounded once, × float32(1/L), bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # the optional `torch` extra

from repro.core.srp import SrpConfig as JSrpConfig  # noqa: E402
from repro.core.srp import make_projections as jax_projections  # noqa: E402
from repro.kernels import ref as R  # noqa: E402
from repro.kernels.ace_score_fused import \
    ace_score_fused as jax_score_fused  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402
from repro_torch.core.srp import SrpConfig  # noqa: E402
from repro_torch.kernels import ace_query as Q  # noqa: E402
from repro_torch.kernels import ace_score_fused as F  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import srp_hash as H  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

CPU = torch.device("cpu")
HASH_AGREEMENT = 0.999


def _inputs(B, d, K, L, seed=0, high=9):
    jcfg = JSrpConfig(dim=d, num_bits=K, num_tables=L, seed=seed + 3)
    cfg = SrpConfig(dim=d, num_bits=K, num_tables=L, seed=seed + 3)
    w = np.asarray(jax_projections(jcfg))
    rng = np.random.default_rng(seed + B)
    x = rng.normal(size=(B, d)).astype(np.float32)
    counts = rng.integers(0, high, size=(L, 1 << K)).astype(np.int32)
    return jcfg, cfg, w, x, counts


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# B on both sides of a 64-row tile; the estimator's d = 36, K = 15,
# L = 50; a group of tables that does not divide L
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("B,d,K,L", [(1, 36, 15, 50), (63, 36, 15, 50),
                                     (64, 20, 9, 13), (65, 36, 15, 50),
                                     (130, 17, 13, 11)])
def test_matches_pallas_kernel_in_interpret_mode(B, d, K, L, weighted):
    jcfg, cfg, w, x, counts = _inputs(B, d, K, L)
    tw = None
    if weighted:
        m = np.ones(L, np.float32)
        m[[1, L // 2]] = 0.0
        tw = (m / m.sum()).astype(np.float32)
    want = np.asarray(jax_score_fused(
        jnp.asarray(counts), jnp.asarray(x), jnp.asarray(w), jcfg,
        interpret=True,
        table_weights=None if tw is None else jnp.asarray(tw)))
    pw = params_from_numpy(w, CPU)
    got, ids = F.ace_score_fused_planned(
        _t(counts), _t(x), pw, cfg, None if tw is None else _t(tw), None,
        with_ids=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B,)
    assert torch.equal(got, F.ace_score_fused(
        _t(counts), _t(x), pw, cfg, None if tw is None else _t(tw)))
    jids = np.asarray(R.srp_hash_ref(jnp.asarray(x), jnp.asarray(w), jcfg))
    assert torch.equal(ids, H.srp_hash(_t(x), pw, cfg))
    assert (ids.numpy() == jids).mean() >= HASH_AGREEMENT
    same = (ids.numpy() == jids).all(axis=1)
    if weighted:
        np.testing.assert_allclose(got.numpy()[same], want[same], rtol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy()[same], want[same])


@pytest.mark.parametrize("high", [1 << 20, (1 << 31) - 1])
def test_unweighted_sum_past_2_24_is_the_rounded_int64_sum(high):
    """Rows summing past 2^24 (and past 2^31): the exact int64 sum, one
    conversion, × float32(1/L) — ``ace_query_sum``'s score of the same
    ids, and not a float sum in table order."""
    _, cfg, w, x, counts = _inputs(40, 36, 10, 50, seed=4, high=high)
    counts = _t(counts)
    got, ids = F.ace_score_fused_planned(counts, _t(x),
                                         params_from_numpy(w, CPU), cfg,
                                         None, None, with_ids=True)
    g = counts[torch.arange(50)[None, :], ids.long()].long()
    assert int(g.sum(-1).min()) > 1 << 24
    want = g.sum(-1).to(torch.float32) * torch.tensor(1.0 / 50,
                                                     dtype=torch.float32)
    assert torch.equal(got, want)
    assert torch.equal(got, Q.ace_query_sum(counts, ids))


class _Recorded:
    """Stands in for the kernel binding: records each call's arguments."""

    def __init__(self):
        self.calls = []
        self.launches = 0

    def __call__(self, device, *args):
        self.calls.append(args)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("B,d,K,L", [(16384, 36, 15, 50), (65, 36, 15, 50),
                                     (512, 4097, 13, 32), (1, 36, 15, 50),
                                     (64, 36, 15, 50), (1000, 64, 12, 20)])
def test_launch_takes_the_hash_plan_and_its_scratch(monkeypatch, B, d, K, L,
                                                    weighted):
    """On a CUDA tensor (the device test replaced by a stand-in) the
    wrapper launches once under ``srp_hash.device_plan``'s plan for
    (B, d, K, L), with the (B, L) int32 counter scratch that the
    warp-a-row sum and the weighted form read, and writes the ids only
    when asked."""
    cfg = SrpConfig(dim=d, num_bits=K, num_tables=L)
    asked = []

    def plan(*a):
        asked.append(a[:4])
        return H.hash_plan(*a[:4], H.H100_CLUSTERS)
    rec = _Recorded()
    monkeypatch.setattr(F, "device_plan", plan)
    monkeypatch.setattr(F, "KERNEL", rec)
    monkeypatch.setattr(build, "on_cpu", lambda *t: False)
    counts = torch.zeros((L, 1 << K), dtype=torch.int32)
    q = torch.zeros((B, d))
    w = torch.zeros((d, cfg.padded_projections))
    tw = torch.ones(L) if weighted else None
    for with_ids in (False, True):
        F.ace_score_fused_planned(counts, q, w, cfg, tw, None,
                                  with_ids=with_ids)
    assert asked == [(B, d, K, L)] * 2
    want_plan = H.hash_plan(B, d, K, L, H.H100_CLUSTERS)
    for call, with_ids in zip(rec.calls, (False, True)):
        ptrs, ints, plan_args = call[:7], call[7:12], call[12:-1]
        assert tuple(plan_args) == want_plan.args()
        assert call[-1] == build.count_code(counts) == 0   # int32
        assert ints == (B, d, cfg.padded_projections, K, L)
        gathered, ids = ptrs[4:6]
        assert gathered is not None
        assert (ids is None) != with_ids
        assert (ptrs[3] is None) != weighted
        assert all(p is not None for p in ptrs[:3] + ptrs[6:])


def test_wrapper_refuses_what_the_kernel_does_not_take():
    _, cfg, w, x, counts = _inputs(4, 8, 5, 3)
    pw = params_from_numpy(w, CPU)
    with pytest.raises(TypeError):
        F.ace_score_fused(_t(counts).long(), _t(x), pw, cfg)
    with pytest.raises(ValueError):
        F.ace_score_fused(_t(counts), _t(x), pw, cfg,
                          table_weights=torch.ones(4))
    with pytest.raises(ValueError, match="do not match"):
        F.ace_score_fused(_t(counts[:2]), _t(x), pw, cfg)
    wide = SrpConfig(dim=8, num_bits=1, num_tables=65536)
    with pytest.raises(ValueError, match="at most"):
        F.ace_score_fused(torch.zeros((65536, 2), dtype=torch.int32),
                          _t(x), torch.zeros((8, wide.padded_projections)),
                          wide)
